from isegprobe_torch.data.datasets.standard import (
    BerkeleyDataset,
    DavisDataset,
    GrabCutDataset,
    PascalVocDataset,
    SBDDataset,
    SBDEvaluationDataset,
)
from isegprobe_torch.data.datasets.synthetic import SyntheticShapesDataset

__all__ = ["BerkeleyDataset", "DavisDataset", "GrabCutDataset",
           "PascalVocDataset", "SBDDataset", "SBDEvaluationDataset",
           "SyntheticShapesDataset"]
