from isegprobe_torch.data.datasets.extended import (
    ADE20kDataset,
    CocoDataset,
    CocoLvisDataset,
    LvisDataset,
    OpenImagesDataset,
)
from isegprobe_torch.data.datasets.standard import (
    BerkeleyDataset,
    DavisDataset,
    GrabCutDataset,
    PascalVocDataset,
    SBDDataset,
    SBDEvaluationDataset,
)
from isegprobe_torch.data.datasets.synthetic import SyntheticShapesDataset

__all__ = ["ADE20kDataset", "BerkeleyDataset", "CocoDataset",
           "CocoLvisDataset", "DavisDataset", "GrabCutDataset",
           "LvisDataset", "OpenImagesDataset", "PascalVocDataset",
           "SBDDataset", "SBDEvaluationDataset", "SyntheticShapesDataset"]
