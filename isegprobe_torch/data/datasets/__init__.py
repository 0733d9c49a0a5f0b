from isegprobe_torch.data.datasets.synthetic import SyntheticShapesDataset

__all__ = ["SyntheticShapesDataset"]
