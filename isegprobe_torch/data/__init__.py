"""Datasets without OpenCV: the stored evaluation scenes and the training pipeline (rendering, augmentation, click synthesis, loader)."""
