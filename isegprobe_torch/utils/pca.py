"""Joint PCA of the feature dumps, for the feature figures.

Counterpart of ``isegprobe_tpu/utils/pca.py``, the same numpy: a plain SVD
PCA fit jointly on the low-res and high-res features of one image, so that
both maps share one colour space.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["PCA", "fit_joint_pca"]


class PCA:
    def __init__(self, n_components: int = 3):
        self.n_components = n_components
        self.mean_ = None
        self.components_ = None

    def fit(self, x: np.ndarray) -> "PCA":
        """x: [N, C]"""
        self.mean_ = x.mean(axis=0, keepdims=True)
        xc = x - self.mean_
        _, _, vt = np.linalg.svd(xc, full_matrices=False)
        self.components_ = vt[: self.n_components]
        return self

    def transform(self, x: np.ndarray) -> np.ndarray:
        return (x - self.mean_) @ self.components_.T


def _minmax(x: np.ndarray) -> np.ndarray:
    mn, mx = x.min(axis=0, keepdims=True), x.max(axis=0, keepdims=True)
    return (x - mn) / np.clip(mx - mn, 1e-6, None)


def fit_joint_pca(lr_feats: np.ndarray, hr_feats: np.ndarray, dim: int = 3
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """PCA fit on the concatenated LowRes and HighRes features; returns
    both as RGB maps in [0, 1].

    lr_feats: [h, w, C]; hr_feats: [H, W, C] -> ([h, w, 3], [H, W, 3])."""
    c = lr_feats.shape[-1]
    lr_flat = lr_feats.reshape(-1, c)
    hr_flat = hr_feats.reshape(-1, c)
    pca = PCA(dim).fit(np.concatenate([lr_flat, hr_flat], axis=0))
    joint = _minmax(pca.transform(np.concatenate([lr_flat, hr_flat],
                                                 axis=0)))
    lr_rgb = joint[: lr_flat.shape[0]].reshape(*lr_feats.shape[:2], dim)
    hr_rgb = joint[lr_flat.shape[0]:].reshape(*hr_feats.shape[:2], dim)
    return lr_rgb, hr_rgb
