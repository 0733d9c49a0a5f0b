"""Image resizing with exact ``torch.nn.functional.interpolate`` coordinate
semantics, as separable interpolation matrices.

Counterpart of ``isegprobe_tpu/ops/resize.py``. NoC parity is brittle to the
interpolation conventions (bilinear with ``align_corners=True`` for the
logits, bicubic with explicit scale factors for the DINOv2 pos-embed trick),
so the port builds the same [out, in] matrices the JAX package builds and
applies them as two small f32 matmuls:

    out = W_rows @ img @ W_cols^T
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize", "resize_matrix"]

_CUBIC_A = -0.75  # PyTorch / OpenCV cubic convolution constant


def _source_coords(in_size: int, out_size: int, align_corners: bool,
                   scale: float | None) -> np.ndarray:
    """Map output pixel indices to (fractional) input coordinates."""
    i = np.arange(out_size, dtype=np.float64)
    if align_corners:
        if out_size == 1:
            return np.zeros(out_size, dtype=np.float64)
        return i * (in_size - 1) / (out_size - 1)
    s = scale if scale is not None else out_size / in_size
    return (i + 0.5) / s - 0.5


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """Cubic convolution weights for taps at offsets [-1, 0, 1, 2] from
    floor(src)."""
    a = _CUBIC_A
    d = np.stack([t + 1.0, t, 1.0 - t, 2.0 - t], axis=-1)
    ad = np.abs(d)
    near = (a + 2.0) * ad**3 - (a + 3.0) * ad**2 + 1.0
    far = a * ad**3 - 5.0 * a * ad**2 + 8.0 * a * ad - 4.0 * a
    return np.where(ad <= 1.0, near, far)


@functools.lru_cache(maxsize=256)
def resize_matrix(in_size: int, out_size: int, mode: str = "bilinear",
                  align_corners: bool = False,
                  scale: float | None = None) -> np.ndarray:
    """The [out_size, in_size] 1-D interpolation matrix (numpy, float32).

    ``scale``: explicit scale factor (``scale_factor=`` semantics: the
    coordinate transform uses the given scale rather than out/in). Only
    meaningful with ``align_corners=False``. The result is cached and shared:
    do not write to it.
    """
    m = np.zeros((out_size, in_size), dtype=np.float64)
    rows = np.arange(out_size)

    if mode == "nearest":
        # legacy 'nearest': src = floorf(i * scale) computed in float32
        scale32 = np.float32(in_size) / np.float32(out_size)
        idx = np.minimum(
            np.floor(rows.astype(np.float32) * scale32).astype(np.int64),
            in_size - 1)
        m[rows, idx] = 1.0
        return m.astype(np.float32)

    src = _source_coords(in_size, out_size, align_corners, scale)

    if mode in ("bilinear", "linear"):
        if not align_corners:
            src = np.maximum(src, 0.0)  # interpolate clamps negative coords
        i0 = np.clip(np.floor(src).astype(np.int64), 0, in_size - 1)
        i1 = np.minimum(i0 + 1, in_size - 1)
        w1 = np.clip(src - i0, 0.0, 1.0)
        np.add.at(m, (rows, i0), 1.0 - w1)
        np.add.at(m, (rows, i1), w1)
        return m.astype(np.float32)

    if mode == "bicubic":
        f = np.floor(src)
        w = _cubic_weights(src - f)  # [out, 4]
        for k in range(4):
            idx = np.clip(f.astype(np.int64) + (k - 1), 0, in_size - 1)
            np.add.at(m, (rows, idx), w[:, k])
        return m.astype(np.float32)

    raise ValueError(f"Unknown resize mode: {mode}")


@functools.lru_cache(maxsize=256)
def _matrix_on(in_size, out_size, mode, align_corners, scale,
               device: torch.device) -> torch.Tensor:
    # a normal tensor even when first made under inference mode, so that
    # a later training forward can save it for backward
    with torch.inference_mode(False):
        return torch.from_numpy(
            resize_matrix(in_size, out_size, mode, align_corners, scale)
        ).to(device)


def resize(x: torch.Tensor, size: tuple[int, int], mode: str = "bilinear",
           align_corners: bool = False,
           scales: tuple[float, float] | None = None) -> torch.Tensor:
    """Resize the spatial dims of an ``[..., H, W, C]`` tensor to
    ``size=(H', W')`` with ``F.interpolate`` numerics for 'nearest',
    'bilinear' and 'bicubic', including ``align_corners`` and explicit
    ``scale_factor`` coordinate transforms (via ``scales``). Computes in
    float32 and returns the input dtype."""
    h_in, w_in = x.shape[-3], x.shape[-2]
    h_out, w_out = size
    if (h_in, w_in) == (h_out, w_out) and mode != "bicubic":
        return x
    sh, sw = scales if scales is not None else (None, None)
    wr = _matrix_on(h_in, h_out, mode, align_corners, sh, x.device)
    wc = _matrix_on(w_in, w_out, mode, align_corners, sw, x.device)
    y = torch.einsum("oh,...hwc->...owc", wr, x.float())
    y = torch.einsum("pw,...owc->...opc", wc, y)
    return y.to(x.dtype)
