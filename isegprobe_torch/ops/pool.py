"""Adaptive pooling with exact ``torch`` window semantics, as matrix
reductions over NHWC tensors.

Counterpart of ``isegprobe_tpu/ops/pool.py``. Windows span indices
``[floor(i·in/out), ceil((i+1)·in/out))``, as in
``adaptive_{avg,max}_pool2d``; they also hold when ``out > in`` (the JBU
guidance pyramid's 448 -> 512 "pool" repeats pixels). The window structure
depends only on the shapes, so it is built once per (in, out) in numpy and
copied to each device once: a copy per forward would be a sync inside the
on-device click loop.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["adaptive_pool"]


@functools.lru_cache(maxsize=128)
def _window_matrix(in_size: int, out_size: int) -> np.ndarray:
    """Boolean [out, in] membership matrix of adaptive pooling windows."""
    m = np.zeros((out_size, in_size), dtype=bool)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = -(-(i + 1) * in_size // out_size)  # ceil
        m[i, start:end] = True
    return m


@functools.lru_cache(maxsize=128)
def _avg_weights_on(in_size: int, out_size: int,
                    device: torch.device) -> torch.Tensor:
    w = _window_matrix(in_size, out_size)
    return torch.from_numpy(
        (w / w.sum(axis=1, keepdims=True)).astype(np.float32)).to(device)


@functools.lru_cache(maxsize=128)
def _mask_on(in_size: int, out_size: int,
             device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_window_matrix(in_size, out_size)).to(device)


def _pool_axis(x: torch.Tensor, out_size: int, axis: int,
               mode: str) -> torch.Tensor:
    in_size = x.shape[axis]
    if in_size == out_size:
        return x
    x = x.movedim(axis, -1)  # [..., in]
    if mode == "max":
        mask = _mask_on(in_size, out_size, x.device)  # [out, in]
        out = torch.where(mask, x[..., None, :], -torch.inf).amax(dim=-1)
    elif mode == "avg":
        weights = _avg_weights_on(in_size, out_size, x.device)
        out = torch.einsum("oi,...i->...o", weights, x.float()).to(x.dtype)
    else:
        raise ValueError(f"unknown pooling mode {mode!r}")
    return out.movedim(-1, axis)


def adaptive_pool(x: torch.Tensor, out_hw: tuple[int, int],
                  mode: str) -> torch.Tensor:
    """Adaptive max or avg pool of the spatial dims of an ``[..., H, W, C]``
    tensor to ``out_hw``; avg computes in float32 and returns x's dtype."""
    x = _pool_axis(x, out_hw[0], -3, mode)
    return _pool_axis(x, out_hw[1], -2, mode)
