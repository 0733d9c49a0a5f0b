"""Resizes whose output (or input) extent is a per-lane value, not a shape.

Counterpart of ``isegprobe_tpu/ops/dynamic_resize.py``. The RITM adaptive
ZoomIn crops to a data-dependent size ``(round(h·s), round(w·s))`` with
``s = T / max(h, w)``. The batched adaptive evaluator
(``inference/adaptive_eval.py``) keeps one canvas shape for all its lanes
and a valid top-left rect per lane, so these helpers build the
``F.interpolate``-convention interpolation matrices for per-lane lengths:

* :func:`dyn_matrix`, an ``[out_cap, in_cap]`` matrix (``[B, out_cap,
  in_cap]`` for per-lane lengths) whose rows at or past the output length
  are garbage for the caller to mask, with ``ops/resize.py``'s coordinate
  conventions computed in float32 as the JAX package computes them;
* :func:`round_half_even_div`, ``round(p / q)`` in integers with banker's
  ties, equal to the host's float64 ``round(h * (T / m))`` at every
  reachable size.

No Pallas kernel stands behind these in the JAX package: they are its jnp
computations, and run as plain PyTorch on every device.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch

__all__ = ["round_half_even_div", "dyn_matrix", "dyn_resize_2d",
           "dyn_resize_2d_batched"]

_CUBIC_A = -0.75  # PyTorch / OpenCV cubic convolution constant

Length = Union[int, float, torch.Tensor]


def round_half_even_div(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``round(p / q)`` with ties to even, for positive integer tensors
    (any shape, broadcast), in int64."""
    p, q = torch.as_tensor(p).long(), torch.as_tensor(q).long()
    t = 2 * p
    n = torch.div(t + q, 2 * q, rounding_mode="floor")  # half-up
    tie = torch.remainder(t, 2 * q) == q
    return torch.where(tie & (torch.remainder(n, 2) == 1), n - 1, n)


def _cubic_weights(t: torch.Tensor) -> torch.Tensor:
    """Cubic convolution weights ``[..., 4]`` for taps at offsets -1..2 from
    ``floor(src)``."""
    a = _CUBIC_A
    d = torch.stack([t + 1.0, t, 1.0 - t, 2.0 - t], dim=-1)
    ad = d.abs()
    near = (a + 2.0) * ad**3 - (a + 3.0) * ad**2 + 1.0
    far = a * ad**3 - 5.0 * a * ad**2 + 8.0 * a * ad - 4.0 * a
    return torch.where(ad <= 1.0, near, far)


def _as_f32(v: Length, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).float()


def _scatter_taps(src: torch.Tensor, weights: torch.Tensor, in_cap: int,
                  in_len: torch.Tensor, offsets: Sequence[int]
                  ) -> torch.Tensor:
    """The dense ``[..., out_cap, in_cap]`` matrix from source coordinates
    ``[..., out_cap]`` and their tap weights ``[..., out_cap, taps]``, taps
    clamped to ``[0, in_len - 1]`` (torch's edge clamp)."""
    cols = torch.arange(in_cap, device=src.device)
    f = torch.floor(src).long()
    hi = (in_len.long() - 1)[..., None]
    m = torch.zeros((*src.shape, in_cap), dtype=torch.float32,
                    device=src.device)
    for k, off in enumerate(offsets):
        idx = torch.minimum(torch.clamp_min(f + off, 0), hi)
        m = m + (cols == idx[..., None]) * weights[..., k, None]
    return m


def dyn_matrix(in_cap: int, out_cap: int, in_len: Length, out_len: Length,
               mode: str = "bilinear", align_corners: bool = True,
               scale: Length | None = None) -> torch.Tensor:
    """The interpolation matrix from ``in_len`` valid inputs (of ``in_cap``)
    to ``out_len`` valid outputs (of ``out_cap``). ``in_len``, ``out_len``
    and ``scale`` are numbers or ``[B]`` tensors (one per lane; the result
    is then ``[B, out_cap, in_cap]``). ``scale`` is ``F.interpolate``'s
    ``scale_factor`` (align_corners=False only). Rows at or past
    ``out_len`` and columns at or past ``in_len`` carry garbage or zero."""
    device = next((v.device for v in (in_len, out_len, scale)
                   if isinstance(v, torch.Tensor)), None)
    in_len_f = _as_f32(in_len, device)[..., None]
    out_len_f = _as_f32(out_len, device)[..., None]
    i = torch.arange(out_cap, dtype=torch.float32, device=device)
    if align_corners:
        step = torch.where(out_len_f > 1, (in_len_f - 1)
                           / torch.clamp_min(out_len_f - 1, 1), 0.0)
        src = i * step
    else:
        s = (_as_f32(scale, device)[..., None] if scale is not None
             else out_len_f / in_len_f)
        src = (i + 0.5) / s - 0.5
    src = src.expand(*torch.broadcast_shapes(in_len_f.shape,
                                             out_len_f.shape)[:-1], out_cap)
    in_len_t = torch.as_tensor(in_len, device=device).expand(src.shape[:-1])
    if mode in ("bilinear", "linear"):
        if not align_corners:
            src = torch.clamp_min(src, 0.0)  # torch clamps negative coords
        i0 = torch.minimum(torch.clamp_min(torch.floor(src), 0),
                           in_len_f - 1)
        w1 = torch.clamp(src - i0, 0.0, 1.0)
        return _scatter_taps(i0, torch.stack([1.0 - w1, w1], dim=-1),
                             in_cap, in_len_t, (0, 1))
    if mode == "bicubic":
        t = src - torch.floor(src)
        return _scatter_taps(src, _cubic_weights(t), in_cap, in_len_t,
                             (-1, 0, 1, 2))
    raise ValueError(f"Unknown resize mode: {mode}")


def dyn_resize_2d(x: torch.Tensor, in_hw, out_hw, out_cap_hw: tuple,
                  mode: str = "bilinear", align_corners: bool = True,
                  scales=None) -> torch.Tensor:
    """Separable resize of ``x`` ``[..., Hc, Wc, C]`` whose valid rect is
    ``in_hw`` (two numbers) to the canvas ``[..., out_cap_h, out_cap_w, C]``
    with valid rect ``out_hw``; garbage outside it. Float32."""
    hc, wc = x.shape[-3], x.shape[-2]
    mr = dyn_matrix(hc, out_cap_hw[0], in_hw[0], out_hw[0], mode,
                    align_corners, None if scales is None else scales[0])
    mc = dyn_matrix(wc, out_cap_hw[1], in_hw[1], out_hw[1], mode,
                    align_corners, None if scales is None else scales[1])
    x = torch.einsum("oh,...hwc->...owc", mr.to(x.device), x.float())
    return torch.einsum("pw,...owc->...opc", mc.to(x.device), x)


def dyn_resize_2d_batched(x: torch.Tensor, in_hw: torch.Tensor,
                          out_hw: torch.Tensor, out_cap_hw: tuple,
                          mode: str = "bilinear",
                          align_corners: bool = True) -> torch.Tensor:
    """Per-lane resize: ``x`` ``[B, Hc, Wc, C]`` with valid rects ``in_hw``
    ``[B, 2]`` -> ``[B, out_cap_h, out_cap_w, C]`` with valid rects
    ``out_hw`` ``[B, 2]``. Float32."""
    hc, wc = x.shape[1], x.shape[2]
    mr = dyn_matrix(hc, out_cap_hw[0], in_hw[:, 0], out_hw[:, 0], mode,
                    align_corners)
    mc = dyn_matrix(wc, out_cap_hw[1], in_hw[:, 1], out_hw[:, 1], mode,
                    align_corners)
    x = torch.einsum("boh,bhwc->bowc", mr, x.float())
    return torch.einsum("bpw,bowc->bopc", mc, x)
