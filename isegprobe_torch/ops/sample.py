"""ZoomIn crop-resize and inverse paste at fractional ROI coordinates.

Counterpart of ``isegprobe_tpu/ops/sample.py:crop_resize`` and
``inverse_paste``. Both directions are bilinear sampling with
``align_corners=True`` numerics and clamped taps: crop-resize ``out[i]``
samples at ``rmin + i·(rh−1)/(oh−1)``; the inverse paste at full-frame row
``y`` samples the probability map at ``(y−rmin)·(oh−1)/(rh−1)``, zero outside
the ROI. The JAX package writes the 2-tap lerp as a matmul for its matrix
unit; here it is a per-lane gather and a lerp. Coordinates are float32 in
the JAX package's compiled order: XLA turns the crop's division by the
constant ``oh − 1`` into a product with its float32 reciprocal and fuses
``rmin + i·step`` into one FMA, which is computed here exactly in float64
(the product of two float32 values and the sum with an integer below 2^24
are exact there) and rounded once.

Both take one ROI per lane as a ``[B, 4]`` integer tensor on the data's
device and never read it on the host, so the on-device click loop calls
them without a sync; or one ROI of host ints for every lane (the host
predictor's ROI state machine).

:func:`crop_resize_dyn` and :func:`inverse_paste_dyn` are the adaptive
ZoomIn's pair (``crop_resize_dyn`` / ``inverse_paste_dyn`` of the JAX
module): the crop's output extent is a per-lane ``[B, 2]`` tensor, laid out
top-left on a fixed canvas, and the paste reads that extent back. Their
divisors are per-lane values, so XLA divides there rather than multiplying
by a reciprocal; the FMA of the coordinate stays.
"""

from __future__ import annotations

import torch

__all__ = ["crop_resize", "inverse_paste", "crop_resize_dyn",
           "inverse_paste_dyn"]


def _taps_f32(x: torch.Tensor) -> torch.Tensor:
    """Gathered taps as float32; uint8 images read as ``f32(v)/255`` (the
    frame is normalised at read time and never widened in full)."""
    if x.dtype == torch.uint8:
        return x.float() / 255.0
    return x.float()


def _lerp_axis(x: torch.Tensor, coords: torch.Tensor, axis: int, lo, hi
               ) -> torch.Tensor:
    """Linearly interpolate ``x`` ``[B, H, W, C]`` along ``axis`` (1 or 2)
    at the per-lane fractional ``coords`` ``[B, n]``, clamping both taps to
    ``[lo, hi]`` (numbers, or ``[B, 1]`` tensors)."""
    c0 = torch.clamp(torch.floor(coords), lo, hi)
    c1 = torch.clamp(c0 + 1, lo, hi)
    w = torch.clamp(coords - c0, 0.0, 1.0)
    b, n = coords.shape
    shape = list(x.shape)
    shape[axis] = n
    view = [b, 1, 1, 1]
    view[axis] = n
    x0 = torch.gather(x, axis, c0.long().reshape(view).expand(shape))
    x1 = torch.gather(x, axis, c1.long().reshape(view).expand(shape))
    w = w.reshape(view)
    return (1.0 - w) * _taps_f32(x0) + w * _taps_f32(x1)


def _crop_coords(lo: torch.Tensor, hi: torch.Tensor, n: int) -> torch.Tensor:
    """``lo + i·(hi − lo)/(n − 1)`` for ``i < n`` (float32 ``[B, n]`` from
    ``[B, 1]`` bounds), rounded as the JAX package's compiled crop rounds
    it."""
    step = (hi - lo) * (1.0 / (n - 1)) if n > 1 else torch.zeros_like(lo)
    i = torch.arange(n, dtype=torch.float64, device=lo.device)
    return (i * step.double() + lo.double()).float()


def _lane_rois(roi, lanes: int, device) -> list[torch.Tensor]:
    """``(rmin, rmax, cmin, cmax)`` as float32 ``[B, 1]`` tensors, from a
    ``[B, 4]`` integer tensor or one ROI of host ints for every lane."""
    if not isinstance(roi, torch.Tensor):
        roi = [int(v) for v in roi]
    roi = torch.as_tensor(roi, device=device).float()
    return [v[:, None] for v in roi.reshape(-1, 4).expand(lanes, 4).unbind(1)]


def crop_resize(img: torch.Tensor, roi, out_hw: tuple[int, int]
                ) -> torch.Tensor:
    """Crop every lane of ``img`` ``[B, H, W, C]`` to its inclusive ROI
    ``(rmin, rmax, cmin, cmax)`` (``roi``: ``[B, 4]`` integer tensor, or
    four host ints for every lane) and resize to ``out_hw`` with
    align_corners=True bilinear. Returns float32 ``[B, oh, ow, C]``; a uint8
    image is read as ``f32(v)/255``."""
    rmin, rmax, cmin, cmax = _lane_rois(roi, img.shape[0], img.device)
    ys = _crop_coords(rmin, rmax, out_hw[0])
    xs = _crop_coords(cmin, cmax, out_hw[1])
    x = _lerp_axis(img, ys, 1, rmin, rmax)
    return _lerp_axis(x, xs, 2, cmin, cmax)


def inverse_paste(probs: torch.Tensor, roi, out_hw: tuple[int, int]
                  ) -> torch.Tensor:
    """Resize every lane of ``probs`` ``[B, oh, ow, C]`` to its ROI's size
    (``roi`` as for :func:`crop_resize`) and paste it into a zeroed full
    frame ``[B, H, W, C]`` with ``(H, W) = out_hw``. Returns float32."""
    _, oh, ow, _ = probs.shape
    h, w = out_hw
    rmin, rmax, cmin, cmax = _lane_rois(roi, probs.shape[0], probs.device)
    rh = rmax - rmin + 1.0
    rw = cmax - cmin + 1.0
    y = torch.arange(h, dtype=torch.float32, device=probs.device)
    x = torch.arange(w, dtype=torch.float32, device=probs.device)
    sy = ((y - rmin) * (oh - 1) / (rh - 1).clamp_min(1.0)).masked_fill(
        rh <= 1, 0.0)
    sx = ((x - cmin) * (ow - 1) / (rw - 1).clamp_min(1.0)).masked_fill(
        rw <= 1, 0.0)
    p = _lerp_axis(probs, sy, 1, 0.0, oh - 1)
    p = _lerp_axis(p, sx, 2, 0.0, ow - 1)
    valid = (((y >= rmin) & (y <= rmax))[:, :, None]
             & ((x >= cmin) & (x <= cmax))[:, None, :])
    return p.masked_fill(~valid[..., None], 0.0)


def _fma_coords(lo: torch.Tensor, step: torch.Tensor, n: int
                ) -> torch.Tensor:
    """``lo + i·step`` for ``i < n`` (float32 ``[B, n]`` from ``[B, 1]``
    operands), rounded once as a fused multiply-add."""
    i = torch.arange(n, dtype=torch.float64, device=lo.device)
    return (i * step.double() + lo.double()).float()


def crop_resize_dyn(img: torch.Tensor, roi: torch.Tensor,
                    out_hw: torch.Tensor, canvas_hw: tuple[int, int]
                    ) -> torch.Tensor:
    """Crop every lane of ``img`` ``[B, H, W, C]`` to its inclusive ROI
    (``[B, 4]`` integer tensor) and resize it (align_corners=True bilinear)
    to its own extent ``out_hw`` ``[B, 2]``, laid out top-left on the canvas
    ``[B, canvas_h, canvas_w, C]``, zero beyond the extent. Float32; uint8
    reads as ``f32(v)/255``. Where the extent equals the ROI's size the
    coordinates are integers and the crop is an exact copy."""
    ch, cw = canvas_hw
    rmin, rmax, cmin, cmax = _lane_rois(roi, img.shape[0], img.device)
    oh = out_hw[:, 0, None].float()
    ow = out_hw[:, 1, None].float()
    ys = _fma_coords(rmin, torch.where(
        oh > 1, (rmax - rmin) / torch.clamp_min(oh - 1, 1.0), 0.0), ch)
    xs = _fma_coords(cmin, torch.where(
        ow > 1, (cmax - cmin) / torch.clamp_min(ow - 1, 1.0), 0.0), cw)
    x = _lerp_axis(img, ys, 1, rmin, rmax)
    x = _lerp_axis(x, xs, 2, cmin, cmax)
    rows = torch.arange(ch, dtype=torch.float32, device=img.device)
    cols = torch.arange(cw, dtype=torch.float32, device=img.device)
    valid = (rows < oh)[:, :, None] & (cols < ow)[:, None, :]
    return x * valid[..., None]


def inverse_paste_dyn(probs: torch.Tensor, src_hw: torch.Tensor,
                      roi: torch.Tensor, out_hw: tuple[int, int]
                      ) -> torch.Tensor:
    """Resize every lane's valid ``src_hw`` ``[B, 2]`` rect of ``probs``
    ``[B, Hc, Wc, C]`` to its ROI's size (``[B, 4]``) and paste it into a
    zeroed frame ``[B, H, W, C]`` with ``(H, W) = out_hw``: the
    :func:`inverse_paste` of a per-lane source extent. Float32."""
    h, w = out_hw
    rmin, rmax, cmin, cmax = _lane_rois(roi, probs.shape[0], probs.device)
    sh = src_hw[:, 0, None].float()
    sw = src_hw[:, 1, None].float()
    rh = rmax - rmin + 1.0
    rw = cmax - cmin + 1.0
    y = torch.arange(h, dtype=torch.float32, device=probs.device)
    x = torch.arange(w, dtype=torch.float32, device=probs.device)
    sy = ((y - rmin) * (sh - 1) / (rh - 1).clamp_min(1.0)).masked_fill(
        rh <= 1, 0.0)
    sx = ((x - cmin) * (sw - 1) / (rw - 1).clamp_min(1.0)).masked_fill(
        rw <= 1, 0.0)
    zero = torch.zeros_like(sh)
    p = _lerp_axis(probs, sy, 1, zero, sh - 1)
    p = _lerp_axis(p, sx, 2, zero, sw - 1)
    valid = (((y >= rmin) & (y <= rmax))[:, :, None]
             & ((x >= cmin) & (x <= cmax))[:, None, :])
    return p.masked_fill(~valid[..., None], 0.0)
