"""The RITM adaptive ZoomIn protocol on the device, lane-batched.

Counterpart of ``isegprobe_tpu/inference/adaptive_eval.py``. The RITM
protocol (``eval_ritm`` with ``eval_mode=cvpr``: a scalar target T, 400, or
600 for DAVIS, and ``skip_clicks=1``) crops to the predicted object's ROI
and resizes it to ``(round(h·s), round(w·s))`` with ``s = T / max(h, w)``: a
data-dependent size for every lane and click. Here every lane's crop lies
top-left on one canvas of ``ceil_patch(max(frame, T))`` per side, with its
valid extent as a ``[B, 2]`` tensor:

* the crop, the click remap and the inverse paste sample at per-lane
  extents (``ops/sample.py:crop_resize_dyn`` / ``inverse_paste_dyn``), the
  sizes rounded in integers with banker's ties
  (``ops/dynamic_resize.round_half_even_div``);
* the model runs ``iSegProbeModel.forward_masked`` on the canvas (the
  plain masked attention, per-lane pos-embeds, masked head convs), whose
  valid rect equals the true-size forward;
* the flip TTA mirrors each lane within its valid width (a per-lane gather,
  the JAX package's roll of the mirrored canvas);
* the ZoomIn state machine is the host transform's, its quirk included: a
  click with no candidate ROI (at or below ``skip_clicks`` clicks, or an
  empty prediction) feeds the model the full frame, but the inverse still
  pastes through an ROI set earlier (``inference/transforms.py:ZoomIn``).

The clicker is the device loop's (kernel C's EDT row pass), and the loop
is :class:`~isegprobe_torch.inference.device_eval.DeviceEvaluator`'s, with
one read a step. The JAX package compiles one program per padded frame
shape (``make_adaptive_runner``, ``_LazyAdaptiveGroup``); eager PyTorch
takes each call's frame shape as it comes, so one evaluator serves every
shape and the runners below are that evaluator.
"""

from __future__ import annotations

from typing import Tuple

import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.inference.device_eval import (
    DeviceEvaluator,
    GroupEvaluator,
)
from isegprobe_torch.ops.dynamic_resize import round_half_even_div
from isegprobe_torch.ops.sample import crop_resize_dyn, inverse_paste_dyn

__all__ = ["AdaptiveEvaluator", "make_adaptive_evaluator",
           "make_adaptive_runner", "make_adaptive_group_runner"]


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


class AdaptiveEvaluator(DeviceEvaluator):
    """The click loop :func:`make_adaptive_evaluator` builds: called as
    :class:`DeviceEvaluator` is (``batch_size`` lanes of padded frames,
    gts and valid extents), with the same counters and click record."""

    def __init__(self, model, *, target_size: int, skip_clicks: int,
                 **protocol) -> None:
        super().__init__(model, target_size=(target_size, target_size),
                         use_cache=False, **protocol)
        self.target = int(target_size)
        self.skip_clicks = skip_clicks
        self.patch = model.backbone.patch_size

    def canvas(self, frame_hw: Tuple[int, int]) -> Tuple[int, int]:
        """The model's canvas for padded frames of ``frame_hw``."""
        return tuple(_ceil_to(max(s, self.target), self.patch)
                     for s in frame_hw)

    def _select(self, st):
        """Clicker, bookkeeping and the adaptive ZoomIn state machine.
        Returns the state entries, the points and the crop geometry:
        ``crop_roi`` [B, 4], ``out_hw`` [B, 2], ``paste_roi`` [B, 4] and
        ``applied`` [B]."""
        sel, points, cand, has_mask = self._click(st)
        # a previous prediction exists from the second click on
        has_mask = has_mask & (st["n"] > 0)
        applied = (st["n"] + 1 > self.skip_clicks) & has_mask
        update = applied & (~st["roi_set"] | self._roi_stale(st, sel, cand))
        roi = torch.where(update[:, None], cand, st["roi"])
        roi_set = st["roi_set"] | applied
        # applied: crop the ROI, resized to round(rh·s), round(rw·s); else
        # the model sees the whole valid frame at its own size
        crop_roi = torch.where(applied[:, None], roi, st["full_roi"])
        rh = crop_roi[:, 1] - crop_roi[:, 0] + 1
        rw = crop_roi[:, 3] - crop_roi[:, 2] + 1
        m = torch.maximum(rh, rw)
        out_hw = torch.where(applied[:, None], torch.stack(
            [round_half_even_div(rh * self.target, m),
             round_half_even_div(rw * self.target, m)], dim=1),
            st["valid_hw"])
        # the quirk: once set, the ROI is pasted through even on a click
        # whose forward saw the full frame
        paste_roi = torch.where(roi_set[:, None], roi, st["full_roi"])
        sel.update(roi=roi, roi_set=roi_set)
        return sel, points, dict(crop_roi=crop_roi, out_hw=out_hw,
                                 paste_roi=paste_roi, applied=applied)

    def _remap_points(self, points, crop_roi, out_hw, applied):
        """Full-frame clicks ``[B, P, 3]`` in crop coordinates where the
        crop applies, -1 rows kept invalid; returns (points, valid)."""
        rmin = crop_roi[:, 0, None].float()
        cmin = crop_roi[:, 2, None].float()
        rh = (crop_roi[:, 1] - crop_roi[:, 0] + 1).float()[:, None]
        rw = (crop_roi[:, 3] - crop_roi[:, 2] + 1).float()[:, None]
        nh = out_hw[:, 0, None].float()
        nw = out_hw[:, 1, None].float()
        valid = points[..., :2].amax(dim=-1) >= 0
        mapped = torch.stack([nh * (points[..., 0] - rmin) / rh,
                              nw * (points[..., 1] - cmin) / rw,
                              points[..., 2]], dim=-1)
        pts = torch.where(applied[:, None, None], mapped, points)
        return pts.masked_fill(~valid[..., None], -1.0), valid

    def _mirror(self, x: torch.Tensor, width: torch.Tensor) -> torch.Tensor:
        """Mirror every lane of ``x`` ``[B, H, Wc, ...]`` within its valid
        ``width`` ``[B]``: column j reads column ``(width - 1 - j) mod Wc``,
        the JAX package's roll of the mirrored canvas (which is its own
        inverse, so it also unmirrors the flipped logits)."""
        wc = x.shape[2]
        j = torch.arange(wc, device=x.device)
        src = torch.remainder(width[:, None] - 1 - j, wc)
        shape = (x.shape[0], 1, wc) + (1,) * (x.ndim - 3)
        return torch.gather(x, 2, src.reshape(shape).expand_as(x))

    def _crop_points(self, st, points, geom, canvas):
        """``[B·nflip, ch, cw, C]`` canvas crops, their points and valid
        extents."""
        crop_roi, out_hw = geom["crop_roi"], geom["out_hw"]
        crop = crop_resize_dyn(st["image"], crop_roi, out_hw, canvas)
        if self.with_prev:
            crop = torch.cat([crop, crop_resize_dyn(
                st["prev"], crop_roi, out_hw, canvas)], dim=-1)
        pts, valid = self._remap_points(points, crop_roi, out_hw,
                                        geom["applied"])
        vhw = out_hw
        if self.with_flip:
            nw = out_hw[:, 1]
            flipped = self._mirror(crop, nw)
            crop = torch.stack([crop, flipped], dim=1).flatten(0, 1)
            fx = nw.float()[:, None] - pts[..., 1] - 1.0
            pts_f = torch.stack([pts[..., 0], fx, pts[..., 2]], dim=-1)
            pts_f = pts_f.masked_fill(~valid[..., None], -1.0)
            pts = torch.stack([pts, pts_f], dim=1).flatten(0, 1)
            vhw = out_hw.repeat_interleave(2, dim=0)
        return crop, pts, vhw

    def _merge(self, logits, out_hw, canvas):
        b = out_hw.shape[0]
        logits = logits.float().reshape(b, self.nflip, *canvas, 1)
        if self.with_flip:
            unflipped = self._mirror(logits[:, 1], out_hw[:, 1])
            return torch.sigmoid(0.5 * (logits[:, 0] + unflipped))
        return torch.sigmoid(logits[:, 0])

    def _body(self, st, active):
        """One click for every lane; finished lanes freeze their outputs."""
        canvas = self.canvas(tuple(st["gt"].shape[1:]))
        sel, points, geom = self._select(st)
        crops, pts, vhw = self._crop_points(st, points, geom, canvas)
        logits = self.model.forward_masked(crops, pts, vhw)["instances"]
        probs = self._merge(logits, geom["out_hw"], canvas)
        prev = inverse_paste_dyn(probs, geom["out_hw"], geom["paste_roi"],
                                 tuple(st["gt"].shape[1:]))
        return self._freeze({**st, **sel, **self._score(st, prev)}, st,
                            active)


def make_adaptive_evaluator(model, target_size: int = 400,
                            max_clicks: int = 20, net_clicks_limit: int = 20,
                            pred_thr: float = 0.49, target_iou: float = 0.90,
                            min_clicks: int = 1, with_flip: bool = True,
                            skip_clicks: int = 1,
                            roi_prob_thresh: float = 0.50,
                            expansion_ratio: float = 1.4,
                            min_crop_size: int = 200,
                            recompute_thresh_iou: float = 0.5,
                            batch_size: int = 1, group_api: bool = False,
                            record_clicks: bool = False, device=None):
    """The adaptive protocol's device loop for ``model`` (an
    ``iSegProbeModel`` on ``device``: CUDA unless ``device="cpu"``), called
    as ``run(images, gts, valid_hws)`` like ``make_device_evaluator``'s.
    ``target_size`` is the scalar RITM target. Any padded frame shape is
    taken, its canvas ``ceil_patch(max(frame, target))`` per side (the JAX
    evaluator's ``frame_hw`` fixes one). ``group_api``
    returns the :class:`GroupEvaluator` over it for
    ``evaluate_dataset_group`` (``batch_size`` > 1). ``record_clicks``
    keeps every click (``.clicks``), as the fixed-crop evaluator's."""
    if skip_clicks < 0:
        raise NotImplementedError(
            "skip_clicks < 0 is the fixed-crop protocol: use "
            "make_device_evaluator")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if group_api and batch_size <= 1:
        raise ValueError("group_api requires batch_size > 1")
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device != device:
        raise ValueError(f"the model lives on {model_device}, the evaluator "
                         f"runs on {device}")
    run = AdaptiveEvaluator(
        model, target_size=target_size, skip_clicks=skip_clicks,
        max_clicks=max_clicks,
        net_clicks_limit=net_clicks_limit, pred_thr=pred_thr,
        target_iou=target_iou, min_clicks=min_clicks, with_flip=with_flip,
        roi_prob_thresh=roi_prob_thresh, expansion_ratio=expansion_ratio,
        min_crop_size=min_crop_size,
        recompute_thresh_iou=recompute_thresh_iou, batch_size=batch_size,
        record_clicks=record_clicks, device=device)
    return GroupEvaluator(run) if group_api else run


def make_adaptive_runner(model, target_size: int, batch_size: int = 1,
                         **protocol_kw) -> AdaptiveEvaluator:
    """The JAX package's name for :func:`make_adaptive_evaluator`."""
    return make_adaptive_evaluator(model, target_size, batch_size=batch_size,
                                   **protocol_kw)


def make_adaptive_group_runner(model, target_size: int, batch_size: int,
                               **protocol_kw) -> GroupEvaluator:
    """The JAX package's name for :func:`make_adaptive_evaluator` with
    ``group_api=True``."""
    return make_adaptive_evaluator(model, target_size, batch_size=batch_size,
                                   group_api=True, **protocol_kw)
