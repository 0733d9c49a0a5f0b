"""On-device NoC evaluation: the whole click protocol on the GPU, lane-batched.

Counterpart of ``isegprobe_tpu/inference/device_eval.py``
(``make_device_evaluator`` and its host-side entry points). The host protocol
(``inference/evaluation.py`` + ``predictor.py``) copies every probability map
to the host for the scipy clicker and the ZoomIn ROI state machine. Here the
clicker (``ops/edt.py:next_click_from_error``, whose EDT row pass is CUDA
kernel C), the ROI state machine, crop, flip, forward, paste, IoU and the
stopping rule all run on the device, for ``B`` samples ("lanes") at once:
per-lane steps are written with a leading lane axis, and the model forward
runs once per click on the stacked ``[B·flip, oh, ow, C]`` crops.

The JAX package compiles the loop into one ``lax.while_loop``; here it is a
Python loop of eager kernels. Its only device-to-host reads are one scalar
per click for the loop condition (any lane still active) and, with the trunk
cache, one more for the batch-level recompute predicate
(:meth:`DeviceEvaluator._read`, counted in ``host_reads``). Every other op is
free of host syncs: tensor indices, no ``.item()``, ``nonzero`` or boolean
masking.

Finished lanes freeze only their outputs (``ious``, ``n``, ``done``), as in
the JAX package: the rest of a finished lane's state may keep evolving, and
nothing it influences reaches a frozen lane's results.

Trunk caching: with ``feats_injection_mode == 'after_backbone'`` the frozen
backbone depends only on the ROI crop, so successive clicks reuse the cached
trunk features and rerun only the click embedding, upsampler and head
(``iSegProbeModel.forward_with_cached_trunk``). The trunk is recomputed when
any active lane's ROI changed.

Continuous batching (``group_api=True``, :class:`GroupEvaluator` and
:func:`evaluate_dataset_group`): a lane that finishes takes the next job
from a staged window of frames on the device, so lanes no longer idle until
their batch's slowest one.

Several devices in one process, as the JAX package spreads the loop over
its chips: ``make_device_evaluator(..., mesh=[dev0, dev1, ...])`` splits
the lane axis over the devices, each running its lanes on its own replica
of the model, in lockstep (:class:`MeshEvaluator`: each step launches every
device's click before reading any flag); ``evaluate_dataset_group(...,
devices=[...])`` deals each shape group's jobs round-robin into one job
queue a device, on replicas made when a device first gets a job. Lanes are
independent, so both give the one-device evaluator's trajectories, and
neither runs a collective. A list may name one device twice.
"""

from __future__ import annotations

import copy
import itertools
from time import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.ops.edt import next_click_from_error
from isegprobe_torch.ops.sample import crop_resize, inverse_paste
from isegprobe_torch.utils import trace

Roi = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _bbox_from_mask(mask: torch.Tensor) -> Roi:
    """Inclusive bbox ``(rmin, rmax, cmin, cmax)`` of each lane of a
    ``[B, H, W]`` bool mask, as float32 ``[B]`` tensors (``(H, -1, W, -1)``
    for an empty lane)."""
    b, h, w = mask.shape
    ridx = torch.arange(h, dtype=torch.float32, device=mask.device)
    cidx = torch.arange(w, dtype=torch.float32, device=mask.device)
    no_row = ~mask.any(dim=2)
    no_col = ~mask.any(dim=1)
    return (ridx.expand(b, h).masked_fill(no_row, h).amin(dim=1),
            ridx.expand(b, h).masked_fill(no_row, -1.0).amax(dim=1),
            cidx.expand(b, w).masked_fill(no_col, w).amin(dim=1),
            cidx.expand(b, w).masked_fill(no_col, -1.0).amax(dim=1))


def _expand_clamp(bbox: Roi, expansion_ratio: float, min_crop_size: int,
                  h_valid: torch.Tensor, w_valid: torch.Tensor) -> Roi:
    """Expand each bbox about its centre by ``expansion_ratio`` (at least
    ``min_crop_size``), round half to even, clamp to the valid extent
    (reference: core/utils/misc.py:80-106), in float32."""
    rmin, rmax, cmin, cmax = bbox
    rcenter = 0.5 * (rmin + rmax)
    ccenter = 0.5 * (cmin + cmax)
    height = (expansion_ratio * (rmax - rmin + 1)).clamp_min(min_crop_size)
    width = (expansion_ratio * (cmax - cmin + 1)).clamp_min(min_crop_size)
    return (torch.round(rcenter - 0.5 * height).clamp_min(0.0),
            torch.minimum(h_valid - 1.0, torch.round(rcenter + 0.5 * height)),
            torch.round(ccenter - 0.5 * width).clamp_min(0.0),
            torch.minimum(w_valid - 1.0, torch.round(ccenter + 0.5 * width)))


def _segments_iou(a0, a1, b0, b1) -> torch.Tensor:
    inter = (torch.minimum(a1, b1) - torch.maximum(a0, b0) + 1).clamp_min(0.0)
    union = (torch.maximum(a1, b1) - torch.minimum(a0, b0) + 1).clamp_min(
        1e-6)
    return inter / union


def _bbox_iou(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """IoU of ``[B, 4]`` float bboxes ``(rmin, rmax, cmin, cmax)``."""
    return (_segments_iou(b1[:, 0], b1[:, 1], b2[:, 0], b2[:, 1])
            * _segments_iou(b1[:, 2], b1[:, 3], b2[:, 2], b2[:, 3]))


def _lane_where(mask: torch.Tensor, new: torch.Tensor,
                old: torch.Tensor) -> torch.Tensor:
    """``new`` where the ``[B]`` lane mask holds, else ``old``."""
    return torch.where(mask.reshape(-1, *[1] * (new.ndim - 1)), new, old)


class DeviceEvaluator:
    """The click loop :func:`make_device_evaluator` builds.

    Call it with device tensors. ``batch_size == 1``: image ``[hp, wp, 3]``
    (uint8, or float in [0, 1]), gt ``[hp, wp]`` (1 object, -1 ignore),
    valid_hw ``[2]`` -> (ious ``[max_clicks]``, n ``[]``). ``batch_size >
    1``: the same with a leading lane axis of ``batch_size``. Counters, for
    the caller to read: ``steps`` (loop steps run), ``host_reads`` (device
    reads inside the loop) and ``trunk_recomputes``. With
    ``record_clicks``, ``clicks`` holds a call's clicks ``[B, max_clicks,
    3]`` (y, x, is_positive; -1 past each lane's count) after it; without,
    the loop keeps no click record and ``clicks`` stays None."""

    def __init__(self, model, *, target_size: Tuple[int, int],
                 max_clicks: int, net_clicks_limit: int, pred_thr: float,
                 target_iou: float, min_clicks: int, with_flip: bool,
                 roi_prob_thresh: float, expansion_ratio: float,
                 min_crop_size: int, recompute_thresh_iou: float,
                 batch_size: int, use_cache: bool, record_clicks: bool,
                 device) -> None:
        self.model = model
        self.target_size = tuple(target_size)
        self.max_clicks = max_clicks
        self.nmax = net_clicks_limit
        self.pred_thr = pred_thr
        self.target_iou = target_iou
        self.min_clicks = min_clicks
        self.with_flip = with_flip
        self.nflip = 2 if with_flip else 1
        self.roi_prob_thresh = roi_prob_thresh
        self.expansion_ratio = expansion_ratio
        self.min_crop_size = min_crop_size
        self.recompute_thresh_iou = recompute_thresh_iou
        self.batch_size = batch_size
        self.use_cache = use_cache
        self.record_clicks = record_clicks
        self.device = device
        self.with_prev = getattr(model, "with_prev_mask", False)
        self.steps = 0
        self.host_reads = 0
        self.trunk_recomputes = 0
        self.clicks: Optional[torch.Tensor] = None

    # -- the loop's allowed host reads --------------------------------------

    def _read(self, flag: torch.Tensor):
        """One allowed device-to-host read: a scalar flag as a bool, or a
        few flags stacked in one tensor as a list. On CUDA, a
        ``torch.cuda.set_sync_debug_mode`` set by the caller is lifted
        around it, so that mode catches every other sync of a click."""
        self.host_reads += 1
        mode = torch.cuda.get_sync_debug_mode() if flag.is_cuda else 0
        with trace.span("loop.read"):
            if not mode:
                return flag.tolist()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return flag.tolist()
            finally:
                torch.cuda.set_sync_debug_mode(mode)

    # -- per-lane protocol steps, over the leading lane axis ----------------

    def _init_state(self, images, gts, valid_hws) -> Dict[str, torch.Tensor]:
        st = self._init_lanes(images, gts, valid_hws)
        if self.use_cache:
            # serves click 1: with an empty prediction the first ROI
            # candidate is the full frame, which this trunk was computed for
            st["trunk"] = self._trunk(images, st["full_roi"])
            st["trunk_roi"] = st["full_roi"]
        return st

    def _init_group_state(self, images, gts, valid_hws
                          ) -> Dict[str, torch.Tensor]:
        """The lane state a job queue starts from: every lane parked. The
        trunk is not computed: every lane that takes a job has its trunk
        ROI poisoned, so the first step recomputes it."""
        st = self._init_lanes(images, gts, valid_hws)
        st["done"] = torch.ones_like(st["done"])
        if self.use_cache:
            st["trunk"] = None
            st["trunk_roi"] = torch.full_like(st["full_roi"], -1)
        return st

    def _init_lanes(self, images, gts, valid_hws) -> Dict[str, torch.Tensor]:
        """Every lane's protocol state at its first click (no trunk)."""
        b, hp, wp = gts.shape
        dev = gts.device
        rows = torch.arange(hp, device=dev)[None, :, None]
        cols = torch.arange(wp, device=dev)[None, None, :]
        valid_hws = valid_hws.long()
        in_valid = ((rows < valid_hws[:, 0, None, None])
                    & (cols < valid_hws[:, 1, None, None]))
        zero = torch.zeros_like(valid_hws[:, 0])
        full_roi = torch.stack([zero, valid_hws[:, 0] - 1, zero,
                                valid_hws[:, 1] - 1], dim=1)

        def lanes(value, dtype=torch.float32):
            return torch.full((b,), value, dtype=dtype, device=dev)

        st = dict(
            # loop-invariant lane context; the image stays in its own dtype
            # (uint8 for real datasets) and is normalised at read time
            image=images,
            gt=gts == 1,
            not_ignore=(gts != -1) & in_valid,
            in_valid=in_valid,
            valid_hw=valid_hws,
            full_roi=full_roi,
            # mutable protocol state
            prev=torch.zeros((b, hp, wp, 1), dtype=torch.float32, device=dev),
            not_clicked=torch.ones((b, hp, wp), dtype=torch.bool, device=dev),
            pos_pts=torch.full((b, self.nmax, 3), -1.0, device=dev),
            neg_pts=torch.full((b, self.nmax, 3), -1.0, device=dev),
            n_pos=lanes(0, torch.long),
            n_neg=lanes(0, torch.long),
            # every positive click ever made (ZoomIn sees the untruncated
            # list) and their running extremes
            pos_mask=torch.zeros((b, hp, wp), dtype=torch.bool, device=dev),
            pos_ymin=lanes(float("inf")),
            pos_ymax=lanes(float("-inf")),
            pos_xmin=lanes(float("inf")),
            pos_xmax=lanes(float("-inf")),
            roi=full_roi,
            roi_set=lanes(False, torch.bool),
            ious=torch.zeros((b, self.max_clicks), device=dev),
            n=lanes(0, torch.long),
            done=lanes(False, torch.bool),
        )
        if self.record_clicks:  # every click (y, x, is_positive), -1 past n
            st["clicks"] = torch.full((b, self.max_clicks, 3), -1,
                                      dtype=torch.long, device=dev)
        return st

    def _select(self, st):
        """Clicker, click bookkeeping and the ZoomIn ROI update of every
        lane. ``not_clicked`` and ``pos_mask`` are updated in place. Returns
        the updated state entries and the ``[B, 2·nmax, 3]`` points."""
        sel, points, cand, has_mask = self._click(st)
        # ZoomIn ROI state machine (reference: zoom_in.py:51-97): a candidate
        # exists only when the predicted mask is non-empty
        cand = torch.where(has_mask[:, None], cand, st["full_roi"])
        update = ~st["roi_set"] | self._roi_stale(st, sel, cand)
        sel.update(roi=torch.where(update[:, None], cand, st["roi"]),
                   roi_set=torch.ones_like(st["roi_set"]))
        return sel, points

    def _roi_stale(self, st, sel, cand) -> torch.Tensor:
        """``[B]``: the current ROI no longer holds every positive click
        (half-open upper bounds) or overlaps the candidate by less than
        ``recompute_thresh_iou``."""
        cur = st["roi"].float()
        clicks_inside = ((sel["pos_ymin"] >= cur[:, 0])
                         & (sel["pos_ymax"] < cur[:, 1])
                         & (sel["pos_xmin"] >= cur[:, 2])
                         & (sel["pos_xmax"] < cur[:, 3])
                         ) | ~torch.isfinite(sel["pos_ymin"])
        iou_ok = _bbox_iou(cand.float(), cur) >= self.recompute_thresh_iou
        return ~clicks_inside | ~iou_ok

    def _click(self, st):
        """The clicker and the click bookkeeping of every lane, and the
        ZoomIn ROI candidate: the expanded, clamped bbox of the predicted
        mask (at ``roi_prob_thresh``) with every positive click in it.
        Returns (state entries, points ``[B, 2·nmax, 3]``, candidate
        ``[B, 4]``, whether the predicted mask is non-empty ``[B]``)."""
        b, hp, wp = st["gt"].shape
        dev = st["gt"].device
        prev2d = st["prev"][..., 0]
        is_pos, cy, cx = next_click_from_error(
            st["gt"], prev2d > self.pred_thr, st["not_clicked"],
            st["not_ignore"])
        cyf, cxf = cy.float(), cx.float()

        # the model's point buffers keep the first net_clicks_limit clicks
        # chronologically: a slot is written only while the click index is
        # below the limit, so the newest kept click is never overwritten
        keep = st["n"] < self.nmax
        row = torch.stack([cyf, cxf, st["n"].float()], dim=1)[:, None, :]
        slots = torch.arange(self.nmax, device=dev)[None, :]
        put_pos = (slots == st["n_pos"][:, None]) & (is_pos & keep)[:, None]
        put_neg = (slots == st["n_neg"][:, None]) & (~is_pos & keep)[:, None]
        pos_pts = torch.where(put_pos[..., None], row, st["pos_pts"])
        neg_pts = torch.where(put_neg[..., None], row, st["neg_pts"])
        n_pos = st["n_pos"] + (is_pos & keep)
        n_neg = st["n_neg"] + (~is_pos & keep)

        flat = (cy * wp + cx)[:, None]
        not_clicked = st["not_clicked"]
        not_clicked.view(b, -1).scatter_(1, flat, False)
        pos_mask = st["pos_mask"]
        pm = pos_mask.view(b, -1)
        pm.scatter_(1, flat, pm.gather(1, flat) | is_pos[:, None])

        def extreme(op, key, v):
            return torch.where(is_pos, op(st[key], v), st[key])

        pos_ymin = extreme(torch.minimum, "pos_ymin", cyf)
        pos_ymax = extreme(torch.maximum, "pos_ymax", cyf)
        pos_xmin = extreme(torch.minimum, "pos_xmin", cxf)
        pos_xmax = extreme(torch.maximum, "pos_xmax", cxf)

        # the ROI candidate: positive clicks join the predicted mask before
        # the bbox
        roi_mask = (prev2d > self.roi_prob_thresh) & st["in_valid"]
        has_mask = roi_mask.flatten(1).any(dim=1)
        h_valid = st["valid_hw"][:, 0].float()
        w_valid = st["valid_hw"][:, 1].float()
        cand = _expand_clamp(_bbox_from_mask(roi_mask | pos_mask),
                             self.expansion_ratio, self.min_crop_size,
                             h_valid, w_valid)
        cand = torch.stack(cand, dim=1).long()

        sel = dict(pos_pts=pos_pts, neg_pts=neg_pts, n_pos=n_pos, n_neg=n_neg,
                   not_clicked=not_clicked, pos_mask=pos_mask,
                   pos_ymin=pos_ymin, pos_ymax=pos_ymax, pos_xmin=pos_xmin,
                   pos_xmax=pos_xmax)
        if self.record_clicks:
            at_n = (torch.arange(self.max_clicks, device=dev)[None, :]
                    == st["n"][:, None])
            sel["clicks"] = torch.where(
                at_n[..., None],
                torch.stack([cy, cx, is_pos.long()], 1)[:, None],
                st["clicks"])
        return sel, torch.cat([pos_pts, neg_pts], dim=1), cand, has_mask

    def _roi_points(self, roi, points):
        """Full-frame clicks ``[B, P, 3]`` in ROI-crop coordinates, -1 rows
        kept invalid; returns (points, valid)."""
        oh, ow = self.target_size
        rmin = roi[:, 0, None].float()
        cmin = roi[:, 2, None].float()
        rh = (roi[:, 1] - roi[:, 0] + 1).float()[:, None]
        rw = (roi[:, 3] - roi[:, 2] + 1).float()[:, None]
        valid = points[..., :2].amax(dim=-1) >= 0
        pts = torch.stack([oh * (points[..., 0] - rmin) / rh,
                           ow * (points[..., 1] - cmin) / rw,
                           points[..., 2]], dim=-1)
        return pts.masked_fill(~valid[..., None], -1.0), valid

    def _flip_stack(self, crop: torch.Tensor) -> torch.Tensor:
        """``[B, oh, ow, C]`` -> ``[B·nflip, oh, ow, C]``, each lane followed
        by its width flip."""
        if not self.with_flip:
            return crop
        return torch.stack([crop, crop.flip(2)], dim=1).flatten(0, 1)

    def _crop_points(self, image, prev, roi, points):
        """Model inputs for every lane: ``[B·nflip, oh, ow, C]`` crops and
        ``[B·nflip, P, 3]`` points. Image and previous mask are cropped
        separately (per-channel interpolation makes that identical)."""
        crop = crop_resize(image, roi, self.target_size)
        if self.with_prev:
            crop = torch.cat(
                [crop, crop_resize(prev, roi, self.target_size)],
                dim=-1)
        pts, valid = self._roi_points(roi, points)
        if self.with_flip:
            fx = self.target_size[1] - pts[..., 1] - 1.0
            flipped = torch.stack([pts[..., 0], fx, pts[..., 2]], dim=-1)
            flipped = flipped.masked_fill(~valid[..., None], -1.0)
            pts = torch.stack([pts, flipped], dim=1).flatten(0, 1)
        return self._flip_stack(crop), pts

    def _trunk(self, images, rois) -> torch.Tensor:
        """Click-independent trunk features of every lane's image crop."""
        crop = crop_resize(images, rois, self.target_size)
        return self.model.compute_backbone_trunk(self._flip_stack(crop))

    def _merge_flip(self, logits: torch.Tensor, b: int) -> torch.Tensor:
        oh, ow = self.target_size
        logits = logits.float().reshape(b, self.nflip, oh, ow, 1)
        if self.with_flip:
            return torch.sigmoid(0.5 * (logits[:, 0] + logits[:, 1].flip(2)))
        return torch.sigmoid(logits[:, 0])

    def _score(self, st, prev):
        """The pasted probabilities ``prev``, their IoU over ``not_ignore``
        and the stopping rule."""
        new_mask = prev[..., 0] > self.pred_thr
        inter = (new_mask & st["gt"] & st["not_ignore"]).flatten(1).sum(1)
        union = ((new_mask | st["gt"]) & st["not_ignore"]).flatten(1).sum(1)
        iou = inter / union.clamp_min(1)
        slots = torch.arange(self.max_clicks, device=iou.device)[None, :]
        ious = torch.where(slots == st["n"][:, None], iou[:, None],
                           st["ious"])
        n = st["n"] + 1
        # the reference gates the early stop on a minimum click count
        done = (iou >= self.target_iou) & (n >= self.min_clicks)
        return dict(prev=prev, ious=ious, n=n, done=done)

    def _body(self, st, active):
        """One click for every lane; finished lanes freeze their outputs."""
        b = active.shape[0]
        with trace.span("loop.clicker"):
            sel, points = self._select(st)
        with trace.span("loop.crop"):
            crops, pts = self._crop_points(st["image"], st["prev"],
                                           sel["roi"], points)
        if self.use_cache:
            changed = ((sel["roi"] != st["trunk_roi"]).any(dim=1)
                       & active).any()
            trunk, trunk_roi = st["trunk"], st["trunk_roi"]
            if self._read(changed):
                with trace.span("loop.trunk"):
                    trunk = self._trunk(st["image"], sel["roi"])
                trunk_roi = sel["roi"]
                self.trunk_recomputes += 1
            with trace.span("loop.forward"):
                logits = self.model.forward_with_cached_trunk(
                    crops, pts, trunk)["instances"]
        else:
            with trace.span("loop.forward"):
                logits = self.model(crops, pts)["instances"]
        with trace.span("loop.score"):
            prev = inverse_paste(self._merge_flip(logits, b), sel["roi"],
                                 tuple(st["gt"].shape[1:]))
            new = {**st, **sel, **self._score(st, prev)}
            if self.use_cache:
                new["trunk"], new["trunk_roi"] = trunk, trunk_roi
            return self._freeze(new, st, active)

    def _freeze(self, new, st, active):
        """``new`` with the outputs of lanes not in ``active`` kept as in
        ``st``."""
        for k in ("ious", "n", "done") + (
                ("clicks",) if self.record_clicks else ()):
            new[k] = _lane_where(active, new[k], st[k])
        return new

    @torch.inference_mode()
    def _run(self, images, gts, valid_hws):
        """The loop: under ``torch.profiler``, a ``loop.init`` span (the
        state and the first flag's read), then one ``loop.step`` span a
        step (``rid``: the step's index in ``steps``) over the click and
        the read of the flag it leaves."""
        for name, t in (("image", images), ("gt", gts),
                        ("valid_hw", valid_hws)):
            if t.device != self.device:
                raise ValueError(f"{name} lives on {t.device}, the evaluator "
                                 f"runs on {self.device}")
        if images.shape[0] != self.batch_size:
            raise ValueError(f"expected {self.batch_size} lanes, got "
                             f"{images.shape[0]}")
        with trace.span("loop.init"):
            st = self._init_state(images, gts, valid_hws)
            active = ~st["done"] & (st["n"] < self.max_clicks)
            go = self._read(active.any())
        while go:
            with trace.span("loop.step", rid=self.steps):
                st = self._body(st, active)
                self.steps += 1
                active = ~st["done"] & (st["n"] < self.max_clicks)
                go = self._read(active.any())
        self.clicks = st.get("clicks")
        return st["ious"], st["n"]

    def __call__(self, images: torch.Tensor, gts: torch.Tensor,
                 valid_hws: torch.Tensor):
        if self.batch_size == 1:
            ious, n = self._run(images[None], gts[None], valid_hws[None])
            return ious[0], n[0]
        return self._run(images, gts, valid_hws)

    def replica(self, device) -> "DeviceEvaluator":
        """The same protocol on ``device``, over a copy of the model there,
        with its own counters."""
        other = copy.copy(self)
        other.model = copy.deepcopy(self.model).to(device)
        other.device = torch.device(device)
        other.steps = other.host_reads = other.trunk_recomputes = 0
        other.clicks = None
        return other


class MeshEvaluator:
    """The lockstep click loop over several devices: lanes ``[i·b, (i+1)·b)``
    of a call run on device ``i`` (``shards[i]``, a :class:`DeviceEvaluator`
    of ``b`` lanes over that device's replica). Called as a
    :class:`DeviceEvaluator` of all the lanes, with inputs on the first
    device, where the outputs come back. Each step starts every device's
    click before it reads a device's flag, so the devices compute at once;
    a device whose lanes are all done sits the step out. ``steps`` counts
    the lockstep steps, ``host_reads`` and ``trunk_recomputes`` sum the
    shards'."""

    def __init__(self, shards: List[DeviceEvaluator]) -> None:
        self.shards = shards
        first = shards[0]
        self.device = first.device
        self.batch_size = sum(s.batch_size for s in shards)
        self.max_clicks = first.max_clicks
        self.record_clicks = first.record_clicks
        self.steps = 0
        self.clicks: Optional[torch.Tensor] = None

    @property
    def host_reads(self) -> int:
        return sum(s.host_reads for s in self.shards)

    @property
    def trunk_recomputes(self) -> int:
        return sum(s.trunk_recomputes for s in self.shards)

    @torch.inference_mode()
    def __call__(self, images: torch.Tensor, gts: torch.Tensor,
                 valid_hws: torch.Tensor):
        one = self.batch_size == 1
        if one:
            images, gts, valid_hws = images[None], gts[None], valid_hws[None]
        if images.shape[0] != self.batch_size:
            raise ValueError(f"expected {self.batch_size} lanes, got "
                             f"{images.shape[0]}")
        states, lo = [], 0
        for sh in self.shards:
            part = slice(lo, lo + sh.batch_size)
            lo += sh.batch_size
            states.append(sh._init_state(
                *(t[part].to(sh.device, non_blocking=True)
                  for t in (images, gts, valid_hws))))
        mc = self.max_clicks
        while True:
            actives = [~st["done"] & (st["n"] < mc) for st in states]
            flags = [sh._read(a.any()) for sh, a in zip(self.shards, actives)]
            if not any(flags):
                break
            for i, sh in enumerate(self.shards):
                if flags[i]:
                    states[i] = sh._body(states[i], actives[i])
                    sh.steps += 1
            self.steps += 1

        def gather(key):
            return torch.cat([st[key].to(self.device) for st in states])

        ious, n = gather("ious"), gather("n")
        self.clicks = gather("clicks") if self.record_clicks else None
        return (ious[0], n[0]) if one else (ious, n)


class GroupEvaluator:
    """Continuous batching: the click loop of a lane protocol (a
    :class:`DeviceEvaluator`, or ``inference.adaptive_eval``'s adaptive
    one) over an on-device job queue, the counterpart of the JAX package's
    ``make_windowed_group_evaluator`` / ``_GroupEvaluator``. A lane that
    finishes writes its job's results into the queue's output rows and
    takes the next job from a staged window of frames at once, instead of
    idling until its batch's slowest lane.

    ``init(imgs, gts, hws)`` builds an all-parked lane state for the first
    window; ``stepper(st, q, imgs, gts, hws, n_valid, win_base)`` runs
    the protocol until every job is done or a lane wants a job beyond the
    staged window (``want_refill``), and returns ``(st, q)``: the lane
    state carries across windows, so a window switch pauses the busy lanes
    at a step boundary rather than draining them. Jobs are handed out on
    the device, without a host read of their own: a cumulative sum over the lanes that
    want one and the window's index of each lane's next job. The loop reads
    one pair of flags a step, ``any(active) & ~want_refill`` and whether a
    lane took a job; only then are the taken frames gathered from the
    window and their fresh lane state put in with ``torch.where``. With a
    trunk cache a refilled lane poisons its trunk ROI, so that the
    batch-level predicate recomputes the trunk for its first click.
    ``fills`` counts the hand-outs that started a lane.
    ``evaluate_dataset_group`` drives it."""

    def __init__(self, protocol) -> None:
        self.protocol = protocol
        self.fills = 0
        self.batch_size = protocol.batch_size
        self.max_clicks = protocol.max_clicks
        self.device = protocol.device
        self.record_clicks = protocol.record_clicks

    @property
    def steps(self) -> int:
        return self.protocol.steps

    def replica(self, device) -> "GroupEvaluator":
        """The same job queue on ``device``, over a copy of the model
        there."""
        return GroupEvaluator(self.protocol.replica(device))

    def init(self, imgs, gts, hws) -> Dict[str, torch.Tensor]:
        b = self.batch_size
        return self.protocol._init_group_state(imgs[:b], gts[:b], hws[:b])

    def queue(self, n_rows: int) -> Dict[str, torch.Tensor]:
        """An empty queue of ``n_rows`` output rows and one scratch row (the
        target of idle lanes' writes); every lane parked on it."""
        dev, b = self.device, self.batch_size
        q = dict(job_id=torch.full((b,), n_rows, dtype=torch.long,
                                   device=dev),
                 next_job=torch.zeros((), dtype=torch.long, device=dev),
                 out_ious=torch.zeros((n_rows + 1, self.max_clicks),
                                      device=dev),
                 out_n=torch.zeros((n_rows + 1,), dtype=torch.long,
                                   device=dev),
                 want_refill=torch.zeros((), dtype=torch.bool, device=dev))
        if self.record_clicks:
            q["out_clicks"] = torch.full((n_rows + 1, self.max_clicks, 3),
                                         -1, dtype=torch.long, device=dev)
        return q

    @staticmethod
    def _hand_out(q, want, w: int, n_valid, win_base):
        """The window's next jobs for the lanes in ``want``, in lane order:
        the lanes that take one, each lane's window index and the queue
        after. A lane whose next job lies beyond the window stays parked
        and raises ``want_refill``."""
        cand = q["next_job"] + torch.cumsum(want.long(), 0) - 1
        in_sweep = cand < n_valid
        take = want & in_sweep & (cand < win_base + w)
        q = dict(q, job_id=torch.where(take, cand, q["job_id"]),
                 next_job=q["next_job"] + take.sum(),
                 want_refill=q["want_refill"]
                 | (want & in_sweep & ~take).any())
        return take, (cand - win_base).clamp(0, w - 1), q

    def _fill(self, st, take, rel, win):
        """``st`` with the lanes in ``take`` started on window frames
        ``rel``."""
        imgs, gts, hws = win
        fresh = self.protocol._init_lanes(imgs[rel], gts[rel], hws[rel])
        st = dict(st)
        for k, v in fresh.items():
            st[k] = _lane_where(take, v, st[k])
        if self.protocol.use_cache:
            st["trunk_roi"] = st["trunk_roi"].masked_fill(take[:, None], -1)
        return st

    @torch.inference_mode()
    def stepper(self, st, q, imgs, gts, hws, n_valid: torch.Tensor,
                win_base: torch.Tensor):
        """Runs the protocol over one staged window (see the class
        docstring) as a generator that leaves the host reads to its
        driver: it yields each step's flag pair (a device tensor), takes
        the pair read back (through the protocol's ``_read``) by ``send``
        and returns ``(st, q)``. :func:`evaluate_dataset_group` drives
        several queues in lockstep: every queue's step is started before
        any queue's flags are read, so their devices compute at once."""
        p, mc = self.protocol, self.max_clicks
        win, w = (imgs, gts, hws), imgs.shape[0]
        sent = q["out_n"].shape[0] - 1  # the scratch row
        q = dict(q, want_refill=torch.zeros_like(q["want_refill"]))
        # the first hand-out serves the parked lanes: the chain's start and
        # every window switch
        want = q["job_id"] == sent
        busy = ~st["done"] & (st["n"] < mc)
        while True:
            take, rel, q = self._hand_out(q, want, w, n_valid, win_base)
            # a lane that takes a job starts it at click 0, not done
            active = busy | take
            go, took = yield torch.stack(
                [active.any() & ~q["want_refill"], take.any()])
            if took:
                st = self._fill(st, take, rel, win)
                self.fills += 1
            if not go:
                return st, q
            st = p._body(st, active)
            p.steps += 1
            fin = active & (st["done"] | (st["n"] >= mc))
            # finished lanes write their job's row; the rest write the
            # scratch row, where colliding writes do no harm
            tgt = torch.where(fin, q["job_id"], sent)
            q["out_ious"].index_put_((tgt,), st["ious"])
            q["out_n"].index_put_((tgt,), st["n"])
            if self.record_clicks:
                q["out_clicks"].index_put_((tgt,), st["clicks"])
            q = dict(q, job_id=torch.where(fin, sent, q["job_id"]))
            want, busy = fin, active & ~fin


def make_device_evaluator(model, target_size: Tuple[int, int] = (448, 448),
                          max_clicks: int = 20, net_clicks_limit: int = 20,
                          pred_thr: float = 0.49, target_iou: float = 0.90,
                          min_clicks: int = 1, with_flip: bool = True,
                          roi_prob_thresh: float = 0.50,
                          expansion_ratio: float = 1.4,
                          min_crop_size: int = 200,
                          recompute_thresh_iou: float = 0.5,
                          batch_size: int = 1, mesh=None,
                          trunk_cache: str = "auto", group_api: bool = False,
                          record_clicks: bool = False,
                          device=None):
    """Build the on-device NoC evaluator for ``model`` (an
    ``iSegProbeModel`` living on ``device``: CUDA unless ``device="cpu"``).
    Returns a :class:`DeviceEvaluator`, called as ``run(image, gt,
    valid_hw)``; ``batch_size > 1`` runs that many lanes in lockstep.

    ``trunk_cache``: ``'auto'`` caches the click-independent trunk when the
    backbone injects clicks ``after_backbone``; ``'on'`` forces it (and
    raises for other injection modes); ``'off'`` disables it.
    ``record_clicks`` keeps every click on the device for the caller
    (``DeviceEvaluator.clicks``; the JAX evaluator has no such record), at
    a few small ops a step.
    ``group_api`` returns the
    :class:`GroupEvaluator` over this protocol, for
    :func:`evaluate_dataset_group` (continuous batching; ``batch_size`` >
    1). ``mesh`` (a list of devices) returns a :class:`MeshEvaluator`: the
    ``batch_size`` lanes split evenly over the devices (it must divide),
    each device running its lanes on its replica of the model (the model
    itself on its own device; a copy on each other entry, a repeated
    device included); ``device`` is then the first device, where the
    inputs and outputs live. ``group_api`` with ``mesh`` raises, as in
    JAX: use ``evaluate_dataset_group(devices=...)``."""
    if mesh is not None:
        if group_api:
            raise ValueError("group_api takes no mesh (the job queue is one "
                             "device's); use evaluate_dataset_group("
                             "devices=...) or the lockstep evaluator with "
                             "mesh")
        devices = [resolve_device(d) for d in mesh]
        if batch_size % len(devices):
            raise ValueError(f"batch_size {batch_size} not divisible by the "
                             f"{len(devices)} devices of the mesh")
        kw = dict(target_size=target_size, max_clicks=max_clicks,
                  net_clicks_limit=net_clicks_limit, pred_thr=pred_thr,
                  target_iou=target_iou, min_clicks=min_clicks,
                  with_flip=with_flip, roi_prob_thresh=roi_prob_thresh,
                  expansion_ratio=expansion_ratio,
                  min_crop_size=min_crop_size,
                  recompute_thresh_iou=recompute_thresh_iou,
                  batch_size=batch_size // len(devices),
                  trunk_cache=trunk_cache, record_clicks=record_clicks)
        home = next(model.parameters()).device
        first = make_device_evaluator(
            model if devices[0] == home else
            copy.deepcopy(model).to(devices[0]), device=devices[0], **kw)
        shards = [first] + [first.replica(d) for d in devices[1:]]
        return MeshEvaluator(shards)
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
    if group_api and batch_size <= 1:
        raise ValueError("group_api requires batch_size > 1")
    if trunk_cache not in ("auto", "on", "off"):
        raise ValueError(f"trunk_cache must be 'auto', 'on' or 'off', got "
                         f"{trunk_cache!r}")
    injection = getattr(model.backbone, "feats_injection_mode",
                        "no_injection")
    if trunk_cache == "on" and injection != "after_backbone":
        raise ValueError(
            f"trunk_cache='on' requires feats_injection_mode="
            f"'after_backbone' (the trunk must be click-independent); got "
            f"{injection!r}")
    device = resolve_device(device)
    model_device = next(model.parameters()).device
    if model_device != device:
        raise ValueError(f"the model lives on {model_device}, the evaluator "
                         f"runs on {device}")
    use_cache = trunk_cache == "on" or (trunk_cache == "auto"
                                        and injection == "after_backbone")
    run = DeviceEvaluator(
        model, target_size=target_size, max_clicks=max_clicks,
        net_clicks_limit=net_clicks_limit, pred_thr=pred_thr,
        target_iou=target_iou, min_clicks=min_clicks, with_flip=with_flip,
        roi_prob_thresh=roi_prob_thresh, expansion_ratio=expansion_ratio,
        min_crop_size=min_crop_size,
        recompute_thresh_iou=recompute_thresh_iou, batch_size=batch_size,
        use_cache=use_cache, record_clicks=record_clicks, device=device)
    return GroupEvaluator(run) if group_api else run


# ---------------------------------------------------------------------------
# Host-side entry points
# ---------------------------------------------------------------------------


_dataset_calls = itertools.count()


def _pad_job(image: np.ndarray, gt_mask: np.ndarray, bucket: int):
    """Zero-pad one object's image and mask to ``bucket``-pixel multiples;
    returns (image, gt, valid_hw) numpy arrays. uint8 images stay uint8."""
    h, w = image.shape[:2]
    hp = -(-h // bucket) * bucket
    wp = -(-w // bucket) * bucket
    image_pad = np.zeros((hp, wp, 3), image.dtype
                         if image.dtype == np.uint8 else np.float32)
    image_pad[:h, :w] = image
    gt_dtype = np.int8 if (gt_mask.min() >= -128 and gt_mask.max() <= 127) \
        else np.int32
    gt_pad = np.zeros((hp, wp), gt_dtype)
    gt_pad[:h, :w] = gt_mask
    return image_pad, gt_pad, np.asarray([h, w], np.int32)


def _build_jobs(dataset, bucket: int):
    """Walk the dataset into padded jobs, grouped by padded frame shape
    (the lanes of one call share a shape)."""
    jobs = []
    for index in range(len(dataset)):
        sample = dataset.get_sample(index)
        for object_id in sample.objects_ids:
            jobs.append(_pad_job(sample.image, sample.gt_mask(object_id),
                                 bucket))
    by_shape: Dict[tuple, list] = {}
    for order_idx, (img, gt, hw) in enumerate(jobs):
        by_shape.setdefault(img.shape, []).append((order_idx, img, gt, hw))
    return jobs, by_shape


def _upload(run_fn: DeviceEvaluator, *arrays: np.ndarray):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(run_fn.device)
            for a in arrays]


def evaluate_sample_device(run_fn: DeviceEvaluator, image: np.ndarray,
                           gt_mask: np.ndarray, bucket: int = 64
                           ) -> np.ndarray:
    """One object through a ``batch_size == 1`` evaluator: pad to the
    bucket, run the loop, return the per-click IoUs."""
    if run_fn.batch_size != 1:
        raise ValueError("evaluate_sample_device needs a batch_size 1 "
                         "evaluator; use evaluate_dataset_device")
    ious, n = run_fn(*_upload(run_fn, *_pad_job(image, gt_mask, bucket)))
    return ious.cpu().numpy()[: int(n)]


def evaluate_dataset_device(run_fn: DeviceEvaluator, dataset,
                            bucket: int = 64,
                            sample_times: Optional[list] = None,
                            clicks: Optional[list] = None
                            ) -> List[np.ndarray]:
    """Every object of ``dataset`` through the device loop; per-click IoUs
    in dataset order.

    With ``run_fn.batch_size > 1`` jobs are grouped by padded shape and
    chunked into batches; the tail chunk is padded with its last job, whose
    duplicates are discarded. ``sample_times`` (a list) receives one wall
    time per sample: the run of the chunk it rode in; ``clicks`` (a list)
    each sample's clicks ``[n, 3]`` (y, x, is_positive; ``run_fn`` must
    record them). Chunks run one after
    the other: the loop's per-click reads keep host and device in step, so
    there is nothing for the JAX package's ``depth`` pipelining to overlap in
    eager PyTorch, and the port has no such parameter. Under
    ``torch.profiler`` the call is a ``loop.dataset`` span (``rid``: the
    call's serial number) over ``loop.jobs`` and, a chunk, ``loop.upload``,
    ``loop.run`` and ``loop.results``."""
    if clicks is not None and not run_fn.record_clicks:
        raise ValueError("clicks= needs an evaluator made with "
                         "record_clicks=True")
    with trace.span("loop.dataset", rid=next(_dataset_calls)):
        b = run_fn.batch_size
        if b == 1:
            all_ious = []
            for index in range(len(dataset)):
                sample = dataset.get_sample(index)
                for object_id in sample.objects_ids:
                    t0 = time()
                    all_ious.append(evaluate_sample_device(
                        run_fn, sample.image, sample.gt_mask(object_id),
                        bucket))
                    if sample_times is not None:
                        sample_times.append(time() - t0)
                    if clicks is not None:
                        clicks.append(run_fn.clicks[0, :len(all_ious[-1])]
                                      .cpu().numpy())
            return all_ious

        with trace.span("loop.jobs"):
            jobs, by_shape = _build_jobs(dataset, bucket)
        results: List[Optional[np.ndarray]] = [None] * len(jobs)
        job_clicks: List[Optional[np.ndarray]] = [None] * len(jobs)
        for group in by_shape.values():
            for lo in range(0, len(group), b):
                chunk = group[lo:lo + b]
                chunk = chunk + [chunk[-1]] * (b - len(chunk))
                t0 = time()
                with trace.span("loop.upload"):
                    imgs, gts, hws = _upload(
                        run_fn, *(np.stack([job[k] for job in chunk])
                                  for k in (1, 2, 3)))
                with trace.span("loop.run"):
                    ious, n = run_fn(imgs, gts, hws)
                with trace.span("loop.results"):
                    ious, n = ious.cpu().numpy(), n.cpu().numpy()
                    wall = time() - t0
                    if clicks is not None:
                        lane_clicks = run_fn.clicks.cpu().numpy()
                seen = set()
                for lane, (order_idx, *_rest) in enumerate(chunk):
                    if order_idx in seen:  # tail padding repeats the last job
                        continue
                    seen.add(order_idx)
                    results[order_idx] = ious[lane][: int(n[lane])]
                    if clicks is not None:
                        job_clicks[order_idx] = (
                            lane_clicks[lane][: int(n[lane])])
                    if sample_times is not None:
                        sample_times.append(wall)
        if clicks is not None:
            clicks.extend(job_clicks)
        return results


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def _window_frames(batch: int, cap: int, n: int) -> int:
    """The frames of each window of a group of ``n`` jobs under a cap of
    ``cap`` frames (raised to the batch): the power of two that holds the
    group, or the batch, where that fits; else the largest power of two
    within the cap, or the batch if that is larger."""
    cap = max(batch, cap)
    w = _pow2_at_least(max(batch, min(cap, n)))
    return w if w <= cap else max(batch, 1 << (cap.bit_length() - 1))


def evaluate_dataset_group(ev: GroupEvaluator, dataset, bucket: int = 64,
                           sample_times: Optional[list] = None,
                           stats: Optional[dict] = None,
                           max_jobs_per_dispatch: int = 0,
                           devices: Optional[list] = None,
                           clicks: Optional[list] = None
                           ) -> List[np.ndarray]:
    """Every object of ``dataset`` through a :class:`GroupEvaluator`
    (continuous batching); per-click IoUs in dataset order, the same as
    :func:`evaluate_dataset_device` gives (lanes do not interact).

    Jobs are grouped by padded shape. Each group runs as a chain of
    dispatches over windows of W staged frames, with the lane state carried
    across windows; the only drain is the last one, when fewer jobs than
    lanes remain. W is at most the cap ``max(batch, max_jobs_per_dispatch
    or 32)``: the power of two that holds the group where it fits, else the
    largest power of two within the cap, never below the batch (few
    distinct shapes, for CUDA graphs of the step). Window i+1 is uploaded
    (asynchronously from pinned memory on a GPU) before window i runs and
    window i is released when it is done, so at most two windows' frames,
    2·W, are resident at a time on a device. The output rows are twice
    the batch, doubled until they hold the group.

    ``sample_times`` (a list) receives each sample's chain wall time;
    ``clicks`` (a list) each sample's clicks ``[n, 3]`` (``ev`` must
    record them); ``stats`` (a dict) is updated with ``dispatches``,
    ``batch_size``, ``devices``, ``window`` (the cap) and ``windows`` (the
    sizes run), ``useful_clicks``, ``steps``, ``lane_steps`` (steps times
    lanes), ``fills`` (hand-outs that started a lane) and
    ``resident_windows`` (the most windows of frames alive at
    once). The JAX package pipelines chains ``depth`` deep; here the loop's
    one read a step keeps host and device in step, so there is no such
    parameter.

    ``devices`` (a list of devices) deals each shape group's jobs
    round-robin into one sub-queue a device (over as many devices as the
    group has batches of jobs, rotating the first device from group to
    group, the JAX package's dealing), each run by its own job queue: ``ev``
    on the first device, a replica (:meth:`GroupEvaluator.replica`) on each
    other entry that gets a job. A device runs its sub-queues one after the
    other; the devices run theirs at once, stepped in lockstep from this
    thread (every device's step is started before any device's flags are
    read), with no collective. ``stats["devices"]`` counts the list's
    entries and ``stats["jobs_by_device"]`` the jobs each ran."""
    import weakref

    if clicks is not None and not ev.record_clicks:
        raise ValueError("clicks= needs an evaluator made with "
                         "record_clicks=True")
    devices = list(devices) if devices else [ev.device]
    jobs, by_shape = _build_jobs(dataset, bucket)
    results: List[Optional[np.ndarray]] = [None] * len(jobs)
    job_clicks: List[Optional[np.ndarray]] = [None] * len(jobs)
    b = ev.batch_size
    window = max(b, max_jobs_per_dispatch or 32)
    n_dispatch, sizes = 0, []
    jobs_by_device = [0] * len(devices)
    alive: list = []
    resident = 0

    def put(dev, group, lo, w):
        nonlocal resident
        win = group[lo:lo + w]
        win = win + [win[-1]] * (w - len(win))
        out = []
        for k in (1, 2, 3):
            t = torch.from_numpy(np.ascontiguousarray(
                np.stack([job[k] for job in win])))
            if dev.type == "cuda":
                t = t.pin_memory()
            out.append(t.to(dev, non_blocking=True))
        alive.append(weakref.ref(out[0]))
        resident = max(resident, sum(r() is not None for r in alive))
        return out

    def chain(gev: GroupEvaluator, group):
        """One sub-queue's chain of windows on ``gev``: a generator of
        flag pairs, as :meth:`GroupEvaluator.stepper`."""
        nonlocal n_dispatch
        dev = gev.device
        n = len(group)
        w = _window_frames(b, window, n)
        sizes.append(w)
        rows = 2 * b
        while rows < n:
            rows *= 2
        t0 = time()
        cur = put(dev, group, 0, w)
        st, q = gev.init(*cur), gev.queue(rows)
        n_valid = torch.tensor(n, device=dev)
        for lo in range(0, n, w):
            nxt = put(dev, group, lo + w, w) if lo + w < n else None
            st, q = yield from gev.stepper(st, q, *cur, n_valid,
                                           torch.tensor(lo, device=dev))
            n_dispatch += 1
            cur = nxt
        del st
        ious = q["out_ious"].cpu().numpy()
        counts = q["out_n"].cpu().numpy()
        out_clicks = (q["out_clicks"].cpu().numpy() if clicks is not None
                      else None)
        wall = time() - t0
        for row, (order_idx, *_rest) in enumerate(group):
            results[order_idx] = ious[row][: int(counts[row])]
            if out_clicks is not None:
                job_clicks[order_idx] = out_clicks[row][: int(counts[row])]
            if sample_times is not None:
                sample_times.append(wall)

    def device_chain(gev: GroupEvaluator, subs):
        for sub in subs:
            yield from chain(gev, sub)

    # deal each shape group round-robin; a device runs its sub-queues in
    # group order
    subs_by_device: Dict[int, list] = {}
    base = 0  # rotates so that small groups land on different devices
    for group in by_shape.values():
        n_dev = min(len(devices), max(1, -(-len(group) // b)))
        for di in range(n_dev):
            sub = group[di::n_dev]
            if not sub:
                continue
            k = (base + di) % len(devices)
            subs_by_device.setdefault(k, []).append(sub)
            jobs_by_device[k] += len(sub)
        base = (base + n_dev) % len(devices)
    # ev on the first device; a replica, with counters from 0, on each
    # other device that got a job
    evs = {k: ev if k == 0 else ev.replica(devices[k])
           for k in sorted(subs_by_device)}
    steppers = {k: device_chain(evs[k], subs_by_device[k]) for k in evs}
    start = {id(ev): (ev.steps, ev.fills)}
    # lockstep: every device's step is started before any device's flags
    # are read
    flags = {}
    for k, g in steppers.items():
        try:
            flags[k] = next(g)
        except StopIteration:
            pass
    while flags:
        read = {k: evs[k].protocol._read(f) for k, f in flags.items()}
        for k, v in read.items():
            try:
                flags[k] = steppers[k].send(v)
            except StopIteration:
                del flags[k]
    if clicks is not None:
        clicks.extend(job_clicks)
    if stats is not None:
        used = {id(e): e for e in evs.values()}
        steps = sum(e.steps - start.get(i, (0, 0))[0]
                    for i, e in used.items())
        fills = sum(e.fills - start.get(i, (0, 0))[1]
                    for i, e in used.items())
        stats.update(dispatches=n_dispatch, batch_size=b,
                     devices=len(devices), jobs_by_device=jobs_by_device,
                     window=window, windows=sizes,
                     useful_clicks=sum(len(a) for a in results
                                       if a is not None),
                     steps=steps, lane_steps=steps * b, fills=fills,
                     resident_windows=resident)
    return results
