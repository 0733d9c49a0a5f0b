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
"""

from __future__ import annotations

from time import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.ops.edt import next_click_from_error
from isegprobe_torch.ops.sample import crop_resize, inverse_paste

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

    def _read(self, flag: torch.Tensor) -> bool:
        """One allowed device-to-host read of a scalar flag. On CUDA, a
        ``torch.cuda.set_sync_debug_mode`` set by the caller is lifted
        around it, so that mode catches every other sync of a click."""
        self.host_reads += 1
        mode = torch.cuda.get_sync_debug_mode() if flag.is_cuda else 0
        if not mode:
            return bool(flag)
        torch.cuda.set_sync_debug_mode(0)
        try:
            return bool(flag)
        finally:
            torch.cuda.set_sync_debug_mode(mode)

    # -- per-lane protocol steps, over the leading lane axis ----------------

    def _init_state(self, images, gts, valid_hws) -> Dict[str, torch.Tensor]:
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
        if self.use_cache:
            # serves click 1: with an empty prediction the first ROI
            # candidate is the full frame, which this trunk was computed for
            st["trunk"] = self._trunk(images, full_roi)
            st["trunk_roi"] = full_roi
        return st

    def _select(self, st):
        """Clicker, click bookkeeping and the ZoomIn ROI update of every
        lane. ``not_clicked`` and ``pos_mask`` are updated in place. Returns
        the updated state entries and the ``[B, 2·nmax, 3]`` points."""
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

        # ZoomIn ROI state machine (reference: zoom_in.py:51-97): a candidate
        # exists only when the predicted mask is non-empty; positive clicks
        # join the mask before the bbox
        roi_mask = (prev2d > self.roi_prob_thresh) & st["in_valid"]
        has_mask = roi_mask.flatten(1).any(dim=1)
        h_valid = st["valid_hw"][:, 0].float()
        w_valid = st["valid_hw"][:, 1].float()
        cand = _expand_clamp(_bbox_from_mask(roi_mask | pos_mask),
                             self.expansion_ratio, self.min_crop_size,
                             h_valid, w_valid)
        cand = torch.stack(cand, dim=1).long()
        cand = torch.where(has_mask[:, None], cand, st["full_roi"])

        cur = st["roi"].float()
        clicks_inside = ((pos_ymin >= cur[:, 0]) & (pos_ymax < cur[:, 1])
                         & (pos_xmin >= cur[:, 2]) & (pos_xmax < cur[:, 3])
                         ) | ~torch.isfinite(pos_ymin)
        iou_ok = _bbox_iou(cand.float(), cur) >= self.recompute_thresh_iou
        update = ~st["roi_set"] | ~clicks_inside | ~iou_ok
        roi = torch.where(update[:, None], cand, st["roi"])

        sel = dict(pos_pts=pos_pts, neg_pts=neg_pts, n_pos=n_pos, n_neg=n_neg,
                   not_clicked=not_clicked, pos_mask=pos_mask,
                   pos_ymin=pos_ymin, pos_ymax=pos_ymax, pos_xmin=pos_xmin,
                   pos_xmax=pos_xmax, roi=roi,
                   roi_set=torch.ones_like(st["roi_set"]))
        if self.record_clicks:
            at_n = (torch.arange(self.max_clicks, device=dev)[None, :]
                    == st["n"][:, None])
            sel["clicks"] = torch.where(
                at_n[..., None],
                torch.stack([cy, cx, is_pos.long()], 1)[:, None],
                st["clicks"])
        return sel, torch.cat([pos_pts, neg_pts], dim=1)

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

    def _finish(self, st, roi, probs):
        """Paste, IoU over ``not_ignore`` and the stopping rule."""
        prev = inverse_paste(probs, roi, tuple(st["gt"].shape[1:]))
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
        sel, points = self._select(st)
        crops, pts = self._crop_points(st["image"], st["prev"], sel["roi"],
                                       points)
        if self.use_cache:
            changed = ((sel["roi"] != st["trunk_roi"]).any(dim=1)
                       & active).any()
            trunk, trunk_roi = st["trunk"], st["trunk_roi"]
            if self._read(changed):
                trunk = self._trunk(st["image"], sel["roi"])
                trunk_roi = sel["roi"]
                self.trunk_recomputes += 1
            logits = self.model.forward_with_cached_trunk(
                crops, pts, trunk)["instances"]
        else:
            logits = self.model(crops, pts)["instances"]
        fin = self._finish(st, sel["roi"], self._merge_flip(logits, b))
        new = {**st, **sel, **fin}
        if self.use_cache:
            new["trunk"], new["trunk_roi"] = trunk, trunk_roi
        for k in ("ious", "n", "done") + (
                ("clicks",) if self.record_clicks else ()):
            new[k] = _lane_where(active, new[k], st[k])
        return new

    @torch.inference_mode()
    def _run(self, images, gts, valid_hws):
        for name, t in (("image", images), ("gt", gts),
                        ("valid_hw", valid_hws)):
            if t.device != self.device:
                raise ValueError(f"{name} lives on {t.device}, the evaluator "
                                 f"runs on {self.device}")
        if images.shape[0] != self.batch_size:
            raise ValueError(f"expected {self.batch_size} lanes, got "
                             f"{images.shape[0]}")
        st = self._init_state(images, gts, valid_hws)
        while True:
            active = ~st["done"] & (st["n"] < self.max_clicks)
            if not self._read(active.any()):
                break
            st = self._body(st, active)
            self.steps += 1
        self.clicks = st.get("clicks")
        return st["ious"], st["n"]

    def __call__(self, images: torch.Tensor, gts: torch.Tensor,
                 valid_hws: torch.Tensor):
        if self.batch_size == 1:
            ious, n = self._run(images[None], gts[None], valid_hws[None])
            return ious[0], n[0]
        return self._run(images, gts, valid_hws)


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
                          device=None) -> DeviceEvaluator:
    """Build the on-device NoC evaluator for ``model`` (an
    ``iSegProbeModel`` living on ``device``: CUDA unless ``device="cpu"``).
    Returns a :class:`DeviceEvaluator`, called as ``run(image, gt,
    valid_hw)``; ``batch_size > 1`` runs that many lanes in lockstep.

    ``trunk_cache``: ``'auto'`` caches the click-independent trunk when the
    backbone injects clicks ``after_backbone``; ``'on'`` forces it (and
    raises for other injection modes); ``'off'`` disables it.
    ``record_clicks`` keeps every click on the device for the caller
    (``DeviceEvaluator.clicks``; the JAX evaluator has no such record), at
    a few small ops a step. ``mesh`` and
    ``group_api`` are not ported yet and raise ``NotImplementedError``."""
    if mesh is not None:
        raise NotImplementedError(
            "the mesh-sharded device evaluator is not ported to "
            "isegprobe_torch yet: ROADMAP Queue 1 item 9 (parallel/mesh.py "
            "on torch.distributed)")
    if group_api:
        raise NotImplementedError(
            "the continuous-batching group API is not ported to "
            "isegprobe_torch yet: ROADMAP Queue 1 item 5 (continuous "
            "batching)")
    if batch_size < 1:
        raise ValueError(f"batch_size must be >= 1, got {batch_size}")
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
    return DeviceEvaluator(
        model, target_size=target_size, max_clicks=max_clicks,
        net_clicks_limit=net_clicks_limit, pred_thr=pred_thr,
        target_iou=target_iou, min_clicks=min_clicks, with_flip=with_flip,
        roi_prob_thresh=roi_prob_thresh, expansion_ratio=expansion_ratio,
        min_crop_size=min_crop_size,
        recompute_thresh_iou=recompute_thresh_iou, batch_size=batch_size,
        use_cache=use_cache, record_clicks=record_clicks, device=device)


# ---------------------------------------------------------------------------
# Host-side entry points
# ---------------------------------------------------------------------------


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
    eager PyTorch, and the port has no such parameter."""
    if clicks is not None and not run_fn.record_clicks:
        raise ValueError("clicks= needs an evaluator made with "
                         "record_clicks=True")
    b = run_fn.batch_size
    if b == 1:
        all_ious = []
        for index in range(len(dataset)):
            sample = dataset.get_sample(index)
            for object_id in sample.objects_ids:
                t0 = time()
                all_ious.append(evaluate_sample_device(
                    run_fn, sample.image, sample.gt_mask(object_id), bucket))
                if sample_times is not None:
                    sample_times.append(time() - t0)
                if clicks is not None:
                    clicks.append(run_fn.clicks[0, :len(all_ious[-1])]
                                  .cpu().numpy())
        return all_ious

    jobs, by_shape = _build_jobs(dataset, bucket)
    results: List[Optional[np.ndarray]] = [None] * len(jobs)
    job_clicks: List[Optional[np.ndarray]] = [None] * len(jobs)
    for group in by_shape.values():
        for lo in range(0, len(group), b):
            chunk = group[lo:lo + b]
            chunk = chunk + [chunk[-1]] * (b - len(chunk))
            t0 = time()
            imgs, gts, hws = _upload(
                run_fn, *(np.stack([job[k] for job in chunk])
                          for k in (1, 2, 3)))
            ious, n = run_fn(imgs, gts, hws)
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
                    job_clicks[order_idx] = lane_clicks[lane][: int(n[lane])]
                if sample_times is not None:
                    sample_times.append(wall)
    if clicks is not None:
        clicks.extend(job_clicks)
    return results
