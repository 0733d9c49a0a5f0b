"""Training metrics.

Counterpart of ``isegprobe_tpu/training/metrics.py``: the per-batch IoU
triplet is computed on the device inside the train step
(:func:`device_iou_stats`: four numbers cross to the host, not the logits),
and the adaptive threshold is a small host-side state machine
(:class:`AdaptiveIoU`) fed by either the host arrays or that triplet.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["compute_iou", "device_iou_parts", "device_iou_stats",
           "AdaptiveIoU"]


def compute_iou(pred_mask, gt_mask, ignore_mask=None,
                keep_ignore: bool = False):
    """Per-sample IoU over NHWC bool masks. Samples with an empty union are
    dropped (or returned as -1 with ``keep_ignore``)."""
    pred_mask = np.asarray(pred_mask)
    gt_mask = np.asarray(gt_mask)
    if ignore_mask is not None:
        pred_mask = pred_mask & ~np.asarray(ignore_mask)
    axes = tuple(range(1, gt_mask.ndim))
    union = np.mean(pred_mask | gt_mask, axis=axes)
    inter = np.mean(pred_mask & gt_mask, axis=axes)
    defined = union > 0
    if not keep_ignore:
        return inter[defined] / union[defined]
    out = np.full(union.shape, -1.0)
    np.divide(inter, union, out=out, where=defined)
    return out


def device_iou_parts(logits: torch.Tensor, gt: torch.Tensor, thresh: float,
                     step: float, ignore_label: int = -1):
    """The sums behind :func:`device_iou_stats`: per threshold (t − step,
    t, t + step) the sum of the defined samples' IoUs ``[3]`` and their
    count ``[3]``, and the batch's count of non-empty gt masks ``[]``. A
    data-parallel trainer sums them over its ranks, so that the metric is
    the global batch's."""
    prob = torch.sigmoid(logits.float())
    gt = gt.float()
    gt_mask = gt > 0.5
    scoreable = gt != ignore_label
    axes = tuple(range(1, gt.ndim))
    n_valid = (gt_mask.sum(dim=axes) > 0).sum()

    def iou_at(t):
        pm = (prob > t) & scoreable
        union = (pm | gt_mask).float().mean(dim=axes)
        inter = (pm & gt_mask).float().mean(dim=axes)
        defined = union > 0
        per = torch.where(defined, inter / torch.clamp(union, min=1e-12),
                          torch.zeros_like(union))
        return per.sum(), defined.sum()

    parts = [iou_at(thresh - step), iou_at(thresh), iou_at(thresh + step)]
    return (torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]), n_valid)


def device_iou_stats(logits: torch.Tensor, gt: torch.Tensor, thresh: float,
                     step: float, ignore_label: int = -1):
    """Batch-mean IoU at the thresholds (t − step, t, t + step), on the
    logits' device with no host sync. Returns ``(ious [3], valid)``:
    ``valid`` is False when every gt mask of the batch is empty (the metric
    skips the batch then)."""
    sums, counts, n_valid = device_iou_parts(logits, gt, thresh, step,
                                             ignore_label)
    return sums / torch.clamp(counts, min=1), n_valid > 0


class AdaptiveIoU:
    """IoU whose binarization threshold follows an EMA of the per-batch
    best among {t − step, t, t + step}. Both update paths, host arrays
    (:meth:`update`) and the device triplet (:meth:`update_from_stats`),
    feed one state transition."""

    def __init__(self, init_thresh: float = 0.4, thresh_step: float = 0.025,
                 thresh_beta: float = 0.99, iou_beta: float = 0.9,
                 ignore_label: int = -1, from_logits: bool = True,
                 pred_output: str = "instances",
                 gt_output: str = "instances") -> None:
        self.pred_outputs = (pred_output,)
        self.gt_outputs = (gt_output,)
        self._ignore_label = ignore_label
        self._from_logits = from_logits
        self._iou_thresh = init_thresh
        self._thresh_step = thresh_step
        self._thresh_beta = thresh_beta
        self._iou_beta = iou_beta
        self._ema_iou = 0.0
        self._epoch_iou_sum = 0.0
        self._epoch_batch_count = 0

    def _absorb(self, iou_triplet) -> None:
        lo, mid, hi = (float(v) for v in iou_triplet)
        offsets = (-self._thresh_step, 0.0, self._thresh_step)
        best = int(np.argmax([lo, mid, hi]))
        # moving off the centre needs a strict improvement
        if (lo, mid, hi)[best] <= mid:
            best = 1
        max_iou = (lo, mid, hi)[best]
        target = self._iou_thresh + offsets[best]
        b_t, b_i = self._thresh_beta, self._iou_beta
        self._iou_thresh = b_t * self._iou_thresh + (1 - b_t) * target
        self._ema_iou = b_i * self._ema_iou + (1 - b_i) * max_iou
        self._epoch_iou_sum += max_iou
        self._epoch_batch_count += 1

    def update(self, pred, gt) -> None:
        pred = np.asarray(pred)
        gt = np.asarray(gt)
        gt_mask = gt > 0.5
        if not gt_mask.any():
            return
        if self._from_logits:
            pred = 1.0 / (1.0 + np.exp(-pred))
        ignore = gt == self._ignore_label
        t, s = self._iou_thresh, self._thresh_step
        self._absorb([compute_iou(pred > v, gt_mask, ignore).mean()
                      for v in (t - s, t, t + s)])

    def update_from_stats(self, ious, valid: bool) -> None:
        """The device path: ``ious`` from :func:`device_iou_stats`."""
        if valid:
            self._absorb(ious)

    def get_epoch_value(self) -> float:
        if self._epoch_batch_count == 0:
            return 0.0
        return self._epoch_iou_sum / self._epoch_batch_count

    def reset_epoch_stats(self) -> None:
        self._epoch_iou_sum = 0.0
        self._epoch_batch_count = 0

    def log_states(self, sw, tag_prefix: str, global_step: int) -> None:
        """The EMA IoU and the threshold as ``<tag_prefix>_ema_iou`` and
        ``<tag_prefix>_iou_thresh`` (the JAX ``log_states``)."""
        sw.add_scalar(tag=tag_prefix + "_ema_iou", value=self._ema_iou,
                      global_step=global_step)
        sw.add_scalar(tag=tag_prefix + "_iou_thresh", value=self._iou_thresh,
                      global_step=global_step)

    @property
    def iou_thresh(self) -> float:
        return self._iou_thresh

    @property
    def thresh_step(self) -> float:
        return self._thresh_step

    @property
    def ema_iou(self) -> float:
        return self._ema_iou

    @property
    def name(self) -> str:
        return type(self).__name__
