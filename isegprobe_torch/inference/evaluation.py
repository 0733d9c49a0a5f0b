"""NoC evaluation loop.

Counterpart of ``isegprobe_tpu/inference/evaluation.py``: a simulated user
clicks on the largest error until the IoU target (or the click budget) is
reached, and the predictor answers each click with a mask.
"""

from __future__ import annotations

import itertools
from copy import deepcopy
from time import time
from typing import Callable, List, Optional, Tuple

import numpy as np

from isegprobe_torch.inference.clicker import Click, Clicker
from isegprobe_torch.utils import trace

_calls = itertools.count()


def evaluate_sample(image: np.ndarray, gt_mask: np.ndarray, predictor,
                    max_iou_thr: float, pred_thr: float = 0.49,
                    min_clicks: int = 1, max_clicks: int = 20,
                    sample_id: Optional[int] = None,
                    callback: Optional[Callable] = None,
                    feats_callback: Optional[Callable] = None,
                    ) -> Tuple[List[Click], np.ndarray, np.ndarray]:
    """Run the click loop on one object. Returns (clicks, per-click IoUs,
    final probabilities). ``callback(image, gt_mask, probs, sample_id,
    click_indx, clicks)`` runs after each prediction; ``feats_callback(
    image, feats, sample_id, click_indx, clicks)`` before it, with the
    predictor's ``get_lowres_highres_feats`` of a copy of the clicker.
    Under ``torch.profiler`` each click is a ``click`` span (``rid``: the
    call's serial number and the click's index) over ``clicker``,
    ``predict`` and ``iou`` spans; the callbacks run outside those three."""
    clicker = Clicker(gt_mask=gt_mask)
    pred_mask = np.zeros_like(gt_mask, dtype=bool)
    ious_list = []
    pred_probs = None

    predictor.set_input_image(image)
    call = next(_calls)
    for click_indx in range(max_clicks):
        with trace.span("click", rid=(call, click_indx)):
            with trace.span("clicker"):
                clicker.make_next_click(pred_mask)
            if feats_callback is not None:
                _, feats = predictor.get_lowres_highres_feats(
                    deepcopy(clicker))
                feats_callback(image, feats, sample_id, click_indx,
                               clicker.clicks_list)
            with trace.span("predict"):
                pred_probs = predictor.get_prediction(clicker)
            if callback is not None:
                callback(image, gt_mask, pred_probs, sample_id, click_indx,
                         clicker.clicks_list)
            with trace.span("iou"):
                pred_mask = pred_probs > pred_thr
                iou = get_iou(gt_mask, pred_mask)
        ious_list.append(iou)
        if iou >= max_iou_thr and click_indx + 1 >= min_clicks:
            break
    ious = np.array(ious_list, dtype=np.float32)
    return clicker.clicks_list, ious, pred_probs


def evaluate_dataset(dataset, predictor, latencies: Optional[list] = None,
                     clicks: Optional[list] = None,
                     **kwargs) -> Tuple[List[np.ndarray], float]:
    """Run :func:`evaluate_sample` over every object of a dataset (objects
    with ``get_sample(i)`` returning ``.image``, ``.objects_ids`` and
    ``.gt_mask(id)``). Pass ``latencies=[]`` to collect per-click wall
    times, ``clicks=[]`` to collect each object's clicks as (y, x,
    is_positive) rows."""
    all_ious = []
    start_time = time()
    for index in range(len(dataset)):
        sample = dataset.get_sample(index)
        for object_id in sample.objects_ids:
            t0 = time()
            object_clicks, sample_ious, _ = evaluate_sample(
                sample.image, sample.gt_mask(object_id), predictor,
                sample_id=index, **kwargs)
            if clicks is not None:
                clicks.append(np.asarray(
                    [(*c.coords, int(c.is_positive)) for c in object_clicks],
                    np.int64).reshape(-1, 3))
            if latencies is not None:
                latencies.append((time() - t0) / max(1, len(sample_ious)))
            all_ious.append(sample_ious)
    return all_ious, time() - start_time


def latency_percentiles(latencies: list) -> dict:
    arr = np.asarray(latencies)
    return {
        "p50_ms": float(np.percentile(arr, 50) * 1e3),
        "p95_ms": float(np.percentile(arr, 95) * 1e3),
        "mean_ms": float(arr.mean() * 1e3),
    }


def get_iou(gt_mask: np.ndarray, pred_mask: np.ndarray,
            ignore_label: int = -1) -> float:
    not_ignore = gt_mask != ignore_label
    obj = gt_mask == 1
    intersection = np.logical_and(np.logical_and(pred_mask, obj),
                                  not_ignore).sum()
    union = np.logical_and(np.logical_or(pred_mask, obj), not_ignore).sum()
    return intersection / union
