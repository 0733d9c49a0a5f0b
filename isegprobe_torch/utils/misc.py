"""Bounding-box helpers used by the ZoomIn ROI state machine, and the
label counter of the data layer.

Counterpart of the bbox helpers and ``get_labels_with_sizes`` of
``isegprobe_tpu/utils/misc.py``, with the same semantics.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

Bbox = Tuple[int, int, int, int]  # (rmin, rmax, cmin, cmax), inclusive


def get_bbox_from_mask(mask: np.ndarray) -> Bbox:
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return int(rmin), int(rmax), int(cmin), int(cmax)


def expand_bbox(bbox: Bbox, expand_ratio: float,
                min_crop_size: int | None = None) -> Bbox:
    rmin, rmax, cmin, cmax = bbox
    rcenter = 0.5 * (rmin + rmax)
    ccenter = 0.5 * (cmin + cmax)
    height = expand_ratio * (rmax - rmin + 1)
    width = expand_ratio * (cmax - cmin + 1)
    if min_crop_size is not None:
        height = max(height, min_crop_size)
        width = max(width, min_crop_size)
    return (
        int(round(rcenter - 0.5 * height)),
        int(round(rcenter + 0.5 * height)),
        int(round(ccenter - 0.5 * width)),
        int(round(ccenter + 0.5 * width)),
    )


def clamp_bbox(bbox: Bbox, rmin: int, rmax: int, cmin: int, cmax: int) -> Bbox:
    return (
        max(rmin, bbox[0]),
        min(rmax, bbox[1]),
        max(cmin, bbox[2]),
        min(cmax, bbox[3]),
    )


def get_segments_iou(s1, s2) -> float:
    a, b = s1
    c, d = s2
    intersection = max(0, min(b, d) - max(a, c) + 1)
    union = max(1e-6, max(b, d) - min(a, c) + 1)
    return intersection / union


def get_bbox_iou(b1: Bbox, b2: Bbox) -> float:
    return (get_segments_iou(b1[:2], b2[:2])
            * get_segments_iou(b1[2:4], b2[2:4]))


def get_labels_with_sizes(x: np.ndarray):
    """Positive instance labels present in a mask and their pixel counts.
    Background (0) and ignore regions (negative labels) are never objects."""
    instances = x.reshape(-1)
    counts = np.bincount(instances[instances > 0])
    labels = np.nonzero(counts)[0]
    return labels.tolist(), counts[labels].tolist()
