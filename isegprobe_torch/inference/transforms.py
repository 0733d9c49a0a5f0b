"""Invertible evaluation-time transforms over torch tensors.

Counterpart of ``isegprobe_tpu/inference/transforms.py`` (the reference's
transform chain: ``transform`` / ``inv_transform`` / ``reset``; the undo
state protocol, ``get_state`` / ``set_state``, serves the demo and comes
with it, ROADMAP Queue 1 item 9), for ``inference.predictor.
TransformChainPredictor``: ``ZoomIn`` (with a scalar target, the RITM
adaptive crop), ``AddHorizontalFlip`` and ``SigmoidForPred``, on NHWC
tensors on the predictor's device, resized by ``ops/resize.py``. Only the
ROI decision reads the thresholded previous mask on the host, where the
click list lives.

``ZoomIn`` keeps the JAX package's semantics exactly, its quirk included: a
click with no candidate ROI (at or below ``skip_clicks`` clicks, or an
empty prediction) feeds the model the full frame, yet the inverse still
pastes that frame's prediction through an ROI set on an earlier click.
``LimitLongestSide`` and ``Crops`` are not ported (ROADMAP Queue 1 item 9).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from isegprobe_torch.inference.clicker import Click
from isegprobe_torch.ops.resize import resize
from isegprobe_torch.utils.misc import (
    clamp_bbox,
    expand_bbox,
    get_bbox_from_mask,
    get_bbox_iou,
)

__all__ = ["BaseTransform", "SigmoidForPred", "AddHorizontalFlip", "ZoomIn",
           "get_object_roi", "get_roi_image_nd", "check_object_roi"]

Bbox = Tuple[int, int, int, int]
ClickLists = List[List[Click]]


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    return resize(x, tuple(int(v) for v in size), "bilinear",
                  align_corners=True)


class BaseTransform:
    def __init__(self) -> None:
        self.image_changed = False

    def transform(self, image_nd: torch.Tensor, clicks_lists: ClickLists):
        raise NotImplementedError

    def inv_transform(self, prob_map: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError


class SigmoidForPred(BaseTransform):
    """Logits in, probabilities out of the inverse."""

    def transform(self, image_nd, clicks_lists):
        return image_nd, clicks_lists

    def inv_transform(self, prob_map):
        return torch.sigmoid(prob_map)

    def reset(self):
        pass


class AddHorizontalFlip(BaseTransform):
    """Batch-doubling width flip (click ``x' = W - x - 1``); the inverse
    averages each map with its unflipped twin. ``[B, H, W, C]``."""

    def transform(self, image_nd, clicks_lists):
        image_nd = torch.cat([image_nd, image_nd.flip(2)], dim=0)
        width = image_nd.shape[2]
        flipped = [[dataclasses.replace(
            c, coords=(c.coords[0], width - c.coords[1] - 1))
            for c in clicks_list] for clicks_list in clicks_lists]
        return image_nd, clicks_lists + flipped

    def inv_transform(self, prob_map):
        assert prob_map.shape[0] % 2 == 0
        n = prob_map.shape[0] // 2
        return 0.5 * (prob_map[:n] + prob_map[n:].flip(2))

    def reset(self):
        pass


class ZoomIn(BaseTransform):
    """Crop to the predicted object's ROI, resize it to ``target_size``
    (a scalar: the longer side, aspect kept; a pair: that size), remap the
    clicks; the inverse pastes the probabilities back into the frame."""

    def __init__(self, target_size: Union[int, Tuple[int, int]] = 400,
                 skip_clicks: int = 1, expansion_ratio: float = 1.4,
                 min_crop_size: int = 200, recompute_thresh_iou: float = 0.5,
                 prob_thresh: float = 0.50) -> None:
        super().__init__()
        self.target_size = target_size
        self.min_crop_size = min_crop_size
        self.skip_clicks = skip_clicks
        self.expansion_ratio = expansion_ratio
        self.recompute_thresh_iou = recompute_thresh_iou
        self.prob_thresh = prob_thresh
        self.reset()

    def _pred_mask(self) -> np.ndarray:
        """The previous prediction thresholded, on the host ``[H, W]``."""
        return (self._prev_probs[0, :, :, 0] > self.prob_thresh).cpu().numpy()

    def transform(self, image_nd, clicks_lists):
        assert image_nd.shape[0] == 1 and len(clicks_lists) == 1
        self.image_changed = False
        clicks_list = clicks_lists[0]
        if len(clicks_list) <= self.skip_clicks:
            return image_nd, clicks_lists

        h, w = image_nd.shape[1:3]
        current_object_roi = None
        if self._prev_probs is not None:
            pred_mask = self._pred_mask()
            if pred_mask.sum() > 0:
                current_object_roi = get_object_roi(
                    pred_mask, clicks_list, self.expansion_ratio,
                    self.min_crop_size)
        if current_object_roi is None:
            if self.skip_clicks >= 0:
                return image_nd, clicks_lists
            current_object_roi = (0, h - 1, 0, w - 1)

        update = self._object_roi is None
        if not update and not check_object_roi(self._object_roi, clicks_list):
            update = True
        if not update and (get_bbox_iou(current_object_roi, self._object_roi)
                           < self.recompute_thresh_iou):
            update = True
        if update:
            self._object_roi = current_object_roi
            self.image_changed = True

        self._roi_image = get_roi_image_nd(image_nd, self._object_roi,
                                           self.target_size)
        return self._roi_image, [self._transform_clicks(clicks_list)]

    def inv_transform(self, prob_map):
        if self._object_roi is None:
            self._prev_probs = prob_map
            return prob_map
        rmin, rmax, cmin, cmax = self._object_roi
        prob_map = _resize(prob_map, (rmax - rmin + 1, cmax - cmin + 1))
        if self._prev_probs is not None:
            new_prob_map = torch.zeros_like(self._prev_probs,
                                            dtype=prob_map.dtype)
            new_prob_map[:, rmin:rmax + 1, cmin:cmax + 1] = prob_map
        else:
            new_prob_map = prob_map
        self._prev_probs = new_prob_map
        return new_prob_map

    def reset(self):
        self._object_roi: Optional[Bbox] = None
        self._prev_probs: Optional[torch.Tensor] = None
        self._roi_image: Optional[torch.Tensor] = None
        self.image_changed = False

    def _transform_clicks(self, clicks_list: List[Click]) -> List[Click]:
        if self._object_roi is None:
            return clicks_list
        rmin, rmax, cmin, cmax = self._object_roi
        crop_height, crop_width = self._roi_image.shape[1:3]
        return [dataclasses.replace(click, coords=(
            crop_height * (click.coords[0] - rmin) / (rmax - rmin + 1),
            crop_width * (click.coords[1] - cmin) / (cmax - cmin + 1)))
            for click in clicks_list]


def get_object_roi(pred_mask: np.ndarray, clicks_list: Sequence[Click],
                   expansion_ratio: float, min_crop_size: int) -> Bbox:
    """The expanded, clamped bbox of ``pred_mask`` ``[H, W]`` with every
    positive click added to it."""
    pred_mask = pred_mask.copy()
    for click in clicks_list:
        if click.is_positive:
            pred_mask[int(click.coords[0]), int(click.coords[1])] = 1
    bbox = get_bbox_from_mask(pred_mask)
    bbox = expand_bbox(bbox, expansion_ratio, min_crop_size)
    h, w = pred_mask.shape
    return clamp_bbox(bbox, 0, h - 1, 0, w - 1)


def get_roi_image_nd(image_nd: torch.Tensor, object_roi: Bbox,
                     target_size: Union[int, Tuple[int, int]]
                     ) -> torch.Tensor:
    """``image_nd`` ``[1, H, W, C]`` cropped to ``object_roi`` and resized
    (align_corners=True bilinear) to ``target_size``: a pair, or a scalar
    for the longer side, the sizes rounded half to even."""
    rmin, rmax, cmin, cmax = object_roi
    height = rmax - rmin + 1
    width = cmax - cmin + 1
    if isinstance(target_size, tuple):
        new_height, new_width = target_size
    else:
        scale = target_size / max(height, width)
        new_height = int(round(height * scale))
        new_width = int(round(width * scale))
    roi = image_nd[:, rmin:rmax + 1, cmin:cmax + 1]
    return _resize(roi, (new_height, new_width))


def check_object_roi(object_roi: Bbox, clicks_list: Sequence[Click]) -> bool:
    """Every positive click inside ``object_roi`` (half-open upper
    bounds)."""
    for click in clicks_list:
        if click.is_positive:
            if (click.coords[0] < object_roi[0]
                    or click.coords[0] >= object_roi[1]):
                return False
            if (click.coords[1] < object_roi[2]
                    or click.coords[1] >= object_roi[3]):
                return False
    return True
