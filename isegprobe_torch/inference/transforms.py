"""Invertible evaluation-time transforms over torch tensors.

Counterpart of ``isegprobe_tpu/inference/transforms.py`` (the reference's
transform chain: ``transform`` / ``inv_transform`` / ``reset``, and the
demo's undo protocol ``get_state`` / ``set_state``), for
``inference.predictor.TransformChainPredictor``: ``ZoomIn`` (with a scalar
target, the RITM adaptive crop), ``LimitLongestSide``, the tiled ``Crops``
with count-averaged stitching, ``AddHorizontalFlip`` and
``SigmoidForPred``, on NHWC tensors on the predictor's device, resized by
``ops/resize.py``. Only the ROI decision reads the thresholded previous
mask on the host, where the click list lives.

``ZoomIn`` keeps the JAX package's semantics exactly, its quirk included: a
click with no candidate ROI (at or below ``skip_clicks`` clicks, or an
empty prediction) feeds the model the full frame, yet the inverse still
pastes that frame's prediction through an ROI set on an earlier click.
"""

from __future__ import annotations

import math
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
           "LimitLongestSide", "Crops", "get_object_roi", "get_roi_image_nd",
           "check_object_roi", "get_offsets"]

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

    def get_state(self):
        raise NotImplementedError

    def set_state(self, state) -> None:
        raise NotImplementedError


class _Stateless(BaseTransform):
    """A transform with nothing to undo."""

    def reset(self):
        pass

    def get_state(self):
        return None

    def set_state(self, state):
        pass


class SigmoidForPred(_Stateless):
    """Logits in, probabilities out of the inverse."""

    def transform(self, image_nd, clicks_lists):
        return image_nd, clicks_lists

    def inv_transform(self, prob_map):
        return torch.sigmoid(prob_map)


class AddHorizontalFlip(_Stateless):
    """Batch-doubling width flip (click ``x' = W - x - 1``); the inverse
    averages each map with its unflipped twin. ``[B, H, W, C]``."""

    def transform(self, image_nd, clicks_lists):
        image_nd = torch.cat([image_nd, image_nd.flip(2)], dim=0)
        width = image_nd.shape[2]
        flipped = [[c.copy(coords=(c.coords[0], width - c.coords[1] - 1))
                    for c in clicks_list] for clicks_list in clicks_lists]
        return image_nd, clicks_lists + flipped

    def inv_transform(self, prob_map):
        assert prob_map.shape[0] % 2 == 0
        n = prob_map.shape[0] // 2
        return 0.5 * (prob_map[:n] + prob_map[n:].flip(2))


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

        self._input_image_shape = tuple(image_nd.shape)
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

    def check_possible_recalculation(self) -> bool:
        """Whether the first click's full-frame prediction marks an object
        whose ROI covers under half the frame (a second pass could zoom)."""
        if (self._prev_probs is None or self._object_roi is not None
                or self.skip_clicks > 0):
            return False
        pred_mask = self._pred_mask()
        if pred_mask.sum() > 0:
            possible_object_roi = get_object_roi(
                pred_mask, [], self.expansion_ratio, self.min_crop_size)
            image_roi = (0, self._input_image_shape[1] - 1,
                         0, self._input_image_shape[2] - 1)
            if get_bbox_iou(possible_object_roi, image_roi) < 0.50:
                return True
        return False

    def get_state(self):
        return (self._input_image_shape, self._object_roi, self._prev_probs,
                self._roi_image, self.image_changed)

    def set_state(self, state):
        (self._input_image_shape, self._object_roi, self._prev_probs,
         self._roi_image, self.image_changed) = state

    def reset(self):
        self._input_image_shape: Optional[Tuple[int, ...]] = None
        self._object_roi: Optional[Bbox] = None
        self._prev_probs: Optional[torch.Tensor] = None
        self._roi_image: Optional[torch.Tensor] = None
        self.image_changed = False

    def _transform_clicks(self, clicks_list: List[Click]) -> List[Click]:
        if self._object_roi is None:
            return clicks_list
        rmin, rmax, cmin, cmax = self._object_roi
        crop_height, crop_width = self._roi_image.shape[1:3]
        return [click.copy(coords=(
            crop_height * (click.coords[0] - rmin) / (rmax - rmin + 1),
            crop_width * (click.coords[1] - cmin) / (cmax - cmin + 1)))
            for click in clicks_list]


class LimitLongestSide(ZoomIn):
    """Resize the whole frame so that its longer side is ``max_size`` (a
    frame that fits passes through); the inverse resizes back."""

    def __init__(self, max_size: int = 800) -> None:
        super().__init__(target_size=max_size, skip_clicks=0)

    def transform(self, image_nd, clicks_lists):
        assert image_nd.shape[0] == 1 and len(clicks_lists) == 1
        image_max_size = max(image_nd.shape[1:3])
        self.image_changed = False
        if image_max_size <= self.target_size:
            return image_nd, clicks_lists
        self._object_roi = (0, image_nd.shape[1] - 1, 0,
                            image_nd.shape[2] - 1)
        self._roi_image = get_roi_image_nd(image_nd, self._object_roi,
                                           self.target_size)
        self.image_changed = True
        return self._roi_image, [self._transform_clicks(clicks_lists[0])]


class Crops(BaseTransform):
    """Tiles of ``crop_size`` at :func:`get_offsets`' offsets, one batch
    row and one click list (shifted into the tile) each; the inverse adds
    the tiles' maps back into the frame and divides by how many tiles cover
    each pixel. A frame smaller than a tile passes through."""

    def __init__(self, crop_size: Tuple[int, int] = (320, 480),
                 min_overlap: float = 0.2) -> None:
        super().__init__()
        self.crop_height, self.crop_width = crop_size
        self.min_overlap = min_overlap
        self.reset()

    def transform(self, image_nd, clicks_lists):
        assert image_nd.shape[0] == 1 and len(clicks_lists) == 1
        image_height, image_width = image_nd.shape[1:3]
        self._counts = None
        if (image_height < self.crop_height
                or image_width < self.crop_width):
            return image_nd, clicks_lists
        self.x_offsets = get_offsets(image_width, self.crop_width,
                                     self.min_overlap)
        self.y_offsets = get_offsets(image_height, self.crop_height,
                                     self.min_overlap)
        counts = torch.zeros((image_height, image_width),
                             dtype=torch.float32, device=image_nd.device)
        crops, new_lists = [], []
        for dy in self.y_offsets:
            for dx in self.x_offsets:
                counts[dy:dy + self.crop_height,
                       dx:dx + self.crop_width] += 1
                crops.append(image_nd[:, dy:dy + self.crop_height,
                                      dx:dx + self.crop_width])
                new_lists.append([c.copy(coords=(c.coords[0] - dy,
                                                 c.coords[1] - dx))
                                  for c in clicks_lists[0]])
        self._counts = counts
        return torch.cat(crops, dim=0), new_lists

    def inv_transform(self, prob_map):
        if self._counts is None:
            return prob_map
        new_prob_map = torch.zeros((1, *self._counts.shape,
                                    prob_map.shape[-1]),
                                   dtype=prob_map.dtype,
                                   device=prob_map.device)
        crop_indx = 0
        for dy in self.y_offsets:
            for dx in self.x_offsets:
                new_prob_map[0, dy:dy + self.crop_height,
                             dx:dx + self.crop_width] += prob_map[crop_indx]
                crop_indx += 1
        return new_prob_map / self._counts[None, :, :, None]

    def get_state(self):
        return self.x_offsets, self.y_offsets, self._counts

    def set_state(self, state):
        self.x_offsets, self.y_offsets, self._counts = state

    def reset(self):
        self.x_offsets: Optional[List[int]] = None
        self.y_offsets: Optional[List[int]] = None
        self._counts: Optional[torch.Tensor] = None


def get_offsets(length: int, crop_size: int,
                min_overlap_ratio: float = 0.2) -> List[int]:
    """Tile offsets along one axis: the fewest tiles of ``crop_size`` that
    overlap by at least ``min_overlap_ratio``, the last one flush with the
    end."""
    if length == crop_size:
        return [0]
    n = (length / crop_size - min_overlap_ratio) / (1 - min_overlap_ratio)
    n = math.ceil(n)
    overlap_ratio = (n - length / crop_size) / (n - 1)
    overlap_width = int(crop_size * overlap_ratio)
    offsets = [0]
    for _ in range(1, n):
        new_offset = offsets[-1] + crop_size - overlap_width
        if new_offset + crop_size > length:
            new_offset = length - crop_size
        offsets.append(new_offset)
    return offsets


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
