"""Per-image predictors: the fixed-ZoomIn + flip-TTA click step on the GPU.

Counterpart of ``isegprobe_tpu/inference/predictor.py``. :class:`Predictor`
(the JAX ``TPUPredictor``) does per click: concat the previous-probability
channel, ZoomIn crop-resize to the target size, remap the clicks into the
crop, batch-double with a width flip (flipped click ``x' = W − x − 1``),
model forward, average the logits with the un-flipped flip, sigmoid, and
inverse-paste into the full frame. The previous probabilities stay on the
device between clicks; only the ROI state machine (a few scalar bbox ops on
the thresholded previous mask) runs on the host, where the clicker needs
the mask anyway. ``click_models`` serves click ``k`` with ensemble member
``min(k, last)``; a model whose backbone injects the clicks
``after_backbone`` caches its click-independent trunk per (ROI version, ROI
value) and reruns only the click embedding, upsampler and head.

Images are zero-padded to 64-pixel buckets and clicks to a fixed
``net_clicks_limit`` budget with (−1, −1, −1) rows, as in the JAX package.

:class:`TransformChainPredictor` is the generic host protocol over a chain
of invertible transforms (``inference/transforms.py``): the path of the
RITM adaptive ZoomIn, whose crops have data-dependent sizes, and of any
chain of ``LimitLongestSide``, ``Crops``, flip and sigmoid. Eager PyTorch
needs no static shapes, so its forward runs at each crop's true size.
:class:`CropsPredictor` is the tiled sliding-window protocol in one step
per click: tiles at static offsets, flip TTA, one forward over all tiles,
logits averaged over each flip, count-averaged stitching.

Every predictor keeps the demo's undo protocol (``get_states`` /
``set_states``) and takes ``get_prediction(clicker, prev_mask=None)``.
``inference.brs.get_predictor`` picks the predictor of a mode and ZoomIn
setting.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.inference.clicker import Click, Clicker
from isegprobe_torch.ops.sample import crop_resize, inverse_paste
from isegprobe_torch.utils import trace
from isegprobe_torch.utils.misc import (
    clamp_bbox,
    expand_bbox,
    get_bbox_from_mask,
    get_bbox_iou,
)

Bbox = Tuple[int, int, int, int]


def _bucket(n: int, step: int = 64) -> int:
    return -(-n // step) * step


def _pack_clicks_row(points: np.ndarray, bi: int, clicks: List[Click],
                     n: int, dy: float = 0.0, dx: float = 0.0) -> None:
    """Fill ``points[bi]`` (a ``[2n, 3]`` row pre-filled with −1) from a
    click list: positives in ``[0:n]``, negatives in ``[n:2n]``, coords
    shifted by ``(−dy, −dx)``."""
    pi = ni = 0
    for click in clicks[:n]:
        row = (click.coords[0] - dy, click.coords[1] - dx, click.indx)
        if click.is_positive:
            points[bi, pi] = row
            pi += 1
        else:
            points[bi, n + ni] = row
            ni += 1


def _clicks_inside(object_roi: Bbox, clicks_list: List[Click]) -> bool:
    """Positive clicks inside the ROI, with a half-open upper bound."""
    for click in clicks_list:
        if click.is_positive:
            if not object_roi[0] <= click.coords[0] < object_roi[1]:
                return False
            if not object_roi[2] <= click.coords[1] < object_roi[3]:
                return False
    return True


def _host_prev_pad(prev, image_hw, pad_hw, device) -> torch.Tensor:
    """A host ``[H, W]`` probability map zero-padded to ``[1, Hp, Wp, 1]``
    on ``device``."""
    h, w = image_hw
    pad = np.zeros((1, *pad_hw, 1), dtype=np.float32)
    pad[0, :h, :w, 0] = np.asarray(prev, np.float32).reshape(h, w)
    return torch.from_numpy(pad).to(device)


def _check_device(model, device) -> None:
    model_device = next(model.parameters()).device
    if model_device != device:
        raise ValueError(f"the model lives on {model_device}, the "
                         f"predictor runs on {device}")


class Predictor:
    """Stateful per-image predictor. ``model`` is an ``iSegProbeModel`` that
    lives on ``device`` (CUDA unless ``device="cpu"`` is passed);
    ``click_models``, a list of such models on the same device, makes a
    click-wise ensemble in its place."""

    def __init__(self, model, target_size: Tuple[int, int] = (448, 448),
                 skip_clicks: int = -1, expansion_ratio: float = 1.4,
                 min_crop_size: int = 200, recompute_thresh_iou: float = 0.5,
                 prob_thresh: float = 0.50, net_clicks_limit: int = 20,
                 with_flip: bool = True,
                 click_models: Optional[List] = None, device=None) -> None:
        self.device = resolve_device(device)
        self.target_size = tuple(target_size)
        self.skip_clicks = skip_clicks
        self.expansion_ratio = expansion_ratio
        self.min_crop_size = min_crop_size
        self.recompute_thresh_iou = recompute_thresh_iou
        self.prob_thresh = prob_thresh
        self.net_clicks_limit = net_clicks_limit
        self.with_flip = with_flip

        self.original_image: Optional[torch.Tensor] = None  # [1, Hp, Wp, 3]
        self.image_hw: Tuple[int, int] = (0, 0)
        self.pad_hw: Tuple[int, int] = (0, 0)
        self.prev_prediction: Optional[np.ndarray] = None  # host [H, W]
        self._prev_probs_dev: Optional[torch.Tensor] = None  # [1, Hp, Wp, 1]
        self._object_roi: Optional[Bbox] = None
        self._roi_version = 0  # bumped when the ROI changes (trunk cache)

        # click-wise ensemble: slot k serves predictions once the click
        # count reaches k + 1; the last slot serves all later clicks
        self._slots = list(click_models) if click_models else [model]
        for m in self._slots:
            _check_device(m, self.device)
        self._active_slot = -1
        self._activate_slot(0)

    def _activate_slot(self, idx: int) -> None:
        if idx == self._active_slot:
            return
        self.model = self._slots[idx]
        self.with_prev_mask = getattr(self.model, "with_prev_mask", False)
        self.cache_backbone = getattr(
            self.model.backbone, "feats_injection_mode",
            "no_injection") == "after_backbone"
        self._trunk_cache = None  # (key, trunk) of another net's features
        self._active_slot = idx

    # -- the click step ----------------------------------------------------

    def _crop_points(self, points: np.ndarray, roi: Bbox):
        """Remap full-frame clicks into the crop, in float32 in the JAX
        package's order; returns (points, valid)."""
        oh, ow = self.target_size
        rmin, rmax, cmin, cmax = (np.float32(v) for v in roi)
        rh = rmax - rmin + np.float32(1.0)
        rw = cmax - cmin + np.float32(1.0)
        valid = points[..., :2].max(axis=-1) >= 0
        new_y = np.float32(oh) * (points[..., 0] - rmin) / rh
        new_x = np.float32(ow) * (points[..., 1] - cmin) / rw
        pts = np.stack([new_y, new_x, points[..., 2]], axis=-1)
        return np.where(valid[..., None], pts, np.float32(-1.0)), valid

    def _crop(self, prev_pad: Optional[torch.Tensor], roi: Bbox
              ) -> torch.Tensor:
        """The ROI crop ``[1, oh, ow, C]`` of the image (and the previous
        probabilities for a ``with_prev_mask`` model)."""
        inp = self.original_image
        if self.with_prev_mask:
            inp = torch.cat([inp, prev_pad], dim=-1)
        return crop_resize(inp, roi, self.target_size)

    @torch.inference_mode()
    def _click_step(self, prev_pad: torch.Tensor, roi: Bbox,
                    points: np.ndarray) -> torch.Tensor:
        ow = self.target_size[1]
        with trace.span("predictor.crop"):
            crop = self._crop(prev_pad, roi)
            pts, valid = self._crop_points(points, roi)
            if self.with_flip:
                fx = np.float32(ow) - pts[..., 1] - np.float32(1.0)
                flipped = np.stack([pts[..., 0], fx, pts[..., 2]], axis=-1)
                flipped = np.where(valid[..., None], flipped,
                                   np.float32(-1.0))
                crop = torch.cat([crop, torch.flip(crop, dims=[2])], dim=0)
                pts = np.concatenate([pts, flipped], axis=0)
            pts_dev = torch.from_numpy(
                np.ascontiguousarray(pts, np.float32)).to(self.device)
        with trace.span("predictor.forward"):
            if self.cache_backbone:
                # keyed by (ROI version, ROI value): the skip_clicks exits
                # return the full frame without a new version
                key = (self._roi_version, tuple(int(v) for v in roi))
                if self._trunk_cache is None or self._trunk_cache[0] != key:
                    self._trunk_cache = (
                        key, self.model.compute_backbone_trunk(crop))
                out = self.model.forward_with_cached_trunk(
                    crop, pts_dev, self._trunk_cache[1])
            else:
                out = self.model(crop, pts_dev)
        with trace.span("predictor.paste"):
            logits = out["instances"].float()
            if self.with_flip:
                logits = 0.5 * (logits[:1] + torch.flip(logits[1:], dims=[2]))
            return inverse_paste(torch.sigmoid(logits), roi, self.pad_hw)

    # -- host-side protocol ------------------------------------------------

    def set_input_image(self, image: np.ndarray) -> None:
        """image: ``[H, W, 3]`` uint8 or float in [0, 1]."""
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        h, w = image.shape[:2]
        hp, wp = _bucket(h), _bucket(w)
        pad = np.zeros((1, hp, wp, 3), dtype=np.float32)
        pad[0, :h, :w] = image
        self.original_image = torch.from_numpy(pad).to(self.device)
        self.image_hw = (h, w)
        self.pad_hw = (hp, wp)
        self.prev_prediction = np.zeros((h, w), dtype=np.float32)
        self._prev_probs_dev = torch.zeros((1, hp, wp, 1), dtype=torch.float32,
                                           device=self.device)
        self._object_roi = None
        self._roi_version += 1

    def _compute_roi(self, clicks_list: List[Click]) -> Bbox:
        """ZoomIn ROI state machine (the JAX predictor's ``_compute_roi``)."""
        h, w = self.image_hw
        full: Bbox = (0, h - 1, 0, w - 1)
        if (len(clicks_list) <= max(self.skip_clicks, 0)
                and self.skip_clicks >= 0):
            return full

        current = None
        pred_mask = self.prev_prediction > self.prob_thresh
        if pred_mask.any():
            pm = pred_mask.copy()
            for click in clicks_list:
                if click.is_positive:
                    pm[int(click.coords[0]), int(click.coords[1])] = True
            bbox = get_bbox_from_mask(pm)
            bbox = expand_bbox(bbox, self.expansion_ratio, self.min_crop_size)
            current = clamp_bbox(bbox, 0, h - 1, 0, w - 1)

        if current is None:
            if self.skip_clicks >= 0:
                return full
            current = full

        update = self._object_roi is None
        if not update and not _clicks_inside(self._object_roi, clicks_list):
            update = True
        if not update and (get_bbox_iou(current, self._object_roi)
                           < self.recompute_thresh_iou):
            update = True
        if update:
            self._object_roi = current
            self._roi_version += 1
        return self._object_roi

    def get_points_nd(self, clicks_list: List[Click]) -> np.ndarray:
        """Pad clicks into the fixed ``[1, 2N, 3]`` buffer, positives first."""
        n = self.net_clicks_limit
        points = np.full((1, 2 * n, 3), -1.0, dtype=np.float32)
        _pack_clicks_row(points, 0, clicks_list, n)
        return points

    def _select_slot(self, clicker: Clicker, clicks_list: List[Click]):
        """Click k is served by ensemble member min(k, last)."""
        if len(self._slots) > 1:
            offset = getattr(clicker, "click_indx_offset", 0)
            self._activate_slot(
                min(offset + len(clicks_list), len(self._slots)) - 1)

    def get_prediction(self, clicker: Clicker, prev_mask=None) -> np.ndarray:
        """Probabilities ``[H, W]`` for the clicker's clicks so far;
        ``prev_mask`` ``[H, W]`` replaces the previous prediction as the
        model's prev-mask input. Under ``torch.profiler`` the steps are the
        spans ``predictor.roi``, ``.crop``, ``.forward``, ``.paste`` and
        ``.to_host`` (the host's wait for the device)."""
        clicks_list = clicker.get_clicks()
        self._select_slot(clicker, clicks_list)
        # the ROI machine sees the full click list; only the model's point
        # tensor truncates to net_clicks_limit
        with trace.span("predictor.roi"):
            roi = self._compute_roi(clicks_list)
        points = self.get_points_nd(clicks_list)
        h, w = self.image_hw
        # the previous probabilities never leave the device between clicks
        prev = (self._prev_probs_dev if prev_mask is None else
                _host_prev_pad(prev_mask, self.image_hw, self.pad_hw,
                               self.device))
        probs_pad = self._click_step(prev, roi, points)
        self._prev_probs_dev = probs_pad
        with trace.span("predictor.to_host"):
            probs = probs_pad[0, :h, :w, 0].cpu().numpy()
        self.prev_prediction = probs
        return probs

    @torch.inference_mode()
    def get_lowres_highres_feats(self, clicker: Clicker) -> Tuple[Dict, Dict]:
        """The model's :meth:`get_lowres_highres_feats` on this click's
        ZoomIn crop (the image and the previous prediction cropped to the
        ROI and resized to the target size, the clicks remapped into it),
        without the flip; the maps stay on the device. The ROI state
        machine advances as for a prediction, as in the JAX package."""
        clicks_list = clicker.get_clicks()
        roi = self._compute_roi(clicks_list)
        points = self.get_points_nd(clicks_list)
        prev = _host_prev_pad(self.prev_prediction, self.image_hw,
                              self.pad_hw, self.device)
        crop = self._crop(prev, roi)
        pts, _ = self._crop_points(points, roi)
        pts_dev = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(
            self.device)
        return self.model.get_lowres_highres_feats(crop, pts_dev)

    # -- the demo's undo protocol --------------------------------------------

    def get_states(self) -> Dict:
        return {"object_roi": self._object_roi,
                "prev_prediction": None if self.prev_prediction is None
                else self.prev_prediction.copy()}

    def set_states(self, states: Dict) -> None:
        self._object_roi = states["object_roi"]
        self.prev_prediction = states["prev_prediction"]
        self._roi_version += 1
        if self.prev_prediction is not None and self.pad_hw != (0, 0):
            self._prev_probs_dev = _host_prev_pad(
                self.prev_prediction, self.image_hw, self.pad_hw, self.device)


class TransformChainPredictor:
    """Stateful per-image predictor over a chain of invertible transforms:
    per click, the image (with the previous probabilities as a fourth
    channel for a ``with_prev_mask`` model) and one click list per batch
    row go through every ``transform``, the model runs once on the result
    at its own size, and the logits come back through every
    ``inv_transform`` in reverse order. ``model`` lives on ``device``
    (CUDA unless ``device="cpu"``); images and predictions stay on it, and
    ``get_prediction`` returns the probabilities ``[H, W]`` on the host for
    the clicker."""

    def __init__(self, model, transforms: Optional[List] = None,
                 net_clicks_limit: int = 20, device=None) -> None:
        self.device = resolve_device(device)
        _check_device(model, self.device)
        self.model = model
        self.transforms = transforms or []
        self.net_clicks_limit = net_clicks_limit
        self.with_prev_mask = getattr(model, "with_prev_mask", False)
        self.original_image: Optional[torch.Tensor] = None  # [1, H, W, 3]
        self.prev_prediction: Optional[torch.Tensor] = None  # [1, H, W, 1]

    def set_input_image(self, image: np.ndarray) -> None:
        """image: ``[H, W, 3]`` uint8 or float in [0, 1]."""
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        self.original_image = torch.from_numpy(
            np.ascontiguousarray(image, np.float32)[None]).to(self.device)
        self.prev_prediction = torch.zeros(
            (1, *image.shape[:2], 1), dtype=torch.float32, device=self.device)
        for t in self.transforms:
            t.reset()

    def _points_nd(self, clicks_lists: List[List[Click]]) -> torch.Tensor:
        n = self.net_clicks_limit
        points = np.full((len(clicks_lists), 2 * n, 3), -1.0, np.float32)
        for bi, clicks in enumerate(clicks_lists):
            _pack_clicks_row(points, bi, clicks, n)
        return torch.from_numpy(points).to(self.device)

    @torch.inference_mode()
    def get_prediction(self, clicker: Clicker, prev_mask=None) -> np.ndarray:
        x = self.original_image
        if self.with_prev_mask:
            prev = self.prev_prediction if prev_mask is None else \
                torch.as_tensor(prev_mask, dtype=torch.float32,
                                device=self.device).reshape(
                                    self.prev_prediction.shape)
            x = torch.cat([x, prev], dim=-1)
        # one click list per batch row; Crops and the flip grow both
        clicks_lists = [clicker.get_clicks()]
        for t in self.transforms:
            x, clicks_lists = t.transform(x, clicks_lists)
        prediction = self.model(x, self._points_nd(clicks_lists))[
            "instances"].float()
        for t in reversed(self.transforms):
            prediction = t.inv_transform(prediction)
        self.prev_prediction = prediction[:1]
        return prediction[0, :, :, 0].cpu().numpy()

    # -- the demo's undo protocol --------------------------------------------

    def get_states(self) -> Dict:
        return {"transform_states": [t.get_state() for t in self.transforms],
                "prev_prediction": None if self.prev_prediction is None
                else self.prev_prediction.clone()}

    def set_states(self, states: Dict) -> None:
        for t, state in zip(self.transforms, states["transform_states"]):
            t.set_state(state)
        self.prev_prediction = states["prev_prediction"]


class CropsPredictor:
    """Tiled sliding-window TTA in one step a click: the (image ⊕
    prev-mask) frame cut into ``crop_size`` tiles at ``get_offsets``'
    static offsets (a frame smaller than a tile runs whole), clicks
    shifted into each tile, flip TTA batch doubling, one forward over all
    tiles, the logits averaged over each flip, sigmoid, and the tiles'
    probabilities added into the frame and divided by how many tiles cover
    each pixel. The tiles and counts are those of ``transforms.Crops``; the
    flip averages logits where ``TransformChainPredictor([Crops,
    AddHorizontalFlip, SigmoidForPred])`` averages probabilities, and a
    click row is valid where its index is ``>= 0``, as in the JAX
    ``CropsPredictor``."""

    def __init__(self, model, crop_size: Tuple[int, int] = (320, 480),
                 min_overlap: float = 0.2, with_flip: bool = True,
                 net_clicks_limit: int = 20, device=None) -> None:
        self.device = resolve_device(device)
        _check_device(model, self.device)
        self.model = model
        self.crop_height, self.crop_width = crop_size
        self.min_overlap = min_overlap
        self.with_flip = with_flip
        self.net_clicks_limit = net_clicks_limit
        self.with_prev_mask = getattr(model, "with_prev_mask", False)
        self.original_image: Optional[torch.Tensor] = None  # [H, W, 3]
        self.prev_prediction: Optional[torch.Tensor] = None  # [H, W, 1]
        self._offsets: List[Tuple[int, int]] = []
        self._tile_hw: Tuple[int, int] = (0, 0)
        self._counts: Optional[torch.Tensor] = None  # [H, W]

    def set_input_image(self, image: np.ndarray) -> None:
        """image: ``[H, W, 3]`` uint8 or float in [0, 1]."""
        from isegprobe_torch.inference.transforms import get_offsets

        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        h, w = image.shape[:2]
        self.original_image = torch.from_numpy(
            np.ascontiguousarray(image, np.float32)).to(self.device)
        self.prev_prediction = torch.zeros((h, w, 1), dtype=torch.float32,
                                           device=self.device)
        if h < self.crop_height or w < self.crop_width:
            ch, cw, y_off, x_off = h, w, [0], [0]
        else:
            ch, cw = self.crop_height, self.crop_width
            y_off = get_offsets(h, ch, self.min_overlap)
            x_off = get_offsets(w, cw, self.min_overlap)
        self._offsets = [(dy, dx) for dy in y_off for dx in x_off]
        self._tile_hw = (ch, cw)
        counts = torch.zeros((h, w), dtype=torch.float32, device=self.device)
        for dy, dx in self._offsets:
            counts[dy:dy + ch, dx:dx + cw] += 1.0
        self._counts = counts

    def _points_nd(self, clicks_list: List[Click]) -> np.ndarray:
        """Per-tile padded click rows, coords shifted into the tiles."""
        n = self.net_clicks_limit
        points = np.full((len(self._offsets), 2 * n, 3), -1.0, np.float32)
        for ti, (dy, dx) in enumerate(self._offsets):
            _pack_clicks_row(points, ti, clicks_list, n, dy=dy, dx=dx)
        return points

    @torch.inference_mode()
    def _step(self, x: torch.Tensor, points: np.ndarray) -> torch.Tensor:
        ch, cw = self._tile_hw
        tiles = torch.stack([x[dy:dy + ch, dx:dx + cw]
                             for dy, dx in self._offsets])  # [T, ch, cw, C]
        t = len(self._offsets)
        if self.with_flip:
            real = points[..., 2:3] >= 0
            flipped = np.where(real, np.stack(
                [points[..., 0], np.float32(cw - 1) - points[..., 1],
                 points[..., 2]], axis=-1), points)
            tiles = torch.cat([tiles, tiles.flip(2)], dim=0)
            points = np.concatenate([points, flipped], axis=0)
        pts = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(
            self.device)
        logits = self.model(tiles, pts)["instances"].float()
        if self.with_flip:
            logits = 0.5 * (logits[:t] + logits[t:].flip(2))
        probs = torch.sigmoid(logits)[..., 0]  # [T, ch, cw]
        out = torch.zeros_like(self._counts)
        for i, (dy, dx) in enumerate(self._offsets):
            out[dy:dy + ch, dx:dx + cw] += probs[i]
        return out / self._counts

    def get_prediction(self, clicker: Clicker, prev_mask=None) -> np.ndarray:
        x = self.original_image
        if self.with_prev_mask:
            prev = self.prev_prediction if prev_mask is None else \
                torch.as_tensor(prev_mask, dtype=torch.float32,
                                device=self.device).reshape(
                                    self.prev_prediction.shape)
            x = torch.cat([x, prev], dim=-1)
        probs = self._step(x, self._points_nd(clicker.get_clicks()))
        self.prev_prediction = probs[..., None]
        return probs.cpu().numpy()

    # -- the demo's undo protocol (the tiling is fixed per image) ------------

    def get_states(self) -> Dict:
        return {"prev_prediction": None if self.prev_prediction is None
                else self.prev_prediction.clone()}

    def set_states(self, states: Dict) -> None:
        self.prev_prediction = states["prev_prediction"]

