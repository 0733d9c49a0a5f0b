"""Per-image predictor: the fixed-ZoomIn + flip-TTA click step on the GPU.

Counterpart of ``isegprobe_tpu/inference/predictor.py:TPUPredictor``. Per
click: concat the previous-probability channel, ZoomIn crop-resize to the
target size, remap the clicks into the crop, batch-double with a width flip
(flipped click ``x' = W − x − 1``), model forward, average the logits with
the un-flipped flip, sigmoid, and inverse-paste into the full frame. The
previous probabilities stay on the device between clicks; only the ROI
state machine (a few scalar bbox ops on the thresholded previous mask) runs
on the host, where the clicker needs the mask anyway.

Images are zero-padded to 64-pixel buckets and clicks to a fixed
``net_clicks_limit`` budget with (−1, −1, −1) rows, as in the JAX package.
Click-model ensembles and the ``after_backbone`` trunk cache are not ported
yet (an ``after_backbone`` model runs its full forward every click).

:class:`TransformChainPredictor` is the generic host protocol over a chain
of invertible transforms (``inference/transforms.py``), the counterpart of
the JAX package's of that name: the path of the RITM adaptive ZoomIn,
whose crops have data-dependent sizes. Eager PyTorch needs no static
shapes, so its forward runs at each crop's true size. :func:`get_predictor`
picks the predictor for a ZoomIn setting, as the JAX package's
``inference/brs.py:get_predictor`` does for NoBRS.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.inference.clicker import Click, Clicker
from isegprobe_torch.ops.sample import crop_resize, inverse_paste
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
                     n: int) -> None:
    """Fill ``points[bi]`` (a ``[2n, 3]`` row pre-filled with −1) from a
    click list: positives in ``[0:n]``, negatives in ``[n:2n]``."""
    pi = ni = 0
    for click in clicks[:n]:
        row = (click.coords[0], click.coords[1], click.indx)
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


class Predictor:
    """Stateful per-image predictor. ``model`` is an ``iSegProbeModel`` that
    lives on ``device`` (CUDA unless ``device="cpu"`` is passed)."""

    def __init__(self, model, target_size: Tuple[int, int] = (448, 448),
                 skip_clicks: int = -1, expansion_ratio: float = 1.4,
                 min_crop_size: int = 200, recompute_thresh_iou: float = 0.5,
                 prob_thresh: float = 0.50, net_clicks_limit: int = 20,
                 with_flip: bool = True, device=None) -> None:
        self.device = resolve_device(device)
        model_device = next(model.parameters()).device
        if model_device != self.device:
            raise ValueError(f"the model lives on {model_device}, the "
                             f"predictor runs on {self.device}")
        self.model = model
        self.target_size = tuple(target_size)
        self.skip_clicks = skip_clicks
        self.expansion_ratio = expansion_ratio
        self.min_crop_size = min_crop_size
        self.recompute_thresh_iou = recompute_thresh_iou
        self.prob_thresh = prob_thresh
        self.net_clicks_limit = net_clicks_limit
        self.with_flip = with_flip
        self.with_prev_mask = getattr(model, "with_prev_mask", False)

        self.original_image: Optional[torch.Tensor] = None  # [1, Hp, Wp, 3]
        self.image_hw: Tuple[int, int] = (0, 0)
        self.pad_hw: Tuple[int, int] = (0, 0)
        self.prev_prediction: Optional[np.ndarray] = None  # host [H, W]
        self._prev_probs_dev: Optional[torch.Tensor] = None  # [1, Hp, Wp, 1]
        self._object_roi: Optional[Bbox] = None

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

    @torch.inference_mode()
    def _click_step(self, prev_pad: torch.Tensor, roi: Bbox,
                    points: np.ndarray) -> torch.Tensor:
        oh, ow = self.target_size
        inp = self.original_image
        if self.with_prev_mask:
            inp = torch.cat([inp, prev_pad], dim=-1)
        crop = crop_resize(inp, roi, (oh, ow))
        pts, valid = self._crop_points(points, roi)
        if self.with_flip:
            fx = np.float32(ow) - pts[..., 1] - np.float32(1.0)
            flipped = np.stack([pts[..., 0], fx, pts[..., 2]], axis=-1)
            flipped = np.where(valid[..., None], flipped, np.float32(-1.0))
            crop = torch.cat([crop, torch.flip(crop, dims=[2])], dim=0)
            pts = np.concatenate([pts, flipped], axis=0)
        pts_dev = torch.from_numpy(np.ascontiguousarray(pts, np.float32)).to(
            self.device)
        logits = self.model(crop, pts_dev)["instances"].float()
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
        return self._object_roi

    def get_points_nd(self, clicks_list: List[Click]) -> np.ndarray:
        """Pad clicks into the fixed ``[1, 2N, 3]`` buffer, positives first."""
        n = self.net_clicks_limit
        points = np.full((1, 2 * n, 3), -1.0, dtype=np.float32)
        _pack_clicks_row(points, 0, clicks_list, n)
        return points

    def get_prediction(self, clicker: Clicker) -> np.ndarray:
        """Probabilities ``[H, W]`` for the clicker's clicks so far."""
        clicks_list = clicker.get_clicks()
        # the ROI machine sees the full click list; only the model's point
        # tensor truncates to net_clicks_limit
        roi = self._compute_roi(clicks_list)
        points = self.get_points_nd(clicks_list)
        h, w = self.image_hw
        # the previous probabilities never leave the device between clicks
        probs_pad = self._click_step(self._prev_probs_dev, roi, points)
        self._prev_probs_dev = probs_pad
        probs = probs_pad[0, :h, :w, 0].cpu().numpy()
        self.prev_prediction = probs
        return probs


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
        model_device = next(model.parameters()).device
        if model_device != self.device:
            raise ValueError(f"the model lives on {model_device}, the "
                             f"predictor runs on {self.device}")
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
                                device=self.device)
            x = torch.cat([x, prev], dim=-1)
        # one click list per batch row; the flip doubles both
        clicks_lists = [clicker.get_clicks()]
        for t in self.transforms:
            x, clicks_lists = t.transform(x, clicks_lists)
        prediction = self.model(x, self._points_nd(clicks_lists))[
            "instances"].float()
        for t in reversed(self.transforms):
            prediction = t.inv_transform(prediction)
        self.prev_prediction = prediction[:1]
        return prediction[0, :, :, 0].cpu().numpy()


def get_predictor(model, brs_mode: str = "NoBRS", with_flip: bool = True,
                  zoom_in_params: Optional[Dict] = None,
                  predictor_params: Optional[Dict] = None, device=None):
    """The NoBRS predictor of the JAX package's ``get_predictor``: with a
    scalar ``zoom_in_params["target_size"]`` (the RITM adaptive ZoomIn) a
    :class:`TransformChainPredictor` over ``[ZoomIn, AddHorizontalFlip,
    SigmoidForPred]`` (no flip without ``with_flip``), else the fixed-crop
    :class:`Predictor` (no ZoomIn: the frame resized to 448², its ROI
    machine off). The BRS modes, which alone read the JAX signature's
    ``prob_thresh``, raise."""
    if brs_mode != "NoBRS":
        raise NotImplementedError(
            f"brs_mode={brs_mode!r} is not ported to isegprobe_torch yet: "
            "ROADMAP Queue 1 item 9 (BRS)")
    predictor_params = dict(predictor_params or {})
    predictor_params.pop("optimize_after_n_clicks", None)
    if zoom_in_params:
        from isegprobe_torch.inference.transforms import (
            AddHorizontalFlip,
            SigmoidForPred,
            ZoomIn,
        )

        known = {"target_size", "skip_clicks", "expansion_ratio",
                 "min_crop_size", "recompute_thresh_iou", "prob_thresh"}
        unknown = set(zoom_in_params) - known
        if unknown:
            raise ValueError(f"Unknown zoom_in_params keys: {sorted(unknown)}")
        zoom_kwargs = dict(zoom_in_params)
        zoom_kwargs.setdefault("target_size", (448, 448))
        if isinstance(zoom_kwargs["target_size"], int):
            chain = [ZoomIn(**zoom_kwargs)]
            if with_flip:
                chain.append(AddHorizontalFlip())
            chain.append(SigmoidForPred())
            return TransformChainPredictor(
                model, transforms=chain,
                net_clicks_limit=predictor_params.get("net_clicks_limit", 20),
                device=device)
    else:
        zoom_kwargs = {"skip_clicks": 10**9}
    return Predictor(model, with_flip=with_flip, device=device,
                     **zoom_kwargs, **predictor_params)
