"""Backpropagating Refinement Scheme (BRS) predictors.

Counterpart of ``isegprobe_tpu/inference/brs.py``. Per click, BRS optimizes
a small set of auxiliary variables with L-BFGS so that the prediction
satisfies the clicks: Feature-BRS (f-BRS-A/B/C) a per-channel scale and
bias of the frozen backbone features before the upsampler and head,
Input-BRS an additive offset on the click maps (``DistMap-BRS``) or on the
normalised image (``RGB-BRS``).

The split is the JAX package's: scipy's ``fmin_l_bfgs_b`` drives the loop
on the host, and each evaluation is one objective on the device. The
optimizer's ``__call__`` takes scipy's float64 ``x``, makes a float32
tensor of it on the device that requires grad, runs the objective under
``torch.enable_grad()``, takes ``torch.autograd.grad(loss, x)`` (so no
weight gathers a gradient) and hands ``(loss, grad)`` back as host floats.
``x`` is laid out as the JAX package lays it out: ``[scale; bias]`` for
f-BRS, the NHWC offset ``(1, oh, ow, C)`` for Input-BRS, so scipy sees the
same vector from click to click. The predictor returns the logits of the
lowest loss seen (kept on the device, read back once), not those of the
final ``x``.

The objective never meets a tensor made under inference mode: f-BRS's
backbone features are computed under ``torch.no_grad()``, the crop and the
previous mask are made from host arrays, and the model's cached constants
are normal tensors. Under autograd the backbone's kernels A and B (and an
upsampler's D or E) run forward on the card with their plain versions'
backward.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from scipy.optimize import fmin_l_bfgs_b

from isegprobe_torch.inference.clicker import Click
from isegprobe_torch.inference.predictor import (
    Predictor,
    TransformChainPredictor,
    _host_prev_pad,
)
from isegprobe_torch.ops.resize import resize
from isegprobe_torch.ops.sample import inverse_paste
from isegprobe_torch.training.metrics import compute_iou

__all__ = ["BRS_MODES", "brs_mask_loss", "OracleMaskLoss", "BaseOptimizer",
           "ScaleBiasOptimizer", "InputOptimizer", "FeatureBRSPredictor",
           "InputBRSPredictor", "get_predictor"]

BRS_MODES = ("NoBRS", "f-BRS-A", "f-BRS-B", "f-BRS-C", "RGB-BRS",
             "DistMap-BRS")
_SCALE_ACTS = {"f-BRS-A": None, "f-BRS-B": "tanh", "f-BRS-C": "sin"}


def _resize(x: torch.Tensor, size) -> torch.Tensor:
    return resize(x, tuple(int(v) for v in size), "bilinear",
                  align_corners=True)


def brs_mask_loss(result, pos_mask, neg_mask, eps: float = 1e-5):
    """Click-consistency loss over ``[B, H, W, 1]`` probabilities and click
    disk masks: the mean squared shortfall at the positive clicks plus the
    mean squared excess at the negative ones. Returns (loss, max shortfall,
    max excess)."""
    pos_diff = (1.0 - result) * pos_mask
    pos_target = torch.sum(pos_diff**2) / (torch.sum(pos_mask) + eps)
    neg_diff = result * neg_mask
    neg_target = torch.sum(neg_diff**2) / (torch.sum(neg_mask) + eps)
    return (pos_target + neg_target, pos_diff.abs().max(),
            neg_diff.abs().max())


class OracleMaskLoss:
    """BCE against the ground-truth mask instead of click consistency, the
    oracle-analysis objective. Call ``set_gt_mask`` per sample; attached to
    a predictor (``get_predictor`` sets ``self.predictor``), the GT is
    cropped to the current ZoomIn ROI and resized to the prediction, and
    doubled with its flip when the prediction is. Its maxima are 1, so the
    click-satisfaction stop never fires; the optimizer's oracle plateau
    stop ends the loop instead."""

    def __init__(self) -> None:
        self.gt_mask: Optional[np.ndarray] = None  # [H, W] float
        self.predictor = None
        self.history: list = []

    def set_gt_mask(self, gt_mask) -> None:
        self.gt_mask = np.asarray(gt_mask, dtype=np.float32)
        self.history = []

    def __call__(self, result, pos_mask, neg_mask, eps: float = 1e-6):
        del pos_mask, neg_mask
        gt = self.gt_mask
        roi = (getattr(self.predictor, "_object_roi", None)
               if self.predictor is not None else None)
        if roi is not None:
            r1, r2, c1, c2 = roi[:4]
            gt = gt[r1:r2 + 1, c1:c2 + 1]
        gt_t = torch.from_numpy(np.ascontiguousarray(gt)).to(
            result.device)[None, :, :, None]
        gt_t = _resize(gt_t, result.shape[1:3])
        if result.shape[0] == 2 * gt_t.shape[0]:  # flip-TTA batch doubling
            gt_t = torch.cat([gt_t, gt_t.flip(2)], dim=0)
        p = torch.clamp(result, eps, 1.0 - eps)
        bce = -torch.mean(gt_t * torch.log(p)
                          + (1.0 - gt_t) * torch.log(1.0 - p))
        one = torch.ones((), device=result.device)
        return bce, one, one


class BaseOptimizer:
    """The scipy-facing objective with three early stops: the clicks
    satisfied (zero gradient), the thresholded mask's IoU with the last
    one's above ``1 - min_iou_diff``, and (with :class:`OracleMaskLoss`)
    a plateau of the oracle loss. ``loss_fn`` swaps the click-consistency
    objective for another. ``n_evals`` counts this click's evaluations
    and ``stop`` names the early stop of the last one (None if it handed
    scipy a gradient)."""

    def __init__(self, optimizer_params: Dict, prob_thresh: float = 0.49,
                 reg_weight: float = 1e-3, min_iou_diff: float = 0.01,
                 with_flip: bool = False, flip_average: bool = False,
                 loss_fn=None, **kwargs) -> None:
        self.optimizer_params = optimizer_params
        self.prob_thresh = prob_thresh
        self.reg_weight = reg_weight
        self.min_iou_diff = min_iou_diff
        self.with_flip = with_flip
        self.flip_average = flip_average
        self.loss_fn = loss_fn
        self.best_prediction: Optional[torch.Tensor] = None
        self._opt_shape = None
        self._best_loss: Optional[float] = None
        self._logits_fn: Optional[Callable] = None
        self._click_args = None
        self._last_mask: Optional[np.ndarray] = None
        self.device = None
        self.n_evals = 0
        self.stop: Optional[str] = None

    def init_click(self, logits_fn: Callable, pos_mask, neg_mask,
                   shape=None, aux=(), device=None) -> None:
        """Start a click: ``logits_fn(aux, *opt_vars)`` gives the logits of
        the unpacked variables; the click disk masks ``[1, oh, ow, 1]``
        (host arrays) go to ``device``."""
        self.device = torch.device(device) if device is not None else None
        self.best_prediction = None
        self._logits_fn = logits_fn
        self._click_args = (aux, torch.as_tensor(pos_mask, device=device),
                            torch.as_tensor(neg_mask, device=device))
        self._opt_shape = shape
        self._last_mask = None
        self._best_loss = None
        self.n_evals = 0
        self.stop = None

    def objective(self, x: torch.Tensor):
        """(loss + regulariser, logits, probabilities, max shortfall, max
        excess) at the float32 device tensor ``x``."""
        aux, pos_mask, neg_mask = self._click_args
        opt_vars, reg_loss = self.unpack_opt_params(x)
        logits = self._logits_fn(aux, *opt_vars)
        result = torch.sigmoid(logits)
        if self.with_flip and self.flip_average:
            half = result.shape[0] // 2
            result = 0.5 * (result[:half] + result[half:].flip(2))
            pos_mask, neg_mask = pos_mask[:half], neg_mask[:half]
        loss, f_max_pos, f_max_neg = (self.loss_fn or brs_mask_loss)(
            result, pos_mask, neg_mask)
        return loss + reg_loss, logits, result, f_max_pos, f_max_neg

    def value_and_grad(self, x: np.ndarray):
        """The objective and its gradient with respect to ``x`` alone, as
        device tensors: (loss, grad, logits, probabilities, max shortfall,
        max excess)."""
        xt = torch.tensor(np.asarray(x), dtype=torch.float32,
                          device=self.device, requires_grad=True)
        with torch.enable_grad():
            loss, logits, result, fpos, fneg = self.objective(xt)
            (grad,) = torch.autograd.grad(loss, xt)
        return (loss.detach(), grad, logits.detach(), result.detach(),
                fpos.detach(), fneg.detach())

    def __call__(self, x: np.ndarray):
        loss, grad, logits, result, fpos, fneg = self.value_and_grad(x)
        self.n_evals += 1
        self.stop = None
        # one host read for the three scalars
        f_val, f_max_pos, f_max_neg = (
            float(v) for v in torch.stack([loss, fpos, fneg]).cpu())
        if self.best_prediction is None or f_val < self._best_loss:
            self.best_prediction = logits
            self._best_loss = f_val

        if isinstance(self.loss_fn, OracleMaskLoss):
            hist = self.loss_fn.history
            hist.append(f_val)
            if len(hist) > 5 and abs(hist[-5] - hist[-1]) < 1e-5:
                self.stop = "oracle"
                return [f_val, np.zeros_like(x)]

        if (f_max_pos < (1 - self.prob_thresh)
                and f_max_neg < self.prob_thresh):
            self.stop = "clicks"
            return [f_val, np.zeros_like(x)]

        current_mask = (result > self.prob_thresh).cpu().numpy()
        if self._last_mask is not None and self.min_iou_diff > 0:
            diff_iou = compute_iou(current_mask, self._last_mask)
            if len(diff_iou) > 0 and diff_iou.mean() > 1 - self.min_iou_diff:
                self.stop = "iou"
                return [f_val, np.zeros_like(x)]
        self._last_mask = current_mask
        return [f_val, grad.double().cpu().numpy().ravel()]

    def unpack_opt_params(self, opt_params: torch.Tensor):
        raise NotImplementedError


class ScaleBiasOptimizer(BaseOptimizer):
    """f-BRS's variables: ``[scale; bias]``, the scale through ``scale_act``
    (None, ``tanh`` or ``sin``) and applied as ``1 + scale``."""

    def __init__(self, *args, scale_act: Optional[str] = None,
                 reg_bias_weight: float = 10.0, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.scale_act = scale_act
        self.reg_bias_weight = reg_bias_weight

    def unpack_opt_params(self, opt_params):
        scale, bias = torch.chunk(opt_params, 2)
        reg_loss = self.reg_weight * (
            torch.sum(scale**2) + self.reg_bias_weight * torch.sum(bias**2))
        if self.scale_act == "tanh":
            scale = torch.tanh(scale)
        elif self.scale_act == "sin":
            scale = torch.sin(scale)
        return (1 + scale, bias), reg_loss


class InputOptimizer(BaseOptimizer):
    """Input-BRS's variable: one offset of the optimizer's NHWC shape."""

    def unpack_opt_params(self, opt_params):
        opt_params = opt_params.reshape(self._opt_shape)
        return (opt_params,), self.reg_weight * torch.sum(opt_params**2)


class _BRSPredictorBase(Predictor):
    """A fixed-ZoomIn predictor whose clicks after the first
    ``optimize_after_n_clicks`` run the optimizer. ``opt_data`` carries
    the variables from click to click and resets with the image."""

    def __init__(self, model, opt_functor: BaseOptimizer,
                 optimize_after_n_clicks: int = 1, **kwargs) -> None:
        super().__init__(model, **kwargs)
        self.opt_functor = opt_functor
        self.optimize_after_n_clicks = optimize_after_n_clicks
        self.opt_data: Optional[np.ndarray] = None

    def _brs_logits(self, aux, *opt_vars) -> torch.Tensor:
        raise NotImplementedError

    def _click_aux(self, crop: torch.Tensor, pts: torch.Tensor):
        """The click's fixed inputs of ``_brs_logits`` and the shape of
        its variables (``x`` holds their product of entries)."""
        raise NotImplementedError

    def set_input_image(self, image) -> None:
        super().set_input_image(image)
        self.opt_data = None

    @staticmethod
    def _clicks_maps(clicks_list: List[Click], hw, radius: int = 1):
        """Binary click squares of side ``2 radius + 1`` in crop
        coordinates, ``[1, oh, ow, 1]`` positive and negative."""
        pos = np.zeros((1, *hw, 1), dtype=np.float32)
        neg = np.zeros((1, *hw, 1), dtype=np.float32)
        for click in clicks_list:
            y, x = int(round(click.coords[0])), int(round(click.coords[1]))
            y1, x1 = max(0, y - radius), max(0, x - radius)
            y2, x2 = y + radius + 1, x + radius + 1
            if click.is_positive:
                pos[0, y1:y2, x1:x2, 0] = 1
            else:
                neg[0, y1:y2, x1:x2, 0] = 1
        return pos, neg

    def _crop_clicks(self, clicks_list: List[Click], roi) -> List[Click]:
        rmin, rmax, cmin, cmax = roi
        oh, ow = self.target_size
        return [c.copy(coords=(oh * (c.coords[0] - rmin) / (rmax - rmin + 1),
                               ow * (c.coords[1] - cmin) / (cmax - cmin + 1)))
                for c in clicks_list]

    def get_prediction(self, clicker, prev_mask=None) -> np.ndarray:
        clicks_list = clicker.get_clicks()
        roi = self._compute_roi(clicks_list)
        h, w = self.image_hw
        prev = self.prev_prediction if prev_mask is None else prev_mask
        prev_pad = (_host_prev_pad(prev, self.image_hw, self.pad_hw,
                                   self.device)
                    if self.with_prev_mask else None)
        crop = self._crop(prev_pad, roi)
        crop_clicks = self._crop_clicks(clicks_list, roi)
        pts = torch.from_numpy(self.get_points_nd(crop_clicks)).to(
            self.device)
        aux, opt_shape = self._click_aux(crop, pts)
        size = int(np.prod(opt_shape))
        if self.opt_data is None or self.opt_data.size != size:
            self.opt_data = np.zeros(size, dtype=np.float32)

        pos_mask, neg_mask = self._clicks_maps(crop_clicks, self.target_size)
        functor = self.opt_functor
        functor.init_click(self._brs_logits, pos_mask, neg_mask,
                           shape=opt_shape, aux=aux, device=self.device)
        if len(clicks_list) > self.optimize_after_n_clicks:
            opt_result = fmin_l_bfgs_b(
                func=functor, x0=self.opt_data.astype(np.float64),
                **functor.optimizer_params)
            self.opt_data = opt_result[0].astype(np.float32)

        if functor.best_prediction is not None:
            logits = functor.best_prediction
        else:
            with torch.no_grad():
                opt_vars, _ = functor.unpack_opt_params(
                    torch.from_numpy(self.opt_data).to(self.device))
                logits = self._brs_logits(aux, *opt_vars)
        full = inverse_paste(torch.sigmoid(logits), roi, self.pad_hw)
        probs = full[0, :h, :w, 0].cpu().numpy()
        self.prev_prediction = probs
        self._prev_probs_dev = full
        return probs

    def get_states(self) -> Dict:
        states = super().get_states()
        states["opt_data"] = (None if self.opt_data is None
                              else self.opt_data.copy())
        return states

    def set_states(self, states: Dict) -> None:
        super().set_states(states)
        self.opt_data = states.get("opt_data")


class FeatureBRSPredictor(_BRSPredictorBase):
    """f-BRS: a per-channel scale and bias of the frozen backbone features
    (with the clicks injected) before the upsampler and head. The features
    are computed once a click, under ``torch.no_grad()``; an evaluation
    runs the upsampler and head."""

    def _brs_logits(self, aux, scale, bias):
        feats, image_norm = aux
        f = feats * scale.reshape(1, 1, 1, -1) + bias.reshape(1, 1, 1, -1)
        logits = self.model._upsample_and_head(f, image_norm)
        return _resize(logits, self.target_size)

    def _click_aux(self, crop, pts):
        model = self.model
        with torch.no_grad():
            image, prev = model.prepare_input(crop)
            coord = model.get_coord_features(image, prev, pts)
            feats = model.backbone(image, model.embed_coords(coord))
        return (feats, image), (2 * feats.shape[-1],)


class InputBRSPredictor(_BRSPredictorBase):
    """Input-BRS: an additive offset on the click maps (``dmaps``, 2
    channels, 3 with the prev mask) or on the normalised image (``rgb``).
    An evaluation runs the whole model forward and backward."""

    def __init__(self, *args, optimize_target: str = "dmaps",
                 **kwargs) -> None:
        super().__init__(*args, **kwargs)
        if optimize_target not in ("dmaps", "rgb"):
            raise ValueError(f"optimize_target must be 'dmaps' or 'rgb', "
                             f"got {optimize_target!r}")
        self.optimize_target = optimize_target

    def _brs_logits(self, aux, offset):
        crop, pts = aux
        model = self.model
        image, prev = model.prepare_input(crop)
        if self.optimize_target == "rgb":
            image = image + offset
        coord = model.get_coord_features(image, prev, pts)
        if self.optimize_target == "dmaps":
            coord = coord + offset
        out = model.backbone_forward(image, coord)
        return _resize(out["instances"], self.target_size)

    def _click_aux(self, crop, pts):
        oh, ow = self.target_size
        channels = 3 if (self.optimize_target == "rgb"
                         or self.with_prev_mask) else 2
        return (crop, pts), (1, oh, ow, channels)


def get_predictor(model, brs_mode: str = "NoBRS", prob_thresh: float = 0.49,
                  with_flip: bool = True,
                  zoom_in_params: Optional[Dict] = None,
                  predictor_params: Optional[Dict] = None,
                  brs_opt_func_params: Optional[Dict] = None,
                  lbfgs_params: Optional[Dict] = None, device=None):
    """The predictor of ``brs_mode`` (one of :data:`BRS_MODES`) with the
    JAX package's signature. ``model`` may be a ``(model, click_models)``
    tuple for a click-wise ensemble (NoBRS only). Without
    ``zoom_in_params`` the ROI machine is off (the frame resized to the
    target size). NoBRS with a scalar target (the RITM adaptive ZoomIn) is
    a :class:`TransformChainPredictor` over ``[ZoomIn, AddHorizontalFlip,
    SigmoidForPred]`` (no flip without ``with_flip``); else the fixed-crop
    :class:`Predictor`. The BRS predictors run without flip TTA;
    ``with_flip`` and ``prob_thresh`` go to their optimizer, with
    ``brs_opt_func_params``; ``lbfgs_params`` update scipy's settings
    (``m`` 20, ``factr`` 0, ``pgtol`` 1e-8, ``maxfun`` 20, ``maxiter``
    twice ``maxfun``)."""
    click_models = None
    if isinstance(model, tuple):
        model, click_models = model
        if brs_mode != "NoBRS":
            raise ValueError("click-model ensembles require NoBRS")
    if brs_mode not in BRS_MODES:
        raise ValueError(f"Unsupported BRS mode: {brs_mode}; takes "
                         f"{list(BRS_MODES)}")
    lbfgs_params_ = {"m": 20, "factr": 0, "pgtol": 1e-8, "maxfun": 20}
    lbfgs_params_.update(lbfgs_params or {})
    lbfgs_params_["maxiter"] = 2 * lbfgs_params_["maxfun"]
    predictor_params_ = {"optimize_after_n_clicks": 1}
    predictor_params_.update(predictor_params or {})
    brs_opt_func_params = brs_opt_func_params or {}

    if zoom_in_params:
        known = {"target_size", "skip_clicks", "expansion_ratio",
                 "min_crop_size", "recompute_thresh_iou", "prob_thresh"}
        unknown = set(zoom_in_params) - known
        if unknown:
            raise ValueError(f"Unknown zoom_in_params keys: {sorted(unknown)}")
        zoom_kwargs = dict(zoom_in_params)
        zoom_kwargs.setdefault("target_size", (448, 448))
    else:
        zoom_kwargs = {"skip_clicks": 10**9}

    if brs_mode == "NoBRS":
        predictor_params_.pop("optimize_after_n_clicks", None)
        if isinstance(zoom_kwargs.get("target_size"), int):
            if click_models:
                raise NotImplementedError(
                    "click-model ensembles + scalar adaptive ZoomIn")
            from isegprobe_torch.inference.transforms import (
                AddHorizontalFlip,
                SigmoidForPred,
                ZoomIn,
            )

            chain = [ZoomIn(**zoom_kwargs)]
            if with_flip:
                chain.append(AddHorizontalFlip())
            chain.append(SigmoidForPred())
            return TransformChainPredictor(
                model, transforms=chain,
                net_clicks_limit=predictor_params_.get("net_clicks_limit",
                                                       20),
                device=device)
        return Predictor(model, with_flip=with_flip,
                         click_models=click_models, device=device,
                         **zoom_kwargs, **predictor_params_)

    if isinstance(zoom_kwargs.get("target_size"), int):
        raise ValueError("the BRS predictors take a fixed (h, w) ZoomIn "
                         "target, not the adaptive scalar one")
    opt_kwargs = dict(prob_thresh=prob_thresh, with_flip=with_flip,
                      optimizer_params=lbfgs_params_, **brs_opt_func_params)
    if brs_mode.startswith("f-BRS"):
        opt_functor = ScaleBiasOptimizer(scale_act=_SCALE_ACTS[brs_mode],
                                         **opt_kwargs)
        predictor = FeatureBRSPredictor(model, opt_functor, with_flip=False,
                                        device=device, **zoom_kwargs,
                                        **predictor_params_)
    else:
        opt_functor = InputOptimizer(**opt_kwargs)
        predictor = InputBRSPredictor(
            model, opt_functor,
            optimize_target="rgb" if brs_mode == "RGB-BRS" else "dmaps",
            with_flip=False, device=device, **zoom_kwargs,
            **predictor_params_)
    if isinstance(opt_functor.loss_fn, OracleMaskLoss):
        opt_functor.loss_fn.predictor = predictor
    return predictor
