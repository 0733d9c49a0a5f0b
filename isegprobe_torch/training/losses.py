"""Training losses, ignore-label aware, on NHWC ``[B, H, W, 1]`` tensors.

Counterpart of ``isegprobe_tpu/training/losses.py``. Every loss is a pure
function returning per-sample values ``[B]`` and a dict of aux metrics (the
normalized focal loss's batch statistics, which the reference keeps as
hidden EMA state). Predictions are widened to float32 first: losses reduce
in f32 whatever the model's dtype.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["NormalizedFocalLossSigmoid", "FocalLoss", "SoftIoU",
           "SigmoidBinaryCrossEntropyLoss", "BinaryDiceLoss", "LOSS_REGISTRY"]

_SPATIAL = (1, 2, 3)  # non-batch axes of [B, H, W, 1]


def _f32(pred: torch.Tensor, label: torch.Tensor):
    return pred.float(), label.float()


def _focal_terms(pred, label, alpha, gamma, ignore_label, from_sigmoid):
    """(alpha, pt, beta, sample_weight) of the focal losses."""
    one_hot = label > 0.5
    sample_weight = (label != ignore_label).float()
    if not from_sigmoid:
        pred = torch.sigmoid(pred)
    alpha_t = torch.where(one_hot, alpha * sample_weight,
                          (1 - alpha) * sample_weight)
    pt = torch.where(sample_weight > 0, 1.0 - torch.abs(label - pred),
                     torch.ones_like(pred))
    beta = (1 - pt) ** gamma
    return alpha_t, pt, beta, sample_weight


@dataclasses.dataclass(frozen=True)
class NormalizedFocalLossSigmoid:
    """Focal loss with batch-normalized modulation: the loss of every
    reference experiment."""

    alpha: float = 0.25
    gamma: float = 2.0
    max_mult: float = -1
    eps: float = 1e-12
    from_sigmoid: bool = False
    detach_delimeter: bool = True
    weight: float = 1.0
    size_average: bool = True
    ignore_label: int = -1

    def __call__(self, pred, label) -> Tuple[torch.Tensor, Dict]:
        pred, label = _f32(pred, label)
        alpha, pt, beta, sample_weight = _focal_terms(
            pred, label, self.alpha, self.gamma, self.ignore_label,
            self.from_sigmoid)
        sw_sum = sample_weight.sum(dim=(-3, -2), keepdim=True)
        beta_sum = beta.sum(dim=(-3, -2), keepdim=True)
        mult = sw_sum / (beta_sum + self.eps)
        if self.detach_delimeter:
            mult = mult.detach()
        beta = beta * mult
        if self.max_mult > 0:
            beta = torch.clamp(beta, max=self.max_mult)

        loss = -alpha * beta * torch.log(torch.clamp(pt + self.eps, max=1.0))
        loss = self.weight * (loss * sample_weight)
        if self.size_average:
            bsum = sample_weight.sum(dim=_SPATIAL)
            loss = loss.sum(dim=_SPATIAL) / (bsum + self.eps)
        else:
            loss = loss.sum(dim=_SPATIAL)
        aux = {"nfl_k": mult.mean(),
               "nfl_m_max": beta.reshape(beta.shape[0], -1).amax(1).mean()}
        return loss, aux


@dataclasses.dataclass(frozen=True)
class FocalLoss:
    alpha: float = 0.25
    gamma: float = 2.0
    from_logits: bool = False
    eps: float = 1e-9
    size_average: bool = True
    scale: float = 1.0
    weight: float = 1.0
    ignore_label: int = -1

    def __call__(self, pred, label):
        pred, label = _f32(pred, label)
        # from_logits=False applies the sigmoid, as the JAX package does
        alpha, pt, beta, sample_weight = _focal_terms(
            pred, label, self.alpha, self.gamma, self.ignore_label,
            self.from_logits)
        loss = -alpha * beta * torch.log(torch.clamp(pt + self.eps, max=1.0))
        loss = self.weight * (loss * sample_weight)
        if self.size_average:
            tsum = sample_weight.sum(dim=_SPATIAL)
            loss = loss.sum(dim=_SPATIAL) / (tsum + self.eps)
        else:
            loss = loss.sum(dim=_SPATIAL)
        return self.scale * loss, {}


@dataclasses.dataclass(frozen=True)
class SoftIoU:
    from_sigmoid: bool = False
    ignore_label: int = -1

    def __call__(self, pred, label):
        pred, label = _f32(pred, label)
        label = label.reshape(pred.shape)
        sample_weight = (label != self.ignore_label).float()
        if not self.from_sigmoid:
            pred = torch.sigmoid(pred)
        inter = (pred * label * sample_weight).sum(dim=_SPATIAL)
        union = (torch.maximum(pred, label) * sample_weight).sum(dim=_SPATIAL)
        return 1.0 - inter / (union + 1e-8), {}


@dataclasses.dataclass(frozen=True)
class SigmoidBinaryCrossEntropyLoss:
    from_sigmoid: bool = False
    weight: float = 1.0
    ignore_label: int = -1

    def __call__(self, pred, label):
        pred, label = _f32(pred, label)
        label = label.reshape(pred.shape)
        sample_weight = (label != self.ignore_label).float()
        label = torch.where(sample_weight > 0, label, torch.zeros_like(label))
        if not self.from_sigmoid:
            loss = (torch.relu(pred) - pred * label
                    + F.softplus(-torch.abs(pred)))
        else:
            eps = 1e-12
            loss = -(torch.log(pred + eps) * label
                     + torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = self.weight * (loss * sample_weight)
        return loss.mean(dim=_SPATIAL), {}


@dataclasses.dataclass(frozen=True)
class BinaryDiceLoss:
    """Dice over channel-last class scores; one value for the batch."""

    def __call__(self, pred, label):
        pred = pred.float()
        b = pred.shape[0]
        input_label = pred.argmax(dim=-1).float()
        input_pred = (pred.amax(dim=-1) * input_label).reshape(b, -1)
        target_label = label.float().reshape(b, -1)
        intersect = (input_pred * target_label).sum(1)
        input_area = (input_pred * input_pred).sum(1)
        target_area = (target_label * target_label).sum(1)
        eps = 1e-6
        batch_loss = 1.0 - (2.0 * intersect + eps) / (input_area
                                                      + target_area + eps)
        return batch_loss.mean()[None], {}


LOSS_REGISTRY = {
    "NormalizedFocalLossSigmoid": NormalizedFocalLossSigmoid,
    "FocalLoss": FocalLoss,
    "SoftIoU": SoftIoU,
    "SigmoidBinaryCrossEntropyLoss": SigmoidBinaryCrossEntropyLoss,
    "BinaryDiceLoss": BinaryDiceLoss,
}
