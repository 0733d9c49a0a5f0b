"""Segmentation heads.

Counterpart of ``isegprobe_tpu/models/heads.py``: ``linear`` (a 1x1 conv
classifier), ``simple_conv`` (N 1x1 conv+ReLU layers, then the classifier)
and ``convhead`` (N 3x3 conv+ReLU layers, then the classifier), NHWC in and
out. The JAX package builds heads at float32 compute whatever the model
dtype, so these heads compute in float32 and widen parameters that were
cast to bfloat16. ``masked(x, valid_hw)`` is each head on the adaptive
canvas, whose top-left ``valid_hw`` ``[B, 2]`` rect is valid per lane: the
3x3 convhead zeroes what lies outside it before every conv, as a true-size
input's zero padding would; the pointwise heads need nothing.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def _conv_f32(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    bias = None if conv.bias is None else conv.bias.float()
    return F.conv2d(x, conv.weight.float(), bias, padding=conv.padding)


def _head(convs, classifier: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    x = x.float().permute(0, 3, 1, 2)
    for conv in convs:
        x = torch.relu(_conv_f32(conv, x))
    return _conv_f32(classifier, x).permute(0, 2, 3, 1)


class SimpleClassifierHead(nn.Module):
    """'linear': a single 1x1 conv classifier."""

    def __init__(self, in_channels: int, num_classes: int = 1) -> None:
        super().__init__()
        self.classifier = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _head((), self.classifier, x)

    def masked(self, x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        return self(x)  # pointwise


class SimpleConvSegHead(nn.Module):
    """'simple_conv': N 1x1 conv+ReLU layers, then the classifier."""

    def __init__(self, in_channels: int, num_layers: int,
                 num_classes: int = 1) -> None:
        super().__init__()
        self.convs = nn.ModuleList(nn.Conv2d(in_channels, in_channels, 1)
                                   for _ in range(num_layers))
        self.classifier = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _head(self.convs, self.classifier, x)

    def masked(self, x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        return self(x)  # pointwise


class ConvSegHead(nn.Module):
    """'convhead': the head of the flagship experiment."""

    def __init__(self, in_channels: int, num_layers: int,
                 num_classes: int = 1) -> None:
        super().__init__()
        self.convs = nn.ModuleList(
            nn.Conv2d(in_channels, in_channels, 3, padding=1)
            for _ in range(num_layers))
        self.classifier = nn.Conv2d(in_channels, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _head(self.convs, self.classifier, x)

    def masked(self, x: torch.Tensor, valid_hw: torch.Tensor) -> torch.Tensor:
        """``x`` ``[B, H, W, C]`` with each lane's valid rect ``valid_hw``
        ``[B, 2]``: valid outputs equal the head on the true-size input."""
        h, w = x.shape[1], x.shape[2]
        rows = torch.arange(h, device=x.device)[None, :, None]
        cols = torch.arange(w, device=x.device)[None, None, :]
        m = ((rows < valid_hw[:, 0, None, None])
             & (cols < valid_hw[:, 1, None, None]))[:, None].float()
        x = x.float().permute(0, 3, 1, 2) * m
        for conv in self.convs:
            x = torch.relu(_conv_f32(conv, x)) * m
        return _conv_f32(self.classifier, x).permute(0, 2, 3, 1)


HEAD_REGISTRY = {"linear": SimpleClassifierHead,
                 "simple_conv": SimpleConvSegHead, "convhead": ConvSegHead}
