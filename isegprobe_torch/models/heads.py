"""Segmentation heads.

Counterpart of ``isegprobe_tpu/models/heads.py``: ``linear`` (a 1x1 conv
classifier), ``simple_conv`` (N 1x1 conv+ReLU layers, then the classifier)
and ``convhead`` (N 3x3 conv+ReLU layers, then the classifier), NHWC in and
out. The JAX package builds heads at float32 compute whatever the model
dtype, so these heads compute in float32 and widen parameters that were
cast to bfloat16.
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


HEAD_REGISTRY = {"linear": SimpleClassifierHead,
                 "simple_conv": SimpleConvSegHead, "convhead": ConvSegHead}
