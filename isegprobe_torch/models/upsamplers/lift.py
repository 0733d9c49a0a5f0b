"""Layers of the learned upsamplers: LiFT's ``FrozenBatchNorm`` and a 1x1
conv on NHWC tensors.

Counterpart of ``isegprobe_tpu/models/upsamplers/lift.py``. So far only
``FrozenBatchNorm`` is ported (LoftUp's conv stem needs it); the LiFT
upsampler itself waits for ROADMAP Queue 1 item 7.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``Conv2d`` applied to an NHWC tensor as a matmul over the
    channels, in the conv's dtype."""
    return F.linear(x.to(conv.weight.dtype), conv.weight[:, :, 0, 0],
                    conv.bias)


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over the last (channel) axis:
    ``y = (x − mean) · 1/sqrt(var + eps) · weight + bias``. The running
    statistics are parameters, as in the JAX tree (the bridge maps its
    ``scale`` to ``weight``); they are frozen like the rest of the
    upsampler."""

    def __init__(self, features: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.mean = nn.Parameter(torch.zeros(features))
        self.var = nn.Parameter(torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv_std = torch.reciprocal(torch.sqrt(self.var + self.eps))
        return (x - self.mean) * inv_std * self.weight + self.bias
