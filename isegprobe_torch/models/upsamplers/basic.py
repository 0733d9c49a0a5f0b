"""Non-learnable upsamplers.

Counterpart of ``isegprobe_tpu/models/upsamplers/basic.py``: every upsampler
is called as ``upsampler(source, guidance)`` with ``source`` a low-res NHWC
feature map and ``guidance`` the input image; the result is resized toward
the guidance resolution.
"""

from __future__ import annotations

import torch
from torch import nn

from isegprobe_torch.ops.resize import resize


class IdentityUpsampler(nn.Module):
    def forward(self, source: torch.Tensor,
                guidance: torch.Tensor) -> torch.Tensor:
        return source


class NearestUpsampler(nn.Module):
    def forward(self, source: torch.Tensor,
                guidance: torch.Tensor) -> torch.Tensor:
        return resize(source, tuple(guidance.shape[1:3]), "nearest")


class BilinearUpsampler(nn.Module):
    def forward(self, source: torch.Tensor,
                guidance: torch.Tensor) -> torch.Tensor:
        return resize(source, tuple(guidance.shape[1:3]), "bilinear",
                      align_corners=True)


class BicubicUpsampler(nn.Module):
    def forward(self, source: torch.Tensor,
                guidance: torch.Tensor) -> torch.Tensor:
        return resize(source, tuple(guidance.shape[1:3]), "bicubic",
                      align_corners=False)


BASIC_UPSAMPLERS = {
    "identity": IdentityUpsampler,
    "nearest": NearestUpsampler,
    "bilinear": BilinearUpsampler,
    "bicubic": BicubicUpsampler,
}
