"""Joint Bilateral Upsampling stack (FeatUp's JBUStack): four learned ×2
JBU stages and a 0.1-scaled fixup projection residual.

Counterpart of ``isegprobe_tpu/models/upsamplers/jbu.py``. Each stage
projects its (avg-pooled) guidance through a 1x1 conv -> exact GELU -> 1x1
conv range encoder (key_dim 32), upsamples the source bicubically to the
guidance size and filters it with ``ops.jbu.jbu_filter`` (kernel E on a
GPU). Parameter names follow the JAX param tree (``up1`` .. ``up4``,
``fixup_proj``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from isegprobe_torch.models.upsamplers.lift import conv1x1
from isegprobe_torch.ops.jbu import RADIUS, jbu_filter
from isegprobe_torch.ops.pool import adaptive_pool
from isegprobe_torch.ops.resize import resize


class JBULearnedRange(nn.Module):
    """One ×2 stage: ``forward(source [B, h, w, C], guidance [B, 2h, 2w,
    3])`` -> ``[B, 2h, 2w, C]``."""

    def __init__(self, key_dim: int = 32, radius: int = RADIUS) -> None:
        super().__init__()
        if radius != RADIUS:
            raise ValueError(f"JBU filtering is built for radius {RADIUS}")
        self.range_temp = nn.Parameter(torch.zeros(()))
        self.sigma_spatial = nn.Parameter(torch.ones(()))
        self.range_proj1 = nn.Conv2d(3, key_dim, 1)  # the guidance image
        self.range_proj2 = nn.Conv2d(key_dim, key_dim, 1)

    def forward(self, source: torch.Tensor,
                guidance: torch.Tensor) -> torch.Tensor:
        gh, gw = guidance.shape[1], guidance.shape[2]
        source = source.to(self.range_proj1.weight.dtype)
        proj = F.gelu(conv1x1(self.range_proj1, guidance),
                      approximate="none")
        proj = conv1x1(self.range_proj2, proj)
        hr = resize(source, (gh, gw), "bicubic", align_corners=False)
        return jbu_filter(hr, proj, self.range_temp, self.sigma_spatial)


class JBUFeatUpUpsampler(nn.Module):
    """×16 upsampling through four learned JBU stages.

    ``backbone_type`` and ``use_norm`` are accepted for config parity with
    the reference wrapper and change nothing (as in the JAX package);
    ``impl`` is accepted for config compatibility and not read (the port
    picks kernel E or the plain version by device). ``feat_dim`` is the
    source's channel count, which the probe model passes from its backbone
    (the JAX module infers it at init)."""

    def __init__(self, backbone_type: str | None = None,
                 use_norm: bool = True, key_dim: int = 32,
                 radius: int = RADIUS, impl: str = "auto",
                 feat_dim: int = 384) -> None:
        super().__init__()
        self.up1 = JBULearnedRange(key_dim, radius)
        self.up2 = JBULearnedRange(key_dim, radius)
        self.up3 = JBULearnedRange(key_dim, radius)
        self.up4 = JBULearnedRange(key_dim, radius)
        self.fixup_proj = nn.Conv2d(feat_dim, feat_dim, 1)

    def forward(self, source: torch.Tensor,
                guidance: torch.Tensor) -> torch.Tensor:
        dtype = self.fixup_proj.weight.dtype
        source, guidance = source.to(dtype), guidance.to(dtype)
        for stage in (self.up1, self.up2, self.up3, self.up4):
            h, w = source.shape[1], source.shape[2]
            g = adaptive_pool(guidance, (2 * h, 2 * w), "avg")
            source = stage(source, g)
        return conv1x1(self.fixup_proj, source) * 0.1 + source
