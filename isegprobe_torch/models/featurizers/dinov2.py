"""DINOv2 featurizer: the ViT configured as DINOv2-S/14 with the three
click-feature injection modes.

Counterpart of ``isegprobe_tpu/models/featurizers/dinov2.py``. Output is an
NHWC feature map ``[B, h, w, 384]``.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from isegprobe_torch.models.vit import ViT, ViTConfig

DINOV2_ARCHS = {
    # dinov2_vits14: patch 14, dim 384, depth 12, heads 6, LayerScale,
    # pretrained at 518x518 -> 37x37 pos-embed grid
    "dinov2_vits14": ViTConfig(patch_size=14, embed_dim=384, depth=12,
                               num_heads=6, pretrain_grid=(37, 37)),
}

INJECTION_MODES = ("no_injection", "before_backbone", "after_backbone")


class DINOv2Featurizer(nn.Module):
    def __init__(self, arch: str = "dinov2_vits14",
                 feats_injection_mode: str = "no_injection",
                 pretrain_grid=None, remat_blocks: bool = False) -> None:
        """``remat_blocks`` (recompute blocks in the backward of high-res
        training) is accepted for config compatibility: trained checkpoints
        carry it, and it does not change the forward."""
        super().__init__()
        if arch not in DINOV2_ARCHS:
            raise NotImplementedError(f"Unknown DINOv2 arch: {arch}")
        if feats_injection_mode not in INJECTION_MODES:
            raise ValueError(
                f"Unknown injection mode: {feats_injection_mode}")
        cfg = DINOV2_ARCHS[arch]
        if pretrain_grid is not None:
            # eval-time pre-interpolated pos embeddings
            cfg = dataclasses.replace(cfg, pretrain_grid=tuple(pretrain_grid))
        self.feats_injection_mode = feats_injection_mode
        self.patch_size = cfg.patch_size
        self.embed_dim = cfg.embed_dim
        self.model = ViT(cfg)

    def forward(self, x: torch.Tensor,
                additional_features: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x: ``[B, H, W, 3]``; additional_features: ``[B, N, D]`` click
        tokens."""
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        mode = self.feats_injection_mode
        if additional_features is not None and mode == "before_backbone":
            tokens = self.model.embed_patches(x)
            tokens = tokens + additional_features.to(tokens.dtype)
            feats = self.model.forward_tokens(tokens, (gh, gw))["patch_tokens"]
        else:
            feats = self.model(x)["patch_tokens"]
            if additional_features is not None and mode == "after_backbone":
                feats = feats.float() + additional_features.float()
        return feats.reshape(b, gh, gw, self.embed_dim)
