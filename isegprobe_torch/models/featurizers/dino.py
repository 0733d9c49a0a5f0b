"""DINO featurizer (the config's ``vit`` backbone): the DINO ViT-S/16 trunk
probed by the last block's keys (``feat_type='key'``, the default) or by
its output patch tokens (``'token'``), with the three click-feature
injection modes.

Counterpart of ``isegprobe_tpu/models/featurizers/dino.py``. The trunk is
always ViT-S/16 (no LayerScale, LayerNorm eps 1e-6, pretrained at 224² so
its pos-embed grid is 14², '+0.1' interpolation); ``arch`` names the
pretrained weights that would be converted into it and does not change the
module. Output is an NHWC feature map ``[B, h, w, 384]``; ``masked_forward``
is the adaptive canvas's forward.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from isegprobe_torch.models.featurizers.dinov2 import INJECTION_MODES
from isegprobe_torch.models.vit import ViT, ViTConfig

DINO_TRUNK = ViTConfig(patch_size=16, embed_dim=384, depth=12, num_heads=6,
                       pretrain_grid=(14, 14), layerscale=False)
FEAT_TYPES = ("key", "token")


class DINOFeaturizer(nn.Module):
    def __init__(self, arch: str = "dino_vits16", patch_size: int = 16,
                 feat_type: str = "key",
                 feats_injection_mode: str = "no_injection",
                 pretrain_grid=None, remat_blocks: bool = False,
                 quant: str | None = None) -> None:
        """``remat_blocks``: recompute each block in the backward (it does
        not change the forward). ``quant='int8'``: the blocks' dense layers
        in dynamic W8A8 (``ops/quant.py``), the key probe's qkv among
        them."""
        super().__init__()
        if feats_injection_mode not in INJECTION_MODES:
            raise ValueError(
                f"Unknown injection mode: {feats_injection_mode}")
        if feat_type not in FEAT_TYPES:
            raise ValueError(f"Unknown feat_type: {feat_type}")
        overrides = dict(patch_size=patch_size, remat_blocks=remat_blocks,
                         quant=quant)
        if pretrain_grid is not None:
            # eval-time pre-interpolated pos embeddings
            overrides["pretrain_grid"] = tuple(pretrain_grid)
        cfg = dataclasses.replace(DINO_TRUNK, **overrides)
        self.feat_type = feat_type
        self.feats_injection_mode = feats_injection_mode
        self.patch_size = patch_size
        self.embed_dim = cfg.embed_dim
        self.model = ViT(cfg)

    def forward(self, x: torch.Tensor,
                additional_features: torch.Tensor | None = None
                ) -> torch.Tensor:
        """x: ``[B, H, W, 3]``; additional_features: ``[B, N, D]`` click
        tokens."""
        return self._features(x, additional_features, None)

    def masked_forward(self, x: torch.Tensor,
                       additional_features: torch.Tensor | None,
                       valid_grid: torch.Tensor) -> torch.Tensor:
        """The forward on a canvas whose top-left ``valid_grid`` ``[B, 2]``
        rect of tokens is valid per lane. Both probing modes are exact on
        the valid rect: the keys are pointwise projections of tokens that
        the masked blocks make exact."""
        return self._features(x, additional_features, valid_grid)

    def _features(self, x, additional_features, valid_grid):
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        mode = self.feats_injection_mode
        tokens = self.model.embed_patches(x)
        if additional_features is not None and mode == "before_backbone":
            tokens = tokens + additional_features.to(tokens.dtype)
        key = self.feat_type == "key"
        if valid_grid is None:
            out = self.model.forward_tokens(tokens, (gh, gw),
                                            return_last_k=key)
        else:
            out = self.model.forward_tokens_masked(tokens, (gh, gw),
                                                   valid_grid,
                                                   return_last_k=key)
        # the key probe: the last block's keys, cls dropped, heads flattened
        feats = out["last_k"][:, 1:] if key else out["patch_tokens"]
        if additional_features is not None and mode == "after_backbone":
            feats = feats + additional_features.to(feats.dtype)
        return feats.reshape(b, gh, gw, self.embed_dim)
