"""MaskCLIP featurizer: dense CLIP ViT-B/16 features by the value-projection
trick, with the three click-feature injection modes.

Counterpart of ``isegprobe_tpu/models/featurizers/maskclip.py`` (the visual
tower; the text tower is not ported). CLIP's ViT differs from the DINO
family: a bias-free conv stem, a pre-LN stem (``ln_pre``), QuickGELU MLPs,
torch ``MultiheadAttention``'s packed ``in_proj`` (q, k and v at rows 0, C
and 2C of ``in_proj_weight``), a position table without a batch dim that is
interpolated on every forward, LayerNorm eps 1e-5, and a final ``ln_post``
with a right-multiplied projection ``proj`` ``[width, output_dim]``. Dense
features run blocks 0..L-2 normally and replace the last block by its value
path only, ``out_proj(v_proj(ln_1(x)))``: no attention, no residual. That
block therefore has no ``ln_2`` / ``c_fc`` / ``c_proj`` (flax never creates
them, so the JAX param tree lacks them). One forward launches L-1 attention
kernels and 2L+1 LayerNorms. Output is NHWC ``[B, h, w, output_dim]``, float32;
inside, every layer computes in the compute dtype (``models/dtype.py``).
``masked_forward`` is the adaptive canvas's forward: each lane's position
table at its own grid and its invalid tokens out of every softmax (the
plain masked attention); everything after the blocks is pointwise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from isegprobe_torch.models.dtype import Conv2d, Linear, compute_dtype
from isegprobe_torch.models.featurizers.dinov2 import INJECTION_MODES
from isegprobe_torch.models.vit import (
    LayerNorm,
    canvas_token_mask,
    dynamic_table,
)
from isegprobe_torch.ops.attention import mha_qkv
from isegprobe_torch.ops.resize import resize

CLIP_ARCHS = {
    # ViT-B/16: the only arch of the reference
    "ViT-B/16": dict(patch_size=16, width=768, layers=12, heads=12,
                     output_dim=512, pretrain_grid=14),
}
LN_EPS = 1e-5
# the '+0.1' scale trick of the pos-embed interpolation
INTERPOLATE_OFFSET = 0.1


class _CLIPAttention(nn.Module):
    """torch ``nn.MultiheadAttention``'s layout: packed ``in_proj`` and
    ``out_proj``; attention through the packed-qkv kernel."""

    def __init__(self, width: int, heads: int) -> None:
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = Linear(width, width)

    def _in_proj(self, x: torch.Tensor, rows: slice) -> torch.Tensor:
        """``x @ in_proj_weight[rows].T + in_proj_bias[rows]`` in the
        compute dtype."""
        dt = compute_dtype(self, self.in_proj_weight)
        return F.linear(x.to(dt), self.in_proj_weight[rows].to(dt),
                        self.in_proj_bias[rows].to(dt))

    def forward(self, x: torch.Tensor,
                key_mask: torch.Tensor | None = None) -> torch.Tensor:
        qkv = self._in_proj(x, slice(None))
        dh = x.shape[-1] // self.heads
        out = mha_qkv(qkv, self.heads, scale=dh**-0.5, key_mask=key_mask)
        return self.out_proj(out)

    def value_path(self, x: torch.Tensor) -> torch.Tensor:
        """``out_proj(v_proj(x))``, the MaskCLIP dense trick."""
        return self.out_proj(self._in_proj(x, slice(2 * x.shape[-1], None)))


class _CLIPBlock(nn.Module):
    """A residual attention block; ``value_only`` builds the last block of
    the dense tower, which keeps only ``ln_1`` and ``attn``."""

    def __init__(self, width: int, heads: int,
                 value_only: bool = False) -> None:
        super().__init__()
        self.ln_1 = LayerNorm(width, LN_EPS)
        self.attn = _CLIPAttention(width, heads)
        if not value_only:
            self.ln_2 = LayerNorm(width, LN_EPS)
            self.c_fc = Linear(width, 4 * width)
            self.c_proj = Linear(4 * width, width)

    def forward(self, x: torch.Tensor,
                key_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), key_mask)
        h = self.c_fc(self.ln_2(x))
        return x + self.c_proj(h * torch.sigmoid(1.702 * h))  # QuickGELU

    def forward_v(self, x: torch.Tensor) -> torch.Tensor:
        return self.attn.value_path(self.ln_1(x))


class CLIPVisionTransformer(nn.Module):
    def __init__(self, patch_size: int = 16, width: int = 768,
                 layers: int = 12, heads: int = 12, output_dim: int = 512,
                 pretrain_grid: int = 14) -> None:
        super().__init__()
        self.patch_size = patch_size
        self.width = width
        self.pretrain_grid = pretrain_grid
        self.conv1 = Conv2d(3, width, patch_size, stride=patch_size,
                            bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(width))
        self.positional_embedding = nn.Parameter(
            torch.zeros(pretrain_grid**2 + 1, width))
        self.ln_pre = LayerNorm(width, LN_EPS)
        self.resblocks = nn.ModuleList(
            _CLIPBlock(width, heads, value_only=i == layers - 1)
            for i in range(layers))
        self.ln_post = LayerNorm(width, LN_EPS)
        self.proj = nn.Parameter(torch.zeros(width, output_dim))

    def embed_patches(self, x: torch.Tensor) -> torch.Tensor:
        """NHWC image -> patch tokens ``[B, N, width]``."""
        return self.conv1(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)

    def _interp_pos(self, grid_hw: tuple[int, int]) -> torch.Tensor:
        """The position table at ``grid_hw`` (float32): bicubic with the
        '+0.1' scale trick, the raw table at the pretraining grid."""
        gh, gw = grid_hw
        g0 = self.pretrain_grid
        pe = self.positional_embedding.float()
        if (gh, gw) == (g0, g0):
            return pe
        patch_pe = pe[1:].reshape(1, g0, g0, self.width)
        scales = ((gh + INTERPOLATE_OFFSET) / g0,
                  (gw + INTERPOLATE_OFFSET) / g0)
        patch_pe = resize(patch_pe, (gh, gw), "bicubic", align_corners=False,
                          scales=scales)
        return torch.cat([pe[:1], patch_pe.reshape(gh * gw, self.width)])

    def dense_features(self, tokens: torch.Tensor,
                       grid_hw: tuple[int, int]) -> torch.Tensor:
        """tokens ``[B, N, width]`` (before cls and pos) -> dense features
        ``[B, N, output_dim]``."""
        b = tokens.shape[0]
        cls = self.class_embedding.to(tokens.dtype).expand(b, 1, -1)
        x = torch.cat([cls, tokens], dim=1)
        x = x + self._interp_pos(grid_hw).to(x.dtype)
        x = self.ln_pre(x)
        for blk in self.resblocks[:-1]:
            x = blk(x)
        x = self.resblocks[-1].forward_v(x)
        x = self.ln_post(x[:, 1:])  # cls dropped
        return x @ self.proj.to(x.dtype)

    def dense_features_masked(self, tokens: torch.Tensor,
                              canvas_grid: tuple[int, int],
                              valid_grid: torch.Tensor) -> torch.Tensor:
        """:meth:`dense_features` on a canvas grid whose top-left
        ``valid_grid`` ``[B, 2]`` rect of tokens is valid per lane."""
        b = tokens.shape[0]
        g0 = self.pretrain_grid
        mask = canvas_token_mask(canvas_grid, valid_grid)
        cls = self.class_embedding.to(tokens.dtype).expand(b, 1, -1)
        x = torch.cat([cls, tokens], dim=1)
        x = x + dynamic_table(self.positional_embedding.float(), (g0, g0),
                              canvas_grid, valid_grid).to(x.dtype)
        x = self.ln_pre(x)
        x = x * mask[..., None].to(x.dtype)  # keeps invalid tokens bounded
        for blk in self.resblocks[:-1]:
            x = blk(x, mask)
        x = self.resblocks[-1].forward_v(x)
        x = self.ln_post(x[:, 1:])
        return x @ self.proj.to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        grid_hw = (x.shape[1] // self.patch_size,
                   x.shape[2] // self.patch_size)
        return self.dense_features(self.embed_patches(x), grid_hw)


class MaskCLIPFeaturizer(nn.Module):
    """The tower with click injection; output ``[B, gh, gw, 512]``."""

    def __init__(self, model_name: str = "ViT-B/16",
                 feats_injection_mode: str = "no_injection") -> None:
        super().__init__()
        if model_name not in CLIP_ARCHS:
            raise ValueError(f"Currently unsupported model_name for "
                             f"MaskCLIP: {model_name}")
        if feats_injection_mode not in INJECTION_MODES:
            raise ValueError(
                f"Unknown injection mode: {feats_injection_mode}")
        arch = CLIP_ARCHS[model_name]
        self.feats_injection_mode = feats_injection_mode
        self.patch_size = arch["patch_size"]
        self.embed_dim = arch["output_dim"]
        self.model = CLIPVisionTransformer(**arch)

    def forward(self, x: torch.Tensor,
                additional_features: torch.Tensor | None = None
                ) -> torch.Tensor:
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        mode = self.feats_injection_mode
        tokens = self.model.embed_patches(x)
        if additional_features is not None and mode == "before_backbone":
            tokens = tokens + additional_features.to(tokens.dtype)
        feats = self.model.dense_features(tokens, (gh, gw)).float()
        if additional_features is not None and mode == "after_backbone":
            feats = feats + additional_features.float()
        return feats.reshape(b, gh, gw, -1)

    def masked_forward(self, x: torch.Tensor,
                       additional_features: torch.Tensor | None,
                       valid_grid: torch.Tensor) -> torch.Tensor:
        """The forward on a canvas whose top-left ``valid_grid`` ``[B, 2]``
        rect of tokens is valid per lane."""
        b, h, w, _ = x.shape
        gh, gw = h // self.patch_size, w // self.patch_size
        mode = self.feats_injection_mode
        tokens = self.model.embed_patches(x)
        if additional_features is not None and mode == "before_backbone":
            tokens = tokens + additional_features.to(tokens.dtype)
        feats = self.model.dense_features_masked(tokens, (gh, gw),
                                                 valid_grid).float()
        if additional_features is not None and mode == "after_backbone":
            feats = feats + additional_features.float()
        return feats.reshape(b, gh, gw, -1)
