"""SimpleViT (lucidrains-style): the trainable click encoder of late
injection.

Counterpart of ``isegprobe_tpu/models/featurizers/simple_vit.py``. Unlike
the frozen trunks it patchifies linearly (LayerNorm, Dense, LayerNorm over
the ``(p1 p2 c)`` pixels of a patch), adds the fixed 2-D sin-cos embedding
of the input's grid (no cls token, no learned table, so the configured
``image_size`` is not checked), and attends with a bias-free packed qkv of
``heads × dim_head`` columns, which need not equal ``dim``. LayerNorms use
flax's default eps 1e-6, the MLP exact GELU. flax makes ``patch_norm1`` as
wide as its input, so the port takes the input's channel count at
construction (``channels``: the probe model passes its click maps', 3 with
the previous mask). Output is tokens ``[B, N, dim]`` in the compute dtype
(``models/dtype.py``); ``patch_norm1`` takes the click maps as they come,
as flax's LayerNorm does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from isegprobe_torch.models.dtype import Linear
from isegprobe_torch.models.vit import LayerNorm, posemb_sincos_2d
from isegprobe_torch.ops.attention import mha_qkv


def _pair(t):
    return tuple(t) if isinstance(t, (tuple, list)) else (t, t)


class _SimpleAttention(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int) -> None:
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.norm = LayerNorm(dim)
        self.to_qkv = Linear(dim, 3 * inner, bias=False)
        self.to_out = Linear(inner, dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.to_qkv(self.norm(x))
        return self.to_out(mha_qkv(qkv, self.heads,
                                   scale=self.dim_head**-0.5))


class _SimpleFeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.norm = LayerNorm(dim)
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(self.norm(x)), approximate="none"))


class SimpleViTFeaturizer(nn.Module):
    def __init__(self, image_size=224, patch_size=16, dim: int = 384,
                 depth: int = 6, heads: int = 8, mlp_dim: int = 768,
                 channels: int = 3, dim_head: int = 64) -> None:
        super().__init__()
        self.patch_hw = _pair(patch_size)
        self.dim = dim
        patch_dim = self.patch_hw[0] * self.patch_hw[1] * channels
        self.patch_norm1 = LayerNorm(patch_dim)
        self.patch_proj = Linear(patch_dim, dim)
        self.patch_norm2 = LayerNorm(dim)
        self.attn = nn.ModuleList(_SimpleAttention(dim, heads, dim_head)
                                  for _ in range(depth))
        self.ff = nn.ModuleList(_SimpleFeedForward(dim, mlp_dim)
                                for _ in range(depth))
        self.final_norm = LayerNorm(dim)

    def forward(self, img: torch.Tensor) -> torch.Tensor:
        """img: ``[B, H, W, C]`` -> tokens ``[B, N, dim]``."""
        ph, pw = self.patch_hw
        b, h, w, c = img.shape
        gh, gw = h // ph, w // pw
        x = img.reshape(b, gh, ph, gw, pw, c)
        x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, gh * gw, ph * pw * c)
        x = self.patch_norm2(self.patch_proj(self.patch_norm1(x)))
        x = x + posemb_sincos_2d(gh, gw, self.dim, x.device).to(x.dtype)
        for attn, ff in zip(self.attn, self.ff):
            x = x + attn(x)
            x = x + ff(x)
        return self.final_norm(x)
