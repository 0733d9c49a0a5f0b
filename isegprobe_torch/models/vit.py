"""Vision Transformer core as ``nn.Module``s (the DINOv2 trunk).

Counterpart of ``isegprobe_tpu/models/vit.py``: ``PatchEmbed``,
``Attention`` (the packed-qkv path), ``Mlp`` with exact GELU, ``LayerScale``,
``Block`` and ``ViT`` with the bicubic pos-embed interpolation and its
exact-size short-circuit. Only the DINOv2 family is ported so far, so its
constants (biases everywhere, LayerScale, a cls token, MLP ratio 4,
LayerNorm eps 1e-6, the '+0.1' pos-embed scale trick) are fixed here rather
than options; the other families bring the options they need. Module and
parameter names follow the JAX param tree (``blocks.i`` for ``blocks_i``)
so the weight bridge (``models/convert.py``) is a rename and a transpose.

Images are NHWC at the public seams; convolutions run NCHW inside. Each
module computes in the dtype of its parameters (float32, or bfloat16 after
``.to(torch.bfloat16)``); attention and LayerNorm go through the port's CUDA
kernels on a GPU and their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from isegprobe_torch.ops.attention import mha_qkv
from isegprobe_torch.ops.layernorm import layernorm
from isegprobe_torch.ops.resize import resize


MLP_RATIO = 4
NORM_EPS = 1e-6
# the DINOv2 hub models' LayerScale init_values; loaded weights overwrite it
LAYERSCALE_INIT = 1e-5
# DINO-family '+0.1' scale-factor trick for pos-embed interpolation
INTERPOLATE_OFFSET = 0.1


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    patch_size: int = 14
    embed_dim: int = 384
    depth: int = 12
    num_heads: int = 6
    # pos-embed grid the checkpoint was pretrained at (DINOv2-S/14: 518/14)
    pretrain_grid: tuple[int, int] = (37, 37)


class PatchEmbed(nn.Module):
    """Conv patch embedding: NHWC image -> ``[B, N, D]`` tokens (row-major
    over the patch grid)."""

    def __init__(self, in_chans: int, patch_size: int,
                 embed_dim: int) -> None:
        super().__init__()
        self.proj = nn.Conv2d(in_chans, embed_dim, patch_size,
                              stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.proj.weight.dtype)
        return self.proj(x).flatten(2).transpose(1, 2)


class LayerNorm(nn.Module):
    """LayerNorm with flax's f32 fast-variance statistics (``ops.layernorm``:
    the CUDA kernel on a GPU)."""

    def __init__(self, dim: int, eps: float = NORM_EPS) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layernorm(x.contiguous(), self.weight, self.bias, self.eps)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dh = x.shape[-1] // self.num_heads
        out = mha_qkv(self.qkv(x), self.num_heads, scale=dh**-0.5)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden_dim)
        self.fc2 = nn.Linear(hidden_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class LayerScale(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), LAYERSCALE_INIT))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma


class Block(nn.Module):
    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        d = cfg.embed_dim
        self.norm1 = LayerNorm(d)
        self.attn = Attention(d, cfg.num_heads)
        self.ls1 = LayerScale(d)
        self.norm2 = LayerNorm(d)
        self.mlp = Mlp(d, MLP_RATIO * d)
        self.ls2 = LayerScale(d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x)))
        return x + self.ls2(self.mlp(self.norm2(x)))


class ViT(nn.Module):
    """The transformer trunk with cls token and interpolated pos embeddings.

    Seams used by the featurizer for click injection: ``embed_patches(img)``
    -> patch tokens ``[B, N, D]``; ``forward_tokens(tokens, grid_hw)`` ->
    dict of normalized ``tokens`` and ``patch_tokens``.
    """

    def __init__(self, cfg: ViTConfig) -> None:
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        self.patch_embed = PatchEmbed(3, cfg.patch_size, d)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        gh, gw = cfg.pretrain_grid
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + gh * gw, d))
        self.blocks = nn.ModuleList(Block(cfg) for _ in range(cfg.depth))
        self.norm = LayerNorm(d)

    def interpolated_pos_embed(self, grid_hw: tuple[int, int]) -> torch.Tensor:
        """Bicubic pos-embed interpolation to a new token grid (float32),
        with the '+0.1' scale trick. Returns the raw table when the grid
        equals the pretraining grid."""
        c = self.cfg
        gh0, gw0 = c.pretrain_grid
        gh, gw = grid_hw
        pe = self.pos_embed.float()
        if (gh, gw) == (gh0, gw0):
            return pe
        patch_pe = pe[:, 1:].reshape(1, gh0, gw0, c.embed_dim)
        scales = ((gh + INTERPOLATE_OFFSET) / gh0,
                  (gw + INTERPOLATE_OFFSET) / gw0)
        patch_pe = resize(patch_pe, (gh, gw), "bicubic", align_corners=False,
                          scales=scales)
        return torch.cat([pe[:, :1],
                          patch_pe.reshape(1, gh * gw, c.embed_dim)], dim=1)

    def embed_patches(self, img: torch.Tensor) -> torch.Tensor:
        return self.patch_embed(img)

    def forward_tokens(self, tokens: torch.Tensor,
                       grid_hw: tuple[int, int]) -> dict:
        """cls-concat + pos-embed + blocks + final norm."""
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        x = tokens + self.interpolated_pos_embed(grid_hw).to(tokens.dtype)
        for blk in self.blocks:
            x = blk(x)
        x = self.norm(x)
        return {"tokens": x, "patch_tokens": x[:, 1:]}

    def forward(self, img: torch.Tensor) -> dict:
        p = self.cfg.patch_size
        grid_hw = (img.shape[1] // p, img.shape[2] // p)
        return self.forward_tokens(self.embed_patches(img), grid_hw)


def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of ``module`` from a seeded CPU generator, with
    flax's scales: normal linear and conv weights (and LoftUp's packed
    ``in_proj_weight``) of variance 1/fan_in, zero biases and cls token,
    unit LayerNorm scales, N(0, 0.02) pos embeddings, N(0, 1) Fourier-feature
    biases; LayerScale gammas are set to 1 (not 1e-5) so that every block
    shapes the output of a randomly drawn model. FrozenBatchNorm statistics
    are drawn away from the identity (mean N(0, 0.5²), var U(0.5, 2)), and
    JBU's learned scalars are set to range_temp 0.5 and sigma_spatial 0.8,
    so that a drawn upsampler exercises them. The values do not depend on
    the device the module lives on."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                v = torch.ones(p.shape)
            elif leaf == "pos_embed":
                v = torch.randn(p.shape, generator=g) * 0.02
            elif leaf == "biases":
                v = torch.randn(p.shape, generator=g)
            elif leaf == "mean":
                v = torch.randn(p.shape, generator=g) * 0.5
            elif leaf == "var":
                v = torch.rand(p.shape, generator=g) * 1.5 + 0.5
            elif leaf == "range_temp":
                v = torch.full(p.shape, 0.5)
            elif leaf == "sigma_spatial":
                v = torch.full(p.shape, 0.8)
            elif leaf in ("weight", "in_proj_weight") and p.ndim >= 2:
                fan_in = math.prod(p.shape[1:])
                v = torch.randn(p.shape, generator=g) / math.sqrt(fan_in)
            elif leaf == "weight":
                v = torch.ones(p.shape)
            else:  # biases, cls token
                v = torch.zeros(p.shape)
            p.copy_(v)
    return module
