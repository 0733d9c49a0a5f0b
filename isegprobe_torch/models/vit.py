"""Vision Transformer core as ``nn.Module``s (the DINOv2 and DINO trunks).

Counterpart of ``isegprobe_tpu/models/vit.py``: ``PatchEmbed``,
``Attention`` (the packed-qkv path), ``Mlp`` with exact GELU, ``LayerScale``,
``Block`` and ``ViT`` with the bicubic pos-embed interpolation and its
exact-size short-circuit, the last block's keys for DINO's key probing, and
the SimpleViT sin-cos embedding (``posemb_sincos_2d``), and the adaptive
canvas's forward (``ViT.forward_tokens_masked``). The two ported
trunks differ only in LayerScale, ``ViTConfig``'s one family switch; what
they share (qkv biases, a cls token, LayerNorm eps 1e-6, MLP ratio 4,
exact GELU, the '+0.1' pos-embed scale trick) is fixed here. Module and
parameter names follow the JAX param tree (``blocks.i`` for ``blocks_i``)
so the weight bridge (``models/convert.py``) is a rename and a transpose.

Images are NHWC at the public seams; convolutions run NCHW inside. Each
module computes in its compute dtype (``models/dtype.py``): bfloat16 over
float32 parameters in mixed-precision training, where LayerScale's raw
``gamma`` promotes the residual stream to float32 after the first block
as jnp does, else the dtype of its parameters (float32, or bfloat16 after
``.to(torch.bfloat16)``). With ``remat_blocks`` each block is recomputed
in the backward (``torch.utils.checkpoint``, the JAX ``nn.remat``).
Attention and LayerNorm go through the port's CUDA kernels on a GPU and
their plain versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from isegprobe_torch.models.dtype import Conv2d, Linear, compute_dtype
from isegprobe_torch.ops.attention import mha_qkv
from isegprobe_torch.ops.dynamic_resize import dyn_matrix
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
    # on in the DINOv2 trunk (the port's first, so the default here), off in
    # DINO's and in the JAX dataclass
    layerscale: bool = True
    # recompute each block in the backward (high-res training)
    remat_blocks: bool = False


class PatchEmbed(nn.Module):
    """Conv patch embedding: NHWC image -> ``[B, N, D]`` tokens (row-major
    over the patch grid)."""

    def __init__(self, in_chans: int, patch_size: int,
                 embed_dim: int) -> None:
        super().__init__()
        self.proj = Conv2d(in_chans, embed_dim, patch_size,
                           stride=patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x.permute(0, 3, 1, 2)).flatten(2).transpose(1, 2)


class LayerNorm(nn.Module):
    """LayerNorm with flax's f32 fast-variance statistics (``ops.layernorm``:
    the CUDA kernel on a GPU), output in the compute dtype. As flax's
    ``nn.LayerNorm`` it takes the input as it comes; with ``cast_input``,
    as the JAX ViT's ``FusedLayerNorm``, it casts the input to the compute
    dtype first. ``real`` (0: all): the statistics cover the first
    ``real`` of ``dim`` channels, as flax's ``nn.LayerNorm(mask=)`` in
    LoftUp's zero-padded layout."""

    def __init__(self, dim: int, eps: float = NORM_EPS,
                 cast_input: bool = False, real: int = 0) -> None:
        super().__init__()
        self.eps = eps
        self.cast_input = cast_input
        self.real = real or None
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self, self.weight)
        if self.cast_input:
            x = x.to(dt)
        return layernorm(x.contiguous(), self.weight, self.bias,
                         self.eps, self.real).to(dt)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor,
                key_mask: torch.Tensor | None = None) -> torch.Tensor:
        """``key_mask`` ``[B, N]``: keys to keep in every softmax (the
        adaptive canvas's valid tokens), through the plain masked path."""
        dh = x.shape[-1] // self.num_heads
        out = mha_qkv(self.qkv(x), self.num_heads, scale=dh**-0.5,
                      key_mask=key_mask)
        return self.proj(out)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden_dim: int) -> None:
        super().__init__()
        self.fc1 = Linear(dim, hidden_dim)
        self.fc2 = Linear(hidden_dim, dim)

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
        self.norm1 = LayerNorm(d, cast_input=True)
        self.attn = Attention(d, cfg.num_heads)
        self.ls1 = LayerScale(d) if cfg.layerscale else nn.Identity()
        self.norm2 = LayerNorm(d, cast_input=True)
        self.mlp = Mlp(d, MLP_RATIO * d)
        self.ls2 = LayerScale(d) if cfg.layerscale else nn.Identity()

    def forward(self, x: torch.Tensor,
                key_mask: torch.Tensor | None = None) -> torch.Tensor:
        x = x + self.ls1(self.attn(self.norm1(x), key_mask))
        return x + self.ls2(self.mlp(self.norm2(x)))

    def keys(self, x: torch.Tensor) -> torch.Tensor:
        """The block's attention keys ``[B, N, C]`` (heads flattened): a
        view of the packed qkv projection."""
        c = x.shape[-1]
        return self.attn.qkv(self.norm1(x))[..., c:2 * c]


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
        self.norm = LayerNorm(d, cast_input=True)

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
                       grid_hw: tuple[int, int],
                       return_last_k: bool = False) -> dict:
        """cls-concat + pos-embed + blocks + final norm -> ``tokens`` and
        ``patch_tokens``. With ``return_last_k`` the dict holds only
        ``last_k`` ``[B, 1 + N, C]``, the last block's keys: what comes
        after them in that block and the final norm do not reach them and
        are not run (the JAX program computes them and XLA drops them)."""
        cls = self.cls_token.to(tokens.dtype).expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1)
        x = tokens + self.interpolated_pos_embed(grid_hw).to(tokens.dtype)
        blocks = self.blocks[:-1] if return_last_k else self.blocks
        remat = self.cfg.remat_blocks and torch.is_grad_enabled()
        for blk in blocks:
            x = (checkpoint(blk, x, use_reentrant=False,
                            preserve_rng_state=False) if remat else blk(x))
        if return_last_k:
            return {"last_k": self.blocks[-1].keys(x)}
        x = self.norm(x)
        return {"tokens": x, "patch_tokens": x[:, 1:]}

    def dynamic_pos_embed(self, canvas_grid: tuple[int, int],
                          valid_grid: torch.Tensor) -> torch.Tensor:
        """The pos-embed interpolated to each lane's token grid
        (``valid_grid`` ``[B, 2]``), laid out row-major on the canvas grid
        and zero beyond each lane's rect: :meth:`interpolated_pos_embed` per
        lane, its raw table where a lane's grid is the pretraining grid,
        computed in float32 as the JAX package's ``dynamic_pos_embed``.
        Returns ``[B, 1 + gh_cap·gw_cap, D]``."""
        c = self.cfg
        return dynamic_table(self.pos_embed.float()[0], c.pretrain_grid,
                             canvas_grid, valid_grid)

    def forward_tokens_masked(self, tokens: torch.Tensor,
                              canvas_grid: tuple[int, int],
                              valid_grid: torch.Tensor,
                              return_last_k: bool = False) -> dict:
        """:meth:`forward_tokens` on a canvas grid whose top-left
        ``valid_grid`` ``[B, 2]`` rect of tokens is valid per lane: the
        pos-embed follows each lane's grid and invalid tokens are left out
        of every softmax, so valid tokens come out as the plain forward of
        the true-size input gives them. Invalid tokens are zeroed after the
        pos-embed and carry garbage after it."""
        b = tokens.shape[0]
        mask = canvas_token_mask(canvas_grid, valid_grid)
        cls = self.cls_token.to(tokens.dtype).expand(b, -1, -1)
        x = torch.cat([cls, tokens], dim=1)
        x = x + self.dynamic_pos_embed(canvas_grid, valid_grid).to(x.dtype)
        x = x * mask[..., None].to(x.dtype)
        blocks = self.blocks[:-1] if return_last_k else self.blocks
        for blk in blocks:
            x = blk(x, mask)
        if return_last_k:
            return {"last_k": self.blocks[-1].keys(x)}
        x = self.norm(x)
        return {"tokens": x, "patch_tokens": x[:, 1:]}

    def forward(self, img: torch.Tensor) -> dict:
        p = self.cfg.patch_size
        grid_hw = (img.shape[1] // p, img.shape[2] // p)
        return self.forward_tokens(self.embed_patches(img), grid_hw)


def canvas_token_mask(canvas_grid: tuple[int, int],
                      valid_grid: torch.Tensor) -> torch.Tensor:
    """``[B, 1 + gh_cap·gw_cap]`` bool: the cls token and each lane's valid
    ``valid_grid`` ``[B, 2]`` rect of the row-major canvas grid."""
    gh_cap, gw_cap = canvas_grid
    dev = valid_grid.device
    ii = torch.arange(gh_cap, device=dev)[None, :, None]
    jj = torch.arange(gw_cap, device=dev)[None, None, :]
    patch = ((ii < valid_grid[:, 0, None, None])
             & (jj < valid_grid[:, 1, None, None]))
    cls = torch.ones((valid_grid.shape[0], 1), dtype=torch.bool, device=dev)
    return torch.cat([cls, patch.flatten(1)], dim=1)


def dynamic_table(pe: torch.Tensor, pretrain_grid: tuple[int, int],
                  canvas_grid: tuple[int, int],
                  valid_grid: torch.Tensor) -> torch.Tensor:
    """A position table ``pe`` ``[1 + gh0·gw0, D]`` (float32, cls row
    first) bicubically interpolated, with the '+0.1' scale trick, to each
    lane's ``valid_grid`` ``[B, 2]``, laid out on the canvas grid, zero
    beyond each lane's rect; a lane at the pretraining grid gets the raw
    table. Returns ``[B, 1 + gh_cap·gw_cap, D]``."""
    gh0, gw0 = pretrain_grid
    gh_cap, gw_cap = canvas_grid
    d = pe.shape[-1]
    b = valid_grid.shape[0]
    patch_pe = pe[1:].reshape(gh0, gw0, d)
    gh, gw = valid_grid[:, 0], valid_grid[:, 1]
    mr = dyn_matrix(gh0, gh_cap, gh0, gh, "bicubic", False,
                    (gh.float() + INTERPOLATE_OFFSET) / gh0)
    mc = dyn_matrix(gw0, gw_cap, gw0, gw, "bicubic", False,
                    (gw.float() + INTERPOLATE_OFFSET) / gw0)
    interp = torch.einsum("boh,hwc->bowc", mr, patch_pe)
    interp = torch.einsum("bpw,bowc->bopc", mc, interp)
    if gh0 <= gh_cap and gw0 <= gw_cap:
        # the exact-size short-circuit: the raw table, laid out
        raw = torch.zeros((gh_cap, gw_cap, d), dtype=torch.float32,
                          device=pe.device)
        raw[:gh0, :gw0] = patch_pe
        same = (gh == gh0) & (gw == gw0)
        interp = torch.where(same[:, None, None, None], raw, interp)
    valid = canvas_token_mask(canvas_grid, valid_grid)[:, 1:]
    patch = torch.where(valid[..., None],
                        interp.reshape(b, gh_cap * gw_cap, d), 0.0)
    return torch.cat([pe[:1].expand(b, 1, d), patch], dim=1)


@functools.lru_cache(maxsize=32)
def posemb_sincos_2d(h: int, w: int, dim: int,
                     device: torch.device) -> torch.Tensor:
    """The SimpleViT fixed 2-D sin-cos embedding ``[h·w, dim]`` (float32,
    computed in float64 as the JAX package's ``posemb_sincos_2d``) on
    ``device``, made once per grid and device (a copy per forward would be a
    sync in the on-device click loop), as a normal tensor even when first
    made under inference mode."""
    if dim % 4:
        raise ValueError(f"sin-cos embedding width {dim} is no multiple of 4")
    y, x = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    omega = 1.0 / 10000.0**(np.arange(dim // 4) / (dim // 4 - 1))
    y = y.flatten()[:, None] * omega[None, :]
    x = x.flatten()[:, None] * omega[None, :]
    pe = np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1)
    with torch.inference_mode(False):
        return torch.from_numpy(pe.astype(np.float32)).to(device)


def init_params(module: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter of ``module`` from a seeded CPU generator, with
    flax's scales: normal linear and conv weights (and LoftUp's packed
    ``in_proj_weight``) of variance 1/fan_in, zero biases and cls token,
    unit LayerNorm scales, N(0, 0.02) pos and class embeddings, CLIP's
    ``proj`` of variance 1/its rows, N(0, 1) Fourier-feature
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
            elif leaf in ("pos_embed", "positional_embedding",
                          "class_embedding"):
                v = torch.randn(p.shape, generator=g) * 0.02
            elif leaf == "proj":  # CLIP's right-multiplied projection
                v = torch.randn(p.shape, generator=g) / math.sqrt(p.shape[0])
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
