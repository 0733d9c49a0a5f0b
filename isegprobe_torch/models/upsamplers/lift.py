"""The LiFT feature upsampler and its layers, on NHWC tensors.

Counterpart of ``isegprobe_tpu/models/upsamplers/lift.py``: a small conv
decoder that doubles the feature resolution, guided by two strided conv
stacks over the image. Its BatchNorms are ``FrozenBatchNorm`` (inference
mode, statistics as parameters, identity at init); LoftUp's conv stem uses
the same layer. The reference loads LiFT frozen from ``lift_path``, which
the repo does not hold, so the upsampler keeps its drawn or PRNGKey(0)
weights. Convolutions compute in the compute dtype (``models/dtype.py``),
the transposed one in float32 (as the JAX package's); the FrozenBatchNorm
parameters are raw, as flax's, so over float32 parameters they promote a
bfloat16 input.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from isegprobe_torch.models.dtype import Conv2d, compute_dtype
from isegprobe_torch.ops.pool import adaptive_pool


def conv1x1(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 ``Conv2d`` applied to an NHWC tensor as a matmul over the
    channels, in the conv's compute dtype."""
    dt = compute_dtype(conv, conv.weight)
    bias = None if conv.bias is None else conv.bias.to(dt)
    return F.linear(x.to(dt), conv.weight[:, :, 0, 0].to(dt), bias)


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


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class ConvTranspose2x2(nn.Module):
    """Stride-2 2x2 transposed conv: ``out[2i+u, 2j+v, f] = Σ_c x[i, j, c]
    · weight[f, c, u, v] + bias[f]``. ``weight`` is the JAX kernel
    ``[2, 2, cin, f]`` in the bridge's conv layout ``[f, cin, 2, 2]``."""

    def __init__(self, in_features: int, features: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(x.float().permute(0, 3, 1, 2),
                               self.weight.float().transpose(0, 1),
                               self.bias.float(), stride=2)
        return y.permute(0, 2, 3, 1).to(compute_dtype(self, self.weight))


class _ConvBNRelu(nn.Module):
    def __init__(self, in_features: int, features: int, stride: int = 1,
                 use_bias: bool = True) -> None:
        super().__init__()
        self.conv = Conv2d(in_features, features, 3, stride=stride,
                           padding=1, bias=use_bias)
        self.bn = FrozenBatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(_conv_nhwc(self.conv, x)))


class _DoubleConv(nn.Module):
    def __init__(self, in_features: int, features: int) -> None:
        super().__init__()
        self.c1 = _ConvBNRelu(in_features, features, use_bias=False)
        self.c2 = _ConvBNRelu(features, features, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c2(self.c1(x))


class LiFTUpsampler(nn.Module):
    """``forward(source [B, h, w, C], guidance [B, H, W, 3]) -> [B, 2h, 2w,
    C]``. ``patch`` and ``lift_path`` are the config's (weights are loaded
    outside the module)."""

    def __init__(self, n_dim: int = 384, patch: int = 14,
                 lift_path: str | None = None) -> None:
        super().__init__()
        c = n_dim
        self.patch, self.lift_path = patch, lift_path
        self.image_convs_1a = _ConvBNRelu(3, 32, stride=2)
        self.image_convs_1b = _ConvBNRelu(32, 32, stride=2)
        self.image_convs_2 = _ConvBNRelu(32, 32, stride=2)
        self.up_transpose = ConvTranspose2x2(c + 32, (c + 32) // 2)
        self.up_conv = _DoubleConv((c + 32) // 2 + 32, c // 2)
        self.outc = Conv2d(c // 2, c, 1)

    def forward(self, source: torch.Tensor,
                guidance: torch.Tensor) -> torch.Tensor:
        h, w = source.shape[1], source.shape[2]
        g1 = self.image_convs_1b(self.image_convs_1a(guidance))
        g1 = adaptive_pool(g1, (2 * h, 2 * w), "max")
        g2 = self.image_convs_2(g1)
        x = torch.cat([source, g2.to(source.dtype)], dim=-1)
        x = self.up_transpose(x)
        x = self.up_conv(torch.cat([x, g1.to(x.dtype)], dim=-1))
        return conv1x1(self.outc, x)
