"""One-pass row LayerNorm: a hand-written CUDA kernel for Hopper
(``csrc/layernorm.cu``) and its plain PyTorch version.

Counterpart of ``isegprobe_tpu/ops/layernorm.py:layernorm``; the kernel
replaces the Pallas TPU kernel ``_ln_pallas``. Numerics are flax's default
LayerNorm: f32 statistics by fast variance, ``max(0, E[x²] − E[x]²)``,
whatever the IO dtype, then rsqrt, scale and bias, output in the IO dtype.
(``F.layer_norm`` takes its variance in two passes and is not used.)
``real`` (default: every channel) takes the statistics over the first
``real`` channels only and normalises every channel with them: flax's
``nn.LayerNorm(mask=arange(C) < real)``, which LoftUp's zero-padded
``mxu_pad`` layout runs (404 of 512 channels, 203 of 256). The
kernel's source note gives its bound (bytes) and design.

On a CPU tensor :func:`layernorm` computes the plain version; on a CUDA
tensor it launches the kernel or raises. ``layernorm.launches`` counts the
launches. Under autograd the kernel runs inside :class:`LayerNormKernel`,
the counterpart of the JAX package's ``_ln_pallas_ad``: the forward is the
kernel, and the backward recomputes the plain version and returns its VJP
(the JAX ``custom_vjp`` does the same with ``_ln_jnp``), so a click encoder
trains through the frozen backbone's LayerNorms.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from isegprobe_torch.ops import cuda_lib
from isegprobe_torch.ops.plain_vjp import plain_vjp

__all__ = ["LayerNormKernel", "layernorm"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_D = 1024
_lib = None


def _ln_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float, real: Optional[int] = None) -> torch.Tensor:
    """The same function in plain PyTorch (the JAX package's ``_ln_jnp``;
    with ``real``, flax's masked statistics over the first ``real``
    channels)."""
    xf = x.float()
    xs = xf if real is None else xf[..., :real]
    m = xs.mean(dim=-1, keepdim=True)
    var = torch.clamp((xs * xs).mean(dim=-1, keepdim=True) - m * m, min=0.0)
    y = (xf - m) * torch.rsqrt(var + eps)
    y = y * weight.float() + bias.float()
    return y.to(x.dtype)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("layernorm")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_layernorm.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                       ctypes.c_float, ci, ci, vp]
        lib.iseg_layernorm.restype = ci
        _lib = lib
    return _lib


def _ln_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, real: Optional[int] = None) -> torch.Tensor:
    d = x.shape[-1]
    real = d if real is None else real
    for name, t in (("x", x), ("weight", weight), ("bias", bias)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"layernorm kernel takes float32 or bfloat16 "
                            f"{name}, got {t.dtype}")
        if not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"layernorm kernel needs a contiguous {name} on "
                             f"{x.device}")
    if weight.dtype != bias.dtype or weight.numel() != d or bias.numel() != d:
        raise ValueError("weight and bias must be [D] tensors of one dtype")
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"layernorm kernel takes D <= {_MAX_D}, got {d}")
    lib = _load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.iseg_layernorm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel() // d, d, real, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[weight.dtype], cuda_lib.current_stream(x))
    cuda_lib.check(lib, err, "layernorm kernel launch")
    return y


class LayerNormKernel(torch.autograd.Function):
    """Kernel B forward, backward through the plain version: it saves
    ``x``, ``weight`` and ``bias`` and returns the VJP of :func:`_ln_plain`
    for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, real=None):
        ctx.save_for_backward(x, weight, bias)
        ctx.eps, ctx.real = eps, real
        return _ln_cuda(x, weight, bias, eps, real)

    @staticmethod
    def backward(ctx, grad):
        return (*plain_vjp(_ln_plain, ctx.saved_tensors,
                           ctx.needs_input_grad[:3], grad, ctx.eps,
                           ctx.real), None, None)


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-6, real: Optional[int] = None) -> torch.Tensor:
    """LayerNorm over the last axis with f32 fast-variance statistics (over
    its first ``real`` channels when given)."""
    if real is not None and not 1 <= real <= x.shape[-1]:
        raise ValueError(f"real={real} channels of {x.shape[-1]}")
    if real == x.shape[-1]:
        real = None
    if x.device.type == "cpu":
        return _ln_plain(x, weight, bias, eps, real)
    if x.device.type != "cuda":
        raise ValueError(f"layernorm runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad
                                    or bias.requires_grad):
        out = LayerNormKernel.apply(x, weight, bias, eps, real)
    else:
        out = _ln_cuda(x, weight, bias, eps, real)
    layernorm.launches += 1
    return out


layernorm.launches = 0
