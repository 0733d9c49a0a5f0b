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
forward's launches. Under autograd the kernel runs inside
:class:`LayerNormKernel`, the counterpart of the JAX package's
``_ln_pallas_ad``, so a click encoder trains through the frozen backbone's
LayerNorms: the forward is the kernel, and the backward is a second kernel
of the same source, the exact VJP of the function (the JAX ``custom_vjp``
takes ``jax.vjp`` of ``_ln_jnp``) in closed form, :func:`_ln_plain_bwd` its
plain version. It launches once for ``dx`` alone and twice when the weight
or bias needs a gradient; ``layernorm.backward_launches`` counts those
launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from isegprobe_torch.ops import cuda_lib

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


def _ln_plain_bwd(x: torch.Tensor, weight: torch.Tensor, grad: torch.Tensor,
                  eps: float, real: Optional[int] = None,
                  needs=(True, True, True)) -> tuple:
    """The VJP of :func:`_ln_plain` at ``grad`` in closed form, the
    backward kernel's plain version: (dx, dweight, dbias), None for an input
    whose flag in ``needs`` is off, each in its input's dtype (the bias has
    the weight's). With ``a = grad * weight`` and the sums over every
    channel, ``dx = rstd a - [k < real] (rstd / real) (Σa + rstd² (x - m) c
    Σa(x - m))``, where ``c`` is the clamp's gradient: 1 above the tie, 0
    below, 1/2 at it, as ``jax.vjp`` of ``jnp.maximum`` gives it."""
    d = x.shape[-1]
    real = d if real is None else real
    xf = x.float()
    xs = xf[..., :real]
    m = xs.mean(dim=-1, keepdim=True)
    raw = (xs * xs).mean(dim=-1, keepdim=True) - m * m
    rstd = torch.rsqrt(torch.clamp(raw, min=0.0) + eps)
    xc = xf - m
    dy = grad.float()
    dx = dw = db = None
    if needs[0]:
        c = torch.where(raw > 0, 1.0, torch.where(raw == 0, 0.5, 0.0))
        a = dy * weight.float()
        s1 = a.sum(dim=-1, keepdim=True)
        s2 = (a * xc).sum(dim=-1, keepdim=True)
        corr = rstd / real * (s1 + rstd * rstd * c * xc * s2)
        if real < d:
            corr = corr * (torch.arange(d, device=x.device) < real)
        dx = (rstd * a - corr).to(x.dtype)
    rows = dy.reshape(-1, d)
    if needs[1]:
        dw = (rows * (xc * rstd).reshape(-1, d)).sum(0).to(weight.dtype)
    if needs[2]:
        db = rows.sum(0).to(weight.dtype)
    return dx, dw, db


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("layernorm")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_layernorm.argtypes = [vp, vp, vp, vp, ci, ci, ci,
                                       ctypes.c_float, ci, ci, vp]
        lib.iseg_layernorm.restype = ci
        lib.iseg_layernorm_bwd.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci,
                                           ci, ci, ctypes.c_float, ci, ci,
                                           ci, vp]
        lib.iseg_layernorm_bwd.restype = ci
        lib.iseg_layernorm_bwd_blocks.argtypes = [ci, ci, ci, ci]
        lib.iseg_layernorm_bwd_blocks.restype = ci
        lib.iseg_layernorm_empty.argtypes = [ci, vp]
        lib.iseg_layernorm_empty.restype = ci
        _lib = lib
    return _lib


def _check(x: torch.Tensor, named) -> None:
    for name, t in named:
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"layernorm kernel takes float32 or bfloat16 "
                            f"{name}, got {t.dtype}")
        if not t.is_contiguous() or t.get_device() != x.get_device():
            raise ValueError(f"layernorm kernel needs a contiguous {name} on "
                             f"{x.device}")
    d = x.shape[-1]
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"layernorm kernel takes D <= {_MAX_D}, got {d}")


def _ln_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
             eps: float, real: Optional[int] = None) -> torch.Tensor:
    d = x.shape[-1]
    real = d if real is None else real
    _check(x, (("x", x), ("weight", weight), ("bias", bias)))
    if weight.dtype != bias.dtype or weight.numel() != d or bias.numel() != d:
        raise ValueError("weight and bias must be [D] tensors of one dtype")
    lib = _load()
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.iseg_layernorm(
            x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
            x.numel() // d, d, real, float(eps), _DTYPE_CODES[x.dtype],
            _DTYPE_CODES[weight.dtype], cuda_lib.current_stream(x))
    cuda_lib.check(lib, err, "layernorm kernel launch")
    return y


def _ln_bwd_cuda(x: torch.Tensor, weight: torch.Tensor, grad: torch.Tensor,
                 eps: float, real: Optional[int] = None,
                 needs=(True, True, True)) -> tuple:
    """Launch the backward kernel: :func:`_ln_plain_bwd`'s result, one
    launch for ``dx`` alone, two when the weight or bias needs a gradient
    (the second adds each column of the first's per-block sums in order)."""
    d = x.shape[-1]
    real = d if real is None else real
    _check(x, (("x", x), ("weight", weight), ("grad", grad)))
    if grad.dtype != x.dtype or grad.shape != x.shape:
        raise ValueError(f"grad {grad.dtype} {tuple(grad.shape)} must match "
                         f"x {x.dtype} {tuple(x.shape)}")
    if weight.numel() != d:
        raise ValueError("weight must be a [D] tensor")
    if not any(needs):
        return None, None, None
    lib = _load()
    rows = x.numel() // d
    codes = _DTYPE_CODES[x.dtype], _DTYPE_CODES[weight.dtype]
    dx = torch.empty_like(x) if needs[0] else None
    affine = needs[1] or needs[2]
    part = dw = db = None
    blocks = 0

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        if affine:
            # the kernel's grid, and scratch for its partial rows of
            # dweight and dbias
            blocks = lib.iseg_layernorm_bwd_blocks(rows, d, *codes)
            if blocks < 1:
                cuda_lib.check(lib, -blocks, "layernorm backward grid")
            part = torch.empty((2, blocks, d), dtype=torch.float32,
                               device=x.device)
            dw = torch.empty(d, dtype=weight.dtype, device=x.device)
            db = torch.empty(d, dtype=weight.dtype, device=x.device)
        err = lib.iseg_layernorm_bwd(
            x.data_ptr(), weight.data_ptr(), grad.data_ptr(), ptr(dx),
            ptr(part), ptr(dw), ptr(db), rows, d, real, float(eps), *codes,
            blocks, cuda_lib.current_stream(x))
    cuda_lib.check(lib, err, "layernorm backward kernel launch")
    layernorm.backward_launches += 2 if affine else 1
    return dx, dw if needs[1] else None, db if needs[2] else None


class LayerNormKernel(torch.autograd.Function):
    """Kernel B under autograd: the forward kernel, and the backward
    kernel on the saved ``x`` and ``weight`` for the inputs that need a
    gradient (None for the others)."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps, real=None):
        ctx.save_for_backward(x, weight)
        ctx.eps, ctx.real = eps, real
        return _ln_cuda(x, weight, bias, eps, real)

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        return (*_ln_bwd_cuda(x, weight, grad.contiguous(), ctx.eps,
                              ctx.real, ctx.needs_input_grad[:3]),
                None, None)


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
layernorm.backward_launches = 0
