"""The fused 7×7 joint bilateral filter of a JBU stage: a hand-written CUDA
kernel for Hopper (``csrc/jbu.cu``, kernel E) and its plain PyTorch version.

Counterpart of ``isegprobe_tpu/ops/jbu_kernel.py``; the kernel replaces the
Pallas TPU kernel ``jbu_filter_pallas``, the plain version follows
``jbu_filter_xla``: reflect padding, a 49-tap softmax of
``clip(exp(temp), 1e-4, 1e4)·⟨key(x), key(x+p)⟩``, times the spatial
Gaussian of ``sigma`` on ``linspace(-1, 1, 7)²``, normalised with a 1e-7
clamp, applied to ``hr``. Both compute in float32 and return hr's dtype.

The two normalisers differ where a clamp binds: the kernel (like the Pallas
kernel) clamps ``Σ exp(s − m)·spatial``, the plain version (like the XLA
form) ``Σ softmax·spatial``. Both sums are at least the smallest spatial
weight, ``exp(-1/σ²)`` (the first has a term ``exp(0)·spatial``, the
second is a convex combination of the spatial weights), so neither clamp
binds for σ above 0.25, and the two agree (σ = 0.8 and 1.0 in the tests).

On a CPU tensor :func:`jbu_filter` computes the plain version; on a CUDA
tensor it launches the kernel or raises. ``jbu_filter.launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from isegprobe_torch.ops import cuda_lib
from isegprobe_torch.ops.grid import linspace

__all__ = ["jbu_filter"]

RADIUS = 3
DIAM = 2 * RADIUS + 1
NTAP = DIAM * DIAM  # 49

_lib = None


def _coefficients(temp, sigma, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(clipped temperature [], spatial Gaussian [49]) in float32, computed
    on ``device`` from scalar tensors or numbers (no host read)."""
    temp = torch.as_tensor(temp, dtype=torch.float32, device=device)
    sigma = torch.as_tensor(sigma, dtype=torch.float32, device=device)
    temp_c = torch.clamp(torch.exp(temp), 1e-4, 1e4)
    g = linspace(-1.0, 1.0, DIAM, device=device)
    yy, xx = torch.meshgrid(g, g, indexing="ij")
    spatial = torch.exp(-(yy**2 + xx**2) / (2.0 * sigma**2)).reshape(NTAP)
    return temp_c.reshape(()), spatial


def _reflect_pad(x: torch.Tensor) -> torch.Tensor:
    """Reflect-pad the spatial dims of ``[B, H, W, C]`` by RADIUS."""
    x = F.pad(x.permute(0, 3, 1, 2), (RADIUS,) * 4, mode="reflect")
    return x.permute(0, 2, 3, 1)


def _jbu_plain(hr: torch.Tensor, proj: torch.Tensor, temp,
               sigma) -> torch.Tensor:
    """The same function in plain PyTorch, in the form of the JAX package's
    ``jbu_filter_xla``."""
    b, h, w, _ = hr.shape
    hr32, proj32 = hr.float(), proj.float()
    proj_pad = _reflect_pad(proj32)
    sims = torch.stack([
        (proj32 * proj_pad[:, p // DIAM:p // DIAM + h,
                           p % DIAM:p % DIAM + w]).sum(-1)
        for p in range(NTAP)], dim=-1)
    temp_c, spatial = _coefficients(temp, sigma, hr.device)
    kernel = torch.softmax(temp_c * sims, dim=-1) * spatial
    kernel = kernel / torch.clamp(kernel.sum(-1, keepdim=True), min=1e-7)
    hr_pad = _reflect_pad(hr32)
    out = torch.zeros_like(hr32)
    for p in range(NTAP):
        out.addcmul_(kernel[..., p:p + 1],
                     hr_pad[:, p // DIAM:p // DIAM + h, p % DIAM:p % DIAM + w])
    return out.to(hr.dtype)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("jbu")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_jbu.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, vp]
        lib.iseg_jbu.restype = ci
        _lib = lib
    return _lib


def _jbu_cuda(hr: torch.Tensor, proj: torch.Tensor, temp,
              sigma) -> torch.Tensor:
    for name, t in (("hr", hr), ("proj", proj)):
        if t.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"JBU kernel E takes float32 or bfloat16 {name}, "
                            f"got {t.dtype}")
        if t.dim() != 4 or t.device != hr.device:
            raise ValueError(f"JBU kernel E needs a 4-D {name} [B, H, W, C] "
                             f"on {hr.device}")
    b, h, w, c = hr.shape
    if proj.shape[:3] != hr.shape[:3]:
        raise ValueError(f"proj {tuple(proj.shape)} does not match hr "
                         f"{tuple(hr.shape)}")
    if h < 4 or w < 4:
        raise ValueError(f"reflect padding by {RADIUS} needs H, W >= 4, got "
                         f"{h}x{w}")
    if torch.is_grad_enabled() and (hr.requires_grad or proj.requires_grad):
        raise NotImplementedError(
            "JBU kernel E has no backward yet; run under torch.no_grad() or "
            "on the CPU")
    hr32 = hr.float().contiguous()
    proj32 = proj.float().contiguous()
    temp_c, spatial = _coefficients(temp, sigma, hr.device)
    coef = torch.cat([temp_c.reshape(1), spatial])
    out = torch.empty_like(hr32)
    lib = _load()
    with torch.cuda.device(hr.device):
        err = lib.iseg_jbu(hr32.data_ptr(), proj32.data_ptr(),
                           coef.data_ptr(), out.data_ptr(), b, h, w, c,
                           proj.shape[3], cuda_lib.current_stream(hr))
    cuda_lib.check(lib, err, "JBU kernel E launch")
    return out.to(hr.dtype)


def jbu_filter(hr: torch.Tensor, proj: torch.Tensor, temp,
               sigma) -> torch.Tensor:
    """Fused JBU filtering of ``hr [B, H, W, C]`` (bicubically pre-upsampled
    source features) by range keys ``proj [B, H, W, K]``, with the learned
    log-temperature ``temp`` and spatial ``sigma`` (scalars) ->
    ``[B, H, W, C]`` in hr's dtype."""
    if hr.device.type == "cpu":
        return _jbu_plain(hr, proj, temp, sigma)
    if hr.device.type != "cuda":
        raise ValueError(f"jbu_filter runs on cpu or cuda, not {hr.device}")
    out = _jbu_cuda(hr, proj, temp, sigma)
    jbu_filter.launches += 1
    return out


jbu_filter.launches = 0
