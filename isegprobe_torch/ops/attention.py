"""Multi-head attention: hand-written CUDA kernels for Hopper and their
plain PyTorch versions.

* :func:`mha_qkv`, self-attention over a packed qkv tensor, counterpart of
  ``isegprobe_tpu/ops/attention.py:mha_qkv``. Its kernel A
  (``csrc/attention.cu``) replaces both Pallas TPU kernels of that entry:
  ``_mha_qkv_pallas_pairs`` (two dh=64 heads per grid step) and
  ``_mha_qkv_pallas`` (any dh, via a transpose). They compute one function
  and differ only in TPU lane layout; the CUDA kernel reads q, k and v by
  stride from the packed ``[B, N, 3C]`` tensor for any dh <= 128 and writes
  ``[B, N, C]`` directly.
* :func:`mha`, attention over separate ``[B, N, H, Dh]`` q, k and v with
  ``Nq != Nk`` allowed (LoftUp's coordinate cross-attention), counterpart of
  ``isegprobe_tpu/ops/attention.py:mha``. Its kernel D (``csrc/mha.cu``)
  replaces the Pallas TPU kernel ``_mha_pallas``.

Each kernel's source note gives its bound (``4·B·H·Nq·Nk·dh`` operations) and
design. On a CPU tensor both entries compute the plain version; on a CUDA
tensor they launch the kernel or raise. ``mha_qkv.launches`` and
``mha.launches`` count the launches.
"""

from __future__ import annotations

import ctypes

import torch

from isegprobe_torch.ops import cuda_lib

__all__ = ["mha", "mha_qkv"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
_mha_lib = None


def _mha_qkv_plain(qkv: torch.Tensor, num_heads: int,
                   scale: float) -> torch.Tensor:
    """The same function in plain PyTorch, with the JAX reference's rounding
    (``_mha_jnp``): f32 scores and softmax, probabilities cast to the input
    dtype before PV, f32 accumulation, output in the input dtype."""
    b, n, three_c = qkv.shape
    c = three_c // 3
    q, k, v = qkv.reshape(b, n, 3, num_heads, c // num_heads).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(qkv.dtype).reshape(b, n, c)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_attention_qkv.argtypes = [vp, vp, ci, ci, ci, ci,
                                           ctypes.c_float, ci, vp]
        lib.iseg_attention_qkv.restype = ci
        _lib = lib
    return _lib


def _mha_qkv_cuda(qkv: torch.Tensor, num_heads: int,
                  scale: float) -> torch.Tensor:
    b, n, three_c = qkv.shape
    c = three_c // 3
    dh = c // num_heads
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel takes float32 or bfloat16, got "
                        f"{qkv.dtype}")
    if not qkv.is_contiguous():
        raise ValueError("attention kernel needs a contiguous qkv tensor")
    if three_c != 3 * c or c != num_heads * dh or not 1 <= dh <= 128:
        raise ValueError(f"qkv last dim {three_c} does not split into 3 x "
                         f"{num_heads} heads of dh <= 128")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError(
            "the attention kernel has no backward yet; run under "
            "torch.no_grad() or on the CPU")
    lib = _load()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.iseg_attention_qkv(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, dh, float(scale),
            _DTYPE_CODES[qkv.dtype], cuda_lib.current_stream(qkv))
    cuda_lib.check(lib, err, "attention kernel launch")
    return out


def mha_qkv(qkv: torch.Tensor, num_heads: int,
            scale: float | None = None) -> torch.Tensor:
    """Self-attention over a packed ``[B, N, 3·C]`` qkv tensor -> ``[B, N, C]``
    (q, k, v at column offsets 0, C, 2C; ``num_heads`` heads of C/num_heads).
    """
    dh = qkv.shape[-1] // 3 // num_heads
    if scale is None:
        scale = dh**-0.5
    if qkv.device.type == "cpu":
        return _mha_qkv_plain(qkv, num_heads, scale)
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_qkv runs on cpu or cuda, not {qkv.device}")
    out = _mha_qkv_cuda(qkv, num_heads, scale)
    mha_qkv.launches += 1
    return out


mha_qkv.launches = 0


def _mha_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               scale: float) -> torch.Tensor:
    """The same function in plain PyTorch, with the JAX reference's rounding
    (``_mha_jnp``): f32 scores and softmax, probabilities cast to the input
    dtype before PV, f32 accumulation, output in q's dtype."""
    k, v = k.to(q.dtype), v.to(q.dtype)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype)


def _load_mha():
    global _mha_lib
    if _mha_lib is None:
        lib = cuda_lib.load("mha")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_mha.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                 ctypes.c_float, ci, vp]
        lib.iseg_mha.restype = ci
        _mha_lib = lib
    return _mha_lib


def _mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float) -> torch.Tensor:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"attention kernel D takes float32 or bfloat16, got "
                        f"{q.dtype}")
    # the reference casts k and v to q's dtype (_mha_pallas); a cast makes
    # a contiguous copy
    k, v = k.to(q.dtype), v.to(q.dtype)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4 or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"attention kernel D needs a contiguous 4-D "
                             f"{name} [B, N, H, Dh] on {q.device}")
    b, nq, heads, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (heads, dh):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if not 1 <= dh <= 128:
        raise ValueError(f"attention kernel D takes dh <= 128, got {dh}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise NotImplementedError(
            "attention kernel D has no backward yet; run under "
            "torch.no_grad() or on the CPU")
    lib = _load_mha()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = lib.iseg_mha(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), b, nq, k.shape[1], heads, dh,
                           float(scale), _DTYPE_CODES[q.dtype],
                           cuda_lib.current_stream(q))
    cuda_lib.check(lib, err, "attention kernel D launch")
    return out


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: float | None = None) -> torch.Tensor:
    """Attention over ``[B, Nq, H, Dh]`` queries and ``[B, Nk, H, Dh]`` keys
    and values -> ``[B, Nq, H, Dh]`` in q's dtype (no masking)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _mha_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cpu or cuda, not {q.device}")
    out = _mha_cuda(q, k, v, scale)
    mha.launches += 1
    return out


mha.launches = 0
