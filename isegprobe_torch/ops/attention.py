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

Both kernels run on one flash core (``csrc/flash_core.cuh``, whose note
gives the bound and design): bf16 on tensor cores over an asynchronous K/V
ring, f32 on register-tiled CUDA-core FMAs. :func:`_plan` picks the query
tile and the load path from the shape. On a CPU tensor both entries compute
the plain version; on a CUDA tensor they launch the kernel or raise.
``mha_qkv.launches`` and ``mha.launches`` count the launches. Under autograd
kernel A runs inside :class:`AttentionKernel`, the counterpart of the JAX
package's ``_mha_qkv_pallas_ad``: kernel forward, backward through the
plain version (the JAX ``custom_vjp`` recomputes ``_mha_qkv_jnp``). Kernel
D runs likewise inside :class:`MhaKernel`, the counterpart of
``_mha_pallas_ad`` (LoftUp training: the gradient reaches the click
encoder through the frozen upsampler's cross-attention).

``mha_qkv(..., key_mask=...)`` is the adaptive canvas's self-attention:
keys outside each lane's valid tokens are left out of every softmax. The
JAX package always runs it as its jnp computation (``_mha_qkv_jnp``),
never through a Pallas kernel, so it is plain PyTorch here on every device
and launches nothing that is counted. Kernel A masks a suffix of keys
(``n_valid``), while the canvas's valid tokens form a row-major rectangle;
a key mask for A is ROADMAP Queue 2.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from isegprobe_torch.ops import cuda_lib
from isegprobe_torch.ops.plain_vjp import plain_vjp

__all__ = ["AttentionKernel", "MhaKernel", "mha", "mha_qkv"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# streaming multiprocessors of the plan made without a card (an H100 SXM's)
SMS = 132
Q_TILES = (64, 128)
_lib = None
_mha_lib = None


@functools.lru_cache(maxsize=None)
def _cuda_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(device=None) -> int:
    """The streaming multiprocessors of ``device``: read from the card for
    a CUDA device (once per device), :data:`SMS` for the CPU or none."""
    device = torch.device("cpu") if device is None else torch.device(device)
    if device.type != "cuda":
        return SMS
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return _cuda_sms(index)


def _plan(b: int, n: int, heads: int, dh: int, dtype: torch.dtype,
          device=None) -> tuple[int, bool]:
    """The kernel's query tile and load path for ``b`` x ``heads`` heads of
    ``n`` query rows of ``dh`` on ``device`` -> ``(q_tile, aligned)``.

    A 128-row tile reads each head's K and V half as often as a 64-row one
    but gives half the blocks: it is taken only where the grid then holds at
    least two blocks per SM of the device (:func:`sm_count`; at [2, 1025,
    1152] it would give 108 blocks for an H100's 132 SMs; 64 rows give
    204). In f32 with dh <= 64 the 64-row tile is kept throughout: there
    the 128-row one was the slower on the H100 (A at [16, 1025, 1152]:
    0.970 against 0.920 ms), while at dh = 101 it was the faster (D at
    LoftUp's [8, 28672, 4, 101]: 12.99 against 15.85 ms).
    ``aligned``: a row of dh values is a whole number of 16-byte chunks (dh
    % 8 == 0 in bf16, % 4 in f32), so the 16-byte load path can take it;
    the wrapper also checks its pointers."""
    blocks = -(-n // 128) * heads * b
    big = blocks >= 2 * sm_count(device) and (dtype == torch.bfloat16
                                               or dh > 64)
    return (128 if big else 64), dh % _vec(dtype) == 0


def _vec(dtype: torch.dtype) -> int:
    """Elements of ``dtype`` in 16 bytes."""
    return 16 // dtype.itemsize


def _kv_width(dh: int, dtype: torch.dtype) -> int:
    """The row width of kernel D's K/V scratch: dh rounded up to whole
    32-byte sectors (LoftUp's 101: 112 in bf16, 104 in f32), so that every
    row starts on a sector; the kernel reads whole 16-byte chunks of it."""
    return -(-dh // (2 * _vec(dtype))) * 2 * _vec(dtype)


def _launch_plan(plan, b: int, n: int, heads: int, dh: int,
                 dtype: torch.dtype, device, ptrs,
                 what: str) -> tuple[int, bool]:
    """``plan`` if given and takeable, else :func:`_plan`'s, on the
    16-byte path only where every pointer in ``ptrs`` is 16-byte aligned."""
    if plan is None:
        q_tile, aligned = _plan(b, n, heads, dh, dtype, device)
        return q_tile, aligned and not any(p % 16 for p in ptrs)
    q_tile, aligned = plan
    if q_tile not in Q_TILES:
        raise ValueError(f"{what} is built for query tiles {Q_TILES}, not "
                         f"{q_tile}")
    if aligned and (dh % _vec(dtype) or any(p % 16 for p in ptrs)):
        raise ValueError(f"{what}: the 16-byte path takes rows of whole "
                         f"16-byte chunks and 16-byte aligned tensors")
    return q_tile, aligned


def _mha_qkv_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                   key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """The same function in plain PyTorch, with the JAX reference's rounding
    (``_mha_jnp``): f32 scores and softmax, probabilities cast to the input
    dtype before PV, f32 accumulation, output in the input dtype. Keys with
    ``key_mask`` ``[B, N]`` false get a -1e30 bias in the softmax."""
    b, n, three_c = qkv.shape
    c = three_c // 3
    q, k, v = qkv.reshape(b, n, 3, num_heads, c // num_heads).unbind(2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if key_mask is not None:
        s = s + torch.where(key_mask.bool(), 0.0, -1e30)[:, None, None, :]
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(qkv.dtype).reshape(b, n, c)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("attention")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_attention_qkv.argtypes = [vp, vp, ci, ci, ci, ci,
                                           ctypes.c_float, ci, ci, ci, vp]
        lib.iseg_attention_qkv.restype = ci
        _lib = lib
    return _lib


def _mha_qkv_cuda(qkv: torch.Tensor, num_heads: int, scale: float,
                  plan) -> torch.Tensor:
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
    lib = _load()
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    q_tile, aligned = _launch_plan(plan, b, n, num_heads, dh, qkv.dtype,
                                   qkv.device,
                                   (qkv.data_ptr(), out.data_ptr()),
                                   "attention kernel")
    with torch.cuda.device(qkv.device):
        err = lib.iseg_attention_qkv(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, dh, float(scale),
            _DTYPE_CODES[qkv.dtype], q_tile, int(aligned),
            cuda_lib.current_stream(qkv))
    cuda_lib.check(lib, err, "attention kernel launch")
    return out


class AttentionKernel(torch.autograd.Function):
    """Kernel A forward, backward through the plain version (the JAX
    package's ``_mha_qkv_pallas_ad``): it saves ``qkv`` and returns the VJP
    of :func:`_mha_qkv_plain`."""

    @staticmethod
    def forward(ctx, qkv, num_heads, scale, plan):
        ctx.save_for_backward(qkv)
        ctx.num_heads, ctx.scale = num_heads, scale
        return _mha_qkv_cuda(qkv, num_heads, scale, plan)

    @staticmethod
    def backward(ctx, grad):
        return (*plain_vjp(_mha_qkv_plain, ctx.saved_tensors,
                           ctx.needs_input_grad[:1], grad, ctx.num_heads,
                           ctx.scale), None, None, None)


def mha_qkv(qkv: torch.Tensor, num_heads: int, scale: float | None = None,
            plan: tuple[int, bool] | None = None,
            key_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Self-attention over a packed ``[B, N, 3·C]`` qkv tensor -> ``[B, N, C]``
    (q, k, v at column offsets 0, C, 2C; ``num_heads`` heads of C/num_heads).
    ``plan`` = ``(q_tile, aligned)`` overrides :func:`_plan` on the card
    (both tiles and both load paths are checked that way). ``key_mask``
    ``[B, N]`` (keys to keep) takes the plain masked path on every device."""
    dh = qkv.shape[-1] // 3 // num_heads
    if scale is None:
        scale = dh**-0.5
    if qkv.device.type == "cpu" or key_mask is not None:
        return _mha_qkv_plain(qkv, num_heads, scale, key_mask)
    if qkv.device.type != "cuda":
        raise ValueError(f"mha_qkv runs on cpu or cuda, not {qkv.device}")
    if torch.is_grad_enabled() and qkv.requires_grad:
        out = AttentionKernel.apply(qkv, num_heads, scale, plan)
    else:
        out = _mha_qkv_cuda(qkv, num_heads, scale, plan)
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


def _relayout_kv(k: torch.Tensor, v: torch.Tensor,
                 width: int) -> torch.Tensor:
    """K and V ``[B, Nk, H, dh]`` -> one head-major scratch ``[2, B, H, Nk,
    width]`` (k, then v), zero beyond dh: rows that 16-byte copies can read
    whatever dh is."""
    b, nk, heads, dh = k.shape
    kv = torch.empty((2, b, heads, nk, width), dtype=k.dtype,
                     device=k.device)
    kv[0, ..., :dh].copy_(k.transpose(1, 2))
    kv[1, ..., :dh].copy_(v.transpose(1, 2))
    kv[..., dh:].zero_()
    return kv


def _load_mha():
    global _mha_lib
    if _mha_lib is None:
        lib = cuda_lib.load("mha")
        vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.iseg_mha.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, cl, cl,
                                 cl, ctypes.c_float, ci, ci, ci, vp]
        lib.iseg_mha.restype = ci
        _mha_lib = lib
    return _mha_lib


def _mha_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, plan) -> torch.Tensor:
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
    nk = k.shape[1]
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (heads, dh):
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match")
    if not 1 <= dh <= 128:
        raise ValueError(f"attention kernel D takes dh <= 128, got {dh}")
    lib = _load_mha()
    out = torch.empty_like(q)
    q_tile, aligned = _launch_plan(plan, b, nq, heads, dh, q.dtype, q.device,
                                   (q.data_ptr(), out.data_ptr()),
                                   "attention kernel D")
    width = _kv_width(dh, q.dtype)
    kv = _relayout_kv(k, v, width)
    with torch.cuda.device(q.device):
        err = lib.iseg_mha(q.data_ptr(), kv[0].data_ptr(), kv[1].data_ptr(),
                           out.data_ptr(), b, nq, nk, heads, dh,
                           heads * nk * width, nk * width, width,
                           float(scale), _DTYPE_CODES[q.dtype], q_tile,
                           int(aligned), cuda_lib.current_stream(q))
    cuda_lib.check(lib, err, "attention kernel D launch")
    return out


class MhaKernel(torch.autograd.Function):
    """Kernel D forward, backward through the plain version (the JAX
    package's ``_mha_pallas_ad``): it saves q, k and v and returns the VJP
    of :func:`_mha_plain` for each that needs a gradient, in the dtype the
    caller passed (the plain version's casts of k and v to q's dtype
    differentiate back)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, plan):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return _mha_cuda(q, k, v, scale, plan)

    @staticmethod
    def backward(ctx, grad):
        return (*plain_vjp(_mha_plain, ctx.saved_tensors,
                           ctx.needs_input_grad[:3], grad, ctx.scale),
                None, None)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        scale: float | None = None,
        plan: tuple[int, bool] | None = None) -> torch.Tensor:
    """Attention over ``[B, Nq, H, Dh]`` queries and ``[B, Nk, H, Dh]`` keys
    and values -> ``[B, Nq, H, Dh]`` in q's dtype (no masking). ``plan`` =
    ``(q_tile, aligned)`` overrides :func:`_plan` on the card."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return _mha_plain(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"mha runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        out = MhaKernel.apply(q, k, v, scale, plan)
    else:
        out = _mha_cuda(q, k, v, scale, plan)
    mha.launches += 1
    return out


mha.launches = 0
