"""Dynamic W8A8 int8 for the serving path: a row quantizer (kernel H,
``csrc/quant.cu``), an s8 tensor-core GEMM with a fused dequantizing
epilogue (kernel I, the same source), their plain PyTorch versions, and
:class:`QuantLinear`.

Counterpart of ``isegprobe_tpu/ops/quant.py``: the activations get one
dynamic symmetric scale a row (token), the weight one a row of its
``[N, K]`` ``nn.Linear`` layout (an output channel, the JAX kernel's
column), both quantized from the stored float params; the product
accumulates in int32 and is rescaled in f32. The rounding is XLA's:
``s = max(max|x| / 127, 1e-8)`` and ``q = round(x / s)`` with true f32
divisions, half to even, and ``y = (f32(acc) · sx) · sw`` multiplied left
to right, then ``+ bias`` in f32, then cast. Neither kernel replaces a
Pallas kernel: they are the XLA ops of the JAX ``int8_dynamic_matmul`` on
the card; the source note gives their bounds and design.

The JAX package quantizes the weight on every call. The wrappers' path
quantizes a fixed weight once and keeps its int8 rows and scales in a
cache keyed weakly on the weight tensor, checked against its version
counter, storage, dtype, device and shape, so an in-place update,
``load_state_dict``, ``.to(dtype)`` or a move re-quantizes it; the cached
values are bitwise what quantizing it again would give. The entry holds
the weight's storage, so its address cannot be handed to a new storage
(``.to(torch.bfloat16).to(torch.float32)`` with no forward between) while
the entry lives: one stale copy a weight is held until its next forward.
A write through ``weight.data`` bumps no version counter and is not seen;
update weights in place under ``torch.no_grad()`` or through
``load_state_dict``. A weight whose gradient is being
taken (``requires_grad`` with grad mode on) is never cached, and the
cache is filled outside inference mode, so rows cached under
``torch.inference_mode()`` serve a later forward under autograd. The
plain versions stay uncached: they are the reference.

On a CPU tensor :func:`quantize_rows` and :func:`int8_gemm` compute the
plain versions (the integer product in float64, exact for these sums); on
a CUDA tensor they launch the kernel or raise. ``quantize_rows.launches``
and ``int8_gemm.launches`` count the launches: a :class:`QuantLinear`
forward launches one H (its input) and one I, and one more H the first
time it sees its weight (every time, if the weight's gradient is being
taken). Under autograd (Input-BRS through the backbone)
:func:`quant_linear` runs the kernels inside :class:`QuantLinearKernel`,
whose backward is the VJP of the plain version: ``round`` and the int cast
pass no gradient, as in JAX, so the input's gradient flows through its row
scales alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import nn
from torch.utils.weak import WeakIdKeyDictionary

from isegprobe_torch.models.dtype import compute_dtype
from isegprobe_torch.ops import cuda_lib
from isegprobe_torch.ops.plain_vjp import plain_vjp

__all__ = ["QuantLinear", "QuantLinearKernel", "int8_dynamic_matmul",
           "int8_gemm", "quant_linear", "quantize_rows"]

EPS = 1e-8
QMAX = 127.0
# kernel H holds a row in registers: 96 values a lane
MAX_K = 32 * 96
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
# weight -> ((version, data_ptr, dtype, device, shape), storage, (wq, sw))
_weight_rows_cache = WeakIdKeyDictionary()


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("quant")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_quantize_rows.argtypes = [vp, vp, vp, ci, ci, ci, vp]
        lib.iseg_quantize_rows.restype = ci
        lib.iseg_int8_gemm.argtypes = [vp] * 6 + [ci] * 7 + [vp]
        lib.iseg_int8_gemm.restype = ci
        _lib = lib
    return _lib


def _quantize_rows_plain(x: torch.Tensor):
    """The plain version of kernel H: ``(q int8, s f32 [..., 1])``. ``s``
    keeps the autograd graph of ``x``; ``q`` has none."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: PyTorch multiplies by the reciprocal of a scalar one
    s = torch.clamp_min(amax / torch.full_like(amax, QMAX), EPS)
    return torch.round(xf / s).to(torch.int8), s


def _check(t: torch.Tensor, name: str, dtypes, device) -> None:
    if t.dtype not in dtypes:
        raise TypeError(f"int8 kernels take {name} of {dtypes}, got "
                        f"{t.dtype}")
    if t.device != device or not t.is_contiguous():
        raise ValueError(f"int8 kernels need a contiguous {name} on "
                         f"{device}")


def _quantize_rows_cuda(x: torch.Tensor):
    k = x.shape[-1]
    _check(x, "x", tuple(_DTYPE_CODES), x.device)
    if not 1 <= k <= MAX_K:
        raise ValueError(f"row quantizer takes 1 <= K <= {MAX_K}, got {k}")
    lib = _load()
    rows = x.numel() // k
    q = torch.empty(x.shape, dtype=torch.int8, device=x.device)
    s = torch.empty((*x.shape[:-1], 1), dtype=torch.float32,
                    device=x.device)
    with torch.cuda.device(x.device):
        err = lib.iseg_quantize_rows(x.data_ptr(), q.data_ptr(),
                                     s.data_ptr(), rows, k,
                                     _DTYPE_CODES[x.dtype],
                                     cuda_lib.current_stream(x))
    cuda_lib.check(lib, err, "row quantizer launch")
    return q, s


def quantize_rows(x: torch.Tensor):
    """Symmetric int8 quantization of each row of ``x`` ``[..., K]``
    (float32 or bfloat16) -> ``(q int8 [..., K], s float32 [..., 1])``
    with ``x ≈ q · s``."""
    if x.device.type == "cpu":
        return _quantize_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows runs on cpu or cuda, not {x.device}")
    out = _quantize_rows_cuda(x.contiguous())
    quantize_rows.launches += 1
    return out


quantize_rows.launches = 0


def _int_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """``xq [M, K] @ wq [N, K].T`` of int8 values, as float32: the sum is
    taken in float64, where every partial sum of these products is an
    exact integer (|sum| <= 127² · K < 2^53), so it is the int32 sum,
    rounded once to float32 as ``acc.astype(float32)`` rounds it."""
    return (xq.double() @ wq.double().T).float()


def _epilogue_plain(acc, sx, sw, bias, out_dtype, bias_after_cast):
    y = acc * sx * sw.reshape(1, -1)
    if bias is not None and not bias_after_cast:
        y = y + bias.float()
    y = y.to(out_dtype)
    if bias is not None and bias_after_cast:
        y = y + bias.to(out_dtype)
    return y


def _int8_gemm_plain(xq, wq, sx, sw, bias=None, out_dtype=torch.float32,
                     bias_after_cast=False):
    """The plain version of kernel I."""
    return _epilogue_plain(_int_matmul_plain(xq, wq), sx.reshape(-1, 1),
                           sw.reshape(-1), bias, out_dtype, bias_after_cast)


def _int8_gemm_cuda(xq, wq, sx, sw, bias, out_dtype, bias_after_cast):
    dev = xq.device
    (m, k), n = xq.shape, wq.shape[0]
    _check(xq, "xq", (torch.int8,), dev)
    _check(wq, "wq", (torch.int8,), dev)
    _check(sx, "sx", (torch.float32,), dev)
    _check(sw, "sw", (torch.float32,), dev)
    if wq.shape[1] != k or sx.numel() != m or sw.numel() != n:
        raise ValueError(f"int8 GEMM shapes disagree: xq {tuple(xq.shape)}, "
                         f"wq {tuple(wq.shape)}, sx {sx.numel()}, "
                         f"sw {sw.numel()}")
    if k % 32 or n % 8:
        raise ValueError(f"int8 GEMM takes K % 32 == 0 and N % 8 == 0, got "
                         f"K={k}, N={n}")
    if xq.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8 GEMM needs 16-byte aligned operands")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"int8 GEMM writes float32 or bfloat16, not "
                        f"{out_dtype}")
    if bias is not None:
        _check(bias, "bias", tuple(_DTYPE_CODES), dev)
        if bias.numel() != n:
            raise ValueError(f"bias of {bias.numel()} for N={n}")
    lib = _load()
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        err = lib.iseg_int8_gemm(
            xq.data_ptr(), wq.data_ptr(), sx.data_ptr(), sw.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), m, n,
            k, _DTYPE_CODES[out_dtype],
            _DTYPE_CODES[torch.float32 if bias is None else bias.dtype],
            int(bias is not None), int(bias_after_cast),
            cuda_lib.current_stream(xq))
    cuda_lib.check(lib, err, "int8 GEMM launch")
    return out


def int8_gemm(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
              sw: torch.Tensor, bias: Optional[torch.Tensor] = None,
              out_dtype: torch.dtype = torch.float32,
              bias_after_cast: bool = False) -> torch.Tensor:
    """``(f32(xq @ wq.T) · sx) · sw (+ bias)`` in ``out_dtype``: ``xq``
    ``[M, K]`` and ``wq`` ``[N, K]`` int8, ``sx`` ``[M]`` (or ``[M, 1]``)
    and ``sw`` ``[N]`` float32 scales, ``bias`` ``[N]`` added in f32 before
    the cast, or with ``bias_after_cast`` after it, in ``out_dtype``.
    Returns ``[M, N]``."""
    if xq.device.type == "cpu":
        return _int8_gemm_plain(xq, wq, sx, sw, bias, out_dtype,
                                bias_after_cast)
    if xq.device.type != "cuda":
        raise ValueError(f"int8_gemm runs on cpu or cuda, not {xq.device}")
    out = _int8_gemm_cuda(xq, wq, sx, sw, bias, out_dtype, bias_after_cast)
    int8_gemm.launches += 1
    return out


int8_gemm.launches = 0


def _weight_rows(weight: torch.Tensor, cache: bool = True):
    """``quantize_rows(weight)``, kept for a fixed weight: the first call
    quantizes (kernel H on the card) and caches the rows and scales; later
    calls return them while ``weight`` has the same version, storage,
    dtype, device and shape. ``cache=False`` (or an inference tensor,
    which keeps no version) always quantizes."""
    if not cache or weight.is_inference():
        return quantize_rows(weight)
    key = (weight._version, weight.data_ptr(), weight.dtype, weight.device,
           tuple(weight.shape))
    storage = weight.untyped_storage()
    hit = _weight_rows_cache.get(weight)
    # the entry keeps its storage alive, so an equal address is that storage
    if (hit is not None and hit[0] == key
            and hit[1].data_ptr() == storage.data_ptr()):
        return hit[2]
    # normal tensors, so that rows cached under inference mode can meet
    # autograd later
    with torch.inference_mode(False), torch.no_grad():
        wq, sw = quantize_rows(weight)
    _weight_rows_cache[weight] = (key, storage, (wq, sw))
    return wq, sw


def _quant_linear(quantize, quantize_weight, gemm, x, weight, bias,
                  out_dtype, bias_after_cast):
    """:func:`quant_linear` through ``quantize`` (the input),
    ``quantize_weight`` and ``gemm``: the wrappers (kernels H and I, their
    plain versions on the CPU; the weight's rows cached) or the plain
    versions on any device."""
    k = x.shape[-1]
    xq, sx = quantize(x.reshape(-1, k))
    wq, sw = quantize_weight(weight)
    y = gemm(xq, wq, sx, sw, bias, out_dtype, bias_after_cast)
    return y.reshape(*x.shape[:-1], weight.shape[0])


def _quant_linear_plain(x, weight, bias, out_dtype, bias_after_cast):
    """The plain version of :func:`quant_linear` on any device,
    differentiable in ``x`` through its row scales (``round`` and the int
    cast pass none)."""
    return _quant_linear(_quantize_rows_plain, _quantize_rows_plain,
                         _int8_gemm_plain, x, weight, bias, out_dtype,
                         bias_after_cast)


class QuantLinearKernel(torch.autograd.Function):
    """Kernels H and I forward, backward through the plain version: it
    saves ``x``, ``weight`` and ``bias`` and returns the VJP of
    :func:`_quant_linear_plain` for the inputs that need a gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, out_dtype, bias_after_cast):
        ctx.save_for_backward(x, weight, bias)
        ctx.out_dtype, ctx.bias_after_cast = out_dtype, bias_after_cast
        return _quant_linear(
            quantize_rows,
            lambda w: _weight_rows(w, cache=not w.requires_grad), int8_gemm,
            x, weight, bias, out_dtype, bias_after_cast)

    @staticmethod
    def backward(ctx, grad):
        x, weight, bias = ctx.saved_tensors
        args = (ctx.out_dtype, ctx.bias_after_cast)
        if bias is None:
            return (*plain_vjp(_quant_linear_plain, (x, weight),
                               ctx.needs_input_grad[:2], grad, None, *args),
                    None, None, None)
        return (*plain_vjp(_quant_linear_plain, (x, weight, bias),
                           ctx.needs_input_grad[:3], grad, *args), None, None)


def quant_linear(x: torch.Tensor, weight: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 out_dtype: torch.dtype = torch.float32,
                 bias_after_cast: bool = False) -> torch.Tensor:
    """``x [..., K]`` times the ``[N, K]`` ``weight`` in dynamic W8A8, with
    the bias of :func:`int8_gemm`, in ``out_dtype``: ``[..., N]``."""
    if x.device.type == "cuda" and torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, weight, bias)):
        return QuantLinearKernel.apply(x, weight, bias, out_dtype,
                                       bias_after_cast)
    cache = not (torch.is_grad_enabled() and weight.requires_grad)
    return _quant_linear(quantize_rows,
                         lambda w: _weight_rows(w, cache=cache), int8_gemm,
                         x, weight, bias, out_dtype, bias_after_cast)


def int8_dynamic_matmul(x: torch.Tensor, weight: torch.Tensor
                        ) -> torch.Tensor:
    """``x @ weight.T`` in dynamic W8A8: ``x`` ``[..., K]`` (float32 or
    bfloat16), ``weight`` ``[N, K]``. Returns float32 ``[..., N]`` (the JAX
    ``int8_dynamic_matmul(x, weight.T)``)."""
    return quant_linear(x, weight)


class QuantLinear(nn.Linear):
    """``nn.Linear`` in dynamic W8A8, the counterpart of the JAX
    ``QuantDense``: the same ``weight`` ``[N, K]`` and ``bias`` ``[N]`` as
    ``models/dtype.py:Linear`` (so ``load_jax_params`` and
    ``.to(torch.bfloat16)`` work unchanged), the input quantized as it
    comes (no cast first), ``(acc·sx)·sw + bias`` in f32, then cast to
    ``out_dtype`` (None: the compute dtype, ``QuantDense(dtype=...)``;
    MaskCLIP's layers keep ``QuantDense``'s default, bfloat16)."""

    def __init__(self, in_features: int, out_features: int,
                 bias: bool = True,
                 out_dtype: Optional[torch.dtype] = None) -> None:
        super().__init__(in_features, out_features, bias)
        self.out_dtype = out_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.out_dtype or compute_dtype(self, self.weight)
        return quant_linear(x, self.weight, self.bias, dt)
