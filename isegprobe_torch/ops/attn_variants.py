"""The attention variants of the sweep: hand-written CUDA kernels for Hopper
and their plain PyTorch versions.

Counterparts of the two bodies of the Pallas TPU kernel in
``scripts/bench_attn_variants.py:run_variant``:

* :func:`mha_qkv_nodiv` (kernel F, ``_kernel_nodiv``): self-attention over a
  packed qkv that normalises the output once, after PV, instead of the
  probability panel;
* :func:`mha_qkv_merged` (kernel G, ``_kernel_merged``): the same function,
  computed by one program per head pair that reads the pair's K and V once.

Both take ``[B, N, 3·C]`` with heads of 64 and an even head count, and the
exp in float32 or (``expdt=torch.bfloat16``, bf16 inputs only) in bf16. The
kernels are instantiations of the flash core of kernels A and D
(``csrc/flash_core.cuh``) under their own names in ``csrc/attn_variants.cu``,
whose note gives their bound and design: F is A's instantiation (with an
f32 exp its output equals kernel A's bit for bit), G stages a head pair's
columns once and computes each head as F does (its output equals F's).
Each is built for query tiles of 64 and 128 rows per head
(``NODIV_TILES``, ``MERGED_TILES``). On a CPU tensor the entries compute
the plain version; on a CUDA tensor they launch the kernel or raise.
``mha_qkv_nodiv.launches`` and ``mha_qkv_merged.launches`` count the
launches.
"""

from __future__ import annotations

import ctypes

import torch

from isegprobe_torch.ops import cuda_lib

__all__ = ["MERGED_TILES", "NODIV_TILES", "mha_qkv_merged", "mha_qkv_nodiv"]

DH = 64
# query rows per block (per head) each kernel is built for, multiples of a
# wgmma warpgroup's 64; the first is the default
NODIV_TILES = (64, 128)
MERGED_TILES = (64, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (input dtype, exp dtype) pairs the kernels take
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16)}
_lib = None


def _softmax_pv(s: torch.Tensor, v: torch.Tensor, expdt: torch.dtype,
                io: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """The shared tail of both bodies: f32 scores ``s`` [..., Nq, Nk] against
    ``v`` [..., Nk, D] -> (unnormalised f32 ``e·v``, ``1/Σe`` [..., Nq, 1]),
    with e = round_expdt(exp(round_expdt(s − max s))) and e rounded to the
    input dtype before PV."""
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp((s - m).to(expdt)).to(expdt)
    ssum = e.float().sum(dim=-1, keepdim=True)
    out = torch.matmul(e.to(io).float(), v.float())
    return out, 1.0 / ssum


def _nodiv_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                 expdt: torch.dtype) -> torch.Tensor:
    """``_kernel_nodiv`` in plain PyTorch: per head, f32 scores of the
    input-dtype values, e by ``expdt``, PV in f32, then one division."""
    b, n, three_c = qkv.shape
    q, k, v = (t.permute(0, 2, 1, 3) for t in  # [B, H, N, dh]
               qkv.reshape(b, n, 3, num_heads, DH).unbind(2))
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    out, inv = _softmax_pv(s, v, expdt, qkv.dtype)
    out = (out * inv).to(qkv.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, n, three_c // 3)


def _merged_plain(qkv: torch.Tensor, num_heads: int, scale: float,
                  expdt: torch.dtype) -> torch.Tensor:
    """``_kernel_merged`` in plain PyTorch: per head pair, the block-diagonal
    query ``[[q0, 0], [0, q1]]`` [2N, 128] against the pair's packed keys in
    one 128-deep product, the shared softmax tail on [2N, N], PV against the
    pair's packed values [N, 128], and the two useful quadrants kept."""
    b, n, three_c = qkv.shape
    c = three_c // 3
    pairs = num_heads // 2
    q, k, v = (qkv[..., i * c:(i + 1) * c].reshape(b, n, pairs, 2 * DH)
               .permute(0, 2, 1, 3) for i in range(3))  # [B, P, N, 128]
    qs = torch.zeros((b, pairs, 2 * n, 2 * DH), dtype=q.dtype,
                     device=q.device)
    qs[:, :, :n, :DH] = q[..., :DH]
    qs[:, :, n:, DH:] = q[..., DH:]
    s = torch.matmul(qs.float(), k.float().transpose(-1, -2)) * scale
    out, inv = _softmax_pv(s, v, expdt, qkv.dtype)  # [B, P, 2N, 128]
    top = out[:, :, :n, :DH] * inv[:, :, :n]
    bot = out[:, :, n:, DH:] * inv[:, :, n:]
    out = torch.cat([top, bot], dim=-1).to(qkv.dtype)
    return out.permute(0, 2, 1, 3).reshape(b, n, c)


def _load():
    global _lib
    if _lib is None:
        lib = cuda_lib.load("attn_variants")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.iseg_attn_variant.argtypes = [vp, vp, ci, ci, ci, ctypes.c_float,
                                          ci, ci, ci, ci, vp]
        lib.iseg_attn_variant.restype = ci
        _lib = lib
    return _lib


def _check(qkv: torch.Tensor, num_heads: int, expdt: torch.dtype,
           q_tile: int, tiles: tuple, what: str) -> None:
    """What the function and the kernels take: raised on any device."""
    if (qkv.dtype, expdt) not in _PAIRS:
        raise TypeError(f"{what} takes float32 or bfloat16 inputs with a "
                        f"float32 exp, or bfloat16 with a bfloat16 exp; got "
                        f"{qkv.dtype} with a {expdt} exp")
    if (qkv.dim() != 3 or num_heads < 2 or num_heads % 2
            or qkv.shape[-1] != 3 * num_heads * DH):
        raise ValueError(f"{what} takes [B, N, 3·H·64] with an even H; got "
                         f"{tuple(qkv.shape)} with H = {num_heads}")
    if q_tile not in tiles:
        raise ValueError(f"{what} is built for query tiles {tiles}, not "
                         f"{q_tile}")


def _launch(qkv: torch.Tensor, num_heads: int, scale: float,
            expdt: torch.dtype, merged: bool, q_tile: int,
            what: str) -> torch.Tensor:
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError(f"{what} needs a contiguous, 16-byte aligned qkv "
                         f"tensor")
    if torch.is_grad_enabled() and qkv.requires_grad:
        raise NotImplementedError(f"{what} has no backward; run under "
                                  f"torch.no_grad() or on the CPU")
    lib = _load()
    b, n, three_c = qkv.shape
    out = torch.empty((b, n, three_c // 3), dtype=qkv.dtype,
                      device=qkv.device)
    with torch.cuda.device(qkv.device):
        err = lib.iseg_attn_variant(
            qkv.data_ptr(), out.data_ptr(), b, n, num_heads, float(scale),
            _DTYPE_CODES[qkv.dtype], int(expdt == torch.bfloat16),
            int(merged), q_tile, cuda_lib.current_stream(qkv))
    cuda_lib.check(lib, err, f"{what} launch")
    return out


def _entry(qkv, num_heads, scale, expdt, q_tile, merged):
    tiles = MERGED_TILES if merged else NODIV_TILES
    q_tile = tiles[0] if q_tile is None else q_tile
    if scale is None:
        scale = DH**-0.5
    what = f"attention kernel {'G (merged)' if merged else 'F (nodiv)'}"
    if qkv.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda, not {qkv.device}")
    _check(qkv, num_heads, expdt, q_tile, tiles, what)
    if qkv.device.type == "cpu":
        plain = _merged_plain if merged else _nodiv_plain
        return plain(qkv, num_heads, scale, expdt)
    return _launch(qkv, num_heads, scale, expdt, merged, q_tile, what)


def mha_qkv_nodiv(qkv: torch.Tensor, num_heads: int,
                  scale: float | None = None,
                  expdt: torch.dtype = torch.float32,
                  q_tile: int | None = None) -> torch.Tensor:
    """Self-attention over a packed ``[B, N, 3·C]`` qkv (heads of 64, H
    even) -> ``[B, N, C]``, normalised after PV (``_kernel_nodiv``).
    ``q_tile`` picks the kernel's query tile (``NODIV_TILES``)."""
    out = _entry(qkv, num_heads, scale, expdt, q_tile, merged=False)
    if qkv.device.type == "cuda":
        mha_qkv_nodiv.launches += 1
    return out


mha_qkv_nodiv.launches = 0


def mha_qkv_merged(qkv: torch.Tensor, num_heads: int,
                   scale: float | None = None,
                   expdt: torch.dtype = torch.float32,
                   q_tile: int | None = None) -> torch.Tensor:
    """The same function as :func:`mha_qkv_nodiv`, computed by head pairs
    (``_kernel_merged``). ``q_tile`` picks the kernel's query tile per head
    (``MERGED_TILES``)."""
    out = _entry(qkv, num_heads, scale, expdt, q_tile, merged=True)
    if qkv.device.type == "cuda":
        mha_qkv_merged.launches += 1
    return out


mha_qkv_merged.launches = 0
