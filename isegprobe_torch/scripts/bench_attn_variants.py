"""Attention-variant sweep: kernel A (``pairs``) beside kernels F (``nodiv``)
and G (``merged``) at each query tile they are built for, in float32 and
bfloat16, and in bf16 also with the exp taken in bf16 (``_ebf16``).

    python -m isegprobe_torch.scripts.bench_attn_variants [--device cpu]

Counterpart of ``scripts/bench_attn_variants.py:main``, at its shape by
default: a packed qkv ``[16, 1025, 3·384]``, 6 heads of 64, drawn from a
seed with an explicit ``torch.Generator``. Each variant is first checked
against the plain f32 reference (``_mha_qkv_plain`` on the f32 input) and
its ``max|err|`` printed; then, on the card, it is timed with CUDA events
around replays of a CUDA graph of ``REPS`` calls (median of ``ROUNDS``).
On the CPU the plain versions run and nothing is timed. Prints one line per
variant and returns the records.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.ops import attention, attn_variants

# the JAX sweep's shape: the device loop's batch of 16 crops at 448², one
# layer's packed qkv, 6 heads of 64
BATCH, N, HEADS = 16, 1025, 6
WARMUP, REPS, ROUNDS = 3, 20, 5
# wrapper calls a variant makes on the card: its check, the warm-up and the
# graph capture (replays call no wrapper)
LAUNCHES_PER_VARIANT = 1 + WARMUP + REPS
# max |variant - f32 reference| <= ATOL + RTOL |reference|. f32 differs in
# summation order only. bf16 inputs are the f32 inputs rounded (2^-9
# relative) and e is rounded to bf16 before PV; errors of ~5e-3 are typical
# at the default shape.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
WRAPPERS = {"mha_qkv": attention.mha_qkv,
            "mha_qkv_nodiv": attn_variants.mha_qkv_nodiv,
            "mha_qkv_merged": attn_variants.mha_qkv_merged}


def variants(heads: int, scale: float, dtype: torch.dtype) -> list:
    """(name, kernel, fn) for each variant of the sweep at ``dtype``."""
    out = [("pairs", "mha_qkv",
            lambda t: attention.mha_qkv(t, heads, scale))]
    exps = [("", torch.float32)]
    if dtype == torch.bfloat16:
        exps.append(("_ebf16", torch.bfloat16))
    for suffix, expdt in exps:
        for kind, kernel, tiles in (
                ("nodiv", "mha_qkv_nodiv", attn_variants.NODIV_TILES),
                ("merged", "mha_qkv_merged", attn_variants.MERGED_TILES)):
            for tile in tiles:
                fn = (lambda t, w=WRAPPERS[kernel], tile=tile, expdt=expdt:
                      w(t, heads, scale, expdt=expdt, q_tile=tile))
                out.append((f"{kind}{tile}{suffix}", kernel, fn))
    return out


def time_graph(fn, qkv: torch.Tensor) -> float:
    """Median device ms per call of ``fn(qkv)``: ``REPS`` calls captured in
    one CUDA graph, replayed between CUDA events ``ROUNDS`` times."""
    for _ in range(WARMUP):
        fn(qkv)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn(qkv)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / REPS)
    return float(np.median(times))


def main(device=None, batch: int = BATCH, n: int = N,
         heads: int = HEADS) -> list[dict]:
    """Check and time every variant; returns one record per variant. The
    shape arguments serve tests at a tiny shape."""
    device = resolve_device(device)
    c = heads * attn_variants.DH
    scale = attn_variants.DH**-0.5
    g = torch.Generator(device=device).manual_seed(0)
    qkv32 = torch.randn((batch, n, 3 * c), generator=g, device=device)
    records = []
    with torch.no_grad():
        ref = attention._mha_qkv_plain(qkv32, heads, scale)
        for dtype in ("float32", "bfloat16"):
            qkv = qkv32.to(getattr(torch, dtype))
            rtol, atol = TOL[dtype]
            for name, kernel, fn in variants(heads, scale, qkv.dtype):
                before = WRAPPERS[kernel].launches
                got = fn(qkv).float()
                err = (got - ref).abs()
                rec = {"dtype": dtype, "variant": name, "kernel": kernel,
                       "shape": [batch, n, 3 * c], "heads": heads,
                       "max_abs_err": float(err.max()),
                       "ok": bool((err <= atol + rtol * ref.abs()).all())
                       and bool(torch.isfinite(got).all()),
                       "ms": (time_graph(fn, qkv) if device.type == "cuda"
                              else None)}
                rec["launches"] = WRAPPERS[kernel].launches - before
                ms = "not measured" if rec["ms"] is None else (
                    f"{rec['ms']:.4f} ms/call")
                print(f"{dtype} {name:16s}: {ms}  max|err| vs f32 plain = "
                      f"{rec['max_abs_err']:.2e}"
                      f"{'' if rec['ok'] else '  OUT OF TOLERANCE'}")
                records.append(rec)
    return records


def _cli() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", help="cuda (default) or cpu")
    records = main(parser.parse_args().device)
    return 0 if all(r["ok"] for r in records) else 1


if __name__ == "__main__":
    sys.exit(_cli())
