"""Kernels H and I (``csrc/quant.cu``) on their own, at the shapes of the
int8 serving path.

    python -m isegprobe_torch.scripts.bench_int8 [--label NAME] [--device cpu]

The shapes are those of ``chip_smoke.py``'s int8 phase: H on the
flagship's activation rows ``[16400, 384]``, ``[16400, 1536]`` (a 448²
forward at batch 8 with flip) and ``[2050, 384]`` (a host click) in bf16
and f32, and on its weights ``[1152, 384]``, ``[1536, 384]``,
``[384, 1536]`` in bf16; I at the flagship's four products (qkv 384→1152,
proj 384→384, fc1 384→1536, fc2 1536→384) at M = 16400 and 2050,
MaskCLIP's four at M = 2·785 (its packed ``in_proj`` 768→2304 with the
bias after the cast), writing bf16, and one f32 output. I's operands are
H's rows of drawn bf16 activations and weights, the weight's taken as the
serving path takes them (``ops/quant.py:_weight_rows``: quantized once).

Each output is checked bit for bit against the plain version. On the card
each call is timed as ``bench_attn_variants.time_graph`` times: CUDA
events around replays of a CUDA graph of 20 calls, median of 5. The record
also holds each case's bound (the larger of its bytes at 3.35 TB/s, each
input read once and the output written once, and its operations at the
int8 or f32 peak), bf16 ``F.linear`` of the same product (a yardstick the
port never calls), I's ptxas entries and the library's C7515 lines when
this call built it, the host µs of one call of I's wrapper at M = 2050
(Python, ctypes, the tensor maps' encoding and the launch: the batch-2
forward is host-bound), and the host µs to encode one tensor map as I's
launch encodes each of its three (libcuda's ``cuTensorMapEncodeTiled``
through ctypes) beside a ctypes call that does nothing
(``iseg_error_string``).

Prints one line, ``bench_int8 {json}``. To compare two versions of
``csrc/quant.cu``, run it from the roots of two checkouts in one call to
the card (``PYTHONPATH=. python <this checkout>/isegprobe_torch/scripts/
bench_int8.py --label X`` from the other), in the order A B B A, since the
card's clocks move between calls; the other checkout must have
``quant._weight_rows``. On the CPU the plain versions run at a
tiny size and nothing is timed.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
import time

import torch
import torch.nn.functional as F

from isegprobe_torch import resolve_device
from isegprobe_torch.ops import cuda_lib, quant
from isegprobe_torch.scripts.bench_attn_variants import time_graph

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory
PEAK_OPS_PER_S = {"int8": 1979e12, "float32": 67e12}
FWD, HOST, CLIP = 16400, 2050, 2 * 785
# H: ((rows, K), x dtype, what)
H_CASES = tuple(((r, k), dt, "activations") for dt in ("bfloat16", "float32")
                for r, k in ((FWD, 384), (FWD, 1536), (HOST, 384))) + tuple(
    ((n, k), "bfloat16", "weight")
    for n, k in ((1152, 384), (1536, 384), (384, 1536)))
FLAGSHIP = (("qkv", 384, 1152), ("proj", 384, 384), ("fc1", 384, 1536),
            ("fc2", 1536, 384))
MASKCLIP = (("in_proj", 768, 2304), ("out_proj", 768, 768),
            ("c_fc", 768, 3072), ("c_proj", 3072, 768))
# I: (name, M, K, N, output dtype, bias after the cast)
I_CASES = tuple((f"flagship {name}", m, k, n, "bfloat16", False)
                for m in (FWD, HOST) for name, k, n in FLAGSHIP) + tuple(
    (f"maskclip {name}", CLIP, k, n, "bfloat16", name == "in_proj")
    for name, k, n in MASKCLIP) + (
    ("flagship qkv f32 output", HOST, 384, 1152, "float32", False),)
HOST_CALLS = 200


def _bound(ops: float, nbytes: float, op_dtype: str) -> dict:
    times = {"operations": ops / PEAK_OPS_PER_S[op_dtype] * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by}


def _drawn(shape, seed: int, device, scale: float = 1.0,
           spread: bool = False) -> torch.Tensor:
    """Drawn values, rows of magnitudes spread over e^±3 with ``spread``,
    as activations are."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(shape, generator=g, device=device) * scale
    if spread:
        x = x * torch.exp(torch.rand((shape[0], 1), generator=g,
                                     device=device) * 6 - 3)
    return x


def quantize_case(shape, dtype: str, what: str, seed: int, device,
                  on_card: bool) -> dict:
    x = _drawn(shape, seed, device, spread=True).to(getattr(torch, dtype))
    q, s = quant.quantize_rows(x)
    want_q, want_s = quant._quantize_rows_plain(x)
    n = x.numel()
    return {"kernel": "quantize_rows", "shape": list(shape), "dtype": dtype,
            "what": what,
            "bitwise_equal": bool(torch.equal(q, want_q))
            and bool(torch.equal(s, want_s)),
            "ms": time_graph(quant.quantize_rows, x) if on_card else None,
            # |x|, max, divide, round a value; x read once, q written once,
            # one scale a row
            **_bound(4.0 * n, n * (x.element_size() + 1) + 4 * shape[0],
                     "float32")}


def gemm_case(name: str, m: int, k: int, n: int, dtype: str,
              bias_after: bool, seed: int, device, on_card: bool) -> dict:
    out_dtype = getattr(torch, dtype)
    x = _drawn((m, k), seed, device).to(torch.bfloat16)
    w = _drawn((n, k), seed + 1, device, k**-0.5).to(torch.bfloat16)
    bias = _drawn((n,), seed + 2, device).to(out_dtype)
    xq, sx = quant.quantize_rows(x)
    wq, sw = quant._weight_rows(w)
    sw = sw.reshape(-1)

    def kernel(a):
        return quant.int8_gemm(a, wq, sx, sw, bias, out_dtype, bias_after)

    got = kernel(xq)
    want = quant._int8_gemm_plain(xq, wq, sx, sw, bias, out_dtype,
                                  bias_after)
    rec = {"kernel": "int8_gemm", "name": name, "shape": [m, k, n],
           "dtype": dtype, "bias_after_cast": bias_after,
           "bitwise_equal": bool(torch.equal(got, want)),
           "max_abs_err": float((got.float() - want.float()).abs().max())}
    if on_card:
        rec["ms"] = time_graph(kernel, xq)
        wb, bb = w, bias.to(torch.bfloat16)
        rec["linear_bf16_ms"] = time_graph(lambda a: F.linear(a, wb, bb), x)
    else:
        rec["ms"] = rec["linear_bf16_ms"] = None
    rec.update(_bound(2.0 * m * n * k,
                      m * k + n * k + 4 * (m + n) + n * bias.element_size()
                      + m * n * got.element_size(), "int8"))
    return rec


def _encode_map(wq: torch.Tensor):
    """A call that encodes the tensor map of the ``[N, K]`` int8 ``wq`` as
    I's launch does (128-byte K-blocks of 128 rows, 128-byte swizzle),
    through libcuda's ``cuTensorMapEncodeTiled``."""
    encode = ctypes.CDLL("libcuda.so.1").cuTensorMapEncodeTiled
    u32, u64 = ctypes.c_uint32, ctypes.c_uint64
    encode.argtypes = [ctypes.c_void_p, ctypes.c_int, u32, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p] + [ctypes.c_int] * 4
    encode.restype = ctypes.c_int
    # a CUtensorMap is 128 bytes, 64-byte aligned
    buf = ctypes.create_string_buffer(128 + 64)
    where = ctypes.addressof(buf) + (-ctypes.addressof(buf)) % 64
    n, k = wq.shape
    dims, pitch = (u64 * 2)(k, n), (u64 * 1)(k)
    box, steps = (u32 * 2)(128, 128), (u32 * 2)(1, 1)
    # UINT8, no interleave, 128-byte swizzle, 128-byte L2 promotion, no fill
    args = (where, 0, 2, wq.data_ptr(), dims, pitch, box, steps, 0, 3, 2, 0)
    if encode(*args) != 0:
        raise RuntimeError("cuTensorMapEncodeTiled refused I's weight map")
    return lambda: encode(*args)


def host_costs(device) -> dict:
    """Host µs of one I wrapper call at the host click's qkv (enqueued
    back to back, then one synchronize), and of one tensor map's encoding
    through ctypes beside a ctypes call that does nothing."""
    xq, sx = quant.quantize_rows(_drawn((HOST, 384), 7, device).to(
        torch.bfloat16))
    wq, sw = quant._weight_rows(_drawn((1152, 384), 8, device, 384**-0.5).to(
        torch.bfloat16))
    sw = sw.reshape(-1)
    for _ in range(10):
        quant.int8_gemm(xq, wq, sx, sw, None, torch.bfloat16)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        quant.int8_gemm(xq, wq, sx, sw, None, torch.bfloat16)
    rec = {"wrapper_us": (time.perf_counter() - t0) / HOST_CALLS * 1e6}
    torch.cuda.synchronize()
    lib = quant._load()
    calls = {"encode_map_us": _encode_map(wq),
             "ctypes_call_us": lambda: lib.iseg_error_string(0)}
    for key, call in calls.items():
        call()
        t0 = time.perf_counter()
        for _ in range(1000):
            call()
        rec[key] = (time.perf_counter() - t0) / 1000 * 1e6
    return rec


def quant_ptxas() -> dict | None:
    """Build H and I if their library is missing; I's ptxas entries and
    the C7515 lines of the source when this call built it, else None."""
    log = cuda_lib.build(["quant"]).get("quant")
    if log is None:
        return None
    return {"int8_gemm": {k: v for k, v in cuda_lib.ptxas_entries(
        log).items() if "int8_gemm" in k},
        "c7515_lines": sum("C7515" in line for line in log.splitlines())}


def main(device=None, label: str = "", h_cases=H_CASES,
         i_cases=I_CASES) -> dict:
    """Check and time H and I at every case (on the card); returns the
    record it prints. The case arguments serve tests at a tiny size."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rec = {"label": label, "device": (torch.cuda.get_device_name(device)
                                      if on_card else "cpu")}
    if on_card:
        rec["ptxas"] = quant_ptxas()
    rec["cases"] = []
    seed = 400
    with torch.no_grad():
        for shape, dtype, what in h_cases:
            rec["cases"].append(quantize_case(shape, dtype, what, seed,
                                              device, on_card))
            seed += 1
        for name, m, k, n, dtype, after in i_cases:
            rec["cases"].append(gemm_case(name, m, k, n, dtype, after, seed,
                                          device, on_card))
            seed += 3
        if on_card:
            rec["host"] = host_costs(device)
    print("bench_int8", json.dumps(rec))
    bad = [c for c in rec["cases"] if not c["bitwise_equal"]]
    if bad:
        raise SystemExit(f"kernels H and I differ from their plain "
                         f"versions: {bad}")
    return rec


def _cli() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="", help="names this checkout")
    parser.add_argument("--device", help="cuda (default) or cpu")
    args = parser.parse_args()
    main(args.device, args.label)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
