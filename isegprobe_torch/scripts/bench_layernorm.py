"""Kernel B's backward (``csrc/layernorm.cu:iseg_layernorm_bwd``) on its
own, and the paths that train through it.

    python -m isegprobe_torch.scripts.bench_layernorm [--label NAME]
        [--out FILE] [--device cpu]
    PYTHONPATH=CHECKOUT python isegprobe_torch/scripts/bench_layernorm.py
        --e2e [--label NAME] [--out FILE]

Each case of :data:`CASES` draws x, weight, bias and the cotangent from a
seed and holds the backward's gradients against its plain version
``ops/layernorm.py:_ln_plain_bwd`` and against autograd through the plain
forward ``_ln_plain`` (each error relative to its gradient's largest
magnitude), counts its launches (1 for dx alone, 2 with the weight's and
bias's gradients) and checks that two runs give dweight and dbias bit for
bit. On the card it times each call as ``bench_attn_variants.time_graph``
times (CUDA events around replays of a CUDA graph of 20 calls, median of
5): the backward, its plain version and ``aten.native_layer_norm_backward``
(the library call, where it computes the same function: statistics over
every channel; weights cast to x's dtype); the forward kernel, forward +
backward, and ``aten.native_layer_norm`` + its backward. Bounds are the
larger of the bytes at 3.35 TB/s and the f32 operations at 67 TFLOP/s: the
backward reads x and dy and writes dx once (3·rows·D·size, plus the
weights), forward + backward adds the forward's read and write. Beside
them: the floor of an empty kernel on the forward's grid at [2, 785, 384]
in a graph, and the host µs a call spends in Python and ctypes (eager
forward + backward, enqueued back to back).

With ``--e2e`` (the card) it measures, instead, the paths that train
through B, of the package that ``import isegprobe_torch`` finds (run by
its path with a checkout first on ``PYTHONPATH``, it measures that
checkout, so two checkouts compare on one card): the flagship's
full-width train step at 224², batch 8, no clicks, in f32 and in bf16
(device kernels a step, device time and busy share by ``torch.profiler``;
the best of three medians of 10 steps' host wall, each step
synchronized); one DistMap-BRS (Input-BRS) L-BFGS evaluation of the
trained flagship at 448² (median host ms of 5); and LoftUp's 448² step at
batch 8 (peak allocated memory, ms). B's backward launches are counted
where the package has the counter.

Prints one line, ``bench_layernorm {json}``. On the CPU the plain versions
run at a tiny size and nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from isegprobe_torch import resolve_device
from isegprobe_torch.ops import cuda_lib, layernorm
from isegprobe_torch.scripts.bench_attn_variants import time_graph
from isegprobe_torch.scripts.bench_int8 import _bound

HOST_CALLS = 200
# gradients against the plain version's, of their scale: f32 sums in
# another order (~1e-6); bf16 outputs one rounding step (2^-8) apart
GRAD_TOL = {"float32": 1e-5, "bfloat16": 2.0**-8}
DX = (True, False, False)
ALL = (True, True, True)
# (name, shape, x dtype, weight dtype, real, eps, needs)
CASES = (
    ("flagship_forward_b16", (16, 1025, 384), "float32", "float32", None,
     1e-6, DX),
    ("flagship_forward_b16_bf16", (16, 1025, 384), "bfloat16", "float32",
     None, 1e-6, DX),
    ("train_step", (8, 257, 384), "float32", "float32", None, 1e-6, DX),
    ("train_step_bf16", (8, 257, 384), "bfloat16", "float32", None, 1e-6,
     DX),
    ("input_brs", (1, 1025, 384), "float32", "float32", None, 1e-6, ALL),
    ("loftup_padded", (4, 28672, 512), "float32", "float32", 404, 1e-5, DX),
    ("loftup_padded_stem", (4, 68, 448, 256), "float32", "float32", 203,
     1e-5, DX),
    ("simplevit", (16, 1024, 588), "float32", "float32", None, 1e-6, ALL),
)
TINY_CASES = (
    ("tiny", (2, 9, 64), "float32", "float32", None, 1e-6, ALL),
    ("tiny_real", (2, 9, 64), "bfloat16", "float32", 50, 1e-5, DX),
)
FLOOR_SHAPE = (2, 785, 384)
E2E_STEPS, E2E_ROUNDS = 10, 3
E2E_BATCH, E2E_CROP, LOFTUP_CROP = 8, 224, 448
FLAGSHIP_CKPT = (Path(__file__).resolve().parents[2] / "assets" / "trained"
                 / "synthetic_dinov2_noup_160ep.ckpt")
BRS_FIXTURE = (Path(__file__).resolve().parents[1] / "fixtures"
               / "synthetic_brs.npz")


def graph_timer(fn) -> float:
    """Device ms a call of ``fn()``, as ``time_graph`` times."""
    return time_graph(lambda _: fn(), None)


def draw(shape, dtype: str, wdtype: str, real, seed: int, device):
    """x (scaled and shifted normals), weight, bias and a cotangent; with
    ``real`` the channels past it are zeros in x, weight and bias, as in
    LoftUp's padded layout."""
    g = torch.Generator(device=device).manual_seed(seed)
    d = shape[-1]
    x = (torch.randn(shape, generator=g, device=device) * 3 + 1).to(
        getattr(torch, dtype))
    w = (torch.randn(d, generator=g, device=device) * 0.5 + 1).to(
        getattr(torch, wdtype))
    b = torch.randn(d, generator=g, device=device).to(getattr(torch, wdtype))
    dy = torch.randn(shape, generator=g, device=device).to(x.dtype)
    if real is not None:
        x[..., real:], w[real:], b[real:] = 0, 0, 0
    return x, w, b, dy


def _rel(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max()) / max(
        float(want.abs().max()), 1e-30)


def backward_case(name: str, shape, dtype: str, wdtype: str, real, eps,
                  needs, seed: int, device, tol: dict = GRAD_TOL,
                  timer=None, bound=_bound) -> dict:
    """Check the backward kernel at one case (see the module docstring),
    and on the card with a ``timer`` (``timer(fn)``: device ms a call of
    ``fn()``) time it; ``bound(ops, bytes, "float32")`` gives the bounds.
    ``ok`` holds the gates."""
    on_card = device.type == "cuda"
    x, w, b, dy = draw(shape, dtype, wdtype, real, seed, device)
    d, n = shape[-1], x.numel()
    kernel_bwd = layernorm._ln_bwd_cuda if on_card else \
        layernorm._ln_plain_bwd
    before = layernorm.layernorm.backward_launches
    got = kernel_bwd(x, w, dy, eps, real, needs)
    launches = layernorm.layernorm.backward_launches - before
    want = layernorm._ln_plain_bwd(x, w, dy, eps, real, needs)
    ts = [t.detach().requires_grad_(nd) for t, nd in zip((x, w, b), needs)]
    with torch.enable_grad():
        wanted = [t for t in ts if t.requires_grad]
        auto = iter(torch.autograd.grad(
            layernorm._ln_plain(*ts, eps, real), wanted, dy))
    auto = [next(auto) if nd else None for nd in needs]
    vs_plain, vs_autograd, dtypes_ok = [], [], True
    for g_, p_, a_, t in zip(got, want, auto, (x, w, b)):
        if a_ is None:
            dtypes_ok = dtypes_ok and g_ is None
            continue
        dtypes_ok = dtypes_ok and g_.dtype == t.dtype
        vs_plain.append(_rel(g_, p_))
        vs_autograd.append(_rel(g_, a_))
    affine = needs[1] or needs[2]
    repeat = None
    if affine:
        again = kernel_bwd(x, w, dy, eps, real, needs)
        repeat = all(torch.equal(g_, a_) for g_, a_ in zip(got[1:], again[1:])
                     if g_ is not None)
    rec = {"kernel": "layernorm_bwd", "name": name, "shape": list(shape),
           "dtype": dtype, "w_dtype": wdtype, "real": real, "eps": eps,
           "needs": list(needs), "launches": launches,
           "grad_rel_err_vs_plain": vs_plain,
           "grad_rel_err_vs_autograd": vs_autograd,
           "max_abs_err": float((got[0].float() - want[0].float()).abs().max())
           if needs[0] else None,
           "grad_tol": tol[dtype], "grad_dtypes_ok": dtypes_ok,
           "affine_bitwise_repeat": repeat}
    rec["ok"] = bool(dtypes_ok and max(vs_plain + vs_autograd) <= tol[dtype]
                     and (not on_card or launches == (2 if affine else 1))
                     and repeat is not False)
    del got, want, auto, ts
    # bytes: x and dy read, dx written, the weight read (and dweight, dbias
    # written); operations: the statistics recomputed (3 an element), the
    # two sums (5), dx (7), dweight and dbias (4); the forward reads x and
    # writes y, and takes 9 an element
    size, wsize = x.element_size(), w.element_size()
    bwd_bytes = 3 * n * size + d * wsize + (2 * d * wsize if affine else 0)
    bwd_ops = (15 + (4 if affine else 0)) * n
    rec.update(bound(bwd_ops, bwd_bytes, "float32"))
    rec["fwd_bwd_bound_ms"] = bound(bwd_ops + 9 * n, bwd_bytes + 2 * n * size
                                    + 2 * d * wsize, "float32")["bound_ms"]
    if not (on_card and timer):
        return rec
    mask = list(needs)
    rec["ms"] = timer(lambda: layernorm._ln_bwd_cuda(x, w, dy, eps, real,
                                                     needs))
    rec["plain_ms"] = timer(lambda: layernorm._ln_plain_bwd(
        x, w, dy, eps, real, needs))
    rec["fwd_ms"] = timer(lambda: layernorm._ln_cuda(x, w, b, eps, real))

    def fwd_bwd():
        layernorm._ln_cuda(x, w, b, eps, real)
        layernorm._ln_bwd_cuda(x, w, dy, eps, real, needs)

    rec["fwd_bwd_ms"] = timer(fwd_bwd)
    rec["library_ms"] = rec["library_fwd_bwd_ms"] = None
    if real is None:
        wl, bl = w.to(x.dtype), b.to(x.dtype)
        _, mean, rstd = torch.ops.aten.native_layer_norm(x, [d], wl, bl, eps)
        rec["library_ms"] = timer(
            lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [d], mean, rstd, wl, bl, mask))

        def library_fwd_bwd():
            _, m_, r_ = torch.ops.aten.native_layer_norm(x, [d], wl, bl, eps)
            torch.ops.aten.native_layer_norm_backward(dy, x, [d], m_, r_, wl,
                                                      bl, mask)

        rec["library_fwd_bwd_ms"] = timer(library_fwd_bwd)
    return rec


def floor_ms(device) -> float:
    """An empty kernel on the forward's grid at FLOOR_SHAPE, in a graph."""
    lib = layernorm._load()
    rows = int(np.prod(FLOOR_SHAPE[:-1]))

    def launch():
        err = lib.iseg_layernorm_empty(
            rows, torch.cuda.current_stream(device).cuda_stream)
        cuda_lib.check(lib, err, "empty kernel launch")

    return graph_timer(launch)


def host_us(device) -> dict:
    """Host µs an eager forward + backward under autograd spends at the
    train step's shape (dx alone), enqueued back to back and synchronized
    once: the kernels and ``F.layer_norm``; and one call of each kernel's
    wrapper and of a ctypes function that does nothing."""
    x, w, b, dy = draw((8, 257, 384), "float32", "float32", None, 5, device)

    def per_call(fn) -> float:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        return us

    def autograd(fn):
        def call():
            fn(x.detach().requires_grad_(True), w, b).backward(dy)
        return call

    lib = layernorm._load()
    return {"autograd_kernel_us": per_call(autograd(
                lambda *t: layernorm.layernorm(*t, 1e-6))),
            "autograd_library_us": per_call(autograd(
                lambda *t: F.layer_norm(t[0], (384,), t[1], t[2], 1e-6))),
            "forward_wrapper_us": per_call(
                lambda: layernorm._ln_cuda(x, w, b, 1e-6)),
            "backward_wrapper_us": per_call(
                lambda: layernorm._ln_bwd_cuda(x, w, dy, 1e-6, None, DX)),
            "ctypes_call_us": per_call(lambda: lib.iseg_error_string(0))}


# -- end to end ---------------------------------------------------------------

def _drawn_batch(size: int, batch: int, seed: int) -> dict:
    """A seeded uint8 batch with one rectangle and a positive click on it
    per item."""
    rng = np.random.default_rng(seed)
    inst = np.zeros((batch, size, size, 1), np.int8)
    points = np.full((batch, 48, 3), -1.0, np.float32)
    for i in range(batch):
        y0, x0 = rng.integers(size // 11, size // 2, 2)
        inst[i, y0:y0 + size // 3, x0:x0 + size // 4] = 1
        points[i, 0] = (y0 + size // 6, x0 + size // 8, 0)
    return {"images": rng.integers(0, 256, (batch, size, size, 3), np.uint8),
            "points": points, "instances": inst}


def _b_backward() -> int | None:
    """B's backward launches so far, where the package counts them."""
    return getattr(layernorm.layernorm, "backward_launches", None)


def profiled(fn) -> dict:
    """Device kernels, their device ms and the busy share of one ``fn()``
    by ``torch.profiler``, the ATen calls the host made, and B's backward
    launches."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = _b_backward()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    kernels = [e for e in events if "CUDA" in str(e.device_type)
               and e.self_device_time_total > 0]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"kernels": int(sum(e.count for e in kernels)),
            "aten_calls": int(sum(e.count for e in events
                                  if e.key.startswith("aten::"))),
            "device_ms": device_ms, "wall_ms": wall,
            "busy_share": device_ms / wall if wall else None,
            "b_backward_launches": None if before is None
            else _b_backward() - before}


def train_steps(dtype: str, tmp: str) -> dict:
    """The flagship's 224² step at batch 8, no clicks."""
    from isegprobe_torch import train as train_cli

    argv = ["model=synthetic_dinov2_noup", "dataloader.workers=0",
            f"exp_path={tmp}", f"training_params.dtype={dtype}"]
    trainer = train_cli.build_trainer(train_cli.parse_args(argv))
    batch = trainer._upload(_drawn_batch(E2E_CROP, E2E_BATCH, 11))

    def step():
        float(trainer._step(batch, 0)[0])

    step()
    rec = {"dtype": dtype, **profiled(step)}
    medians = []
    for _ in range(E2E_ROUNDS):
        walls = []
        for _ in range(E2E_STEPS):
            t0 = time.perf_counter()
            step()
            walls.append(1e3 * (time.perf_counter() - t0))
        medians.append(float(np.median(walls)))
    rec.update(step_ms_medians=medians, step_ms_best_median=min(medians))
    trainer.shutdown()
    return rec


def input_brs(device) -> dict:
    """One DistMap-BRS evaluation of the trained flagship at 448² (the
    objective scipy's L-BFGS calls), on the first Synthetic object after
    the two clicks and predictor states of ``fixtures/synthetic_brs.npz``,
    median host ms of 5."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference import brs
    from isegprobe_torch.inference.clicker import Click, Clicker

    model, _ = load_model_for_eval(str(FLAGSHIP_CKPT), torch.float32,
                                   (448, 448), device)
    with np.load(BRS_FIXTURE) as fx:
        roi, prev, clicks = fx["b_roi"], fx["b_prev"], fx["b_clicks"]
    sample = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, 1)
                          ).get_sample(0)
    clicker = Clicker()
    for y, x, pos in clicks:
        clicker.add_click(Click(bool(pos), (int(y), int(x))))
    pred = brs.get_predictor(model, "DistMap-BRS", prob_thresh=0.49,
                             zoom_in_params={"skip_clicks": -1,
                                             "target_size": (448, 448)},
                             predictor_params={"net_clicks_limit": 20})
    pred.set_input_image(sample.image)
    pred.set_states({"object_roi": tuple(int(v) for v in roi),
                     "prev_prediction": prev.astype(np.float32)})
    captured = {}
    real = brs.fmin_l_bfgs_b

    def capture(func, x0, **kw):
        captured.update(func=func, x0=x0)
        return x0, 0.0, {}

    brs.fmin_l_bfgs_b = capture
    try:
        pred.get_prediction(clicker)
    finally:
        brs.fmin_l_bfgs_b = real
    func, x0 = captured["func"], captured["x0"]

    def evaluation():
        func._last_mask = None  # a repeat computes in full
        func(x0)

    evaluation()
    rec = {"mode": "DistMap-BRS", **profiled(evaluation)}
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        evaluation()
        walls.append(1e3 * (time.perf_counter() - t0))
    rec["ms_median"] = float(np.median(walls))
    return rec


def loftup_448(tmp: str) -> dict:
    """LoftUp's 448² step at batch 8 (slabs checkpointed): peak allocated
    memory and device ms by events, of the step after a first one."""
    from isegprobe_torch import train as train_cli

    argv = ["model=synthetic_dinov2_loftup", "dataloader.workers=0",
            f"exp_path={tmp}",
            f"training_params.crop_size=[{LOFTUP_CROP},{LOFTUP_CROP}]"]
    trainer = train_cli.build_trainer(train_cli.parse_args(argv))
    batch = trainer._upload(_drawn_batch(LOFTUP_CROP, E2E_BATCH, 12))
    float(trainer._step(batch, 0)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    loss = float(trainer._step(batch, 0)[0])
    ev[1].record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    trainer.shutdown()
    return {"crop": LOFTUP_CROP, "batch": E2E_BATCH, "loss": loss,
            "step_ms": ev[0].elapsed_time(ev[1]),
            "peak_memory_mb": peak / 2**20,
            "step_peak_mb": (peak - base) / 2**20}


def end_to_end(device) -> dict:
    with tempfile.TemporaryDirectory() as tmp:
        rec = {"train_f32": train_steps("float32", tmp),
               "train_bf16": train_steps("bfloat16", tmp)}
        torch.cuda.empty_cache()
        rec["input_brs"] = input_brs(device)
        torch.cuda.empty_cache()
        rec["loftup_448"] = loftup_448(tmp)
    return rec


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def _emit(rec: dict, out: str | None) -> None:
    line = json.dumps(rec)
    print("bench_layernorm", line)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(line + "\n")


def main(device=None, label: str = "", cases=CASES,
         out: str | None = None) -> dict:
    """Check (and on the card time) every case; returns the record it
    prints. ``cases`` serves tests at a tiny size."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rec = {"label": label, "device": (torch.cuda.get_device_name(device)
                                      if on_card else "cpu")}
    if on_card:
        rec["nvidia_smi"] = _nvidia_smi()
    rec["cases"] = [backward_case(*case, seed=500 + i, device=device,
                                  timer=graph_timer)
                    for i, case in enumerate(cases)]
    if on_card:
        rec["floor_ms"] = {"shape": list(FLOOR_SHAPE),
                           "empty_kernel_ms": floor_ms(device)}
        rec["host"] = host_us(device)
    _emit(rec, out)
    bad = [c for c in rec["cases"] if not c["ok"]]
    if bad:
        raise SystemExit(f"kernel B's backward fails its gates: {bad}")
    return rec


def main_e2e(label: str = "", out: str | None = None) -> dict:
    """The end-to-end measures on the card; returns the record it
    prints."""
    device = resolve_device("cuda")
    import isegprobe_torch

    rec = {"label": label, "package": str(Path(
               isegprobe_torch.__file__).resolve().parents[1]),
           "device": torch.cuda.get_device_name(device),
           "nvidia_smi": _nvidia_smi(), "e2e": end_to_end(device)}
    _emit(rec, out)
    return rec


def _cli() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="", help="names this run")
    parser.add_argument("--device", help="cuda (default) or cpu")
    parser.add_argument("--e2e", action="store_true",
                        help="the paths that train through B instead")
    parser.add_argument("--out", help="also write the JSON line here")
    args = parser.parse_args()
    if args.e2e:
        main_e2e(args.label, args.out)
        return 0
    device = resolve_device(args.device)
    main(device, args.label, CASES if device.type == "cuda" else TINY_CASES,
         args.out)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
