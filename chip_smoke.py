#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json]

Phases, each of which fails the run (non-zero exit, no result line) when it
does not hold:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels of ``isegprobe_torch/csrc`` (A attention, B
   LayerNorm, C EDT row envelope, D cross-attention, E JBU filter, F and G
   attention variants; A, D, F and G on the flash core
   ``csrc/flash_core.cuh``) with nvcc, one process per source, all started
   together, print the ptxas report and, on a line of its own, the count of
   its C7515 lines (wgmma serialized by ptxas); read kernel E's tiling,
   resident blocks an SM, registers and local bytes from its library and
   its ptxas entry from this run's build (a spill, or fewer than the two
   blocks an SM of its design, fails the run), and kernel C's layout at the
   loop's row width (rows a block, threads, segment width, shared bytes,
   blocks an SM, registers, local bytes: any local byte fails the run);
3. hold kernels A and B against their plain PyTorch versions on the card, at
   the flagship shapes in f32 and bf16, at the device loop's batch of 16
   crops, and at attention shapes with dh != 64 (A also at dh = 13, whose
   bf16 rows take the element-load path), and time kernel, plain version
   and the one PyTorch call that computes the same function (a yardstick
   only: the port never calls it). A is checked and timed at the plan
   ``ops/attention.py:_plan`` picks (recorded) and, forced through the
   entry's ``plan``, at every other query tile and load path;
4. hold kernel C bitwise against its plain version (max abs error exactly 0)
   at the device loop's shape [8, 2, 514, 642] on the three inputs of
   ``bench_edt.py`` (random masks with zero-free columns, the clicker's
   error maps, one zero a column), timed; on random masks at 64x64 and at
   a width that is no multiple of 32; and over the rest of its domain
   (``bench_edt.domain_inputs``: W = 4096, W = 1, sentinel rows, single
   sources, column passes of height 5000, where g > 4096, and 40,000, where
   G > 2^30 and C takes its int64 path);
5. build the full-width flagship probe (DINOv2-S/14, 448², weights drawn
   from a seed, classifier bias set so that masks answer clicks), run
   one f32 forward on the card and the same forward on the CPU (plain
   versions), compare the logits, and check that one forward launches 12
   attention and 25 LayerNorm kernels;
6. main path 1, the host protocol: the Predictor answers NoC clicks
   (fixed-448 ZoomIn, flip TTA, f32) on two numpy-drawn scenes, with every
   launch counter set to 0 just before and read just after; prints the p50
   ms per click. Then one bf16 forward (params cast as evaluate.py casts
   them) is timed: exact launches, and its logits within 0.05 of the f32
   logits' scale;
7. the on-device clicker (``next_click_from_error``, kernel C underneath)
   on 32 random lanes must click exactly where the host scipy ``Clicker``
   clicks;
8. main path 2, the batched on-device NoC loop (``make_device_evaluator`` +
   ``evaluate_dataset_device``) on ten 480x640 scenes at B=8 (a padded
   tail chunk), 20 clicks, f32, with a target IoU picked from a first run
   so that lanes stop at different clicks. Counters set to 0 just before
   and read just after: every loop step launches exactly 1 C, 12 A and 25
   B. The B=8 trajectories must equal the B=1 ones, and two of them the
   host Predictor's;
9. one whole device-loop evaluation under
   ``torch.cuda.set_sync_debug_mode("error")``, lifted only around the one
   allowed read per click: any other synchronising op fails the run;
10. the trunk cache at full width (``after_backbone`` flagship, B=4, 5
    clicks): cached trajectories equal uncached ones, and the trunk was
    recomputed on some clicks but not all;
11. throughput of the device loop (f32 B=8, bf16 B=8 and B=16 on sixteen
    scenes) beside the host protocol's p50 per click, and the split of one
    f32 B=8 loop step (clicker, crop, forward at batch 16, paste; kernel C
    on the step's own error maps, bitwise against its plain version);
11b. the trained probes (main paths 8-13): the 160-epoch flagship
    checkpoint loaded through ``isegprobe_torch.evaluate.
    load_model_for_eval`` (frozen backbone rebuilt from PRNGKey(0) in numpy:
    its seconds and 22,056,192 parameters printed) and held against the
    JAX package's results stored in ``isegprobe_torch/fixtures/
    synthetic2026_50.npz`` (the Synthetic scenes, 78 objects): the f32
    device loop at B=8 on every object (IoUs within 1e-3 of JAX's up to an
    object's first click that differs, at most 2 objects differing, each
    printed; NoC@80/85/90 within 0.05; every step 1 C, 12 A and 25 B), the
    f32 host protocol on the first 8 objects (checked the same way; p50 ms
    per click and per get_prediction), the bf16 loops at B=8 and B=16 (NoC
    and lane-clicks/s beside f32's, a report); then the 448² LoftUp
    checkpoint (its missing upsampler_path must warn) through the f32 loop
    on the fixture's 2 objects and 4 clicks against JAX's, with no object
    differing (every step 1 C, 12 A, 82 B and 14 D), and timed on all 78
    objects at the family loop's 4 lanes and 8 clicks (a report, every step
    launching the same). Kernels A, B, C and D are also checked at these
    paths' shapes: A and B in bf16 at the B=16 loop's forward batch 32, B
    at LoftUp's widths (404 on the slab and key rows, 203 on the stem, 384
    in the ChannelNorm) at both LoftUp loops' forward batches, C on 258²
    rows, D at forward batch 4;
12. the learned-upsampler families, LoftUp and JBU-FeatUp on DINOv2-S/14 at
    448² (drawn, calibrated): kernels D (cross-attention, f32 and bf16, at
    every tile and load path as A) and E (JBU filter; also at the edges of
    its tiling and on bases off 16-byte alignment) against their plain
    versions at the families' shapes, timed beside them; for each family
    one f32 forward on the card against the CPU with its exact launches per
    forward (LoftUp 12 A + 82 B + 14 D, JBU 12 A + 25 B + 4 E; LoftUp also
    one bf16 forward, checked as the flagship's), the host protocol (main path 3 and 5: p50 ms per
    click), the device loop at B=4 (main paths 4 and 6: every step 1 C plus
    one forward's launches, trajectories equal to B=1 and to the host
    Predictor; the JBU loop also under the sync debugger), and the split of
    one loop step into backbone, upsampler and head, with a profiler
    breakdown of the LoftUp forward by kernel;
13. the attention-variant sweep: kernels F (nodiv) and G (merged) against
    their plain versions at every query tile and exp dtype they take, at
    [2, 1025, 1152], at the sweep's [16, 1025, 1152] and at the ragged
    [3, 77, 768] (4 heads), in f32 and bf16, and bit for bit against the
    core they share with kernel A (G equals F at the same tile and exp; F
    with an f32 exp equals A at the same plan);
    their plain versions and SDPA timed at the sweep's shape. Then main
    path 7, the sweep through its package entry (``isegprobe_torch.scripts.
    bench_attn_variants.main``): every variant within tolerance of the f32
    reference and timed (the kernel times of F and G in the ``kernels``
    line), with every counter set to 0 just before and read just after, and
    each variant's kernel launched exactly as often as the sweep calls it;
14. print the ``{"kernels": [...]}`` line (kernels A-G, launches by path,
    the flash core named beside A, D, F and G,
    the flagship's and LoftUp's bf16 forwards among the paths; A, F and G
    also in bf16 at the sweep's shape, D at the LoftUp loop's; A and D with
    the plan their wrapper picked, E with the tiling and resources its
    library reports and its ptxas entry, C with its layout, its ptxas
    entry and its times on each of the three inputs) and,
    last, the ``{"ok": true, "device":
    ...}`` line.

Imports nothing of JAX or of the JAX package. Exits non-zero without a
result when CUDA is not available or the port cannot be imported.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

# Hopper H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the roofline that
# every bound_ms is computed against
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
# special-function (exp) rate of the H100 SXM, from the FlashAttention-3
# paper (Shah et al., 2024: "3.9 TFLOPS of special functions"):
# an attention's B·H·Nq·Nk exps bound it as much as its bf16 products
PEAK_EXPS_PER_S = 3.9e12

# max |kernel - plain| <= ATOL + RTOL * |plain|: f32 differs only in
# summation order (and rsqrtf / the online softmax, ~1e-6 relative); bf16
# outputs may differ by one bf16 rounding step (2^-8 relative). Kernel E's
# output is a weighted mean of 49 inputs, which errs relative to the inputs
# summed, not to the mean, so its ATOL is scaled by max |hr|.
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-2)}
# full forward, card vs CPU: f32 through 12 blocks and the conv head
FORWARD_RTOL = 1e-3
# first-click probabilities, card vs CPU predictor
PROBS_ATOL = 1e-3
# a bf16 forward (params cast to bf16) against the f32 forward on the card:
# bf16 weights, activations and attention probabilities through 12 blocks
# (the flagship's differed by 0.0149 at a logit scale of 1.07 with the
# lane-per-row attention kernel that preceded the flash core)
BF16_LOGIT_RTOL = 0.05

MAX_CLICKS = 5

# device loop: B=8 against B=1 and against the host Predictor. On the card
# the batch size may change cuBLAS's algorithm and so the f32 summation
# order, and a pixel at the 0.49 threshold may flip: per-click IoU within
# 1e-3, click counts equal. The picked target IoU keeps STOP_MARGIN from
# every IoU reached, so such a difference cannot move a stop.
LOOP_CLICKS = 20
LOOP_BATCH = 8
LOOP_JOBS = 10
LOOP_IOU_TOL = 1e-3
# the clicker's row pass in the device loop at B=8: 2 error maps of 480x640
# scenes padded by one pixel
EDT_SHAPE = (LOOP_BATCH, 2, 514, 642)
STOP_MARGIN = 2e-3
# trunk cache: the same arithmetic from a cached trunk
CACHE_TOL = 1e-4
# share of a seeded scene's pixels a drawn probe marks positive
POSITIVE_SHARE = 0.03
# what one forward of each probe launches (LoftUp at 448²: 7 slabs of 64
# rows, each 2 cross-attention layers of kernel D and 8 LayerNorms, plus the
# ChannelNorm of its input; JBU: 4 stages of kernel E)
FORWARD_LAUNCHES = {
    "flagship": {"mha_qkv": 12, "layernorm": 25},
    "loftup": {"mha_qkv": 12, "layernorm": 25 + 1 + 7 * 8, "mha": 14},
    "jbu_featup": {"mha_qkv": 12, "layernorm": 25, "jbu_filter": 4},
}
KERNELS = ("edt_row_envelope", "mha_qkv", "layernorm", "mha", "jbu_filter",
           "mha_qkv_nodiv", "mha_qkv_merged")
# what the loop's steps must launch, per step
PER_STEP = {"edt_row_envelope": 1, **FORWARD_LAUNCHES["flagship"]}
# the learned-upsampler families: crop size, device loop batch, clicks and
# scenes
FAMILY_SIZE = 448
FAMILY_BATCH = 4
FAMILY_CLICKS = 8
FAMILY_JOBS = 4
# a larger positive share than the flagship's: at 3% the drawn JBU probe's
# masks missed every object on every click (IoU 0 throughout), so no target
# IoU could stop its lanes at different clicks
FAMILY_POSITIVE_SHARE = 0.15
UPSAMPLERS = {
    "loftup": dict(type="loftup", params=dict(upsampler_path=None,
                                              n_dim=384)),
    "jbu_featup": dict(type="jbu_featup", params=dict(backbone_type="dinov2",
                                                      use_norm=True)),
}


# the trained probes (isegprobe_torch/evaluate.py) on the JAX package's
# Synthetic scenes: the checkpoints, their frozen parameters (rebuilt from
# PRNGKey(0)), evaluate.py's protocol (20 clicks, target IoU 0.9, threshold
# 0.5), the loop's batch, the objects of the host protocol and of the
# LoftUp leg against JAX (the timed LoftUp report runs every object at
# FAMILY_BATCH lanes and FAMILY_CLICKS), and the gates against the JAX
# results: at most
# TRAINED_MAX_DIVERGED of the 78 objects may click differently (a pixel at
# p = 0.5 or a tied deepest error can flip between CPU JAX and the card),
# NoC within TRAINED_NOC_TOL
TRAINED_CKPTS = {
    name: str(Path(__file__).resolve().parent / "assets" / "trained" / ckpt)
    for name, ckpt in (("flagship", "synthetic_dinov2_noup_160ep.ckpt"),
                       ("loftup", "synthetic_dinov2_loftup448_160ep.ckpt"))}
TRAINED_FROZEN = {"flagship": 22_056_192, "loftup": 22_056_192 + 4_305_510}
TRAINED_CLICKS = 20
TRAINED_TARGET = 0.9
TRAINED_THRESH = 0.5
TRAINED_BATCH = 8
TRAINED_SCENE = 256
TRAINED_HOST_OBJECTS = 8
TRAINED_LOFTUP_OBJECTS = 2
TRAINED_LOFTUP_CLICKS = 4
TRAINED_MAX_DIVERGED = 2
TRAINED_NOC_TOL = 0.05


def fail(msg: str):
    raise RuntimeError(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    if not out:
        fail("nvidia-smi printed nothing")
    return out.splitlines()[0]


def time_ms(torch, fn, reps: int = 20, rounds: int = 5,
            graph: bool = True) -> tuple[float, str]:
    """Median device ms per call of ``fn`` over ``rounds`` rounds of
    ``reps`` calls between CUDA events. With ``graph`` the calls are
    captured in one CUDA graph and replayed, so host launch cost does not
    count (a kernel of a few microseconds is otherwise timed at the host's
    launch rate); if capture fails the eager loop is timed instead. Returns
    the time and the method used."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()

    method = "eager"
    if graph:
        try:
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                run()
            g.replay()
            run, method = g.replay, "cuda_graph"
        except RuntimeError as e:
            print(f"graph capture failed ({e}); timing eagerly")
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times)), method


def compare(torch, got, want, dtype: str, scale: float = 1.0) -> dict:
    rtol, atol = TOL[dtype]
    atol *= scale
    g, w = got.float(), want.float()
    err = (g - w).abs()
    ok = bool((err <= atol + rtol * w.abs()).all()) and bool(
        torch.isfinite(g).all())
    return {"max_abs_err": float(err.max()),
            "max_rel_err": float((err / w.abs().clamp_min(1.0)).max()),
            "rtol": rtol, "atol": atol, "ok": ok}


def plan_records(torch, entry, args, plans, want, dtype, what: dict,
                 chosen) -> list:
    """Hold the kernel behind ``entry(*args, plan=...)`` against ``want``
    at every forced (q_tile, aligned) in ``plans`` other than ``chosen``
    (the plan the wrapper picks itself), each timed: one record each,
    marked ``forced``."""
    records = []
    for plan in plans:
        if plan == chosen:
            continue
        got = entry(*args, plan=plan)
        torch.cuda.synchronize()
        res = compare(torch, got, want, dtype)
        del got
        res["ms"], res["timing"] = time_ms(
            torch, lambda: entry(*args, plan=plan))
        res.update(what, plan=list(plan), forced=True)
        records.append(res)
    return records


def every_plan(attention, dtype: str, dh: int) -> list:
    """Every (q_tile, aligned) kernels A and D take at this dtype and dh."""
    vec = 8 if dtype == "bfloat16" else 4
    paths = [False] + ([True] if dh % vec == 0 else [])
    return [(t, a) for t in attention.Q_TILES for a in paths]


def attention_case(torch, F, attention, b, n, heads, dh, dtype, seed,
                   all_plans: bool = False) -> list:
    """Check and time the attention kernel at one shape, at the plan the
    wrapper picks (recorded, with the plain version's, SDPA's and the bound
    beside it) and, with ``all_plans``, at every other tile and load
    path."""
    tdt = getattr(torch, dtype)
    c = heads * dh
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda").to(tdt)
    scale = dh**-0.5
    got = attention.mha_qkv(qkv, heads, scale)
    want = attention._mha_qkv_plain(qkv, heads, scale)
    torch.cuda.synchronize()
    res = compare(torch, got, want, dtype)
    q, k, v = qkv.view(b, n, 3, heads, dh).permute(2, 0, 3, 1, 4).unbind(0)
    res["ms"], res["timing"] = time_ms(
        torch, lambda: attention.mha_qkv(qkv, heads, scale))
    res["plain_ms"], _ = time_ms(
        torch, lambda: attention._mha_qkv_plain(qkv, heads, scale))
    res["library_ms"], _ = time_ms(
        torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
    itemsize = qkv.element_size()
    ops = 4.0 * b * heads * n * n * dh
    nbytes = (b * n * 3 * c + b * n * c) * itemsize
    res.update(_bound(ops, nbytes, dtype, exps=float(b * heads * n * n)))
    what = dict(kernel="mha_qkv", shape=[b, n, 3 * c], heads=heads, dh=dh,
                dtype=dtype)
    chosen = attention._plan(b, n, heads, dh, tdt, qkv.device)
    res.update(what, plan=list(chosen))
    records = [res]
    if all_plans:
        records += plan_records(torch, attention.mha_qkv, (qkv, heads, scale),
                                every_plan(attention, dtype, dh), want,
                                dtype, what, chosen)
    return records


def variant_cases(torch, F, attention, attn_variants, b, n, heads, dtype,
                  seed, timed: bool) -> list:
    """Hold kernels F (nodiv) and G (merged) against their plain versions at
    one shape, at every query tile and every exp dtype the entries take
    (bf16 inputs: f32 and bf16 exp), and bit for bit against the flash core
    they share with kernel A: G's output equals F's at the same tile and
    exp, and F's with an f32 exp equals A's at the same plan. With
    ``timed``, the default tile of each (kernel, exp) gets its plain
    version's and SDPA's times on the same q, k and v, and its bound; the
    kernel itself is timed by the sweep. One record each."""
    tdt = getattr(torch, dtype)
    c = heads * 64
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((b, n, 3 * c), generator=g, device="cuda").to(tdt)
    scale = 64**-0.5
    expdts = ["float32"] + (["bfloat16"] if dtype == "bfloat16" else [])
    q, k, v = qkv.view(b, n, 3, heads, 64).permute(2, 0, 3, 1, 4).unbind(0)
    library_ms = None
    records = []
    kernel_f = {}  # (expdt, tile) -> F's output
    for name, entry, plain, tiles in (
            ("mha_qkv_nodiv", attn_variants.mha_qkv_nodiv,
             attn_variants._nodiv_plain, attn_variants.NODIV_TILES),
            ("mha_qkv_merged", attn_variants.mha_qkv_merged,
             attn_variants._merged_plain, attn_variants.MERGED_TILES)):
        for expdt in expdts:
            edt = getattr(torch, expdt)
            want = plain(qkv, heads, scale, edt)
            for tile in tiles:
                got = entry(qkv, heads, scale, expdt=edt, q_tile=tile)
                torch.cuda.synchronize()
                res = compare(torch, got, want, dtype)
                if name == "mha_qkv_nodiv":
                    kernel_f[expdt, tile] = got
                    if expdt == "float32":
                        same = torch.equal(got, attention.mha_qkv(
                            qkv, heads, scale, plan=(tile, True)))
                        res["bitwise_equal_kernel_a"] = same
                        res["ok"] = res["ok"] and same
                else:
                    same = torch.equal(got, kernel_f[expdt, tile])
                    res["bitwise_equal_kernel_f"] = same
                    res["ok"] = res["ok"] and same
                res.update(kernel=name, shape=[b, n, 3 * c], heads=heads,
                           dtype=dtype, expdt=expdt, tile=tile)
                if timed and tile == tiles[0]:
                    res["plain_ms"], _ = time_ms(
                        torch, lambda: plain(qkv, heads, scale, edt), reps=3,
                        rounds=3, graph=False)
                    if library_ms is None:
                        library_ms, _ = time_ms(
                            torch, lambda: F.scaled_dot_product_attention(
                                q, k, v, scale=scale))
                    res["library_ms"] = library_ms
                    res.update(_bound(4.0 * b * heads * n * n * 64,
                                      4.0 * b * n * c * qkv.element_size(),
                                      dtype, exps=float(b * heads * n * n)))
                records.append(res)
            del want
    del kernel_f
    return records


def layernorm_case(torch, F, layernorm, rows_shape, d, dtype, seed,
                   eps: float = 1e-6):
    """Check and time the LayerNorm kernel at one shape (weights in the IO
    dtype, as the model passes them)."""
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn((*rows_shape, d), generator=g, device="cuda") * 3 + 1
         ).to(tdt)
    w = (torch.randn(d, generator=g, device="cuda") * 0.5 + 1).to(tdt)
    bias = torch.randn(d, generator=g, device="cuda").to(tdt)
    got = layernorm.layernorm(x, w, bias, eps)
    want = layernorm._ln_plain(x, w, bias, eps)
    torch.cuda.synchronize()
    res = compare(torch, got, want, dtype)
    res["ms"], res["timing"] = time_ms(
        torch, lambda: layernorm.layernorm(x, w, bias, eps))
    res["plain_ms"], _ = time_ms(
        torch, lambda: layernorm._ln_plain(x, w, bias, eps))
    res["library_ms"], _ = time_ms(
        torch, lambda: F.layer_norm(x, (d,), w, bias, eps))
    n = x.numel()
    nbytes = 2 * n * x.element_size() + 2 * d * w.element_size()
    ops = 8.0 * n  # sum, square-sum, centre, scale, affine (f32 math)
    res.update(_bound(ops, nbytes, "float32"))
    res.update(kernel="layernorm", shape=list(x.shape), dtype=dtype)
    return res


def edt_case(torch, edt, gcol, kind: str, timed: bool = True):
    """Hold kernel C bitwise against its plain version on one column-pass
    output ``gcol`` (``bench_edt.column_input`` or ``domain_inputs``),
    timed beside it. C's work depends on the data; its bound counts what
    the function needs: ~20 integer operations a source for an envelope,
    and g read and the result written once (bytes bound it). No single
    PyTorch call computes this function, so there is no library time."""
    got = edt.row_envelope(gcol)
    want = edt._row_envelope_plain(gcol)
    torch.cuda.synchronize()
    res = {"max_abs_err": float((got - want).abs().max()),
           "bitwise_equal": bool(torch.equal(got, want)),
           "clamped_values": int((want == edt.BIG2).sum())}
    res["ok"] = res["bitwise_equal"] and res["max_abs_err"] == 0.0
    if timed:
        res["ms"], res["timing"] = time_ms(torch,
                                           lambda: edt.row_envelope(gcol))
        res["plain_ms"], _ = time_ms(
            torch, lambda: edt._row_envelope_plain(gcol))
        res["library_ms"] = None
    w = gcol.shape[-1]
    rows = gcol.numel() // w
    res.update(_bound(20.0 * rows * w, 8.0 * rows * w, "float32"))
    res.update(kernel="edt_row_envelope", input=kind,
               shape=list(gcol.shape), rows=rows, dtype="float32")
    return res


def sdpa_backends(torch, F, q, k, v, scale) -> list:
    """The fused backends of ``scaled_dot_product_attention`` that take
    these inputs (the math backend takes everything)."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    names = []
    for backend in (SDPBackend.FLASH_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            try:
                with sdpa_kernel(backend):
                    F.scaled_dot_product_attention(q, k, v, scale=scale)
                names.append(backend.name)
            except RuntimeError:
                pass
    return names


def cross_attention_case(torch, F, attention, b, nq, nk, heads, dh, dtype,
                         seed, all_plans: bool = False) -> list:
    """Check and time kernel D at one shape, at the plan the wrapper picks,
    beside its plain version and ``scaled_dot_product_attention``
    (recording which fused backends take the shape; the default picks the
    first, else the math backend) and, with ``all_plans``, at every other
    tile and load path."""
    tdt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((b, nq, heads, dh), generator=g, device="cuda").to(tdt)
    k = torch.randn((b, nk, heads, dh), generator=g, device="cuda").to(tdt)
    v = torch.randn((b, nk, heads, dh), generator=g, device="cuda").to(tdt)
    scale = dh**-0.5
    got = attention.mha(q, k, v, scale)
    want = attention._mha_plain(q, k, v, scale)
    torch.cuda.synchronize()
    res = compare(torch, got, want, dtype)
    del got
    res["ms"], res["timing"] = time_ms(
        torch, lambda: attention.mha(q, k, v, scale))
    res["plain_ms"], _ = time_ms(
        torch, lambda: attention._mha_plain(q, k, v, scale), reps=3,
        rounds=3, graph=False)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    res["library_backends"] = sdpa_backends(torch, F, qt, kt, vt, scale)
    res["library_ms"], _ = time_ms(
        torch, lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                      scale=scale),
        reps=3, rounds=3, graph=False)
    ops = 4.0 * b * heads * nq * nk * dh
    nbytes = (2 * b * nq + 2 * b * nk) * heads * dh * q.element_size()
    res.update(_bound(ops, nbytes, dtype, exps=float(b * heads * nq * nk)))
    what = dict(kernel="mha", shape=[[b, nq, heads, dh], [b, nk, heads, dh]],
                dtype=dtype)
    chosen = attention._plan(b, nq, heads, dh, tdt, q.device)
    res.update(what, plan=list(chosen))
    records = [res]
    if all_plans:
        records += plan_records(torch, attention.mha, (q, k, v, scale),
                                every_plan(attention, dtype, dh), want,
                                dtype, what, chosen)
    del want
    return records


def misaligned(torch, t):
    """A contiguous copy of ``t`` whose data starts one element past a
    16-byte boundary (kernel E then copies 4 bytes at a time)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


def jbu_case(torch, jbu, b, h, w, c, k, seed, aligned: bool = True):
    """Check and time kernel E at one shape (f32, temp 0.5, sigma 0.8, as
    the drawn probes carry), with hr and proj 16-byte aligned or not. No
    single PyTorch call computes this function, so there is no library
    time."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    hr = torch.randn((b, h, w, c), generator=g, device="cuda")
    proj = torch.randn((b, h, w, k), generator=g, device="cuda")
    if not aligned:
        hr, proj = misaligned(torch, hr), misaligned(torch, proj)
    temp = torch.full((), 0.5, device="cuda")
    sigma = torch.full((), 0.8, device="cuda")
    got = jbu.jbu_filter(hr, proj, temp, sigma)
    want = jbu._jbu_plain(hr, proj, temp, sigma)
    torch.cuda.synchronize()
    res = compare(torch, got, want, "float32", float(hr.abs().max()))
    del got, want
    res["ms"], res["timing"] = time_ms(
        torch, lambda: jbu.jbu_filter(hr, proj, temp, sigma))
    res["plain_ms"], _ = time_ms(
        torch, lambda: jbu._jbu_plain(hr, proj, temp, sigma), reps=3,
        rounds=3, graph=False)
    res["library_ms"] = None
    px = b * h * w
    # 49 taps of a K-wide dot and a C-wide weighted sum, 2 ops a product;
    # hr and proj read once, out written once
    res.update(_bound(2.0 * jbu.NTAP * (k + c) * px, 4.0 * (2 * c + k) * px,
                      "float32"))
    res.update(kernel="jbu_filter", shape=[b, h, w, c], key_dim=k,
               dtype="float32", aligned=aligned)
    return res


def _bound(ops: float, nbytes: float, op_dtype: str,
           exps: float = 0.0) -> dict:
    """The least time for the work: the largest of the products (or other
    operations) at the dtype's peak, the exps at the special-function rate
    and the bytes at the memory rate; ``bound_by`` names which."""
    times = {"operations": ops / PEAK_OPS_PER_S[op_dtype] * 1e3,
             "exps": exps / PEAK_EXPS_PER_S * 1e3,
             "bytes": nbytes / PEAK_BYTES_PER_S * 1e3}
    by = max(times, key=times.get)
    return {"bound_ms": times[by], "bound_by": by, "ops": ops,
            "exps": exps, "bytes": nbytes}


def scene(seed: int, hw=(480, 640)):
    """A numpy-drawn image with one elliptic object (uint8 image, int mask)."""
    rng = np.random.default_rng(seed)
    img = (rng.random((*hw, 3)) * 90).astype(np.uint8)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    cy, cx = rng.uniform(0.3, 0.7) * hw[0], rng.uniform(0.3, 0.7) * hw[1]
    ry, rx = rng.uniform(0.15, 0.3) * hw[0], rng.uniform(0.15, 0.3) * hw[1]
    gt = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1).astype(np.int32)
    img[gt == 1] = rng.integers(130, 255, size=3)
    return img, gt


class Scenes:
    """Scenes in the shape ``evaluate_dataset`` reads: one object each."""

    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def get_sample(self, index):
        image, gt = self.scenes[index]
        return types.SimpleNamespace(image=image, objects_ids=[1],
                                     gt_mask=lambda _: gt)


def check_probs(image, gt, probs, *_):
    """evaluate_sample callback: every answer is a probability map."""
    if probs.shape != gt.shape or not np.isfinite(probs).all() or (
            probs.min() < 0 or probs.max() > 1):
        fail("predictor returned bad probabilities")


def calibrate_classifier(torch, model, size: int,
                         share: float = POSITIVE_SHARE) -> float:
    """Set the classifier bias of a drawn probe so that ``share`` of one
    seeded scene's pixels (one click) are positive. A drawn probe's
    logits share one sign over the frame (its head's ReLU features have a
    common positive mean), so every click would answer the same mask and
    every trajectory would be flat; with a small positive share the mask is
    a few compact blobs that the ZoomIn ROI follows, so masks answer the
    crop, the clicks and the previous mask, the ROI moves and lanes stop at
    different clicks. Returns the bias."""
    img, _ = scene(7, (size, size))
    x = np.concatenate([img.astype(np.float32) / 255.0,
                        np.zeros((size, size, 1), np.float32)], axis=-1)
    pts = np.full((1, 40, 3), -1.0, np.float32)
    pts[0, 0] = (size / 2, size / 2, 0)
    with torch.no_grad():
        logits = model(torch.from_numpy(x[None]).cuda(),
                       torch.from_numpy(pts).cuda())["instances"]
        cut = torch.quantile(logits.float().flatten(), 1.0 - share)
        model.head.classifier.bias.sub_(cut)
    return float(model.head.classifier.bias.detach())


def click_lanes(n: int, hw, seed: int):
    """Random clicker inputs: elliptic ground truths with an ignore band,
    predictions that are other ellipses with 1% noise, a few clicked
    pixels; lane 0 has no error at all."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:hw[0], :hw[1]]

    def ellipse():
        cy, cx = rng.uniform(0.2, 0.8) * hw[0], rng.uniform(0.2, 0.8) * hw[1]
        ry, rx = rng.uniform(0.1, 0.3) * hw[0], rng.uniform(0.1, 0.3) * hw[1]
        return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1

    gts, preds, ncs = [], [], []
    for lane in range(n):
        obj = ellipse()
        gt = obj.astype(np.int32)
        if lane % 2:
            gt[:, rng.integers(0, hw[1] - 20):][:, :20] = -1
        pred = ellipse() ^ (rng.random(hw) < 0.01)
        if lane == 0:
            pred = obj.copy()
        gts.append(gt), preds.append(pred)
        ncs.append(rng.random(hw) > 0.001)
    return np.stack(gts), np.stack(preds), np.stack(ncs)


def pick_target(trajectories, max_clicks: int):
    """The target IoU, from trajectories run to ``max_clicks``, at which the
    lanes stop at the most distinct clicks, at least STOP_MARGIN from every
    IoU reached. Returns (target, the stop click of each lane); fails when
    no target stops the lanes at two different clicks."""
    best = find_target(trajectories, max_clicks)
    if best is None:
        fail(f"no target IoU stops the lanes at different clicks: "
             f"{trajectories}")
    return best


def find_target(trajectories, max_clicks: int):
    """As ``pick_target``; None when no target splits the lanes."""
    values = sorted({float(v) for t in trajectories for v in t})
    best = None
    for lo, hi in zip(values, values[1:]):
        if hi - lo < 2 * STOP_MARGIN:
            continue
        t = 0.5 * (lo + hi)
        stops = [next((k + 1 for k, v in enumerate(traj) if v >= t),
                      max_clicks) for traj in trajectories]
        key = (len(set(stops)), hi - lo)
        if best is None or key > best[0]:
            best = (key, t, stops)
    if best is None or best[0][0] < 2:
        return None
    return best[1], best[2]


def same_trajectories(got, want, tol: float, what: str) -> float:
    """Fail unless click counts are equal and IoUs within ``tol``; returns
    the largest IoU difference."""
    if [len(a) for a in got] != [len(b) for b in want]:
        fail(f"{what}: click counts {[len(a) for a in got]} != "
             f"{[len(b) for b in want]}")
    err = max((float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(got, want) if len(a)), default=0.0)
    if err > tol:
        fail(f"{what}: IoUs differ by {err} > {tol}")
    return err


def time_clicks(predictor) -> list:
    """Wrap ``predictor.get_prediction`` so that the host seconds of each
    call (it ends in a device-to-host copy) go to the returned list."""
    click_s: list = []
    timed = predictor.get_prediction

    def get_prediction(clicker):
        t = time.perf_counter()
        out = timed(clicker)
        click_s.append(time.perf_counter() - t)
        return out

    predictor.get_prediction = get_prediction
    return click_s


def first_chunk(torch, device_eval, scenes, batch: int) -> list:
    """The device loop's (image, gt, valid) inputs for the first ``batch``
    scenes, on the card."""
    jobs = [device_eval._pad_job(img, gt, 64) for img, gt in scenes[:batch]]
    chunk = [torch.from_numpy(np.stack([j[k] for j in jobs])).cuda()
             for k in range(3)]
    torch.cuda.synchronize()
    return chunk


def sync_checked_run(torch, run, chunk, want, what: str) -> dict:
    """One whole device-loop evaluation of ``chunk`` under
    ``torch.cuda.set_sync_debug_mode("error")``, which the loop lifts only
    around its one allowed read per click: any other synchronising op, a
    debugger that does not catch a read, or trajectories other than
    ``want`` fail the run."""
    steps0, reads0 = run.steps, run.host_reads
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:  # the debugger is live: a plain read must raise
            bool(chunk[2].sum() > 0)
            live = False
        except RuntimeError:
            live = True
        ious, n = run(*chunk)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    steps, reads = run.steps - steps0, run.host_reads - reads0
    if not live:
        fail("set_sync_debug_mode('error') did not catch a device read")
    if reads != steps + 1:
        fail(f"{what}: {reads} host reads in {steps} loop steps")
    ious, n = ious.cpu().numpy(), n.cpu().numpy()
    same_trajectories([ious[i][: int(n[i])] for i in range(len(n))], want,
                      CACHE_TOL, f"{what}: sync-checked run")
    return {"steps": steps, "host_reads": reads, "debugger_live": live}


def forward_vs_cpu(torch, model, cpu_model, size: int, per_forward: dict,
                   what: str, cpu_batch: int = 2) -> tuple:
    """One f32 forward at B=2 on the card: it must launch exactly
    ``per_forward``, give finite logits of the crop's shape, and agree
    within FORWARD_RTOL of the logit scale with the CPU forward of its
    first ``cpu_batch`` samples (lanes are independent). Returns (image,
    points and logits on the card, the record)."""
    rng = np.random.default_rng(0)
    image = rng.random((2, size, size, 4), dtype=np.float32)
    points = np.full((2, 40, 3), -1.0, np.float32)
    points[:, 0] = (200.0, 220.0, 0)
    points[0, 20] = (60.0, 400.0, 1)
    points[1, 1] = (300.0, 120.0, 1)
    img_d = torch.from_numpy(image).cuda()
    pts_d = torch.from_numpy(points).cuda()
    with torch.inference_mode():
        zero_counters()
        logits = model(img_d, pts_d)["instances"]
        torch.cuda.synchronize()
        got = {k: v for k, v in counters().items() if v}
        t0 = time.time()
        ref = cpu_model(torch.from_numpy(image[:cpu_batch]),
                        torch.from_numpy(points[:cpu_batch]))["instances"]
        cpu_s = time.time() - t0
        f32_ms, _ = time_ms(torch, lambda: model(img_d, pts_d), reps=3,
                            rounds=3, graph=False)
    err = float((logits[:cpu_batch].cpu() - ref).abs().max())
    scale = float(ref.abs().max())
    record = {"launches_per_forward": got, "max_abs_err_vs_cpu": err,
              "logit_scale": scale, "cpu_forward_s": cpu_s,
              "f32_forward_ms": f32_ms, "shape": list(logits.shape)}
    print(f"{what} forward", json.dumps(record))
    if tuple(logits.shape) != (2, size, size, 1) or not bool(
            torch.isfinite(logits).all()):
        fail(f"{what}: bad logits, shape {tuple(logits.shape)}")
    if err > FORWARD_RTOL * max(1.0, scale):
        fail(f"{what}: card forward disagrees with the CPU forward: {err} "
             f"(logit scale {scale})")
    if got != per_forward:
        fail(f"{what}: expected {per_forward} launches per forward, got "
             f"{got}")
    return img_d, pts_d, logits, record


def bf16_forward(torch, model, cfg: dict, img_d, pts_d, logits,
                 per_forward: dict, what: str) -> dict:
    """One forward of ``model`` with its params cast to bf16 (as evaluate.py
    casts them), on the f32 forward's inputs: finite logits of the same
    shape within BF16_LOGIT_RTOL of the f32 logits' scale, with exactly
    ``per_forward`` launches; timed. Returns (the bf16 model, the
    record)."""
    from isegprobe_torch.models.probe_model import iSegProbeModel

    model16 = iSegProbeModel(**cfg).eval()
    model16.load_state_dict(model.state_dict())
    model16.to(torch.bfloat16)
    with torch.inference_mode():
        zero_counters()
        got = model16(img_d, pts_d)["instances"]
        torch.cuda.synchronize()
        launches = {k: v for k, v in counters().items() if v}
        ms, _ = time_ms(torch, lambda: model16(img_d, pts_d), reps=3,
                        rounds=3, graph=False)
    diff = float((got.float() - logits).abs().max())
    scale = float(logits.abs().max())
    record = {"launches_per_forward": launches, "bf16_forward_ms": ms,
              "bf16_vs_f32_max_abs_logit_diff": diff,
              "f32_logit_scale": scale, "shape": list(got.shape)}
    print(f"{what} bf16 forward", json.dumps(record))
    if got.shape != logits.shape or not bool(torch.isfinite(got).all()):
        fail(f"{what}: bad bf16 logits, shape {tuple(got.shape)}")
    if launches != per_forward:
        fail(f"{what}: expected {per_forward} launches per bf16 forward, "
             f"got {launches}")
    if diff > BF16_LOGIT_RTOL * scale:
        fail(f"{what}: bf16 forward differs from the f32 forward by {diff} "
             f"(logit scale {scale})")
    return model16, record


def kernel_wrappers() -> dict:
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from isegprobe_torch.ops import attention, attn_variants, edt, jbu
    from isegprobe_torch.ops import layernorm

    return {"edt_row_envelope": edt.row_envelope,
            "mha_qkv": attention.mha_qkv, "layernorm": layernorm.layernorm,
            "mha": attention.mha, "jbu_filter": jbu.jbu_filter,
            "mha_qkv_nodiv": attn_variants.mha_qkv_nodiv,
            "mha_qkv_merged": attn_variants.mha_qkv_merged}


def counters() -> dict:
    return {k: w.launches for k, w in kernel_wrappers().items()}


def zero_counters() -> None:
    for w in kernel_wrappers().values():
        w.launches = 0


def expected(**counts) -> dict:
    """A full counter dict: the given launches, 0 for every other kernel."""
    return {k: counts.get(k, 0) for k in KERNELS}


def profile_forward(torch, model, crops, pts) -> dict:
    """Device time of one forward by kernel, from ``torch.profiler``: the
    sum of every kernel's self device time, grouped (the port's kernels by
    name; cuDNN convolutions, GEMMs, the rest), the ten longest kernels, and
    the device-busy share of the profiled forward's wall time. Empty when
    the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        model(crops, pts)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    # kernels only: an operator's self device time repeats its kernels'
    kernels = [e for e in events if "CUDA" in str(e.device_type)] or [
        e for e in events if not e.key.startswith("aten::")]
    rows = [(e.self_device_time_total / 1e3, e.key, e.count)
            for e in kernels]
    if not rows:
        return {}
    groups = {"D mha_kernel": "mha_kernel", "A attn_qkv": "attn_qkv_",
              "B ln_kernel": "ln_kernel",
              "E jbu_kernel": "jbu_kernel", "C edt": "edt"}
    out: dict = {k: 0.0 for k in groups}
    out.update(conv=0.0, gemm=0.0, other=0.0)
    for ms, key, _ in rows:
        name = next((g for g, pat in groups.items() if pat in key), None)
        low = key.lower()
        if name is None:  # implicit-GEMM convolutions name both
            name = ("conv" if "conv" in low or "fprop" in low
                    or "cudnn" in low
                    else "gemm" if "gemm" in low or "cutlass" in low
                    else "other")
        out[name] += ms
    total = sum(ms for ms, _, _ in rows)
    rows.sort(reverse=True)
    return {"device_ms": total, "wall_ms": wall_ms,
            "busy_share": total / wall_ms, "by_group_ms": out,
            "top": [[round(ms, 4), key[:90], n] for ms, key, n in rows[:10]]}


def learned_family(torch, name: str) -> dict:
    """Main paths 3-6: one learned-upsampler family (DINOv2-S/14 + LoftUp or
    JBU-FeatUp at FAMILY_SIZE², drawn from seed 0 and calibrated) through
    the card's forward against the CPU, the host protocol and the device
    loop, with exact launch counts on each path, and the split of one loop
    step."""
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.evaluation import (
        evaluate_dataset,
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.ops.resize import resize

    per_forward = FORWARD_LAUNCHES[name]
    size = (FAMILY_SIZE, FAMILY_SIZE)
    res: dict = {}
    cfg = dict(flagship_config(size), upsampler_cfg=UPSAMPLERS[name])
    model = init_params(iSegProbeModel(**cfg), seed=0).eval()
    res["classifier_bias"] = calibrate_classifier(
        torch, model, FAMILY_SIZE, FAMILY_POSITIVE_SHARE)
    cpu_model = iSegProbeModel(**cfg, device="cpu").eval()
    cpu_model.load_state_dict(model.state_dict())
    # the CPU forward of the first sample alone: it takes tens of seconds
    img_d, pts_d, logits, res["forward"] = forward_vs_cpu(
        torch, model, cpu_model, FAMILY_SIZE, per_forward, name, cpu_batch=1)
    del cpu_model
    if name == "loftup":
        res["bf16_forward"] = bf16_forward(torch, model, cfg, img_d, pts_d,
                                           logits, per_forward, name)[1]

    # main path: the host predictor answers NoC clicks
    predictor = Predictor(model, target_size=size, with_flip=True,
                          net_clicks_limit=20)
    evaluate_sample(*scene(10), predictor, max_iou_thr=2.0, max_clicks=1)
    click_s = time_clicks(predictor)
    sample_s: list = []
    zero_counters()
    all_ious, _ = evaluate_dataset(Scenes([scene(11)]), predictor,
                                   latencies=sample_s, max_iou_thr=0.95,
                                   max_clicks=3, callback=check_probs)
    host_launches = counters()
    n_clicks = sum(len(a) for a in all_ious)
    if host_launches != expected(**{k: v * n_clicks
                                    for k, v in per_forward.items()}):
        fail(f"{name}: host protocol launched {host_launches} for "
             f"{n_clicks} clicks")
    res["host"] = {"clicks": n_clicks, "launches": host_launches,
                   "ious": [[float(v) for v in a] for a in all_ious],
                   "per_click": latency_percentiles(click_s),
                   "per_click_protocol": latency_percentiles(sample_s)}
    print(f"{name} host", json.dumps(res["host"]))

    # main path: the batched on-device loop at B=FAMILY_BATCH
    loop_scenes = [scene(20 + i) for i in range(FAMILY_JOBS)]

    def evaluator(batch, target):
        return device_eval.make_device_evaluator(
            model, target_size=size, batch_size=batch,
            target_iou=target, net_clicks_limit=20,
            max_clicks=FAMILY_CLICKS)

    probe = device_eval.evaluate_dataset_device(
        evaluator(FAMILY_BATCH, 2.0), Scenes(loop_scenes))
    found = find_target(probe, FAMILY_CLICKS)
    # a drawn probe whose lanes never split runs every lane to the end
    target, stops = found or (2.0, [FAMILY_CLICKS] * len(loop_scenes))
    run = evaluator(FAMILY_BATCH, target)
    zero_counters()
    t0 = time.time()
    got = device_eval.evaluate_dataset_device(run, Scenes(loop_scenes))
    wall = time.time() - t0
    loop_launches = counters()
    want = expected(edt_row_envelope=run.steps,
                    **{k: v * run.steps for k, v in per_forward.items()})
    if loop_launches != want:
        fail(f"{name}: device loop launched {loop_launches} in {run.steps} "
             f"steps, expected {want}")
    lengths = [len(a) for a in got]
    if lengths != stops:
        fail(f"{name}: lanes stopped at {lengths}, expected {stops}")
    got1 = device_eval.evaluate_dataset_device(evaluator(1, target),
                                               Scenes(loop_scenes))
    err_b1 = same_trajectories(got, got1, LOOP_IOU_TOL,
                               f"{name}: B={FAMILY_BATCH} vs B=1")
    host_idx = sorted({int(np.argmin(lengths)), int(np.argmax(lengths))})
    host_pred = Predictor(model, target_size=size, with_flip=True,
                          net_clicks_limit=20)
    host = [evaluate_sample(*loop_scenes[i], host_pred, max_iou_thr=target,
                            pred_thr=0.49, max_clicks=FAMILY_CLICKS)[1]
            for i in host_idx]
    err_host = same_trajectories([got[i] for i in host_idx], host,
                                 LOOP_IOU_TOL, f"{name}: loop vs Predictor")
    res["device_loop"] = {
        "batch": FAMILY_BATCH, "jobs": FAMILY_JOBS, "target_iou": target,
        "target_splits_lanes": found is not None, "lengths": lengths,
        "steps": run.steps, "host_reads": run.host_reads,
        "launches": loop_launches, "wall_s": wall,
        "ms_per_step": 1e3 * wall / run.steps,
        "lane_clicks_per_s": sum(lengths) / wall,
        "ious": [[float(v) for v in a] for a in got],
        "max_iou_diff_vs_b1": err_b1, "host_compared": host_idx,
        "max_iou_diff_vs_host": err_host}
    print(f"{name} device_loop", json.dumps(
        {k: v for k, v in res["device_loop"].items() if k != "ious"}))

    chunk = first_chunk(torch, device_eval, loop_scenes, FAMILY_BATCH)
    if name == "jbu_featup":
        # no hidden syncs in this family's click either
        res["sync_check"] = sync_checked_run(torch, run, chunk,
                                             got[:FAMILY_BATCH], name)
        print(f"{name} sync_check", json.dumps(res["sync_check"]))

    # the split of one loop step (forward at batch 2·B): backbone with the
    # click encoding, upsampler, head (with JBU's resize to the crop size)
    with torch.inference_mode():
        st = run._init_state(*chunk)
        sel, pts_full = run._select(st)
        crops, pts = run._crop_points(st["image"], st["prev"], sel["roi"],
                                      pts_full)
        image_n, prev = model.prepare_input(crops)

        def backbone():
            coords = model.get_coord_features(image_n, prev, pts)
            return model.backbone(image_n, model.embed_coords(coords))

        feats = backbone()
        hr = model.upsampler(feats, image_n)

        def head():
            f = hr
            if f.shape[1:3] != size:
                f = resize(f, size, "bilinear", align_corners=True)
            return model.head(f)

        slow = dict(reps=1, rounds=3, graph=False)
        split = {"batch": int(crops.shape[0]),
                 "backbone_ms": time_ms(torch, backbone, **slow)[0],
                 "upsampler_ms": time_ms(
                     torch, lambda: model.upsampler(feats, image_n),
                     **slow)[0],
                 "head_ms": time_ms(torch, head, **slow)[0],
                 "forward_ms": time_ms(torch, lambda: model(crops, pts),
                                       **slow)[0],
                 "loop_ms_per_step": res["device_loop"]["ms_per_step"]}
        split["profile"] = profile_forward(torch, model, crops, pts)
    print(f"{name} step_split", json.dumps(split))
    res["step_split"] = split
    res["path_launches"] = {f"{name}_host": host_launches,
                            f"{name}_loop": loop_launches}
    if "bf16_forward" in res:
        res["path_launches"][f"{name}_bf16_forward"] = expected(
            **res["bf16_forward"]["launches_per_forward"])
    return res


def against_fixture(ious, clicks, want_ious, want_n, want_clicks,
                    what: str, max_diverged: int) -> dict:
    """Hold per-object trajectories against the JAX package's (the
    fixture's): each object's IoUs within LOOP_IOU_TOL up to its first click
    that differs from JAX's in position or sign (or where one run stops and
    the other clicks on), all of them where none does; at most
    ``max_diverged`` objects may differ at all, each printed."""
    diverged, err = [], 0.0
    for i, (got_i, got_c) in enumerate(zip(ious, clicks)):
        n = int(want_n[i])
        want_c = [tuple(int(v) for v in c) for c in want_clicks[i, :n]]
        got_c = [tuple(int(v) for v in c) for c in got_c]
        k = next((j for j, (a, b) in enumerate(zip(got_c, want_c))
                  if a != b), None)
        if k is None and len(got_c) != n:
            k = min(len(got_c), n)
        upto = len(got_c) if k is None else k
        if upto:
            err = max(err, float(np.abs(np.asarray(got_i[:upto])
                                        - want_ious[i, :upto]).max()))
        if k is not None:
            diverged.append({"object": i, "click": k + 1,
                             "got": got_c[k] if k < len(got_c) else "stop",
                             "want": want_c[k] if k < n else "stop"})
    for d in diverged:
        print(f"{what}: object {d['object']} clicks differently from JAX at "
              f"click {d['click']}: {d['got']} (y, x, positive) here, "
              f"{d['want']} in JAX")
    if err > LOOP_IOU_TOL:
        fail(f"{what}: IoUs differ from JAX's by {err} > {LOOP_IOU_TOL} "
             f"before any click differs")
    if len(diverged) > max_diverged:
        fail(f"{what}: {len(diverged)} objects click differently from JAX "
             f"(at most {max_diverged} allowed)")
    return {"max_iou_diff_before_divergence": err, "diverged": diverged}


def trained_phase(torch, cuda) -> dict:
    """Main paths of the trained probes: the 160-epoch flagship checkpoint
    and the 448² LoftUp one, loaded through ``isegprobe_torch.evaluate.
    load_model_for_eval`` (frozen parts rebuilt from PRNGKey(0) in numpy)
    and held against the JAX package's results on the stored Synthetic
    scenes (``isegprobe_torch/fixtures/synthetic2026_50.npz``): the f32
    device loop on every object, the host protocol on the first
    TRAINED_HOST_OBJECTS, the bf16 loops as a report, and LoftUp's f32 loop
    on the fixture's objects, then timed on every object. Returns the
    records, the path launches and the kernel checks at the paths'
    shapes."""
    import warnings

    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.evaluation import (
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.metrics import compute_noc_metric
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.upsamplers.loftup import LN_EPS
    from isegprobe_torch.ops import attention, edt, layernorm
    from isegprobe_torch.scripts import bench_edt

    F = torch.nn.functional
    res: dict = {}
    fx = dict(np.load(SYNTHETIC_FIXTURE))
    data = SceneDataset(SYNTHETIC_FIXTURE)
    n_obj = data.n_objects
    # kernels A-D at the shapes these paths give them: 224² scenes pad to
    # 256², so C's rows are 258 wide; the bf16 B=16 loop runs forwards of
    # 32 crops; LoftUp's loops of 2 and 4 lanes forwards of 4 and 8, whose
    # LayerNorms run 404 wide on a slab's 64 × 448 query rows and the 32²
    # key rows, 203 wide on the stem's 68 × 448 rows, 384 in the
    # ChannelNorm
    side = TRAINED_SCENE + 2
    fwd32 = 2 * 2 * TRAINED_BATCH
    checks = [edt_case(torch, edt, bench_edt.column_input(
        "clicker", (b, 2, side, side), cuda, seed=50 + b), "clicker")
        for b in (TRAINED_BATCH, 2 * TRAINED_BATCH)]
    checks += cross_attention_case(torch, F, attention,
                                   2 * TRAINED_LOFTUP_OBJECTS, 64 * 448, 1024,
                                   4, 101, "float32", seed=52)
    checks += attention_case(torch, F, attention, fwd32, 1025, 6, 64,
                             "bfloat16", seed=53)
    checks.append(layernorm_case(torch, F, layernorm, (fwd32, 1025), 384,
                                 "bfloat16", seed=54))
    seed = 55
    for b in (2 * TRAINED_LOFTUP_OBJECTS, 2 * FAMILY_BATCH):
        for rows, d in (((64 * 448,), 404), ((1024,), 404),
                        ((68, 448), 203), ((1024,), 384)):
            checks.append(layernorm_case(torch, F, layernorm, (b, *rows), d,
                                         "float32", seed=seed, eps=LN_EPS))
            seed += 1

    def evaluator(model, batch, max_clicks=TRAINED_CLICKS,
                  record_clicks=False):
        return device_eval.make_device_evaluator(
            model, target_size=(448, 448), batch_size=batch,
            max_clicks=max_clicks, net_clicks_limit=max_clicks,
            pred_thr=TRAINED_THRESH, target_iou=TRAINED_TARGET,
            record_clicks=record_clicks)

    def noc_of(all_ious, max_clicks=TRAINED_CLICKS):
        return compute_noc_metric(all_ious, [0.8, 0.85, 0.9],
                                  max_clicks)[0]

    want_noc = [float(v) for v in fx["flagship_noc"]]
    models = {}
    for dtype in ("float32", "bfloat16"):
        t0 = time.time()
        models[dtype], info = load_model_for_eval(
            TRAINED_CKPTS["flagship"], getattr(torch, dtype), (448, 448))
        res[f"load_{dtype}"] = {"load_s": time.time() - t0,
                                "init_tree_s": info["init_seconds"],
                                "frozen_params": info["frozen_params"]}
        print(f"trained flagship {dtype}: init tree built in "
              f"{info['init_seconds']:.2f} s, {info['frozen_params']:,} "
              f"frozen parameters, loaded in {time.time() - t0:.2f} s")
        if info["frozen_params"] != TRAINED_FROZEN["flagship"]:
            fail(f"trained flagship: {info['frozen_params']} frozen "
                 f"parameters, expected {TRAINED_FROZEN['flagship']}")

    # the device loops: f32 at B=8, held against JAX; bf16 at B=8 and 16
    paths, loops = {}, []
    for dtype, batch in (("float32", TRAINED_BATCH),
                         ("bfloat16", TRAINED_BATCH),
                         ("bfloat16", 2 * TRAINED_BATCH)):
        model = models[dtype]
        device_eval.evaluate_dataset_device(  # warm-up: per-device constants
            evaluator(model, batch, max_clicks=1), data)
        gated = dtype == "float32"  # only the f32 loop is held against JAX
        run = evaluator(model, batch, record_clicks=gated)
        clicks = [] if gated else None
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.time()
        got = device_eval.evaluate_dataset_device(run, data, clicks=clicks)
        wall = time.time() - t0
        launches = counters()
        want = expected(**{k: v * run.steps for k, v in PER_STEP.items()})
        if launches != want:
            fail(f"trained {dtype} B={batch} loop launched {launches} in "
                 f"{run.steps} steps, expected {want}")
        if len(got) != n_obj or not all(
                np.isfinite(a).all() and 1 <= len(a) <= TRAINED_CLICKS
                for a in got):
            fail(f"trained {dtype} B={batch} loop: bad trajectories")
        n_clicks = sum(len(a) for a in got)
        rec = {"dtype": dtype, "batch": batch, "objects": len(got),
               "steps": run.steps, "clicks": n_clicks, "wall_s": wall,
               "ms_per_step": 1e3 * wall / run.steps,
               "lane_clicks_per_s": n_clicks / wall, "noc": noc_of(got),
               "jax_cpu_noc": want_noc, "launches": launches,
               "records_clicks": gated}
        if gated:
            rec.update(against_fixture(
                got, clicks, fx["flagship_ious"], fx["flagship_n"],
                fx["flagship_clicks"], "trained f32 device loop",
                TRAINED_MAX_DIVERGED))
            gap = max(abs(a - b) for a, b in zip(rec["noc"], want_noc))
            if gap > TRAINED_NOC_TOL:
                fail(f"trained f32 NoC@80/85/90 {rec['noc']} differ from "
                     f"JAX's {want_noc} by {gap} > {TRAINED_NOC_TOL}")
        print("trained_loop", json.dumps(
            {k: v for k, v in rec.items() if k != "diverged"}))
        print(f"trained flagship {dtype} B={batch}: NoC@80/85/90 "
              + " / ".join(f"{v:.4f}" for v in rec["noc"]) + " (JAX f32 "
              "on the CPU: " + " / ".join(f"{v:.4f}" for v in want_noc)
              + f"), {rec['lane_clicks_per_s']:.2f} lane-clicks/s, "
              f"{rec['ms_per_step']:.3f} ms/step")
        loops.append(rec)
        paths[f"trained_loop_{dtype}_b{batch}"] = launches
    res["device_loops"] = loops

    # the host protocol, f32, on the first objects
    predictor = Predictor(models["float32"], target_size=(448, 448),
                          with_flip=True, net_clicks_limit=TRAINED_CLICKS)
    host_data = SceneDataset(SYNTHETIC_FIXTURE,
                             objects=slice(0, TRAINED_HOST_OBJECTS))
    samples = [host_data.get_sample(i) for i in range(len(host_data))]
    evaluate_sample(samples[0].image, samples[0].gt_mask(0), predictor,
                    max_iou_thr=2.0, max_clicks=1)  # warm-up
    click_s = time_clicks(predictor)
    per_click, host_ious, host_clicks = [], [], []
    zero_counters()
    for sample in samples:
        t0 = time.time()
        cl, ious, _ = evaluate_sample(
            sample.image, sample.gt_mask(0), predictor,
            max_iou_thr=TRAINED_TARGET, pred_thr=TRAINED_THRESH,
            max_clicks=TRAINED_CLICKS)
        per_click.append((time.time() - t0) / len(ious))
        host_ious.append(ious)
        host_clicks.append([(*c.coords, int(c.is_positive)) for c in cl])
    host_launches = counters()
    n_clicks = sum(len(a) for a in host_ious)
    if host_launches != expected(mha_qkv=12 * n_clicks,
                                 layernorm=25 * n_clicks):
        fail(f"trained host protocol launched {host_launches} for "
             f"{n_clicks} clicks")
    k = TRAINED_HOST_OBJECTS
    host = {"objects": k, "clicks": n_clicks, "launches": host_launches,
            "per_get_prediction": latency_percentiles(click_s),
            "per_click_protocol": latency_percentiles(per_click),
            **against_fixture(host_ious, host_clicks, fx["flagship_ious"][:k],
                              fx["flagship_n"][:k],
                              fx["flagship_clicks"][:k],
                              "trained f32 host protocol",
                              TRAINED_MAX_DIVERGED)}
    print("trained_host", json.dumps(host))
    print(f"trained host protocol: p50 "
          f"{host['per_click_protocol']['p50_ms']:.3f} ms per click, "
          f"{host['per_get_prediction']['p50_ms']:.3f} ms per "
          "get_prediction")
    res["host"] = host
    paths["trained_host"] = host_launches
    del models, predictor

    # LoftUp: its configured upsampler_path is missing, so it must warn and
    # keep the PRNGKey(0) upsampler, as the JAX package's evaluation did
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.time()
        model, info = load_model_for_eval(TRAINED_CKPTS["loftup"],
                                          torch.float32, (448, 448))
        load_s = time.time() - t0
    warned = [str(w.message) for w in caught
              if "upsampler_path" in str(w.message)]
    print(f"trained LoftUp: init tree built in {info['init_seconds']:.2f} s, "
          f"{info['frozen_params']:,} frozen parameters; warned: {warned}")
    if not warned:
        fail("trained LoftUp: no warning for its missing upsampler_path")
    if info["frozen_params"] != TRAINED_FROZEN["loftup"]:
        fail(f"trained LoftUp: {info['frozen_params']} frozen parameters, "
             f"expected {TRAINED_FROZEN['loftup']}")
    per_step = dict(edt_row_envelope=1, **FORWARD_LAUNCHES["loftup"])

    def loftup_loop(dataset, batch, max_clicks, clicks):
        run = evaluator(model, batch, max_clicks=max_clicks,
                        record_clicks=clicks is not None)
        torch.cuda.synchronize()
        zero_counters()
        t0 = time.time()
        got = device_eval.evaluate_dataset_device(run, dataset,
                                                  clicks=clicks)
        wall = time.time() - t0
        launches = counters()
        want = expected(**{k: v * run.steps for k, v in per_step.items()})
        if launches != want:
            fail(f"trained LoftUp B={batch} loop launched {launches} in "
                 f"{run.steps} steps, expected {want}")
        return got, {"objects": len(got), "batch": batch,
                     "max_clicks": max_clicks, "steps": run.steps,
                     "clicks": sum(len(a) for a in got), "wall_s": wall,
                     "ms_per_step": 1e3 * wall / run.steps,
                     "launches": launches}

    # against JAX on the fixture's objects, then timed on every object
    m = TRAINED_LOFTUP_OBJECTS
    clicks = []
    got, loftup = loftup_loop(SceneDataset(SYNTHETIC_FIXTURE,
                                           objects=slice(0, m)),
                              m, TRAINED_LOFTUP_CLICKS, clicks)
    loftup.update(ious=[[float(v) for v in a] for a in got],
                  load_s=load_s, init_tree_s=info["init_seconds"],
                  frozen_params=info["frozen_params"],
                  **against_fixture(got, clicks, fx["loftup_ious"],
                                    fx["loftup_n"], fx["loftup_clicks"],
                                    "trained LoftUp f32 device loop", 0))
    print("trained_loftup", json.dumps(loftup))
    got, timed = loftup_loop(data, FAMILY_BATCH, FAMILY_CLICKS, None)
    if len(got) != n_obj or not all(
            np.isfinite(a).all() and 1 <= len(a) <= FAMILY_CLICKS
            for a in got):
        fail("trained LoftUp timed loop: bad trajectories")
    timed.update(lane_clicks_per_s=timed["clicks"] / timed["wall_s"],
                 noc=noc_of(got, FAMILY_CLICKS))
    print("trained_loftup_timed", json.dumps(timed))
    print(f"trained LoftUp f32 B={FAMILY_BATCH}, {n_obj} objects, <= "
          f"{FAMILY_CLICKS} clicks: {timed['ms_per_step']:.1f} ms/step, "
          f"{timed['lane_clicks_per_s']:.2f} lane-clicks/s, NoC@80/85/90 "
          + " / ".join(f"{v:.4f}" for v in timed["noc"]))
    res["loftup"] = loftup
    res["loftup_timed"] = timed
    paths["trained_loftup_loop"] = loftup["launches"]
    paths["trained_loftup_timed"] = timed["launches"]
    res["path_launches"] = paths
    res["checks"] = checks
    return res


def variant_sweep(torch, F) -> tuple:
    """Kernels F (nodiv) and G (merged) against their plain versions and
    bit for bit against each other and kernel A, at B=2, at the sweep's
    shape and at a ragged small shape; then
    main path 7, the sweep through its package entry, with every counter set
    to 0 just before and read just after: each variant launches its kernel
    exactly ``LAUNCHES_PER_VARIANT`` times. The checks at the sweep's shape
    take their kernel times from the sweep's records. Returns (the checks,
    the sweep's records, its launches)."""
    from isegprobe_torch.ops import attention, attn_variants
    from isegprobe_torch.scripts import bench_attn_variants as bav

    variant_checks = []
    for i, (b, n, heads) in enumerate(((2, 1025, 6), (bav.BATCH, bav.N,
                                                      bav.HEADS),
                                       (3, 77, 4))):
        for dtype in ("float32", "bfloat16"):
            variant_checks += variant_cases(
                torch, F, attention, attn_variants, b, n, heads, dtype,
                seed=40 + i, timed=b == bav.BATCH)
    for c in variant_checks:
        print("check", json.dumps(c))
    bad = [c for c in variant_checks if not c["ok"]]
    if bad:
        fail(f"kernel F or G disagrees with its plain version, or G with F "
             f"or F with kernel A bit for bit: {bad}")
    zero_counters()
    sweep = bav.main()
    sweep_launches = counters()
    per = bav.LAUNCHES_PER_VARIANT
    want = expected(**{k: per * sum(r["kernel"] == k for r in sweep)
                       for k in ("mha_qkv", "mha_qkv_nodiv",
                                 "mha_qkv_merged")})
    if sweep_launches != want:
        fail(f"the sweep launched {sweep_launches}, expected {want}")
    bad = [r for r in sweep if not r["ok"] or r["launches"] != per
           or not r["ms"] > 0]
    if bad:
        fail(f"sweep variants out of tolerance or untimed: {bad}")
    print("sweep", json.dumps({"records": sweep, "launches": sweep_launches}))
    ms = {(r["dtype"], r["variant"]): r["ms"] for r in sweep}
    for c in variant_checks:
        if "plain_ms" in c:
            suffix = "_ebf16" if c["expdt"] == "bfloat16" else ""
            c["ms"] = ms[(c["dtype"],
                          c["kernel"].removeprefix("mha_qkv_")
                          + f"{c['tile']}{suffix}")]
            c["timing"] = "cuda_graph (sweep)"
    return variant_checks, sweep, sweep_launches


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write every result to this JSON "
                        "file")
    args = parser.parse_args()

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1

    from isegprobe_torch.inference import device_eval
    from isegprobe_torch.inference.clicker import Clicker
    from isegprobe_torch.inference.evaluation import (
        evaluate_dataset,
        evaluate_sample,
        latency_percentiles,
    )
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.ops import attention, cuda_lib, edt, jbu, layernorm
    from isegprobe_torch.scripts import bench_edt

    t_start = time.time()
    results: dict = {}

    # 1. the card
    card = nvidia_smi()
    print(card)
    results["card"] = card
    results["device_name"] = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build every kernel from the checkout's sources
    t0 = time.time()
    reports = cuda_lib.build()
    results["build_s"] = time.time() - t0
    for name, log in reports.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C7515" in line:
                print(f"[ptxas {name}] {line.strip()}")
    print(f"built {sorted(reports) or 'nothing (cached)'} in "
          f"{results['build_s']:.1f} s")
    # wgmma serialized by ptxas (C7515) in the sources built by this run
    results["ptxas_c7515_lines"] = sum(
        "C7515" in line for log in reports.values()
        for line in log.splitlines())
    print(f"ptxas C7515 lines: {results['ptxas_c7515_lines']} (sources "
          f"built in this run: {sorted(reports)})")
    # kernel E's tiling and resources as its library reports them on this
    # card (whether or not this run built it: blocks an SM from CUDA's
    # occupancy calculator, local bytes for stack and spills), and its ptxas
    # entry where this run built it
    jbu_ptxas = next((v for n, v in cuda_lib.ptxas_entries(
        reports.get("jbu", "")).items() if "jbu_kernel" in n), None)
    jbu_config = jbu.kernel_config()
    results["jbu_ptxas"], results["jbu_config"] = jbu_ptxas, jbu_config
    print(f"kernel E: {json.dumps(jbu_config)}; "
          f"ptxas {json.dumps(jbu_ptxas)}")
    if "jbu" in reports and jbu_ptxas is None:
        fail("kernel E has no entry in its ptxas report")
    if jbu_config["local_bytes"] or (jbu_ptxas and (
            jbu_ptxas["spill_stores"] or jbu_ptxas["spill_loads"])):
        fail(f"kernel E spills: {jbu_config}, ptxas {jbu_ptxas}")
    if jbu_config["blocks_per_sm"] < 2:
        fail(f"kernel E fits fewer than the two blocks an SM of its design: "
             f"{jbu_config}")
    # kernel C's layout at the loop's row width, as its library reports it
    edt_ptxas = next((v for n, v in cuda_lib.ptxas_entries(
        reports.get("edt", "")).items() if "row_envelope_kernel" in n), None)
    edt_config = edt.kernel_config(EDT_SHAPE[-1])
    results["edt_ptxas"], results["edt_config"] = edt_ptxas, edt_config
    print(f"kernel C: {json.dumps(edt_config)}; "
          f"ptxas {json.dumps(edt_ptxas)}")
    if "edt" in reports and edt_ptxas is None:
        fail("kernel C has no entry in its ptxas report")
    if edt_config["local_bytes"] or (edt_ptxas and (
            edt_ptxas["spill_stores"] or edt_ptxas["spill_loads"])):
        fail(f"kernel C spills: {edt_config}, ptxas {edt_ptxas}")

    # 3. kernels A and B against their plain versions, timed beside them;
    # batch 16 is the device loop's forward (8 lanes, flip TTA)
    checks = []
    for dtype in ("float32", "bfloat16"):
        checks += attention_case(torch, F, attention, 2, 1025, 6, 64, dtype,
                                 seed=1, all_plans=True)
        checks.append(layernorm_case(torch, F, layernorm, (2, 1025), 384,
                                     dtype, seed=2))
        checks += attention_case(torch, F, attention, 2, 1025, 8, 32, dtype,
                                 seed=3, all_plans=True)
        checks += attention_case(torch, F, attention, 1, 513, 2, 128, dtype,
                                 seed=4, all_plans=True)
        checks += attention_case(torch, F, attention, 2 * LOOP_BATCH, 1025,
                                 6, 64, dtype, seed=5, all_plans=True)
    # an odd head width takes the element-load path in bf16
    checks += attention_case(torch, F, attention, 2, 1025, 3, 13,
                             "bfloat16", seed=7, all_plans=True)
    checks.append(layernorm_case(torch, F, layernorm, (2 * LOOP_BATCH, 1025),
                                 384, "float32", seed=6))

    # 4. kernel C against its plain version, bitwise: the three inputs of
    # bench_edt.py at the device loop's shape (random first: the kernels
    # line reads it), random masks at two more shapes, and the rest of its
    # domain (W = 4096 and 1, sentinel rows, single sources, g > 4096,
    # G > 2^30)
    cuda = torch.device("cuda")
    for i, (kind, shape) in enumerate((
            ("random", EDT_SHAPE), ("clicker", EDT_SHAPE),
            ("adversarial", EDT_SHAPE), ("random", (64, 64)),
            ("random", (3, 5, 37, 333)))):
        checks.append(edt_case(torch, edt, bench_edt.column_input(
            kind, shape, cuda, seed=10 + i), kind))
    for kind, gcol in bench_edt.domain_inputs(cuda, seed=15).items():
        checks.append(edt_case(torch, edt, gcol, kind, timed=False))

    # kernel D at LoftUp's slab (64 rows of 448 queries against 32² keys, 4
    # heads of 101) at B=2 and at the family loop's batch (flip TTA doubles
    # it), at a ragged Nq and Nk, and at dh=64; kernel E at the four JBU
    # stages at B=2, the last at the loop's batch, at a width and height
    # that are no multiple of 16, at C=100; at the tiling's edges: W one
    # past a strip of 8 and H one past a tile of 8 (and 16) rows, C=70 (no
    # multiple of 4: 4-byte copies), K=1, H = W = 4, and bases off 16-byte
    # alignment
    loop_fwd = 2 * FAMILY_BATCH
    for i, (b, nq, nk, heads, dh, dtype) in enumerate((
            (2, 64 * 448, 1024, 4, 101, "float32"),
            (2, 64 * 448, 1024, 4, 101, "bfloat16"),
            (loop_fwd, 64 * 448, 1024, 4, 101, "float32"),
            (loop_fwd, 64 * 448, 1024, 4, 101, "bfloat16"),
            (2, 1000, 777, 4, 101, "float32"),
            (2, 1000, 777, 4, 101, "bfloat16"),
            (2, 4096, 1024, 6, 64, "float32"),
            (2, 4096, 1024, 6, 64, "bfloat16"))):
        checks += cross_attention_case(torch, F, attention, b, nq, nk, heads,
                                       dh, dtype, seed=20 + i,
                                       all_plans=True)
    for i, (b, h, w, c) in enumerate((
            (2, 64, 64, 384), (2, 128, 128, 384), (2, 256, 256, 384),
            (2, 512, 512, 384), (loop_fwd, 512, 512, 384),
            (1, 60, 90, 384), (2, 64, 64, 100))):
        checks.append(jbu_case(torch, jbu, b, h, w, c, 32, seed=30 + i))
    for i, (b, h, w, c, k, aligned) in enumerate((
            (1, 17, 41, 384, 32, True), (2, 64, 64, 70, 32, True),
            (2, 40, 24, 384, 1, True), (3, 4, 4, 384, 32, True),
            (2, 33, 50, 384, 32, False))):
        checks.append(jbu_case(torch, jbu, b, h, w, c, k, seed=40 + i,
                               aligned=aligned))
    for c in checks:
        print("check", json.dumps(c))
    results["checks"] = checks
    bad = [c for c in checks if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # 5. full-width flagship forward: card vs CPU, launches per forward
    cfg = flagship_config((448, 448))
    model = init_params(iSegProbeModel(**cfg), seed=0).eval()
    results["classifier_bias"] = calibrate_classifier(torch, model, 448)
    cpu_model = iSegProbeModel(**cfg, device="cpu").eval()
    cpu_model.load_state_dict(model.state_dict())
    torch.set_num_threads(8)
    img_d, pts_d, logits, results["forward"] = forward_vs_cpu(
        torch, model, cpu_model, 448, FORWARD_LAUNCHES["flagship"],
        "flagship")

    # 6. main path 1: the host predictor answers NoC clicks
    scenes = [scene(11), scene(12)]
    predictor = Predictor(model, target_size=(448, 448), with_flip=True,
                          net_clicks_limit=20)
    evaluate_sample(*scene(10), predictor, max_iou_thr=2.0, max_clicks=1)
    click_s = time_clicks(predictor)
    sample_s: list = []  # per sample: wall time / clicks, clicker included
    zero_counters()
    all_ious, _ = evaluate_dataset(Scenes(scenes), predictor,
                                   latencies=sample_s, max_iou_thr=0.95,
                                   max_clicks=MAX_CLICKS,
                                   callback=check_probs)
    launches = counters()
    n_clicks = sum(len(ious) for ious in all_ious)
    if len(all_ious) != len(scenes) or not all(
            1 <= len(ious) <= MAX_CLICKS for ious in all_ious):
        fail("predictor trajectories have bad lengths")
    if launches != expected(mha_qkv=12 * n_clicks,
                            layernorm=25 * n_clicks):
        fail(f"main path launches {launches} for {n_clicks} clicks")

    # the first click of scene 0 against the CPU predictor
    cpu_pred = Predictor(cpu_model, target_size=(448, 448), with_flip=True,
                         net_clicks_limit=20, device="cpu")
    _, _, cpu_probs = evaluate_sample(*scenes[0], cpu_pred, max_iou_thr=2.0,
                                      max_clicks=1)
    gpu_pred = Predictor(model, target_size=(448, 448), with_flip=True,
                         net_clicks_limit=20)
    _, _, gpu_probs = evaluate_sample(*scenes[0], gpu_pred, max_iou_thr=2.0,
                                      max_clicks=1)
    probs_err = float(np.abs(gpu_probs - cpu_probs).max())
    if probs_err > PROBS_ATOL:
        fail(f"first-click probabilities differ from the CPU path by "
             f"{probs_err}")

    # one bf16 forward, params cast as evaluate.py casts them
    model_bf16, bf16_rec = bf16_forward(torch, model, cfg, img_d, pts_d,
                                        logits, FORWARD_LAUNCHES["flagship"],
                                        "flagship")
    noc = {"clicks": n_clicks,
           "ious": [[float(v) for v in ious] for ious in all_ious],
           "per_click": latency_percentiles(click_s),
           "per_click_protocol": latency_percentiles(sample_s),
           "main_path_launches": launches,
           "first_click_probs_err_vs_cpu": probs_err,
           "bf16_forward": bf16_rec}
    print("noc", json.dumps(noc))
    print(f"p50 per click: {noc['per_click']['p50_ms']:.3f} ms over "
          f"{n_clicks} clicks (f32, fixed-448 ZoomIn, flip TTA)")
    results["noc"] = noc

    # 7. the device clicker against the host scipy clicker, lane by lane
    gts, preds, ncs = click_lanes(32, (512, 640), seed=3)
    with torch.inference_mode():
        is_pos, cy, cx = edt.next_click_from_error(
            *(torch.from_numpy(a).cuda() for a in (gts == 1, preds, ncs,
                                                   gts != -1)))
    got = list(zip(is_pos.tolist(), cy.tolist(), cx.tolist()))
    want = []
    for gt, pred, nc in zip(gts, preds, ncs):
        clicker = Clicker(gt)
        clicker.not_clicked_map = nc.copy()
        click = clicker._get_next_click(pred)
        want.append((click.is_positive, *click.coords))
    mismatched = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
    results["clicker"] = {"lanes": len(got), "mismatched": mismatched,
                          "positives": int(sum(p for p, _, _ in got))}
    print("clicker", json.dumps(results["clicker"]))
    if mismatched:
        fail(f"device clicks differ from the host clicker in lanes "
             f"{mismatched}: {[(got[i], want[i]) for i in mismatched]}")

    # 8. main path 2: the batched on-device NoC loop at full width
    loop_scenes = [scene(20 + i) for i in range(LOOP_JOBS)]

    def evaluator(m, batch, target, **kw):
        kw.setdefault("max_clicks", LOOP_CLICKS)
        return device_eval.make_device_evaluator(
            m, target_size=(448, 448), batch_size=batch, target_iou=target,
            net_clicks_limit=20, **kw)

    probe = device_eval.evaluate_dataset_device(
        evaluator(model, LOOP_BATCH, 2.0), Scenes(loop_scenes))
    target, stops = pick_target(probe, LOOP_CLICKS)
    print(f"target IoU {target:.6f}: lanes stop at clicks {stops}")
    run8 = evaluator(model, LOOP_BATCH, target)
    lane_s: list = []
    zero_counters()
    t0 = time.time()
    got8 = device_eval.evaluate_dataset_device(run8, Scenes(loop_scenes),
                                               sample_times=lane_s)
    loop_wall = time.time() - t0
    loop_launches = counters()
    want_launches = expected(**{k: v * run8.steps
                                for k, v in PER_STEP.items()})
    if loop_launches != want_launches:
        fail(f"device loop launched {loop_launches} in {run8.steps} steps, "
             f"expected {want_launches}")
    lengths = [len(a) for a in got8]
    if lengths != stops or len(set(lengths)) < 2:
        fail(f"lanes stopped at {lengths}, expected {stops} (at least two "
             f"different clicks)")
    if len(lane_s) != LOOP_JOBS:
        fail(f"{len(lane_s)} sample times for {LOOP_JOBS} samples")
    run1 = evaluator(model, 1, target)
    got1 = device_eval.evaluate_dataset_device(run1, Scenes(loop_scenes))
    err_b1 = same_trajectories(got8, got1, LOOP_IOU_TOL, "B=8 vs B=1")
    host_idx = sorted({int(np.argmin(lengths)), int(np.argmax(lengths))})
    host_pred = Predictor(model, target_size=(448, 448), with_flip=True,
                          net_clicks_limit=20)
    host = [evaluate_sample(*loop_scenes[i], host_pred, max_iou_thr=target,
                            pred_thr=0.49, max_clicks=LOOP_CLICKS)[1]
            for i in host_idx]
    err_host = same_trajectories([got8[i] for i in host_idx], host,
                                 LOOP_IOU_TOL, "device loop vs Predictor")
    loop = {"jobs": LOOP_JOBS, "batch": LOOP_BATCH, "target_iou": target,
            "lengths": lengths, "steps": run8.steps,
            "host_reads": run8.host_reads, "launches": loop_launches,
            "wall_s": loop_wall, "sample_s": lane_s,
            "ious": [[float(v) for v in a] for a in got8],
            "max_iou_diff_b8_vs_b1": err_b1,
            "host_compared": host_idx, "max_iou_diff_vs_host": err_host}
    print("device_loop", json.dumps({k: v for k, v in loop.items()
                                     if k not in ("ious", "sample_s")}))
    results["device_loop"] = loop

    # 9. no hidden syncs: one whole device-loop evaluation of the first
    # chunk under the sync debugger, lifted only around the allowed reads
    chunk = first_chunk(torch, device_eval, loop_scenes, LOOP_BATCH)
    results["sync_check"] = sync_checked_run(torch, run8, chunk,
                                             got8[:LOOP_BATCH], "flagship")
    print("sync_check", json.dumps(results["sync_check"]))

    # 10. the trunk cache at full width: after_backbone injection
    cfg_ab = flagship_config((448, 448))
    cfg_ab["backbone_cfg"]["params"]["feats_injection_mode"] = \
        "after_backbone"
    model_ab = iSegProbeModel(**cfg_ab).eval()
    model_ab.load_state_dict(model.state_dict())
    calibrate_classifier(torch, model_ab, 448)  # clicks join after it
    cache_scenes = Scenes(loop_scenes[:4])
    cached = evaluator(model_ab, 4, 2.0, max_clicks=5)
    uncached = evaluator(model_ab, 4, 2.0, max_clicks=5, trunk_cache="off")
    if not cached.use_cache or uncached.use_cache:
        fail("trunk_cache='auto' did not pick the cache for after_backbone")
    got_c = device_eval.evaluate_dataset_device(cached, cache_scenes)
    want_c = device_eval.evaluate_dataset_device(uncached, cache_scenes)
    cache = {"max_iou_diff": same_trajectories(got_c, want_c, CACHE_TOL,
                                               "cached vs uncached trunk"),
             "ious": [[float(v) for v in a] for a in got_c],
             "steps": cached.steps,
             "trunk_recomputes": cached.trunk_recomputes,
             "host_reads": cached.host_reads}
    print("trunk_cache", json.dumps(cache))
    if not 0 < cached.trunk_recomputes < cached.steps:
        fail(f"the trunk was recomputed on {cached.trunk_recomputes} of "
             f"{cached.steps} clicks: the ROI never moved, or moved on "
             f"every click, so the cache was not exercised")
    print(f"trunk recomputed on {cache['trunk_recomputes']} of "
          f"{cache['steps']} clicks")
    results["trunk_cache"] = cache

    # 11. throughput of the device loop beside the host protocol, and the
    # split of one f32 B=8 loop step
    thr_scenes = Scenes([scene(20 + i) for i in range(16)])
    throughput = []
    for dtype, batch in (("float32", 8), ("bfloat16", 8), ("bfloat16", 16)):
        m = model if dtype == "float32" else model_bf16
        device_eval.evaluate_dataset_device(  # warm-up: per-device constants
            evaluator(m, batch, target, max_clicks=1),
            Scenes(thr_scenes.scenes[:batch]))
        run = evaluator(m, batch, target)
        torch.cuda.synchronize()
        t0 = time.time()
        res = device_eval.evaluate_dataset_device(run, thr_scenes)
        wall = time.time() - t0
        clicks = sum(len(a) for a in res)
        throughput.append({
            "dtype": dtype, "batch": batch, "jobs": len(thr_scenes),
            "steps": run.steps, "wall_s": wall, "clicks": clicks,
            "lane_clicks_per_s": clicks / wall,
            "driven_lane_steps_per_s": run.steps * batch / wall,
            "ms_per_step": 1e3 * wall / run.steps})
        print("throughput", json.dumps(throughput[-1]))
    host_p50 = noc["per_click_protocol"]["p50_ms"]
    print(f"host protocol p50 {host_p50:.3f} ms per click "
          f"({1e3 / host_p50:.2f} clicks/s) vs device loop " + ", ".join(
              f"{t['dtype']} B={t['batch']}: {t['lane_clicks_per_s']:.2f} "
              f"lane-clicks/s, {t['ms_per_step']:.3f} ms/step"
              for t in throughput))
    results["throughput"] = throughput

    with torch.inference_mode():
        st = run8._init_state(*chunk)
        sel, pts_full = run8._select(st)
        crops, pts = run8._crop_points(st["image"], st["prev"], sel["roi"],
                                       pts_full)
        step_logits = model(crops, pts)["instances"]
        split = {
            "clicker_ms": time_ms(torch, lambda: edt.next_click_from_error(
                st["gt"], st["prev"][..., 0] > 0.49, st["not_clicked"],
                st["not_ignore"]))[0],
            "select_ms": time_ms(torch, lambda: run8._select(st))[0],
            "crop_ms": time_ms(torch, lambda: run8._crop_points(
                st["image"], st["prev"], sel["roi"], pts_full))[0],
            "forward_ms": time_ms(torch, lambda: model(crops, pts),
                                  reps=5, rounds=3, graph=False)[0],
            "paste_iou_ms": time_ms(torch, lambda: run8._finish(
                st, sel["roi"], run8._merge_flip(step_logits,
                                                 LOOP_BATCH)))[0],
        }
        # kernel C on this step's own column pass (the clicker's fn and fp
        # maps, padded with background), as next_click_from_error builds it
        pred = st["prev"][..., 0] > 0.49
        err = torch.stack([st["gt"] & ~pred, ~st["gt"] & pred], 1)
        err &= st["not_ignore"][:, None]
        fg = err.new_zeros((*err.shape[:-2], err.shape[-2] + 2,
                            err.shape[-1] + 2))
        fg[..., 1:-1, 1:-1] = err
        gcol = edt._column_pass(~fg).contiguous()
        split["row_envelope_ms"] = time_ms(
            torch, lambda: edt.row_envelope(gcol))[0]
        split["row_envelope_shape"] = list(gcol.shape)
        if not torch.equal(edt.row_envelope(gcol),
                           edt._row_envelope_plain(gcol)):
            fail("kernel C differs from its plain version on the loop's "
                 "own error maps")
    split["loop_ms_per_step"] = throughput[0]["ms_per_step"]
    print("step_split", json.dumps(split))
    results["step_split"] = split

    # 11b. the trained probes against the JAX package's results
    trained = trained_phase(torch, cuda)
    results["trained"] = {k: v for k, v in trained.items() if k != "checks"}
    for c in trained["checks"]:
        print("check", json.dumps(c))
    checks += trained["checks"]
    bad = [c for c in trained["checks"] if not c["ok"]]
    if bad:
        fail(f"kernel disagrees with its plain version: {bad}")

    # 12. the learned-upsampler families (main paths 3-6)
    families = {name: learned_family(torch, name) for name in UPSAMPLERS}
    results["families"] = families

    # 13. kernels F and G, and main path 7: the attention-variant sweep
    variant_checks, sweep, sweep_launches = variant_sweep(torch, F)
    checks += variant_checks
    results["sweep"] = {"records": sweep, "launches": sweep_launches}

    # 14. the kernels of the paths, at the device loops' shapes (f32; A, F
    # and G also in bf16 at the sweep's shape)
    from isegprobe_torch.scripts import bench_attn_variants as bav
    sweep_shape = [bav.BATCH, bav.N, 3 * 64 * bav.HEADS]
    sources = {
        "mha_qkv": ("isegprobe_torch/csrc/attention.cu",
                    "isegprobe_tpu/ops/attention.py:172",
                    [2 * LOOP_BATCH, 1025, 1152]),
        "layernorm": ("isegprobe_torch/csrc/layernorm.cu",
                      "isegprobe_tpu/ops/layernorm.py:70",
                      [2 * LOOP_BATCH, 1025, 384]),
        "edt_row_envelope": ("isegprobe_torch/csrc/edt.cu",
                             "isegprobe_tpu/ops/edt.py:168",
                             list(EDT_SHAPE)),
        "mha": ("isegprobe_torch/csrc/mha.cu",
                "isegprobe_tpu/ops/attention.py:319",
                [[loop_fwd, 64 * 448, 4, 101], [loop_fwd, 1024, 4, 101]]),
        "jbu_filter": ("isegprobe_torch/csrc/jbu.cu",
                       "isegprobe_tpu/ops/jbu_kernel.py:188",
                       [loop_fwd, 512, 512, 384]),
        "mha_qkv_nodiv": ("isegprobe_torch/csrc/attn_variants.cu",
                          "scripts/bench_attn_variants.py:101",
                          sweep_shape),
        "mha_qkv_merged": ("isegprobe_torch/csrc/attn_variants.cu",
                           "scripts/bench_attn_variants.py:101",
                           sweep_shape)}
    # the kernels whose source instantiates the shared flash core
    on_core = ("mha_qkv", "mha", "mha_qkv_nodiv", "mha_qkv_merged")
    paths = {"host_protocol": launches, "device_loop": loop_launches,
             "flagship_bf16_forward": expected(
                 **noc["bf16_forward"]["launches_per_forward"]),
             "attn_variant_sweep": sweep_launches}
    paths.update(trained["path_launches"])
    for fam in families.values():
        paths.update(fam["path_launches"])
    kernels = []
    timing_keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                   "library_ms")

    def timed_check(name, shape, dtype):
        return next((c for c in checks if c["kernel"] == name
                     and c["dtype"] == dtype and c["shape"] == shape
                     and c.get("expdt", "float32") == "float32"
                     and "plain_ms" in c), None)

    for name, (src, replaces, shape) in sources.items():
        c = timed_check(name, shape, "float32")
        by_path = {p: counts[name] for p, counts in paths.items()}
        if not any(by_path.values()):
            fail(f"kernel {name} was launched on no main path: {by_path}")
        entry = {"name": name, "route": "cuda", "source": src,
                 **({"core": "isegprobe_torch/csrc/flash_core.cuh"}
                    if name in on_core else {}),
                 "replaces": replaces, "launches": sum(by_path.values()),
                 "launches_by_path": by_path,
                 **{k: c[k] for k in timing_keys}, "shape": shape}
        c16 = timed_check(name, shape, "bfloat16")
        if c16 is not None:
            entry["bfloat16"] = {k: c16[k] for k in timing_keys}
            if "plan" in c16:
                entry["bfloat16"]["plan"] = c16["plan"]
        for key in ("tile", "plan"):
            if key in c:
                entry[key] = c[key]
        if name == "jbu_filter":
            entry.update(tile=jbu_config, ptxas=jbu_ptxas)
        if name == "edt_row_envelope":
            entry.update(layout=edt_config, ptxas=edt_ptxas, by_input={
                e["input"]: {k: e[k] for k in ("ms", "plain_ms", "bound_ms")}
                for e in checks if e["kernel"] == name
                and e["shape"] == shape})
        kernels.append(entry)
    results["kernels"] = kernels
    results["seconds"] = time.time() - t_start
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    print(f"chip_smoke finished in {results['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
