#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is ``BENCHMARK.json``'s workload of that name; its configuration,
traffic mix, limits and per-layer metrics are files of this directory found
by name. The run loads the program (the ``isegprobe_torch`` package) and
warms it up (``setup_s``: from the process's start to the first timed
unit), measures for ``--seconds``, reads the device's peak memory, frees
the program, and then has the cell's client (``clients/<kind>.py``) hold a
sample of the window's answers, drawn from the seed, against the plain
reference in ``reference/``. With ``--trace 1`` the first
``trace_seconds`` of the window run under ``torch.profiler`` and the line
holds the per-layer metrics; with ``--trace 0`` the end-to-end ones. The last line of standard output is the result; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

The program builds its CUDA kernels with nvcc into its own fixed directory
inside the checkout (``isegprobe_torch/csrc/build/``), so only a
checkout's first run builds them; it uses no Triton, ``torch.compile`` or
``cpp_extension`` cache.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "isegprobe_tpu")


def process_start() -> float:
    """The epoch second this process started (``/proc``; the import time of
    this file where ``/proc`` is missing)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, StopIteration, IndexError, ValueError):
        return _IMPORTED


_IMPORTED = time.time()


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def power_limit_w():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.split()
        return float(out[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None


class Context(SimpleNamespace):
    """What a client gets: the cell, its traffic, the seed, the window's
    seconds, the traced stretch's seconds (None untraced) and the device."""


def run_cell(workload: str, seed: int, seconds: float, trace: int,
             device=None, require_cuda: bool = True):
    """One run of a cell; returns (result line dict, compared numbers) or
    raises ``SystemExit`` with a message where no result may be printed.
    ``device``/``require_cuda`` let the CPU tests drive the plumbing."""
    import torch

    from benchmark.lib import spec
    from benchmark.lib import trace as trace_lib

    cell = spec.Cell(workload)
    chips = cell.entry["chips"]
    if require_cuda and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < chips):
        raise SystemExit(f"{workload} needs {chips} CUDA device(s); "
                         f"torch sees {torch.cuda.device_count()}")
    device = torch.device(device or "cuda:0")
    client = spec.client(cell.traffic["client"])
    trace_s = float(cell.traffic["trace_seconds"]) if trace else None
    ctx = Context(cell=cell, traffic=cell.traffic, seed=seed,
                  seconds=seconds, trace_seconds=trace_s, device=device)
    t_start = process_start()
    t_prepare = time.time()
    state = client.prepare(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.time() - t_start
    print(f"setup {setup_s:.2f} s: {t_prepare - t_start:.2f} to start the "
          f"client, {time.time() - t_prepare:.2f} to load and warm up",
          file=sys.stderr)
    result = client.measure(state, ctx)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of JAX or the JAX package are loaded: "
                         f"{found}")
    on_gpu = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if on_gpu else None
    win = result["window"]
    summary = trace_lib.summarize(win.prof) if win.prof is not None else None
    del state
    gc.collect()
    if on_gpu:
        torch.cuda.empty_cache()

    t_judge = time.time()
    verdict = client.judge(cell, result, seed, device)
    print(f"window {result['totals']['window_s']:.2f} s, judged in "
          f"{time.time() - t_judge:.2f} s", file=sys.stderr)
    compared = {k: dict(value=verdict["gaps"].get(k, 0.0), limit=v)
                for k, v in cell.limits.items()}
    correct = (verdict["failed"] == 0 and verdict["judged"] > 0
               and all(c["value"] <= c["limit"] for c in compared.values()))

    metrics = {}
    if trace:
        flops = {}

        def forward_flops():
            if "f" not in flops:
                from benchmark.lib import roofline
                flops["f"] = roofline.forward_flops(
                    cell.config, 1, tuple(cell.traffic["target_size"]))
            return flops["f"]

        run = SimpleNamespace(cell=cell, config=cell.config,
                              traffic=cell.traffic, result=result,
                              stretch=win.stretch, trace=summary,
                              forward_flops=forward_flops)
        for m in cell.per_layer:
            if not on_gpu and m["source"] == "device_trace":
                continue  # no device, no device metric
            value = spec.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        for m in cell.end_to_end:
            value = (setup_s if m["name"] == "setup_s"
                     else result["e2e"].get(m["name"]))
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])

    dev = dict(platform="gpu" if on_gpu else "cpu",
               kind=torch.cuda.get_device_name(device) if on_gpu else "cpu",
               count=chips if on_gpu else 0, memory_peak_bytes=peak)
    if on_gpu:
        dev["power_limit_w"] = power_limit_w()
    if summary is not None and on_gpu:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
    line = dict(correct=bool(correct), attempted=result["totals"]["clicks"],
                failed=verdict["failed"], metrics=metrics, device=dev)
    if summary is not None and on_gpu:
        line["breakdown"] = dict(device_ops=summary["device_ops"],
                                 idle_gaps=summary["idle_gaps"])
    line["compared"] = compared
    return line, verdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line, verdict = run_cell(args.workload, args.seed, args.seconds,
                                 args.trace)
    except SystemExit as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    print(f"judged {verdict['judged']} objects, {verdict['clicks']} clicks; "
          f"every gap: {json.dumps(verdict['all_gaps'])}", file=sys.stderr)
    for k, c in line["compared"].items():
        print(f"{k} {c['value']:.6g} limit {c['limit']:.6g}",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
