#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the chip.

    python3 benchmark/control.py --workload <name> --seeds 201-212 \\
        --seconds 8 --control-seeds 301-303 --out <file.json>

The lower readings: the program is loaded once and runs a short window on
each of ``--seeds``, each judged as ``run.py`` judges a run. The upper
readings: the control, the plain reference in the nearest precision below
the configuration's (float32 with TF32 off: TF32), put in the program's
place on the objects a run would judge for each of ``--control-seeds``,
and judged by the float32 reference. Prints one JSON line per reading and
writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import run as bench_run  # noqa: E402


def seeds(text: str) -> list:
    lo, _, hi = text.partition("-")
    return list(range(int(lo), int(hi or lo) + 1))


def control_readings(cell, seed_list, device) -> list:
    """The TF32 reference as the program on the objects of each seed."""
    from benchmark.clients.device_loop import load_objects
    from benchmark.reference import protocol

    objs = load_objects(cell.traffic)
    with protocol.reference(cell, device) as params:
        return _control(cell, seed_list, device, objs, params)


def _control(cell, seed_list, device, objs, params) -> list:
    import numpy as np
    import torch

    from benchmark.reference import protocol

    out = []
    for seed in seed_list:
        rng = np.random.default_rng(seed)
        pick = rng.choice(len(objs), size=cell.traffic["judge_objects"],
                          replace=False)
        gaps = {}
        t0 = time.time()
        for i in pick:
            image, gt = objs[int(i)]
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
            played = protocol.play(params, cell.config, cell.traffic, image,
                                   gt, device)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            g = protocol.judge_object(
                params, cell.config, cell.traffic, image, gt,
                played["clicks"], played["ious"], played["probs"], device)
            for k in g:
                gaps[k] = max(gaps.get(k, 0.0), g[k])
        out.append(dict(kind="control_tf32", seed=seed, gaps=gaps,
                        seconds=time.time() - t0))
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchmark.lib import spec

    cell = spec.Cell(args.workload)
    device = torch.device("cuda:0")
    readings = []
    if args.seeds:
        client = spec.client(cell.traffic["client"])
        ctx = bench_run.Context(cell=cell, traffic=cell.traffic, seed=0,
                                seconds=args.seconds, trace_seconds=None,
                                device=device)
        state = client.prepare(ctx)
        for seed in seeds(args.seeds):
            ctx.seed = seed
            t0 = time.time()
            result = client.measure(state, ctx)
            verdict = client.judge(cell, result, seed, device)
            readings.append(dict(kind="program", seed=seed,
                                 gaps=verdict["all_gaps"],
                                 judged=verdict["judged"],
                                 clicks=verdict["clicks"],
                                 e2e=result["e2e"],
                                 seconds=time.time() - t0))
            print(json.dumps(readings[-1]), flush=True)
        del state, result
        gc.collect()
        torch.cuda.empty_cache()
    if args.control_seeds:
        readings += control_readings(cell, seeds(args.control_seeds), device)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
