"""Kernel E (the fused JBU filter) on its own: the ×16 JBU stack with its
check, and E's time at the JBU probe's stage shapes.

    python -m isegprobe_torch.scripts.bench_jbu [--label NAME] [--device cpu]

Counterpart of ``scripts/bench_jbu.py``. Its parts:
- the ×16 JBU-FeatUp stack at 448² (source ``[1, 28, 28, 384]``, guidance
  ``[1, 448, 448, 3]``, drawn with numpy from seed 0, weights drawn by
  ``init_params``), once through kernel E and once with the plain version
  in its place, on the same device; the two must agree as the JAX script
  asserts, ``max|err| < 1e-3 · max(1, max|plain|)``;
- E alone at the JBU probe's loop shapes (its four stages at batch 8, f32,
  key dim 32) and at ``[2, 512, 512, 384]``, timed as
  ``bench_attn_variants.time_graph`` times: CUDA events around replays of a
  CUDA graph of 20 calls, median of 5;
- E's registers and spill bytes from the ptxas report (when this call
  built the library).

Prints one line, ``bench_jbu {json}``. To compare two versions of
``csrc/jbu.cu``, run it from the roots of two checkouts in one call to the
card (``PYTHONPATH=. python <this checkout>/isegprobe_torch/scripts/
bench_jbu.py --label X`` from the other), in the order A B B A, since the
card's clocks move between calls. On the CPU the plain version runs in
both legs and nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import sys
from unittest import mock

import numpy as np
import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.models.upsamplers import jbu as jbu_stack
from isegprobe_torch.models.vit import init_params
from isegprobe_torch.ops import cuda_lib, jbu
from isegprobe_torch.scripts.bench_attn_variants import time_graph

# the JAX script's ×16 stack: DINOv2-S/14 patch features at 448²
STACK_SOURCE = (1, 28, 28, 384)
# E at the JBU loop's four stages (batch 8: 4 lanes, flip TTA), 32² -> 512²,
# and at chip_smoke.py's batch-2 shape
SHAPES = ((8, 64, 64, 384), (8, 128, 128, 384), (8, 256, 256, 384),
          (8, 512, 512, 384), (2, 512, 512, 384))
KEY_DIM = 32
def stack_check(device: torch.device, source=STACK_SOURCE) -> dict:
    """The ×16 stack through kernel E and through the plain version."""
    b, h, w, c = source
    rng = np.random.default_rng(0)
    src = torch.from_numpy(rng.standard_normal(source, dtype=np.float32))
    guide = torch.from_numpy(rng.random((b, 16 * h, 16 * w, 3),
                                        dtype=np.float32))
    src, guide = src.to(device), guide.to(device)
    model = init_params(jbu_stack.JBUFeatUpUpsampler(feat_dim=c), seed=0)
    model = model.to(device).eval()
    with torch.no_grad():
        before = jbu.jbu_filter.launches
        got = model(src, guide)
        launches = jbu.jbu_filter.launches - before
        with mock.patch.object(jbu_stack, "jbu_filter", jbu._jbu_plain):
            want = model(src, guide)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        rec = {"source": list(source), "out": list(got.shape),
               "launches": launches, "max_abs_err": err, "scale": scale,
               "ok": err < 1e-3 * max(1.0, scale)
               and bool(torch.isfinite(got).all()), "ms": None}
        if device.type == "cuda":
            rec["ms"] = time_graph(lambda s: model(s, guide), src)
    return rec


def jbu_ptxas() -> dict | None:
    """Build E if its library is missing; the kernel's ptxas entry when
    this call built it, else None."""
    log = cuda_lib.build(["jbu"]).get("jbu", "")
    return next((v for k, v in cuda_lib.ptxas_entries(log).items()
                 if "jbu_kernel" in k), None)


def main(device=None, label: str = "", source=STACK_SOURCE,
         shapes=SHAPES) -> dict:
    """Check the stack and time E (on the card); returns the record it
    prints. The shape arguments serve tests at a tiny size."""
    device = resolve_device(device)
    rec = {"label": label, "device": (torch.cuda.get_device_name(device)
                                      if device.type == "cuda" else "cpu")}
    if device.type == "cuda":
        rec["ptxas"] = jbu_ptxas()
    rec["stack"] = stack_check(device, source)
    rec["ms"] = {}
    g = torch.Generator(device=device).manual_seed(0)
    temp = torch.full((), 0.5, device=device)
    sigma = torch.full((), 0.8, device=device)
    with torch.no_grad():
        for b, h, w, c in shapes:
            hr = torch.randn((b, h, w, c), generator=g, device=device)
            proj = torch.randn((b, h, w, KEY_DIM), generator=g,
                               device=device)
            key = f"{b}x{h}x{w}x{c}"
            rec["ms"][key] = (
                time_graph(lambda t: jbu.jbu_filter(t, proj, temp, sigma),
                           hr) if device.type == "cuda" else None)
            del hr, proj
    print("bench_jbu", json.dumps(rec))
    if not rec["stack"]["ok"]:
        raise SystemExit(f"kernel E's JBU stack differs from the plain "
                         f"version: {rec['stack']}")
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
