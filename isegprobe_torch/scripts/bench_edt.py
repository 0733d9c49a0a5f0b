"""Kernel C (the EDT row envelope) on its own, on the inputs that set its
time.

    python -m isegprobe_torch.scripts.bench_edt [--label NAME] [--device cpu]

The row pass takes the column pass of a zero mask (``ops/edt.py:
_column_pass``) and its work depends on the data, so C is timed on three
inputs at the device loop's shapes, ``[B, 2, 514, 642]`` (B lanes, the fn
and fp error maps of 512×640 scenes padded by one pixel) at B = 8 (the f32
and bf16 B=8 loops) and B = 16 (the bf16 B=16 loop):
- ``random``: masks with about 2% zeros (column 1, and the last column in
  the leading half of the rows, zero-free, so the sentinel 1e6 reaches the
  row pass), drawn with a ``torch.Generator`` from the seed;
- ``clicker``: the clicker's own input, drawn with numpy from the seed:
  error maps of elliptic ground truths, half the lanes at their first
  click (the whole object missed) and half against other ellipses with 1%
  noise, padded with background as ``next_click_from_error`` pads them;
- ``adversarial``: one zero in each column, at row 0, so g runs from 0 to
  513 along every column and a column's minimum lies far away.
Each output is checked bit for bit against the plain version
(``_row_envelope_plain``). On the card C is timed as
``bench_attn_variants.time_graph`` times: CUDA events around replays of a
CUDA graph of 20 calls, median of 5. The record also holds C's bound (its
bytes: g read and the result written once, at 3.35 TB/s), its layout and
resources as its library reports them (``edt.kernel_config``) and its ptxas
entry when this call built the library.

Prints one line, ``bench_edt {json}``. To compare two versions of
``csrc/edt.cu``, run it from the roots of two checkouts in one call to the
card (``PYTHONPATH=. python <this checkout>/isegprobe_torch/scripts/
bench_edt.py --label X`` from the other), in the order A B B A, since the
card's clocks move between calls. On the CPU the plain version runs in
both legs and nothing is timed.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from isegprobe_torch import resolve_device
from isegprobe_torch.ops import cuda_lib, edt
from isegprobe_torch.scripts.bench_attn_variants import time_graph

KINDS = ("random", "clicker", "adversarial")
# the inputs of domain_inputs, in its order
DOMAIN_NAMES = ("w4096_random", "w4096_adversarial", "w1_random",
                "w1_adversarial", "sentinel_rows", "single_source_rows",
                "tall_5000x7", "tall_40000x7")
SHAPES = ((8, 2, 514, 642), (16, 2, 514, 642))
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM device memory


def error_maps(batch: int, hw, seed: int) -> np.ndarray:
    """The clicker's fn and fp maps, ``[batch, 2, H, W]`` bool, for an
    elliptic ground truth: even lanes at their first click (no prediction
    yet: the whole object is false negative, as on the device loop's first
    step), odd lanes later (a prediction that is another ellipse with 1% of
    its pixels flipped)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.ogrid[:hw[0], :hw[1]]

    def ellipse():
        cy, cx = rng.uniform(0.2, 0.8) * hw[0], rng.uniform(0.2, 0.8) * hw[1]
        ry, rx = rng.uniform(0.1, 0.3) * hw[0], rng.uniform(0.1, 0.3) * hw[1]
        return ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1

    maps = np.empty((batch, 2, *hw), bool)
    for lane in range(batch):
        gt = ellipse()
        pred = ellipse() ^ (rng.random(hw) < 0.01)
        if lane % 2 == 0:
            pred[:] = False
        maps[lane, 0] = gt & ~pred
        maps[lane, 1] = ~gt & pred
    return maps


def zero_mask(kind: str, shape, device: torch.device,
              seed: int) -> torch.Tensor:
    """The zero (background) mask of one input kind, ``shape`` bool."""
    if kind == "random":
        g = torch.Generator(device=device).manual_seed(seed)
        zero = torch.rand(shape, generator=g, device=device) < 0.02
        if shape[-1] > 1:
            zero[..., 1] = False
        zero[..., : max(1, shape[-2] // 2), -1] = False
        return zero
    if kind == "clicker":
        fg = torch.zeros(shape, dtype=torch.bool, device=device)
        fg[..., 1:-1, 1:-1] = torch.from_numpy(
            error_maps(shape[0], (shape[-2] - 2, shape[-1] - 2), seed)
        ).to(device)
        return ~fg
    if kind == "adversarial":
        zero = torch.zeros(shape, dtype=torch.bool, device=device)
        zero[..., 0, :] = True
        return zero
    raise ValueError(f"no input kind {kind!r}; kinds: {KINDS}")


def column_input(kind: str, shape, device: torch.device,
                 seed: int = 0) -> torch.Tensor:
    """The row pass's input: the column pass of ``zero_mask``."""
    return edt._column_pass(zero_mask(kind, shape, device, seed)).contiguous()


def domain_inputs(device: torch.device, seed: int = 0) -> dict:
    """Small inputs that hold C over the rest of its domain, by name: the
    widest row it takes (W = 4096), W = 1, rows of sentinels only, rows
    with one finite source each (at the ends, at segment edges, g up to
    4200), a column pass of height 5000 (two columns without a zero),
    where g reaches 4999 and the minimum fl(g²) + d² passes 2^24, so both
    sums round, and the last 10,000 rows of one of height 40,000, where G
    passes 2^30 and C takes its int64 arithmetic."""
    g = torch.Generator(device=device).manual_seed(seed)
    single = torch.full((6, 642), 1e6, device=device)
    single[torch.arange(6), torch.tensor([0, 641, 320, 20, 21, 100])] = (
        torch.tensor([0.0, 513.0, 4000.0, 7.0, 4200.0, 4097.0],
                     device=device))
    tall = torch.zeros((5000, 7), dtype=torch.bool, device=device)
    tall[0, :5] = True  # one zero in columns 0-4, a second in column 1
    tall[700, 1] = True
    taller = torch.zeros((40000, 7), dtype=torch.bool, device=device)
    taller[0, :5] = True
    taller[5000, 1] = True
    return {
        "w4096_random": column_input("random", (2, 40, 4096), device, seed),
        "w4096_adversarial": column_input("adversarial", (1, 30, 4096),
                                          device),
        "w1_random": column_input("random", (4, 300, 1), device, seed),
        "w1_adversarial": column_input("adversarial", (2, 300, 1), device),
        "sentinel_rows": edt._column_pass(torch.zeros(
            (2, 9, 642), dtype=torch.bool, device=device)),
        "single_source_rows": single,
        "tall_5000x7": edt._column_pass(tall).contiguous(),
        "tall_40000x7": edt._column_pass(taller)[30000:].contiguous(),
    }


def edt_ptxas() -> dict | None:
    """Build C if its library is missing; the kernel's ptxas entry when
    this call built it, else None."""
    log = cuda_lib.build(["edt"]).get("edt", "")
    return next((v for k, v in cuda_lib.ptxas_entries(log).items()
                 if "row_envelope_kernel" in k), None)


def main(device=None, label: str = "", shapes=SHAPES,
         kinds=KINDS) -> dict:
    """Check and time C on every input (on the card); returns the record
    it prints. The shape arguments serve tests at a tiny size."""
    device = resolve_device(device)
    on_card = device.type == "cuda"
    rec = {"label": label, "device": (torch.cuda.get_device_name(device)
                                      if on_card else "cpu")}
    if on_card:
        rec["ptxas"] = edt_ptxas()
        # a checkout from before C's library reported its layout has no
        # kernel_config
        if hasattr(edt, "kernel_config"):
            rec["config"] = {str(w): edt.kernel_config(w, device)
                             for w in sorted({s[-1] for s in shapes})}
    rec["cases"] = []
    with torch.no_grad():
        for shape in shapes:
            for kind in kinds:
                g = column_input(kind, shape, device)
                got = edt.row_envelope(g)
                want = edt._row_envelope_plain(g)
                rec["cases"].append({
                    "shape": list(shape), "kind": kind,
                    "bitwise_equal": bool(torch.equal(got, want)),
                    "zeros": float((g == 0).float().mean()),
                    "max_finite_g": float(g[g < 1e6].max()) if bool(
                        (g < 1e6).any()) else None,
                    "ms": time_graph(edt.row_envelope, g) if on_card
                    else None,
                    "bound_ms": 8.0 * g.numel() / PEAK_BYTES_PER_S * 1e3})
                del g, got, want
    print("bench_edt", json.dumps(rec))
    bad = [c for c in rec["cases"] if not c["bitwise_equal"]]
    if bad:
        raise SystemExit(f"kernel C differs from the plain version: {bad}")
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
