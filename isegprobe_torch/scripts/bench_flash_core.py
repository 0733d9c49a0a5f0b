"""The flash core's bf16 kernels at the paths' shapes, for comparing two
versions of ``csrc/flash_core.cuh`` on one card.

    python -m isegprobe_torch.scripts.bench_flash_core [--label NAME]

Builds kernels A (``attention``), D (``mha``) and F/G (``attn_variants``),
counts the ptxas report's C7515 lines (wgmma serialized) and the bf16
instantiations that spill, then times in bf16 as the sweep times its
variants (``bench_attn_variants.time_graph``: CUDA events around replays
of a CUDA graph of 20 calls, median of 5):
- A at the sweep's [16, 1025, 1152] and at [2, 1025, 1152] (6 heads of 64),
  forced to each query tile on the 16-byte path;
- F and G at [16, 1025, 1152] at each of their tiles, with the exp in f32
  and in bf16;
- D at LoftUp's slab, q [B, 28672, 4, 101] against k/v [B, 1024, 4, 101],
  B = 2 and 8, at the plan its wrapper picks.
Prints one line, ``bench_flash_core {json}``. To compare two versions, run
it from the roots of two checkouts in one call to the card, in the order
A B B A, since the card's clocks move between calls. Needs a CUDA device;
nothing is checked for correctness here (``chip_smoke.py`` does that).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from isegprobe_torch.ops import attention, attn_variants, cuda_lib
from isegprobe_torch.scripts.bench_attn_variants import time_graph

SOURCES = ("attention", "mha", "attn_variants")


def build_report() -> dict:
    """Build the sources (if their libraries are missing) and summarise the
    ptxas report of those built: C7515 lines and spilling bf16 entries."""
    t0 = time.time()
    reports = cuda_lib.build(SOURCES)
    spills = {}
    for name, log in reports.items():
        for entry, rec in cuda_lib.ptxas_entries(log).items():
            if "bf16" in entry and rec["spill_stores"]:
                spills.setdefault(name, {})[entry] = rec["spill_stores"]
    return {"built": sorted(reports), "build_s": time.time() - t0,
            "c7515": sum(log.count("C7515") for log in reports.values()),
            "bf16_spill_stores": spills}


def main(label: str = "") -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("bench_flash_core needs a CUDA device")
    rec = {"label": label, **build_report(), "ms": {}}
    ms = rec["ms"]
    g = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for b in (16, 2):
            qkv = torch.randn((b, 1025, 1152), generator=g,
                              device="cuda").bfloat16()
            for tile in attention.Q_TILES[::-1]:
                ms[f"A b{b} tile{tile}"] = time_graph(
                    lambda t: attention.mha_qkv(t, 6, 0.125,
                                                plan=(tile, True)), qkv)
            if b != 16:
                continue
            for kind, entry, tiles in (
                    ("F", attn_variants.mha_qkv_nodiv,
                     attn_variants.NODIV_TILES),
                    ("G", attn_variants.mha_qkv_merged,
                     attn_variants.MERGED_TILES)):
                for tile in tiles:
                    for exp in ("float32", "bfloat16"):
                        edt = getattr(torch, exp)
                        ms[f"{kind} tile{tile} exp {exp}"] = time_graph(
                            lambda t: entry(t, 6, 0.125, expdt=edt,
                                            q_tile=tile), qkv)
        for b in (2, 8):
            q, k, v = (torch.randn((b, n, 4, 101), generator=g,
                                   device="cuda").bfloat16()
                       for n in (28672, 1024, 1024))
            ms[f"D b{b}"] = time_graph(
                lambda t: attention.mha(t, k, v, 101**-0.5), q)
    print("bench_flash_core", json.dumps(rec))
    return rec


def _cli() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--label", default="", help="names this checkout")
    main(parser.parse_args().label)
    return 0


if __name__ == "__main__":
    sys.exit(_cli())
