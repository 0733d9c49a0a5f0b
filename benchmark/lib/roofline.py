"""The yardstick: the card's published peaks, the least time of a kernel's
work at its call shapes, and the model's FLOPs per forward.

Peaks are NVIDIA's data sheet for one H100 SXM at its full 700 W, dense:
float32 67 TFLOP/s outside the tensor cores (the port runs float32 with
TF32 off), bfloat16 989; 3.35 TB/s of HBM; 3.9e12 exps a second
(the special-function rate FlashAttention-3 quotes). A bound is the
largest of the operations, the exps and the bytes at their rates; each
input byte is counted read once and each output byte written once.
"""

from __future__ import annotations

from typing import Dict

PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
PEAK_EXPS = 3.9e12
ITEMSIZE = {"float32": 4, "bfloat16": 2}


def bound_s(ops: float, nbytes: float, exps: float, dtype: str) -> float:
    return max(ops / PEAK_OPS[dtype], nbytes / PEAK_BYTES, exps / PEAK_EXPS)


def attention_bound_s(b: int, heads: int, nq: int, nk: int, dh: int,
                      dtype: str, packed: bool) -> float:
    """Least time of one attention call: ``4·b·heads·nq·nk·dh`` products
    (QK^T and PV), ``b·heads·nq·nk`` exps, q, k, v read and the output
    written. ``packed``: kernel A's packed qkv ``[b, n, 3·heads·dh]``
    (``nq == nk``); else kernel D's separate q ``[b, nq, heads, dh]`` and
    k, v ``[b, nk, heads, dh]``."""
    c = heads * dh
    ops = 4.0 * b * heads * nq * nk * dh
    exps = float(b * heads * nq * nk)
    if packed:
        elems = b * nq * 3 * c + b * nq * c
    else:
        elems = 2 * b * nq * c + 2 * b * nk * c
    return bound_s(ops, elems * ITEMSIZE[dtype], exps, dtype)


def forward_flops(cfg: Dict, batch: int, hw) -> float:
    """FLOPs of the reference forward of ``batch`` crops of ``hw`` pixels,
    as ``torch.utils.flop_counter.FlopCounterMode`` counts them (matrix
    products and convolutions) on meta tensors: the same count whatever
    implements the forward."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from benchmark.reference import model, weights

    dev = torch.device("meta")
    params = model.to_device(weights.probe_params(cfg), dev)
    h, w = hw
    n = 2 * 20
    image = torch.zeros((batch, h, w, 3), device=dev)
    points = torch.zeros((batch, n, 3), device=dev)
    prev = torch.zeros((batch, h, w), device=dev)
    with FlopCounterMode(display=False) as counter:
        model.forward(params, cfg, image, points, prev)
    return float(counter.get_total_flops())
