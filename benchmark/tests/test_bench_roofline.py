"""The yardstick's arithmetic: the bounds of kernels A and D at the shapes
of the port's kernel table, and the FLOPs of each configuration's reference
forward."""

from __future__ import annotations

import pytest

from benchmark.lib import roofline, spec


def test_attention_a_bound():
    # [16, 1025, 1152] f32: 6 heads of 64, bound by operations
    ms = 1e3 * roofline.attention_bound_s(16, 6, 1025, 1025, 64, "float32",
                                          packed=True)
    assert ms == pytest.approx(0.3854, abs=5e-5)


def test_cross_attention_d_bound():
    # q [2, 28672, 4, 101], k/v [2, 1024, 4, 101] f32
    ms = 1e3 * roofline.attention_bound_s(2, 4, 28672, 1024, 101, "float32",
                                          packed=False)
    assert ms == pytest.approx(1.4163, abs=5e-5)


def test_bf16_attention_bound():
    # the table's [16, 1025, 1152] bf16 row: 0.02611 ms by operations, its
    # exps 0.02586
    ms = 1e3 * roofline.attention_bound_s(16, 6, 1025, 1025, 64, "bfloat16",
                                          packed=True)
    assert ms == pytest.approx(0.02611, abs=5e-6)
    assert 1e3 * 16 * 6 * 1025 ** 2 / roofline.PEAK_EXPS == pytest.approx(
        0.02586, abs=5e-6)


# FlopCounterMode's count of one 448x448 forward of the reference
FLOPS = {"dinov2_s14_noup": 69_255_579_648,
         "dinov2_s14_loftup": 3_254_331_361_280}


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_forward_flops(name):
    conf = [c for c in spec.benchmark()["configs"] if c["name"] == name][0]
    cfg = spec.read_json(spec.ROOT / conf["file"])
    assert roofline.forward_flops(cfg, 1, (448, 448)) == FLOPS[name]
    assert roofline.forward_flops(cfg, 2, (448, 448)) == 2 * FLOPS[name]
