"""The judge's sample and its comparisons: the device loop's recorded
batches cover the whole window with the last round always in it, and the
IoU and click checks allow pixels within the band of the threshold to fall
either way, and no more."""

from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.clients import device_loop
from benchmark.reference import protocol


class _Loop:
    steps = 0


def _measure(seed: int, k: int = 3):
    """``device_loop.measure`` over six fake batches of 2 ms each."""
    ev, model = _Loop(), SimpleNamespace(on=False, logits=[])

    def one_batch(idx):
        ev.steps += 2
        if model.on:
            model.logits += [torch.zeros(1), torch.zeros(1)]
        time.sleep(0.002)
        return [np.ones(2)] * len(idx), [np.zeros((2, 3))] * len(idx)

    st = dict(ev=ev, batches=[np.array([2 * b, 2 * b + 1])
                              for b in range(6)],
              one_batch=one_batch, model=model, objs=[None] * 12)
    ctx = SimpleNamespace(seed=seed, seconds=0.25, trace_seconds=None,
                          device=torch.device("cpu"),
                          traffic=dict(judge_batches=k))
    return device_loop.measure(st, ctx)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_recorded_batches_span_the_window(seed):
    result = _measure(seed)
    judged = result["judged"]
    rounds = [r["round"] for r in judged]
    assert result["rounds"] >= 8
    assert len(judged) == 3 and len(set(rounds)) == 3
    assert rounds[-1] == result["rounds"] - 1
    for r in judged:
        assert len(r["logits"]) == r["steps"] == 2
        assert [o["lane"] for o in r["objects"]] == [0, 1]


def test_earlier_rounds_are_drawn_over_the_window():
    """Over seeds the kept earlier rounds reach past the first rounds."""
    late = 0
    for seed in range(8):
        result = _measure(seed)
        late += max(r["round"] for r in result["judged"][:-1]) >= 3
    assert late >= 4


def test_iou_range_and_band():
    gt = np.zeros((4, 4), bool)
    gt[:2] = True
    p = np.where(gt, 0.9, 0.1)
    assert protocol.iou_range(p, gt, 0.5, 0.0) == (1.0, 1.0)
    p[0, 0] = 0.5 + 5e-6  # in the band, inside the object
    p[3, 3] = 0.5 - 5e-6  # in the band, outside
    lo, hi = protocol.iou_range(p, gt, 0.5, 1e-5)
    assert lo == pytest.approx(7 / 9) and hi == pytest.approx(1.0)
    lo, hi = protocol.iou_range(p, gt, 0.5, 0.0)
    assert lo == hi == 1.0


def test_a_click_is_checked_exactly_outside_the_band():
    cfg = dict(pred_thr=0.5)
    gt = np.zeros((9, 9), np.int32)
    gt[2:7, 2:8] = 1
    run = protocol.ClickRun(None, {}, cfg, np.zeros((9, 9, 3), np.uint8),
                            gt, torch.device("cpu"))
    prev = np.where(gt == 1, 0.9, 0.1).astype(np.float32)
    prev[:, 7] = 0.1  # a missed strip, one pixel deep
    prev[3:6, 3:6] = 0.5 - 5e-6  # a hole in the band, two deep
    run.prev = torch.as_tensor(prev)
    chosen = run.next_click()
    assert chosen == (4, 4, True)
    assert protocol._chose(run, chosen, 0.0)
    # with the hole filled within the band, the user clicks the strip
    other = run.next_click(prev > 0.5 - 1e-5)
    assert other == (2, 7, True)
    assert protocol._chose(run, other, 1e-5)
    assert not protocol._chose(run, other, 0.0)
    assert not protocol._chose(run, (0, 0, False), 1e-5)
