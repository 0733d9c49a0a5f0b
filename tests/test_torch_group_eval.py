"""Continuous batching in the port (``inference/device_eval.py``:
``GroupEvaluator`` and ``evaluate_dataset_group``) against the port's
lockstep ``evaluate_dataset_device``, as ``tests/test_group_eval.py`` holds
the JAX package's: the job queue changes when a lane's protocol runs, never
what it computes, so every object's IoUs, stopping click and clicks must
equal the lockstep loop's. Both run the same arithmetic in the port (a
lane's numbers do not depend on its neighbours), so the IoUs are held to
1e-6.
"""

import numpy as np
import pytest
import torch

from tests.test_torch_device_eval import SIZE, _models
from tests.test_torch_model import tiny_arch  # noqa: F401  (fixture)
from tests.test_torch_predictor import _scene, _Scenes

torch.set_num_threads(2)

TOL = 1e-6
SEEDS = [0, 3, 5, 7, 11, 2, 9]


def _common(max_clicks=4):
    # a 20-pixel minimum crop lets the ZoomIn ROI move inside the scenes, and
    # a 0.3 target stops the drawn probe's lanes at different clicks
    return dict(target_size=(SIZE, SIZE), max_clicks=max_clicks,
                net_clicks_limit=max_clicks, pred_thr=0.49, target_iou=0.3,
                with_flip=True, min_crop_size=20, record_clicks=True,
                device="cpu")


def _same(got, want, got_clicks, want_clicks):
    assert [len(a) for a in got] == [len(a) for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
    for a, b in zip(got_clicks, want_clicks):
        np.testing.assert_array_equal(a, b)


def _lockstep(model, data, batch, kw):
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )

    clicks: list = []
    run = make_device_evaluator(model, batch_size=batch, **kw)
    ious = evaluate_dataset_device(run, data, clicks=clicks)
    return ious, clicks, run


@pytest.mark.parametrize("injection", ["before_backbone", "after_backbone"])
def test_group_matches_lockstep(tiny_arch, injection):  # noqa: F811
    """7 jobs on 3 lanes: refills mid-loop, the output rows padded past the
    job count, the final drain with idle lanes and (after_backbone) the
    poisoned trunk's recompute on a refilled lane's first click. Then
    windows of 3 jobs (a cap of 3: its largest power of two, 2, is below
    the batch), so that busy lanes pause at a window switch and resume in
    the next dispatch."""
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_group,
        make_device_evaluator,
    )

    _, _, model = _models(injection)
    data = _Scenes([_scene(s) for s in SEEDS])
    kw = _common()
    want, want_clicks, lock = _lockstep(model, data, 3, kw)
    assert len({len(a) for a in want}) > 1  # lanes stop at different clicks

    ev = make_device_evaluator(model, batch_size=3, group_api=True, **kw)
    times, stats, clicks = [], {}, []
    got = evaluate_dataset_group(ev, data, sample_times=times, stats=stats,
                                 clicks=clicks)
    _same(got, want, clicks, want_clicks)
    assert len(times) == 7 and all(t > 0 for t in times)
    assert stats["dispatches"] == 1 and stats["windows"] == [8]
    assert stats["useful_clicks"] == sum(len(a) for a in want)
    assert stats["lane_steps"] == 3 * stats["steps"]
    # a fill starts at least one lane, and the first starts three
    assert 1 <= stats["fills"] <= 7 - 2
    # the queue keeps lanes busy: fewer steps than the lockstep chunks ran
    assert stats["steps"] < lock.steps
    if injection == "after_backbone":
        assert ev.protocol.use_cache and ev.protocol.trunk_recomputes > 0

    stats_w, clicks_w = {}, []
    got_w = evaluate_dataset_group(ev, data, stats=stats_w, clicks=clicks_w,
                                   max_jobs_per_dispatch=3)
    _same(got_w, want, clicks_w, want_clicks)
    assert stats_w["windows"] == [3] and stats_w["dispatches"] == 3
    assert stats_w["resident_windows"] == 2


@pytest.mark.parametrize("batch,cap,jobs,frames", [
    (8, 32, 78, 32),    # the default cap, a power of two
    (8, 24, 78, 16),    # a cap between powers of two: never above it
    (8, 24, 10, 16),    # the group's power of two fits the cap
    (8, 24, 5, 8),      # a group smaller than the batch: the batch
    (3, 3, 7, 3),       # the cap's power of two below the batch: the batch
    (3, 5, 7, 4),
    (16, 4, 78, 16),    # a cap below the batch is raised to it
])
def test_window_frames(batch, cap, jobs, frames):
    """A window holds at most ``max(batch, cap)`` frames, a power of two
    unless the batch is not one and the cap leaves no room above it."""
    from isegprobe_torch.inference.device_eval import _window_frames

    assert _window_frames(batch, cap, jobs) == frames


def test_at_most_two_windows_resident(tiny_arch):  # noqa: F811
    """Windows of 4 frames over 7 jobs on 3 lanes, then 13 jobs (4
    windows): the next window is staged while one runs, and no third is
    ever alive."""
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_group,
        make_device_evaluator,
    )

    _, _, model = _models()
    kw = dict(_common(max_clicks=2), record_clicks=False)
    ev = make_device_evaluator(model, batch_size=3, group_api=True, **kw)
    seeds = SEEDS + [1, 4, 6, 8, 10, 12]
    data = _Scenes([_scene(s) for s in seeds])
    stats: dict = {}
    got = evaluate_dataset_group(ev, data, stats=stats,
                                 max_jobs_per_dispatch=4)
    assert len(got) == 13 and stats["dispatches"] == 4
    assert stats["resident_windows"] == 2
    # one read a step (its flags stacked) and one at each dispatch's start
    assert ev.protocol.host_reads == stats["steps"] + stats["dispatches"]


def test_group_smaller_than_batch(tiny_arch):  # noqa: F811
    """Two jobs on four lanes: lanes idle from the start (jobs fewer than
    lanes) and the output rows padded up to the batch."""
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_group,
        make_device_evaluator,
    )

    _, _, model = _models()
    data = _Scenes([_scene(s) for s in (0, 5)])
    kw = _common(max_clicks=3)
    want, want_clicks, _ = _lockstep(model, data, 1, kw)
    ev = make_device_evaluator(model, batch_size=4, group_api=True, **kw)
    clicks: list = []
    got = evaluate_dataset_group(ev, data, clicks=clicks)
    _same(got, want, clicks, want_clicks)


def test_adaptive_group_matches_adaptive_lockstep(tiny_arch):  # noqa: F811
    """The adaptive protocol through the same queue: 5 jobs on 2 lanes,
    windows of 2, against the adaptive lockstep runner."""
    from isegprobe_torch.inference.adaptive_eval import (
        make_adaptive_group_runner,
        make_adaptive_runner,
    )
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        evaluate_dataset_group,
    )

    _, _, model = _models()
    data = _Scenes([_scene(s) for s in SEEDS[:5]])
    kw = dict(max_clicks=4, net_clicks_limit=4, pred_thr=0.49,
              target_iou=0.3, with_flip=True, skip_clicks=1,
              min_crop_size=20, record_clicks=True, device="cpu")
    run = make_adaptive_runner(model, 56, batch_size=2, **kw)
    want_clicks: list = []
    want = evaluate_dataset_device(run, data, clicks=want_clicks)
    ev = make_adaptive_group_runner(model, 56, 2, **kw)
    clicks, stats = [], {}
    got = evaluate_dataset_group(ev, data, clicks=clicks, stats=stats,
                                 max_jobs_per_dispatch=2)
    _same(got, want, clicks, want_clicks)
    assert stats["dispatches"] == 3 and stats["resident_windows"] == 2


def test_group_options_that_raise(tiny_arch):  # noqa: F811
    from isegprobe_torch.inference.adaptive_eval import make_adaptive_evaluator
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_group,
        make_device_evaluator,
    )

    _, _, model = _models()
    with pytest.raises(ValueError, match="batch_size > 1"):
        make_device_evaluator(model, group_api=True, device="cpu")
    with pytest.raises(ValueError, match="batch_size > 1"):
        make_adaptive_evaluator(model, 56, group_api=True, device="cpu")
    ev = make_device_evaluator(model, batch_size=2, group_api=True,
                               device="cpu")
    data = _Scenes([_scene(0)])
    # several devices are ported: one job queue a device, the jobs dealt
    # round-robin, the results the one-device queue's
    many = _Scenes([_scene(s) for s in (0, 3, 5, 7, 11)])
    small = make_device_evaluator(model, batch_size=2, group_api=True,
                                  **_common())
    want = evaluate_dataset_group(small, many)
    stats = {}
    got = evaluate_dataset_group(small, many, devices=["cpu", "cpu"],
                                 stats=stats)
    assert [len(a) for a in got] == [len(a) for a in want]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert stats["devices"] == 2 and sum(stats["jobs_by_device"]) == 5
    assert min(stats["jobs_by_device"]) > 0
    with pytest.raises(ValueError, match="record_clicks"):
        evaluate_dataset_group(ev, data, clicks=[])


def test_device_queues_step_in_lockstep(tiny_arch, monkeypatch):  # noqa: F811
    """With two devices named, the per-device queues are stepped in
    lockstep: every device's step is started before either device's flags
    are read, so the second device's reads interleave with the first's
    instead of following them."""
    from isegprobe_torch.inference import device_eval

    _, _, model = _models()
    ev = device_eval.make_device_evaluator(model, batch_size=2,
                                           group_api=True, **_common())
    data = _Scenes([_scene(s) for s in SEEDS])
    want = device_eval.evaluate_dataset_group(ev, data)
    order = []
    read = device_eval.DeviceEvaluator._read

    def logged(self, flag):
        order.append(id(self))
        return read(self, flag)

    monkeypatch.setattr(device_eval.DeviceEvaluator, "_read", logged)
    stats: dict = {}
    got = device_eval.evaluate_dataset_group(ev, data, devices=["cpu"] * 2,
                                             stats=stats)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert min(stats["jobs_by_device"]) > 0
    first, second = ev.protocol, [i for i in order if i != id(ev.protocol)]
    assert len(set(second)) == 1
    # the reads alternate while both queues run
    last_first = max(i for i, k in enumerate(order) if k == id(first))
    first_second = order.index(second[0])
    assert first_second == 1 and last_first > first_second
    both = order[:2 * min(order.count(id(first)), len(second))]
    assert both[0::2] == [id(first)] * (len(both) // 2)
