"""The port's spans (``isegprobe_torch/utils/trace.py``) on the CPU at a tiny
size: nothing is recorded without a profiler; under ``torch.profiler`` the
host click protocol and the device loop record their spans with the right
parents and request ids, on the clock of the profiler's own host events;
and the results are the same with tracing on and off."""

import dataclasses
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from isegprobe_torch.utils import trace

torch.set_num_threads(2)

SIZE = 56
ARCH = "dinov2_trace_test"


@pytest.fixture
def arch(monkeypatch):
    """A 2-block, width-128 DINOv2 entry in the port's arch table."""
    from isegprobe_torch.models.featurizers import dinov2

    monkeypatch.setitem(dinov2.DINOV2_ARCHS, ARCH, dataclasses.replace(
        dinov2.DINOV2_ARCHS["dinov2_vits14"], embed_dim=128, depth=2,
        num_heads=2))


def _model(injection="before_backbone"):
    """A flagship-shaped probe at the tiny arch (identity upsampler,
    2-layer convhead, clicks and the previous mask patch-embedded) with
    drawn weights."""
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.models.vit import init_params

    cfg = dict(
        backbone_cfg=dict(type="dinov2", params=dict(
            arch=ARCH, feats_injection_mode=injection)),
        embed_coords_cfg=dict(type="patchEmbed", params=dict(
            img_size=(SIZE, SIZE), patch_size=(14, 14), embed_dim=128)),
        head_cfg=dict(type="convhead", params=dict(
            in_channels=128, num_layers=2, num_classes=1)),
        upsampler_cfg=dict(type="identity", params=dict()),
        use_disks=True, norm_radius=5, with_prev_mask=True)
    return init_params(iSegProbeModel(**cfg, device="cpu"), seed=0).eval()


@pytest.fixture
def model(arch):
    return _model()


def _scene(seed, hw=(60, 70)):
    rng = np.random.default_rng(seed)
    img = (rng.random((*hw, 3)) * 70).astype(np.uint8)
    gt = np.zeros(hw, np.int32)
    yy, xx = np.mgrid[:hw[0], :hw[1]]
    cy, cx = rng.uniform(0.3, 0.7) * hw[0], rng.uniform(0.3, 0.7) * hw[1]
    gt[((yy - cy) / (0.3 * hw[0])) ** 2 + ((xx - cx) / (0.35 * hw[1])) ** 2
       <= 1] = 1
    img[gt == 1] = rng.integers(120, 255, size=3)
    return img, gt


class _Scenes:
    def __init__(self, scenes):
        self.scenes = scenes

    def __len__(self):
        return len(self.scenes)

    def get_sample(self, index):
        image, gt = self.scenes[index]
        return SimpleNamespace(image=image, objects_ids=[0],
                               gt_mask=lambda _: gt)


def _traced(fn):
    """``fn()`` under a CPU ``torch.profiler``: (its result, the program's
    spans of the profiled stretch, the profiler's host ops on this
    thread)."""
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    try:
        out = fn()
    finally:
        prof.stop()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    tid = threading.get_native_id()
    recs = [r for r in trace.spans(t0, 2**63 - 1) if r[4] == tid]
    ops = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith("aten::")
           and e.device_resource_id() == tid]
    return out, recs, ops


def _by_serial(recs):
    return {r[0]: SimpleNamespace(serial=r[0], name=r[1], rid=r[2],
                                  parent=r[3], t0=r[5], t1=r[6])
            for r in recs}


def _predictor(model):
    from isegprobe_torch.inference.predictor import Predictor

    return Predictor(model, target_size=(SIZE, SIZE), with_flip=True,
                     net_clicks_limit=4, min_crop_size=20, device="cpu")


def _host_click(model, scenes, max_clicks=3):
    from isegprobe_torch.inference.evaluation import evaluate_sample

    pred = _predictor(model)
    out = []
    for img, gt in scenes:
        clicks, ious, probs = evaluate_sample(
            img, gt, pred, max_iou_thr=0.99, pred_thr=0.49,
            max_clicks=max_clicks)
        out.append(([(c.coords, c.is_positive) for c in clicks], ious,
                    probs))
    return out


def _device_loop(model, scenes, batch=2, max_clicks=3, target_iou=0.6,
                 **kw):
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )

    ev = make_device_evaluator(
        model, target_size=(SIZE, SIZE), max_clicks=max_clicks,
        net_clicks_limit=max_clicks, pred_thr=0.49, target_iou=target_iou,
        with_flip=True, min_crop_size=20,
        batch_size=batch, record_clicks=True, device="cpu", **kw)
    clicks: list = []
    ious = evaluate_dataset_device(ev, _Scenes(scenes), clicks=clicks)
    return ev, ious, clicks


def test_off_records_nothing():
    before = list(trace._ring)
    a, b = trace.span("click", rid=(0, 0)), trace.span("loop.step")
    assert a is b
    with a:
        with b:
            pass
    assert list(trace._ring) == before
    assert trace.spans(0, 2**63 - 1) == before


def test_host_click_spans(model):
    (result,), recs, ops = _traced(lambda: _host_click(model, [_scene(3)]))
    spans = _by_serial(recs)
    clicks = [s for s in spans.values() if s.name == "click"]
    assert len(clicks) == len(result[1]) >= 2
    assert {c.rid[1] for c in clicks} == set(range(len(clicks)))
    assert len({c.rid[0] for c in clicks}) == 1
    want = {"click": None, "clicker": "click", "predict": "click",
            "iou": "click", "predictor.roi": "predict",
            "predictor.crop": "predict", "predictor.forward": "predict",
            "predictor.paste": "predict", "predictor.to_host": "predict",
            "model.clicks": "predictor.forward",
            "model.backbone": "predictor.forward",
            "model.upsampler": "predictor.forward",
            "model.head": "predictor.forward"}
    assert {s.name for s in spans.values()} == set(want)
    for s in spans.values():
        parent = spans.get(s.parent)
        assert (parent.name if parent else None) == want[s.name], s.name
        if parent is not None:
            assert parent.t0 <= s.t0 <= s.t1 <= parent.t1
            assert s.rid == parent.rid
    counts = {n: sum(s.name == n for s in spans.values()) for n in want}
    assert set(counts.values()) == {len(clicks)}, counts
    # the clock: every host op either lies inside a span or misses it;
    # each span holds the ops it ran
    for s in spans.values():
        for a, b, name in ops:
            inside = s.t0 <= a and b <= s.t1
            assert inside or b <= s.t0 or a >= s.t1, (s.name, name)

    def ops_in(name):
        return {op for a, b, op in ops for s in spans.values()
                if s.name == name and s.t0 <= a and b <= s.t1}

    assert "aten::linear" in ops_in("model.backbone")
    assert "aten::conv2d" in ops_in("model.head")
    assert "aten::slice" in ops_in("predictor.to_host")
    linear = [(a, b) for a, b, op in ops if op == "aten::linear"]
    assert linear and all(
        any(s.name == "model.backbone" and s.t0 <= a and b <= s.t1
            for s in spans.values()) for a, b in linear)


def test_device_loop_spans(model):
    scenes = [_scene(s) for s in (0, 3, 5)]
    ev, *_ = _device_loop(model, scenes[:2])  # the evaluator, warmed
    steps0, reads0 = ev.steps, ev.host_reads
    from isegprobe_torch.inference.device_eval import evaluate_dataset_device

    _, recs, ops = _traced(lambda: evaluate_dataset_device(
        ev, _Scenes(scenes), clicks=[]))
    spans = _by_serial(recs)
    names = [s.name for s in spans.values()]
    assert names.count("loop.step") == ev.steps - steps0 > 0
    assert names.count("loop.read") == ev.host_reads - reads0
    assert names.count("loop.dataset") == 1
    assert names.count("loop.run") == names.count("loop.upload") == \
        names.count("loop.results") == names.count("loop.init") == 2
    want = {"loop.dataset": None, "loop.jobs": "loop.dataset",
            "loop.upload": "loop.dataset", "loop.run": "loop.dataset",
            "loop.results": "loop.dataset", "loop.init": "loop.run",
            "loop.step": "loop.run", "loop.clicker": "loop.step",
            "loop.crop": "loop.step", "loop.forward": "loop.step",
            "loop.score": "loop.step", "model.clicks": "loop.forward",
            "model.backbone": "loop.forward",
            "model.upsampler": "loop.forward", "model.head": "loop.forward"}
    for s in spans.values():
        parent = spans.get(s.parent)
        if s.name == "loop.read":
            assert parent.name in ("loop.init", "loop.step")
            continue
        assert (parent.name if parent else None) == want[s.name], s.name
        assert parent is None or parent.t0 <= s.t0 <= s.t1 <= parent.t1
    root = next(s for s in spans.values() if s.name == "loop.dataset")
    steps = sorted((s for s in spans.values() if s.name == "loop.step"),
                   key=lambda s: s.t0)
    assert [s.rid for s in steps] == list(range(steps0, ev.steps))
    for s in spans.values():
        top, ancestors = s, []
        while top.parent in spans:
            ancestors.append(top := spans[top.parent])
        assert top is root
        step = next((a for a in [s] + ancestors if a.name == "loop.step"),
                    None)
        assert s.rid == (step.rid if step else root.rid)
    assert any(s.t0 <= a and b <= s.t1 for a, b, op in ops
               if op == "aten::linear" for s in spans.values()
               if s.name == "model.backbone")


def test_trunk_recompute_spans(arch):
    """With the trunk cache, each recompute is a ``loop.trunk`` span inside
    its step, and every read, the recompute flags' too, a ``loop.read``."""
    late = _model("after_backbone")
    (ev, _ious, _clicks), recs, _ = _traced(
        lambda: _device_loop(late, [_scene(s) for s in (0, 3, 5, 7)],
                             batch=3, max_clicks=4, target_iou=0.3,
                             trunk_cache="on"))
    spans = _by_serial(recs)
    names = [s.name for s in spans.values()]
    assert names.count("loop.read") == ev.host_reads > ev.steps
    assert names.count("loop.trunk") == ev.trunk_recomputes > 0
    assert all(spans[s.parent].name == "loop.step"
               for s in spans.values() if s.name == "loop.trunk")
    assert "model.clicks" in names and "model.backbone" in names


@pytest.mark.parametrize("path", ["host", "device"])
def test_same_results_traced(model, path):
    scenes = [_scene(s) for s in (0, 3, 5)]
    if path == "host":
        def run():
            return _host_click(model, scenes)
    else:
        def run():
            _ev, ious, clicks = _device_loop(model, scenes)
            return ious, clicks
    off = run()
    on, recs, _ = _traced(run)
    assert recs
    if path == "host":
        for (c0, i0, p0), (c1, i1, p1) in zip(off, on):
            assert c0 == c1
            np.testing.assert_array_equal(i0, i1)
            np.testing.assert_array_equal(p0, p1)
    else:
        for a, b in zip(off[0] + off[1], on[0] + on[1]):
            np.testing.assert_array_equal(a, b)
