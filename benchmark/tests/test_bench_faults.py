"""The check that decides ``correct`` sees the faults a cell can have: the
program broken underneath the timed path, the rest of a run driven at a
tiny size on the CPU, and ``correct`` must come out false. One chip, so no
exchange between chips can be left out."""

from __future__ import annotations

import pytest
import torch

from benchmark import run as bench_run


def _run(workload):
    line, _ = bench_run.run_cell(workload, 2**31 + 11, 1.0, 0,
                                 device="cpu", require_cuda=False)
    return line


def _loop_unchanged_state(monkeypatch):
    from isegprobe_torch.inference.device_eval import DeviceEvaluator

    body = DeviceEvaluator._body

    def stale(self, st, active):
        new = body(self, st, active)
        new["prev"] = st["prev"]  # the click leaves the mask state as it was
        return new

    monkeypatch.setattr(DeviceEvaluator, "_body", stale)


def _half_batch(monkeypatch):
    from isegprobe_torch.models.probe_model import iSegProbeModel

    forward = iSegProbeModel.forward

    def half(self, image, points):
        b = image.shape[0] // 2
        out = forward(self, image[:b], points[:b])
        inst = out["instances"]
        return dict(out, instances=torch.cat([inst, inst], 0))

    monkeypatch.setattr(iSegProbeModel, "forward", half)


def _loop_altered_answer(monkeypatch):
    from isegprobe_torch.inference.device_eval import DeviceEvaluator

    score = DeviceEvaluator._score

    def altered(self, st, prev):
        out = score(self, st, prev)
        out["ious"] = out["ious"] + 1e-3
        return out

    monkeypatch.setattr(DeviceEvaluator, "_score", altered)


def _host_unchanged_state(monkeypatch):
    from isegprobe_torch.inference.predictor import Predictor

    def stale(self, clicker, prev_mask=None):
        return self.prev_prediction  # nothing recomputed

    monkeypatch.setattr(Predictor, "get_prediction", stale)


def _host_altered_answer(monkeypatch):
    from isegprobe_torch.inference.predictor import Predictor

    predict = Predictor.get_prediction

    def altered(self, clicker, prev_mask=None):
        return predict(self, clicker, prev_mask) * 0.99

    monkeypatch.setattr(Predictor, "get_prediction", altered)


@pytest.mark.parametrize("workload, fault", [
    ("noup_eval_f32", _loop_unchanged_state),
    ("noup_eval_f32", _half_batch),
    ("noup_eval_f32", _loop_altered_answer),
    ("loftup_click_f32", _host_unchanged_state),
    ("loftup_click_f32", _half_batch),
    ("loftup_click_f32", _host_altered_answer),
], ids=lambda v: getattr(v, "__name__", v))
def test_fault_is_not_correct(tiny, monkeypatch, workload, fault):
    fault(monkeypatch)
    line = _run(workload)
    assert line["correct"] is False, line["compared"]
