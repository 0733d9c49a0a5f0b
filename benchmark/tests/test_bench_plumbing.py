"""Each cell's whole run at a tiny size on the CPU: the result line's keys,
a judged sample, no device metric without a device; and the harness's
refusals."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import run as bench_run
from benchmark.lib import spec

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_at_a_tiny_size(tiny, workload, trace):
    line, verdict = bench_run.run_cell(workload, 2**31 + 7, 1.0, trace,
                                       device="cpu", require_cuda=False)
    assert list(line)[:5] == KEYS and list(line)[-1] == "compared"
    assert line["correct"] is True, line["compared"]
    assert verdict["judged"] >= 1 and line["attempted"] > 0
    assert line["device"]["platform"] == "cpu"
    assert "busy_s" not in line["device"] and "breakdown" not in line
    cell = spec.Cell(workload)
    if trace:
        device_metrics = {m["name"] for m in cell.per_layer
                          if m["source"] == "device_trace"}
        assert line["metrics"] and not device_metrics & set(line["metrics"])
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for c in line["compared"].values():
        assert c["value"] <= c["limit"]
    json.dumps(line)


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert bench_run.main(["--workload", WORKLOADS[0], "--seed", "1",
                           "--seconds", "1", "--trace", "0"]) == 2
    assert capsys.readouterr().out == ""


def test_nothing_of_jax_is_loaded():
    """The harness and the reference import neither JAX nor the JAX
    package (top-level names compared whole: the port's name begins with
    the JAX package's), and the reference imports nothing of the
    program."""
    code = (
        "import sys; sys.path.insert(0, '.');"
        "import benchmark.reference.model, benchmark.reference.protocol,"
        " benchmark.reference.weights, benchmark.lib.roofline,"
        " benchmark.lib.scenes;"
        "tops = {m.split('.')[0] for m in sys.modules};"
        "assert not tops & {'jax', 'jaxlib', 'flax', 'isegprobe_tpu',"
        " 'isegprobe_torch'}, tops;"
        "import benchmark.run, benchmark.control, benchmark.lib.spec,"
        " benchmark.clients.device_loop, benchmark.clients.host_click;"
        "import isegprobe_torch.evaluate, isegprobe_torch.inference.device_eval;"
        "assert not benchmark.run.forbidden_modules(), "
        "benchmark.run.forbidden_modules()")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=spec.ROOT, timeout=300)


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "isegprobe_tpu_like", sys)
    assert "isegprobe_tpu_like" not in bench_run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax.numpy" in bench_run.forbidden_modules()


def test_one_user_order_holds_the_same_sizes_for_every_seed():
    """The host client's pass: every object once, and the frame size of
    each position the same whatever the seed."""
    import numpy as np

    from benchmark.clients import host_click

    cell = spec.Cell("loftup_click_f32")
    groups = []
    for g, group in enumerate(cell.traffic["scenes"]["groups"]):
        groups += [g] * group["objects"]
    passes = [host_click.order(cell.traffic, np.random.default_rng(s))
              for s in (1, 2, 2**31 + 9)]
    for p in passes:
        assert sorted(p) == list(range(len(groups)))
    sizes = [[groups[i] for i in p] for p in passes]
    assert sizes[0] == sizes[1] == sizes[2]
    assert passes[0] != passes[1]
