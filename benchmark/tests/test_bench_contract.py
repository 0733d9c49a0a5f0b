"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name."""

from __future__ import annotations

import json
import re

import pytest

from benchmark.lib import scenes, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def names(bench):
    """Every name in the file, for the contract's character checks."""
    out = [c["name"] for c in bench["configs"]]
    for w in bench["workloads"]:
        out += [w["name"], w["config"], w["traffic"]]
    out += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for c in bench["configs"]:
        out += list(c["reduced"])
    return out


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    assert 1 <= cells <= 24
    # a full check: 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a
    # cell to compile, 1200 s spare; with the full 24 cells
    assert ((2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180
            + 1200) <= 43200


@pytest.mark.parametrize("name", names(BENCH))
def test_names_use_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entries(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    if metric in BENCH["end_to_end"]:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert metric["moves"] in e2e
        assert 1 <= len(metric["layer"]) <= 200
        for w in metric["workloads"]:
            moved = [m for m in BENCH["end_to_end"]
                     if m["name"] == metric["moves"]][0]
            assert w in moved.get("workloads", WORKLOADS)
        assert callable(spec.metric_reader(metric["name"]))
    for w in metric.get("workloads", []):
        assert w in WORKLOADS


def test_setup_bound():
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"][0]
    assert setup["bound"] <= 0.25 and "workloads" not in setup


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_is_found_by_name(workload):
    cell = spec.Cell(workload)
    assert cell.entry["chips"] in (1, 4)
    assert 1 <= len(cell.entry["why"]) <= 200
    assert set(cell.entry) == {"name", "config", "traffic", "chips", "why"}
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    assert cell.traffic["client"] in ("device_loop", "host_click")
    assert hasattr(spec.client(cell.traffic["client"]), "prepare")
    assert cell.limits
    assert cell.checkpoint().is_file()
    assert {"seed", "min_area", "groups", "sha256",
            "sizes_source"} <= set(cell.traffic["scenes"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert conf["file"].startswith("benchmark/")
    cfg = spec.read_json(spec.ROOT / conf["file"])
    assert conf["reduced"] == cfg["reduced"] == []
    assert cfg["source"] == conf["source"]
    assert cfg["assumed"]
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(conf["file"]) == 1


@pytest.mark.parametrize("workload", WORKLOADS)
def test_pinned_inputs_match_their_hashes(workload):
    cell = spec.Cell(workload)
    assert spec.sha256(spec.ROOT / cell.config["checkpoint"]) == \
        cell.config["checkpoint_sha256"]
    objs = scenes.objects(cell.traffic["scenes"])
    assert len(objs) == sum(g["objects"]
                            for g in cell.traffic["scenes"]["groups"])
    for o in objs:
        group = cell.traffic["scenes"]["groups"][o["group"]]
        assert o["image"].shape == (*group["hw"], 3)
        assert o["gt"].sum() >= cell.traffic["scenes"]["min_area"]


def test_a_changed_input_is_refused(tmp_path, monkeypatch):
    cell = spec.Cell(WORKLOADS[0])
    copy = tmp_path / "model.ckpt"
    copy.write_bytes((spec.ROOT / cell.config["checkpoint"]).read_bytes()
                     + b"\0")
    monkeypatch.setattr(spec, "ROOT", tmp_path)
    with pytest.raises(RuntimeError, match="sha256"):
        spec.pinned("model.ckpt", cell.config["checkpoint_sha256"])
    changed = dict(cell.traffic["scenes"], seed=cell.traffic["scenes"]
                   ["seed"] + 1)
    with pytest.raises(RuntimeError, match="sha256"):
        scenes.objects(changed)
