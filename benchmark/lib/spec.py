"""What a cell is made of, found by name: ``BENCHMARK.json``'s entry, the
configuration's file, the traffic mix's file (``traffic/<traffic>.json``),
the cell's limits (``limits/<workload>.json``) and the per-layer metrics'
readers (``metrics/<name>.py``). Inputs named in these files are pinned by
sha256: a checkpoint's file here, a traffic's drawn scenes in
``scenes.py``."""

from __future__ import annotations

import hashlib
import importlib.util
import json
from pathlib import Path
from typing import Dict

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return read_json(ROOT / "BENCHMARK.json")


def sha256(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def pinned(rel: str, digest: str) -> Path:
    """The repository file ``rel``, after checking its sha256."""
    path = ROOT / rel
    got = sha256(path)
    if got != digest:
        raise RuntimeError(f"{rel}: sha256 {got}, the benchmark pins "
                           f"{digest}")
    return path


class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    def __init__(self, name: str, bench: Dict = None) -> None:
        bench = bench or benchmark()
        found = [w for w in bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = found[0]
        self.name = name
        conf = [c for c in bench["configs"]
                if c["name"] == self.entry["config"]][0]
        self.config_entry = conf
        self.config = read_json(ROOT / conf["file"])
        self.traffic = read_json(BENCH_DIR / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.limits = read_json(BENCH_DIR / "limits" / f"{name}.json")
        self.end_to_end = [m for m in bench["end_to_end"]
                           if name in m.get("workloads", [name])]
        moved = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if name in m.get("workloads", [])
                          or ("workloads" not in m and m["moves"] in moved)]

    def checkpoint(self) -> Path:
        return pinned(self.config["checkpoint"],
                      self.config["checkpoint_sha256"])


def metric_reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def client(kind: str):
    """The ``clients/<kind>.py`` module that runs a traffic mix's kind of
    client."""
    return importlib.import_module(f"benchmark.clients.{kind}")
