"""Fixtures of the benchmark's CPU tests: a cell cut to a size the CPU can
run (one ViT block, 112x112 crops, 2 lanes, 3 clicks), with the program and
the reference cut alike. Tests marked ``cuda`` need the card and decide so
inside the test."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where "
        "torch.cuda.is_available() is false")


TINY_SCENES = dict(seed=7, min_area=100, groups=[
    dict(hw=[480, 854], objects=2), dict(hw=[321, 481], objects=2)])


@pytest.fixture
def tiny(monkeypatch):
    """Cells cut to one ViT block at 112x112 and four objects at the
    largest and the smallest frame size: the program's DINOv2 table and
    every ``spec.Cell`` the run builds."""
    from benchmark.lib import scenes, spec
    from isegprobe_torch.models.featurizers import dinov2

    small_scenes = dict(TINY_SCENES)
    small_scenes["sha256"] = scenes.digest(scenes.draw(small_scenes))

    arch = dinov2.DINOV2_ARCHS["dinov2_vits14"]
    monkeypatch.setitem(dinov2.DINOV2_ARCHS, "dinov2_vits14",
                        dataclasses.replace(arch, depth=1))
    orig = spec.Cell.__init__

    def small(self, name, bench=None):
        orig(self, name, bench)
        self.config["backbone"]["num_hidden_layers"] = 1
        self.traffic.update(target_size=[112, 112], lanes=2, max_clicks=3,
                            judge_objects=2, judge_batches=2,
                            trace_seconds=1, scenes=small_scenes)

    monkeypatch.setattr(spec.Cell, "__init__", small)
    return spec


def require_cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
