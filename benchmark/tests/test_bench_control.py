"""The control on the card at a size a test run holds: the reference in
TF32 put in the program's place fails the cell's limits, and the program
passes them. Needs an NVIDIA GPU."""

from __future__ import annotations

import pytest

from benchmark import control
from benchmark import run as bench_run
from benchmark.lib import spec
from benchmark.tests.conftest import require_cuda


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["noup_eval_f32", "loftup_click_f32"])
def test_control_fails_and_program_passes(workload):
    require_cuda()
    import torch

    cell = spec.Cell(workload)
    cell.traffic["judge_objects"] = 3
    device = torch.device("cuda:0")
    for reading in control.control_readings(cell, [11, 12, 13], device):
        assert any(reading["gaps"][k] > v for k, v in cell.limits.items()), \
            reading
    line, _ = bench_run.run_cell(workload, 2**31 + 3, 5.0, 0)
    assert line["correct"] is True, line["compared"]
