"""Host-side pieces around kernel E (the fused JBU filter): the ptxas report
that ``bench_jbu.py``, ``bench_flash_core.py`` and ``chip_smoke.py`` read
through ``cuda_lib.ptxas_entries``, and ``bench_jbu.py`` itself at a tiny
size on the CPU (the plain version in both legs, nothing timed)."""

import pytest
import torch

from isegprobe_torch.ops import cuda_lib
from isegprobe_torch.scripts import bench_jbu

# the ptxas lines of one nvcc -Xptxas -v build of csrc/jbu.cu, in the form
# CUDA 12 prints them (a device function, then the kernel)
LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Function properties for _Z6helperv
    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_110jbu_kernelEPKfS1_S1_Pfiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_110jbu_kernelEPKfS1_S1_Pfiiiii
    16 bytes stack frame, 12 bytes spill stores, 20 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]
"""


def test_ptxas_entries_read_registers_and_spills():
    entries = cuda_lib.ptxas_entries(LOG)
    assert entries == {
        "_Z6helperv": {"registers": None, "stack_bytes": 8,
                       "spill_stores": 0, "spill_loads": 0},
        "_ZN12_GLOBAL__N_110jbu_kernelEPKfS1_S1_Pfiiiii": {
            "registers": 168, "stack_bytes": 16, "spill_stores": 12,
            "spill_loads": 20}}
    assert cuda_lib.ptxas_entries("") == {}


def test_bench_jbu_runs_on_cpu_at_a_tiny_size():
    rec = bench_jbu.main(device="cpu", label="tiny", source=(1, 2, 3, 8),
                         shapes=[(1, 8, 9, 8), (2, 4, 4, 3)])
    stack = rec["stack"]
    assert rec["label"] == "tiny" and rec["device"] == "cpu"
    assert stack["ok"] and stack["out"] == [1, 32, 48, 8]
    assert stack["max_abs_err"] == 0.0  # the plain version in both legs
    assert stack["launches"] == 0 and stack["ms"] is None
    assert rec["ms"] == {"1x8x9x8": None, "2x4x4x3": None}  # CPU: not timed


def test_bench_jbu_raises_without_a_gpu_unless_asked_for_the_cpu(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        bench_jbu.main(source=(1, 2, 2, 4), shapes=[])
