"""What surrounds the shared flash core of kernels A, D, F and G
(``isegprobe_torch/csrc/flash_core.cuh``) that runs on the CPU: the library
hash over shared headers, the tile plan and the SM count it reads, and
kernel D's K/V relayout."""

import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from isegprobe_torch.ops import attention, cuda_lib


def test_library_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_lib.CSRC, csrc,
                    ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(cuda_lib, "CSRC", csrc)
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", csrc / "build")
    before = {name: cuda_lib.library_path(name) for name in cuda_lib.SOURCES}
    assert all(p.parent == csrc / "build" for p in before.values())
    header = csrc / "flash_core.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: cuda_lib.library_path(name) for name in cuda_lib.SOURCES}
    assert all(after[n] != before[n] for n in cuda_lib.SOURCES)
    # a new header counts as well; an edited source moves only its library
    (csrc / "extra.cuh").write_text("#pragma once\n")
    again = {name: cuda_lib.library_path(name) for name in cuda_lib.SOURCES}
    assert all(again[n] != after[n] for n in cuda_lib.SOURCES)
    src = csrc / "mha.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    last = {name: cuda_lib.library_path(name) for name in cuda_lib.SOURCES}
    assert [n for n in cuda_lib.SOURCES if last[n] != again[n]] == ["mha"]


def test_library_path_is_stable():
    assert cuda_lib.library_path("attention") == cuda_lib.library_path(
        "attention")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,dh,tile", [
    (2, 1025, 6, 64, 64),      # A at the host protocol's batch: 108 blocks
    (16, 1025, 6, 64, 128),    # A at the device loop's batch 16
    (8, 1025, 6, 64, 128),     # 9 x 6 x 8 = 432 blocks
    (2, 28672, 4, 101, 128),   # D at LoftUp's slab, B=2
    (8, 28672, 4, 101, 128),   # D at the family loop's batch
    (2, 1000, 4, 101, 64),     # 8 x 4 x 2 = 64 blocks
    (1, 5, 2, 40, 64),
])
def test_plan_picks_the_tile_by_the_grid(dtype, b, n, heads, dh, tile):
    """128 rows where the grid then holds two blocks per SM; f32 with dh <=
    64 keeps 64 rows (the faster there on the H100)."""
    q_tile, aligned = attention._plan(b, n, heads, dh, dtype)
    if dtype == torch.float32 and dh <= 64:
        tile = 64
    assert q_tile == tile
    blocks128 = -(-n // 128) * heads * b
    assert (q_tile == 128) <= (blocks128 >= 2 * attention.sm_count())
    assert aligned == (dh % (8 if dtype == torch.bfloat16 else 4) == 0)


def test_plan_follows_the_cards_sm_count(monkeypatch):
    """On a CUDA device the tile rule reads the card's SM count (once per
    device): [4, 1025, 7 x 64] in bf16 is 252 blocks of 128 rows, two an SM
    on 114 SMs but not on an H100's 132."""
    sms = {0: 114, 1: 132}
    calls = []

    def props(index):
        calls.append(index)
        return SimpleNamespace(multi_processor_count=sms[index])

    attention._cuda_sms.cache_clear()
    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    try:
        assert attention.sm_count(torch.device("cuda", 0)) == 114
        assert attention.sm_count("cuda:1") == 132
        assert attention.sm_count() == attention.sm_count("cpu") == 132
        plan = [attention._plan(4, 1025, 7, 64, torch.bfloat16, device)
                for device in ("cuda:0", torch.device("cuda", 1), None)]
        assert [t for t, _ in plan] == [128, 64, 64]
        # f32 at dh <= 64 keeps 64 rows on any card
        assert attention._plan(4, 1025, 7, 64, torch.float32,
                               "cuda:0")[0] == 64
        assert sorted(set(calls)) == [0, 1] and len(calls) == 2
    finally:
        attention._cuda_sms.cache_clear()


@pytest.mark.parametrize("dh,bf16,f32", [(13, False, False),
                                         (101, False, False),
                                         (40, True, True), (64, True, True),
                                         (128, True, True),
                                         (100, False, True)])
def test_plan_marks_the_load_path(dh, bf16, f32):
    """The 16-byte path takes rows of whole 16-byte chunks: dh = 13 (bf16)
    and dh = 101 (both dtypes) take the element loads."""
    assert attention._plan(2, 1025, 6, dh, torch.bfloat16)[1] is bf16
    assert attention._plan(2, 1025, 6, dh, torch.float32)[1] is f32


@pytest.mark.parametrize("dh,bf16,f32", [(1, 16, 8), (13, 16, 16),
                                         (40, 48, 40), (64, 64, 64),
                                         (101, 112, 104), (126, 128, 128),
                                         (128, 128, 128)])
def test_kv_width_rounds_up_to_32_bytes(dh, bf16, f32):
    assert attention._kv_width(dh, torch.bfloat16) == bf16
    assert attention._kv_width(dh, torch.float32) == f32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,heads,dh", [(2, 37, 50, 4, 101),
                                              (1, 9, 1, 2, 13),
                                              (2, 20, 65, 3, 64)])
def test_relayout_kv_keeps_the_function(dtype, b, nq, nk, heads, dh):
    rng = np.random.default_rng(nq + nk + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               .to(dtype) for s in ((b, nq, heads, dh), (b, nk, heads, dh),
                                    (b, nk, heads, dh)))
    dhp = attention._kv_width(dh, dtype)
    kv = attention._relayout_kv(k, v, dhp)
    assert kv.shape == (2, b, heads, nk, dhp) and kv.dtype == dtype
    assert kv.is_contiguous()
    assert bool((kv[..., dh:] == 0).all())
    assert torch.equal(kv[0, ..., :dh], k.transpose(1, 2))
    assert torch.equal(kv[1, ..., :dh], v.transpose(1, 2))
    # the plain function of the relaid (zero-padded) tensors, cut back to
    # dh, is the plain function of the originals
    qp = torch.zeros((b, nq, heads, dhp), dtype=dtype)
    qp[..., :dh] = q
    scale = dh**-0.5
    got = attention._mha_plain(qp, kv[0].transpose(1, 2),
                               kv[1].transpose(1, 2), scale)[..., :dh]
    want = attention._mha_plain(q, k, v, scale)
    torch.testing.assert_close(got.float(), want.float(), rtol=1e-5,
                               atol=1e-5)


def test_cpu_entries_take_a_plan_and_compute_the_plain_version():
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 9, 3 * 2 * 16))
                           .astype(np.float32))
    before = attention.mha_qkv.launches
    got = attention.mha_qkv(qkv, 2, plan=(128, False))
    assert attention.mha_qkv.launches == before
    torch.testing.assert_close(got, attention._mha_qkv_plain(qkv, 2, 0.25))
    q = qkv[..., :32].reshape(2, 9, 2, 16).contiguous()
    got = attention.mha(q, q, q, plan=(64, False))
    torch.testing.assert_close(got, attention._mha_plain(q, q, q, 0.25))


def test_bench_flash_core_needs_a_card():
    """The core's timing script refuses to run without a CUDA device (it
    times on the card only; chip_smoke.py checks the kernels)."""
    from isegprobe_torch.scripts import bench_flash_core

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="needs a CUDA device"):
        bench_flash_core.main()


def test_bench_flash_core_build_report_reads_the_ptxas_report(monkeypatch):
    """The core's build summary counts C7515 lines and names the bf16
    entries that spill, from the report ``cuda_lib.build`` returns."""
    from isegprobe_torch.scripts import bench_flash_core

    log = ("ptxas info    : Function properties for k_bf16_64\n"
           "    0 bytes stack frame, 24 bytes spill stores, 24 bytes spill "
           "loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n"
           "ptxas info    : Function properties for k_f32_64\n"
           "    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill "
           "loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n"
           "ptxas info    : Function properties for k_bf16_128\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\n"
           "ptxas info    : Used 168 registers, used 1 barriers\n"
           "ptxas warning : (C7515) wgmma serialized in k_bf16_128\n")
    monkeypatch.setattr(cuda_lib, "build",
                        lambda names: {"attention": log, "mha": ""})
    rep = bench_flash_core.build_report()
    assert rep["built"] == ["attention", "mha"] and rep["c7515"] == 1
    assert rep["bf16_spill_stores"] == {"attention": {"k_bf16_64": 24}}
