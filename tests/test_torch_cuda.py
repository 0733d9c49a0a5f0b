"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test needs an NVIDIA GPU and skips where ``torch.cuda.is_available()``
is false. The file imports neither JAX nor the JAX package, so it also runs
on a machine without them, where tests/conftest.py (which imports JAX) must
be left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: f32 differs only in summation order, rsqrtf and the online
softmax (~1e-6 relative), so 1e-5; bf16 outputs may differ by one bf16
rounding step (2^-8 relative), so 2e-2. The EDT row kernel computes exact
integers in f32 and is held bitwise to its plain version. The JBU kernel
(E) and its plain version clamp different normalisers, which agree where
neither clamp binds (sigma 0.8 here); E's output is a weighted mean of 49
inputs, which errs relative to the inputs summed, so its absolute tolerance
is 1e-5 of max |hr|.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from isegprobe_torch.ops import attention, edt, jbu, layernorm

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,dh", [(2, 1025, 6, 64), (2, 131, 3, 16),
                                           (1, 77, 2, 128), (1, 5, 2, 40),
                                           (2, 257, 8, 32)])
def test_attention_kernel_matches_plain(cuda_device, dtype, b, n, heads, dh):
    qkv = _randn((b, n, 3 * heads * dh), n, cuda_device, dtype)
    before = attention.mha_qkv.launches
    got = attention.mha_qkv(qkv, heads)
    torch.cuda.synchronize()
    assert attention.mha_qkv.launches == before + 1
    assert got.shape == (b, n, heads * dh) and got.dtype == dtype
    want = attention._mha_qkv_plain(qkv, heads, dh**-0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,w_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("shape", [(2, 1025, 384), (300, 128), (7, 100),
                                   (3, 1024)])
def test_layernorm_kernel_matches_plain(cuda_device, dtype, w_dtype, shape):
    x = (_randn(shape, 0, cuda_device) * 3 + 1).to(dtype)
    w = (_randn(shape[-1:], 1, cuda_device) * 0.5 + 1).to(w_dtype)
    bias = _randn(shape[-1:], 2, cuda_device, w_dtype)
    before = layernorm.layernorm.launches
    got = layernorm.layernorm(x, w, bias)
    torch.cuda.synchronize()
    assert layernorm.layernorm.launches == before + 1
    assert got.dtype == dtype
    want = layernorm._ln_plain(x, w, bias, 1e-6)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 2, 66, 82), (64, 64), (5, 33, 129),
                                   (3, 1, 4096), (7, 1)])
def test_edt_row_kernel_matches_plain_bitwise(cuda_device, shape):
    """Random masks through the column pass, one with a zero-free column,
    then the row pass: kernel C equals the plain version bit for bit."""
    rng = np.random.default_rng(sum(shape))
    zero = rng.random(shape) < 0.05
    zero[..., 0] = False  # a column without any zero: g = 1e6 there
    g = edt._column_pass(torch.from_numpy(zero).to(cuda_device))
    before = edt.row_envelope.launches
    got = edt.row_envelope(g)
    torch.cuda.synchronize()
    assert edt.row_envelope.launches == before + 1
    want = edt._row_envelope_plain(g)
    assert torch.equal(got, want)
    ones = torch.ones((2, 9, 13), dtype=torch.bool, device=cuda_device)
    assert bool((edt.edt_l2sq_device(ones) == edt.BIG2).all())


@pytest.mark.cuda
def test_clicker_ties_take_the_first_maximum(cuda_device):
    """Two equal false-positive squares: on the card the click goes to the
    first row-major maximum (the upper square's centre), as on the host."""
    pred = torch.zeros((2, 40, 52), dtype=torch.bool, device=cuda_device)
    pred[:, 5:10, 5:10] = pred[:, 20:25, 30:35] = True
    gt = torch.zeros_like(pred)
    is_pos, y, x = edt.next_click_from_error(gt, pred, ~gt)
    assert is_pos.tolist() == [False, False]
    assert y.tolist() == [7, 7] and x.tolist() == [7, 7]


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    qkv = _randn((1, 9, 3 * 2 * 64), 0, cuda_device)
    with pytest.raises(ValueError):
        attention.mha_qkv(qkv[:, ::2], 2)  # not contiguous
    with pytest.raises(TypeError):
        attention.mha_qkv(qkv.half(), 2)
    with pytest.raises(ValueError):
        attention.mha_qkv(_randn((1, 9, 3 * 256), 0, cuda_device), 1)  # dh 256
    with pytest.raises(NotImplementedError):
        attention.mha_qkv(qkv.requires_grad_(), 2)
    x = _randn((4, 2048), 0, cuda_device)
    with pytest.raises(ValueError):
        layernorm.layernorm(x, torch.ones(2048, device=cuda_device),
                            torch.zeros(2048, device=cuda_device))  # D > 1024
    with pytest.raises(TypeError):
        edt.row_envelope(x.double())
    with pytest.raises(ValueError):
        edt.row_envelope(x.t())  # not contiguous
    with pytest.raises(ValueError):
        edt.row_envelope(_randn((2, 4097), 0, cuda_device))  # W > 4096


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,heads,dh", [
    (2, 1000, 1024, 4, 101), (1, 300, 77, 2, 64), (2, 129, 200, 3, 13),
    (1, 64, 1, 1, 128), (1, 5, 130, 2, 40)])
def test_cross_attention_kernel_matches_plain(cuda_device, dtype, b, nq, nk,
                                              heads, dh):
    q = _randn((b, nq, heads, dh), nq, cuda_device, dtype)
    k = _randn((b, nk, heads, dh), nk, cuda_device, dtype)
    v = _randn((b, nk, heads, dh), nk + 1, cuda_device, dtype)
    before = attention.mha.launches
    got = attention.mha(q, k, v)
    torch.cuda.synchronize()
    assert attention.mha.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    want = attention._mha_plain(q, k, v, dh**-0.5)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,k", [(2, 64, 64, 384, 32),
                                       (1, 37, 50, 48, 32),
                                       (2, 16, 258, 40, 20),
                                       (1, 4, 5, 3, 33)])
def test_jbu_kernel_matches_plain(cuda_device, b, h, w, c, k):
    hr = _randn((b, h, w, c), c, cuda_device)
    proj = _randn((b, h, w, k), k, cuda_device)
    temp = torch.tensor(0.5, device=cuda_device)
    sigma = torch.tensor(0.8, device=cuda_device)
    before = jbu.jbu_filter.launches
    got = jbu.jbu_filter(hr, proj, temp, sigma)
    torch.cuda.synchronize()
    assert jbu.jbu_filter.launches == before + 1
    want = jbu._jbu_plain(hr, proj, temp, sigma)
    scale = float(hr.abs().max())
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5 * scale)
    # bf16 features are filtered in f32 and returned in bf16
    got16 = jbu.jbu_filter(hr.bfloat16(), proj, temp, sigma)
    assert got16.dtype == torch.bfloat16
    want16 = jbu._jbu_plain(hr.bfloat16(), proj, temp, sigma)
    torch.testing.assert_close(got16.float(), want16.float(), rtol=2e-2,
                               atol=2e-2 * scale)


@pytest.mark.cuda
def test_kernels_d_and_e_raise_on_what_they_do_not_take(cuda_device):
    q = _randn((1, 9, 2, 16), 0, cuda_device)
    with pytest.raises(TypeError):
        attention.mha(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        attention.mha(q[:, ::2], q, q)  # not contiguous
    with pytest.raises(ValueError):
        attention.mha(q, q[:, :, :1], q[:, :, :1])  # heads differ
    big = _randn((1, 9, 1, 160), 0, cuda_device)
    with pytest.raises(ValueError):
        attention.mha(big, big, big)  # dh > 128
    with pytest.raises(NotImplementedError):
        attention.mha(q.requires_grad_(), q, q)
    hr = _randn((1, 8, 8, 4), 0, cuda_device)
    with pytest.raises(TypeError):
        jbu.jbu_filter(hr.double(), hr, 0.5, 0.8)
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr, hr[:, :4], 0.5, 0.8)  # proj of another size
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr[:, :3], hr[:, :3], 0.5, 0.8)  # H < 4


@pytest.mark.cuda
@pytest.mark.parametrize("family", ["loftup", "jbu_featup"])
def test_small_learned_upsampler_probe_matches_cpu(cuda_device, family):
    """A 112² probe of each learned family at full width (LoftUp banded in
    slabs of 16 rows): the card's forward equals the CPU forward, with the
    expected launches of kernels A, B, D and E."""
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params

    up = {"loftup": dict(type="loftup", params=dict(
              n_dim=384, query_chunk_rows=16, query_chunk_min_pixels=0)),
          "jbu_featup": dict(type="jbu_featup", params=dict(
              backbone_type="dinov2", use_norm=True))}[family]
    cfg = dict(flagship_config((112, 112)), upsampler_cfg=up)
    model = init_params(iSegProbeModel(**cfg, device=cuda_device),
                        seed=0).eval()
    cpu = iSegProbeModel(**cfg, device="cpu").eval()
    cpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((2, 112, 112, 4), dtype=np.float32))
    points = torch.full((2, 8, 3), -1.0)
    points[:, 0] = torch.tensor([50.0, 60.0, 0.0])
    attention.mha_qkv.launches = layernorm.layernorm.launches = 0
    attention.mha.launches = jbu.jbu_filter.launches = 0
    with torch.inference_mode():
        got = model(image.to(cuda_device), points.to(cuda_device))
        got = got["instances"].cpu()
        counts = (attention.mha_qkv.launches, layernorm.layernorm.launches,
                  attention.mha.launches, jbu.jbu_filter.launches)
        want = cpu(image, points)["instances"]
    # LoftUp: 7 slabs of 16 rows, each 2 layers of kernel D and 8 norms,
    # plus its input ChannelNorm; JBU: 4 stages of kernel E
    assert counts == ((12, 25 + 1 + 7 * 8, 14, 0) if family == "loftup"
                      else (12, 25, 0, 4))
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * max(1.0, scale))


@pytest.mark.cuda
def test_small_probe_forward_matches_cpu(cuda_device):
    """A 112² flagship-width probe (12 blocks): the card's forward through
    the kernels equals the CPU forward through the plain versions, with 12
    attention and 25 LayerNorm launches."""
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params

    cfg = flagship_config((112, 112))
    model = init_params(iSegProbeModel(**cfg, device=cuda_device),
                        seed=0).eval()
    cpu = iSegProbeModel(**cfg, device="cpu").eval()
    cpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((2, 112, 112, 4), dtype=np.float32))
    points = torch.full((2, 8, 3), -1.0)
    points[:, 0] = torch.tensor([50.0, 60.0, 0.0])
    attention.mha_qkv.launches = layernorm.layernorm.launches = 0
    with torch.inference_mode():
        got = model(image.to(cuda_device), points.to(cuda_device))
        got = got["instances"].cpu()
        assert (attention.mha_qkv.launches, layernorm.layernorm.launches) == (
            12, 25)
        want = cpu(image, points)["instances"]
    scale = float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * max(1.0, scale))


@pytest.mark.cuda
def test_device_loop_matches_cpu(cuda_device):
    """A 112² flagship-width probe through the on-device click loop at two
    lanes: the card's trajectories equal the CPU loop's (same lengths, IoU
    within 1e-3: pixels at the 0.49 threshold), with one kernel C launch
    per loop step."""
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params

    cfg = flagship_config((112, 112))
    model = init_params(iSegProbeModel(**cfg, device=cuda_device),
                        seed=0).eval()
    cpu = iSegProbeModel(**cfg, device="cpu").eval()
    cpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(1)
    scenes = []
    for _ in range(3):
        img = rng.integers(0, 90, (100, 130, 3), dtype=np.uint8)
        gt = np.zeros((100, 130), np.int32)
        y, x = rng.integers(10, 50, size=2)
        gt[y:y + 40, x:x + 60] = 1
        img[gt == 1] = rng.integers(130, 255, size=3)
        scenes.append((img, gt))

    class Data:
        def __len__(self):
            return len(scenes)

        def get_sample(self, i):
            img, gt = scenes[i]
            return SimpleNamespace(image=img, objects_ids=[1],
                                   gt_mask=lambda _: gt)

    kw = dict(target_size=(112, 112), max_clicks=4, target_iou=0.95,
              min_crop_size=40, batch_size=2)
    run = make_device_evaluator(model, **kw)
    edt.row_envelope.launches = 0
    got = evaluate_dataset_device(run, Data())
    assert edt.row_envelope.launches == run.steps
    want = evaluate_dataset_device(
        make_device_evaluator(cpu, device="cpu", **kw), Data())
    assert [len(a) for a in got] == [len(a) for a in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)
