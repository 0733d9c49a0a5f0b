"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Every test needs an NVIDIA GPU and skips where ``torch.cuda.is_available()``
is false. The file imports neither JAX nor the JAX package, so it also runs
on a machine without them, where tests/conftest.py (which imports JAX) must
be left out:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerances: f32 differs only in summation order, rsqrtf and the online
softmax (~1e-6 relative), so 1e-5; bf16 outputs may differ by one bf16
rounding step (2^-8 relative), so 2e-2. Kernels A and D (one flash core)
are held at both query tiles and both load paths, forced through the
entries' ``plan``. The EDT row kernel (C) computes an exact integer
minimum and rounds it once, and is held bitwise to its plain version over
its domain. The JBU kernel
(E) and its plain version clamp different normalisers, which agree where
neither clamp binds (sigma 0.8 here); E's output is a weighted mean of 49
inputs, which errs relative to the inputs summed, so its absolute tolerance
is 1e-5 of max |hr|. Kernels F and G (attention variants) take e against
the running row max, where their plain versions take it against the final
one, so bf16 roundings of e (and, with a bf16 exp, of s - m) fall at other
points: within the bf16 tolerance. F and G run on the flash core of A and
D: G's output equals F's, and F's with an f32 exp equals A's, bit for bit.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from isegprobe_torch.ops import attention, attn_variants, edt, jbu, layernorm

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _randn(shape, seed, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, dtype)


def _plans(dtype, dh):
    """Every (q_tile, aligned) the kernels take for this dtype and dh."""
    vec = 8 if dtype == torch.bfloat16 else 4
    paths = [False] + ([True] if dh % vec == 0 else [])
    return [(tile, a) for tile in attention.Q_TILES for a in paths]


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 elements past a
    16-byte boundary."""
    buf = torch.empty(t.numel() + 2, dtype=t.dtype, device=t.device)
    out = buf[2:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,dh", [(2, 1025, 6, 64), (2, 131, 3, 16),
                                           (1, 77, 2, 128), (1, 5, 2, 40),
                                           (2, 257, 8, 32), (2, 63, 3, 13),
                                           (1, 64, 2, 101), (2, 65, 2, 64),
                                           (1, 128, 3, 40), (1, 129, 2, 16),
                                           (2, 1, 2, 64), (1, 1025, 2, 101)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,heads,dh", [(2, 1, 2, 64), (1, 63, 2, 13),
                                           (2, 64, 3, 16), (1, 65, 2, 40),
                                           (2, 128, 2, 64), (1, 129, 2, 101),
                                           (2, 1025, 6, 64),
                                           (1, 1025, 2, 128)])
def test_attention_kernel_every_tile_and_load_path(cuda_device, dtype, b, n,
                                                   heads, dh):
    """Both query tiles and both load paths, forced through the entry's
    plan: N = 65 and 129 leave a query tile with one valid row, N = 1, 63,
    65 and 129 a key tile with one or most of its keys masked; and a qkv
    that starts off a 16-byte boundary takes the element path."""
    qkv = _randn((b, n, 3 * heads * dh), n + dh, cuda_device, dtype)
    want = attention._mha_qkv_plain(qkv, heads, dh**-0.5)
    for plan in _plans(dtype, dh):
        before = attention.mha_qkv.launches
        got = attention.mha_qkv(qkv, heads, plan=plan)
        torch.cuda.synchronize()
        assert attention.mha_qkv.launches == before + 1, plan
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    odd = _misaligned(qkv)
    assert odd.data_ptr() % 16 != 0
    got = attention.mha_qkv(odd, heads)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    with pytest.raises(ValueError):
        attention.mha_qkv(odd, heads, plan=(64, True))


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,real", [((2, 300, 512), 404),
                                        ((3, 100, 256), 203),
                                        ((7, 101), 57), ((4, 96), 96)])
def test_layernorm_kernel_real_channels_match_plain(cuda_device, dtype,
                                                    shape, real):
    """Statistics over the first ``real`` channels (LoftUp's padded
    layout): the kernel against the masked plain version, padded channels
    of zero input and zero weights exact zeros."""
    x = (_randn(shape, 3, cuda_device) * 3 + 1).to(dtype)
    x[..., real:] = 0
    w = (_randn(shape[-1:], 4, cuda_device) * 0.5 + 1).to(dtype)
    bias = _randn(shape[-1:], 5, cuda_device, dtype)
    w[real:], bias[real:] = 0, 0
    before = layernorm.layernorm.launches
    got = layernorm.layernorm(x, w, bias, 1e-5, real)
    torch.cuda.synchronize()
    assert layernorm.layernorm.launches == before + 1
    want = layernorm._ln_plain(x, w, bias, 1e-5, real)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    assert not got[..., real:].any()


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
@pytest.mark.parametrize("name", [
    "random", "clicker", "adversarial", "w4096_random", "w4096_adversarial",
    "w1_random", "w1_adversarial", "sentinel_rows", "single_source_rows",
    "tall_5000x7", "tall_40000x7"])
def test_edt_row_kernel_bitwise_over_its_domain(cuda_device, name):
    """Kernel C on bench_edt.py's three inputs at the device loop's shape
    [8, 2, 514, 642] (random masks, the clicker's error maps, one zero a
    column) and on its domain inputs (W = 4096 and 1, sentinel rows, single
    sources, g > 4096 where fl(g²) + d² passes 2^24): bit for bit the plain
    version."""
    from isegprobe_torch.scripts import bench_edt

    if name in bench_edt.KINDS:
        g = bench_edt.column_input(name, bench_edt.SHAPES[0], cuda_device)
    else:
        g = bench_edt.domain_inputs(cuda_device)[name]
    got = edt.row_envelope(g)
    torch.cuda.synchronize()
    assert torch.equal(got, edt._row_envelope_plain(g))


@pytest.mark.cuda
def test_edt_kernel_reports_its_layout_and_resources(cuda_device):
    """Kernel C's library reports its layout at a row width: one warp a
    row, eight rows a block at the loop's 642 columns (55,488 shared bytes,
    four blocks an SM), one at 4096, and no local memory (nothing
    spilled)."""
    cfg = edt.kernel_config(642, cuda_device)
    assert set(cfg) == set(edt.CONFIG_KEYS)
    assert (cfg["rows_per_block"], cfg["threads"], cfg["segment"]) == (
        8, 256, 21)
    assert cfg["smem_bytes"] == 55488 and cfg["blocks_per_sm"] == 4
    assert cfg["local_bytes"] == 0 and 0 < cfg["registers"] <= 64
    wide = edt.kernel_config(edt.MAX_ROW_WIDTH, cuda_device)
    assert (wide["rows_per_block"], wide["threads"], wide["segment"]) == (
        1, 32, 128)
    assert wide["smem_bytes"] == 41472 and wide["blocks_per_sm"] >= 5


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
@pytest.mark.parametrize("shape", [(8, 257, 3 * 384), (2, 65, 3 * 128)])
def test_kernels_under_autograd_match_plain(cuda_device, shape):
    """Kernels A and B under autograd (training): the forward is the
    kernel's, bitwise, and the gradients are autograd's through the plain
    version (A's backward recomputes it; B's is a kernel of its own, the
    same function summed in another order: its weight and bias gradients,
    sums over every row, within 1e-5 of their scale)."""
    heads = shape[-1] // 3 // 64
    qkv = _randn(shape, 0, cuda_device)
    with torch.no_grad():
        ref = attention.mha_qkv(qkv, heads)
    t = qkv.clone().requires_grad_(True)
    out = attention.mha_qkv(t, heads)
    assert torch.equal(out.detach(), ref)
    g = _randn(out.shape, 1, cuda_device)
    out.backward(g)
    t2 = qkv.clone().requires_grad_(True)
    attention._mha_qkv_plain(t2, heads, 64**-0.5).backward(g)
    torch.testing.assert_close(t.grad, t2.grad, rtol=1e-5, atol=1e-6)
    d = shape[-1] // 3
    x = _randn((*shape[:2], d), 2, cuda_device)
    w, b = _randn((d,), 3, cuda_device), _randn((d,), 4, cuda_device)
    ts = [v.clone().requires_grad_(True) for v in (x, w, b)]
    y = layernorm.layernorm(*ts)
    assert torch.equal(y.detach(), layernorm.layernorm(x, w, b))
    y.backward(x)
    refs = [v.clone().requires_grad_(True) for v in (x, w, b)]
    layernorm._ln_plain(*refs, 1e-6).backward(x)
    for i, (a, r) in enumerate(zip(ts, refs)):
        scale = 1.0 if i == 0 else float(r.grad.abs().max())
        torch.testing.assert_close(a.grad, r.grad, rtol=1e-5,
                                   atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape,real", [((4, 33, 384), None),
                                        ((2, 9, 203), None),
                                        ((2, 17, 512), 404),
                                        ((3, 5, 1024), None)])
def test_layernorm_backward_kernel_matches_its_plain_version(
        cuda_device, xdt, wdt, shape, real):
    """B's backward kernel against ``_ln_plain_bwd`` (f32 within 1e-5 of
    each gradient's scale; bf16 outputs within one rounding step, 2^-7):
    one launch for dx alone, two with dweight and dbias, which two runs
    give bit for bit; the 16-byte and element load paths, D up to 1024.
    Two rows are zeros (with ``real`` < D, rows of padding alone): their
    variance is exactly 0, the clamp's tie, and rstd is 1/sqrt(eps); their
    dx is held within the same tolerance of its own scale."""
    d = shape[-1]
    x = (_randn(shape, 0, cuda_device) * 3 + 1).to(xdt)
    w = (_randn((d,), 1, cuda_device) * 0.5 + 1).to(wdt)
    dy = _randn(shape, 2, cuda_device).to(xdt)
    if real is not None:
        x[..., real:], w[real:] = 0, 0
    zero = torch.zeros(x.numel() // d, dtype=torch.bool, device=cuda_device)
    zero[[0, -1]] = True
    x.view(-1, d)[zero] = 0
    for needs in ((True, False, False), (True, True, True)):
        before = layernorm.layernorm.backward_launches
        got = layernorm._ln_bwd_cuda(x, w, dy, 1e-5, real, needs)
        launched = layernorm.layernorm.backward_launches - before
        assert launched == (2 if needs[1] else 1)
        want = layernorm._ln_plain_bwd(x, w, dy, 1e-5, real, needs)
        for i, (g, p_, t) in enumerate(zip(got, want, (x, w, w))):
            assert (g is None) == (p_ is None)
            if g is None:
                continue
            assert g.dtype == t.dtype
            tol = 1e-5 if g.dtype == torch.float32 else 2.0**-7
            parts = ((g.view(-1, d)[rows], p_.view(-1, d)[rows])
                     for rows in (zero, ~zero)) if i == 0 else ((g, p_),)
            for g_, p_r in parts:
                scale = float(p_r.float().abs().max())
                assert scale > 0
                err = float((g_.float() - p_r.float()).abs().max())
                assert err <= tol * scale
        if needs[1]:
            again = layernorm._ln_bwd_cuda(x, w, dy, 1e-5, real, needs)
            assert torch.equal(got[1], again[1])
            assert torch.equal(got[2], again[2])


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda_device):
    qkv = _randn((1, 9, 3 * 2 * 64), 0, cuda_device)
    with pytest.raises(ValueError):
        attention.mha_qkv(qkv[:, ::2], 2)  # not contiguous
    with pytest.raises(TypeError):
        attention.mha_qkv(qkv.half(), 2)
    with pytest.raises(ValueError):
        attention.mha_qkv(_randn((1, 9, 3 * 256), 0, cuda_device), 1)  # dh 256
    with pytest.raises(ValueError):
        attention.mha_qkv(qkv, 2, plan=(32, False))  # no such tile
    with pytest.raises(ValueError):  # dh 13: no 16-byte path
        attention.mha_qkv(_randn((1, 9, 3 * 13), 0, cuda_device), 1,
                          plan=(64, True))
    # kernel A has a backward (through the plain version) since it trains
    attention.mha_qkv(qkv.requires_grad_(), 2).sum().backward()
    assert qkv.grad is not None and torch.isfinite(qkv.grad).all()
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
    (2, 1000, 1024, 4, 101), (2, 1000, 1024, 4, 128),
    (1, 300, 77, 2, 64), (2, 129, 200, 3, 13),
    (1, 64, 1, 1, 128), (1, 5, 130, 2, 40), (2, 1025, 777, 2, 16),
    (1, 65, 1024, 4, 101), (2, 63, 777, 2, 64), (1, 1, 1, 1, 13)])
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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nq,nk,heads,dh", [
    (1, 1, 1, 2, 64), (2, 63, 777, 2, 13), (1, 64, 1024, 2, 16),
    (2, 65, 1, 1, 40), (1, 128, 777, 2, 101), (2, 129, 1024, 4, 101),
    (1, 1025, 777, 2, 64), (1, 129, 65, 1, 128)])
def test_cross_attention_every_tile_and_load_path(cuda_device, dtype, b, nq,
                                                  nk, heads, dh):
    """Kernel D at both query tiles and both q/out load paths, forced
    through the entry's plan (Nk = 1 and 65 leave a key tile with one valid
    key; Nq = 65 and 129 a query tile with one valid row), and a q off a
    16-byte boundary on the element path."""
    q = _randn((b, nq, heads, dh), nq + dh, cuda_device, dtype)
    k = _randn((b, nk, heads, dh), nk, cuda_device, dtype)
    v = _randn((b, nk, heads, dh), nk + 1, cuda_device, dtype)
    want = attention._mha_plain(q, k, v, dh**-0.5)
    for plan in _plans(dtype, dh):
        before = attention.mha.launches
        got = attention.mha(q, k, v, plan=plan)
        torch.cuda.synchronize()
        assert attention.mha.launches == before + 1, plan
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])
    odd = _misaligned(q)
    got = attention.mha(odd, k, v)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])
    with pytest.raises(ValueError):
        attention.mha(odd, k, v, plan=(128, True))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,k,aligned", [
    (2, 64, 64, 384, 32, True), (1, 37, 50, 48, 32, True),
    (2, 16, 258, 40, 20, True), (1, 4, 5, 3, 33, True),
    # the tiling's edges: W one past a strip of 8 and H one past a tile of
    # 8 (and 16) rows, C no multiple of 4 or of the 32-channel chunk, K = 1,
    # H = W = 4, and bases off 16-byte alignment (4-byte copies)
    (1, 17, 41, 64, 32, True), (2, 20, 24, 70, 32, True),
    (1, 12, 9, 40, 1, True), (2, 4, 4, 36, 32, True),
    (2, 19, 23, 48, 32, False)])
def test_jbu_kernel_matches_plain(cuda_device, b, h, w, c, k, aligned):
    hr = _randn((b, h, w, c), c, cuda_device)
    proj = _randn((b, h, w, k), k, cuda_device)
    if not aligned:
        hr, proj = _misaligned(hr), _misaligned(proj)
    assert (hr.data_ptr() % 16 == 0) is aligned  # else 4-byte copies
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
def test_jbu_kernel_reports_its_tiling_and_resources(cuda_device):
    """Kernel E's library reports the tiling it was compiled with and what
    the card gives it: two 128-thread blocks of 8x16 pixels an SM (the
    design's occupancy), and no local memory (nothing spilled)."""
    cfg = jbu.kernel_config(cuda_device)
    assert set(cfg) == set(jbu.CONFIG_KEYS)
    assert (cfg["tile_h"], cfg["tile_w"], cfg["threads"]) == (8, 16, 128)
    assert (cfg["chunk"], cfg["stages"], cfg["strip"]) == (32, 2, 8)
    assert cfg["blocks_per_sm"] >= 2
    assert 2 * cfg["smem_bytes"] <= 228 * 1024
    assert cfg["local_bytes"] == 0 and 0 < cfg["registers"] <= 255


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
    with pytest.raises(ValueError):
        attention.mha(q, q, q, plan=(256, False))  # no such tile
    with pytest.raises(ValueError):  # dh 101: no 16-byte path for q
        r = _randn((1, 9, 1, 101), 0, cuda_device, torch.bfloat16)
        attention.mha(r, r, r, plan=(128, True))
    # kernel D has a backward (through the plain version) since it trains
    attention.mha(q.clone().requires_grad_(), q, q).sum().backward()
    hr = _randn((1, 8, 8, 4), 0, cuda_device)
    with pytest.raises(TypeError):
        jbu.jbu_filter(hr.double(), hr, 0.5, 0.8)
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr, hr[:, :4], 0.5, 0.8)  # proj of another size
    with pytest.raises(ValueError):
        jbu.jbu_filter(hr[:, :3], hr[:, :3], 0.5, 0.8)  # H < 4
    # and kernel E too
    hr_g = hr.clone().requires_grad_()
    jbu.jbu_filter(hr_g, hr, 0.5, 0.8).sum().backward()
    assert torch.isfinite(hr_g.grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,nk,heads,dh", [(2, 1000, 256, 4, 101),
                                               (1, 300, 77, 2, 64)])
def test_cross_attention_kernel_under_autograd_matches_plain(
        cuda_device, b, nq, nk, heads, dh):
    """Kernel D under autograd (LoftUp training): the forward is the
    kernel's, bitwise, with one launch, and the gradients of q, k and v are
    autograd's through the plain version."""
    q, k, v = (_randn((b, n, heads, dh), i, cuda_device)
               for i, n in enumerate((nq, nk, nk)))
    with torch.no_grad():
        ref = attention.mha(q, k, v)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = attention.mha.launches
    out = attention.mha(*ts)
    assert attention.mha.launches - before == 1
    assert torch.equal(out.detach(), ref)
    g = _randn(out.shape, 3, cuda_device)
    out.backward(g)
    refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    attention._mha_plain(*refs, dh**-0.5).backward(g)
    for t, r in zip(ts, refs):
        scale = float(r.grad.abs().max())
        torch.testing.assert_close(t.grad, r.grad, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c", [(2, 32, 32, 384), (1, 20, 24, 70)])
def test_jbu_kernel_under_autograd_matches_plain(cuda_device, b, h, w, c):
    """Kernel E under autograd (JBU training): the forward is the kernel's,
    bitwise, with one launch, and the gradients of hr, proj, temp and sigma
    are autograd's through the plain version."""
    hr = _randn((b, h, w, c), 0, cuda_device)
    proj = _randn((b, h, w, 32), 1, cuda_device) * 0.3
    temp = torch.tensor(0.5, device=cuda_device)
    sigma = torch.tensor(0.8, device=cuda_device)
    inputs = (hr, proj, temp, sigma)
    with torch.no_grad():
        ref = jbu.jbu_filter(*inputs)
    ts = [t.clone().requires_grad_(True) for t in inputs]
    before = jbu.jbu_filter.launches
    out = jbu.jbu_filter(*ts)
    assert jbu.jbu_filter.launches - before == 1
    assert torch.equal(out.detach(), ref)
    g = _randn(out.shape, 2, cuda_device)
    out.backward(g)
    refs = [t.clone().requires_grad_(True) for t in inputs]
    jbu._jbu_plain(*refs).backward(g)
    for t, r in zip(ts, refs):
        scale = float(r.grad.abs().max())
        torch.testing.assert_close(t.grad, r.grad, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.cuda
def test_loftup_train_step_checkpoints_its_slabs(cuda_device):
    """A 112² LoftUp probe (banded in 7 slabs of 16 rows) under autograd on
    the card: the backward recomputes every slab, so a forward and backward
    launch D and the slabs' LayerNorms twice, and the click encoder's
    gradient equals the CPU's."""
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_torch.models.vit import init_params
    from isegprobe_torch.training.trainer import split_params

    up = dict(type="loftup", params=dict(
        n_dim=384, query_chunk_rows=16, query_chunk_min_pixels=0))
    cfg = dict(flagship_config((112, 112)), upsampler_cfg=up)
    model = init_params(iSegProbeModel(**cfg, device=cuda_device), seed=0)
    cpu = iSegProbeModel(**cfg, device="cpu")
    cpu.load_state_dict(model.state_dict())
    rng = np.random.default_rng(0)
    image = torch.from_numpy(rng.random((2, 112, 112, 4), dtype=np.float32))
    points = torch.full((2, 8, 3), -1.0)
    points[:, 0] = torch.tensor([50.0, 60.0, 0.0])
    grads, counts = [], []
    for m, dev in ((model, cuda_device), (cpu, "cpu")):
        split_params(m)
        attention.mha_qkv.launches = layernorm.layernorm.launches = 0
        attention.mha.launches = 0
        m(image.to(dev), points.to(dev))["instances"].square().mean(
        ).backward()
        counts.append((attention.mha_qkv.launches,
                       layernorm.layernorm.launches, attention.mha.launches))
        grads.append(m.embed_coords.proj.weight.grad.cpu())
    # the forward's 12 A + 82 B + 14 D, then each slab's 8 B + 2 D again;
    # the CPU's plain versions count nothing
    assert counts == [(12, 82 + 7 * 8, 14 + 7 * 2), (0, 0, 0)]
    torch.testing.assert_close(grads[0], grads[1], rtol=0,
                               atol=1e-4 * float(grads[1].abs().max()))
    assert float(grads[0].norm()) > 0


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


_VARIANT_PAIRS = [(torch.float32, torch.float32),
                  (torch.bfloat16, torch.float32),
                  (torch.bfloat16, torch.bfloat16)]
# N = 1, 63 and 65 leave a key tile with one or most of its keys masked and
# a query tile with few valid rows; 1025 is the sweep's N
_VARIANT_SHAPES = [(2, 1, 2), (1, 63, 4), (2, 64, 2), (1, 65, 6),
                   (2, 1025, 6)]
_VARIANTS = {"nodiv": (attn_variants.mha_qkv_nodiv, attn_variants._nodiv_plain,
                       attn_variants.NODIV_TILES),
             "merged": (attn_variants.mha_qkv_merged,
                        attn_variants._merged_plain,
                        attn_variants.MERGED_TILES)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,expdt", _VARIANT_PAIRS)
@pytest.mark.parametrize("kind", ["nodiv", "merged"])
@pytest.mark.parametrize("b,n,heads", _VARIANT_SHAPES)
def test_attention_variant_kernels_match_plain(cuda_device, kind, dtype,
                                               expdt, b, n, heads):
    entry, plain, tiles = _VARIANTS[kind]
    qkv = _randn((b, n, 3 * heads * 64), n + heads, cuda_device, dtype)
    want = plain(qkv, heads, 0.125, expdt)
    for tile in tiles:
        before = entry.launches
        got = entry(qkv, heads, expdt=expdt, q_tile=tile)
        torch.cuda.synchronize()
        assert entry.launches == before + 1
        assert got.shape == (b, n, heads * 64) and got.dtype == dtype
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,expdt", _VARIANT_PAIRS)
@pytest.mark.parametrize("b,n,heads", _VARIANT_SHAPES)
def test_attention_variants_are_bitwise_the_core(cuda_device, dtype, expdt,
                                                 b, n, heads):
    """G computes each head as F does (the same key tiles in the same
    order), so their outputs are equal bit for bit at the same tile and exp;
    with an f32 exp F is kernel A's instantiation at the same plan."""
    qkv = _randn((b, n, 3 * heads * 64), 2 * n + heads, cuda_device, dtype)
    launches = (attn_variants.mha_qkv_nodiv.launches,
                attn_variants.mha_qkv_merged.launches,
                attention.mha_qkv.launches)
    for tile in attn_variants.NODIV_TILES:
        f = attn_variants.mha_qkv_nodiv(qkv, heads, expdt=expdt, q_tile=tile)
        g = attn_variants.mha_qkv_merged(qkv, heads, expdt=expdt, q_tile=tile)
        assert torch.equal(f, g), tile
        if expdt == torch.float32:
            a = attention.mha_qkv(qkv, heads, plan=(tile, True))
            assert torch.equal(f, a), tile
    k = len(attn_variants.NODIV_TILES)
    assert (attn_variants.mha_qkv_nodiv.launches,
            attn_variants.mha_qkv_merged.launches,
            attention.mha_qkv.launches) == (
        launches[0] + k, launches[1] + k,
        launches[2] + (k if expdt == torch.float32 else 0))


@pytest.mark.cuda
def test_attention_variant_kernels_raise(cuda_device):
    qkv = _randn((1, 9, 3 * 2 * 64), 0, cuda_device)
    for entry in (attn_variants.mha_qkv_nodiv, attn_variants.mha_qkv_merged):
        before = entry.launches
        with pytest.raises(ValueError):
            entry(qkv[:, ::2], 2)  # not contiguous
        with pytest.raises(ValueError):
            entry(_misaligned(qkv), 2)  # off a 16-byte boundary
        with pytest.raises(ValueError):
            entry(_randn((1, 9, 3 * 3 * 64), 0, cuda_device), 3)  # odd H
        with pytest.raises(ValueError):
            entry(_randn((1, 9, 3 * 4 * 32), 0, cuda_device), 4)  # dh 32
        for tile in (32, 96, 256):  # G's old tile 32; tiles the core lacks
            with pytest.raises(ValueError):
                entry(qkv, 2, q_tile=tile)
        with pytest.raises(TypeError):
            entry(qkv, 2, expdt=torch.bfloat16)  # f32 with a bf16 exp
        with pytest.raises(NotImplementedError):
            entry(qkv.clone().requires_grad_(), 2)
        assert entry.launches == before


# -- kernels H and I (int8 W8A8) -----------------------------------------------

def _int8_operands(m, n, k, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=device,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (n, k), generator=g, device=device,
                       dtype=torch.int8)
    sx = torch.rand(m, generator=g, device=device) + 0.01
    sw = torch.rand(n, generator=g, device=device) * 0.01
    bias = torch.randn(n, generator=g, device=device)
    return xq, wq, sx, sw, bias


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 96, 3072])
@pytest.mark.parametrize("n", [8, 200, 2304])
@pytest.mark.parametrize("m", [1, 127, 129, 2050])
def test_int8_gemm_kernel_bitwise_at_ragged_shapes(cuda_device, m, n, k):
    """Kernel I against its plain version, bit for bit, at M, N and K that
    leave ragged tiles and K-blocks (TMA zero-fills the loads and clips the
    stores), writing f32 and bf16, with no bias, the bias before the cast
    and after it: the integer sum is exact, the epilogue the plain
    version's rounding."""
    from isegprobe_torch.ops import quant

    xq, wq, sx, sw, b = _int8_operands(m, n, k, m * 7 + n * 3 + k,
                                       cuda_device)
    before = quant.int8_gemm.launches
    for dtype in (torch.float32, torch.bfloat16):
        for bias, after in ((None, False), (b.to(dtype), False),
                            (b.to(dtype), True)):
            got = quant.int8_gemm(xq, wq, sx, sw, bias, dtype, after)
            want = quant._int8_gemm_plain(xq, wq, sx, sw, bias, dtype, after)
            torch.cuda.synchronize()
            assert got.dtype == dtype and torch.equal(got, want), (
                dtype, bias is not None, after)
    assert quant.int8_gemm.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2050, 384), (37, 1536), (5, 3072),
                                   (9, 40)])
def test_quantize_rows_kernel_bitwise(cuda_device, dtype, shape):
    """Kernel H against its plain version, bit for bit (rows of spread
    magnitudes; K = 40 takes the element path)."""
    from isegprobe_torch.ops import quant

    x = (_randn(shape, 3, cuda_device) * torch.exp(
        _randn((shape[0], 1), 4, cuda_device) * 2)).to(dtype)
    q, s = quant.quantize_rows(x)
    want_q, want_s = quant._quantize_rows_plain(x)
    torch.cuda.synchronize()
    assert torch.equal(q, want_q) and torch.equal(s, want_s)


@pytest.mark.cuda
def test_weight_rows_are_quantized_once_on_the_card(cuda_device):
    """A QuantLinear forward launches two H and one I the first time it
    sees its weight and one H and one I after, and the output is the plain
    version's bit for bit either way."""
    from isegprobe_torch.ops import quant

    torch.manual_seed(0)
    layer = quant.QuantLinear(384, 1152).to(cuda_device, torch.bfloat16)
    x = torch.randn(2, 1025, 384, device=cuda_device).to(torch.bfloat16)
    want = quant._quant_linear_plain(x, layer.weight, layer.bias,
                                     torch.bfloat16, False)
    for h in (2, 1, 1):
        before = (quant.quantize_rows.launches, quant.int8_gemm.launches)
        with torch.inference_mode():
            got = layer(x)
        torch.cuda.synchronize()
        assert (quant.quantize_rows.launches - before[0],
                quant.int8_gemm.launches - before[1]) == (h, 1)
        assert torch.equal(got, want)
    with torch.no_grad():
        layer.weight.mul_(0.5)  # an in-place update: quantized again
        before = quant.quantize_rows.launches
        got = layer(x)
    assert quant.quantize_rows.launches == before + 2
    assert torch.equal(got, quant._quant_linear_plain(
        x, layer.weight, layer.bias, torch.bfloat16, False))


@pytest.mark.cuda
def test_weight_cache_requantizes_after_a_round_trip_on_the_card(
        cuda_device):
    """``.to(bfloat16).to(float32)`` with no forward between: the caching
    allocator would hand the new float32 weight the block its old storage
    freed, with the same version, address, dtype and shape, but the cache
    holds that storage, so the next forward quantizes the rounded weight
    and equals the plain version bit for bit."""
    from isegprobe_torch.ops import quant

    torch.manual_seed(0)
    layer = quant.QuantLinear(384, 1152).to(cuda_device)
    x = torch.randn(2, 1025, 384, device=cuda_device)
    with torch.inference_mode():
        layer(x)
    stale = quant._weight_rows_cache[layer.weight][2][0]
    layer.to(torch.bfloat16).to(torch.float32)
    before = quant.quantize_rows.launches
    with torch.inference_mode():
        got = layer(x)
    torch.cuda.synchronize()
    assert quant.quantize_rows.launches == before + 2
    wq = quant._weight_rows_cache[layer.weight][2][0]
    assert wq is not stale
    assert torch.equal(wq, quant._quantize_rows_plain(layer.weight)[0])
    assert torch.equal(got, quant._quant_linear_plain(
        x, layer.weight, layer.bias, torch.float32, False))
