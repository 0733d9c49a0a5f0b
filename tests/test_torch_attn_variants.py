"""The attention variants of the sweep (isegprobe_torch/ops/attn_variants.py
and isegprobe_torch/scripts/bench_attn_variants.py) against the TPU kernel
bodies of scripts/bench_attn_variants.py on the same numpy inputs.

The JAX side builds ``run_variant``'s ``pallas_call`` (its grid and
BlockSpecs) with ``interpret=True`` around ``_kernel_nodiv`` and
``_kernel_merged``, at a partial last query block. On the CPU the port's
entries compute their plain versions; the CUDA kernels F and G are held
against those on the card in tests/test_torch_cuda.py.

Tolerances: f32 differs in summation order only (measured 6.6e-7), so 1e-5.
In bf16 the two sides round the same values at the same points, but f32
sums taken in another order can round to the neighbouring bf16 value, twice
over (e before PV, then the output): measured at most two bf16 roundings
(2^-7 relative), so 1e-2 relative with 1e-3 absolute.
"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from isegprobe_torch.ops import attention as t_attention
from isegprobe_torch.ops import attn_variants as av
from isegprobe_torch.scripts import bench_attn_variants as sweep

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (1e-2, 1e-3)}  # (rtol, atol)
PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
         ("bfloat16", "bfloat16")]
B, N, H, BQ = 2, 37, 4, 16  # N = 37: the last query block of 16 is partial


def _jax_sweep():
    """scripts/bench_attn_variants.py as a module (its main is guarded)."""
    spec = importlib.util.spec_from_file_location(
        "jax_bench_attn_variants", REPO / "scripts" / "bench_attn_variants.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_variant_interpret(kernel, qkv, num_heads, scale, bq, expdt):
    """``run_variant``'s pallas_call, in interpret mode."""
    b, n, three_c = qkv.shape
    c = three_c // 3
    pairs = num_heads // 2
    fn = pl.pallas_call(
        functools.partial(kernel, scale=scale, n_valid=n, expdt=expdt),
        grid=(b, pairs, -(-n // bq)),
        in_specs=[
            pl.BlockSpec((1, bq, 128), lambda i, h, j: (i, j, h)),
            pl.BlockSpec((1, n, 128), lambda i, h, j: (i, 0, pairs + h)),
            pl.BlockSpec((1, n, 128), lambda i, h, j: (i, 0, 2 * pairs + h)),
        ],
        out_specs=pl.BlockSpec((1, bq, 128), lambda i, h, j: (i, j, h)),
        out_shape=jax.ShapeDtypeStruct((b, n, c), qkv.dtype),
        interpret=True,
    )
    return fn(qkv, qkv, qkv)


def _qkv(b=B, n=N, heads=H, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, n, 3 * heads * 64)).astype(np.float32)


@pytest.mark.parametrize("dtype,expdt", PAIRS)
@pytest.mark.parametrize("kind", ["nodiv", "merged"])
def test_plain_matches_pallas_body(kind, dtype, expdt):
    jsweep = _jax_sweep()
    body = {"nodiv": jsweep._kernel_nodiv,
            "merged": jsweep._kernel_merged}[kind]
    entry = {"nodiv": av.mha_qkv_nodiv, "merged": av.mha_qkv_merged}[kind]
    x = _qkv()
    scale = 64**-0.5
    want = _run_variant_interpret(body, jnp.asarray(x, getattr(jnp, dtype)),
                                  H, scale, BQ, getattr(jnp, expdt))
    before = entry.launches
    got = entry(torch.from_numpy(x).to(getattr(torch, dtype)), H, scale,
                expdt=getattr(torch, expdt))
    assert entry.launches == before  # CPU: the plain version, no launch
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, N, H * 64)
    rtol, atol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("kind", ["nodiv", "merged"])
def test_cpu_entries_match_mha_qkv_plain_f32(kind):
    """In f32 both variants compute kernel A's function."""
    from isegprobe_tpu.ops.attention import _mha_qkv_jnp

    entry = {"nodiv": av.mha_qkv_nodiv, "merged": av.mha_qkv_merged}[kind]
    x = _qkv(3, 77, 6, seed=1)
    got = entry(torch.from_numpy(x), 6).numpy()
    want = t_attention._mha_qkv_plain(torch.from_numpy(x), 6, 0.125).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    ref = np.asarray(_mha_qkv_jnp(jnp.asarray(x), 6, 0.125))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype,expdt", PAIRS)
def test_nodiv_and_merged_plain_agree(dtype, expdt):
    """The two bodies compute one function; merged sums in another order."""
    x = torch.from_numpy(_qkv(1, 50, 2, seed=2)).to(getattr(torch, dtype))
    a = av.mha_qkv_nodiv(x, 2, expdt=getattr(torch, expdt))
    b = av.mha_qkv_merged(x, 2, expdt=getattr(torch, expdt))
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(a.float(), b.float(), rtol=rtol, atol=atol)


def test_entries_raise_on_what_they_do_not_take():
    x = torch.from_numpy(_qkv(1, 9, 2))
    for entry in (av.mha_qkv_nodiv, av.mha_qkv_merged):
        with pytest.raises(ValueError):
            entry(torch.zeros(1, 9, 3 * 3 * 64), 3)  # odd H
        with pytest.raises(ValueError):
            entry(torch.zeros(1, 9, 3 * 2 * 32), 2)  # dh = 32
        with pytest.raises(TypeError):
            entry(x, 2, expdt=torch.bfloat16)  # f32 inputs, bf16 exp
        with pytest.raises(TypeError):
            entry(x.half(), 2)
        with pytest.raises(ValueError):
            entry(x, 2, q_tile=48)  # no kernel for this tile
        with pytest.raises(ValueError):
            entry(torch.zeros(1, 9, 3 * 2 * 64, device="meta"), 2)
    # the plain version keeps autograd on the CPU
    y = x.clone().requires_grad_()
    av.mha_qkv_nodiv(y, 2).sum().backward()
    assert y.grad is not None and bool(torch.isfinite(y.grad).all())


def test_sweep_runs_on_cpu_at_a_tiny_shape():
    records = sweep.main(device="cpu", batch=2, n=37, heads=4)
    names = [(r["dtype"], r["variant"]) for r in records]
    tiles = [f"{k}{t}" for k, ts in (("nodiv", av.NODIV_TILES),
                                     ("merged", av.MERGED_TILES)) for t in ts]
    assert names == (
        [("float32", v) for v in ["pairs", *tiles]]
        + [("bfloat16", v) for v in ["pairs", *tiles]]
        + [("bfloat16", f"{v}_ebf16") for v in tiles])
    for r in records:
        assert r["ok"], r
        assert r["ms"] is None and r["launches"] == 0  # CPU: not timed
        assert r["max_abs_err"] <= (1e-5 if r["dtype"] == "float32"
                                    else 1e-2)


def test_sweep_raises_without_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        sweep.main(batch=1, n=5, heads=2)
