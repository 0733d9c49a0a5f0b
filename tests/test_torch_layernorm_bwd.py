"""Kernel B's backward on the CPU: ``ops/layernorm.py:_ln_plain_bwd``, the
closed form the backward kernel computes, against ``jax.vjp`` of the JAX
package's LayerNorm on the same seeded numpy inputs.

The reference is ``isegprobe_tpu.ops.layernorm._ln_jnp`` (the function
whose VJP ``_ln_pallas_ad_bwd`` takes) for the full row, and flax's
``nn.LayerNorm(mask=arange(D) < real)``, which LoftUp's padded layout runs,
for statistics over the first ``real`` channels. Every dtype pair the
kernel takes (f32; bf16 x with f32 weight and bias; bf16 with bf16 weight
and bias), every subset of {x, weight, bias} that needs a gradient.

Tolerances, on well-conditioned rows: f32 gradients within 2e-5 absolute
(of the gradient's scale) + 2e-5 relative, as ``test_torch_autograd.py``
(the closed form sums in another order than JAX's graph; measured below
4e-7 of the scale). bf16 gradients are rounded from f32 values that differ
by that much, so an element may land one bf16 step away: within 2^-7 of
the scale. Rows of zeros (variance exactly 0, the clamp at its tie, where
``x - mean`` is 0 and the clamp's gradient drops out) are held to the f32
tolerance too. A row whose fast variance comes out a few ulp from zero
(a constant 0.1: rstd 1000 at eps 1e-6) is ill-conditioned, and any two
summation orders part there (1.4e-3 of the scale), so it is not gated.
"""

import functools

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isegprobe_torch.ops import layernorm
from isegprobe_tpu.ops.layernorm import _ln_jnp

torch.set_num_threads(2)
TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0**-7, 0.0)}
SUBSETS = [(True, False, False), (False, True, False), (False, False, True),
           (True, True, False), (True, False, True), (False, True, True),
           (True, True, True)]
# (x dtype, weight and bias dtype)
PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
         ("bfloat16", "bfloat16")]


def _close(got, want, dtype):
    atol, rtol = TOL[dtype]
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=atol * max(1.0, float(np.abs(want).max())))


def _inputs(shape, seed, real=None):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    w = rng.normal(1, 0.3, d).astype(np.float32)
    b = rng.normal(0, 0.3, d).astype(np.float32)
    g = rng.standard_normal(shape).astype(np.float32)
    if real is not None:  # LoftUp's padded layout: a zero tail
        x[..., real:], w[real:], b[real:] = 0, 0, 0
    return x, w, b, g


def _jax_vjp(fn, x, w, b, g, xdt, wdt):
    """``jax.vjp`` of ``fn`` at ``g`` (cast to the output's dtype), jitted:
    one compile a shape, not one a primitive."""
    def vjp(*args):
        out, pull = jax.vjp(fn, *args[:3])
        return pull(args[3].astype(out.dtype))

    cast = [jnp.asarray(v, dt) for v, dt in ((x, xdt), (w, wdt), (b, wdt))]
    return jax.jit(vjp)(*cast, jnp.asarray(g))


def _torch(v, dtype):
    return torch.from_numpy(v).to(getattr(torch, dtype))


@functools.lru_cache(maxsize=None)
def _full_row_case(xdt, wdt):
    """The inputs and ``jax.vjp`` of ``_ln_jnp`` at one dtype pair (every
    subset of a pair's cases reads the same three gradients)."""
    x, w, b, g = _inputs((3, 37, 96), seed=11)
    return (x, w, g), _jax_vjp(lambda a, s, c: _ln_jnp(a, s, c, 1e-6), x, w,
                               b, g, getattr(jnp, xdt), getattr(jnp, wdt))


@functools.lru_cache(maxsize=None)
def _real_case(dim, real):
    """The inputs and ``jax.vjp`` of flax's masked LayerNorm (eps 1e-5)."""
    x, w, b, g = _inputs((2, 9, dim), seed=dim + real, real=real)
    ln, mask = nn.LayerNorm(epsilon=1e-5), np.arange(dim) < real

    def fn(a, s, c):
        return ln.apply({"params": {"scale": s, "bias": c}}, a, mask=mask)

    return (x, w, g), _jax_vjp(fn, x, w, b, g, jnp.float32, jnp.float32)


@pytest.mark.parametrize("needs", SUBSETS)
@pytest.mark.parametrize("xdt,wdt", PAIRS)
def test_plain_backward_matches_jax_vjp(xdt, wdt, needs):
    """The closed form against ``jax.vjp`` of ``_ln_jnp``: a gradient, in
    its input's dtype, for each input that needs one, None for the
    others."""
    (x, w, g), want = _full_row_case(xdt, wdt)
    xt, gt = _torch(x, xdt), _torch(g, xdt)
    # the cotangent the port sees is the output's, in x's dtype
    got = layernorm._ln_plain_bwd(xt, _torch(w, wdt), gt, 1e-6, None, needs)
    for t, ref, need, dt in zip(got, want, needs, (xdt, wdt, wdt)):
        assert (t is None) == (not need)
        if need:
            assert t.dtype == getattr(torch, dt)
            _close(t, ref, dt)


@pytest.mark.parametrize("needs", SUBSETS)
@pytest.mark.parametrize("dim,real", [(512, 404), (256, 203)])
def test_plain_backward_over_real_channels_matches_flax(dim, real, needs):
    """Statistics over the first ``real`` channels (LoftUp's padded
    layout, eps 1e-5) against ``jax.vjp`` of flax's masked LayerNorm: the
    sums run over every channel, the mean's and variance's terms reach the
    first ``real`` only."""
    (x, w, g), want = _real_case(dim, real)
    got = layernorm._ln_plain_bwd(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(g), 1e-5, real, needs)
    for t, ref, need in zip(got, want, needs):
        assert (t is None) == (not need)
        if need:
            _close(t, ref, "float32")


def test_plain_backward_on_rows_of_zeros():
    """Rows of zeros (variance exactly 0: the clamp at its tie): dx is
    ``rstd (a - mean(a))`` and matches JAX's within the f32 tolerance of
    its scale, beside random rows."""
    x, w, b, g = _inputs((3, 37, 96), seed=5)
    x[0, :4] = 0
    want = _jax_vjp(lambda a, s, c: _ln_jnp(a, s, c, 1e-6), x, w, b, g,
                    jnp.float32, jnp.float32)
    dx, dw, db = layernorm._ln_plain_bwd(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(g), 1e-6)
    _close(dx[0, :4], np.asarray(want[0])[0, :4], "float32")
    _close(dx, want[0], "float32")
    _close(dw, want[1], "float32")
    _close(db, want[2], "float32")
    a = torch.from_numpy(g[0, :4] * w)
    rstd = torch.rsqrt(torch.tensor(1e-6))
    torch.testing.assert_close(dx[0, :4], rstd * (a - a.mean(-1, True)),
                               rtol=2e-5, atol=2e-5 * float(rstd))


@pytest.mark.parametrize("xdt,wdt", PAIRS)
def test_plain_backward_equals_autograd_through_the_plain_forward(xdt, wdt):
    """The closed form against autograd through ``_ln_plain`` (the
    backward the port ran before), at a train step's width."""
    x, w, b, g = _inputs((4, 65, 384), seed=7)
    ts = [_torch(v, dt).requires_grad_(True)
          for v, dt in ((x, xdt), (w, wdt), (b, wdt))]
    layernorm._ln_plain(*ts, 1e-6).backward(_torch(g, xdt))
    got = layernorm._ln_plain_bwd(ts[0].detach(), ts[1].detach(),
                                  _torch(g, xdt), 1e-6)
    for t, r, dt in zip(got, ts, (xdt, wdt, wdt)):
        assert t.dtype == r.grad.dtype
        _close(t, r.grad.float().numpy(), dt)


def test_backward_kernel_wrapper_rejects_what_the_kernel_cannot_take():
    """The backward's wrapper raises, before any build, on an input the
    kernel does not take: no fallback to the plain version."""
    x, w = torch.zeros(2, 8), torch.ones(8)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        layernorm._ln_bwd_cuda(x.half(), w, x.half(), 1e-6)
    with pytest.raises(ValueError, match="must match"):
        layernorm._ln_bwd_cuda(x, w, x.bfloat16(), 1e-6)
    with pytest.raises(ValueError, match="D <= 1024"):
        big = torch.zeros(2, 1032)
        layernorm._ln_bwd_cuda(big, torch.ones(1032), big, 1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        layernorm._ln_bwd_cuda(x, w, torch.zeros(8, 2).t(), 1e-6)


def test_bench_layernorm_runs_the_plain_versions_at_a_tiny_size(capsys):
    """``scripts/bench_layernorm.py`` on the CPU: its tiny cases through
    the plain versions, every gate held, one JSON line, nothing timed."""
    from isegprobe_torch.scripts import bench_layernorm

    rec = bench_layernorm.main("cpu", cases=bench_layernorm.TINY_CASES)
    assert [c["name"] for c in rec["cases"]] == ["tiny", "tiny_real"]
    assert all(c["ok"] and "ms" not in c for c in rec["cases"])
    assert rec["cases"][0]["affine_bitwise_repeat"] is True
    assert capsys.readouterr().out.startswith("bench_layernorm {")
