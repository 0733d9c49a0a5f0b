"""Kernels A and B under autograd: the backward bodies against ``jax.vjp``
of the JAX package's references, and the ``autograd.Function`` plumbing.

The port's ``AttentionKernel`` runs kernel A forward and, in the backward,
recomputes the plain version and returns its VJP, as the JAX
``custom_vjp`` ``_mha_qkv_pallas_ad`` does with ``_mha_qkv_jnp``.
``LayerNormKernel`` runs kernel B forward and B's backward kernel, whose
plain version is the closed form ``_ln_plain_bwd``
(``test_torch_layernorm_bwd.py`` holds it against ``jax.vjp``). Here, on
the CPU, the kernels are replaced by their plain versions
(``monkeypatch``), so the Function's plumbing (saved tensors, which inputs
get a gradient, the launch counter) runs as on the card.

Tolerance: f32 gradients within 2e-5 absolute + 2e-5 relative of
``jax.vjp`` (the two sides sum in other orders; measured below 1e-6 of
the gradients' scale).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isegprobe_torch.ops import attention, layernorm
from isegprobe_tpu.ops.attention import _mha_qkv_jnp
from isegprobe_tpu.ops.layernorm import _ln_jnp

torch.set_num_threads(2)
ATOL = RTOL = 2e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("b,n,heads,dh", [(2, 17, 2, 48), (8, 257, 6, 64),
                                          (1, 9, 3, 13)])
def test_attention_backward_matches_jax_vjp(b, n, heads, dh):
    rng = np.random.default_rng(b * n)
    qkv = rng.standard_normal((b, n, 3 * heads * dh), np.float32)
    g = rng.standard_normal((b, n, heads * dh), np.float32)
    scale = dh**-0.5
    _, vjp = jax.vjp(lambda t: _mha_qkv_jnp(t, heads, scale),
                     jnp.asarray(qkv))
    (want,) = vjp(jnp.asarray(g))
    t = torch.from_numpy(qkv).requires_grad_(True)
    attention._mha_qkv_plain(t, heads, scale).backward(torch.from_numpy(g))
    _close(t.grad, want)


@pytest.mark.parametrize("needs", [(True, True, True), (True, False, False),
                                   (False, True, True)])
def test_layernorm_backward_matches_jax_vjp(needs):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((8, 257, 96), np.float32) * 2 + 0.5
    w = rng.standard_normal(96, np.float32)
    bias = rng.standard_normal(96, np.float32)
    g = rng.standard_normal(x.shape, np.float32)
    _, vjp = jax.vjp(lambda a, s, c: _ln_jnp(a, s, c, 1e-6),
                     *(jnp.asarray(v) for v in (x, w, bias)))
    want = vjp(jnp.asarray(g))
    ts = [torch.from_numpy(v).requires_grad_(need)
          for v, need in zip((x, w, bias), needs)]
    layernorm._ln_plain(*ts, 1e-6).backward(torch.from_numpy(g))
    for t, w_, need in zip(ts, want, needs):
        if need:
            _close(t.grad, w_)


def test_attention_function_plumbing(monkeypatch):
    """``AttentionKernel`` with the plain forward patched in for kernel A:
    its forward equals the no-grad output bitwise, its gradient is the
    plain version's, and the kernel runs with grad mode off."""
    calls = []

    def fake(qkv, heads, scale, plan):
        calls.append(torch.is_grad_enabled())
        return attention._mha_qkv_plain(qkv, heads, scale)

    monkeypatch.setattr(attention, "_mha_qkv_cuda", fake)
    rng = np.random.default_rng(0)
    qkv = torch.from_numpy(rng.standard_normal((2, 17, 3 * 96), np.float32))
    g = torch.from_numpy(rng.standard_normal((2, 17, 96), np.float32))
    t = qkv.clone().requires_grad_(True)
    out = attention.AttentionKernel.apply(t, 2, 48**-0.5, None)
    with torch.no_grad():
        ref = attention._mha_qkv_plain(qkv, 2, 48**-0.5)
    assert torch.equal(out.detach(), ref)
    out.backward(g)
    t2 = qkv.clone().requires_grad_(True)
    attention._mha_qkv_plain(t2, 2, 48**-0.5).backward(g)
    assert torch.equal(t.grad, t2.grad)
    assert calls == [False]  # the kernel runs outside the autograd graph


def test_layernorm_function_plumbing(monkeypatch):
    """``LayerNormKernel`` with the plain forward patched in for kernel B
    and the closed form for its backward kernel: bitwise forward, and
    gradients only for the inputs that need them, bitwise the closed
    form's on the saved ``x`` and weight, and equal to autograd through
    the plain version within the file's tolerance."""
    monkeypatch.setattr(layernorm, "_ln_cuda", layernorm._ln_plain)
    monkeypatch.setattr(layernorm, "_ln_bwd_cuda", layernorm._ln_plain_bwd)
    rng = np.random.default_rng(1)
    x, w, b = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((4, 9, 32), (32,), (32,)))
    g = torch.from_numpy(rng.standard_normal((4, 9, 32), np.float32))
    for needs in ((True, False, False), (True, True, True),
                  (False, True, False)):
        ts = [v.clone().requires_grad_(n) for v, n in zip((x, w, b), needs)]
        out = layernorm.LayerNormKernel.apply(*ts, 1e-6)
        assert torch.equal(out.detach(), layernorm._ln_plain(x, w, b, 1e-6))
        out.backward(g)
        refs = [v.clone().requires_grad_(n) for v, n in zip((x, w, b),
                                                             needs)]
        layernorm._ln_plain(*refs, 1e-6).backward(g)
        closed = layernorm._ln_plain_bwd(x, w, g, 1e-6, None, needs)
        for t, r, c, n in zip(ts, refs, closed, needs):
            assert (t.grad is None) == (not n) == (c is None)
            if n:
                assert torch.equal(t.grad, c)
                _close(t.grad, r.grad)


def test_wrappers_route_cpu_tensors_to_the_plain_version():
    """On a CPU tensor the entries compute the plain version (autograd
    flows through it) and count no launch."""
    before = (attention.mha_qkv.launches, layernorm.layernorm.launches,
              layernorm.layernorm.backward_launches)
    qkv = torch.randn(1, 5, 3 * 64, requires_grad=True)
    attention.mha_qkv(qkv, 1).sum().backward()
    x = torch.randn(3, 16, requires_grad=True)
    layernorm.layernorm(x, torch.ones(16), torch.zeros(16)).sum().backward()
    assert qkv.grad is not None and x.grad is not None
    assert (attention.mha_qkv.launches, layernorm.layernorm.launches,
            layernorm.layernorm.backward_launches) == before
