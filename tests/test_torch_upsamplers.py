"""The port's learned upsamplers and their ops against the JAX package, on
the same numpy inputs: adaptive pooling, the plain cross-attention ``mha``
and JBU filter (the plain versions of kernels D and E), LoftUp's layers,
LoftUp monolithic and banded, the JBU-FeatUp stack, and both probe
families' logits at a tiny arch.

Tolerances, each with its reason:
* pooling, ``mha``, the JBU filter, the norms and the JBU stack are the
  same f32 arithmetic in another summation order: 1e-5 (1e-4 through the
  four JBU stages and for ``mha`` against the Pallas kernel's padded keys);
* LoftUp's Fourier features multiply coordinates by frequencies up to
  e^10 ≈ 2.2e4, so one ulp of ``exp`` or of a coordinate moves a phase by
  ~1e-3 rad. The JAX package's own jitted and eager forwards differ there
  by ~2e-3, and so does the port: features and LoftUp outputs are held to
  5e-3 of their scale, and the port's banded path to its own monolithic
  one to 1e-5 (the same arithmetic in slabs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isegprobe_torch.models.convert import load_jax_params

torch.set_num_threads(2)

TOL = 1e-5
FOURIER_TOL = 5e-3


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _close(got, want, tol, scale=1.0):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("mode", ["avg", "max"])
@pytest.mark.parametrize("in_hw,out_hw", [((448, 40), (64, 7)),
                                          ((56, 40), (64, 96)),
                                          ((13, 9), (13, 4))])
def test_adaptive_pool_matches_jax(mode, in_hw, out_hw):
    from isegprobe_tpu.ops.pool import adaptive_pool as j_pool
    from isegprobe_torch.ops.pool import adaptive_pool

    x = np.random.default_rng(0).standard_normal((2, *in_hw, 3)).astype(
        np.float32)
    want = np.asarray(j_pool(jnp.asarray(x), out_hw, mode))
    got = adaptive_pool(torch.from_numpy(x), out_hw, mode).numpy()
    _close(got, want, TOL)


@pytest.mark.parametrize("impl", ["jnp", "pallas_interpret"])
@pytest.mark.parametrize("dh", [13, 101])
def test_mha_plain_matches_jax(impl, dh):
    """Cross-attention with Nq != Nk and Nk no multiple of 128 (the Pallas
    kernel pads the keys to 256 and masks them)."""
    from isegprobe_tpu.ops.attention import mha as j_mha
    from isegprobe_torch.ops.attention import mha

    rng = np.random.default_rng(dh)
    q = rng.standard_normal((2, 150, 3, dh)).astype(np.float32)
    k = rng.standard_normal((2, 133, 3, dh)).astype(np.float32)
    v = rng.standard_normal((2, 133, 3, dh)).astype(np.float32)
    want = np.asarray(j_mha(q, k, v, scale=dh**-0.5, impl=impl))
    got = mha(*map(torch.from_numpy, (q, k, v)), scale=dh**-0.5).numpy()
    _close(got, want, 1e-4)


def test_mha_plain_rounds_bf16_probabilities():
    """bf16 inputs: the probabilities are cast to bf16 before PV, as the
    JAX reference path does (compared in f32 after one bf16 rounding)."""
    from isegprobe_tpu.ops.attention import mha as j_mha
    from isegprobe_torch.ops.attention import mha

    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((1, n, 2, 16)).astype(np.float32)
               for n in (40, 24, 24))
    want = np.asarray(j_mha(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                            impl="jnp").astype(jnp.float32))
    got = mha(*(torch.from_numpy(a).bfloat16() for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), want, 1e-2)


# tests/test_jbu_kernel.py's shapes, then the edges of kernel E's tiling
# (8x16 tiles, strips of 8): H one past a tile and W one past a strip, and
# the smallest frame reflect padding takes
JBU_SHAPES = [(16, 16), (20, 36), (34, 130), (16, 258), (17, 41), (4, 4)]


@pytest.mark.parametrize("hw", JBU_SHAPES)
def test_jbu_filter_plain_matches_jax(hw):
    """The shapes of tests/test_jbu_kernel.py and the tiling's edges,
    against the XLA composition
    and the Pallas kernel in interpret mode (temp 0.5, sigma 0.8: neither
    normaliser clamp binds, so the two JAX forms agree)."""
    from isegprobe_tpu.ops.jbu_kernel import (
        jbu_filter_pallas,
        jbu_filter_xla,
    )
    from isegprobe_torch.ops.jbu import jbu_filter

    rng = np.random.default_rng(sum(hw))
    hr = rng.standard_normal((1, *hw, 48)).astype(np.float32)
    proj = rng.standard_normal((1, *hw, 32)).astype(np.float32)
    got = jbu_filter(torch.from_numpy(hr), torch.from_numpy(proj), 0.5,
                     0.8).numpy()
    want = np.asarray(jbu_filter_xla(hr, proj, jnp.float32(0.5),
                                     jnp.float32(0.8)))
    _close(got, want, TOL)
    want_pallas = np.asarray(jbu_filter_pallas(hr, proj, 0.5, 0.8,
                                               interpret=True))
    _close(got, want_pallas, 1e-4)


def test_loftup_layers_match_jax():
    """ImplicitFeaturizer (with and without color, learned biases, global
    row coordinates), ChannelNorm, ConvNeXtLayerNorm and min_max_scale."""
    from isegprobe_tpu.models.upsamplers import loftup as j
    from isegprobe_torch.models.upsamplers import loftup as t

    rng = np.random.default_rng(5)
    x = rng.random((2, 12, 20, 3)).astype(np.float32) * 3 - 1
    rows = np.linspace(-1, 1, 30).astype(np.float32)[4:16]
    for color, nf in ((True, 20), (False, 5)):
        jm = j.ImplicitFeaturizer(color, nf, True)
        p = _np_tree(jm.init(jax.random.PRNGKey(nf), x)["params"])
        p["biases"] = rng.standard_normal(p["biases"].shape).astype(
            np.float32)
        tm = load_jax_params(t.ImplicitFeaturizer(color, nf), p)
        for rc in (None, rows):
            want = np.asarray(jm.apply({"params": p}, x, row_coords=rc))
            with torch.no_grad():
                got = tm(torch.from_numpy(x), row_coords=None if rc is None
                         else torch.from_numpy(rc)).numpy()
            _close(got, want, FOURIER_TOL)

    feats = rng.standard_normal((2, 5, 6, 24)).astype(np.float32) * 2 + 1
    for jm, tm in ((j.ChannelNorm(24), t.ChannelNorm(24)),
                   (j.ConvNeXtLayerNorm(24), t.ConvNeXtLayerNorm(24))):
        p = _np_tree(jm.init(jax.random.PRNGKey(0), feats)["params"])
        p = jax.tree.map(lambda a: a + rng.standard_normal(a.shape).astype(
            np.float32), p)
        load_jax_params(tm, p)
        with torch.no_grad():
            got = tm(torch.from_numpy(feats)).numpy()
        _close(got, np.asarray(jm.apply({"params": p}, feats)), TOL)

    _close(t.min_max_scale(torch.from_numpy(x)).numpy(),
           np.asarray(j.min_max_scale(jnp.asarray(x))), TOL)


def _loftup_params(dim, seed):
    from isegprobe_tpu.models.upsamplers.loftup import LoftUpUpsampler

    rng = np.random.default_rng(seed)
    src = rng.standard_normal((2, 4, 4, dim)).astype(np.float32)
    img = rng.random((2, 56, 56, 3)).astype(np.float32)
    jm = LoftUpUpsampler(n_dim=dim, attn_impl="jnp", query_chunk_rows=0)
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(seed), src,
                                       img)["params"])
    # frozen BN statistics away from the identity
    for conv in ("first_conv1", "first_conv2"):
        bn = params[conv]["bn"]
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return src, img, params


@pytest.mark.parametrize("kw", [
    dict(query_chunk_rows=0),
    dict(query_chunk_rows=16, query_chunk_min_pixels=0),
    dict(query_chunk_rows=24, query_chunk_min_pixels=0)],
    ids=["monolithic", "banded16", "banded24"])
def test_loftup_matches_jax(kw):
    """LoftUp at n_dim 32 against JAX, monolithic and banded (24 rows fall
    back to 14, the largest divisor of 56), and banded equal to the port's
    own monolithic path."""
    from isegprobe_tpu.models.upsamplers.loftup import LoftUpUpsampler as JL
    from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler

    src, img, params = _loftup_params(32, seed=2)
    want = np.asarray(jax.jit(JL(n_dim=32, attn_impl="jnp", **kw).apply)(
        {"params": params}, src, img))
    model = load_jax_params(LoftUpUpsampler(n_dim=32, **kw), params)
    mono = load_jax_params(LoftUpUpsampler(n_dim=32, query_chunk_rows=0),
                           params)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(img)).numpy()
        ref = mono(torch.from_numpy(src), torch.from_numpy(img)).numpy()
    assert got.shape == (2, 56, 56, 32)
    scale = float(np.abs(want).max())
    _close(got, want, FOURIER_TOL, scale)
    _close(got, ref, TOL, scale)


def test_loftup_unported_layouts_raise():
    """The padded layout and the tail, once unported, now build and run:
    the padded widths, and a tail that sees every output row with its
    ``tail_halo`` rows each side, those outside the frame marked by
    ``in_frame`` (the shapes; tests/test_torch_loftup_pad.py holds the
    values against JAX)."""
    from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler

    padded = LoftUpUpsampler(n_dim=32, mxu_pad=True)
    assert (padded.cdim, padded.stem) == (128, 256)
    assert padded.first_norm.norm.real == 203
    assert padded.ca_transformer.norm.real == 52
    for kw in (dict(query_chunk_rows=0),
               dict(query_chunk_rows=16, query_chunk_min_pixels=0)):
        up = LoftUpUpsampler(n_dim=32, **kw)
        seen = []

        def tail(x, in_frame):
            seen.append((x.shape[1], in_frame.tolist()))
            return x[:, 2:-2]

        with torch.no_grad():
            out = up(torch.zeros(1, 4, 4, 32), torch.rand(1, 56, 56, 3),
                     tail=tail, tail_halo=2)
        assert out.shape == (1, 56, 56, 32)
        rows = [n for n, _ in seen]
        assert sum(rows) - 4 * len(rows) == 56
        assert seen[0][1][:3] == [0.0, 0.0, 1.0]
        assert seen[-1][1][-3:] == [1.0, 0.0, 0.0]


def test_jbu_featup_matches_jax():
    """The four-stage JBU stack (x16, guidance pooled per stage, the
    448->512-style pool that repeats pixels at the last stage) with learned
    scalars 0.5 / 0.8 and the fixup residual."""
    from isegprobe_tpu.models.upsamplers.jbu import JBUFeatUpUpsampler as JJ
    from isegprobe_torch.models.upsamplers.jbu import JBUFeatUpUpsampler

    rng = np.random.default_rng(4)
    src = rng.standard_normal((2, 4, 4, 24)).astype(np.float32)
    img = rng.random((2, 56, 56, 3)).astype(np.float32)
    jm = JJ()
    params = _np_tree(jax.jit(jm.init)(jax.random.PRNGKey(1), src,
                                       img)["params"])
    for i in range(1, 5):
        params[f"up{i}"]["range_temp"] = np.float32(0.5)
        params[f"up{i}"]["sigma_spatial"] = np.float32(0.8)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, src, img))
    model = load_jax_params(JBUFeatUpUpsampler(feat_dim=24), params)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(img)).numpy()
    assert got.shape == (2, 64, 64, 24)
    _close(got, want, 1e-4, float(np.abs(want).max()))


TINY_ARCH = "dinov2_tiny_upsampler_test"
WIDTH = 128


@pytest.fixture
def tiny_arch(monkeypatch):
    """A 2-block, width-128, 2-head DINOv2 entry in both packages."""
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2
    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2

    for mod in (j_dinov2, t_dinov2):
        monkeypatch.setitem(mod.DINOV2_ARCHS, TINY_ARCH, dataclasses.replace(
            mod.DINOV2_ARCHS["dinov2_vits14"], embed_dim=WIDTH, depth=2,
            num_heads=2))
    return TINY_ARCH


FAMILIES = {
    # banded at 56² so the slab path runs inside the probe
    "loftup": dict(type="loftup", params=dict(
        n_dim=WIDTH, query_chunk_rows=16, query_chunk_min_pixels=0,
        upsampler_path="/weights/loftup.pth")),
    "jbu_featup": dict(type="jbu_featup", params=dict(
        backbone_type="dinov2", use_norm=True)),
}


def family_config(family, size, arch=TINY_ARCH, width=WIDTH):
    return dict(
        backbone_cfg=dict(type="dinov2", params=dict(
            arch=arch, feats_injection_mode="before_backbone")),
        embed_coords_cfg=dict(type="patchEmbed", params=dict(
            img_size=(size, size), patch_size=(14, 14), embed_dim=width)),
        head_cfg=dict(type="convhead", params=dict(
            in_channels=width, num_layers=2, num_classes=1)),
        upsampler_cfg=FAMILIES[family],
        use_disks=True, norm_radius=5, with_prev_mask=True)


def family_model_and_params(family, size, seed=0):
    """The JAX probe of ``family`` with init params, gammas at 0.5, BN
    statistics away from the identity and JBU scalars 0.5 / 0.8."""
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    cfg = family_config(family, size)
    model = JModel(**cfg, attn_impl="jnp")
    image = np.zeros((1, size, size, 4), np.float32)
    points = np.full((1, 8, 3), -1.0, np.float32)
    params = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0), image,
                                          points)["params"])
    rng = np.random.default_rng(seed)

    def adjust(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = adjust(value)
            elif key == "gamma":
                out[key] = np.full_like(value, 0.5)
            elif key == "mean":
                out[key] = rng.normal(0, 0.5, value.shape).astype(np.float32)
            elif key == "var":
                out[key] = rng.uniform(0.5, 2, value.shape).astype(np.float32)
            elif key == "range_temp":
                out[key] = np.float32(0.5)
            elif key == "sigma_spatial":
                out[key] = np.float32(0.8)
            else:
                out[key] = value
        return out

    return cfg, model, adjust(params)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_probe_logits_match_jax(tiny_arch, family):
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = 56
    cfg, jmodel, params = family_model_and_params(family, size)
    rng = np.random.default_rng(0)
    image = rng.random((2, size, size, 4)).astype(np.float32)
    points = np.full((2, 6, 3), -1.0, np.float32)
    points[:, 0] = (size * 0.4, size * 0.5, 0)
    points[0, 3] = (size * 0.8, size * 0.2, 1)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, image,
                                            points)["instances"])
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    with torch.no_grad():
        got = model(torch.from_numpy(image),
                    torch.from_numpy(points))["instances"].numpy()
    assert got.shape == want.shape == (2, size, size, 1)
    tol = FOURIER_TOL if family == "loftup" else 1e-4
    _close(got, want, tol, float(np.abs(want).max()))
