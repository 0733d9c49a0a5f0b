"""LoftUp's zero-padded layout (``mxu_pad=True``) and the head fused into
its slab loop (``fuse_hr_head``) against the JAX package and against the
port's own unpadded, unfused path, on the same numpy inputs.

Tolerances, each with its reason:
* the masked LayerNorm (kernel B's plain version with ``real``) against
  flax's ``nn.LayerNorm(mask=)``: the same f32 sums in another order, 1e-5;
* the padded upsampler and transformer against JAX's: 1e-5 of the output
  scale (zero rows and columns add exact zeros, so only the summation
  order differs); the tiny probe's fused logits against JAX's within
  ``FOURIER_TOL`` of their scale, the bound ``tests/test_torch_upsamplers.py``
  gives LoftUp probes (an ulp of a Fourier phase at frequencies up to
  e^10 moves a feature by ~1e-3); the trained checkpoint's logits through
  ``load_model_for_eval`` within 1e-3 of their scale, as
  ``tests/test_torch_checkpoint.py`` holds the unpadded ones, and its
  padded upsampler tree within ``ULP_BOUND`` ulp of JAX's (the init tree's
  bound);
* padded against unpadded and fused against unfused in the port: 1e-5 of
  the scale (a padded product adds exact zeros; the fused head computes
  the same rows in slabs).
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from isegprobe_torch.models.convert import load_jax_params, pad_loftup_params
from tests.test_torch_checkpoint import LOFTUP, ULP_BOUND, _evaluate_cli
from tests.test_torch_upsamplers import (  # noqa: F401  (fixture)
    FOURIER_TOL,
    family_model_and_params,
    tiny_arch,
)

torch.set_num_threads(2)

TOL = 1e-5
LOGIT_TOL = 1e-3
DIM = 32
BANDINGS = {"monolithic": dict(query_chunk_rows=0),
            "banded16": dict(query_chunk_rows=16, query_chunk_min_pixels=0)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _close(got, want, tol, scale=1.0):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _loftup(seed=2, dim=DIM):
    """Inputs and init params of a JAX LoftUp at ``dim``, with frozen BN
    statistics away from the identity, and the params padded."""
    from isegprobe_tpu.models.upsamplers.loftup import LoftUpUpsampler

    rng = np.random.default_rng(seed)
    src = rng.standard_normal((2, 4, 4, dim)).astype(np.float32)
    img = rng.random((2, 56, 56, 3)).astype(np.float32)
    params = _np_tree(jax.jit(LoftUpUpsampler(
        n_dim=dim, attn_impl="jnp", query_chunk_rows=0).init)(
            jax.random.PRNGKey(seed), src, img)["params"])
    for conv in ("first_conv1", "first_conv2"):
        bn = params[conv]["bn"]
        bn["mean"] = rng.normal(0, 0.5, bn["mean"].shape).astype(np.float32)
        bn["var"] = rng.uniform(0.5, 2.0, bn["var"].shape).astype(np.float32)
    return src, img, params, pad_loftup_params(params, n_dim=dim)


@pytest.mark.parametrize("dim,real", [(512, 404), (256, 203), (16, 11),
                                      (8, 8)])
@pytest.mark.parametrize("tail", ["zero", "drawn"])
def test_masked_layernorm_matches_flax(dim, real, tail):
    """Statistics over the first ``real`` channels, every channel
    normalised: flax's ``mask=arange(dim) < real``, whatever the tail
    holds."""
    import flax.linen as nn

    from isegprobe_torch.ops.layernorm import layernorm

    rng = np.random.default_rng(dim + real)
    x = (rng.standard_normal((3, 7, dim)) * 2 + 0.5).astype(np.float32)
    if tail == "zero":
        x[..., real:] = 0
    scale = rng.normal(1, 0.2, dim).astype(np.float32)
    bias = rng.normal(0, 0.2, dim).astype(np.float32)
    ln = nn.LayerNorm(epsilon=1e-5)
    mask = None if real == dim else np.arange(dim) < real
    want = np.asarray(ln.apply({"params": {"scale": scale, "bias": bias}},
                               x, mask=mask))
    got = layernorm(torch.from_numpy(x), torch.from_numpy(scale),
                    torch.from_numpy(bias), 1e-5, real).numpy()
    _close(got, want, TOL, float(np.abs(want).max()))


def test_layernorm_rejects_a_real_count_out_of_range():
    from isegprobe_torch.ops.layernorm import layernorm

    x, w = torch.zeros(2, 8), torch.ones(8)
    for real in (0, 9):
        with pytest.raises(ValueError, match="real"):
            layernorm(x, w, w, 1e-5, real)


def test_padded_ca_transformer_matches_jax():
    """The cross-attention transformer on padded params and zero-padded
    inputs: masked norms, head-interleaved projections and the real head's
    softmax scale."""
    from isegprobe_tpu.models.upsamplers.loftup import CATransformer as JCA
    from isegprobe_torch.models.upsamplers.loftup import CATransformer

    _, _, _, padded = _loftup()
    cdim, creal = 128, DIM + 20
    rng = np.random.default_rng(3)
    q = np.zeros((2, 40, cdim), np.float32)
    kv = np.zeros((2, 16, cdim), np.float32)
    q[..., :creal] = rng.standard_normal((2, 40, creal))
    kv[..., :creal] = rng.standard_normal((2, 16, creal))
    tree = padded["ca_transformer"]
    want = np.asarray(JCA(cdim, 2, 4, DIM, "jnp", real_dim=creal).apply(
        {"params": tree}, q, kv))
    model = load_jax_params(CATransformer(cdim, 2, 4, DIM, creal), tree)
    with torch.no_grad():
        got = model(torch.from_numpy(q), torch.from_numpy(kv)).numpy()
    _close(got, want, TOL, float(np.abs(want).max()))
    assert not got[..., creal:].any()


@pytest.mark.parametrize("banding", list(BANDINGS))
def test_padded_loftup_matches_jax_and_unpadded(banding):
    from isegprobe_tpu.models.upsamplers.loftup import LoftUpUpsampler as JL
    from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler

    kw = BANDINGS[banding]
    src, img, params, padded = _loftup()
    want = np.asarray(jax.jit(JL(n_dim=DIM, attn_impl="jnp", mxu_pad=True,
                                 **kw).apply)({"params": padded}, src, img))
    model = load_jax_params(LoftUpUpsampler(n_dim=DIM, mxu_pad=True, **kw),
                            padded)
    plain = load_jax_params(LoftUpUpsampler(n_dim=DIM, **kw), params)
    assert (model.cdim, model.stem) == (128, 256)
    with torch.no_grad():
        got = model(torch.from_numpy(src), torch.from_numpy(img)).numpy()
        ref = plain(torch.from_numpy(src), torch.from_numpy(img)).numpy()
    scale = float(np.abs(want).max())
    _close(got, want, TOL, scale)
    _close(got, ref, TOL, scale)


def test_padded_activations_are_exact_zeros():
    """Every padded channel of every layer's output is an exact zero: the
    padded BN scale, bias and mean are 0 and its variance 1, the padded
    projection columns and norm scales 0, so kernel B's sums (and flax's
    masked ones) see zeros there."""
    from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler

    src, img, _, padded = _loftup()
    model = load_jax_params(LoftUpUpsampler(n_dim=DIM, mxu_pad=True,
                                            query_chunk_rows=0), padded)
    real = {model.first_norm: 203}
    seen = {}
    for name, mod in model.named_modules():
        if name.startswith(("first_conv1", "first_conv2")) and \
                name.count(".") == 0:
            real[mod] = DIM + 20
        if name.startswith("ca_transformer.") and name.endswith(
                ("norm_q", "norm_kv", "attention", "norm", "fc2")):
            real[mod] = DIM + 20
    real[model.ca_transformer] = DIM + 20
    hooks = [m.register_forward_hook(
        lambda mod, args, out, n=r: seen.setdefault(mod, []).append(
            (n, out))) for m, r in real.items()]
    with torch.no_grad():
        model(torch.from_numpy(src), torch.from_numpy(img))
    for h in hooks:
        h.remove()
    # the stem norm and convs, 5 outputs a layer, the final norm, the whole
    assert len(seen) == len(real) == 3 + 2 * 5 + 1 + 1
    for outs in seen.values():
        for n, out in outs:
            assert out[..., n:].abs().max() == 0


@pytest.mark.parametrize("head", ["convhead", "linear", "simple_conv"])
@pytest.mark.parametrize("banding", list(BANDINGS))
def test_fused_head_matches_unfused(head, banding):
    """The head run inside the slab loop (its ``banded`` contract, the
    frame edge's zero padding by ``in_frame``) gives the unfused logits."""
    from isegprobe_torch.models.heads import HEAD_REGISTRY
    from isegprobe_torch.models.upsamplers.loftup import LoftUpUpsampler

    src, img, params, padded = _loftup()
    up = load_jax_params(LoftUpUpsampler(n_dim=DIM, mxu_pad=True,
                                         **BANDINGS[banding]), padded)
    kw = dict(in_channels=DIM, num_classes=1)
    if head != "linear":
        kw["num_layers"] = 2
    torch.manual_seed(0)
    mod = HEAD_REGISTRY[head](**kw)
    assert mod.tail_halo == (2 if head == "convhead" else 0)
    with torch.no_grad():
        want = mod(up(torch.from_numpy(src), torch.from_numpy(img)))
        got = up(torch.from_numpy(src), torch.from_numpy(img),
                 tail=mod.banded, tail_halo=mod.tail_halo)
    assert got.shape == want.shape == (2, 56, 56, 1)
    _close(got.numpy(), want.numpy(), TOL, float(want.abs().max()))


@pytest.mark.parametrize("mxu_pad", [False, True], ids=["unpadded",
                                                        "padded"])
def test_fused_probe_matches_jax(tiny_arch, mxu_pad):
    """The tiny LoftUp probe (banded at 56²) with ``fuse_hr_head`` against
    JAX's fused probe, in both layouts, and against the port's unfused
    probe."""
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = 56
    cfg, _, params = family_model_and_params("loftup", size)
    if mxu_pad:
        up = cfg["upsampler_cfg"]
        cfg = dict(cfg, upsampler_cfg=dict(up, params=dict(
            up["params"], mxu_pad=True)))
        params = dict(params, upsampler=pad_loftup_params(
            params["upsampler"], n_dim=up["params"]["n_dim"]))
    rng = np.random.default_rng(0)
    image = rng.random((2, size, size, 4)).astype(np.float32)
    points = np.full((2, 6, 3), -1.0, np.float32)
    points[:, 0] = (size * 0.4, size * 0.5, 0)
    points[0, 3] = (size * 0.8, size * 0.2, 1)
    jmodel = JModel(**cfg, attn_impl="jnp", fuse_hr_head=True)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, image,
                                            points)["instances"])
    fused = load_jax_params(iSegProbeModel(**cfg, fuse_hr_head=True,
                                           device="cpu"), params)
    unfused = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    assert fused._fused_head() and not unfused._fused_head()
    args = torch.from_numpy(image), torch.from_numpy(points)
    with torch.no_grad():
        got = fused(*args)["instances"].numpy()
        ref = unfused(*args)["instances"].numpy()
    scale = float(np.abs(want).max())
    _close(got, want, FOURIER_TOL, scale)
    _close(got, ref, TOL, scale)


def test_load_model_for_eval_padded_and_fused_match_jax():
    """The trained LoftUp checkpoint at 112² with ``mxu_pad`` and
    ``fuse_hr_head`` against the root ``load_model_for_eval`` with the same
    keys (the padded upsampler tree bitwise), and against the port's
    unpadded, unfused load."""
    from isegprobe_torch.evaluate import load_model_for_eval

    size = 112
    jmodel, jparams = _evaluate_cli().load_model_for_eval(
        str(LOFTUP), {"dtype": "float32", "mxu_pad": True,
                      "fuse_hr_head": True}, target_size=(size, size))
    assert jmodel.fuse_hr_head
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        plain, info = load_model_for_eval(str(LOFTUP), torch.float32,
                                          (size, size), device="cpu")
        model, info = load_model_for_eval(
            str(LOFTUP), torch.float32, (size, size), device="cpu",
            frozen=info["frozen"], mxu_pad=True, fuse_hr_head=True)
    assert info["config"]["params"]["upsampler_cfg"]["params"]["mxu_pad"]
    assert model._fused_head() and model.upsampler.cdim == 512
    assert plain.upsampler.cdim == 404  # mxu_pad="auto" in f32: off
    from isegprobe_torch.models.convert import state_dict_to_jax_params

    got_up = state_dict_to_jax_params(model.upsampler.state_dict(),
                                      jparams["upsampler"])
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(got_up)[0],
            jax.tree_util.tree_flatten_with_path(
                _np_tree(jparams["upsampler"]))[0]):
        assert np.array_equal(a == 0, b == 0), path
        np.testing.assert_allclose(
            a, b, rtol=0, atol=ULP_BOUND * np.spacing(np.abs(b).max()),
            err_msg=str(path))
    rng = np.random.default_rng(0)
    image = rng.random((2, size, size, 4)).astype(np.float32)
    points = np.full((2, 4, 3), -1.0, np.float32)
    points[:, 0] = (50, 60, 0)
    points[:, 2] = (20, 30, 1)
    want = np.asarray(jax.jit(jmodel.apply)({"params": jparams}, image,
                                            points)["instances"])
    args = torch.from_numpy(image), torch.from_numpy(points)
    with torch.no_grad():
        got = model(*args)["instances"].numpy()
        ref = plain(*args)["instances"].numpy()
    scale = float(np.abs(want).max())
    _close(got, want, LOGIT_TOL, scale)
    _close(got, ref, TOL, scale)


def test_bf16_load_pads_by_default():
    """``mxu_pad="auto"`` pads in bfloat16, as the root's default does."""
    from isegprobe_torch.evaluate import load_model_for_eval

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # LoftUp's missing upsampler_path
        model, info = load_model_for_eval(str(LOFTUP), torch.bfloat16,
                                          (112, 112), device="cpu")
        off, _ = load_model_for_eval(str(LOFTUP), torch.bfloat16,
                                     (112, 112), device="cpu",
                                     frozen=info["frozen"], mxu_pad=False)
    assert model.upsampler.mxu_pad and model.upsampler.cdim == 512
    assert not off.upsampler.mxu_pad and off.upsampler.cdim == 404


def test_evaluate_cli_takes_the_layout_keys(caplog):
    """``fuse_hr_head`` is a flag; ``mxu_pad`` is accepted, and a value
    naming the layout the dtype does not take warns and is ignored (the
    layout follows the dtype)."""
    from isegprobe_torch.evaluate import parse_args

    base = ["checkpoint=x.ckpt"]
    cfg = parse_args(base)
    assert "mxu_pad" not in cfg and cfg["fuse_hr_head"] is False
    assert parse_args(base + ["fuse_hr_head=true"])["fuse_hr_head"] is True
    agree = (["mxu_pad=auto"], ["mxu_pad=false"],
             ["mxu_pad=true", "dtype=bfloat16"],
             ["mxu_pad=auto", "dtype=bfloat16"])
    for extra in agree:
        caplog.clear()
        assert "mxu_pad" not in parse_args(base + extra)
        assert "ignored" not in caplog.text, extra
    for extra in (["mxu_pad=true"], ["mxu_pad=false", "dtype=bfloat16"]):
        caplog.clear()
        assert "mxu_pad" not in parse_args(base + extra)
        assert "mxu_pad=" in caplog.text and "ignored" in caplog.text
