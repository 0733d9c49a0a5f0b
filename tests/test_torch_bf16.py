"""The port's bf16 model forward against the JAX package's bf16 serving path.

The JAX side builds the probe with ``dtype=bfloat16`` and casts every f32
param to bf16, as ``evaluate.py`` does for ``eval_cfg.dtype=bfloat16``
(:145, :202-210). The port's side is ``model.to(torch.bfloat16)`` on the
same numpy param tree, bridged by ``models/convert.py``. Both take the same
f32 image and clicks; the flagship and LoftUp probes run at a tiny arch (2
blocks, width 128, 2 heads of 64) at 56².

Tolerance, as a share of the logits' largest magnitude. Both sides round
to bf16 at the same points (weights, the activations between layers,
attention probabilities) but sum in other orders, so a value may land on
the neighbouring bf16 value and carry that through the next layers.
- flagship: 2^-6 (two bf16 steps of 2^-7); measured 0.0066, as far as the
  JAX bf16 forward lies from its own f32 forward (0.0065).
- LoftUp: 2^-5; measured 0.0191. Its Fourier stem multiplies the pixel
  coordinates and colours by frequencies up to e^10 (22026), where one f32
  ulp of a frequency moves a phase by up to 2e-3. XLA's exp gives 6 of the
  20 frequencies one ulp away from the correctly rounded values the port
  computes, so the two stems' features differ by 2e-3 even in f32 (the
  f32 logits by 3.4e-4 of the scale). The JAX bf16 forward itself moves by
  0.0144-0.0156 of the scale when its f32 image moves by one ulp: its bf16
  LoftUp logits are reproducible to no better than that. With the stems'
  features made equal, each later layer of the two upsamplers agrees to
  one or two bf16 steps (the LayerNorm statistics sum in another order).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isegprobe_torch.models.convert import load_jax_params

torch.set_num_threads(2)

TOL = {"flagship": 2.0**-6, "loftup": 2.0**-5}
SIZE = 56
TINY_ARCH = "dinov2_tiny_bf16_test"
WIDTH = 128
UPSAMPLERS = {
    "flagship": dict(type="identity", params=dict()),
    # banded at 56², so LoftUp's slab path runs inside the probe
    "loftup": dict(type="loftup", params=dict(
        n_dim=WIDTH, query_chunk_rows=16, query_chunk_min_pixels=0,
        upsampler_path="/weights/loftup.pth")),
}


@pytest.fixture
def tiny_arch(monkeypatch):
    """A 2-block, width-128, 2-head DINOv2 entry in both packages."""
    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2

    for mod in (j_dinov2, t_dinov2):
        monkeypatch.setitem(mod.DINOV2_ARCHS, TINY_ARCH, dataclasses.replace(
            mod.DINOV2_ARCHS["dinov2_vits14"], embed_dim=WIDTH, depth=2,
            num_heads=2))
    return TINY_ARCH


def _config(family):
    return dict(
        backbone_cfg=dict(type="dinov2", params=dict(
            arch=TINY_ARCH, feats_injection_mode="before_backbone")),
        embed_coords_cfg=dict(type="patchEmbed", params=dict(
            img_size=(SIZE, SIZE), patch_size=(14, 14), embed_dim=WIDTH)),
        head_cfg=dict(type="convhead", params=dict(
            in_channels=WIDTH, num_layers=2, num_classes=1)),
        upsampler_cfg=UPSAMPLERS[family],
        use_disks=True, norm_radius=5, with_prev_mask=True)


def _params(model, seed):
    """The JAX probe's init params as numpy, with LayerScale gammas at 0.5
    (so attention and the MLPs shape the logits) and BatchNorm statistics
    away from the identity."""
    image = np.zeros((1, SIZE, SIZE, 4), np.float32)
    points = np.full((1, 8, 3), -1.0, np.float32)
    tree = jax.jit(model.init)(jax.random.PRNGKey(0), image,
                               points)["params"]
    rng = np.random.default_rng(seed)

    def adjust(node):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = adjust(value)
            elif key == "gamma":
                out[key] = np.full(value.shape, 0.5, np.float32)
            elif key == "mean":
                out[key] = rng.normal(0, 0.5, value.shape).astype(np.float32)
            elif key == "var":
                out[key] = rng.uniform(0.5, 2, value.shape).astype(np.float32)
            else:
                out[key] = np.asarray(value)
        return out

    return adjust(tree)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    image = rng.random((2, SIZE, SIZE, 4)).astype(np.float32)
    points = np.full((2, 6, 3), -1.0, np.float32)
    points[:, 0] = (SIZE * 0.4, SIZE * 0.5, 0)
    points[0, 3] = (SIZE * 0.8, SIZE * 0.2, 1)
    points[1, 1] = (SIZE * 0.3, SIZE * 0.7, 2)
    return image, points


@pytest.mark.parametrize("family", list(UPSAMPLERS))
def test_bf16_logits_match_jax_bf16(tiny_arch, family):
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    cfg = _config(family)
    params = _params(JModel(**cfg, attn_impl="jnp"), seed=1)
    image, points = _inputs()

    jmodel = JModel(**cfg, attn_impl="jnp", dtype=jnp.bfloat16)
    params16 = jax.tree.map(  # evaluate.py's cast of every f32 param
        lambda x: jnp.asarray(x, jnp.bfloat16)
        if x.dtype == np.float32 else x, params)
    want = np.asarray(jax.jit(jmodel.apply)(
        {"params": params16}, image, points)["instances"], np.float32)

    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    model.to(torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(image),
                    torch.from_numpy(points))["instances"].float().numpy()
    assert got.shape == want.shape == (2, SIZE, SIZE, 1)
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[family] * scale)


def test_loftup_bf16_reference_moves_with_one_ulp_of_the_image(tiny_arch):
    """The floor under LoftUp's tolerance: the JAX bf16 forward alone moves
    its logits by more than 2^-7 of their scale (0.0144-0.0156 measured)
    when every pixel of the f32 image moves by one ulp, since the Fourier
    stem multiplies the colours by frequencies up to e^10."""
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    cfg = _config("loftup")
    params = _params(JModel(**cfg, attn_impl="jnp"), seed=1)
    image, points = _inputs()
    params16 = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16)
        if x.dtype == np.float32 else x, params)
    apply = jax.jit(JModel(**cfg, attn_impl="jnp", dtype=jnp.bfloat16).apply)
    rng = np.random.default_rng(5)
    away = np.where(rng.random(image.shape) < 0.5, 2.0, -1.0)
    nudged = np.nextafter(image, away.astype(np.float32))
    a, b = (np.asarray(apply({"params": params16}, x, points)["instances"],
                       np.float32) for x in (image, nudged))
    moved = float(np.abs(a - b).max() / np.abs(a).max())
    assert 2.0**-7 < moved < TOL["loftup"]
