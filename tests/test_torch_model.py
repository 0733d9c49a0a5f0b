"""The port's models against the JAX package: the weight bridge, a tiny ViT
forward, and whole-model logits of the probe from the same JAX-initialized
params, bridged into the port.

Tolerances: f32 on both sides, differing only in summation order inside the
matmuls, convolutions and the fused softmax; after two transformer blocks
and a 2-layer 3x3 head that stays below 1e-4 of the logits' scale."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from isegprobe_torch.models.convert import (
    jax_params_to_state_dict,
    load_jax_params,
)

torch.set_num_threads(2)

TOL = 1e-4
TINY_ARCH = "dinov2_tiny_test"


def _to_numpy(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _set_gammas(tree, value):
    """LayerScale gammas start at 1e-5; raise them so attention and the MLP
    shape the logits the tests compare."""
    return {k: (_set_gammas(v, value) if isinstance(v, dict) else
                (np.full_like(v, value) if k == "gamma" else v))
            for k, v in tree.items()}


@pytest.fixture
def tiny_arch(monkeypatch):
    """A 2-block, width-128, 2-head (dh=64) DINOv2 entry in both packages'
    arch tables."""
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2
    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2

    monkeypatch.setitem(j_dinov2.DINOV2_ARCHS, TINY_ARCH, dataclasses.replace(
        j_dinov2.DINOV2_ARCHS["dinov2_vits14"], embed_dim=128, depth=2,
        num_heads=2))
    monkeypatch.setitem(t_dinov2.DINOV2_ARCHS, TINY_ARCH, dataclasses.replace(
        t_dinov2.DINOV2_ARCHS["dinov2_vits14"], embed_dim=128, depth=2,
        num_heads=2))
    return TINY_ARCH


def tiny_config(size, arch=TINY_ARCH, width=128):
    return dict(
        backbone_cfg=dict(type="dinov2",
                          params=dict(arch=arch,
                                      feats_injection_mode="before_backbone")),
        embed_coords_cfg=dict(type="patchEmbed",
                              params=dict(img_size=(size, size),
                                          patch_size=(14, 14),
                                          embed_dim=width)),
        head_cfg=dict(type="convhead",
                      params=dict(in_channels=width, num_layers=2,
                                  num_classes=1)),
        upsampler_cfg=dict(type="identity", params=dict()),
        use_disks=True,
        norm_radius=5,
        with_prev_mask=True,
    )


def jax_model_and_params(cfg, size, attn_impl="jnp", gamma=0.5):
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    model = JModel(**cfg, attn_impl=attn_impl)
    image = np.zeros((1, size, size, 4), np.float32)
    points = np.full((1, 8, 3), -1.0, np.float32)
    params = _to_numpy(model.init(jax.random.PRNGKey(0), image,
                                  points)["params"])
    return model, _set_gammas(params, gamma)


def _inputs(size, n_clicks=3, seed=0):
    rng = np.random.default_rng(seed)
    image = rng.random((2, size, size, 4)).astype(np.float32)
    points = np.full((2, 2 * n_clicks, 3), -1.0, np.float32)
    points[:, 0] = (size * 0.4, size * 0.5, 0)
    points[0, n_clicks] = (size * 0.8, size * 0.2, 1)
    points[1, 1] = (size * 0.3, size * 0.7, 2)
    return image, points


@pytest.mark.parametrize("size,attn_impl", [(56, "jnp"),
                                            (112, "pallas_interpret")])
def test_probe_logits_match_jax(tiny_arch, size, attn_impl):
    from isegprobe_torch.models.probe_model import iSegProbeModel

    cfg = tiny_config(size)
    jmodel, params = jax_model_and_params(cfg, size, attn_impl)
    image, points = _inputs(size)
    want = np.asarray(jmodel.apply({"params": params}, image,
                                   points)["instances"])

    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    with torch.no_grad():
        got = model(torch.from_numpy(image),
                    torch.from_numpy(points))["instances"].numpy()
    assert got.shape == want.shape == (2, size, size, 1)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale)


@pytest.mark.parametrize("grid", [(4, 4), (3, 5)])
def test_vit_forward_matches_jax(grid):
    """Tiny ViT trunk at the pretraining grid (the exact-size short-circuit)
    and off it (bicubic with the +0.1 scale trick)."""
    from isegprobe_tpu.models.vit import ViT as JViT
    from isegprobe_tpu.models.vit import ViTConfig as JConfig
    from isegprobe_torch.models.vit import ViT, ViTConfig

    kw = dict(patch_size=14, embed_dim=128, depth=2, num_heads=2,
              pretrain_grid=(4, 4))
    img = np.random.default_rng(1).standard_normal(
        (2, 14 * grid[0], 14 * grid[1], 3)).astype(np.float32)
    jvit = JViT(JConfig(**kw, layerscale=True, attn_impl="jnp"))
    params = _set_gammas(
        _to_numpy(jvit.init(jax.random.PRNGKey(1), img)["params"]), 0.7)
    params["pos_embed"] = np.random.default_rng(2).standard_normal(
        params["pos_embed"].shape).astype(np.float32)
    want = np.asarray(jvit.apply({"params": params}, img)["patch_tokens"])
    vit = load_jax_params(ViT(ViTConfig(**kw)), params)
    with torch.no_grad():
        got = vit(torch.from_numpy(img))["patch_tokens"].numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_bridge_loads_flagship_tree():
    """The full flagship param tree (shapes from the JAX model, random
    values) loads with no key left over, and the layouts are right."""
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    cfg = flagship_config((56, 56))
    shapes = jax.eval_shape(
        JModel(**cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, 56, 56, 4)), jnp.full((1, 8, 3), -1.0))["params"]
    rng = np.random.default_rng(0)
    tree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), tree)
    sd = model.state_dict()
    assert len(sd) == len(jax.tree.leaves(tree))
    blk = tree["backbone"]["model"]["blocks_11"]
    np.testing.assert_array_equal(
        sd["backbone.model.blocks.11.attn.qkv.weight"].numpy(),
        blk["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["backbone.model.blocks.11.norm2.weight"].numpy(),
        blk["norm2"]["scale"])
    np.testing.assert_array_equal(
        sd["head.convs.1.weight"].numpy(),
        tree["head"]["convs_1"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        sd["embed_coords.proj.weight"].numpy(),
        tree["embed_coords"]["proj"]["kernel"].transpose(3, 2, 0, 1))


def test_bridge_raises_on_missing_and_unexpected_keys():
    from isegprobe_torch.models.heads import ConvSegHead

    head = ConvSegHead(8, num_layers=1)
    tree = {"convs_0": {"kernel": np.zeros((3, 3, 8, 8), np.float32),
                        "bias": np.zeros(8, np.float32)},
            "classifier": {"kernel": np.zeros((1, 1, 8, 1), np.float32),
                           "bias": np.zeros(1, np.float32)}}
    assert set(jax_params_to_state_dict(tree)) == set(head.state_dict())
    load_jax_params(head, tree)

    missing = {"convs_0": tree["convs_0"]}
    with pytest.raises(KeyError, match="classifier.weight"):
        load_jax_params(head, missing)
    extra = dict(tree, convs_1=tree["convs_0"])
    with pytest.raises(KeyError, match="convs.1.weight"):
        load_jax_params(head, extra)
    bad = dict(tree, classifier={"kernel": np.zeros((1, 1, 8, 2), np.float32),
                                 "bias": np.zeros(1, np.float32)})
    with pytest.raises(ValueError):
        load_jax_params(head, bad)


def test_unported_configs_raise():
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )

    cfg = flagship_config((56, 56))
    # int8 W8A8 is ported: the backbone's dense layers become QuantLinear;
    # an unknown mode raises, as the JAX package's _dense does
    from isegprobe_torch.ops.quant import QuantLinear

    int8 = iSegProbeModel(**cfg, quant="int8", device="cpu")
    assert sum(isinstance(m, QuantLinear)
               for m in int8.backbone.modules()) == 48
    assert not any(isinstance(m, QuantLinear)
                   for part in (int8.embed_coords, int8.head)
                   for m in part.modules())
    with pytest.raises(ValueError, match="Unknown quant mode"):
        iSegProbeModel(**cfg, quant="int4", device="cpu")
    # LoftUp's padded layout and the fused head are ported
    padded = iSegProbeModel(**{**cfg, "upsampler_cfg": dict(
        type="loftup", params=dict(mxu_pad=True))}, fuse_hr_head=True,
        device="cpu")
    assert padded.upsampler.cdim == 512 and padded._fused_head()
    # the fused head applies to LoftUp only
    assert not iSegProbeModel(**cfg, fuse_hr_head=True,
                              device="cpu")._fused_head()
    # the RITM maps transform is ported
    model = iSegProbeModel(**cfg, use_rgb_conv=True, device="cpu")
    assert model.maps_transform is not None
    assert model.embed_coords.proj.in_channels == 64


def test_entry_points_need_a_gpu_or_an_explicit_cpu():
    from isegprobe_torch.inference.predictor import Predictor
    from isegprobe_torch.models.probe_model import (
        flagship_config,
        iSegProbeModel,
    )

    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    cfg = flagship_config((56, 56))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        iSegProbeModel(**cfg)
    model = iSegProbeModel(**cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Predictor(model)
    Predictor(model, device="cpu")


@pytest.mark.parametrize("mode", ["no_injection", "before_backbone",
                                  "after_backbone"])
def test_featurizer_injection_modes_match_jax(tiny_arch, mode):
    from isegprobe_tpu.models.featurizers.dinov2 import (
        DINOv2Featurizer as JFeaturizer,
    )
    from isegprobe_torch.models.featurizers.dinov2 import DINOv2Featurizer

    rng = np.random.default_rng(3)
    img = rng.standard_normal((2, 56, 42, 3)).astype(np.float32)
    clicks = rng.standard_normal((2, 12, 128)).astype(np.float32)
    jf = JFeaturizer(arch=tiny_arch, feats_injection_mode=mode,
                     attn_impl="jnp")
    params = _set_gammas(_to_numpy(
        jf.init(jax.random.PRNGKey(2), img, clicks)["params"]), 0.5)
    want = np.asarray(jf.apply({"params": params}, img, clicks))
    feat = load_jax_params(DINOv2Featurizer(arch=tiny_arch,
                                            feats_injection_mode=mode),
                           params)
    with torch.no_grad():
        got = feat(torch.from_numpy(img), torch.from_numpy(clicks)).numpy()
    assert got.shape == want.shape == (2, 4, 3, 128)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _random_tree(cfg, size=56):
    """The JAX probe's full param tree for ``cfg`` (shapes from
    ``eval_shape``, values random)."""
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    shapes = jax.eval_shape(
        JModel(**cfg).init, jax.random.PRNGKey(0),
        jnp.zeros((1, size, size, 4)), jnp.full((1, 8, 3), -1.0))["params"]
    rng = np.random.default_rng(0)
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


def _family_config(upsampler_cfg):
    from isegprobe_torch.models.probe_model import flagship_config

    return dict(flagship_config((56, 56)), upsampler_cfg=upsampler_cfg)


LOFTUP_CFG = dict(type="loftup", params=dict(upsampler_path="/weights/"
                                             "loftup.pth", n_dim=384))
JBU_CFG = dict(type="jbu_featup", params=dict(backbone_type="dinov2",
                                              use_norm=True))


def test_bridge_loads_learned_upsampler_trees():
    """The full-width LoftUp and JBU-FeatUp probe trees (the trained LoftUp
    checkpoint's config; random values) load with no key left over, with
    the new leaves in the port's layout."""
    from isegprobe_torch.models.probe_model import iSegProbeModel

    tree = _random_tree(_family_config(LOFTUP_CFG))
    model = load_jax_params(iSegProbeModel(**_family_config(LOFTUP_CFG),
                                           device="cpu"), tree)
    sd = model.state_dict()
    assert len(sd) == len(jax.tree.leaves(tree))
    up = tree["upsampler"]
    ca1 = up["ca_transformer"]["ca_1"]
    np.testing.assert_array_equal(
        sd["upsampler.ca_transformer.ca.1.attention.in_proj_weight"].numpy(),
        ca1["attention"]["in_proj_weight"])
    np.testing.assert_array_equal(
        sd["upsampler.ca_transformer.ca.1.attention.out_proj.weight"].numpy(),
        ca1["attention"]["out_proj"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["upsampler.ca_transformer.ff.0.fc1.weight"].numpy(),
        up["ca_transformer"]["ff_0"]["fc1"]["kernel"].T)
    bn = up["first_conv2"]["bn"]
    for leaf, name in (("scale", "weight"), ("mean", "mean"), ("var", "var")):
        np.testing.assert_array_equal(
            sd[f"upsampler.first_conv2.bn.{name}"].numpy(), bn[leaf])
    np.testing.assert_array_equal(sd["upsampler.fourier_feat.biases"].numpy(),
                                  up["fourier_feat"]["biases"])
    np.testing.assert_array_equal(sd["upsampler.final_ln.weight"].numpy(),
                                  up["final_ln"]["weight"])

    tree = _random_tree(_family_config(JBU_CFG))
    model = load_jax_params(iSegProbeModel(**_family_config(JBU_CFG),
                                           device="cpu"), tree)
    sd = model.state_dict()
    assert len(sd) == len(jax.tree.leaves(tree))
    assert sd["upsampler.up3.range_temp"].shape == ()
    assert float(sd["upsampler.up3.sigma_spatial"]) == float(
        tree["upsampler"]["up3"]["sigma_spatial"])
    np.testing.assert_array_equal(
        sd["upsampler.up1.range_proj1.weight"].numpy(),
        tree["upsampler"]["up1"]["range_proj1"]["kernel"].transpose(3, 2, 0, 1))


def test_bridge_raises_on_upsampler_key_mismatch():
    """A missing or an unexpected upsampler subtree raises (no silent
    random upsampler), and so does a config parameter the port does not
    take."""
    from isegprobe_torch.models.probe_model import iSegProbeModel

    cfg = _family_config(JBU_CFG)
    tree = _random_tree(cfg)
    model = iSegProbeModel(**cfg, device="cpu")
    up = dict(tree["upsampler"])
    del up["fixup_proj"]
    with pytest.raises(KeyError, match="fixup_proj"):
        load_jax_params(model, dict(tree, upsampler=up))
    up = dict(tree["upsampler"], up5=tree["upsampler"]["up4"])
    with pytest.raises(KeyError, match="up5"):
        load_jax_params(model, dict(tree, upsampler=up))
    no_upsampler = {k: v for k, v in tree.items() if k != "upsampler"}
    with pytest.raises(KeyError, match="upsampler.up1.range_temp"):
        load_jax_params(model, no_upsampler)
    for params in (dict(n_dim=384, dtype="bfloat16"),
                   dict(n_dim=384, fuse_hr_head=True)):
        with pytest.raises(TypeError, match="does not take"):
            iSegProbeModel(**_family_config(dict(type="loftup",
                                                 params=params)),
                           device="cpu")
