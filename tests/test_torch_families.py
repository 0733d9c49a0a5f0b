"""The other backbone families of the port against the JAX package: the DINO
ViT key probe, MaskCLIP, the SimpleViT late-injection click encoder, LiFT
and the ``linear`` / ``simple_conv`` heads, module by module and as whole
probes, their ``init_tree`` against ``model.init(PRNGKey(0))``, the eval
pos-embed resize, and the trained MaskCLIP probe against the JAX device
evaluator's results stored in ``isegprobe_torch/fixtures/
synthetic_maskclip.npz``.

That fixture holds the JAX f32 device evaluator's results for the trained
160-epoch MaskCLIP probe (``assets/trained/synthetic_maskclip_noup_160ep.
ckpt`` through ``evaluate.py:load_model_for_eval``; fixed 448² ZoomIn,
flip, 20 clicks, target IoU 0.9, threshold 0.5, chunks of 8) on the
objects of ``synthetic2026_50.npz``, in object order: ``maskclip_ious``
[K, 20], ``maskclip_n`` [K], ``maskclip_clicks`` [K, 20, 3] (as the
flagship's in that file), ``maskclip_objects`` (K = 78, every object) and,
over them, ``maskclip_noc``, ``maskclip_over_max`` and ``maskclip_miou``.
Write it with ``JAX_PLATFORMS=cpu python tests/test_torch_families.py
--export`` (it saves after every chunk).
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
MASKCLIP_FIXTURE = (REPO / "isegprobe_torch" / "fixtures"
                    / "synthetic_maskclip.npz")
MASKCLIP_CKPT = REPO / "assets" / "trained" / "synthetic_maskclip_noup_160ep.ckpt"
EXPORT_CHUNK = 8
N_CLICKS = 20


def export(n_objects: int = 78, path=MASKCLIP_FIXTURE):
    """The JAX device evaluator on the trained MaskCLIP probe, one chunk of
    EXPORT_CHUNK objects at a time through one compiled evaluator (the
    scenes are all 224², so these are the chunks a whole run makes);
    the file is rewritten after every chunk."""
    from isegprobe_tpu.inference import device_eval as jde
    from isegprobe_tpu.inference.metrics import compute_noc_metric, miou_at_k
    from tests.test_torch_fixtures import (
        FIXTURE,
        PROTOCOL,
        TARGET,
        _evaluate_cli,
        _lane_key,
        _np_lane_key,
        _objects,
    )

    with np.load(FIXTURE) as fx:
        images, labels, objects = fx["images"], fx["labels"], fx["objects"]
    model, params = _evaluate_cli().load_model_for_eval(
        str(MASKCLIP_CKPT), {"dtype": "float32"}, target_size=TARGET)
    seen = {}

    def record(key, n_prior, is_pos, cy, cx):
        seen[(tuple(int(v) for v in key), int(n_prior))] = (
            int(cy), int(cx), int(bool(is_pos)))

    inner = jde.next_click_from_error

    def recording_clicker(gt, pred_mask, not_clicked, not_ignore):
        is_pos, cy, cx = inner(gt, pred_mask, not_clicked, not_ignore)
        n_prior = (~not_clicked).astype(jnp.int32).sum()
        jax.debug.callback(record, _lane_key(gt), n_prior, is_pos, cy, cx)
        return is_pos, cy, cx

    jde.next_click_from_error = recording_clicker
    ious = np.zeros((0, N_CLICKS), np.float32)
    counts = np.zeros(0, np.int16)
    clicks = np.full((0, N_CLICKS, 3), -1, np.int16)
    try:
        run = jde.make_device_evaluator(model, target_size=TARGET,
                                        **PROTOCOL, batch_size=EXPORT_CHUNK)
        for lo in range(0, n_objects, EXPORT_CHUNK):
            t0 = time.time()
            data = _objects(images, labels, objects,
                            slice(lo, min(lo + EXPORT_CHUNK, len(objects))))
            got = jde.evaluate_dataset_device(run, params, data,
                                              batch_size=EXPORT_CHUNK)
            c_ious = np.zeros((len(got), N_CLICKS), np.float32)
            c_clicks = np.full((len(got), N_CLICKS, 3), -1, np.int16)
            c_n = np.zeros(len(got), np.int16)
            for i, arr in enumerate(got):
                key = _np_lane_key(data.get_sample(i).gt_mask(0))
                c_n[i] = len(arr)
                c_ious[i, :len(arr)] = arr
                for k in range(len(arr)):
                    c_clicks[i, k] = seen[(key, k)]
            ious = np.concatenate([ious, c_ious])
            counts = np.concatenate([counts, c_n])
            clicks = np.concatenate([clicks, c_clicks])
            per_object = [ious[i, :counts[i]] for i in range(len(counts))]
            noc, _, over_max = compute_noc_metric(per_object,
                                                  [0.8, 0.85, 0.9], N_CLICKS)
            np.savez_compressed(
                path, maskclip_ious=ious, maskclip_n=counts,
                maskclip_clicks=clicks,
                maskclip_objects=np.int16(len(counts)),
                maskclip_noc=np.asarray(noc),
                maskclip_over_max=np.asarray(over_max),
                maskclip_miou=miou_at_k(per_object, N_CLICKS))
            print(f"objects {lo}..{lo + len(got) - 1}: "
                  f"{time.time() - t0:.0f} s; NoC@80/85/90 over "
                  f"{len(counts)} objects {noc}", flush=True)
    finally:
        jde.next_click_from_error = inner
    print(f"wrote {path} ({path.stat().st_size} bytes)")



# -- tiny archs and the JAX side -----------------------------------------------

TOL = 1e-5          # a module, f32, of its output scale
LOGIT_TOL = 1e-4    # a whole probe, f32, of the logit scale
BF16_TOL = 2.0**-6  # the bf16 MaskCLIP probe against JAX's bf16 probe
TINY = "tiny_test"
WIDTH = 128


def _np(tree):

    return jax.tree.map(np.asarray, jax.device_get(tree))


@pytest.fixture
def tiny_archs(monkeypatch):
    """A 2-block DINOv2, a 2-block DINO trunk pretrained on a 4x4 grid and
    a 3-block CLIP tower (width 128, heads of 64, 64-wide output, 4x4
    grid), in both packages' tables."""
    from isegprobe_torch.models import init_tree as t_init
    from isegprobe_torch.models.featurizers import dino as t_dino
    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2
    from isegprobe_torch.models.featurizers import maskclip as t_clip
    from isegprobe_tpu.models.featurizers import dino as j_dino
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2
    from isegprobe_tpu.models.featurizers import maskclip as j_clip

    for mod in (j_dinov2, t_dinov2):
        monkeypatch.setitem(mod.DINOV2_ARCHS, TINY, dataclasses.replace(
            mod.DINOV2_ARCHS["dinov2_vits14"], embed_dim=WIDTH, depth=2,
            num_heads=2))
    for mod in (j_dino, t_dino, t_init):
        monkeypatch.setattr(mod, "DINO_TRUNK", dataclasses.replace(
            mod.DINO_TRUNK, embed_dim=WIDTH, depth=2, num_heads=2,
            pretrain_grid=(4, 4)))
    for mod in (j_clip, t_clip):
        monkeypatch.setitem(mod.CLIP_ARCHS, TINY, dict(
            patch_size=16, width=WIDTH, layers=3, heads=2, output_dim=64,
            pretrain_grid=4))
    return TINY


def tiny_config(family: str, size: int) -> dict:
    """The four families' configs (``probe_model.synthetic_config``) at the
    tiny archs and ``size``²."""
    from isegprobe_torch.models.probe_model import synthetic_config

    cfg = synthetic_config(family, (size, size))
    bp = cfg["backbone_cfg"]["params"]
    ep = cfg["embed_coords_cfg"]["params"]
    hp = cfg["head_cfg"]["params"]
    if family == "maskclip_noup":
        bp["model_name"] = TINY
        ep["embed_dim"], hp["in_channels"] = WIDTH, 64
    else:
        if family != "vit_noup":
            bp["arch"] = TINY
        ep["embed_dim"] = hp["in_channels"] = WIDTH
    if family == "dinov2_simplevit":
        ep.update(depth=2, heads=2, mlp_dim=256, dim_head=32)
    if family == "dinov2_lift":
        cfg["upsampler_cfg"]["params"]["n_dim"] = WIDTH
    return cfg


FAMILY_SIZE = {"maskclip_noup": 80, "vit_noup": 80, "dinov2_simplevit": 56,
               "dinov2_lift": 56}


def _perturb(tree, seed: int):
    """Init params with LayerScale gammas at 0.5 and BatchNorm statistics
    and scales away from the identity, so that every layer shapes the
    output."""
    rng = np.random.default_rng(seed)

    def walk(node, bn=False):
        out = {}
        for key, value in node.items():
            if isinstance(value, dict):
                out[key] = walk(value, bn=key == "bn")
            elif key == "gamma":
                out[key] = np.full(value.shape, 0.5, np.float32)
            elif key == "mean":
                out[key] = rng.normal(0, 0.5, value.shape).astype(np.float32)
            elif key == "var":
                out[key] = rng.uniform(0.5, 2, value.shape).astype(np.float32)
            elif bn and key in ("scale", "bias"):
                out[key] = rng.normal(float(key == "scale"), 0.3,
                                      value.shape).astype(np.float32)
            else:
                out[key] = np.asarray(value)
        return out

    return walk(tree)


def _jax_probe(cfg, size, seed=1, dtype=None):
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    kw = {} if dtype is None else {"dtype": dtype}
    model = JModel(**cfg, attn_impl="jnp", **kw)
    image = np.zeros((1, size, size, 4), np.float32)
    points = np.full((1, 8, 3), -1.0, np.float32)
    params = _np(jax.jit(JModel(**cfg, attn_impl="jnp").init)(
        jax.random.PRNGKey(0), image, points)["params"])
    return model, _perturb(params, seed)


def _inputs(size, n_clicks=3, seed=0):
    rng = np.random.default_rng(seed)
    image = rng.random((2, size, size, 4)).astype(np.float32)
    points = np.full((2, 2 * n_clicks, 3), -1.0, np.float32)
    points[:, 0] = (size * 0.4, size * 0.5, 0)
    points[0, n_clicks] = (size * 0.8, size * 0.2, 1)
    points[1, 1] = (size * 0.3, size * 0.7, 2)
    return image, points


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _apply(module, params, *args, **kwargs):

    return np.asarray(jax.jit(lambda p, *a: module.apply(
        {"params": p}, *a, **kwargs))(params, *args))


# -- modules ------------------------------------------------------------------

@pytest.mark.parametrize("feat_type", ["key", "token"])
@pytest.mark.parametrize("mode", ["no_injection", "before_backbone",
                                  "after_backbone"])
def test_dino_featurizer_matches_jax(tiny_archs, feat_type, mode):
    """At a 5x6 grid against the trunk's 4x4 (the '+0.1' bicubic)."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.featurizers.dino import DINOFeaturizer
    from isegprobe_tpu.models.featurizers.dino import DINOFeaturizer as J

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 80, 96, 3)).astype(np.float32)
    add = rng.standard_normal((2, 30, WIDTH)).astype(np.float32)
    kw = dict(feat_type=feat_type, feats_injection_mode=mode)
    jmod = J(**kw, attn_impl="jnp")
    params = _np(jmod.init(jax.random.PRNGKey(2), x, add)["params"])
    want = _apply(jmod, params, x, add)
    mod = load_jax_params(DINOFeaturizer(**kw), params)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(add)).numpy()
    assert got.shape == (2, 5, 6, WIDTH)
    _close(got, want, TOL)


@pytest.mark.parametrize("grid", [(4, 4), (5, 6)])
def test_clip_tower_dense_features_match_jax(grid):
    """``CLIPVisionTransformer.dense_features`` at a small width, at the
    pretraining grid (the raw table) and off it; the JAX tree's last block
    holds only ``ln_1`` and ``attn``."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.featurizers.maskclip import (
        CLIPVisionTransformer,
    )
    from isegprobe_tpu.models.featurizers.maskclip import (
        CLIPVisionTransformer as J,
    )

    kw = dict(patch_size=16, width=WIDTH, layers=3, heads=2, output_dim=64,
              pretrain_grid=4)
    x = np.random.default_rng(4).standard_normal(
        (2, 16 * grid[0], 16 * grid[1], 3)).astype(np.float32)
    jmod = J(**kw, attn_impl="jnp")
    params = _np(jmod.init(jax.random.PRNGKey(5), x)["params"])
    assert set(params["resblocks_2"]) == {"ln_1", "attn"}
    assert set(params["resblocks_1"]) == {"ln_1", "attn", "ln_2", "c_fc",
                                          "c_proj"}
    want = _apply(jmod, params, x)
    mod = load_jax_params(CLIPVisionTransformer(**kw), params)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (2, grid[0] * grid[1], 64)
    _close(got, want, TOL)


@pytest.mark.parametrize("mode", ["no_injection", "before_backbone",
                                  "after_backbone"])
def test_maskclip_featurizer_matches_jax(tiny_archs, mode):
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.featurizers.maskclip import (
        MaskCLIPFeaturizer,
    )
    from isegprobe_tpu.models.featurizers.maskclip import (
        MaskCLIPFeaturizer as J,
    )

    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 80, 64, 3)).astype(np.float32)
    width = 64 if mode == "after_backbone" else WIDTH
    add = rng.standard_normal((2, 20, width)).astype(np.float32)
    kw = dict(model_name=TINY, feats_injection_mode=mode)
    jmod = J(**kw, attn_impl="jnp")
    params = _np(jmod.init(jax.random.PRNGKey(7), x, add)["params"])
    want = _apply(jmod, params, x, add)
    mod = load_jax_params(MaskCLIPFeaturizer(**kw), params)
    with torch.no_grad():
        got = mod(torch.from_numpy(x), torch.from_numpy(add))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 4, 64)
    _close(got.numpy(), want, TOL)


def test_simple_vit_matches_jax():
    """Inner width (2 heads of 32) other than the model width (96), a 4x5
    grid of 4x4 patches of 3 channels."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.featurizers.simple_vit import (
        SimpleViTFeaturizer,
    )
    from isegprobe_tpu.models.featurizers.simple_vit import (
        SimpleViTFeaturizer as J,
    )

    kw = dict(image_size=(16, 20), patch_size=(4, 4), dim=96, depth=2,
              heads=2, mlp_dim=128, dim_head=32)
    x = np.random.default_rng(8).random((2, 16, 20, 3)).astype(np.float32)
    jmod = J(**kw, attn_impl="jnp")
    params = _np(jmod.init(jax.random.PRNGKey(9), x)["params"])
    want = _apply(jmod, params, x)
    mod = load_jax_params(SimpleViTFeaturizer(**kw, channels=3), params)
    with torch.no_grad():
        got = mod(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 20, 96)
    _close(got, want, TOL)


def test_lift_matches_jax():
    """LiFT at n_dim 32 on a 4x5 source guided by a 56x70 image, its
    BatchNorms away from the identity."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.upsamplers.lift import LiFTUpsampler
    from isegprobe_tpu.models.upsamplers.lift import LiFTUpsampler as J

    rng = np.random.default_rng(10)
    src = rng.standard_normal((2, 4, 5, 32)).astype(np.float32)
    img = rng.standard_normal((2, 56, 70, 3)).astype(np.float32)
    jmod = J(n_dim=32)
    params = _perturb(_np(jmod.init(jax.random.PRNGKey(11), src,
                                    img)["params"]), 12)
    want = _apply(jmod, params, src, img)
    mod = load_jax_params(LiFTUpsampler(n_dim=32), params)
    with torch.no_grad():
        got = mod(torch.from_numpy(src), torch.from_numpy(img)).numpy()
    assert got.shape == (2, 8, 10, 32)
    _close(got, want, TOL)


@pytest.mark.parametrize("htype", ["linear", "simple_conv"])
def test_heads_match_jax(htype):
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.heads import HEAD_REGISTRY
    from isegprobe_tpu.models.heads import HEAD_REGISTRY as J

    kw = dict(in_channels=24, num_classes=2)
    if htype == "simple_conv":
        kw["num_layers"] = 2
    x = np.random.default_rng(13).standard_normal(
        (2, 7, 9, 24)).astype(np.float32)
    jmod = J[htype](**kw)
    params = _np(jmod.init(jax.random.PRNGKey(14), x)["params"])
    want = _apply(jmod, params, x)
    head = load_jax_params(HEAD_REGISTRY[htype](**kw), params)
    with torch.no_grad():
        got = head(torch.from_numpy(x)).numpy()
    assert got.shape == (2, 7, 9, 2)
    _close(got, want, TOL)


# -- whole probes -------------------------------------------------------------

FAMILIES = list(FAMILY_SIZE)


@pytest.mark.parametrize("family", FAMILIES)
def test_probe_logits_match_jax(tiny_archs, family):
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = FAMILY_SIZE[family]
    cfg = tiny_config(family, size)

    jmodel, params = _jax_probe(cfg, size)
    image, points = _inputs(size)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params}, image,
                                            points)["instances"])
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    with torch.no_grad():
        got = model(torch.from_numpy(image),
                    torch.from_numpy(points))["instances"].numpy()
    assert got.shape == (2, size, size, 1)
    _close(got, want, LOGIT_TOL)


def test_maskclip_bf16_logits_match_jax_bf16(tiny_archs):
    """Params cast to bf16 on both sides, as evaluate.py casts them."""
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = FAMILY_SIZE["maskclip_noup"]
    cfg = tiny_config("maskclip_noup", size)
    jmodel, params = _jax_probe(cfg, size, dtype=jnp.bfloat16)
    params16 = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), params)
    image, points = _inputs(size)
    want = np.asarray(jax.jit(jmodel.apply)({"params": params16}, image,
                                            points)["instances"], np.float32)
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    model.to(torch.bfloat16)
    with torch.no_grad():
        got = model(torch.from_numpy(image),
                    torch.from_numpy(points))["instances"].float().numpy()
    _close(got, want, BF16_TOL)


def test_simple_vit_trunk_cache_equals_the_full_forward(tiny_archs):
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel

    size = FAMILY_SIZE["dinov2_simplevit"]
    cfg = tiny_config("dinov2_simplevit", size)
    _, params = _jax_probe(cfg, size)
    model = load_jax_params(iSegProbeModel(**cfg, device="cpu"), params)
    image, points = (torch.from_numpy(a) for a in _inputs(size))
    with torch.no_grad():
        want = model(image, points)["instances"]
        trunk = model.compute_backbone_trunk(image)
        got = model.forward_with_cached_trunk(image, points,
                                              trunk)["instances"]
    assert trunk.shape == (2, size // 14, size // 14, WIDTH)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


def test_synthetic_configs_equal_the_model_scripts():
    """``probe_model.synthetic_config`` against ``models/synthetic/*.py``'s
    modules as ``init_model_from_modules_cfg`` passes them."""
    import importlib.util
    from types import SimpleNamespace

    from isegprobe_torch.models.probe_model import synthetic_config

    crop = (448, 448)
    cfg = SimpleNamespace(training_params=SimpleNamespace(crop_size=crop),
                          UPSAMPLERS=SimpleNamespace(LIFT="/weights/lift.pth"))
    sys.path.insert(0, str(REPO))
    for name in FAMILIES:
        spec = importlib.util.spec_from_file_location(
            f"synthetic_{name}_script", REPO / "models" / "synthetic"
            / f"{name}.py")
        script = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(script)
        mods = script.define_modules_cfg(cfg)
        got = synthetic_config(name, crop)
        assert got["backbone_cfg"] == mods["backbone"], name
        assert got["head_cfg"] == mods["head"], name
        assert got["upsampler_cfg"] == mods["upsampler"], name
        assert got["save_cfg"] == mods["save"], name
        ec = dict(mods["embed_coords"], params=dict(
            mods["embed_coords"]["params"],
            img_size=list(mods["embed_coords"]["params"]["img_size"])))
        assert got["embed_coords_cfg"] == ec, name


# -- init_tree ----------------------------------------------------------------

@pytest.mark.parametrize("family,head", [
    ("maskclip_noup", "convhead"), ("vit_noup", "convhead"),
    ("dinov2_simplevit", "linear"), ("dinov2_lift", "simple_conv")])
def test_init_tree_matches_jax_init(tiny_archs, family, head):
    from isegprobe_torch.models.init_tree import init_tree
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from tests.test_torch_checkpoint import _assert_tree_close

    cfg = tiny_config(family, 56)
    if head != "convhead":
        cfg["head_cfg"] = dict(type=head, params=dict(
            in_channels=cfg["head_cfg"]["params"]["in_channels"],
            **({"num_layers": 2} if head == "simple_conv" else {})))
    image = np.zeros((1, 56, 56, 4), np.float32)
    points = np.full((1, 8, 3), -1.0, np.float32)
    want = jax.jit(JModel(**cfg).init)(jax.random.PRNGKey(0), image,
                                       points)["params"]
    got = init_tree(cfg)
    _assert_tree_close(got, want)
    if family == "maskclip_noup":
        tower = got["backbone"]["model"]
        assert set(tower["resblocks_2"]) == {"ln_1", "attn"}


def test_init_tree_full_width_maskclip(maskclip_112):
    """The trained checkpoint's config at full width: the 81,468,672 frozen
    scalars of the ViT-B/16 tower that the port's ``load_model_for_eval``
    drew with ``init_tree`` (and loaded leaf for leaf, none missing or
    unexpected), against the tower the root ``evaluate.py`` draws, through
    the bridge's names and layouts: the same leaves, the missing last-block
    ones included, and values within 2 ulp."""
    from isegprobe_torch.models.convert import jax_params_to_state_dict
    from tests.test_torch_checkpoint import ULP_BOUND

    jax_tower = maskclip_112["jax"][1]["backbone"]
    assert set(jax_tower["model"]["resblocks_11"]) == {"ln_1", "attn"}
    want = jax_params_to_state_dict({"backbone": jax_tower})
    got = {k: v for k, v in maskclip_112["port"][0].state_dict().items()
           if k.startswith("backbone.")}
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        scale = float(w.abs().max())
        tol = ULP_BOUND * float(np.spacing(np.float32(scale))) if scale else 0
        assert float((g - w).abs().max()) <= tol, name
    assert sum(w.numel() for w in want.values()) == MASKCLIP_FROZEN


MASKCLIP_FROZEN = 81_468_672


# -- the eval pos-embed resize --------------------------------------------------

@pytest.mark.parametrize("btype", ["dinov2", "vit", "mask_clip",
                                   "simple_vit"])
def test_preinterpolate_pos_embed_matches_root(btype):
    """``evaluate._preinterpolate_pos_embed`` against the root
    ``evaluate.py:interpolate_backbone_pos_embed`` at 448²: DINOv2 from 37²
    to 32², the DINO trunk from 14² to 28²; MaskCLIP and SimpleViT come
    back unchanged."""
    from types import SimpleNamespace


    from isegprobe_torch.evaluate import _preinterpolate_pos_embed
    from isegprobe_torch.models.probe_model import synthetic_config
    from tests.test_torch_checkpoint import _evaluate_cli

    n = 1 + (37 * 37 if btype == "dinov2" else 14 * 14)
    pe = np.random.default_rng(15).standard_normal(
        (1, n, 384)).astype(np.float32)
    params = {"backbone": {"model": {"pos_embed": pe}}}
    cfg = synthetic_config("vit_noup", (448, 448))
    cfg["backbone_cfg"] = dict(
        type=btype, params=cfg["backbone_cfg"]["params"] if btype == "vit"
        else {})
    config = {"class": "isegprobe_tpu.models.probe_model.iSegProbeModel",
              "params": cfg}
    model = SimpleNamespace(dtype=jnp.float32, quant=None,
                            fuse_hr_head=False)
    jmodel, jparams = _evaluate_cli().interpolate_backbone_pos_embed(
        model, params, config, (448, 448))
    got_cfg, got = _preinterpolate_pos_embed(config, params, (448, 448))
    if jmodel is model:  # the root left model and params alone
        assert btype in ("mask_clip", "simple_vit")
        assert jparams is params and got_cfg is config and got is params
        return
    grid = {"dinov2": (32, 32), "vit": (28, 28)}[btype]
    want = np.asarray(jparams["backbone"]["model"]["pos_embed"], np.float32)
    assert want.shape == (1, 1 + grid[0] * grid[1], 384)
    np.testing.assert_allclose(got["backbone"]["model"]["pos_embed"], want,
                               rtol=0, atol=1e-6)
    assert tuple(jmodel.backbone_cfg["params"]["pretrain_grid"]) == grid
    assert tuple(got_cfg["params"]["backbone_cfg"]["params"]
                 ["pretrain_grid"]) == grid


# -- the trained MaskCLIP probe -------------------------------------------------

@pytest.fixture(scope="module")
def maskclip_results():
    with np.load(MASKCLIP_FIXTURE) as data:
        return dict(data)


def test_maskclip_fixture_is_consistent(maskclip_results):
    """All 78 objects; NoC and mIoU@k recomputed from
    the stored IoUs; clicks present exactly up to each object's count,
    first clicks positive and inside the object."""
    from isegprobe_tpu.inference.metrics import compute_noc_metric, miou_at_k
    from tests.test_torch_fixtures import FIXTURE

    fx = maskclip_results
    k = int(fx["maskclip_objects"])
    assert k == 78
    assert fx["maskclip_ious"].shape == (k, N_CLICKS)
    assert fx["maskclip_clicks"].shape == (k, N_CLICKS, 3)
    with np.load(FIXTURE) as scenes:
        objects, labels = scenes["objects"], scenes["labels"]
    per_object = []
    for i, n in enumerate(fx["maskclip_n"]):
        assert 1 <= n <= N_CLICKS
        clicks = fx["maskclip_clicks"][i]
        assert (clicks[:n] >= 0).all() and (clicks[n:] == -1).all()
        assert (fx["maskclip_ious"][i, n:] == 0).all()
        scene, label = objects[i]
        y, x, pos = clicks[0]
        assert pos == 1 and labels[scene, y, x] == label
        per_object.append(fx["maskclip_ious"][i, :n])
    noc, _, over_max = compute_noc_metric(per_object, [0.8, 0.85, 0.9],
                                          N_CLICKS)
    np.testing.assert_array_equal(fx["maskclip_noc"], noc)
    np.testing.assert_array_equal(fx["maskclip_over_max"], over_max)
    np.testing.assert_array_equal(fx["maskclip_miou"],
                                  miou_at_k(per_object, N_CLICKS))
    assert noc[2] < 10  # the trained probe segments


@pytest.fixture(scope="module")
def maskclip_112():
    """The trained MaskCLIP probe through the root's and the port's
    ``load_model_for_eval`` at 112², once for the tests below. MaskCLIP's
    pos-embed is not resized at load, so the port's model is the one any
    target size gives."""
    from isegprobe_torch.evaluate import load_model_for_eval
    from tests.test_torch_checkpoint import _evaluate_cli

    jax_side = _evaluate_cli().load_model_for_eval(
        str(MASKCLIP_CKPT), {"dtype": "float32"}, target_size=(112, 112))
    port = load_model_for_eval(str(MASKCLIP_CKPT), torch.float32,
                               (112, 112), device="cpu")
    return {"jax": jax_side, "port": port}


def test_load_model_for_eval_maskclip_matches_jax(maskclip_112):
    """The port's model: the tower rebuilt from PRNGKey(0), the config left
    as it was (no pos-embed resize), logits within 1e-3 of their scale of
    the root's (as the flagship's, tests/test_torch_checkpoint.py)."""

    size = 112
    jmodel, jparams = maskclip_112["jax"]
    model, info = maskclip_112["port"]
    assert info["frozen_params"] == MASKCLIP_FROZEN
    assert "pretrain_grid" not in info["config"]["params"]["backbone_cfg"][
        "params"]
    rng = np.random.default_rng(0)
    image = rng.random((2, size, size, 4)).astype(np.float32)
    points = np.full((2, 4, 3), -1.0, np.float32)
    points[:, 0] = (50, 60, 0)
    points[:, 2] = (20, 30, 1)
    want = np.asarray(jmodel.apply({"params": jparams}, image,
                                   points)["instances"])
    with torch.no_grad():
        got = model(torch.from_numpy(image),
                    torch.from_numpy(points))["instances"].numpy()
    _close(got, want, 1e-3)


TRAINED_CPU_CLICKS = 2


def test_trained_maskclip_clicks_as_the_fixture(maskclip_results,
                                                 maskclip_112):
    """The port's device loop on the CPU (448², flip, the export's
    protocol) on the first object, for its first clicks: the JAX
    evaluator's clicks and IoUs within 1e-3."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )

    model = maskclip_112["port"][0]
    k = TRAINED_CPU_CLICKS
    run = make_device_evaluator(model, target_size=(448, 448), max_clicks=k,
                                net_clicks_limit=N_CLICKS, pred_thr=0.5,
                                target_iou=0.9, batch_size=1,
                                record_clicks=True, device="cpu")
    clicks: list = []
    got = evaluate_dataset_device(
        run, SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, 1)),
        clicks=clicks)
    n = min(k, int(maskclip_results["maskclip_n"][0]))
    assert [tuple(int(v) for v in c) for c in clicks[0][:n]] == [
        tuple(int(v) for v in c)
        for c in maskclip_results["maskclip_clicks"][0, :n]]
    np.testing.assert_allclose(got[0][:n],
                               maskclip_results["maskclip_ious"][0, :n],
                               rtol=0, atol=1e-3)


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="full-width bf16 forwards on the CPU (RUN_SLOW=1)")
def test_maskclip_bf16_lies_as_far_from_jax_as_jax_bf16_from_itself(
        maskclip_results):
    """Why bf16 moves the trained MaskCLIP's NoC: at 448², on the first
    scene with one click and its flip, the port's bf16 logits lie no
    farther from JAX's bf16 logits (as a share of the f32 logit scale)
    than twice JAX's own bf16 noise, the larger of its distance from JAX
    f32 and from itself on an image moved by one ulp. Prints the
    distances and the pixels whose sign differs from JAX f32."""
    from isegprobe_torch.evaluate import load_model_for_eval
    from tests.test_torch_checkpoint import _evaluate_cli
    from tests.test_torch_fixtures import FIXTURE

    size = 448
    with np.load(FIXTURE) as fx:
        img = torch.from_numpy(fx["images"][0].astype(np.float32) / 255.0)
    img = torch.nn.functional.interpolate(
        img.permute(2, 0, 1)[None], size=(size, size),
        mode="bilinear").permute(0, 2, 3, 1).numpy()
    x = np.concatenate([img, np.zeros((1, size, size, 1), np.float32)], -1)
    x = np.ascontiguousarray(np.concatenate([x, x[:, :, ::-1]]))
    pts = np.full((2, 40, 3), -1.0, np.float32)
    pts[:, 0] = (200.0, 220.0, 0)
    rng = np.random.default_rng(5)
    nudged = np.nextafter(x, np.where(rng.random(x.shape) < 0.5, 2.0,
                                      -1.0).astype(np.float32))
    logits = {}
    for dtype in ("float32", "bfloat16"):
        jmodel, jparams = _evaluate_cli().load_model_for_eval(
            str(MASKCLIP_CKPT), {"dtype": dtype}, target_size=(size, size))
        apply = jax.jit(jmodel.apply)
        logits[f"jax_{dtype}"] = np.asarray(
            apply({"params": jparams}, x, pts)["instances"], np.float32)
        if dtype == "bfloat16":
            logits["jax_bfloat16_ulp"] = np.asarray(
                apply({"params": jparams}, nudged, pts)["instances"],
                np.float32)
        model, _ = load_model_for_eval(str(MASKCLIP_CKPT),
                                       getattr(torch, dtype), (size, size),
                                       device="cpu")
        with torch.no_grad():
            logits[f"port_{dtype}"] = model(
                torch.from_numpy(x), torch.from_numpy(pts))[
                    "instances"].float().numpy()
    scale = float(np.abs(logits["jax_float32"]).max())

    def dist(a, b):
        return float(np.abs(logits[a] - logits[b]).max()) / scale

    port = dist("port_bfloat16", "jax_bfloat16")
    noise = max(dist("jax_bfloat16", "jax_float32"),
                dist("jax_bfloat16", "jax_bfloat16_ulp"))
    flips = {k: int(((logits[k] > 0) != (logits["jax_float32"] > 0)).sum())
             for k in ("port_bfloat16", "jax_bfloat16")}
    print(f"port bf16 vs JAX bf16 {port:.4f}; JAX bf16 vs JAX f32 "
          f"{dist('jax_bfloat16', 'jax_float32'):.4f}, vs itself one ulp "
          f"away {dist('jax_bfloat16', 'jax_bfloat16_ulp'):.4f}; port f32 "
          f"vs JAX f32 {dist('port_float32', 'jax_float32'):.2e}; sign "
          f"flips against JAX f32 {flips}")
    assert dist("port_float32", "jax_float32") < 1e-4
    assert port <= 2 * noise


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="reruns the JAX device evaluator (RUN_SLOW=1)")
def test_jax_maskclip_evaluator_reproduces_stored_results(maskclip_results,
                                                          tmp_path):
    """The first chunk of eight objects, as the export ran it."""
    export(EXPORT_CHUNK, tmp_path / "maskclip.npz")
    with np.load(tmp_path / "maskclip.npz") as fresh:
        for key in ("maskclip_n", "maskclip_clicks", "maskclip_ious"):
            np.testing.assert_array_equal(
                fresh[key], maskclip_results[key][:EXPORT_CHUNK])


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if sys.argv[1:] != ["--export"]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_families.py"
                 " --export")
    export()
