"""The RITM adaptive protocol of the port against the JAX package: the
dynamic resizes, the per-lane crop and paste, the masked attention, the
masked ViT, featurizer, head and probe forward on the adaptive canvas, the
RITM maps transform, the host transform chain, the adaptive device loop,
the trained flagship's adaptive results and the evaluate CLI's RITM and
cvpr modes. Each test states its tolerance.

The adaptive fixture ``isegprobe_torch/fixtures/synthetic_ritm.npz`` holds
the JAX f32 adaptive evaluator's results (``make_adaptive_runner``: scalar
target 400, ``skip_clicks=1``, flip, 20 clicks, target IoU 0.9, threshold
0.5, B=8, chunks of 8) for the trained 160-epoch flagship
(``assets/trained/synthetic_dinov2_noup_160ep.ckpt``) on the objects of
``synthetic2026_50.npz``, in object order: ``ritm_ious`` [K, 20],
``ritm_n`` [K], ``ritm_clicks`` [K, 20, 3] (y, x, is_positive; -1 past
``ritm_n``), ``ritm_objects`` (K = 78, every object) and, over them,
``ritm_noc`` (NoC@80/85/90), ``ritm_over_max`` and ``ritm_miou``; and the
JAX host protocol's (``TransformChainPredictor`` over ``[ZoomIn(400,
skip_clicks=1), AddHorizontalFlip, SigmoidForPred]``, the same protocol)
on the first HOST_OBJECTS objects: ``ritm_host_ious``, ``ritm_host_n`` and
``ritm_host_clicks``. The host chain averages the flip's probabilities
where the device loop averages its logits, so the two protocols of the
JAX package part by up to 0.0201 in IoU on these objects, and click
differently on two of them. The model is the one ``eval_ritm=true``
loads: the checkpoint's own config and the pos-embed at its pretraining
grid (the RITM protocol skips the pre-interpolation to the eval grid).
Write it with ``JAX_PLATFORMS=cpu python tests/test_torch_adaptive.py
--export`` (it saves after every chunk; ``--export-host`` redoes the host
part alone).
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

if __name__ == "__main__":  # run as a script (--export), from the repo root
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from tests.test_torch_families import tiny_archs  # noqa: E402,F401  (fixture)
from tests.test_torch_model import tiny_arch  # noqa: E402,F401  (fixture)

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RITM_FIXTURE = REPO / "isegprobe_torch" / "fixtures" / "synthetic_ritm.npz"
FLAGSHIP_CKPT = (REPO / "assets" / "trained"
                 / "synthetic_dinov2_noup_160ep.ckpt")
EXPORT_CHUNK = 8
HOST_OBJECTS = 8
N_CLICKS = 20
RITM_TARGET = 400
# the early-stop protocol of the fixed-crop fixture, with the adaptive ZoomIn
RITM_PROTOCOL = dict(max_clicks=N_CLICKS, net_clicks_limit=N_CLICKS,
                     pred_thr=0.5, target_iou=0.9, min_clicks=1,
                     with_flip=True, skip_clicks=1)
# the pretraining grid of DINOv2-S/14 (518 / 14 = 37): loading at it leaves
# the pos-embed as stored, as eval_ritm does
PRETRAIN_SIZE = (518, 518)


def jax_ritm_model(ckpt=FLAGSHIP_CKPT):
    """The JAX model and params ``eval_ritm=true`` evaluates: the root
    ``load_model_for_eval`` at the pretraining grid."""
    from tests.test_torch_fixtures import _evaluate_cli

    return _evaluate_cli().load_model_for_eval(
        str(ckpt), {"dtype": "float32"}, target_size=PRETRAIN_SIZE)


def jax_ritm_run(model, params, data, batch_size):
    """The JAX adaptive evaluator over ``data``: per-object IoUs, click
    counts and clicks [N, N_CLICKS, 3], clicks read by wrapping the
    clicker in ``jax.debug.callback`` keyed by each lane's object."""
    from isegprobe_tpu.inference import adaptive_eval as jae
    from isegprobe_tpu.inference import device_eval as jde
    from tests.test_torch_fixtures import _lane_key, _np_lane_key

    seen = {}

    def record(key, n_prior, is_pos, cy, cx):
        seen[(tuple(int(v) for v in key), int(n_prior))] = (
            int(cy), int(cx), int(bool(is_pos)))

    inner = jae.next_click_from_error

    def recording_clicker(gt, pred_mask, not_clicked, not_ignore):
        is_pos, cy, cx = inner(gt, pred_mask, not_clicked, not_ignore)
        n_prior = (~not_clicked).astype(jnp.int32).sum()
        jax.debug.callback(record, _lane_key(gt), n_prior, is_pos, cy, cx)
        return is_pos, cy, cx

    jae.next_click_from_error = recording_clicker
    try:
        run = jae.make_adaptive_runner(model, RITM_TARGET,
                                       batch_size=batch_size,
                                       **RITM_PROTOCOL)
        got = jde.evaluate_dataset_device(run, params, data,
                                          batch_size=batch_size)
    finally:
        jae.next_click_from_error = inner
    ious = np.zeros((len(got), N_CLICKS), np.float32)
    clicks = np.full((len(got), N_CLICKS, 3), -1, np.int16)
    counts = np.zeros(len(got), np.int16)
    for i, arr in enumerate(got):
        key = _np_lane_key(data.get_sample(i).gt_mask(0))
        counts[i] = len(arr)
        ious[i, :len(arr)] = arr
        for k in range(len(arr)):
            clicks[i, k] = seen[(key, k)]
    return ious, counts, clicks


def export(n_objects: int = 78, path=RITM_FIXTURE):
    """The JAX adaptive evaluator on the trained flagship, one chunk of
    EXPORT_CHUNK objects at a time (the scenes are all 224², so these are
    the chunks a whole run makes); the file is rewritten after every
    chunk."""
    from isegprobe_tpu.inference.metrics import compute_noc_metric, miou_at_k
    from tests.test_torch_fixtures import FIXTURE, _objects

    with np.load(FIXTURE) as fx:
        images, labels, objects = fx["images"], fx["labels"], fx["objects"]
    model, params = jax_ritm_model()
    ious = np.zeros((0, N_CLICKS), np.float32)
    counts = np.zeros(0, np.int16)
    clicks = np.full((0, N_CLICKS, 3), -1, np.int16)
    t_start = time.time()
    for lo in range(0, n_objects, EXPORT_CHUNK):
        t0 = time.time()
        data = _objects(images, labels, objects,
                        slice(lo, min(lo + EXPORT_CHUNK, n_objects)))
        c_ious, c_n, c_clicks = jax_ritm_run(model, params, data,
                                             EXPORT_CHUNK)
        ious = np.concatenate([ious, c_ious])
        counts = np.concatenate([counts, c_n])
        clicks = np.concatenate([clicks, c_clicks])
        per_object = [ious[i, :counts[i]] for i in range(len(counts))]
        noc, _, over_max = compute_noc_metric(per_object, [0.8, 0.85, 0.9],
                                              N_CLICKS)
        np.savez_compressed(
            path, ritm_ious=ious, ritm_n=counts, ritm_clicks=clicks,
            ritm_objects=np.int16(len(counts)), ritm_noc=np.asarray(noc),
            ritm_over_max=np.asarray(over_max),
            ritm_miou=miou_at_k(per_object, N_CLICKS))
        print(f"objects {lo}..{lo + len(c_n) - 1}: {time.time() - t0:.0f} "
              f"s; NoC@80/85/90 over {len(counts)} objects {noc}",
              flush=True)
    print(f"wrote {path} ({path.stat().st_size} bytes) in "
          f"{time.time() - t_start:.0f} s")


def jax_host_chain(model, params):
    """The JAX host protocol of the fixture: the transform chain with the
    RITM ZoomIn, flip and sigmoid."""
    from isegprobe_tpu.inference import transforms as jt
    from isegprobe_tpu.inference.predictor import TransformChainPredictor

    return TransformChainPredictor(
        model, params, [jt.ZoomIn(target_size=RITM_TARGET, skip_clicks=1),
                        jt.AddHorizontalFlip(), jt.SigmoidForPred()],
        net_clicks_limit=N_CLICKS)


def export_host(path=RITM_FIXTURE):
    """Add the JAX host protocol's results on the first HOST_OBJECTS
    objects to the fixture."""
    from isegprobe_tpu.inference.evaluation import evaluate_sample
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset

    t0 = time.time()
    model, params = jax_ritm_model()
    data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, HOST_OBJECTS))
    ious = np.zeros((HOST_OBJECTS, N_CLICKS), np.float32)
    clicks = np.full((HOST_OBJECTS, N_CLICKS, 3), -1, np.int16)
    counts = np.zeros(HOST_OBJECTS, np.int16)
    for i in range(HOST_OBJECTS):
        sample = data.get_sample(i)
        cl, got, _ = evaluate_sample(
            sample.image, sample.gt_mask(0), jax_host_chain(model, params),
            max_iou_thr=RITM_PROTOCOL["target_iou"],
            pred_thr=RITM_PROTOCOL["pred_thr"], max_clicks=N_CLICKS)
        counts[i] = len(got)
        ious[i, :len(got)] = got
        clicks[i, :len(got)] = [(*c.coords, int(c.is_positive)) for c in cl]
    with np.load(path) as f:
        out = dict(f)
    out.update(ritm_host_ious=ious, ritm_host_n=counts,
               ritm_host_clicks=clicks)
    np.savez_compressed(path, **out)
    print(f"host protocol on {HOST_OBJECTS} objects in "
          f"{time.time() - t0:.0f} s; wrote {path}")


# -- ops ----------------------------------------------------------------------

@pytest.mark.parametrize("mode,align,scale", [
    ("bilinear", True, None), ("bilinear", False, None),
    ("bicubic", False, 0.1), ("bicubic", False, None)])
@pytest.mark.parametrize("in_len,out_len", [(37, 16), (37, 43), (12, 29),
                                            (29, 12), (5, 5), (1, 7),
                                            (13, 27), (31, 1)])
def test_dyn_matrix_matches_jax(mode, align, scale, in_len, out_len):
    """The cases of tests/test_dynamic_resize.py and odd extents; the
    '+0.1' scale of the DINO pos-embed where ``scale`` is 0.1. Bitwise
    against JAX's float32 computation op by op (compiled, XLA fuses the
    cubic polynomial and moves its weights by up to 1.2e-6)."""
    from isegprobe_tpu.ops import dynamic_resize as jdr
    from isegprobe_torch.ops import dynamic_resize as tdr

    if scale is not None:
        scale = (out_len + scale) / in_len
    want = np.asarray(jdr.dyn_matrix(
        in_len + 5, out_len + 7, jnp.asarray(in_len), jnp.asarray(out_len),
        mode, align, None if scale is None else jnp.float32(scale)))
    got = tdr.dyn_matrix(in_len + 5, out_len + 7, torch.tensor(in_len),
                         torch.tensor(out_len), mode, align,
                         None if scale is None else torch.tensor(scale))
    np.testing.assert_array_equal(got.numpy(), want)


def test_dyn_resize_and_rounding_match_jax():
    """Per-lane resizes within 1e-6 of the value scale; ``round_half_even_
    div`` equal to JAX's and to Python's float64 ``round`` (ties to even)."""
    from isegprobe_tpu.ops import dynamic_resize as jdr
    from isegprobe_torch.ops import dynamic_resize as tdr

    rng = np.random.default_rng(0)
    h = rng.integers(1, 1200, 400)
    m = np.maximum(h, rng.integers(1, 1201, 400))
    t = rng.integers(100, 700, 400)
    got = tdr.round_half_even_div(torch.tensor(h * t), torch.tensor(m))
    want = np.asarray(jdr.round_half_even_div(jnp.asarray(h * t),
                                              jnp.asarray(m)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [round(a * (b / c)) for a, b, c in zip(h, t, m)]
    assert tdr.round_half_even_div(torch.tensor([5, 7]),
                                   torch.tensor(2)).tolist() == [2, 4]

    x = rng.standard_normal((3, 21, 17, 3)).astype(np.float32)
    in_hw = np.array([[21, 17], [13, 9], [5, 16]], np.int32)
    out_hw = np.array([[34, 9], [25, 19], [1, 3]], np.int32)
    want = np.asarray(jdr.dyn_resize_2d_batched(
        jnp.asarray(x), jnp.asarray(in_hw), jnp.asarray(out_hw), (36, 20)))
    got = tdr.dyn_resize_2d_batched(torch.tensor(x), torch.tensor(in_hw),
                                    torch.tensor(out_hw), (36, 20))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    want = np.asarray(jdr.dyn_resize_2d(jnp.asarray(x[0]), (13, 9), (25, 19),
                                        (36, 20)))
    got = tdr.dyn_resize_2d(torch.tensor(x[0]), (13, 9), (25, 19), (36, 20))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_crop_resize_dyn_and_inverse_paste_dyn_match_jax():
    """Against the JAX functions as the adaptive evaluator compiles them
    (jitted, so the coordinate's multiply-add fuses): within 4e-7 of values
    in [0, 1]; an extent equal to the ROI's size copies exactly."""
    from isegprobe_tpu.ops import sample as js
    from isegprobe_torch.ops import sample as ts

    rng = np.random.default_rng(1)
    img = (rng.random((4, 64, 60, 3)) * 255).astype(np.uint8)
    roi = np.array([[3, 50, 7, 40], [0, 63, 0, 59], [10, 12, 20, 55],
                    [5, 44, 9, 50]], np.int32)
    out_hw = np.array([[70, 50], [64, 60], [5, 90], [40, 42]], np.int32)
    crop = jax.jit(lambda im, r, o: js.crop_resize_dyn(
        im.astype(jnp.float32) / 255.0, r, o, (98, 98)))
    paste = jax.jit(lambda p, o, r: js.inverse_paste_dyn(
        p, o, r, jnp.zeros((1, 64, 60, 1))))
    probs = rng.random((4, 98, 98, 1)).astype(np.float32)
    want_c = np.concatenate([np.asarray(crop(img[i:i + 1], roi[i],
                                             out_hw[i])) for i in range(4)])
    want_p = np.concatenate([np.asarray(paste(probs[i:i + 1], out_hw[i],
                                              roi[i])) for i in range(4)])
    got_c = ts.crop_resize_dyn(torch.tensor(img), torch.tensor(roi),
                               torch.tensor(out_hw), (98, 98)).numpy()
    got_p = ts.inverse_paste_dyn(torch.tensor(probs), torch.tensor(out_hw),
                                 torch.tensor(roi), (64, 60)).numpy()
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=4e-7)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=4e-7)
    # lane 3's extent is its ROI's size (40 x 42): an exact copy
    np.testing.assert_array_equal(got_c[3, :40, :42],
                                  img[3, 5:45, 9:51].astype(np.float32) / 255)
    assert (got_c[3, 40:] == 0).all() and (got_c[3, :, 42:] == 0).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attention_matches_jax(dtype):
    """``mha_qkv(key_mask=...)`` against ``_mha_jnp(key_mask=...)`` on a canvas
    mask (a row-major rect of tokens plus cls), 2 heads of 64: f32 within
    1e-6 of the output scale, bf16 within one bf16 step (2^-8)."""
    from isegprobe_tpu.ops.attention import _mha_qkv_jnp
    from isegprobe_torch.models.vit import canvas_token_mask
    from isegprobe_torch.ops.attention import mha_qkv

    rng = np.random.default_rng(2)
    qkv = rng.standard_normal((2, 1 + 6 * 7, 3 * 128)).astype(np.float32)
    mask = canvas_token_mask((6, 7), torch.tensor([[4, 5], [6, 2]]))
    jdt = getattr(jnp, dtype)
    want = np.asarray(_mha_qkv_jnp(jnp.asarray(qkv, jdt), 2, 0.125,
                                   key_mask=jnp.asarray(mask.numpy()))
                      .astype(jnp.float32))
    got = mha_qkv(torch.tensor(qkv).to(getattr(torch, dtype)), 2, 0.125,
                  key_mask=mask).float().numpy()
    tol = 1e-6 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


# -- models -------------------------------------------------------------------

VIT_TOL = 1e-5      # a module, f32, of its output scale
LOGIT_TOL = 1e-4    # a whole probe, f32, of the logit scale
TRUE_SIZE_TOL = 2e-4  # the canvas against the true-size forward, as JAX's


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("grids", [[(5, 3), (2, 6)], [(7, 7), (4, 4)]])
def test_forward_tokens_masked_matches_jax(grids):
    """The grids of tests/test_masked_vit.py on an 8x8 canvas, a ViT
    pretrained at 7x7 (so (7, 7) takes the raw-table short-circuit): the
    port against JAX's ``forward_tokens_masked`` on the canvas, and its
    valid tokens against the port's own true-size forward."""
    from isegprobe_tpu.models.vit import ViT as JViT
    from isegprobe_tpu.models.vit import ViTConfig as JConfig
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.vit import ViT, ViTConfig

    kw = dict(patch_size=14, embed_dim=64, depth=2, num_heads=4,
              pretrain_grid=(7, 7))
    jvit = JViT(JConfig(**kw, layerscale=True, attn_impl="jnp"))
    params = jvit.init(jax.random.PRNGKey(0),
                       jnp.zeros((1, 98, 98, 3)))["params"]
    rng = np.random.default_rng(7)
    params = jax.tree.map(lambda x: np.asarray(
        rng.standard_normal(x.shape) * 0.02, np.float32), params)
    vit = load_jax_params(ViT(ViTConfig(**kw)), params)
    p, canvas_grid = 14, (8, 8)
    canvas = np.zeros((len(grids), 8 * p, 8 * p, 3), np.float32)
    for i, (gh, gw) in enumerate(grids):
        canvas[i, :gh * p, :gw * p] = rng.standard_normal((gh * p, gw * p, 3))

    def fwd(mdl, x, vg):
        return mdl.forward_tokens_masked(mdl.embed_patches(x), canvas_grid,
                                         vg)["patch_tokens"]

    vg = np.asarray(grids, np.int32)
    want = np.asarray(jax.jit(lambda prm, x, v: jvit.apply(
        {"params": prm}, x, v, method=fwd))(params, canvas, vg))
    with torch.no_grad():
        got = vit.forward_tokens_masked(
            vit.embed_patches(torch.tensor(canvas)), canvas_grid,
            torch.tensor(vg))["patch_tokens"].numpy()
        for i, (gh, gw) in enumerate(grids):
            valid = got[i].reshape(8, 8, -1)[:gh, :gw].reshape(gh * gw, -1)
            true = vit(torch.tensor(canvas[i:i + 1, :gh * p, :gw * p]))
            _close(valid, want[i].reshape(8, 8, -1)[:gh, :gw].reshape(
                gh * gw, -1), VIT_TOL)
            _close(valid, true["patch_tokens"][0].numpy(), TRUE_SIZE_TOL)


def _probe_pair(cfg, size, seed=0):
    """The JAX probe of ``cfg`` and its params (LayerScale gammas at 0.5),
    and the port's probe from those params."""
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from isegprobe_torch.models.convert import load_jax_params
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from tests.test_torch_model import _set_gammas

    jmodel = JModel(**cfg, attn_impl="jnp")
    image = np.zeros((1, size, size, 4), np.float32)
    points = np.full((1, 8, 3), -1.0, np.float32)
    params = _set_gammas(jax.tree.map(np.asarray, jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), image, points)["params"]), 0.5)
    if seed:
        rng = np.random.default_rng(seed)
        params = jax.tree.map(lambda x: x + np.asarray(
            rng.standard_normal(x.shape) * 0.02, np.float32), params)
    return jmodel, params, load_jax_params(
        iSegProbeModel(**cfg, device="cpu"), params)


def _canvas_inputs(sizes, canvas, seed=5):
    """Canvas images ``[B, *canvas, 4]`` with each lane's true-size image
    top-left, points inside each lane's rect, and the true-size images."""
    rng = np.random.default_rng(seed)
    image = np.zeros((len(sizes), *canvas, 4), np.float32)
    pts = np.full((len(sizes), 8, 3), -1.0, np.float32)
    singles = []
    for i, (vh, vw) in enumerate(sizes):
        img = rng.random((vh, vw, 4), dtype=np.float32)
        image[i, :vh, :vw] = img
        pts[i, 0] = [vh * 0.4, vw * 0.6, 0]
        pts[i, 4] = [vh * 0.8, vw * 0.2, 1]
        singles.append(img[None])
    return image, pts, singles


def _masked_case(jmodel, params, tmodel, sizes, canvas):
    """The port's ``forward_masked`` against JAX's (LOGIT_TOL) and, on
    each lane's valid rect, against the port's true-size forward
    (TRUE_SIZE_TOL)."""
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel

    image, pts, singles = _canvas_inputs(sizes, canvas)
    vhw = np.asarray(sizes, np.int32)
    want = np.asarray(jax.jit(lambda prm, x, p, v: jmodel.apply(
        {"params": prm}, x, p, v, method=JModel.forward_masked)
        ["instances"])(params, image, pts, vhw))
    with torch.no_grad():
        got = tmodel.forward_masked(torch.tensor(image), torch.tensor(pts),
                                    torch.tensor(vhw))["instances"].numpy()
        _close(got, want, LOGIT_TOL)
        for i, (vh, vw) in enumerate(sizes):
            true = tmodel(torch.tensor(singles[i]),
                          torch.tensor(pts[i:i + 1]))["instances"]
            _close(got[i, :vh, :vw], true[0].numpy(), TRUE_SIZE_TOL)


@pytest.mark.parametrize("upsampler", ["identity", "bilinear"])
def test_forward_masked_matches_jax(tiny_arch, upsampler):  # noqa: F811
    """The sizes of tests/test_adaptive_eval.py on a 112² canvas."""
    from tests.test_torch_model import tiny_config

    cfg = tiny_config(112)
    cfg["upsampler_cfg"]["type"] = upsampler
    jmodel, params, tmodel = _probe_pair(cfg, 112)
    _masked_case(jmodel, params, tmodel, [(98, 70), (112, 112), (59, 101)],
                 (112, 112))


def test_ritm_maps_transform_matches_jax(tiny_arch):  # noqa: F811
    """``use_rgb_conv``: the RITM transform (stride-2 3x3 conv and its
    ScaleLayer, drawn away from its 0.05 init) before a patch-7 click
    embedding, through ``forward_masked`` against JAX and the true-size
    forward; its ``init_tree`` against ``model.init(PRNGKey(0))`` (paths
    and shapes exact, values within 2 ulp of 1)."""
    from isegprobe_torch.models.init_tree import init_tree
    from tests.test_torch_model import jax_model_and_params, tiny_config

    cfg = dict(tiny_config(112), use_rgb_conv=True)
    cfg["embed_coords_cfg"]["params"]["patch_size"] = (7, 7)
    jmodel, params, tmodel = _probe_pair(cfg, 112, seed=3)
    assert tmodel.maps_transform is not None
    assert tmodel.maps_transform.scale.weight.item() != np.float32(0.05)
    _masked_case(jmodel, params, tmodel, [(98, 70), (112, 112), (84, 56)],
                 (112, 112))
    ours = init_tree(cfg)
    _, init = jax_model_and_params(cfg, 112, gamma=1e-5)
    flat_ours = jax.tree_util.tree_flatten_with_path(ours)[0]
    flat_init = jax.tree_util.tree_flatten_with_path(init)[0]
    assert [k for k, _ in flat_ours] == [k for k, _ in flat_init]
    for (path, a), (_, b) in zip(flat_ours, flat_init):
        assert np.shape(a) == np.shape(b), path
        np.testing.assert_allclose(a, b, rtol=2.0**-22, atol=1e-7,
                                   err_msg=str(path))
    np.testing.assert_array_equal(ours["maps_transform"]["scale"]["scale"],
                                  np.float32([0.05]))


@pytest.mark.parametrize("family,feat_type", [
    ("vit_noup", "key"), ("vit_noup", "token"), ("maskclip_noup", None)])
def test_family_masked_forward_matches_jax(tiny_archs, family, feat_type):
    """The DINO key and token probes and MaskCLIP (tiny widths) through
    ``forward_masked`` on an 80² canvas (16-pixel patches) against JAX and
    the true-size forward."""
    from tests.test_torch_families import tiny_config as family_config

    cfg = family_config(family, 80)
    if feat_type:
        cfg["backbone_cfg"]["params"]["feat_type"] = feat_type
    jmodel, params, tmodel = _probe_pair(cfg, 80, seed=4)
    _masked_case(jmodel, params, tmodel, [(64, 48), (80, 80), (35, 70)],
                 (80, 80))



# -- the host transform chain and the adaptive device loop --------------------

LOOP_TOL = 1e-4   # IoUs, the port against JAX on the same protocol
HOST_TOL = 5e-3   # IoUs, the device loop against the host chain (JAX's own)
T_SMALL = 56      # the adaptive target of the small scenes
SMALL_KW = dict(max_clicks=5, net_clicks_limit=4, pred_thr=0.49,
                target_iou=0.95, with_flip=True, skip_clicks=1,
                min_crop_size=24)


def _small_models():
    from tests.test_torch_model import tiny_config

    return _probe_pair(tiny_config(112), 112, seed=6)


def _chains(jmodel, params, tmodel):
    from isegprobe_tpu.inference import predictor as jp
    from isegprobe_tpu.inference import transforms as jt
    from isegprobe_torch.inference import predictor as tp
    from isegprobe_torch.inference import transforms as tt

    def chain(mod):
        return [mod.ZoomIn(target_size=T_SMALL, skip_clicks=1,
                           min_crop_size=24), mod.AddHorizontalFlip(),
                mod.SigmoidForPred()]

    return (jp.TransformChainPredictor(jmodel, params, chain(jt),
                                       net_clicks_limit=4),
            tp.TransformChainPredictor(tmodel, chain(tt), net_clicks_limit=4,
                                       device="cpu"))


SCENES = [((60, 70), 0), ((50, 90), 3), ((64, 100), 5)]


def test_zoom_in_stale_roi_matches_jax():
    """ZoomIn on a scripted sequence, port against JAX: a first click
    (skipped), a click with a predicted object (the ROI is set, the frame
    cropped to the scalar target's size), then one with an empty prediction,
    whose forward sees the full frame while the inverse still pastes
    through the earlier ROI (the quirk). Crops and pastes within 1e-6."""
    from isegprobe_tpu.inference import clicker as jcl
    from isegprobe_tpu.inference import transforms as jt
    from isegprobe_torch.inference import clicker as tcl
    from isegprobe_torch.inference import transforms as tt

    image = np.random.default_rng(9).random((1, 60, 70, 4)).astype(
        np.float32)
    blob = np.zeros((1, 60, 70, 1), np.float32)
    blob[0, 20:40, 30:55] = 0.9
    prevs = (None, blob, np.zeros_like(blob))
    outs = []
    for mod, cl_mod, arr in ((jt, jcl, np.asarray), (tt, tcl, torch.tensor)):
        clicks = [cl_mod.Click(True, (30, 40), 0),
                  cl_mod.Click(False, (5, 5), 1),
                  cl_mod.Click(True, (25, 50), 2)]
        z = mod.ZoomIn(target_size=T_SMALL, skip_clicks=1, min_crop_size=24)
        steps = []
        for k, prev in enumerate(prevs):
            if prev is not None:
                z._prev_probs = arr(prev)
            x, cl = z.transform(arr(image), [clicks[:k + 1]])
            pm = np.random.default_rng(k).random((1, *x.shape[1:3], 1))
            steps.append((np.asarray(x), [c.coords for c in cl[0]],
                          z._object_roi,
                          np.asarray(z.inv_transform(arr(pm.astype(
                              np.float32))))))
        outs.append(steps)
    for (jx, jc, jroi, jp), (tx, tc, troi, tp) in zip(*outs):
        assert jroi == troi and jx.shape == tx.shape
        np.testing.assert_allclose(tx, jx, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-9)
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    (x1, _, roi1, _), (x2, _, roi2, _), (x3, _, roi3, p3) = outs[1]
    assert roi1 is None and x1.shape[1:3] == (60, 70)
    assert roi2 is not None and max(x2.shape[1:3]) == T_SMALL
    # the quirk: a full-frame forward, pasted through the stale ROI
    assert roi3 == roi2 and x3.shape[1:3] == (60, 70)
    rmin, rmax, cmin, cmax = roi2
    assert (p3[0, :rmin] == 0).all() and (p3[0, rmax + 1:] == 0).all()
    assert (p3[0, rmin:rmax + 1, cmin:cmax + 1] > 0).all()


def test_transform_chain_matches_jax(tiny_arch):  # noqa: F811
    """The port's chain predictor against JAX's on two scenes: the same
    clicks, IoUs within LOOP_TOL."""
    from isegprobe_tpu.inference.evaluation import evaluate_sample as j_eval
    from isegprobe_torch.inference.evaluation import evaluate_sample
    from tests.test_torch_predictor import _scene

    jmodel, params, tmodel = _small_models()
    jchain, tchain = _chains(jmodel, params, tmodel)
    protocol = dict(max_iou_thr=0.95, pred_thr=0.49, max_clicks=4)
    for hw, seed in SCENES[:2]:
        img, gt = _scene(seed, hw)
        jc, jious, _ = j_eval(img, gt, jchain, **protocol)
        tc, tious, _ = evaluate_sample(img, gt, tchain, **protocol)
        assert [(c.is_positive, c.coords) for c in tc] == [
            (c.is_positive, c.coords) for c in jc]
        np.testing.assert_allclose(tious, jious, rtol=0, atol=LOOP_TOL)


def test_adaptive_loop_matches_jax_and_the_chain(tiny_arch):  # noqa: F811
    """The port's adaptive device loop: at B=1 and B=3 over scenes of three
    valid rects in one padded shape, the same click counts as JAX's
    ``make_adaptive_evaluator`` with IoUs within LOOP_TOL; and the same
    counts as the port's host chain with IoUs within HOST_TOL (the chain
    averages the flip's probabilities where the loop averages logits, as
    in the JAX package, whose test holds its own pair to 5e-3)."""
    from isegprobe_tpu.inference import adaptive_eval as jae
    from isegprobe_tpu.inference import device_eval as jde
    from isegprobe_torch.inference.adaptive_eval import make_adaptive_evaluator
    from isegprobe_torch.inference.device_eval import evaluate_dataset_device
    from isegprobe_torch.inference.evaluation import evaluate_sample
    from tests.test_torch_predictor import _scene, _Scenes

    jmodel, params, tmodel = _small_models()
    scenes = [_scene(seed, hw) for hw, seed in SCENES]
    data = _Scenes(scenes)
    for batch in (1, 3):
        want = jde.evaluate_dataset_device(
            jae.make_adaptive_evaluator(jmodel, target_size=T_SMALL,
                                        frame_hw=(64, 128), batch_size=batch,
                                        **SMALL_KW),
            params, data, batch_size=batch)
        run = make_adaptive_evaluator(tmodel, T_SMALL, batch_size=batch,
                                      device="cpu", **SMALL_KW)
        got = evaluate_dataset_device(run, data)
        assert [len(a) for a in got] == [len(a) for a in want]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=0, atol=LOOP_TOL)
    assert run.canvas((64, 128)) == (70, 140)
    _, tchain = _chains(jmodel, params, tmodel)
    for (img, gt), dev in zip(scenes, got):
        _, host, _ = evaluate_sample(img, gt, tchain, max_iou_thr=0.95,
                                     pred_thr=0.49, max_clicks=5)
        assert len(host) == len(dev)
        np.testing.assert_allclose(dev, host, rtol=0, atol=HOST_TOL)



# -- the evaluate CLI ---------------------------------------------------------

def test_zoomin_params_match_the_root_cli():
    """``eval_ritm`` and ``eval_mode`` pick the ZoomIn as the root's
    ``get_zoomin_params`` does; ``eval_mode=cvpr`` alone is the fixed 448²
    crop (672² on DAVIS)."""
    from isegprobe_torch.evaluate import get_zoomin_params, parse_args
    from tests.test_torch_fixtures import _evaluate_cli

    class _EC(dict):
        def __getattr__(self, k):
            return self[k]

    root = _evaluate_cli().get_zoomin_params
    for ritm in (False, True):
        for mode in ("cvpr", "fixed448", "fixed400,336"):
            for name in ("Synthetic", "DAVIS"):
                assert get_zoomin_params(ritm, mode, name) == root(
                    _EC(eval_mode=mode, eval_ritm=ritm), name)
    cfg = parse_args(["checkpoint=x", "eval_ritm=true", "eval_mode=cvpr",
                      "device_loop=true", "device_batch=8",
                      "device_refill=true", "group_max_jobs=16"])
    assert cfg["zoomin"] == {"skip_clicks": 1, "target_size": 400}
    assert cfg["target_size"] == (400, 400) and cfg["device_refill"]
    assert cfg["group_max_jobs"] == 16 and cfg["eval_ritm"]
    assert parse_args(["checkpoint=x", "eval_mode=cvpr"])["zoomin"] == {
        "skip_clicks": -1, "target_size": (448, 448)}
    # the root's rule: continuous batching needs more than one lane
    assert not parse_args(["checkpoint=x", "device_refill=true"])[
        "device_refill"]
    for bad in ("host", "sometimes"):
        with pytest.raises(ValueError, match="device_refill"):
            parse_args(["checkpoint=x", f"device_refill={bad}"])
    with pytest.raises(NotImplementedError, match="eval_mode"):
        parse_args(["checkpoint=x", "eval_ritm=true", "eval_mode=big"])


@pytest.fixture
def ritm_checkpoint(tiny_arch, tmp_path):  # noqa: F811
    """An RITM-style probe checkpoint written by the JAX package (the RITM
    maps transform before a patch-7 click embedding, so the half-size maps
    give the backbone's grid, as tests/test_cli_end_to_end.py makes one),
    at the tiny arch, its weights PRNGKey(0)'s with the classifier bias
    set so that the drawn probe marks a fifth of the first scene's pixels
    positive for a first click; and the first two stored scenes (three
    objects)."""
    from isegprobe_tpu.utils.serialization import (
        model_config,
        save_checkpoint,
    )
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE
    from tests.test_torch_model import jax_model_and_params, tiny_config

    cfg = dict(tiny_config(112), use_rgb_conv=True,
               save_cfg=dict(embed_coords=True, backbone=False,
                             upsampler=False, head=True))
    cfg["embed_coords_cfg"]["params"]["patch_size"] = (7, 7)
    model, params = jax_model_and_params(cfg, 112, gamma=1e-5)
    with np.load(SYNTHETIC_FIXTURE) as fx:
        image = fx["images"][0].astype(np.float32) / 255
    x = np.concatenate([image, np.zeros((224, 224, 1), np.float32)], -1)
    pts = np.full((1, 8, 3), -1.0, np.float32)
    pts[0, 0] = (100, 100, 0)
    logits = np.asarray(model.apply({"params": params}, x[None],
                                    pts)["instances"])
    head = params["head"]["classifier"]
    head["bias"] = head["bias"] - np.quantile(logits, 0.8).astype(np.float32)
    ckpt = tmp_path / "ritm.ckpt"
    save_checkpoint(params, model_config(model), ckpt)
    with np.load(SYNTHETIC_FIXTURE) as fx:
        keep = fx["objects"][:, 0] < 2
        scenes = tmp_path / "scenes.npz"
        np.savez(scenes, images=fx["images"][:2], labels=fx["labels"][:2],
                 objects=fx["objects"][keep])
    return ckpt, scenes


@pytest.mark.parametrize("device_loop", [False, True])
def test_evaluate_ritm_cvpr_matches_root_cli(ritm_checkpoint, tmp_path,
                                             monkeypatch, capsys,
                                             device_loop):
    """``eval_ritm=true eval_mode=cvpr`` on three stored objects, 2 clicks:
    the port's host chain (``device_loop=false``) and its adaptive device
    loop (``device_loop=true``, and with ``device_refill=true
    device_batch=3``) print the root CLI's NoC columns and mIoU@k, the root
    running the same mode (its device loop at 3 lanes)."""
    from isegprobe_torch.evaluate import main
    from tests.test_torch_training import _root_evaluate, _table_numbers

    ckpt, scenes = ritm_checkpoint
    common = ["eval_mode=cvpr", "eval_ritm=true", "n_clicks=2",
              f"device_loop={str(device_loop).lower()}"]
    root_args = common + (["device_batch=3"] if device_loop else [])
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", f"checkpoint={ckpt}",
                                      "datasets=Synthetic:2",
                                      f"logs_path={tmp_path}", *root_args])
    _root_evaluate().main()
    root = capsys.readouterr().out
    root_miou = [line for line in root.splitlines()
                 if line.startswith("mIoU@k")]
    assert root_miou
    runs = [common] + ([common + ["device_batch=3", "device_refill=true",
                                  "group_max_jobs=2"]] if device_loop
                       else [])
    for args in runs:
        assert main([f"checkpoint={ckpt}", "datasets=Synthetic",
                     f"scenes={scenes}", "device=cpu", *args]) == 0
        port = capsys.readouterr().out
        assert _table_numbers(port) == _table_numbers(root)
        assert [line for line in port.splitlines()
                if line.startswith("mIoU@k")] == root_miou
        if "device_refill=true" in args:
            assert "group-eval stats:" in port



# -- the trained flagship's adaptive fixture ----------------------------------

@pytest.fixture(scope="module")
def ritm_results():
    with np.load(RITM_FIXTURE) as data:
        return dict(data)


def test_ritm_fixture_is_consistent(ritm_results):
    """Every stored object, NoC, over-budget counts and mIoU@k recomputed
    from the stored IoUs; clicks present exactly up to each object's count,
    the first positive and inside its object."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE
    from isegprobe_torch.inference.metrics import compute_noc_metric, miou_at_k

    fx = ritm_results
    with np.load(SYNTHETIC_FIXTURE) as scenes:
        labels, objects = scenes["labels"], scenes["objects"]
    k = int(fx["ritm_objects"])
    assert k == len(objects) == len(fx["ritm_n"]) == 78
    for i, n in enumerate(fx["ritm_n"]):
        assert 1 <= n <= N_CLICKS
        clicks = fx["ritm_clicks"][i]
        assert (clicks[:n] >= 0).all() and (clicks[n:] == -1).all()
        assert (fx["ritm_ious"][i, n:] == 0).all()
        scene, label = objects[i]
        y, x, pos = clicks[0]
        assert pos == 1 and labels[scene, y, x] == label
        # an early stop is at the target
        assert n == N_CLICKS or fx["ritm_ious"][i, n - 1] >= 0.9
    per_object = [fx["ritm_ious"][i, :n] for i, n in enumerate(fx["ritm_n"])]
    noc, _, over_max = compute_noc_metric(per_object, [0.8, 0.85, 0.9],
                                          N_CLICKS)
    np.testing.assert_array_equal(fx["ritm_noc"], noc)
    np.testing.assert_array_equal(fx["ritm_over_max"], over_max)
    np.testing.assert_array_equal(fx["ritm_miou"],
                                  miou_at_k(per_object, N_CLICKS))
    assert noc[2] < 10  # the trained probe segments under this protocol too
    for i, n in enumerate(fx["ritm_host_n"]):
        assert 1 <= n <= N_CLICKS and len(fx["ritm_host_n"]) == HOST_OBJECTS
        assert (fx["ritm_host_clicks"][i, :n] >= 0).all()
        assert (fx["ritm_host_clicks"][i, n:] == -1).all()
        assert (fx["ritm_host_ious"][i, n:] == 0).all()
        assert n == N_CLICKS or fx["ritm_host_ious"][i, n - 1] >= 0.9


# the first objects whose host trajectories are short (2-3 clicks)
SHORT_HOST_OBJECTS = (0, 2, 3)


def test_trained_host_chain_matches_the_fixture(ritm_results):
    """The port's transform chain on the trained flagship (CPU, full
    width) against the JAX chain's results stored in the fixture, on the
    first objects with short trajectories: the same clicks, IoUs within
    LOOP_TOL. (JAX's chain and JAX's device loop part by up to 0.0201 on
    the fixture's first 8 objects: the chain averages the flip's
    probabilities, the loop its logits.)"""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference.evaluation import evaluate_sample
    from isegprobe_torch.inference.brs import get_predictor

    fx = ritm_results
    model, _ = load_model_for_eval(str(FLAGSHIP_CKPT), device="cpu",
                                   eval_ritm=True)
    chain = get_predictor(
        model, zoom_in_params={"skip_clicks": 1, "target_size": RITM_TARGET},
        predictor_params={"net_clicks_limit": N_CLICKS}, device="cpu")
    data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, HOST_OBJECTS))
    for i in SHORT_HOST_OBJECTS:
        sample = data.get_sample(i)
        cl, ious, _ = evaluate_sample(
            sample.image, sample.gt_mask(0), chain,
            max_iou_thr=RITM_PROTOCOL["target_iou"],
            pred_thr=RITM_PROTOCOL["pred_thr"], max_clicks=N_CLICKS)
        n = int(fx["ritm_host_n"][i])
        assert len(ious) == n <= 3
        np.testing.assert_array_equal(
            [(*c.coords, int(c.is_positive)) for c in cl],
            fx["ritm_host_clicks"][i, :n])
        np.testing.assert_allclose(ious, fx["ritm_host_ious"][i, :n],
                                   rtol=0, atol=LOOP_TOL)


@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="reruns the JAX adaptive evaluator and the port's "
                           "full-width loop (RUN_SLOW=1)")
def test_flagship_adaptive_reproduces_the_fixture(ritm_results):
    """A fresh JAX run of the first 2 objects (as one chunk of the export,
    at B=2) equals the stored results exactly; the port's f32 adaptive loop
    on the CPU, loaded as ``eval_ritm`` loads it, clicks as they do with
    IoUs within LOOP_TOL."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE, SceneDataset
    from isegprobe_torch.evaluate import load_model_for_eval
    from isegprobe_torch.inference.adaptive_eval import make_adaptive_runner
    from isegprobe_torch.inference.device_eval import evaluate_dataset_device

    fx = ritm_results
    data = SceneDataset(SYNTHETIC_FIXTURE, objects=slice(0, 2))
    model, params = jax_ritm_model()
    ious, n, clicks = jax_ritm_run(model, params, data, 2)
    np.testing.assert_array_equal(n, fx["ritm_n"][:2])
    np.testing.assert_array_equal(clicks, fx["ritm_clicks"][:2])
    np.testing.assert_array_equal(ious, fx["ritm_ious"][:2])

    tmodel, _ = load_model_for_eval(str(FLAGSHIP_CKPT), device="cpu",
                                    eval_ritm=True)
    run = make_adaptive_runner(tmodel, RITM_TARGET, batch_size=2,
                               record_clicks=True, device="cpu",
                               **RITM_PROTOCOL)
    got_clicks: list = []
    got = evaluate_dataset_device(run, data, clicks=got_clicks)
    assert [len(a) for a in got] == list(fx["ritm_n"][:2])
    for i, (a, c) in enumerate(zip(got, got_clicks)):
        np.testing.assert_allclose(a, fx["ritm_ious"][i, :len(a)], rtol=0,
                                   atol=LOOP_TOL)
        np.testing.assert_array_equal(c, fx["ritm_clicks"][i, :len(a)])


if __name__ == "__main__":
    if sys.argv[1:] not in (["--export"], ["--export-host"]):
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_adaptive.py"
                 " --export | --export-host")
    if sys.argv[1] == "--export":
        export()
    export_host()
