"""The port's training slice against the JAX package: losses, metrics, the
optimizer and schedule, the on-card click rule, the train step, the epoch
loop, checkpoints, the command lines, and the train-step fixture.

Each test takes the same numpy inputs through the JAX function and its
counterpart in ``isegprobe_torch``. Tolerances:
- losses and their gradients, ``device_iou_stats``: 1e-5 relative (+1e-7
  absolute): f32 reductions in other orders;
- Adam, AdamW and SGD against optax on the same gradients: 3e-7 absolute
  on parameters of scale 1, a few f32 ulps (the two divide by the bias
  corrections in other orders);
- the train step at a 2-block, 96-wide arch from the same params and batch:
  loss within 1e-5 relative, trainable gradients within 1e-4 of each
  leaf's largest gradient, parameters after three Adam steps within 5e-7
  absolute (lr 5e-5: an update differs only where a gradient element is
  near zero against its own rounding noise), frozen parameters bitwise
  unchanged.

The fixture ``isegprobe_torch/fixtures/synthetic_train_step.npz`` carries
to the GPU machine (no JAX there) one batch of JAX training items and the
JAX full-width train step's numbers. Write it with
``JAX_PLATFORMS=cpu python tests/test_torch_training.py --export`` (on an
8-core CPU host about a minute); the tests hold it against a fresh JAX
export of its first item, and the port's CPU step against its numbers.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import os
import sys
import time
import types
import zlib
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
STEP_FIXTURE = (REPO / "isegprobe_torch" / "fixtures"
                / "synthetic_train_step.npz")
FLAGSHIP = REPO / "assets" / "trained" / "synthetic_dinov2_noup_160ep.ckpt"
TINY = "dinov2_tiny_train_test"
WIDTH, SIZE, BATCH, N_POINTS = 96, 56, 8, 4
LR = 5e-5
FIXTURE_POSITIONS = 8
# the full-width step from init_tree(config, 0) against the fixture's JAX
# numbers (chip_smoke.py holds the card to the same). Measured on the CPU:
# losses within 1e-6 relative, sums and norms within 2.2e-5 of a leaf's
# norm, first values within 3e-9. An element whose gradient is rounding
# noise may take Adam's update of the other sign (two steps: up to ~4.4 lr
# = 2.2e-4), so sums and norms get STEP_FLIPS such elements on top.
STEP_LOSS_RTOL = 1e-5
DIGEST_ATOL = 2.5e-4  # first values
DIGEST_RTOL = 1e-4    # sums and norms, relative to the leaf's norm
STEP_FLIPS = 10


# -- the JAX side -------------------------------------------------------------

def jax_cfg(**training_params):
    from isegprobe_tpu.utils.config import EDict

    tp = dict(crop_size=[224, 224], num_max_points=24, lr_milestones=[17, 20],
              checkpoint_interval=[[0, 3], [15, 1]], epochs=20)
    tp.update(training_params)
    return EDict.convert(dict(
        dataloader=dict(batch_size=8, val_batch_size=8, workers=2, mp=False),
        training_params=tp, training=dict(seed=0, start_epoch=0,
                                          weights=None),
        CHECKPOINTS_PATH="/nonexistent"))


def jax_synthetic_datasets(cfg):
    from models.defaults import get_synthetic_train_val_datasets

    return get_synthetic_train_val_datasets(cfg)


def jax_items(trainset, positions, seed=0, salt="train", epoch=0):
    """The JAX loader's process-mode items (``_process_worker_get``)."""
    from isegprobe_tpu.data import loader as jl

    jl._process_worker_init(trainset, seed, zlib.crc32(salt.encode()))
    return [jl._process_worker_get(epoch, p, p) for p in positions]


def _dinov2_noup():
    spec = importlib.util.spec_from_file_location(
        "isegprobe_models_synthetic_dinov2_noup",
        REPO / "models" / "synthetic" / "dinov2_noup.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def jax_flagship_trainer(cfg, trainset, valset):
    """The JAX trainer of ``models/synthetic/dinov2_noup.py`` as
    ``models/common.py:train`` builds it, on one device."""
    from isegprobe_tpu.parallel.mesh import make_mesh
    from isegprobe_tpu.training.metrics import AdaptiveIoU
    from isegprobe_tpu.training.trainer import iSegTrainer
    from models.common import init_model_from_modules_cfg
    from models.defaults import get_loss_cfg, get_optimizer_cfg

    model = init_model_from_modules_cfg(
        _dinov2_noup().define_modules_cfg(cfg), cfg)
    name, opt = get_optimizer_cfg(cfg)
    return iSegTrainer(
        model, cfg, get_loss_cfg(cfg), trainset, valset, optimizer=name,
        optimizer_params=opt,
        lr_scheduler={"milestones": cfg.training_params.lr_milestones,
                      "gamma": 0.1},
        metrics=[AdaptiveIoU()], max_interactive_points=24,
        max_num_next_clicks=3, seed=0, mesh=make_mesh(n_devices=1))


def digest(tree, prefix=""):
    """Per leaf of a flax-named param tree: sum, L2 norm and the first 16
    values (C order; NaN past a smaller leaf's end), float64."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(digest(v, f"{prefix}{k}/"))
        else:
            a = np.asarray(v, np.float64).ravel()
            first = np.full(16, np.nan)
            first[:min(16, a.size)] = a[:16]
            out[prefix + k] = np.concatenate(
                [[a.sum(), np.sqrt((a * a).sum())], first])
    return out


def export(path=STEP_FIXTURE):
    """One batch of JAX training items and JAX's full-width train step:
    the loss at num_iters=0 from ``model.init(PRNGKey(0))``, and the
    trainable leaves' digests after two Adam steps on that batch."""
    import jax

    cfg = jax_cfg()
    trainset, valset = jax_synthetic_datasets(cfg)
    positions = list(range(FIXTURE_POSITIONS))
    items = jax_items(trainset, positions)
    from isegprobe_tpu.data.loader import _stack

    batch = _stack(items)
    seeds = [int(np.random.SeedSequence([0, zlib.crc32(b"train"), 0, p])
                 .generate_state(1)[0]) for p in positions]
    trainer = jax_flagship_trainer(cfg, trainset, valset)
    rng = jax.random.PRNGKey(1)
    losses = []
    t0 = time.time()
    for _ in range(2):
        (trainer.params, trainer.opt_state, loss, _, _, _) = \
            trainer._train_step(trainer.params, trainer.opt_state,
                                trainer._prep_batch(batch), rng, 0, 0.4,
                                0.025, click_trees=())
        losses.append(float(loss))
    print(f"two JAX steps in {time.time() - t0:.1f} s, losses {losses}")
    dig = digest(jax.device_get(trainer.params["trainable"]))
    out = dict(images=batch["images"], points=batch["points"],
               instances=batch["instances"], seeds=np.asarray(seeds,
                                                              np.uint32),
               positions=np.asarray(positions), losses=np.asarray(losses),
               digest_names=np.asarray(sorted(dig)),
               digests=np.stack([dig[k] for k in sorted(dig)]))
    np.savez_compressed(path, **out)
    print(f"wrote {path} ({path.stat().st_size} bytes)")


# -- fixtures ------------------------------------------------------------------

@pytest.fixture
def tiny_arch(monkeypatch):
    """A 2-block, width-96, 2-head DINOv2 entry in both packages."""
    from isegprobe_torch.models.featurizers import dinov2 as t_dinov2
    from isegprobe_tpu.models.featurizers import dinov2 as j_dinov2

    for mod in (j_dinov2, t_dinov2):
        monkeypatch.setitem(mod.DINOV2_ARCHS, TINY, dataclasses.replace(
            mod.DINOV2_ARCHS["dinov2_vits14"], embed_dim=WIDTH, depth=2,
            num_heads=2))
    return TINY


def tiny_config():
    return dict(
        backbone_cfg=dict(type="dinov2", params=dict(
            arch=TINY, feats_injection_mode="before_backbone")),
        head_cfg=dict(type="convhead", params=dict(
            in_channels=WIDTH, num_layers=2, num_classes=1)),
        embed_coords_cfg=dict(type="patchEmbed", params=dict(
            img_size=[SIZE, SIZE], patch_size=(14, 14), embed_dim=WIDTH)),
        upsampler_cfg=dict(type="identity", params=dict()),
        save_cfg=dict(embed_coords=True, backbone=False, upsampler=False,
                      head=True),
        use_disks=True, norm_radius=5, with_prev_mask=True)


class ListDataset:
    """Fixed items (the trainers only read ``[0]`` and the length here)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def get_item(self, i, seed):
        return self.items[i]

    def get_samples_number(self):
        return len(self.items)


def tiny_batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), dtype=np.uint8)
    inst = np.zeros((BATCH, SIZE, SIZE, 1), np.int8)
    points = np.full((BATCH, 2 * N_POINTS, 3), -1.0, np.float32)
    for b in range(BATCH):
        y0, x0 = rng.integers(4, 24, 2)
        hh, ww = rng.integers(10, 28, 2)
        inst[b, y0:y0 + hh, x0:x0 + ww] = 1
        inst[b, :2, :] = -1  # an ignore band
        points[b, 0] = [y0 + hh // 2, x0 + ww // 2, 100]
        images[b, y0:y0 + hh, x0:x0 + ww] //= 3
    return {"images": images, "points": points, "instances": inst}


def _items(batch):
    return [{k: v[i] for k, v in batch.items()} for i in range(BATCH)]


def _ns_cfg(tmp_path):
    return types.SimpleNamespace(
        dataloader=types.SimpleNamespace(batch_size=BATCH,
                                         val_batch_size=BATCH, workers=0),
        training=types.SimpleNamespace(start_epoch=0, weights=None),
        CHECKPOINTS_PATH=str(tmp_path / "ckpts"), LOGS_PATH=None)


def _numpy_tree(tree):
    return {k: _numpy_tree(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


@pytest.fixture
def tiny_pair(tiny_arch, tmp_path):
    """A JAX trainer and a port trainer of the tiny probe, from the same
    params (JAX's ``model.init(PRNGKey(0))``) and loss."""
    import jax
    import torch

    from isegprobe_torch.models.probe_model import iSegProbeModel as TModel
    from isegprobe_torch.training.losses import \
        NormalizedFocalLossSigmoid as TNFL
    from isegprobe_torch.training.trainer import iSegTrainer as TTrainer
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from isegprobe_tpu.parallel.mesh import make_mesh
    from isegprobe_tpu.training.losses import \
        NormalizedFocalLossSigmoid as JNFL
    from isegprobe_tpu.training.trainer import iSegTrainer as JTrainer

    torch.set_num_threads(4)
    items = _items(tiny_batch())
    opt = {"lr": LR, "betas": (0.9, 0.999), "eps": 1e-8}
    jtr = JTrainer(JModel(**tiny_config(), attn_impl="jnp"), _ns_cfg(tmp_path),
                   {"instance_loss": JNFL(alpha=0.5, gamma=2),
                    "instance_loss_weight": 1.0},
                   ListDataset(items), ListDataset(items), optimizer="adam",
                   optimizer_params=dict(opt), max_num_next_clicks=2, seed=0,
                   mesh=make_mesh(n_devices=1))
    p = jax.device_get(jtr.params)
    params = _numpy_tree({**p["trainable"], **p["frozen"]})
    ttr = TTrainer(TModel(**tiny_config(), device="cpu"), _ns_cfg(tmp_path),
                   {"instance_loss": TNFL(alpha=0.5, gamma=2),
                    "instance_loss_weight": 1.0},
                   ListDataset(items), ListDataset(items), optimizer="adam",
                   optimizer_params=dict(opt), max_num_next_clicks=2, seed=0,
                   params=params, device="cpu")
    return jtr, ttr, params


# -- losses and metrics --------------------------------------------------------

def _pred_label(seed=0, shape=(3, 12, 10, 1)):
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal(shape).astype(np.float32) * 3
    label = (rng.random(shape) > 0.6).astype(np.float32)
    label[0, :2] = -1  # ignore label
    label[2] = 0       # an empty mask
    return pred, label


@pytest.mark.parametrize("name,kwargs", [
    ("NormalizedFocalLossSigmoid", dict(alpha=0.5, gamma=2)),
    ("NormalizedFocalLossSigmoid", dict(max_mult=2.0, size_average=False)),
    ("FocalLoss", dict(alpha=0.5, gamma=2)),
    ("FocalLoss", dict(from_logits=True, size_average=False)),
    ("SoftIoU", {}),
    ("SigmoidBinaryCrossEntropyLoss", {}),
    ("SigmoidBinaryCrossEntropyLoss", dict(from_sigmoid=True)),
])
def test_losses_and_grads_match_jax(name, kwargs):
    import jax
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.training import losses as tl
    from isegprobe_tpu.training import losses as jlo

    pred, label = _pred_label()
    if kwargs.get("from_sigmoid") or kwargs.get("from_logits"):
        pred = 1 / (1 + np.exp(-pred))
    jfn, tfn = jlo.LOSS_REGISTRY[name](**kwargs), tl.LOSS_REGISTRY[name](
        **kwargs)

    def jtotal(p):
        loss, aux = jfn(p, jnp.asarray(label))
        return jnp.sum(loss), (loss, aux)

    (_, (jloss, jaux)), jgrad = jax.value_and_grad(jtotal, has_aux=True)(
        jnp.asarray(pred))
    tp = torch.from_numpy(pred).requires_grad_(True)
    tloss, taux = tfn(tp, torch.from_numpy(label))
    tloss.sum().backward()
    np.testing.assert_allclose(tloss.detach().numpy(), jloss, rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(tp.grad.numpy(), jgrad, rtol=1e-5, atol=1e-7)
    assert sorted(taux) == sorted(jaux)
    for k in taux:
        np.testing.assert_allclose(float(taux[k].detach()), float(jaux[k]),
                                   rtol=1e-5)


def test_dice_loss_matches_jax():
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.training.losses import BinaryDiceLoss as T
    from isegprobe_tpu.training.losses import BinaryDiceLoss as J

    rng = np.random.default_rng(1)
    pred = rng.standard_normal((3, 8, 8, 2)).astype(np.float32)
    label = (rng.random((3, 8, 8)) > 0.5).astype(np.float32)
    got = T()(torch.from_numpy(pred), torch.from_numpy(label))[0]
    want = J()(jnp.asarray(pred), jnp.asarray(label))[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("thresh", [0.4, 0.55])
def test_device_iou_stats_and_adaptive_iou_match_jax(thresh):
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.training.metrics import AdaptiveIoU as TA
    from isegprobe_torch.training.metrics import compute_iou as tci
    from isegprobe_torch.training.metrics import device_iou_stats as tds
    from isegprobe_tpu.training.metrics import AdaptiveIoU as JA
    from isegprobe_tpu.training.metrics import compute_iou as jci
    from isegprobe_tpu.training.metrics import device_iou_stats as jds

    pred, label = _pred_label(2)
    got, gvalid = tds(torch.from_numpy(pred), torch.from_numpy(label),
                      thresh, 0.025)
    want, wvalid = jds(jnp.asarray(pred), jnp.asarray(label), thresh, 0.025)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    assert bool(gvalid) == bool(wvalid)
    empty = np.zeros_like(label)
    assert not bool(tds(torch.from_numpy(pred), torch.from_numpy(empty),
                        thresh, 0.025)[1])
    ta, ja = TA(init_thresh=thresh), JA(init_thresh=thresh)
    rng = np.random.default_rng(3)
    for _ in range(20):
        trip = rng.random(3)
        ta.update_from_stats(trip, True)
        ja.update_from_stats(trip, True)
        ta.update_from_stats(trip, False)
        ja.update_from_stats(trip, False)
    ta.update(pred, label)
    ja.update(pred, label)
    assert ta.iou_thresh == ja.iou_thresh and ta.ema_iou == ja._ema_iou
    assert ta.get_epoch_value() == ja.get_epoch_value()
    p, g = pred > 0, label > 0.5
    for keep in (False, True):
        np.testing.assert_array_equal(tci(p, g, label == -1, keep),
                                      jci(p, g, label == -1, keep))


def test_adam_matches_optax_and_schedule():
    """Three Adam steps (and AdamW, SGD) on the same gradients, and the
    multistep schedule against optax's piecewise-constant one."""
    import jax.numpy as jnp
    import optax
    import torch

    from isegprobe_torch.training.optim import (
        make_layerwise_decay_optimizer,
        make_optimizer,
        multistep_lr,
    )
    from isegprobe_tpu.training.optim import multistep_lr as jmultistep

    rng = np.random.default_rng(0)
    w0 = rng.standard_normal((5, 7)).astype(np.float32)
    grads = [rng.standard_normal((5, 7)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    for name, tx, kw in (
            ("adam", optax.adam(1e-2, b1=0.9, b2=0.999, eps=1e-8), {}),
            ("adamw", optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8,
                                  weight_decay=0.1), {"weight_decay": 0.1}),
            ("sgd", optax.sgd(1e-2, momentum=0.9), {})):
        p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
        opt = make_optimizer(name, [p], 1e-2, **kw)
        jp, state = jnp.asarray(w0), tx.init(jnp.asarray(w0))
        for g in grads:
            p.grad = torch.from_numpy(g)
            opt.step()
            upd, state = tx.update(jnp.asarray(g), state, jp)
            jp = optax.apply_updates(jp, upd)
        np.testing.assert_allclose(p.detach().numpy(), jp, rtol=0, atol=3e-7)
    # layer-wise decay leaves a parameter outside the backbone unscaled
    lw = make_layerwise_decay_optimizer("adam", [("head.w", p)], 1e-2,
                                        num_layers=12)
    assert [(g["lr_scale"], g["lr"]) for g in lw.param_groups] == [
        (1.0, 1e-2)]
    with pytest.raises(ValueError):
        make_optimizer("lamb", [p], 1e-2)
    lr, jlr = multistep_lr(5e-5, [17, 20], 0.1, 40), jmultistep(
        5e-5, [17, 20], 0.1, 40)
    for step in (0, 1, 679, 680, 681, 799, 800, 801, 5000):
        np.testing.assert_allclose(lr(step), float(jlr(step)), rtol=1e-6)


# -- the click rule --------------------------------------------------------------

def _jax_inner(prob, gt):
    """JAX's click rule pieces: the sign and inner region."""
    import jax.numpy as jnp

    from isegprobe_tpu.ops.edt import edt_l2sq_device

    pred = prob[..., 0]
    gtm = gt[..., 0] > 0.5
    fn = gtm & (pred < 0.49)
    fp = ~gtm & (pred > 0.49)
    d2 = np.asarray(edt_l2sq_device(jnp.stack([fn, fp], axis=1),
                                    pad_border=True))
    fn_max, fp_max = d2[:, 0].max((1, 2)), d2[:, 1].max((1, 2))
    pos = fn_max > fp_max
    dt = np.where(pos[:, None, None], d2[:, 0], d2[:, 1])
    return pos, dt > (np.maximum(fn_max, fp_max) / 4)[:, None, None]


def test_get_next_points_device_matches_jax():
    """The sign, the row written and the inner region are JAX's; every
    draw lies in the region; where the region is one pixel the click is
    JAX's; a sample with no error keeps its points."""
    import jax
    import jax.numpy as jnp
    import torch

    from isegprobe_torch.training.trainer import get_next_points_device as t
    from isegprobe_tpu.training.trainer import get_next_points_device as j

    rng = np.random.default_rng(0)
    b, h, w, n = 6, 40, 48, 5
    gt = np.zeros((b, h, w, 1), np.float32)
    prob = np.zeros((b, h, w, 1), np.float32)
    for i in range(b):
        y, x = rng.integers(2, 20, 2)
        gt[i, y:y + 15, x:x + 18] = 1
        prob[i, y + 3:y + 12, x:x + 25] = 0.9  # both FN and FP regions
    gt[4] = 0
    gt[4, 10:13, 10:13] = 1          # a 3x3 FN: its inner region is a pixel
    prob[4] = 0
    prob[5] = gt[5]                   # no error at all
    points = rng.uniform(0, 30, (b, 2 * n, 3)).astype(np.float32)
    pos, inner = _jax_inner(prob, gt)
    for click in (1, 2, 3):
        want = np.asarray(j(jnp.asarray(prob), jnp.asarray(gt),
                            jnp.asarray(points), jnp.asarray(click),
                            jax.random.PRNGKey(click)))
        for seed in range(3):
            gen = torch.Generator().manual_seed(seed)
            got = t(torch.from_numpy(prob), torch.from_numpy(gt),
                    torch.from_numpy(points), click, gen).numpy()
            for i in range(b):
                changed = np.nonzero((got[i] != points[i]).any(1))[0]
                jchanged = np.nonzero((want[i] != points[i]).any(1))[0]
                np.testing.assert_array_equal(changed, jchanged)
                if i == 5:
                    assert len(changed) == 0
                    continue
                row = n - click if pos[i] else 2 * n - click
                assert list(changed) == [row]
                y, x, k = got[i, row]
                assert k == click and inner[i, int(y), int(x)]
                if i == 4:
                    np.testing.assert_array_equal(got[i], want[i])


# -- the train step ----------------------------------------------------------------

def test_train_step_matches_jax(tiny_pair):
    """Three steps at num_iters=0 on one batch: the loss, the trainable
    gradients of the first step and the params after each step against
    the JAX trainer's ``_train_step``; the frozen params stay bitwise."""
    import jax
    import torch

    from isegprobe_torch.models.convert import state_dict_to_jax_params

    jtr, ttr, params = tiny_pair
    batch = tiny_batch()
    jbatch = jtr._prep_batch(batch)
    tbatch = ttr._upload(batch)
    frozen0 = {k: v.clone() for k, v in ttr.model.state_dict().items()
               if k.startswith(("backbone", "upsampler"))}

    # JAX's gradient through the trainer's own forward and loss
    import jax.numpy as jnp

    images = jnp.asarray(batch["images"], jnp.float32) / 255.0
    inst = jnp.asarray(batch["instances"], jnp.float32)
    prev = jnp.zeros((*images.shape[:3], 1), jnp.float32)
    frozen = jtr.params["frozen"]

    def loss_fn(trainable):
        out = jtr._forward({**trainable, **frozen}, images, prev,
                           jnp.asarray(batch["points"]))
        return jtr._loss(out, {"instances": inst})[0]

    jgrads = jax.grad(loss_fn)(jtr.params["trainable"])
    rng = jax.random.PRNGKey(0)
    for step in range(3):
        (jtr.params, jtr.opt_state, jloss, _, _, _) = jtr._train_step(
            jtr.params, jtr.opt_state, jbatch, rng, 0, 0.4, 0.025,
            click_trees=())
        tloss, _, _ = ttr._step(tbatch, 0)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        if step == 0:
            tgrads = {n: p.grad for n, p in ttr.model.named_parameters()
                      if p.grad is not None}
            assert sorted({n.split(".")[0] for n in tgrads}) == [
                "embed_coords", "head"]
            tg = state_dict_to_jax_params(tgrads, {
                k: params[k] for k in ("embed_coords", "head")})
            for top in tg:
                for a, b in zip(jax.tree.leaves(tg[top]),
                                jax.tree.leaves(jax.device_get(
                                    jgrads[top]))):
                    np.testing.assert_allclose(
                        a, b, rtol=0, atol=1e-4 * np.abs(b).max())
        got = ttr.full_params(("embed_coords", "head"))
        want = jax.device_get(jtr.params["trainable"])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=5e-7)
    for k, v in ttr.model.state_dict().items():
        if k in frozen0:
            assert torch.equal(v, frozen0[k]), k


def test_train_step_with_click_simulation(tiny_pair):
    """num_iters = 2: the simulated clicks land in the two rows the rule
    writes (counted backwards) or leave the points alone, and the step
    still trains only the trainable params."""
    import torch

    _, ttr, _ = tiny_pair
    batch = ttr._upload(tiny_batch(1))
    seen = []
    orig = ttr._forward

    def spy(images, prev, points):
        seen.append(points.clone())
        return orig(images, prev, points)

    ttr._forward = spy
    loss, logging_out, (iou, valid) = ttr._step(batch, 2)
    assert torch.isfinite(loss) and iou.shape == (3,) and bool(valid)
    assert sorted(logging_out) == ["instance_loss", "nfl_k", "nfl_m_max",
                                   "overall"]
    assert len(seen) == 3
    changed = (seen[-1] != batch["points"]).any(-1)
    rows = {N_POINTS - 1, N_POINTS - 2, 2 * N_POINTS - 1, 2 * N_POINTS - 2}
    assert set(torch.nonzero(changed)[:, 1].tolist()) <= rows


def test_epoch_updates_trainable_only_and_checkpoints(tiny_pair, tmp_path):
    """A tiny epoch with validation changes only the trainable leaves
    (``tests/test_trainer.py``), and writes a checkpoint that the JAX
    package's ``load_checkpoint`` + ``build_model`` read and that gives the
    port's logits; the port's reader reads it back bitwise."""
    import jax
    import torch

    from isegprobe_torch.utils.serialization import \
        load_checkpoint as tload
    from isegprobe_torch.training.metrics import AdaptiveIoU
    from isegprobe_tpu.utils.serialization import build_model, \
        load_checkpoint, merge_params

    _, ttr, params = tiny_pair
    ttr.train_metrics = [AdaptiveIoU()]
    ttr.val_metrics = [AdaptiveIoU()]
    before = {k: v.clone() for k, v in ttr.model.state_dict().items()}
    ttr.run(num_epochs=1, validation=True)
    assert len(ttr.stats["num_iters"]) == 1 and ttr.stats["loss"]
    for k, v in ttr.model.state_dict().items():
        same = torch.equal(v, before[k])
        assert same == k.startswith(("backbone", "upsampler")), k
    assert ttr.train_metrics[0].get_epoch_value() >= 0
    path = tmp_path / "ckpts" / "last_checkpoint.ckpt"
    jparams, config, extra = load_checkpoint(path)
    assert sorted(jparams) == ["embed_coords", "head"] and extra == {
        "epoch": 0}
    tparams, tconfig, _ = tload(path)
    for a, b in zip(jax.tree.leaves(tparams), jax.tree.leaves(jparams)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert tparams.keys() == jparams.keys() and tconfig == config
    own = ttr.full_params(("embed_coords", "head"))
    for a, b in zip(jax.tree.leaves(own), jax.tree.leaves(tparams)):
        assert np.array_equal(a, b)
    jmodel = build_model(config, attn_impl="jnp")
    full = merge_params(params, jparams)
    image = np.random.default_rng(5).random((2, SIZE, SIZE, 4),
                                            dtype=np.float32)
    pts = tiny_batch()["points"][:2]
    want = np.asarray(jmodel.apply({"params": full}, image, pts)[
        "instances"])
    with torch.no_grad():
        got = ttr.model(torch.from_numpy(image), torch.from_numpy(pts))[
            "instances"].numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_constants_made_in_inference_mode_serve_training(tiny_arch):
    """The port caches per-device constants (resize and pooling matrices,
    normalization constants) at first use; made under an evaluation's
    ``inference_mode``, they must still serve a later training forward."""
    import torch

    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.ops.pool import adaptive_pool

    model = iSegProbeModel(**tiny_config(), device="cpu")
    image = torch.rand(2, 42, 42, 4)
    pts = torch.from_numpy(tiny_batch()["points"][:2])
    with torch.inference_mode():
        model(image, pts)
        adaptive_pool(torch.rand(1, 9, 9, 2), (4, 4), "avg")
        adaptive_pool(torch.rand(1, 9, 9, 2), (4, 4), "max")
    model(image, pts)["instances"].sum().backward()
    x = torch.rand(1, 9, 9, 2, requires_grad=True)
    (adaptive_pool(x, (4, 4), "avg").sum()
     + adaptive_pool(x, (4, 4), "max").sum()).backward()
    assert model.head.classifier.weight.grad is not None
    assert x.grad is not None


def test_split_params_and_unported_options(tiny_arch, tmp_path):
    import torch

    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.training.trainer import iSegTrainer, split_params

    model = iSegProbeModel(**tiny_config(), device="cpu")
    trainable, frozen = split_params(model)
    assert all(p.requires_grad for p in trainable)
    assert not any(p.requires_grad for p in frozen)
    assert sum(p.numel() for p in trainable) + sum(
        p.numel() for p in frozen) == sum(p.numel() for p in
                                          model.parameters())
    items = ListDataset(_items(tiny_batch()))
    cfg = _ns_cfg(tmp_path)
    with pytest.raises(KeyError, match="click model"):
        iSegTrainer(model, cfg, {}, items, items, device="cpu",
                    click_models=[{"head": {"nonexistent": {
                        "kernel": np.zeros((1, 1))}}}])
    cfg.training.weights = str(tmp_path / "x.ckpt")
    with pytest.raises(FileNotFoundError):
        iSegTrainer(model, cfg, {}, items, items, device="cpu")
    cfg = _ns_cfg(tmp_path)
    cfg.dataloader.mp = True
    trainer = iSegTrainer(model, cfg, {}, items, items, device="cpu")
    assert trainer.train_data.use_processes and trainer.val_data.use_processes
    trainer.shutdown()
    with pytest.raises(ValueError, match="float32 master weights"):
        iSegTrainer(model.to(torch.bfloat16), _ns_cfg(tmp_path), {}, items,
                    items, device="cpu")


# -- command lines -------------------------------------------------------------------

def _root_evaluate():
    spec = importlib.util.spec_from_file_location(
        "isegprobe_evaluate_cli_training", REPO / "evaluate.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _table_numbers(text):
    """NoC@80/85/90 and the over-budget counts of a results table."""
    row = [line for line in text.splitlines() if "NoBRS" in line][0]
    return [c.strip() for c in row.split("|")[3:8]]


def test_evaluate_cli_matches_root_cli_defaults(tmp_path, monkeypatch,
                                                capsys):
    """With ``print_ious``, ``min_n_clicks``, ``thresh`` and
    ``clicks_limit`` at their defaults, the port's command line runs every
    click (the root's 1.01 rule) and prints the root's NoC columns and
    mIoU@k, on the first 2 Synthetic scenes at a 112² crop, 4 clicks."""
    from isegprobe_torch.data.scenes import SYNTHETIC_FIXTURE
    from isegprobe_torch.evaluate import main

    with np.load(SYNTHETIC_FIXTURE) as fx:
        keep = fx["objects"][:, 0] < 2
        scenes = tmp_path / "scenes.npz"
        np.savez(scenes, images=fx["images"][:2], labels=fx["labels"][:2],
                 objects=fx["objects"][keep])
    common = ["eval_mode=fixed112", "n_clicks=4"]
    monkeypatch.chdir(REPO)
    monkeypatch.setattr(sys, "argv", ["evaluate.py", f"checkpoint={FLAGSHIP}",
                                      "datasets=Synthetic:2",
                                      f"logs_path={tmp_path}", *common])
    _root_evaluate().main()
    root = capsys.readouterr().out
    assert main([f"checkpoint={FLAGSHIP}", "datasets=Synthetic",
                 f"scenes={scenes}", "device=cpu", *common]) == 0
    port = capsys.readouterr().out
    assert _table_numbers(port) == _table_numbers(root)
    miou = [line for line in root.splitlines() if line.startswith("mIoU@k")]
    assert miou and miou == [line for line in port.splitlines()
                             if line.startswith("mIoU@k")]


def test_train_cli_arguments():
    from isegprobe_torch.train import parse_args

    cfg = parse_args(["model=synthetic_dinov2_noup",
                      "training_params.crop_size=[112,112]",
                      "dataloader.mp=false", "epoch_len=16"])
    assert cfg["training_params.crop_size"] == [112, 112]
    assert cfg["dataloader.mp"] is False and cfg["epoch_len"] == 16
    for ok in (["training_params.dtype=bfloat16"],
               ["training.resume_exp=000"], ["training.weights=x.ckpt"],
               ["dataloader.mp=true"], ["training.model_parallel=2"],
               ["training.n_devices=4", "training.model_parallel=2"]):
        parse_args(["model=synthetic_dinov2_noup", *ok])
    for bad, err in ((["model=synthetic_dinov2_nonexistent"], ValueError),
                     (["model=synthetic_dinov2_noup",
                       "training_params.dtype=float16"], ValueError),
                     (["model=synthetic_dinov2_noup", "training.n_devices=4",
                       "training.model_parallel=3"], ValueError),
                     (["model=synthetic_dinov2_noup",
                       "training.model_parallel=0"], ValueError),
                     (["model=synthetic_dinov2_noup", "colour=red"],
                      ValueError)):
        with pytest.raises(err):
            parse_args(bad)


def test_train_cli_runs_two_steps_and_evaluate_reads_it(tmp_path):
    """``python -m isegprobe_torch.train`` on the CPU (``device=cpu``): two
    full-width steps at a 112² crop and a reduced epoch length write a
    checkpoint (in the run directory ``<exp_path>/synthetic/dinov2_noup/
    000_<exp.name>``, the JAX package's path for the script) that
    ``python -m isegprobe_torch.evaluate`` reads, and the JAX package's
    model config for the same script."""
    from isegprobe_torch import evaluate, train
    from isegprobe_torch.utils.serialization import load_checkpoint

    out = tmp_path / "exp"
    assert train.main(["model=synthetic_dinov2_noup", "device=cpu",
                       "training_params.crop_size=[112,112]",
                       "epoch_len=16", "val_epoch_len=8",
                       "training_params.epochs=1", "dataloader.workers=2",
                       f"exp_path={out}"]) == 0
    ckpt = (out / "synthetic" / "dinov2_noup" / "000_exp_name_test"
            / "checkpoints" / "last_checkpoint.ckpt")
    params, config, extra = load_checkpoint(ckpt)
    assert sorted(params) == ["embed_coords", "head"] and extra == {
        "epoch": 0}
    jcfg = jax_cfg(crop_size=[112, 112])
    from models.common import init_model_from_modules_cfg

    from isegprobe_tpu.utils.serialization import model_config

    jmodel = init_model_from_modules_cfg(
        _dinov2_noup().define_modules_cfg(jcfg), jcfg)
    assert config == model_config(jmodel)
    with np.load(evaluate.SYNTHETIC_FIXTURE) as fx:
        scenes = tmp_path / "scenes.npz"
        np.savez(scenes, images=fx["images"][:1], labels=fx["labels"][:1],
                 objects=fx["objects"][:1])
    assert evaluate.main([f"checkpoint={ckpt}", "datasets=Synthetic",
                          f"scenes={scenes}",
                          "eval_mode=fixed112", "n_clicks=2",
                          "device=cpu"]) == 0


# -- the fixture of the GPU check ------------------------------------------------------

@pytest.fixture(scope="module")
def step_fixture():
    with np.load(STEP_FIXTURE) as data:
        return dict(data)


def test_step_fixture_against_a_fresh_jax_export(step_fixture):
    """Size and keys, the seeds, and the first item against a fresh JAX
    process-mode item; the port's item from the same seed is equal."""
    from isegprobe_torch.data.loader import item_seed
    from isegprobe_torch.train import synthetic_datasets

    fx = step_fixture
    assert STEP_FIXTURE.stat().st_size <= 4 * 2**20
    assert fx["images"].shape == (8, 224, 224, 3)
    assert fx["images"].dtype == np.uint8 and fx["instances"].dtype == np.int8
    assert fx["points"].shape == (8, 48, 3) and fx["losses"].shape == (2,)
    salt = zlib.crc32(b"train")
    assert [item_seed(0, salt, 0, p) for p in fx["positions"]] == list(
        fx["seeds"])
    jtrain, _ = jax_synthetic_datasets(jax_cfg())
    want = jax_items(jtrain, [0])[0]
    ttrain, _ = synthetic_datasets()
    got = ttrain.get_item(0, int(fx["seeds"][0]))
    for key in ("images", "points", "instances"):
        np.testing.assert_array_equal(fx[key][0], want[key])
        np.testing.assert_array_equal(got[key], want[key])


def step_against_fixture(fx, device="cpu"):
    """The port's full-width step from ``init_tree(config, 0)`` on the
    fixture's batch at num_iters=0, twice: (losses, digests by name).
    ``chip_smoke.py`` runs the same on the card."""
    import tempfile

    from isegprobe_torch.train import build_trainer, parse_args

    with tempfile.TemporaryDirectory() as tmp:  # the run directory
        trainer = build_trainer(parse_args(["model=synthetic_dinov2_noup",
                                            f"device={device}",
                                            "dataloader.workers=0",
                                            f"exp_path={tmp}"]))
    batch = trainer._upload({k: fx[k] for k in ("images", "points",
                                                 "instances")})
    losses = [float(trainer._step(batch, 0)[0]) for _ in range(2)]
    return losses, digest(trainer.full_params(("embed_coords", "head")))


def test_cpu_step_matches_the_fixture(step_fixture):
    fx = step_fixture
    losses, dig = step_against_fixture(fx)
    np.testing.assert_allclose(losses, fx["losses"], rtol=STEP_LOSS_RTOL)
    assert sorted(dig) == list(fx["digest_names"])
    for name, want in zip(fx["digest_names"], fx["digests"]):
        got = dig[name]
        np.testing.assert_allclose(
            got[:2], want[:2], rtol=0,
            atol=DIGEST_RTOL * want[1] + STEP_FLIPS * 4.4 * LR)
        np.testing.assert_allclose(got[2:], want[2:], rtol=0,
                                   atol=DIGEST_ATOL)


# -- learning -------------------------------------------------------------------------

@pytest.mark.skipif(not os.environ.get("RUN_SLOW"),
                    reason="learning demo (RUN_SLOW=1)")
def test_trained_head_beats_random_init(tmp_path, monkeypatch):
    """``tests/test_learning.py`` on the port: a tiny probe trained 8
    epochs on 64 shape scenes beats its random init on held-out scenes."""
    import torch

    from isegprobe_torch.data import transforms as T
    from isegprobe_torch.data.datasets import SyntheticShapesDataset
    from isegprobe_torch.data.points_sampler import MultiPointSampler
    from isegprobe_torch.inference.device_eval import (
        evaluate_dataset_device,
        make_device_evaluator,
    )
    from isegprobe_torch.inference.metrics import compute_noc_metric, \
        miou_at_k
    from isegprobe_torch.models.featurizers import dinov2
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.training.losses import NormalizedFocalLossSigmoid
    from isegprobe_torch.training.trainer import iSegTrainer

    hw = 56
    monkeypatch.setitem(dinov2.DINOV2_ARCHS, "dinov2_tiny_learn",
                        dataclasses.replace(
                            dinov2.DINOV2_ARCHS["dinov2_vits14"],
                            embed_dim=96, depth=2, num_heads=4))
    cfg = dict(tiny_config())
    cfg["backbone_cfg"] = dict(type="dinov2", params=dict(
        arch="dinov2_tiny_learn", feats_injection_mode="before_backbone"))
    cfg["embed_coords_cfg"]["params"]["img_size"] = [hw, hw]

    def dataset(seed, n):
        return SyntheticShapesDataset(
            n_samples=n, image_size=(hw, hw), max_shapes=1, seed=seed,
            augmentator=T.Compose([T.PadIfNeeded(hw, hw),
                                   T.RandomCrop(hw, hw)]),
            min_object_area=40,
            points_sampler=MultiPointSampler(max_num_points=4,
                                             prob_gamma=0.8,
                                             first_click_center=True),
            epoch_len=n)

    def noc_miou(model):
        run = make_device_evaluator(model, target_size=(hw, hw),
                                    max_clicks=8, net_clicks_limit=8,
                                    pred_thr=0.49, target_iou=0.50,
                                    with_flip=False, device="cpu")
        evalset = SyntheticShapesDataset(n_samples=12, image_size=(hw, hw),
                                         max_shapes=1, seed=777,
                                         min_instance_area=120)
        ious = evaluate_dataset_device(run, evalset)
        noc, _, _ = compute_noc_metric(ious, iou_thrs=[0.50], max_clicks=8)
        return noc[0], float(miou_at_k(ious, 8)[-1])

    torch.set_num_threads(4)
    model = iSegProbeModel(**cfg, device="cpu")
    trainer = iSegTrainer(
        model, _ns_cfg(tmp_path),
        {"instance_loss": NormalizedFocalLossSigmoid(alpha=0.5, gamma=2),
         "instance_loss_weight": 1.0},
        dataset(1, 64), dataset(2, 8), optimizer="adam",
        optimizer_params={"lr": 2e-3}, checkpoint_interval=100,
        max_num_next_clicks=1, seed=0, device="cpu")
    noc_rand, miou_rand = noc_miou(model)
    for epoch in range(8):
        trainer.training(epoch)
    noc_trained, miou_trained = noc_miou(model)
    print(f"NoC@50: random {noc_rand:.2f} -> trained {noc_trained:.2f}; "
          f"mIoU@8: {miou_rand:.3f} -> {miou_trained:.3f}")
    assert miou_trained > miou_rand + 0.15
    assert noc_trained < noc_rand - 2.0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    if "--export" not in sys.argv[1:]:
        sys.exit("usage: JAX_PLATFORMS=cpu python tests/test_torch_training.py"
                 " --export")
    export()
