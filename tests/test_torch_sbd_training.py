"""The SBD scripts of ``models/sbd/`` in the port's train CLI, against the
JAX package on the CPU.

- ``python -m isegprobe_torch.train`` takes all eight ``sbd_*`` keys; each
  names its script's ``MODEL_NAME`` and builds the script's modules.
- ``sbd_dinov2_bilinear`` (the flagship through the bilinear upsampler,
  a configuration no Synthetic script trains) at a 2-block, 96-wide arch:
  three steps against the JAX trainer's ``_train_step`` (loss within
  1e-5, parameters within 5e-7 but for at most ``STEP_FLIPS`` elements a
  leaf whose gradient is rounding noise, within Adam's step).
- The full-width 224² steps of ``sbd_dinov2_noup`` and
  ``sbd_dinov2_bilinear`` at batch 8 from ``init_tree(config, 0)``, on the
  port's SBD items of the committed tree, against the JAX numbers in
  ``isegprobe_torch/fixtures/datasets.npz`` (the tolerances of
  ``tests/test_torch_training.py``'s full-width step).
- A two-step command-line run on SBD with process workers
  (``dataloader.mp=true``), its checkpoint read by the JAX reader.
"""

from __future__ import annotations

import importlib.util
import json
import zlib
from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_datasets import (
    FIXTURE,
    ITEM_POSITIONS,
    STEP_MODELS,
    TREES,
)
from tests.test_torch_training import (  # noqa: F401 (tiny_arch: a fixture)
    BATCH,
    DIGEST_ATOL,
    DIGEST_RTOL,
    LR,
    STEP_FLIPS,
    STEP_LOSS_RTOL,
    ListDataset,
    _items,
    _ns_cfg,
    _numpy_tree,
    digest,
    tiny_arch,
    tiny_batch,
    tiny_config,
)

REPO = Path(__file__).resolve().parents[1]
SCRIPTS = {
    "sbd_dinov2_noup": "dinov2/patch-embed_noup.py",
    "sbd_dinov2_bilinear": "dinov2/patch-embed_bilinear.py",
    "sbd_dinov2_jbu": "dinov2/patch-embed_jbu.py",
    "sbd_dinov2_lift": "dinov2/patch-embed_lift.py",
    "sbd_dinov2_loftup": "dinov2/patch-embed_loftup.py",
    "sbd_dinov2_simplevit": "dinov2/simple-vit_noup.py",
    "sbd_maskclip_noup": "maskclip/patch-embed_noup.py",
    "sbd_vit_noup": "vit/patch-embed_noup.py",
}


def _script(key):
    spec = importlib.util.spec_from_file_location(
        f"isegprobe_models_{key}", REPO / "models" / "sbd" / SCRIPTS[key])
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _plain(x):
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("key", sorted(SCRIPTS))
def test_train_cli_takes_the_sbd_script(key):
    from isegprobe_torch.train import MODELS, model_kwargs, parse_args
    from isegprobe_tpu.utils.config import EDict

    cfg = parse_args([f"model={key}", "DATASETS.SBD_PATH=/x/sbd"])
    assert (cfg["epoch_len"], cfg["val_epoch_len"]) == (-1, 500)
    assert cfg["DATASETS.SBD_PATH"] == "/x/sbd"
    script = _script(key)
    assert MODELS[key] == script.MODEL_NAME
    jcfg = EDict.convert(dict(
        training_params=dict(crop_size=[224, 224]),
        UPSAMPLERS=dict(LIFT="/weights/lift.pth",
                        LOFTUP="/weights/loftup.pth")))
    modules = script.define_modules_cfg(jcfg)
    got = model_kwargs(cfg)
    for name in ("backbone", "embed_coords", "head", "upsampler"):
        assert _plain(got[f"{name}_cfg"]) == _plain(modules[name]), name
    assert got["save_cfg"] == _plain(modules["save"])


def test_sbd_defaults():
    from isegprobe_torch.train import DEFAULTS, build_trainer, parse_args

    assert DEFAULTS["DATASETS.SBD_PATH"] == "/data/sbd"  # main_cfg.yaml's
    cfg = parse_args(["model=synthetic_dinov2_noup"])
    assert (cfg["epoch_len"], cfg["val_epoch_len"]) == (320, 48)
    cfg = parse_args(["model=sbd_dinov2_noup", "epoch_len=16"])
    assert (cfg["epoch_len"], cfg["val_epoch_len"]) == (16, 500)
    with pytest.raises(ValueError, match="models/sbd/"):
        parse_args(["model=sbd_dinov2_nonexistent"])
    # get_sbd_train_val_datasets' batch rule: 32 below 1, val = train
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        trainer = build_trainer(parse_args([
            "model=sbd_dinov2_noup", "device=cpu", "dataloader.batch_size=0",
            "dataloader.val_batch_size=3", f"exp_path={tmp}",
            f"DATASETS.SBD_PATH={TREES / 'sbd'}",
            "training_params.crop_size=[56,56]"]))
        assert trainer.train_data.batch_size == 32
        assert trainer.val_data.batch_size == 32
        # assets/sbd_samples_weights.pkl is not in the repository
        assert trainer.train_data.dataset._weighted_index is None
        trainer.shutdown()


def _bilinear_config():
    return dict(tiny_config(), upsampler_cfg=dict(type="bilinear",
                                                  params=dict()))


def test_bilinear_step_matches_jax(tiny_arch, tmp_path):
    """Three steps of the tiny bilinear probe at num_iters=0: loss and
    parameters against the JAX trainer, frozen parameters bitwise."""
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
    batch = tiny_batch(3)
    items = _items(batch)
    opt = {"lr": LR, "betas": (0.9, 0.999), "eps": 1e-8}
    loss = dict(instance_loss_weight=1.0)
    jtr = JTrainer(JModel(**_bilinear_config(), attn_impl="jnp"),
                   _ns_cfg(tmp_path),
                   dict(loss, instance_loss=JNFL(alpha=0.5, gamma=2)),
                   ListDataset(items), ListDataset(items), optimizer="adam",
                   optimizer_params=dict(opt), max_num_next_clicks=2, seed=0,
                   mesh=make_mesh(n_devices=1))
    p = jax.device_get(jtr.params)
    params = _numpy_tree({**p["trainable"], **p["frozen"]})
    ttr = TTrainer(TModel(**_bilinear_config(), device="cpu"),
                   _ns_cfg(tmp_path),
                   dict(loss, instance_loss=TNFL(alpha=0.5, gamma=2)),
                   ListDataset(items), ListDataset(items), optimizer="adam",
                   optimizer_params=dict(opt), max_num_next_clicks=2, seed=0,
                   params=params, device="cpu")
    assert ttr.model.upsampler_type == "bilinear"
    frozen0 = {k: v.clone() for k, v in ttr.model.state_dict().items()
               if k.startswith(("backbone", "upsampler"))}
    jbatch, tbatch = jtr._prep_batch(batch), ttr._upload(batch)
    rng = jax.random.PRNGKey(0)
    for _ in range(3):
        (jtr.params, jtr.opt_state, jloss, _, _, _) = jtr._train_step(
            jtr.params, jtr.opt_state, jbatch, rng, 0, 0.4, 0.025,
            click_trees=())
        tloss, _, _ = ttr._step(tbatch, 0)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
        got = ttr.full_params(("embed_coords", "head"))
        want = jax.device_get(jtr.params["trainable"])
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            # within 5e-7, but for an element whose gradient is rounding
            # noise: Adam may move it by up to ~2.2 lr a step either way
            # (measured: 1 of 82,944 head weights, 7.6e-7 after step 3)
            d = np.abs(np.asarray(a, np.float64) - b)
            assert (d > 5e-7).sum() <= STEP_FLIPS
            assert d.max() <= 3 * 2.2 * LR
    for k, v in ttr.model.state_dict().items():
        if k in frozen0:
            assert torch.equal(v, frozen0[k]), k
    ttr.shutdown()


def test_bilinear_init_tree_is_the_identity_probes(tiny_arch):
    """The bilinear upsampler has no parameters and draws none: the
    probe's ``init_tree`` is the identity probe's, leaf for leaf
    (``chip_smoke.py`` draws the tree once for both)."""
    from isegprobe_torch.models.init_tree import init_tree

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}{k}/") if isinstance(v, dict)
                       else {prefix + k: v})
        return out

    got = flat(init_tree(_bilinear_config(), 0))
    want = flat(init_tree(tiny_config(), 0))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def sbd_batch(trainset):
    """The train items of seed 0 at positions 0-7 (index = position),
    stacked: the batch of the fixture's JAX steps."""
    from isegprobe_torch.data.loader import _stack, item_seed

    salt = zlib.crc32(b"train")
    return _stack([trainset.get_item(p, item_seed(0, salt, 0, p))
                   for p in ITEM_POSITIONS])


def sbd_step(model_key, device="cpu", sbd_path=TREES / "sbd"):
    """The port's full-width 224² step of ``model_key`` from
    ``init_tree(config, 0)`` on :func:`sbd_batch`, twice: (losses, digests
    by name, trainer). ``chip_smoke.py`` runs the same on the card."""
    import tempfile

    from isegprobe_torch.train import build_trainer, parse_args

    with tempfile.TemporaryDirectory() as tmp:  # the run directory
        trainer = build_trainer(parse_args([
            f"model={model_key}", f"device={device}", "dataloader.workers=0",
            f"exp_path={tmp}", f"DATASETS.SBD_PATH={sbd_path}"]))
    batch = trainer._upload(sbd_batch(trainer.train_data.dataset))
    losses = [float(trainer._step(batch, 0)[0]) for _ in range(2)]
    return (losses, digest(trainer.full_params(("embed_coords", "head"))),
            trainer)


@pytest.mark.parametrize("model_key", STEP_MODELS)
def test_cpu_sbd_step_matches_the_fixture(model_key):
    with np.load(FIXTURE) as fx:
        names = list(fx["step_digest_names"])
        want_losses = fx[f"step_{model_key}_losses"]
        want_digests = fx[f"step_{model_key}_digests"]
    losses, dig, trainer = sbd_step(model_key)
    trainer.shutdown()
    np.testing.assert_allclose(losses, want_losses, rtol=STEP_LOSS_RTOL)
    assert sorted(dig) == names
    for name, want in zip(names, want_digests):
        got = dig[name]
        np.testing.assert_allclose(
            got[:2], want[:2], rtol=0,
            atol=DIGEST_RTOL * want[1] + STEP_FLIPS * 4.4 * LR)
        np.testing.assert_allclose(got[2:], want[2:], rtol=0,
                                   atol=DIGEST_ATOL)


def test_sbd_cli_runs_two_steps_with_process_workers(tmp_path):
    """``python -m isegprobe_torch.train model=sbd_dinov2_bilinear
    dataloader.mp=true`` on the CPU: two steps at a 112² crop and batch 2
    from spawned workers, validation, and a checkpoint that the JAX
    package's reader loads with the script's model name and config."""
    from isegprobe_torch import train
    from isegprobe_tpu.utils.serialization import load_checkpoint

    out = tmp_path / "exp"
    assert train.main([
        "model=sbd_dinov2_bilinear", "device=cpu",
        f"DATASETS.SBD_PATH={TREES / 'sbd'}",
        "training_params.crop_size=[112,112]", "dataloader.batch_size=2",
        "epoch_len=4", "val_epoch_len=2", "training_params.epochs=1",
        "dataloader.workers=2", "dataloader.mp=true",
        f"exp_path={out}"]) == 0
    ckpt = (out / "sbd" / "dinov2" / "patch-embed_bilinear"
            / "000_exp_name_test" / "checkpoints" / "last_checkpoint.ckpt")
    params, config, _ = load_checkpoint(str(ckpt))
    assert sorted(params) == ["embed_coords", "head"]
    assert config["params"]["upsampler_cfg"]["type"] == "bilinear"
