"""Resuming training with the port against the JAX package: the trainer's
``training.weights``, the run directories of ``utils/exp.py`` against the
JAX package's ``init_experiment``, and the command line's
``training.resume_exp`` / ``resume_prefix``.

Ports of ``tests/test_trainer.py:test_resume_from_checkpoint_continues_
training`` and ``tests/test_cli_end_to_end.py``'s ``init_experiment``
tests (numeric run and checkpoint prefixes, ``false`` means a fresh run).
Like the JAX trainer, resuming restores the weights, not the optimizer
state. Loaded leaves are compared bitwise.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from tests.test_torch_training import (  # noqa: F401  (fixture)
    ListDataset,
    _items,
    _ns_cfg,
    tiny_arch,
    tiny_batch,
    tiny_config,
)

LOSS = {"alpha": 0.5, "gamma": 2}


def _port_trainer(cfg, seed=3, **kw):
    import torch

    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.training.losses import NormalizedFocalLossSigmoid
    from isegprobe_torch.training.trainer import iSegTrainer

    torch.set_num_threads(4)
    items = ListDataset(_items(tiny_batch()))
    return iSegTrainer(
        iSegProbeModel(**tiny_config(), device="cpu"), cfg,
        {"instance_loss": NormalizedFocalLossSigmoid(**LOSS),
         "instance_loss_weight": 1.0}, items, items, optimizer="adam",
        optimizer_params={"lr": 1e-3}, seed=seed, device="cpu", **kw)


def _leaves(tree):
    import jax

    return jax.tree.leaves(tree)


def test_resume_from_checkpoint_continues_training(tiny_arch, tmp_path):
    """Checkpoint -> a fresh trainer with ``training.weights`` -> its
    trainable leaves equal the saved ones bitwise (and the JAX trainer
    given the same ``training.weights`` loads the same), its frozen ones
    are the init's, and training continues from them."""
    import jax

    from isegprobe_torch.utils.serialization import load_checkpoint
    from isegprobe_tpu.models.probe_model import iSegProbeModel as JModel
    from isegprobe_tpu.parallel.mesh import make_mesh
    from isegprobe_tpu.training.losses import NormalizedFocalLossSigmoid
    from isegprobe_tpu.training.trainer import iSegTrainer as JTrainer

    first = _port_trainer(_ns_cfg(tmp_path))
    init = first.full_params()
    first.training(0)
    saved = first.full_params(("embed_coords", "head"))
    path = tmp_path / "ckpts" / "last_checkpoint.ckpt"
    stored, _, extra = load_checkpoint(path)
    assert extra == {"epoch": 0}
    for a, b in zip(_leaves(saved), _leaves(stored)):
        assert np.array_equal(a, b)

    cfg = _ns_cfg(tmp_path)
    cfg.training.weights = str(path)
    resumed = _port_trainer(cfg)
    loaded = resumed.full_params()
    for a, b in zip(_leaves({k: loaded[k] for k in saved}), _leaves(saved)):
        assert np.array_equal(a, b)
    for top in ("backbone", "upsampler"):
        for a, b in zip(_leaves(loaded.get(top, {})),
                        _leaves(init.get(top, {}))):
            assert np.array_equal(a, b)

    items = ListDataset(_items(tiny_batch()))
    jtr = JTrainer(JModel(**tiny_config(), attn_impl="jnp"), cfg,
                   {"instance_loss": NormalizedFocalLossSigmoid(**LOSS),
                    "instance_loss_weight": 1.0}, items, items,
                   optimizer="adam", optimizer_params={"lr": 1e-3}, seed=3,
                   mesh=make_mesh(n_devices=1))
    jloaded = jax.device_get(jtr.params["trainable"])
    for a, b in zip(_leaves({k: jloaded[k] for k in saved}),
                    _leaves(saved)):
        assert np.array_equal(np.asarray(a), b)

    resumed.training(1)  # keeps training from the restored weights
    after = resumed.full_params(("embed_coords", "head"))
    assert any(not np.array_equal(a, b)
               for a, b in zip(_leaves(after), _leaves(saved)))


# -- run directories ------------------------------------------------------------

def _jax_run(tmp_path, monkeypatch, training: dict, name: str):
    """The JAX package's ``init_experiment`` for a model script
    ``models/synthetic/demo_model.py`` under ``tmp_path``: (run directory,
    weights)."""
    from isegprobe_tpu.utils.config import EDict
    from isegprobe_tpu.utils.exp import init_experiment

    monkeypatch.chdir(tmp_path)
    script = tmp_path / "models" / "synthetic" / "demo_model.py"
    script.parent.mkdir(parents=True, exist_ok=True)
    script.write_text("main = None\n")
    cfg = EDict.convert({"exp": {"model_path": str(script), "name": name},
                         "training": dict(training, weights=None),
                         "EXPS_PATH": str(tmp_path / "exps")})
    cfg = init_experiment(cfg)
    return Path(cfg.EXP_PATH), cfg.training.weights


def _make_run(root: Path, run: str, checkpoints=("last_checkpoint",)):
    ckpts = root / "exps" / "synthetic" / "demo_model" / run / "checkpoints"
    ckpts.mkdir(parents=True)
    for c in checkpoints:
        (ckpts / f"{c}.ckpt").write_bytes(c.encode())


@pytest.mark.parametrize("resume_exp,resume_prefix,want_run,want_ckpt", [
    (0, "latest", "000_first", "last_checkpoint"),      # int 0 is "000"
    ("000", 8, "000_first", "008"),                      # int 8 is "008"
    (False, "latest", "002_second", None),               # false: fresh run
    (None, "latest", "002_second", None),
    (1, "latest", "001_again", "last_checkpoint"),
])
def test_init_experiment_matches_jax(tmp_path, monkeypatch, resume_exp,
                                     resume_prefix, want_run, want_ckpt):
    """The port's run numbering and resume lookup against the JAX
    package's ``init_experiment`` on the same directory tree."""
    from isegprobe_torch.utils.exp import init_experiment

    for root in (tmp_path / "jax", tmp_path / "port"):
        _make_run(root, "000_first", ("008", "last_checkpoint"))
        _make_run(root, "001_again")
    training = {"resume_exp": resume_exp, "resume_prefix": resume_prefix}
    (tmp_path / "jax").mkdir(exist_ok=True)
    jrun, jweights = _jax_run(tmp_path / "jax", monkeypatch, training,
                              "second")
    port = init_experiment(tmp_path / "port" / "exps",
                           tmp_path / "port" / "models" / "synthetic"
                           / "demo_model.py", "second", resume_exp,
                           resume_prefix)
    assert port["exp_path"].name == jrun.name == want_run
    assert port["checkpoints_path"] == port["exp_path"] / "checkpoints"
    assert port["checkpoints_path"].is_dir()
    if want_ckpt is None:
        assert port["weights"] is None and jweights is None
    else:
        assert Path(port["weights"]).name == Path(jweights).name == (
            f"{want_ckpt}.ckpt")
        assert Path(port["weights"]).parent == port["checkpoints_path"]
    with pytest.raises(FileNotFoundError):
        init_experiment(tmp_path / "port", "demo_model", resume_exp="007")


# -- the command line --------------------------------------------------------------

def _cli_args(out: Path):
    return ["model=synthetic_dinov2_noup", "device=cpu",
            "training_params.crop_size=[56,56]", "dataloader.batch_size=2",
            "dataloader.val_batch_size=2", "epoch_len=4", "val_epoch_len=2",
            "dataloader.workers=0", "exp.name=run", f"exp_path={out}"]


def _cli(out: Path, *extra):
    from isegprobe_torch.train import parse_args

    return parse_args([*_cli_args(out), *extra])


def test_train_cli_resumes_a_run(tmp_path):
    """``training.resume_exp=0`` continues run 000 in its own directory
    from its last checkpoint (leaves bitwise, then moved by the next
    epoch, which ``training.start_epoch`` names); ``resume_prefix=0``
    picks the epoch checkpoint ``000.ckpt``; ``training.weights`` merges
    a checkpoint into a fresh run; ``resume_exp=false`` starts run 001."""
    from isegprobe_torch import train
    from isegprobe_torch.utils.serialization import load_checkpoint

    out = tmp_path / "exp"
    assert train.main([*_cli_args(out), "training_params.epochs=1",
                       "training_params.checkpoint_interval=[[0,1]]"]) == 0
    (run,) = out.glob("*/*/000_run")
    ckpt = run / "checkpoints" / "last_checkpoint.ckpt"
    saved, _, _ = load_checkpoint(ckpt)
    assert (run / "checkpoints" / "000.ckpt").exists()

    for extra in (["training.resume_exp=0"],
                  ["training.resume_exp=000", "training.resume_prefix=0"],
                  [f"training.weights={ckpt}"]):
        trainer = train.build_trainer(_cli(out, *extra))
        loaded = trainer.full_params(tuple(saved))
        for a, b in zip(_leaves(loaded), _leaves(saved)):
            assert np.array_equal(a, b), extra
        if extra[0].startswith("training.resume_exp"):
            assert Path(trainer.cfg.CHECKPOINTS_PATH) == run / "checkpoints"
        trainer.shutdown()
    assert sorted(p.name for p in run.parent.iterdir()) == ["000_run",
                                                            "001_run"]
    trainer = train.build_trainer(_cli(out, "training.resume_exp=0"))
    try:
        trainer.run(2, start_epoch=1)
    finally:
        trainer.shutdown()
    moved, _, extra = load_checkpoint(ckpt)
    assert extra == {"epoch": 1}
    assert any(not np.array_equal(a, b)
               for a, b in zip(_leaves(moved), _leaves(saved)))
    train.build_trainer(_cli(out, "training.resume_exp=false")).shutdown()
    assert sorted(p.name for p in run.parent.iterdir()) == [
        "000_run", "001_run", "002_run"]


def test_resume_keys_parse_and_find(tmp_path):
    """The command line's resume values as its parser reads them (``000``
    an int, ``008`` a string, ``false`` a bool) find what the JAX
    package's YAML-parsed ones find."""
    from isegprobe_torch.train import parse_args
    from isegprobe_torch.utils.exp import init_experiment

    cfg = parse_args(["model=synthetic_dinov2_noup", "training.resume_exp=000",
                      "training.resume_prefix=008"])
    assert cfg["training.resume_exp"] == 0
    ckpts = tmp_path / "m" / "000_a" / "checkpoints"
    ckpts.mkdir(parents=True)
    for name in ("008", "last_checkpoint"):
        (ckpts / f"{name}.ckpt").write_bytes(b"x")
    for prefix in (cfg["training.resume_prefix"], 8):
        run = init_experiment(tmp_path, "m", "b", cfg["training.resume_exp"],
                              prefix)
        assert run["weights"] == str(ckpts / "008.ckpt")
    cfg = parse_args(["model=synthetic_dinov2_noup",
                      "training.resume_exp=false"])
    assert cfg["training.resume_exp"] is False
    run = init_experiment(tmp_path, "m", "b", cfg["training.resume_exp"])
    assert run["exp_path"].name == "001_b" and run["weights"] is None
