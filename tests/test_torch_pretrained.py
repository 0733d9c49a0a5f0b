"""``PRETRAINED_MODELS`` in the port's trainer and train CLI: the converted
backbone that the key of the backbone's type names is overlaid on the
initial params as the JAX trainer's ``_load_pretrained`` does
(``isegprobe_tpu/training/trainer.py:325-350``), before the upsampler's
``upsampler_path`` and ``training.weights``.

Tolerances: the overlaid leaves bitwise the file's, every other leaf
bitwise the initial tree's (the same merge), at tiny archs.
"""

import types

import jax
import numpy as np
import pytest
import torch

from isegprobe_torch.models import convert as P
from isegprobe_torch.utils import drawn_weights as D
from isegprobe_torch.utils.serialization import msgpack_serialize
from tests.test_torch_families import tiny_archs  # noqa: F401  (fixture)
from tests.test_torch_families import WIDTH, tiny_config as family_config
from tests.test_torch_training import (  # noqa: F401  (fixture)
    ListDataset,
    _items,
    _ns_cfg,
    tiny_arch,
    tiny_batch,
    tiny_config,
)

torch.set_num_threads(2)


def _np(tree):
    return jax.tree.map(np.asarray, jax.device_get(tree))


def _same(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), (path, sorted(got), sorted(want))
        for k in want:
            _same(got[k], want[k], f"{path}/{k}")
    else:
        assert np.array_equal(np.asarray(got), np.asarray(want)), path


def _jax_load_pretrained(cfg, config, params):
    """The JAX trainer's ``_load_pretrained`` on ``params`` (its method on
    the two attributes it reads)."""
    from isegprobe_tpu.training.trainer import iSegTrainer as JTrainer

    model = types.SimpleNamespace(
        backbone_cfg=config["backbone_cfg"],
        upsampler_cfg=config.get("upsampler_cfg"))
    return JTrainer._load_pretrained(types.SimpleNamespace(cfg=cfg,
                                                           model=model),
                                     params)


def _port_trainer(tmp_path, pretrained):
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.training.losses import NormalizedFocalLossSigmoid
    from isegprobe_torch.training.trainer import iSegTrainer

    items = _items(tiny_batch())
    cfg = _ns_cfg(tmp_path)
    cfg.PRETRAINED_MODELS = pretrained
    return iSegTrainer(
        iSegProbeModel(**tiny_config(), device="cpu"), cfg,
        {"instance_loss": NormalizedFocalLossSigmoid(alpha=0.5, gamma=2),
         "instance_loss_weight": 1.0},
        ListDataset(items), ListDataset(items), optimizer="adam",
        optimizer_params={"lr": 5e-5}, seed=0, device="cpu")


def test_trainer_overlays_the_pretrained_backbone_as_jax(tiny_arch, tmp_path):
    """A drawn DINOv2 hub file at the tiny arch, converted by the port's
    script, named by ``PRETRAINED_MODELS.DINOV2_VITS14``: the trainer's
    backbone is the JAX package's ``merge_params(init, {"model": file})``
    and its ``_load_pretrained``'s; the rest of the tree stays the
    init's."""
    from flax import serialization as flax_serialization

    from isegprobe_torch.models.init_tree import init_tree
    from isegprobe_torch.scripts import convert_weights
    from isegprobe_tpu.utils.serialization import merge_params

    sd = D.draw_state_dict(D.vit_layout(depth=2, dim=96, patch=14, grid=37,
                                        chunks=2), 3)
    src, path = tmp_path / "hub.pth", tmp_path / "dinov2.msgpack"
    torch.save(sd, src)
    convert_weights.main(["--kind", "dinov2", "--input", str(src),
                          "--output", str(path), "--depth", "2"])
    loaded = flax_serialization.msgpack_restore(path.read_bytes())
    init = init_tree(tiny_config(), 0)
    want = merge_params(init, {"backbone": {"model": loaded}})
    _same(_np(want["backbone"]["model"]), P.convert_vit(sd, 2, True))
    _same(_np(_jax_load_pretrained(types.SimpleNamespace(
        PRETRAINED_MODELS={"DINOV2_VITS14": str(path)}), tiny_config(),
        init)), _np(want))

    trainer = _port_trainer(tmp_path, {"DINOV2_VITS14": str(path)})
    _same(trainer.full_params(), _np(want))
    # a key of another backbone type is not read
    other = _port_trainer(tmp_path, {"DINO_VITS16": str(path),
                                     "DINOV2_VITS14": ""})
    _same(other.full_params(), init)


def test_missing_pretrained_file_warns_and_keeps_the_init(tiny_arch,
                                                          tmp_path):
    from isegprobe_torch.models.init_tree import init_tree

    missing = str(tmp_path / "nowhere.msgpack")
    with pytest.warns(UserWarning, match="PRETRAINED_MODELS.DINOV2_VITS14"):
        trainer = _port_trainer(tmp_path, {"DINOV2_VITS14": missing})
    _same(trainer.full_params(), init_tree(tiny_config(), 0))


def test_maskclip_pretrained_drops_the_layers_the_probe_never_calls(
        tiny_archs, tmp_path):
    """A CLIP file's last visual block holds an MLP that MaskCLIP's dense
    tower never calls: JAX's merge keeps it (flax leaves it unused), the
    port drops it; every leaf the probe has is the file's."""
    from isegprobe_torch.models.init_tree import init_tree
    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.training.trainer import iSegTrainer

    config = family_config("maskclip_noup", 64)
    sd = D.draw_state_dict(D.clip_layout(
        layers=3, width=WIDTH, grid=4, output_dim=64, text_layers=1,
        text_width=16, vocab=50, context=5), 4, torch.float16)
    path = tmp_path / "clip.msgpack"
    path.write_bytes(msgpack_serialize(P.convert_clip_visual(sd, 3)))
    init = init_tree(config, 0)
    cfg = types.SimpleNamespace(
        PRETRAINED_MODELS={"MASKCLIP_VITB16": str(path)})
    want = _np(_jax_load_pretrained(cfg, config, init))
    assert "c_fc" in want["backbone"]["model"]["resblocks_2"]
    model = iSegProbeModel(**config, device="cpu")
    got = iSegTrainer._load_pretrained(
        types.SimpleNamespace(cfg=cfg, model=model), init, config)
    _same(got["backbone"], P.restrict_to_module(want["backbone"],
                                                model.backbone))
    assert sorted(got["backbone"]["model"]["resblocks_2"]) == ["attn",
                                                               "ln_1"]
    P.load_jax_params(model, got)


def test_train_cli_takes_the_pretrained_keys(monkeypatch, tmp_path):
    """The three keys of ``configs/main_cfg.yaml`` (empty by default) reach
    the trainer's ``cfg.PRETRAINED_MODELS``."""
    from isegprobe_torch import train

    cfg = train.parse_args(["model=synthetic_dinov2_noup"])
    assert {k: v for k, v in cfg.items()
            if k.startswith("PRETRAINED_MODELS.")} == {
        "PRETRAINED_MODELS.DINOV2_VITS14": "",
        "PRETRAINED_MODELS.DINO_VITS16": "",
        "PRETRAINED_MODELS.MASKCLIP_VITB16": ""}
    seen = {}

    class Capture:
        def __init__(self, model, cfg, *args, **kwargs):
            seen["cfg"] = cfg

    monkeypatch.setattr("isegprobe_torch.training.trainer.iSegTrainer",
                        Capture)
    train.build_trainer(train.parse_args([
        "model=synthetic_dinov2_noup", "device=cpu",
        "PRETRAINED_MODELS.DINOV2_VITS14=/weights/dinov2_vits14.msgpack",
        f"exp_path={tmp_path}"]))
    assert seen["cfg"].PRETRAINED_MODELS == {
        "DINOV2_VITS14": "/weights/dinov2_vits14.msgpack",
        "DINO_VITS16": "", "MASKCLIP_VITB16": ""}
