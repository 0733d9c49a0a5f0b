"""Train a probe with the port.

Counterpart of the root ``train.py`` with the scripts of
``models/synthetic/`` and ``models/sbd/`` and ``models/common.py:train``,
one model a script (``model=`` takes the key, the script's ``MODEL_NAME``
beside it). The Synthetic scripts train on the procedural scenes:

- ``synthetic_dinov2_noup``: the flagship, DINOv2-S/14 with clicks
  patch-embedded before the backbone, identity upsampler;
- ``synthetic_dinov2_loftup``: the flagship through the LoftUp upsampler
  (kernel D under autograd; its configured ``upsampler_path`` warns when
  missing and LoftUp keeps its ``init_tree`` weights, as in the JAX
  package offline);
- ``synthetic_dinov2_jbu``: the flagship through the JBU-FeatUp stack
  (kernel E under autograd);
- ``synthetic_dinov2_lift``: the flagship through LiFT;
- ``synthetic_dinov2_simplevit``: DINOv2-S/14 with the SimpleViT click
  encoder added after the trunk;
- ``synthetic_vit_noup``: the DINO ViT-S/16 key probe;
- ``synthetic_maskclip_noup``: MaskCLIP ViT-B/16;

and the paper's scripts train the same modules on SBD
(``models/defaults.py:get_sbd_train_val_datasets``, read from
``DATASETS.SBD_PATH``): ``sbd_dinov2_noup``, ``sbd_dinov2_bilinear`` (the
flagship through the bilinear upsampler), ``sbd_dinov2_jbu``,
``sbd_dinov2_lift``, ``sbd_dinov2_loftup``, ``sbd_dinov2_simplevit``,
``sbd_maskclip_noup`` and ``sbd_vit_noup``.

Each has the 2-layer 3×3 convhead and the prev mask, with the JAX
package's defaults (``models/defaults.py``: the dataset's augmentations and
click sampler, NFL with alpha 0.5 and gamma 2, Adam at lr 5e-5 with betas
(0.9, 0.999) and eps 1e-8, the multistep schedule at ``lr_milestones``
with gamma 0.1, ``max_num_next_clicks=3``). The frozen backbone and
upsampler start from ``init_tree(config, seed)``, the JAX trainer's
``model.init(PRNGKey(seed))``; the saved modules (click encoder and head)
take the Adam steps, and their gradient passes through the frozen
upsampler and backbone. Checkpoints are the JAX package's (float32,
whatever the compute dtype), which both ``evaluate.py`` and ``python -m
isegprobe_torch.evaluate`` read.

Usage (on a CUDA GPU; ``device=cpu`` runs the plain PyTorch path):

    python -m isegprobe_torch.train model=synthetic_dinov2_loftup \\
        [training_params.epochs=20] [dataloader.batch_size=8] \\
        [epoch_len=320] [exp_path=./experiments/torch] [device=cpu] ...
    python -m isegprobe_torch.train model=sbd_dinov2_noup \\
        DATASETS.SBD_PATH=/data/sbd [dataloader.mp=true] ...

Keys: those of ``configs/train_cfg.yaml`` that apply (``exp.name``,
``dataloader.*``, ``training_params.*``, ``training.seed``,
``training.start_epoch``, ``training.resume_exp``,
``training.resume_prefix``, ``training.weights``), ``DATASETS.SBD_PATH``
and ``PRETRAINED_MODELS.{DINOV2_VITS14,DINO_VITS16,MASKCLIP_VITB16}``
(``configs/main_cfg.yaml``'s defaults; the port reads no YAML), plus the
port's ``model``, ``device``, ``exp_path`` and ``epoch_len`` /
``val_epoch_len`` (items an epoch; by default the script's: 320 and 48 for
the Synthetic scenes, the whole split and 500 for SBD). A run goes to
``<exp_path>/<MODEL_NAME>/<NNN>_<exp.name>/checkpoints``, numbered as the
JAX package numbers its runs (``utils/exp.py``).

- ``training_params.dtype=bfloat16`` (or ``bf16``): mixed precision, the
  model computing in bf16 by flax's rules over float32 master weights;
  ``float32`` / ``f32`` by default; anything else raises ``ValueError``.
- ``training_params.remat_backbone=true``: the ``dinov2`` and ``vit``
  backbones recompute each block in the backward (the memory lever at
  448²); the other backbones ignore it, as in the JAX package.
- ``training.resume_exp=<run prefix>`` (``000``, or ``false`` for a fresh
  run) continues that run, loading the checkpoint that
  ``training.resume_prefix`` picks (``latest``, or an epoch such as
  ``008``); ``training.weights=<checkpoint>`` merges a checkpoint over the
  initial weights. Both restore weights, not the optimizer state;
  ``training.start_epoch`` re-seeds the data order of the epoch it names.
- ``PRETRAINED_MODELS.DINOV2_VITS14=<file>.msgpack`` (``DINO_VITS16``
  for the ``vit`` backbone, ``MASKCLIP_VITB16`` for ``mask_clip``): the
  backbone starts from converted published weights
  (``python -m isegprobe_torch.scripts.convert_weights``) instead of its
  init, as in the JAX trainer; a path that does not exist warns.
- ``dataloader.mp=true`` builds the items in spawned worker processes
  (``dataloader.workers`` of them) instead of threads; the items are the
  same.

``training.model_parallel > 1``, ``training.n_devices`` and wandb raise
``NotImplementedError`` naming their ROADMAP items; a key or a model that
is not known raises ``ValueError``.
"""

from __future__ import annotations

import ast
import logging
import sys
import time
from typing import Dict, Optional, Tuple

from isegprobe_torch import resolve_device

__all__ = ["DEFAULTS", "MODELS", "parse_args", "train_dtype",
           "model_kwargs", "synthetic_datasets", "sbd_datasets", "loss_cfg",
           "build_trainer", "main"]

# model= key -> the script's MODEL_NAME; the key without its "synthetic_" or
# "sbd_" prefix is its models.probe_model.synthetic_config name
MODELS = {
    "synthetic_dinov2_noup":
        "synthetic_dinov2_noup_convhead_patchembed_earlyinject_224",
    "synthetic_dinov2_loftup":
        "synthetic_dinov2_loftup_convhead_patchembed_earlyinject_224",
    "synthetic_dinov2_jbu":
        "synthetic_dinov2_jbu_convhead_patchembed_earlyinject_224",
    "synthetic_dinov2_lift":
        "synthetic_dinov2_lift_convhead_patchembed_earlyinject_224",
    "synthetic_dinov2_simplevit":
        "synthetic_dinov2_noup_convhead_simplevit_lateinject_224",
    "synthetic_vit_noup":
        "synthetic_vit_noup_convhead_patchembed_earlyinject_224",
    "synthetic_maskclip_noup":
        "synthetic_maskclip_noup_convhead_patchembed_earlyinject_224",
    "sbd_dinov2_noup": "sbd_dinov2_noup_convhead_patchembed_earlyinject_224",
    "sbd_dinov2_bilinear":
        "sbd_dinov2_bilinear_convhead_patchembed_earlyinject_224",
    "sbd_dinov2_jbu": "sbd_dinov2_jbu_convhead_patchembed_earlyinject_224",
    "sbd_dinov2_lift": "sbd_dinov2_lift_convhead_patchembed_earlyinject_224",
    "sbd_dinov2_loftup":
        "sbd_dinov2_loftup_convhead_patchembed_earlyinject_224",
    "sbd_dinov2_simplevit":
        "sbd_dinov2_noup_convhead_simplevit_lateinject_224",
    "sbd_maskclip_noup":
        "sbd_maskclip_noup_convhead_patchembed_earlyinject_224",
    "sbd_vit_noup": "sbd_vit_noup_convhead_patchembed_earlyinject_224",
}
_NOT_PORTED = {
    "training.n_devices": "ROADMAP Queue 1 item 9 (parallel/mesh.py)",
    "training.model_parallel": "ROADMAP Queue 1 item 9 (parallel/tp.py)",
    "wandb.log_wandb": "ROADMAP Queue 1 item 6 (training: TensorBoard and "
                       "wandb)",
}
# items an epoch when epoch_len / val_epoch_len are not given: the
# Synthetic scripts' 320 and 48, SBD's whole split (-1) and 500
_EPOCH_LENS = {"synthetic": (320, 48), "sbd": (-1, 500)}
# models/defaults.py's difficulty weights, used when the file exists
SBD_SAMPLES_WEIGHTS = "./assets/sbd_samples_weights.pkl"
# configs/train_cfg.yaml's keys that apply, with its defaults
DEFAULTS: Dict[str, object] = {
    "model": None,
    "exp.name": "exp_name_test",
    "dataloader.workers": 4,
    "dataloader.batch_size": 8,
    "dataloader.val_batch_size": 8,
    "dataloader.mp": False,
    "training_params.epochs": 20,
    "training_params.crop_size": [224, 224],
    "training_params.remat_backbone": False,
    "training_params.dtype": "float32",
    "training_params.checkpoint_interval": [[0, 3], [15, 1]],
    "training_params.lr_milestones": [17, 20],
    "training_params.do_validation": True,
    "training_params.num_max_points": 24,
    "training_params.lr": 5e-5,
    "training_params.render_size": None,
    "training_params.aug_scale_range": None,
    "training.seed": 0,
    "training.n_devices": None,
    "training.model_parallel": 1,
    "training.resume_exp": None,
    "training.resume_prefix": "latest",
    "training.start_epoch": 0,
    "training.weights": None,
    "wandb.log_wandb": False,
    "DATASETS.SBD_PATH": "/data/sbd",
    "PRETRAINED_MODELS.DINOV2_VITS14": "",
    "PRETRAINED_MODELS.DINO_VITS16": "",
    "PRETRAINED_MODELS.MASKCLIP_VITB16": "",
    "epoch_len": None,
    "val_epoch_len": None,
    "exp_path": "./experiments/torch",
    "device": None,
}


def _value(text: str):
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("null", "none", "~"):
        return None
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def parse_args(argv) -> Dict:
    """``key=value`` overrides onto :data:`DEFAULTS` (YAML-like values:
    numbers, lists, true/false, null)."""
    cfg = dict(DEFAULTS)
    for arg in argv:
        key, sep, text = arg.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {arg!r}")
        if key not in cfg:
            raise ValueError(f"unknown key {key!r}; takes {sorted(cfg)}")
        cfg[key] = _value(text)
    if cfg["model"] not in MODELS:
        raise ValueError(f"model={cfg['model']}: takes one of "
                         f"{sorted(MODELS)} (models/synthetic/, "
                         "models/sbd/)")
    lens = _EPOCH_LENS[dataset_family(cfg)]
    for key, default in zip(("epoch_len", "val_epoch_len"), lens):
        if cfg[key] is None:
            cfg[key] = default
    train_dtype(cfg)
    for key, item in _NOT_PORTED.items():
        value = cfg[key]
        off = value is None or value is False or value == ""
        if key.endswith(("model_parallel", "n_devices")):
            off = off or value == 1
        if not off:
            raise NotImplementedError(f"{key}={value} is not ported to "
                                      f"isegprobe_torch.train yet: {item}")
    return cfg


def dataset_family(cfg: Dict) -> str:
    """``"synthetic"`` or ``"sbd"``: the data a script trains on."""
    return cfg["model"].split("_", 1)[0]


def train_dtype(cfg: Dict):
    """The model's compute dtype of ``training_params.dtype``: None
    (float32) or ``torch.bfloat16``; any other raises ``ValueError``, as
    ``models/common.py:init_model_from_modules_cfg`` does."""
    text = str(cfg["training_params.dtype"])
    if text in ("bfloat16", "bf16"):
        import torch

        return torch.bfloat16
    if text not in ("float32", "f32"):
        raise ValueError(f"training_params.dtype={text!r}: expected float32 "
                         "or bfloat16")
    return None


def model_kwargs(cfg: Dict) -> Dict:
    """The probe model's constructor config for a parsed command line: the
    script's (``probe_model.synthetic_config``) at the crop, with
    ``remat_blocks`` on the ``dinov2`` and ``vit`` backbones when
    ``training_params.remat_backbone`` (``models/common.py`` does the same,
    so the saved config carries it)."""
    from isegprobe_torch.models.probe_model import synthetic_config

    crop = tuple(cfg["training_params.crop_size"])
    config = synthetic_config(cfg["model"].split("_", 1)[1], crop)
    backbone = config["backbone_cfg"]
    if cfg["training_params.remat_backbone"] and backbone["type"] in (
            "dinov2", "vit"):
        config["backbone_cfg"] = dict(backbone, params=dict(
            backbone.get("params") or {}, remat_blocks=True))
    return config


def synthetic_datasets(crop_size=(224, 224), num_max_points: int = 24,
                       epoch_len: int = 320, val_epoch_len: int = 48,
                       render_size=None, aug_scale_range=None) -> Tuple:
    """``models/defaults.py:get_synthetic_train_val_datasets``: the train
    set (320 scenes, seed 17, the train augmentator) and the val set (48
    scenes, seed 999), with one shared click sampler."""
    from isegprobe_torch.data import transforms as T
    from isegprobe_torch.data.datasets import SyntheticShapesDataset
    from isegprobe_torch.data.points_sampler import MultiPointSampler

    crop = tuple(crop_size)
    render = tuple(render_size or crop)
    scale_range = tuple(aug_scale_range or (0.75, 1.25))
    train_aug = T.Compose([
        T.UniformRandomResize(scale_range=scale_range),
        T.Flip(),
        T.RandomRotate90(),
        T.PadIfNeeded(min_height=crop[0], min_width=crop[1]),
        T.RandomCrop(*crop),
        T.RandomBrightnessContrast(brightness_limit=(-0.2, 0.2),
                                   contrast_limit=(-0.1, 0.3), p=0.5),
    ], p=1.0)
    val_aug = T.Compose([
        T.PadIfNeeded(min_height=crop[0], min_width=crop[1]),
        T.RandomCrop(*crop),
    ], p=1.0)
    sampler = MultiPointSampler(num_max_points, prob_gamma=0.80,
                                merge_objects_prob=0.15,
                                max_num_merged_objects=2)
    area_scale = (render[0] * render[1]) / (224 * 224)
    trainset = SyntheticShapesDataset(
        n_samples=320, seed=17, image_size=render, augmentator=train_aug,
        min_object_area=int(80 * area_scale), keep_background_prob=0.01,
        points_sampler=sampler, epoch_len=epoch_len)
    valset = SyntheticShapesDataset(
        n_samples=48, seed=999, image_size=render, augmentator=val_aug,
        min_object_area=int(80 * area_scale), points_sampler=sampler,
        epoch_len=val_epoch_len)
    return trainset, valset


def sbd_datasets(path, crop_size=(224, 224), num_max_points: int = 24,
                 epoch_len: int = -1, val_epoch_len: int = 500) -> Tuple:
    """``models/defaults.py:get_sbd_train_val_datasets``: SBD's train split
    (the train augmentator with ``ShiftScaleRotate`` and ``RGBShift``,
    ``min_object_area=80``, ``keep_background_prob=0.01``, the difficulty
    weights of :data:`SBD_SAMPLES_WEIGHTS` with gamma 1.25 when that file
    exists) and its val split (``epoch_len=500``), with one shared click
    sampler."""
    from pathlib import Path

    from isegprobe_torch.data import transforms as T
    from isegprobe_torch.data.datasets import SBDDataset
    from isegprobe_torch.data.points_sampler import MultiPointSampler

    crop = tuple(crop_size)
    train_aug = T.Compose([
        T.UniformRandomResize(scale_range=(0.75, 1.25)),
        T.Flip(),
        T.RandomRotate90(),
        T.ShiftScaleRotate(shift_limit=0.03, scale_limit=0,
                           rotate_limit=(-3, 3), p=0.75),
        T.PadIfNeeded(min_height=crop[0], min_width=crop[1]),
        T.RandomCrop(*crop),
        T.RandomBrightnessContrast(brightness_limit=(-0.25, 0.25),
                                   contrast_limit=(-0.15, 0.4), p=0.75),
        T.RGBShift(r_shift_limit=10, g_shift_limit=10, b_shift_limit=10,
                   p=0.75),
    ], p=1.0)
    val_aug = T.Compose([
        T.UniformRandomResize(scale_range=(0.75, 1.25)),
        T.PadIfNeeded(min_height=crop[0], min_width=crop[1]),
        T.RandomCrop(*crop),
    ], p=1.0)
    sampler = MultiPointSampler(num_max_points, prob_gamma=0.80,
                                merge_objects_prob=0.15,
                                max_num_merged_objects=2)
    weights = SBD_SAMPLES_WEIGHTS if Path(SBD_SAMPLES_WEIGHTS).exists() \
        else None
    trainset = SBDDataset(path, split="train", augmentator=train_aug,
                          min_object_area=80, keep_background_prob=0.01,
                          points_sampler=sampler, samples_scores_path=weights,
                          samples_scores_gamma=1.25, epoch_len=epoch_len)
    valset = SBDDataset(path, split="val", augmentator=val_aug,
                        min_object_area=80, points_sampler=sampler,
                        epoch_len=val_epoch_len)
    return trainset, valset


def loss_cfg() -> Dict:
    """``models/defaults.py:get_loss_cfg``."""
    from isegprobe_torch.training.losses import NormalizedFocalLossSigmoid

    return {"instance_loss": NormalizedFocalLossSigmoid(alpha=0.5, gamma=2),
            "instance_loss_weight": 1.0}


def build_trainer(cfg: Dict, on_step=None, params: Optional[Dict] = None,
                  click_models=None):
    """The model, datasets, run directory and trainer of a parsed command
    line (the run's directories are the trainer's ``cfg.EXP_PATH`` and
    ``cfg.CHECKPOINTS_PATH``). ``click_models`` goes to the trainer; as in
    the JAX package, no command-line key sets it."""
    from types import SimpleNamespace

    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.training.metrics import AdaptiveIoU
    from isegprobe_torch.training.trainer import iSegTrainer
    from isegprobe_torch.utils.exp import init_experiment

    device = resolve_device(cfg["device"])
    crop = tuple(cfg["training_params.crop_size"])
    model = iSegProbeModel(**model_kwargs(cfg), device=device,
                           dtype=train_dtype(cfg))
    batch_size = cfg["dataloader.batch_size"]
    val_batch_size = cfg["dataloader.val_batch_size"]
    if dataset_family(cfg) == "sbd":
        trainset, valset = sbd_datasets(
            cfg["DATASETS.SBD_PATH"], crop,
            cfg["training_params.num_max_points"], cfg["epoch_len"],
            cfg["val_epoch_len"])
        # get_sbd_train_val_datasets' batch rule
        batch_size = 32 if batch_size < 1 else batch_size
        val_batch_size = batch_size
    else:
        trainset, valset = synthetic_datasets(
            crop, cfg["training_params.num_max_points"], cfg["epoch_len"],
            cfg["val_epoch_len"], cfg["training_params.render_size"],
            cfg["training_params.aug_scale_range"])
    run = init_experiment(cfg["exp_path"], MODELS[cfg["model"]],
                          cfg["exp.name"], cfg["training.resume_exp"],
                          cfg["training.resume_prefix"])
    tcfg = SimpleNamespace(
        dataloader=SimpleNamespace(
            batch_size=batch_size, val_batch_size=val_batch_size,
            workers=cfg["dataloader.workers"],
            mp=bool(cfg["dataloader.mp"])),
        training=SimpleNamespace(
            start_epoch=cfg["training.start_epoch"],
            weights=run["weights"] or cfg["training.weights"]),
        PRETRAINED_MODELS={
            k.split(".", 1)[1]: v for k, v in cfg.items()
            if k.startswith("PRETRAINED_MODELS.")},
        EXP_PATH=str(run["exp_path"]),
        CHECKPOINTS_PATH=str(run["checkpoints_path"]))
    lr = float(cfg["training_params.lr"])
    return iSegTrainer(
        model, tcfg, loss_cfg(), trainset, valset, optimizer="adam",
        optimizer_params={"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8},
        lr_scheduler={"milestones": cfg["training_params.lr_milestones"],
                      "gamma": 0.1},
        checkpoint_interval=[tuple(x) for x in
                             cfg["training_params.checkpoint_interval"]],
        metrics=[AdaptiveIoU()], max_num_next_clicks=3,
        click_models=click_models, seed=cfg["training.seed"], params=params,
        device=device, on_step=on_step)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    t0 = time.time()
    trainer = build_trainer(cfg)
    try:
        trainer.run(cfg["training_params.epochs"],
                    validation=cfg["training_params.do_validation"])
    finally:
        trainer.shutdown()
    print(f"trained {cfg['training_params.epochs']} epochs in "
          f"{time.time() - t0:.1f} s; checkpoints in "
          f"{trainer.cfg.CHECKPOINTS_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
