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

Keys: the settings start, as the root's do, from
``configs/train_cfg.yaml`` read at the working directory
(``utils/config.py``; the port needs no YAML package), with the overrides
typed as the root's ``load_config`` types them (``exp.name``,
``dataloader.*``, ``training_params.*``, ``training.*``, ``wandb.*``;
``exp.model_path=models/<script>.py`` names a script as ``model`` does);
``DATASETS.SBD_PATH`` and
``PRETRAINED_MODELS.{DINOV2_VITS14,DINO_VITS16,MASKCLIP_VITB16}`` come from
the ``main_cfg.yaml`` the root finds for the script (``configs/``), and a
key on the command line wins; a key that neither file nor the port knows
raises (the root ignores it). The port's own keys are ``model``,
``device``, ``exp_path``, ``training_params.lr`` /
``render_size`` / ``aug_scale_range`` and ``epoch_len`` /
``val_epoch_len`` (items an epoch; by default the script's: 320 and 48 for
the Synthetic scenes, the whole split and 500 for SBD). A run goes to
``<exp_path>/<script's directory under models/>/<script stem>/
<NNN>_<exp.name>/`` (for example ``synthetic/dinov2_noup/000_run`` or
``sbd/dinov2/patch-embed_noup/000_run``), the path and numbering the JAX
package gives a run of the same script (``utils/exp.py``), with
``checkpoints/``, ``logs/`` (``train.log`` and the TensorBoard events),
``vis/train/`` (the image dumps) and a copy of the JAX model script.

- ``image_dump_interval`` (300, the scripts' ``models/common.py``): every
  that many steps the trainer writes the image | GT | prediction panel of
  the batch's first sample to ``vis/train/<step>_instance_segmentation.jpg``
  (0 writes none); ``tb_dump_period`` (25): the window of the averaged
  TensorBoard scalars; ``prev_mask_drop_prob`` (0): the chance a sample's
  prev mask is zeroed after its simulated clicks.
- ``wandb.log_wandb=true`` (``wandb.project``, ``wandb.name``,
  ``wandb.dir``): a W&B run synced from the TensorBoard events, as the JAX
  package starts one; without the ``wandb`` package it warns and trains
  on.

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

- Several processes (``parallel/mesh.py``; one a GPU, each on
  ``cuda:<local rank>``): launch one command a process with
  ``ISEG_COORDINATOR=host:port ISEG_NUM_PROCESSES=N ISEG_PROCESS_ID=i``,
  or through torchrun with ``ISEG_DISTRIBUTED=auto`` (``torchrun
  --nproc_per_node=N -m isegprobe_torch.train ...``). ``main`` joins the
  group (NCCL on GPUs, gloo with ``device=cpu``) before any device use,
  as the root ``train.py`` does. ``training.n_devices`` (by default the
  world) must be the number of processes; ``training.model_parallel``
  (1) ranks of it form the model axis: the frozen ViT blocks are split
  over them (Megatron, ``parallel/tp.py``), the rest is data parallel
  with ``dataloader.batch_size`` rows a rank. Rank 0 writes the run's
  files.

A key or a model that is not known raises ``ValueError``, as does a
``training.model_parallel`` that does not divide the devices.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Tuple

from isegprobe_torch import resolve_device
from isegprobe_torch.utils.config import (
    _parse_value,
    apply_overrides,
    find_main_config,
    load_yaml,
)
from isegprobe_torch.utils.main_cfg import flatten, read_main_cfg

__all__ = ["DEFAULTS", "MODELS", "MODEL_SCRIPTS", "parse_args", "train_dtype",
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
# model= key -> its script under the repository's models/ (its runs go
# where the JAX package puts the script's runs; the script is copied, not
# imported)
MODEL_SCRIPTS = {
    "synthetic_dinov2_noup": "synthetic/dinov2_noup.py",
    "synthetic_dinov2_loftup": "synthetic/dinov2_loftup.py",
    "synthetic_dinov2_jbu": "synthetic/dinov2_jbu.py",
    "synthetic_dinov2_lift": "synthetic/dinov2_lift.py",
    "synthetic_dinov2_simplevit": "synthetic/dinov2_simplevit.py",
    "synthetic_vit_noup": "synthetic/vit_noup.py",
    "synthetic_maskclip_noup": "synthetic/maskclip_noup.py",
    "sbd_dinov2_noup": "sbd/dinov2/patch-embed_noup.py",
    "sbd_dinov2_bilinear": "sbd/dinov2/patch-embed_bilinear.py",
    "sbd_dinov2_jbu": "sbd/dinov2/patch-embed_jbu.py",
    "sbd_dinov2_lift": "sbd/dinov2/patch-embed_lift.py",
    "sbd_dinov2_loftup": "sbd/dinov2/patch-embed_loftup.py",
    "sbd_dinov2_simplevit": "sbd/dinov2/simple-vit_noup.py",
    "sbd_maskclip_noup": "sbd/maskclip/patch-embed_noup.py",
    "sbd_vit_noup": "sbd/vit/patch-embed_noup.py",
}
MODELS_DIR = Path(__file__).resolve().parents[1] / "models"
# items an epoch when epoch_len / val_epoch_len are not given: the
# Synthetic scripts' 320 and 48, SBD's whole split (-1) and 500
_EPOCH_LENS = {"synthetic": (320, 48), "sbd": (-1, 500)}
# models/defaults.py's difficulty weights, used when the file exists
SBD_SAMPLES_WEIGHTS = "./assets/sbd_samples_weights.pkl"
# the root's settings file, read at the working directory as the root
# reads it
TRAIN_CFG = "configs/train_cfg.yaml"
# the keys configs/train_cfg.yaml lacks, with their defaults: the machine
# paths the root takes from configs/main_cfg.yaml (read here too) and the
# port's own
DEFAULTS: Dict[str, object] = {
    "model": None,
    "training_params.lr": 5e-5,
    "training_params.render_size": None,
    "training_params.aug_scale_range": None,
    "DATASETS.SBD_PATH": "/data/sbd",
    "PRETRAINED_MODELS.DINOV2_VITS14": "",
    "PRETRAINED_MODELS.DINO_VITS16": "",
    "PRETRAINED_MODELS.MASKCLIP_VITB16": "",
    "epoch_len": None,
    "val_epoch_len": None,
    "exp_path": "./experiments/torch",
    "device": None,
    "image_dump_interval": 300,
    "tb_dump_period": 25,
    "prev_mask_drop_prob": 0.0,
}
# the keys the machine-paths file gives
_MAIN_CFG_KEYS = ("DATASETS.SBD_PATH", "PRETRAINED_MODELS.DINOV2_VITS14",
                  "PRETRAINED_MODELS.DINO_VITS16",
                  "PRETRAINED_MODELS.MASKCLIP_VITB16")


def _script_model(model_path) -> Optional[str]:
    """The ``model`` key of a root ``exp.model_path`` (``models/<script>``),
    or None."""
    parts = Path(str(model_path)).parts
    if "models" not in parts:
        return None
    rel = "/".join(parts[len(parts) - parts[::-1].index("models"):])
    return {v: k for k, v in MODEL_SCRIPTS.items()}.get(rel)


def parse_args(argv) -> Dict:
    """The run's settings by dotted key: ``configs/train_cfg.yaml`` (at the
    working directory) with the ``key=value`` overrides, typed as the
    root's ``load_config`` types them, the machine paths of the
    ``main_cfg.yaml`` that the root finds for the script
    (``find_main_config``), and :data:`DEFAULTS` for the keys the files
    lack; the command line wins. ``model`` names the script, or the root's
    ``exp.model_path=models/<script>.py`` does."""
    root = load_yaml(TRAIN_CFG)
    keys = flatten(root)
    file_args, extra, given = [], {}, set()
    for arg in argv:
        key, sep, text = arg.partition("=")
        if not sep:
            raise ValueError(f"expected key=value, got {arg!r}")
        if key in keys:
            file_args.append(arg)
        elif key in DEFAULTS:
            extra[key] = _parse_value(text)
        else:
            raise ValueError(f"unknown key {key!r}; takes "
                             f"{sorted([*keys, *DEFAULTS])}")
        given.add(key)
    cfg = {**DEFAULTS, **flatten(apply_overrides(root, file_args)), **extra}
    if cfg["model"] is None:
        cfg["model"] = _script_model(cfg["exp.model_path"])
    if cfg["model"] in MODEL_SCRIPTS:
        cfg["exp.model_path"] = f"models/{MODEL_SCRIPTS[cfg['model']]}"
        main_cfg = (find_main_config(Path(cfg["exp.model_path"]).parent)
                    or find_main_config("."))
        machine = read_main_cfg(main_cfg) if main_cfg else {}
        for key in _MAIN_CFG_KEYS:
            if key in machine and key not in given:
                cfg[key] = machine[key]
    if cfg["model"] not in MODELS:
        raise ValueError(f"model={cfg['model']}: takes one of "
                         f"{sorted(MODELS)} (models/synthetic/, "
                         "models/sbd/)")
    lens = _EPOCH_LENS[dataset_family(cfg)]
    for key, default in zip(("epoch_len", "val_epoch_len"), lens):
        if cfg[key] is None:
            cfg[key] = default
    train_dtype(cfg)
    mp = cfg["training.model_parallel"]
    mp = 1 if mp is None else mp
    n = cfg["training.n_devices"]
    if not isinstance(mp, int) or mp < 1 or (n and n % mp):
        raise ValueError(f"training.model_parallel={mp} must be a positive "
                         f"integer that divides training.n_devices={n}")
    cfg["training.model_parallel"] = mp
    return cfg


def make_run_mesh(cfg: Dict):
    """The run's mesh (``parallel/mesh.make_mesh``): over the process group
    when one was joined, or when ``training.n_devices`` or
    ``training.model_parallel`` ask for more than one device (which then
    raises: one process a device); None for a plain one-device run."""
    import torch.distributed as dist

    from isegprobe_torch.parallel.mesh import make_mesh

    n = cfg["training.n_devices"]
    mp = cfg["training.model_parallel"]
    if not dist.is_initialized() and not (n and n > 1) and mp == 1:
        return None
    return make_mesh(n_devices=n or None, model_parallel=mp,
                     device=cfg["device"])


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
                  click_models=None, mesh=None):
    """The model, datasets, run directory and trainer of a parsed command
    line (the run's directories are the trainer's ``cfg.EXP_PATH``,
    ``cfg.CHECKPOINTS_PATH``, ``cfg.VIS_PATH`` and ``cfg.LOGS_PATH``; the
    W&B run starts here when asked for). ``click_models`` goes to the
    trainer; as in the JAX package, no command-line key sets it. ``mesh``
    (:func:`make_run_mesh`) makes the trainer one rank of a parallel run,
    on the mesh's device."""
    from types import SimpleNamespace

    from isegprobe_torch.models.probe_model import iSegProbeModel
    from isegprobe_torch.training.metrics import AdaptiveIoU
    from isegprobe_torch.training.trainer import iSegTrainer
    from isegprobe_torch.utils.exp import init_experiment
    from isegprobe_torch.utils.log import init_wandb

    device = resolve_device(mesh.device if mesh is not None
                            else cfg["device"])
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
    run = init_experiment(cfg["exp_path"],
                          MODELS_DIR / MODEL_SCRIPTS[cfg["model"]],
                          cfg["exp.name"], cfg["training.resume_exp"],
                          cfg["training.resume_prefix"])
    if mesh is None or mesh.rank == 0:
        init_wandb(cfg, run["logs_path"])
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
        CHECKPOINTS_PATH=str(run["checkpoints_path"]),
        VIS_PATH=str(run["vis_path"]), LOGS_PATH=str(run["logs_path"]))
    lr = float(cfg["training_params.lr"])
    return iSegTrainer(
        model, tcfg, loss_cfg(), trainset, valset, optimizer="adam",
        optimizer_params={"lr": lr, "betas": (0.9, 0.999), "eps": 1e-8},
        lr_scheduler={"milestones": cfg["training_params.lr_milestones"],
                      "gamma": 0.1},
        checkpoint_interval=[tuple(x) for x in
                             cfg["training_params.checkpoint_interval"]],
        image_dump_interval=int(cfg["image_dump_interval"]),
        tb_dump_period=int(cfg["tb_dump_period"]),
        max_interactive_points=cfg["training_params.num_max_points"],
        metrics=[AdaptiveIoU()], max_num_next_clicks=3,
        click_models=click_models,
        prev_mask_drop_prob=float(cfg["prev_mask_drop_prob"]),
        seed=cfg["training.seed"], params=params, device=device,
        on_step=on_step, mesh=mesh)


def main(argv=None) -> int:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    cfg = parse_args(sys.argv[1:] if argv is None else argv)
    from isegprobe_torch.parallel.mesh import maybe_init_distributed

    # before any device use, as the root train.py does
    joined = maybe_init_distributed(
        backend="gloo" if cfg["device"] == "cpu" else None)
    t0 = time.time()
    try:
        trainer = build_trainer(cfg, mesh=make_run_mesh(cfg))
        try:
            trainer.run(cfg["training_params.epochs"],
                        validation=cfg["training_params.do_validation"])
        finally:
            trainer.shutdown()
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()
    print(f"trained {cfg['training_params.epochs']} epochs in "
          f"{time.time() - t0:.1f} s; checkpoints in "
          f"{trainer.cfg.CHECKPOINTS_PATH}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
