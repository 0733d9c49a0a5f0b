"""The trainer: simulated corrective clicks on the card, then a train step
of the trainable modules over a frozen backbone.

Counterpart of ``isegprobe_tpu/training/trainer.py`` on one GPU. A step
(:meth:`iSegTrainer._step`, the JAX ``_step``) normalizes the uint8 batch
on the device, runs ``num_iters`` (0 to ``max_num_next_clicks``) no-grad
forwards, each followed by a corrective click that
:func:`get_next_points_device` picks on the card (EDT through kernel C),
feeds the last probability map back as the prev mask, then runs the
forward with autograd, the loss and its backward into the trainable
parameters only, and the optimizer update. The frozen backbone and
upsampler carry ``requires_grad=False``; the gradient of the click encoder
still flows back through the frozen upsampler and every frozen block
(kernels A, B, D and E under autograd: ``ops/attention.py:
AttentionKernel`` and ``MhaKernel``, ``ops/layernorm.py:LayerNormKernel``,
``ops/jbu.py:JbuKernel``; LoftUp's slabs checkpointed where it bands its
queries). Nothing in a step reads the device: each step's
scalars are read once, one step later (the JAX trainer's deferred read),
so the host builds and uploads the next batch while the card computes.

What a run leaves behind, as the JAX trainer leaves it: TensorBoard
scalars in ``cfg.LOGS_PATH`` (``utils/log.py:SummaryWriterAvg``, windows of
``tb_dump_period``; every step ``Losses/<name>``, ``States/learning_rate``
and the metrics' ``log_states``, at each epoch ``Metrics/<name>``, after
validation ``Val/loss`` and ``Val/<name>``, at the JAX trainer's steps:
``epoch * steps an epoch + i``), read from the deferred read; and every
``image_dump_interval`` steps the image | GT | prediction panel of the
batch's first sample in ``cfg.VIS_PATH/train/<step>_instance_segmentation
.jpg`` (quality 85; positive clicks green, negative red, GT's ignored
pixels at 0.25). A dump step carries its first sample's probabilities and
points out of the step, and they join that step's deferred read: the
other steps compute and read nothing more. ``prev_mask_drop_prob`` zeroes
a sample's prev mask after the simulated clicks with that probability (a
Bernoulli a sample from the trainer's generator, drawn every step), only
in a step where at least one click ran.

Mixed precision: a model built with ``dtype=torch.bfloat16`` computes by
flax's dtype rules over float32 parameters (``models/dtype.py``), which
are the master weights: Adam's moments are float32, and checkpoints are
float32 and record no dtype, as the JAX package's. The losses reduce in
float32, the click picker takes a float32 sigmoid, and
``device_iou_stats`` reads the logits as they come (the head's, float32).
``click_models`` (param trees merged over the model's) run iteration k of
the click simulation through ``torch.func.functional_call``: the merged
leaves are the only new tensors, every other one is the model's own.
``cfg.training.weights`` merges a checkpoint over the initial params
(weights only, not the optimizer state, as the JAX trainer resumes).

Randomness: ``num_iters`` comes from ``random.Random(seed + epoch)`` (the
JAX trainer seeds the global ``random`` so); the clicks' uniform draw from
a ``torch.Generator`` on the card seeded with ``seed + 1`` (JAX draws from
``PRNGKey(seed + 1)``, so the two packages' clicks differ past the
deterministic cases); the items from the loader's per-item seeds, which
equal the JAX package's process-mode items.

Parallelism (``mesh``, ``parallel/mesh.py``): one process a device. Each
data index loads its rank-strided shard (the loader's ``rank``/``world``),
``dataloader.batch_size`` rows a rank, so the global batch is the data
ranks' rows in data order, as the JAX package assembles it. The clicks'
and the prev-mask dropout's draws are made for the global batch on every
rank, from the shared seed, and each rank keeps its rows: a step of ``D``
ranks takes the clicks a one-rank step takes on the same global batch, as
JAX's one sharded program does. After the backward the trainable
gradients are averaged over the data group in one bucketed all-reduce
before Adam, so the replicated params stay equal; the step's loss and the
IoU metric's sums are reduced over the group too (the global batch's).
``mesh.model > 1`` splits the frozen ViT blocks over the model group
(``parallel/tp.py``: kernel A runs each rank's heads). Only the master
(rank 0) writes checkpoints (the full tree, gathered from the model group
where it is split), TensorBoard scalars and image dumps; every rank joins
``reduce_loss_dict`` for the logged losses.
"""

from __future__ import annotations

import copy
import logging
import random
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from isegprobe_torch import resolve_device
from isegprobe_torch.data.loader import DataLoader
from isegprobe_torch.models.convert import (
    jax_params_to_state_dict,
    load_jax_params,
    overlay_upsampler_params,
    restrict_to_module,
    state_dict_to_jax_params,
)
from isegprobe_torch.models.init_tree import init_tree
from isegprobe_torch.models.probe_model import filter_state_dict
from isegprobe_torch.ops.edt import edt_l2sq_device
from isegprobe_torch.parallel.mesh import (
    all_reduce_mean,
    process_is_master,
    reduce_loss_dict,
)
from isegprobe_torch.training.metrics import device_iou_parts, device_iou_stats
from isegprobe_torch.training.optim import (
    make_layerwise_decay_optimizer,
    make_optimizer,
    multistep_lr,
    trainable_parameters,
)
from isegprobe_torch.utils.log import SummaryWriterAvg
from isegprobe_torch.utils.serialization import (
    load_checkpoint,
    merge_params,
    model_config,
    msgpack_restore,
    save_checkpoint,
)

__all__ = ["FROZEN_PREFIXES", "PRETRAINED_KEYS", "split_params",
           "get_next_points_device", "iSegTrainer"]

logger = logging.getLogger("isegprobe_torch")
# the backbone type -> its key of PRETRAINED_MODELS (configs/main_cfg.yaml)
PRETRAINED_KEYS = {"dinov2": "DINOV2_VITS14", "vit": "DINO_VITS16",
                   "mask_clip": "MASKCLIP_VITB16"}

FROZEN_PREFIXES = ("backbone", "upsampler")
TRAINABLE_PREFIXES = ("embed_coords", "head", "neck")


def split_params(model: torch.nn.Module,
                 frozen_prefixes: Sequence[str] = FROZEN_PREFIXES
                 ) -> Tuple[List, List]:
    """Freeze the top-level modules named in ``frozen_prefixes``
    (``requires_grad=False``) and return (trainable, frozen) parameter
    lists: the JAX ``split_params`` of the param tree."""
    trainable, frozen = [], []
    for name, p in model.named_parameters():
        is_frozen = name.split(".", 1)[0] in frozen_prefixes
        p.requires_grad_(not is_frozen)
        (frozen if is_frozen else trainable).append(p)
    return trainable, frozen


def get_next_points_device(prob: torch.Tensor, gt: torch.Tensor,
                           points: torch.Tensor, click_indx: int,
                           generator: torch.Generator,
                           pred_thresh: float = 0.49,
                           rows: Optional[Tuple[int, int]] = None
                           ) -> torch.Tensor:
    """One corrective click per sample, on the tensors' device with no host
    sync (the JAX ``get_next_points_device``): the exact EDT of the false
    negative and false positive regions (``edt_l2sq_device``,
    ``pad_border=True``: kernel C on the card), the deeper region's sign,
    a uniform draw (from ``generator``) over its pixels deeper than half
    the largest distance (``d² > max d² / 4``), written as ``(y, x,
    click_indx)`` into row ``N - click_indx`` (positive) or ``2N -
    click_indx`` (negative) of the ``[B, 2N, 3]`` points. A sample without
    error keeps its points. ``rows=(n, lo)``: the batch is rows ``[lo, lo
    + B)`` of a global batch of ``n``; the draw is made for all ``n`` and
    these rows are kept (a data-parallel rank's share).

    prob, gt: ``[B, H, W, 1]``; returns new points."""
    b = prob.shape[0]
    num_points = points.shape[1] // 2
    pred = prob[..., 0]
    gtm = gt[..., 0] > 0.5
    fn = gtm & (pred < pred_thresh)
    fp = ~gtm & (pred > pred_thresh)
    d2 = edt_l2sq_device(torch.stack([fn, fp], dim=1), pad_border=True)
    fn_max = d2[:, 0].amax(dim=(1, 2))
    fp_max = d2[:, 1].amax(dim=(1, 2))
    is_positive = fn_max > fp_max
    dt = torch.where(is_positive[:, None, None], d2[:, 0], d2[:, 1])
    max_d2 = torch.maximum(fn_max, fp_max)
    inner = (dt > (max_d2 / 4.0)[:, None, None]).reshape(b, -1)
    has_any = max_d2 > 0
    w = pred.shape[2]
    if rows is None:
        u = torch.rand(inner.shape, generator=generator, device=inner.device)
    else:
        n, lo = rows
        u = torch.rand((n, inner.shape[1]), generator=generator,
                       device=inner.device)[lo:lo + b]
    idx = torch.where(inner, u, torch.full_like(u, -1.0)).argmax(dim=1)
    new_row = torch.stack([(idx // w).to(points.dtype),
                           (idx % w).to(points.dtype),
                           torch.full_like(idx, click_indx,
                                           dtype=points.dtype)], dim=-1)
    row = torch.where(is_positive, num_points - click_indx,
                      2 * num_points - click_indx)
    lanes = torch.arange(b, device=points.device)
    out = points.clone()
    out[lanes, row] = torch.where(has_any[:, None], new_row,
                                  out[lanes, row])
    return out


def _get(cfg, path: str, default=None):
    """``cfg.a.b`` for attribute objects and dicts, ``default`` if absent."""
    node = cfg
    for part in path.split("."):
        if node is None:
            return default
        node = (node.get(part) if isinstance(node, dict)
                else getattr(node, part, None))
    return default if node is None else node


def _shapes(tree: Dict) -> Dict:
    """A param tree's names and shapes, without its values."""
    return {k: _shapes(v) if isinstance(v, dict)
            else np.broadcast_to(np.float32(0), np.shape(v))
            for k, v in tree.items()}


class iSegTrainer:
    """Epoch loop with on-card click simulation.

    Takes the JAX trainer's constructor arguments that its training of the
    probes uses. ``params`` is the param
    tree (flax names, numpy) the model is initialised with; by default
    ``init_tree(config, seed)``, the JAX trainer's ``model.init(
    PRNGKey(seed))``. Over it go, in the JAX trainer's order
    (``_load_pretrained``, then ``training.weights``): the converted
    backbone that ``cfg.PRETRAINED_MODELS`` names for the backbone's type
    (``DINOV2_VITS14`` for ``dinov2``, ``DINO_VITS16`` for ``vit``,
    ``MASKCLIP_VITB16`` for ``mask_clip``; a ``.msgpack`` of
    ``scripts/convert_weights.py``, merged under ``backbone/model``), the
    upsampler weights that the config's ``upsampler_path`` names, and the
    checkpoint of ``cfg.training.weights``. A configured file that does not
    exist warns and leaves its part as it was.
    ``click_models`` is a list of param trees (flax names, numpy, any
    subset of the model's leaves), each merged over those params: iteration
    k of the click simulation runs ``click_models[k]``, later iterations
    the live weights. ``layerwise_decay`` builds the layer-wise decay
    optimizer over every top-level module that is not frozen; with the
    backbone frozen it warns and every scale is 1, as in the JAX trainer.
    ``on_step(kind, step, num_iters)`` (optional) is
    called right after each step is dispatched (``kind`` ``"train"`` or
    ``"val"``). ``stats`` holds each training step's ``num_iters``, host
    wall seconds (from one step's start to the next's), seconds waiting for
    its batch and, on CUDA, device milliseconds (events around the step).
    ``dataloader.mp`` builds the items in spawned processes (the same
    items as threads); a model with parameters that are not
    float32 raises ``ValueError`` (the master weights are float32: build
    it with ``dtype=torch.bfloat16`` for mixed precision). ``mesh``
    (``parallel/mesh.make_mesh``) runs the trainer as one rank of a data-
    and tensor-parallel run (the module docstring) on the mesh's device;
    ``click_models`` that hold leaves of split blocks raise there."""

    def __init__(self, model, cfg, loss_cfg: Dict, trainset, valset,
                 optimizer: str = "adam",
                 optimizer_params: Optional[Dict] = None,
                 layerwise_decay: bool = False,
                 image_dump_interval: int = 200,
                 checkpoint_interval: Any = 10,
                 tb_dump_period: int = 25,
                 max_interactive_points: int = 0,
                 lr_scheduler: Optional[Dict] = None,
                 metrics: Optional[List] = None,
                 max_num_next_clicks: int = 0, click_models=None,
                 prev_mask_drop_prob: float = 0.0,
                 seed: int = -1,
                 params: Optional[Dict] = None, device=None,
                 on_step: Optional[Callable] = None, mesh=None) -> None:
        if any(p.dtype != torch.float32 for p in model.parameters()):
            raise ValueError(
                "the trainer keeps float32 master weights: build the model "
                "with float32 parameters (dtype=torch.bfloat16 computes in "
                "bf16 over them)")
        if device is None and mesh is not None:
            device = mesh.device
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        self.loss_cfg = loss_cfg
        self.max_num_next_clicks = max_num_next_clicks
        self.max_interactive_points = max_interactive_points
        self.prev_mask_drop_prob = prev_mask_drop_prob
        self.image_dump_interval = image_dump_interval
        self.tb_dump_period = tb_dump_period
        self.sw: Optional[SummaryWriterAvg] = None
        self.vis_payload = None
        self.checkpoint_interval = checkpoint_interval
        self.seed = seed if seed != -1 else 0
        self.on_step = on_step
        self.mesh = mesh
        self.is_master = process_is_master()
        shard = (dict(rank=mesh.data_index, world=mesh.data) if mesh
                 else {})

        batch_size = _get(cfg, "dataloader.batch_size")
        val_batch_size = _get(cfg, "dataloader.val_batch_size", batch_size)
        workers = int(_get(cfg, "dataloader.workers", 4))
        mp = bool(_get(cfg, "dataloader.mp", False))
        self.train_data = DataLoader(trainset, batch_size, shuffle=True,
                                     num_workers=workers, seed=self.seed,
                                     salt="train", use_processes=mp,
                                     **shard)
        self.val_data = DataLoader(valset, val_batch_size, shuffle=False,
                                   num_workers=workers, seed=self.seed,
                                   salt="val", use_processes=mp, **shard)

        self.train_metrics = list(metrics or [])
        self.val_metrics = copy.deepcopy(self.train_metrics)

        optimizer_params = dict(optimizer_params or {"lr": 5e-5})
        self.base_lr = optimizer_params.pop("lr")
        steps_per_epoch = max(1, len(self.train_data))
        milestones = (lr_scheduler or {}).get("milestones", [])
        self.lr_schedule = multistep_lr(
            self.base_lr, milestones, (lr_scheduler or {}).get("gamma", 0.1),
            steps_per_epoch)

        config = model_config(model)["params"]
        if params is None:
            params = init_tree(config, self.seed)
        params = self._load_pretrained(params, config)
        weights = _get(cfg, "training.weights")
        if weights:
            loaded, _, _ = load_checkpoint(weights)
            params = merge_params(params, loaded)
            logger.info("Loaded weights from %s", weights)
        load_jax_params(model, params)
        self._template = _shapes(params)
        if mesh is not None and mesh.model > 1:
            from isegprobe_torch.parallel.tp import shard_vit_tp

            shard_vit_tp(model, mesh)
        self._click_states = tuple(
            self._click_state(cm) for cm in (click_models or ()))
        self._trainable, _ = split_params(model)
        opt_kwargs = {k: v for k, v in optimizer_params.items()
                      if k in ("betas", "eps", "momentum", "weight_decay")}
        if layerwise_decay:
            # the backbone is frozen, so no trainable parameter has a layer
            # to decay by: the JAX trainer warns and builds the optimizer
            # over every module that is not frozen all the same
            logger.warning("layerwise_decay=True but the backbone is frozen "
                           "(not trainable): layer-wise decay changes "
                           "nothing")
            tops = tuple(n for n, _ in model.named_children()
                         if n not in FROZEN_PREFIXES)
            self.optimizer = make_layerwise_decay_optimizer(
                optimizer, model.named_parameters(), self.base_lr,
                num_layers=1, trainable_prefixes=tops, **opt_kwargs)
        else:
            self.optimizer = make_optimizer(
                optimizer, trainable_parameters(model, TRAINABLE_PREFIXES),
                self.base_lr, **opt_kwargs)
        self.num_updates = 0
        self.generator = torch.Generator(self.device).manual_seed(
            self.seed + 1)
        self._pyrandom = random.Random(self.seed)
        self.stats: Dict[str, list] = {"num_iters": [], "step_wall_s": [],
                                       "data_wait_s": [], "step_device_ms": [],
                                       "loss": []}
        self.epoch_losses: List[float] = []

    def _load_pretrained(self, params: Dict, config: Dict) -> Dict:
        """``params`` with the converted backbone of ``cfg.
        PRETRAINED_MODELS`` and the upsampler's ``upsampler_path`` weights
        overlaid (the JAX trainer's ``_load_pretrained``)."""
        key = PRETRAINED_KEYS.get(config["backbone_cfg"]["type"].lower())
        path = _get(self.cfg, f"PRETRAINED_MODELS.{key}") if key else None
        if path:
            if Path(path).exists():
                # layers the probe never calls are dropped (flax leaves
                # them unused)
                loaded = restrict_to_module(
                    msgpack_restore(Path(path).read_bytes()),
                    self.model.backbone.model)
                params = dict(params, backbone=merge_params(
                    params["backbone"], {"model": loaded}))
                logger.info("Loaded pretrained backbone from %s", path)
            else:
                warnings.warn(f"PRETRAINED_MODELS.{key}={path} does not "
                              "exist: the backbone keeps its init",
                              stacklevel=3)
        return overlay_upsampler_params(params, config.get("upsampler_cfg"))

    def _click_state(self, tree: Dict) -> Dict[str, torch.Tensor]:
        """A click model's leaves as tensors on the model's device, under
        the model's parameter names (raises on a leaf the model lacks)."""
        own = dict(self.model.named_parameters())
        state = jax_params_to_state_dict(tree)
        unknown = sorted(set(state) - set(own))
        if unknown:
            raise KeyError(f"click model leaves the model lacks: {unknown}")
        if getattr(self.model, "tp_mesh", None) is not None:
            from isegprobe_torch.parallel.tp import is_sharded

            split = sorted(k for k in state if is_sharded(k))
            if split:
                raise ValueError("click_models under tensor parallelism "
                                 f"hold leaves of split blocks: {split}")
        return {k: v.to(own[k].device, own[k].dtype)
                for k, v in state.items()}

    # -- the step ---------------------------------------------------------

    def _upload(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            out[k] = t
        return out

    def _net_input(self, images, prev):
        if getattr(self.model, "with_prev_mask", False):
            return torch.cat([images, prev], dim=-1)
        return images

    def _forward(self, images, prev, points) -> Dict:
        return self.model(self._net_input(images, prev), points)

    def _loss(self, outputs: Dict, gt: torch.Tensor):
        loss_fn = self.loss_cfg["instance_loss"]
        weight = self.loss_cfg.get("instance_loss_weight", 1.0)
        loss, aux = loss_fn(outputs["instances"].float(), gt)
        loss = loss.mean()
        total = weight * loss
        logging_out = {"instance_loss": loss, **aux}
        aux_fn = self.loss_cfg.get("instance_aux_loss")
        if aux_fn is not None and outputs.get("instances_aux") is not None:
            w = self.loss_cfg.get("instance_aux_loss_weight", 1.0)
            aux_loss = aux_fn(outputs["instances_aux"].float(), gt)[0].mean()
            total = total + w * aux_loss
            logging_out["instance_aux_loss"] = aux_loss
        return total, logging_out

    def _rows(self, b: int) -> Optional[Tuple[int, int]]:
        """This rank's rows of the global batch, ``(n, lo)`` (None without
        a mesh)."""
        if self.mesh is None:
            return None
        return b * self.mesh.data, b * self.mesh.data_index

    def _simulate_clicks(self, images, gt, points, num_iters: int):
        """``num_iters`` no-grad forwards (iteration k through
        ``click_models[k]`` where there is one), each followed by a click;
        returns (prev mask, points)."""
        rows = self._rows(images.shape[0])
        prev = torch.zeros_like(images[..., :1])
        for i in range(num_iters):
            if i < len(self._click_states):
                out = functional_call(self.model, self._click_states[i],
                                      (self._net_input(images, prev), points))
            else:
                out = self._forward(images, prev, points)
            prev = torch.sigmoid(out["instances"].float())
            points = get_next_points_device(prev, gt, points, i + 1,
                                            self.generator, rows=rows)
        if self.max_num_next_clicks > 0 and self.prev_mask_drop_prob > 0:
            b = images.shape[0]
            n, lo = rows or (b, 0)
            drop = torch.rand(n, generator=self.generator,
                              device=images.device)[lo:lo + b] \
                < self.prev_mask_drop_prob
            if num_iters > 0:
                prev = torch.where(drop[:, None, None, None],
                                   torch.zeros_like(prev), prev)
        return prev, points

    def _step(self, batch: Dict[str, torch.Tensor], num_iters: int,
              iou_thresh: float = 0.4, iou_step: float = 0.025,
              training: bool = True, vis: bool = False):
        """One step on a batch already on the device. Returns (loss,
        logging dict, (iou triplet, valid)), all tensors on the device.
        With ``vis`` the step also leaves the first sample's probabilities
        ``[H, W]`` and points ``[2N, 3]``, on the device, in
        ``self.vis_payload`` (else None)."""
        images = batch["images"]
        if not images.is_floating_point():
            images = images.float() / 255.0
        gt = batch["instances"].float()
        with torch.no_grad():
            prev, points = self._simulate_clicks(images, gt, batch["points"],
                                                 num_iters)
        if training:
            self.optimizer.zero_grad(set_to_none=True)
            outputs = self._forward(images, prev, points)
            loss, logging_out = self._loss(outputs, gt)
            loss.backward()
            if self.mesh is not None:
                all_reduce_mean([p.grad for p in self._trainable
                                 if p.grad is not None],
                                self.mesh.data_group, self.mesh.data)
            lr = self.lr_schedule(self.num_updates)
            for group in self.optimizer.param_groups:
                group["lr"] = lr * group.get("lr_scale", 1.0)
            self.optimizer.step()
            self.num_updates += 1
        else:
            with torch.no_grad():
                outputs = self._forward(images, prev, points)
                loss, logging_out = self._loss(outputs, gt)
        logging_out = {k: v.detach() for k, v in logging_out.items()}
        logging_out["overall"] = loss.detach()
        if self.mesh is not None and self.mesh.distributed:
            loss, iou = self._global_loss_and_iou(
                loss.detach(), outputs["instances"].detach(), gt, iou_thresh,
                iou_step)
        else:
            iou = device_iou_stats(outputs["instances"].detach(), gt,
                                   iou_thresh, iou_step)
        self.vis_payload = None
        if vis:
            self.vis_payload = (torch.sigmoid(
                outputs["instances"][0, ..., 0].detach().float()), points[0])
        return loss.detach(), logging_out, iou

    def _global_loss_and_iou(self, loss, logits, gt, thresh, step):
        """The global batch's loss (the data ranks' mean) and IoU triplet,
        from one all-reduce of the loss and the IoU sums over the data
        group."""
        import torch.distributed as dist

        sums, counts, n_valid = device_iou_parts(logits, gt, thresh, step)
        buf = torch.cat([loss.float()[None], sums, counts.float(),
                         n_valid.float()[None]])
        dist.all_reduce(buf, group=self.mesh.data_group)
        return (buf[0] / self.mesh.data,
                (buf[1:4] / torch.clamp(buf[4:7], min=1), buf[7] > 0))

    # -- epochs -----------------------------------------------------------

    def run(self, num_epochs: int, start_epoch: Optional[int] = None,
            validation: bool = True) -> None:
        if start_epoch is None:
            start_epoch = int(_get(self.cfg, "training.start_epoch", 0))
        for epoch in range(start_epoch, num_epochs):
            self.training(epoch)
            if validation:
                self.validation(epoch)

    def _metric_thresh(self, metrics) -> Tuple[float, float]:
        if not metrics:
            return 0.4, 0.025
        return metrics[0].iou_thresh, getattr(metrics[0], "thresh_step",
                                               0.025)

    def _ensure_writer(self) -> None:
        """The TensorBoard writer on ``cfg.LOGS_PATH`` (none without it)."""
        logs = _get(self.cfg, "LOGS_PATH")
        if self.sw is None and logs and self.is_master:
            self.sw = SummaryWriterAvg(log_dir=str(logs),
                                       dump_period=self.tb_dump_period)

    def _dump_step(self, global_step: int) -> bool:
        return (self.image_dump_interval > 0
                and global_step % self.image_dump_interval == 0)

    def training(self, epoch: int) -> None:
        self._ensure_writer()
        for metric in self.train_metrics:
            metric.reset_epoch_stats()
        self.train_data.set_epoch(epoch)
        self._pyrandom = random.Random(self.seed + epoch)
        cuda = self.device.type == "cuda"
        train_loss, n = 0.0, 0
        pending = None
        events = []
        t0 = time.time()
        data_it = iter(self.train_data)
        t_wait = time.time()
        nxt = next(data_it, None)
        waited = time.time() - t_wait
        step_start = None
        steps_per_epoch = len(self.train_data)
        i = -1
        while nxt is not None:
            i += 1
            global_step = epoch * steps_per_epoch + i
            now = time.time()
            if step_start is not None:
                self.stats["step_wall_s"].append(now - step_start)
            step_start = now
            self.stats["data_wait_s"].append(waited)
            batch = self._upload(nxt)
            num_iters = self._pyrandom.randint(0, self.max_num_next_clicks)
            self.stats["num_iters"].append(num_iters)
            thr, step = self._metric_thresh(self.train_metrics)
            if cuda:
                ev = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
                ev[0].record()
            result = self._step(batch, num_iters, thr, step, training=True,
                                vis=self._dump_step(global_step))
            if cuda:
                ev[1].record()
                events.append(ev)
            if self.on_step is not None:
                self.on_step("train", self.num_updates - 1, num_iters)
            # the next batch is built and uploaded while the card computes
            batch_np = nxt
            t_wait = time.time()
            nxt = next(data_it, None)
            waited = time.time() - t_wait
            if pending is not None:
                train_loss += self._finish_train_step(*pending)
                n += 1
            pending = (global_step, batch_np, *result, self.vis_payload)
        if pending is not None:
            train_loss += self._finish_train_step(*pending)
            n += 1
            self.stats["step_wall_s"].append(time.time() - step_start)
        if cuda:
            torch.cuda.synchronize(self.device)
            self.stats["step_device_ms"] += [a.elapsed_time(b)
                                             for a, b in events]
        elapsed = time.time() - t0
        self.epoch_losses.append(train_loss / max(n, 1))
        logger.info("Epoch %d: train loss %.4f (%.1fs, %.3f s/step)", epoch,
                    train_loss / max(n, 1), elapsed, elapsed / max(n, 1))
        if self.sw is not None:
            for m in self.train_metrics:
                self.sw.add_scalar(f"Metrics/{m.name}", m.get_epoch_value(),
                                   epoch)
        self.save_checkpoint(epoch)

    def _finish_train_step(self, global_step, batch_np, loss, logging_out,
                           iou, vis) -> float:
        """Read one step's scalars (one transfer, with the dump's payload
        on a dump step), log them and update the metrics."""
        names = list(logging_out)
        host = torch.stack([loss, iou[1].float(), *iou[0],
                            *(logging_out[k].float() for k in names)]
                           ).cpu().numpy()
        # every rank joins the mean over processes (the JAX trainer's
        # reduce_loss_dict); nothing happens in a world of one
        logged = reduce_loss_dict(
            {k: float(v) for k, v in zip(names, host[5:])})
        if self.sw is not None:
            for k, v in logged.items():
                self.sw.add_scalar(f"Losses/{k}", float(v), global_step)
            self.sw.add_scalar("States/learning_rate",
                               float(self.lr_schedule(global_step)),
                               global_step)
            for m in self.train_metrics:
                m.log_states(self.sw, f"Metrics/{m.name}", global_step)
        if vis is not None and self.is_master:
            self.save_visualization(batch_np, vis, global_step,
                                    prefix="train")
        for m in self.train_metrics:
            m.update_from_stats(host[2:5], bool(host[1]))
        self.stats["loss"].append(float(host[0]))
        return float(host[0])

    def save_visualization(self, batch_np: Dict[str, np.ndarray], vis,
                           global_step: int, prefix: str) -> Path:
        """The image | GT | prediction panel of the batch's first sample,
        ``<VIS_PATH>/<prefix>/<step>_instance_segmentation.jpg`` at quality
        85 (the JAX ``save_visualization``); returns its path."""
        from isegprobe_torch.data.image_io import write_jpeg
        from isegprobe_torch.utils.viz import draw_points, draw_probmap

        vis_dir = Path(_get(self.cfg, "VIS_PATH", "./vis")) / prefix
        vis_dir.mkdir(parents=True, exist_ok=True)
        probs, points = (t.cpu().numpy() for t in vis)
        images = batch_np["images"]
        image = np.asarray(images[0], dtype=np.float32)
        if not np.issubdtype(images.dtype, np.integer):
            image = image * 255.0
        gt = np.asarray(batch_np["instances"][0, ..., 0], dtype=np.float32)
        gt[gt < 0] = 0.25
        n_pos = self.max_interactive_points or points.shape[0] // 2
        panel_img = draw_points(image, points[:n_pos], (0, 255, 0))
        panel_img = draw_points(panel_img, points[n_pos:], (255, 0, 0))
        panel = np.hstack([np.clip(panel_img, 0, 255).astype(np.uint8),
                           draw_probmap(gt),
                           draw_probmap(np.asarray(probs, np.float32))])
        path = vis_dir / f"{global_step:06d}_instance_segmentation.jpg"
        write_jpeg(path, panel, quality=85)
        return path

    def validation(self, epoch: int) -> None:
        for metric in self.val_metrics:
            metric.reset_epoch_stats()
        val_loss, count = 0.0, 0
        for batch_np in self.val_data:
            batch = self._upload(batch_np)
            num_iters = self._pyrandom.randint(0, self.max_num_next_clicks)
            thr, step = self._metric_thresh(self.val_metrics)
            loss, _, iou = self._step(batch, num_iters, thr, step,
                                      training=False)
            if self.on_step is not None:
                self.on_step("val", count, num_iters)
            host = torch.stack([loss, iou[1].float(), *iou[0]]).cpu().numpy()
            val_loss += float(host[0])
            count += 1
            for m in self.val_metrics:
                m.update_from_stats(host[2:], bool(host[1]))
        if count:
            self.val_loss = val_loss / count
            logger.info("Epoch %d: val loss %.4f", epoch, self.val_loss)
            if self.sw is not None:
                self.sw.add_scalar("Val/loss", self.val_loss, epoch)
                for m in self.val_metrics:
                    self.sw.add_scalar(f"Val/{m.name}", m.get_epoch_value(),
                                       epoch)

    # -- checkpoints ------------------------------------------------------

    def full_params(self, tops: Optional[Sequence[str]] = None) -> Dict:
        """The model's params as a flax-named numpy tree (the top-level
        subtrees in ``tops``, or all). Under tensor parallelism the split
        blocks are gathered from the model group when ``tops`` takes the
        backbone (every rank of the group must call it then)."""
        template = self._template if tops is None else {
            k: v for k, v in self._template.items() if k in tops}
        state = self.model.state_dict()
        if getattr(self.model, "tp_mesh", None) is not None and \
                "backbone" in template:
            from isegprobe_torch.parallel.tp import full_state_dict

            state = full_state_dict(self.model)
        return state_dict_to_jax_params(state, template)

    def save_checkpoint(self, epoch: Optional[int] = None) -> None:
        """``last_checkpoint.ckpt`` and the interval-scheduled epoch
        checkpoints, filtered by the model's ``save_cfg``, in the JAX
        package's format. Every rank calls it; the master writes."""
        ckpt_dir = Path(_get(self.cfg, "CHECKPOINTS_PATH", "./checkpoints"))
        save_cfg = getattr(self.model, "save_cfg", None)
        tops = list(filter_state_dict(self._template, save_cfg))
        filtered = filter_state_dict(self.full_params(tops), save_cfg)
        if not self.is_master:
            return
        config = model_config(self.model)
        extra = {"epoch": epoch}
        save_checkpoint(filtered, config, ckpt_dir / "last_checkpoint.ckpt",
                        extra)
        if epoch is not None and self._scheduled_epoch(epoch):
            save_checkpoint(filtered, config, ckpt_dir / f"{epoch:03d}.ckpt",
                            extra)

    def _scheduled_epoch(self, epoch: int) -> bool:
        ci = self.checkpoint_interval
        if isinstance(ci, (int, float)):
            return (epoch + 1) % int(ci) == 0
        result = False
        for start, every in ci:
            if epoch >= start:
                result = (epoch + 1) % every == 0
        return result

    def shutdown(self) -> None:
        self.train_data.shutdown()
        self.val_data.shutdown()
        if self.sw is not None:
            self.sw.close()
            self.sw = None
