"""Optimizers and the learning-rate schedule of the trainer.

Counterpart of ``isegprobe_tpu/training/optim.py``. The JAX package hands
optax the whole param tree and zero-masks the frozen subtrees; here the
optimizer holds the parameters of the trainable top-level modules only
(``embed_coords``, ``head`` and ``neck`` by default), and the frozen ones
carry ``requires_grad=False``. ``multistep_lr`` is optax's
``piecewise_constant_schedule`` over epoch milestones, as a function of the
number of updates done. Layer-wise decay (the BEiT scheme: layer 0 the
patch embedding, cls token and pos-embed, layers 1..D the blocks, D+1
everything else) gives each parameter group an ``lr_scale``
``layer_decay^(D+1-layer)``, by which the caller multiplies the scheduled
learning rate: optax's chain scales the whole update, its weight decay
included, and so does a group's learning rate.
"""

from __future__ import annotations

import re
from typing import Callable, Iterable, Sequence, Tuple

import torch
from torch import nn

__all__ = ["TRAINABLE_PREFIXES_DEFAULT", "make_layerwise_decay_optimizer",
           "make_optimizer", "multistep_lr", "trainable_parameters",
           "vit_layer_id"]

TRAINABLE_PREFIXES_DEFAULT = ("embed_coords", "head", "neck")


def trainable_parameters(model: nn.Module,
                         trainable_prefixes: Sequence[str]
                         = TRAINABLE_PREFIXES_DEFAULT) -> list:
    """The parameters of ``model``'s top-level modules named in
    ``trainable_prefixes``, in ``named_parameters`` order."""
    return [p for name, p in model.named_parameters()
            if name.split(".", 1)[0] in trainable_prefixes]


def make_optimizer(opt_name: str, params, lr: float,
                   weight_decay: float = 0.0,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   eps: float = 1e-8, momentum: float = 0.9
                   ) -> torch.optim.Optimizer:
    """``sgd``, ``adam`` or ``adamw`` over ``params`` (the trainable ones,
    :func:`trainable_parameters`, or parameter groups), with optax's
    semantics: SGD with plain momentum, Adam with eps outside the square
    root, AdamW with decoupled weight decay. The learning rate is set per
    step by the caller from :func:`multistep_lr`."""
    params = list(params)
    name = opt_name.lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=momentum)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=tuple(betas), eps=eps)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=tuple(betas), eps=eps,
                                 weight_decay=weight_decay)
    raise ValueError(f"Unknown optimizer: {opt_name}")


def vit_layer_id(name: str, num_layers: int) -> int:
    """The BEiT layer of a backbone parameter by its name inside the
    backbone (``blocks.i`` or flax's ``blocks_i``): 0 for the patch
    embedding, cls token and pos-embed, i + 1 for block i, ``num_layers``
    for the rest."""
    if any(k in name for k in ("cls_token", "pos_embed", "patch_embed")):
        return 0
    m = re.search(r"blocks[._](\d+)", name)
    return int(m.group(1)) + 1 if m else num_layers


def make_layerwise_decay_optimizer(
        opt_name: str, named_params: Iterable[Tuple[str, nn.Parameter]],
        lr: float, num_layers: int, layer_decay: float = 0.75,
        weight_decay: float = 0.02,
        trainable_prefixes: Sequence[str] = TRAINABLE_PREFIXES_DEFAULT
        + ("backbone",), **kwargs) -> torch.optim.Optimizer:
    """:func:`make_optimizer` over the parameters of ``named_params``
    (``model.named_parameters()``) whose top-level module is in
    ``trainable_prefixes``, one group per learning-rate scale: a
    ``backbone`` parameter's is ``layer_decay^(num_layers + 1 -
    vit_layer_id)``, every other's 1. The JAX package's
    ``make_layerwise_decay_optimizer``."""
    groups: dict = {}
    for name, p in named_params:
        top, _, rest = name.partition(".")
        if top not in trainable_prefixes:
            continue
        scale = (layer_decay ** (num_layers + 1
                                 - vit_layer_id(rest, num_layers))
                 if top == "backbone" else 1.0)
        groups.setdefault(scale, []).append(p)
    return make_optimizer(
        opt_name, [{"params": ps, "lr_scale": s, "lr": lr * s}
                   for s, ps in groups.items()],
        lr, weight_decay=weight_decay, **kwargs)


def multistep_lr(base_lr: float, milestones: Sequence[int], gamma: float,
                 steps_per_epoch: int) -> Callable[[int], float]:
    """``lr(step)``: ``base_lr`` times ``gamma`` for every milestone epoch
    whose first step ``step`` has reached (torch's ``MultiStepLR`` over
    steps; optax's ``piecewise_constant_schedule`` in the JAX package)."""
    boundaries = sorted(int(m * steps_per_epoch) for m in milestones)

    def lr(step: int) -> float:
        value = base_lr
        for b in boundaries:
            if step >= b:
                value *= gamma
        return value

    return lr
