"""Optimizers and the learning-rate schedule of the trainer.

Counterpart of ``isegprobe_tpu/training/optim.py``. The JAX package hands
optax the whole param tree and zero-masks the frozen subtrees; here the
optimizer holds the parameters of the trainable top-level modules only
(``embed_coords``, ``head`` and ``neck`` by default), and the frozen ones
carry ``requires_grad=False``. ``multistep_lr`` is optax's
``piecewise_constant_schedule`` over epoch milestones, as a function of the
number of updates done.
"""

from __future__ import annotations

from typing import Callable, Sequence, Tuple

import torch
from torch import nn

__all__ = ["TRAINABLE_PREFIXES_DEFAULT", "make_optimizer", "multistep_lr",
           "trainable_parameters"]

TRAINABLE_PREFIXES_DEFAULT = ("embed_coords", "head", "neck")
_LAYERWISE = "ROADMAP Queue 1 item 6 (training: layer-wise decay)"


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
                   eps: float = 1e-8, momentum: float = 0.9,
                   layerwise_decay: bool = False) -> torch.optim.Optimizer:
    """``sgd``, ``adam`` or ``adamw`` over ``params`` (the trainable ones:
    :func:`trainable_parameters`), with optax's semantics: SGD with plain
    momentum, Adam with eps outside the square root, AdamW with decoupled
    weight decay. The learning rate is set per step by the caller from
    :func:`multistep_lr`."""
    if layerwise_decay:
        raise NotImplementedError(
            f"layer-wise learning-rate decay is not ported to "
            f"isegprobe_torch yet: {_LAYERWISE}")
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
