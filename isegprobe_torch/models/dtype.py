"""The compute dtype of the port's modules, by flax's rules.

A module of the JAX package computes in its ``dtype`` while its
parameters keep their own: ``nn.Dense``, ``nn.Conv`` and ``nn.LayerNorm``
cast their input (LayerNorm its output) and their kernel and bias to
``dtype`` at use, and a raw ``self.param`` that meets an activation is
not cast, so jnp promotion decides (``bf16[..., D] * f32[D]`` is f32).
Mixed-precision training builds the model with ``dtype=bfloat16`` over f32
master weights.

Here every module computes in its ``compute_dtype`` when one is set
(:func:`set_compute_dtype`, which ``iSegProbeModel(dtype=...)`` calls),
else in the dtype of its parameters, so ``model.to(torch.bfloat16)``
serves as before. :class:`Linear` and :class:`Conv2d` are ``nn.Linear`` and
``nn.Conv2d`` with flax's casts; the other modules read
:func:`compute_dtype` where flax casts. PyTorch promotes a dimensioned
f32 tensor against bf16 as jnp does; a 0-dim one it does not, so no
0-dim parameter meets an activation outside a float32 computation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["Conv2d", "Linear", "compute_dtype", "set_compute_dtype"]


def compute_dtype(module: nn.Module, param: torch.Tensor) -> torch.dtype:
    """``module``'s compute dtype: the one set on it, else ``param``'s."""
    return getattr(module, "compute_dtype", None) or param.dtype


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Set the compute dtype of ``module`` and every module inside it
    (None: the dtype of each one's parameters)."""
    for m in module.modules():
        m.compute_dtype = dtype
    return module


def _cast(t: torch.Tensor | None, dtype) -> torch.Tensor | None:
    return None if t is None else t.to(dtype)


class Linear(nn.Linear):
    """``nn.Linear`` as flax's ``nn.Dense(dtype=...)``: input, weight and
    bias cast to the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self, self.weight)
        return F.linear(x.to(dt), self.weight.to(dt), _cast(self.bias, dt))


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` (NCHW) as flax's ``nn.Conv(dtype=...)``: input, weight
    and bias cast to the compute dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = compute_dtype(self, self.weight)
        return self._conv_forward(x.to(dt), self.weight.to(dt),
                                  _cast(self.bias, dt))
