"""The backward shared by the ``torch.autograd.Function`` of kernels A, D
and E and of the int8 layer.

Those kernels run forward only. Under autograd each runs inside a Function
whose backward recomputes the kernel's plain PyTorch version and returns
its VJP, as the JAX package's ``custom_vjp`` wrappers recompute their jnp /
XLA forms under ``jax.vjp``. Kernel B has a backward kernel of its own
(``ops/layernorm.py``).
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

__all__ = ["plain_vjp"]


def plain_vjp(plain: Callable, saved: Sequence[torch.Tensor],
              needs: Sequence[bool], grad: torch.Tensor, *args) -> tuple:
    """The VJP of ``plain(*saved, *args)`` at ``grad``: one gradient for
    each tensor of ``saved`` whose flag in ``needs`` is set, None for the
    others, recomputed with grad mode on."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(saved, needs)]
    wanted = [t for t in inputs if t.requires_grad]
    with torch.enable_grad():
        out = plain(*inputs, *args)
        grads = iter(torch.autograd.grad(out, wanted, grad))
    return tuple(next(grads) if t.requires_grad else None for t in inputs)
