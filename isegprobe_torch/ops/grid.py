"""Evenly spaced coordinates computed with the float32 arithmetic of the
JAX package's compiled ``jnp.linspace``.

``torch.linspace`` rounds differently from ``jnp.linspace`` in the last
bit, and LoftUp's Fourier features multiply these coordinates by
frequencies up to e^10, where one ulp of a coordinate moves a phase by
~1e-3 rad. The port therefore builds them as XLA compiles
``jnp.linspace`` inside a jitted forward: ``start·(1 − s) + stop·s`` with
``s = i·(1/div)`` in float32, and ``stop`` appended (bit-equal for the
symmetric grids in [-1, 1]). Computed on ``device`` by kernels, with no
host copy.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["linspace"]


def linspace(start: float, stop: float, num: int,
             device=None) -> torch.Tensor:
    """float32 ``[num]`` tensor equal to ``jnp.linspace(start, stop, num)``
    as a jitted JAX forward computes it."""
    if num == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    div = num - 1
    recip = float(np.float32(1.0) / np.float32(div))  # an exact f32 value
    step = torch.arange(div, dtype=torch.float32, device=device) * recip
    out = start * (1.0 - step) + stop * step
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])
