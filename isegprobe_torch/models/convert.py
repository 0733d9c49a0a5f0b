"""Weight bridge: the JAX package's flax param trees into the port's modules.

Counterpart of ``isegprobe_tpu/models/convert.py`` in the other direction.
A param tree is nested dicts of numpy arrays (``params["backbone"]["model"]
["blocks_0"]["attn"]["qkv"]["kernel"]`` ...). The rules:

* Dense ``kernel [in, out]`` becomes Linear ``weight [out, in]``;
* conv ``kernel`` HWIO becomes ``weight`` OIHW;
* LayerNorm and FrozenBatchNorm ``scale`` becomes ``weight``;
* ``blocks_i``, ``convs_i``, ``ca_i`` and ``ff_i`` become ``blocks.i``,
  ``convs.i``, ``ca.i`` and ``ff.i``;
* ``bias``, ``cls_token``, ``pos_embed`` and ``gamma`` pass through, and so
  do the learned upsamplers' leaves: the packed attention projection
  ``in_proj_weight`` / ``in_proj_bias`` (already in torch layout),
  ``ImplicitFeaturizer.biases``, FrozenBatchNorm ``mean`` and ``var``,
  ConvNeXtLayerNorm ``weight``, and JBU's scalars ``range_temp`` and
  ``sigma_spatial``.

Loading raises on any missing or unexpected key and on any shape mismatch.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch
from torch import nn

__all__ = ["jax_params_to_state_dict", "load_jax_params"]

_INDEXED = re.compile(r"^(blocks|convs|ca|ff)_(\d+)$")
_PASS_THROUGH = ("bias", "cls_token", "pos_embed", "gamma", "weight",
                 "in_proj_weight", "in_proj_bias", "biases", "mean", "var",
                 "range_temp", "sigma_spatial")


def _leaf(path: str, key: str, value) -> tuple[str, np.ndarray]:
    a = np.asarray(value, dtype=np.float32)
    if key == "kernel":
        if a.ndim == 2:
            return "weight", a.T
        if a.ndim == 4:
            return "weight", a.transpose(3, 2, 0, 1)
        raise ValueError(f"{path}: kernel of rank {a.ndim} is neither a "
                         "Dense nor a 2-D conv kernel")
    if key == "scale":
        return "weight", a
    if key in _PASS_THROUGH:
        return key, a
    raise KeyError(f"{path}: no bridge rule for param {key!r}")


def jax_params_to_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a flax param tree into a float32 torch state dict with the
    port's names and layouts."""
    out: dict[str, torch.Tensor] = {}

    def walk(node: Mapping, prefix: list[str]) -> None:
        for key, value in node.items():
            if isinstance(value, Mapping):
                m = _INDEXED.match(key)
                walk(value, prefix + ([m[1], m[2]] if m else [key]))
            else:
                path = "/".join(prefix + [key])
                name, arr = _leaf(path, key, value)
                out[".".join(prefix + [name])] = torch.from_numpy(
                    np.array(arr, order="C"))  # a writable copy

    walk(tree, [])
    return out


def load_jax_params(module: nn.Module, tree: Mapping) -> nn.Module:
    """Copy a flax param tree into ``module`` in place (onto its device and
    into its parameter dtypes). Raises ``KeyError`` listing every missing
    and unexpected key, ``ValueError`` on a shape mismatch."""
    incoming = jax_params_to_state_dict(tree)
    own = module.state_dict()
    missing = sorted(set(own) - set(incoming))
    unexpected = sorted(set(incoming) - set(own))
    if missing or unexpected:
        raise KeyError(f"param tree does not match {type(module).__name__}: "
                       f"missing {missing}, unexpected {unexpected}")
    for name, value in incoming.items():
        if own[name].shape != value.shape:
            raise ValueError(f"{name}: shape {tuple(value.shape)} in the "
                             f"param tree, {tuple(own[name].shape)} in the "
                             "module")
    with torch.no_grad():
        for name, value in incoming.items():
            own[name].copy_(value)
    return module
