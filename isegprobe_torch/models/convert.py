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

``load_upsampler_params`` reads the frozen upsampler weights a config's
``upsampler_path`` names, and ``interpolate_pos_embed_params`` resizes a
pos-embed to the eval grid once (counterparts of the JAX package's functions
of those names).
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

__all__ = ["jax_params_to_state_dict", "load_jax_params",
           "load_upsampler_params", "interpolate_pos_embed_params"]

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


def load_upsampler_params(upsampler_cfg: Optional[Mapping]):
    """The frozen LoftUp or LiFT weights that ``upsampler_cfg["params"]
    ["upsampler_path"]`` names, as a flax param tree, or None when no path
    is configured (counterpart of ``isegprobe_tpu/models/convert.py:
    load_upsampler_params``).

    A ``.msgpack`` file (the JAX package's converted weights) is read with
    ``utils.serialization.msgpack_restore``. A raw torch checkpoint of the
    reference raises ``NotImplementedError``: its converters are not ported.
    A configured path that does not exist warns and returns None, so the
    upsampler keeps its PRNGKey(0) init; the JAX package returns None there
    without a word."""
    utype = str((upsampler_cfg or {}).get("type", "")).lower()
    uparams = (upsampler_cfg or {}).get("params") or {}
    path = uparams.get("upsampler_path")
    if not path or utype not in ("loftup", "lift"):
        return None
    p = Path(str(path))
    if not p.exists():
        warnings.warn(
            f"upsampler_path {str(path)!r} of the {utype} upsampler does not "
            "exist: the upsampler keeps its PRNGKey(0) init", stacklevel=2)
        return None
    if p.suffix == ".msgpack":
        from isegprobe_torch.utils.serialization import msgpack_restore

        return msgpack_restore(p.read_bytes())
    raise NotImplementedError(
        f"{p}: converting a reference torch checkpoint of the {utype} "
        "upsampler is not ported to isegprobe_torch yet: ROADMAP Queue 1 "
        "item 7 (the converters for reference torch checkpoints)")


def interpolate_pos_embed_params(pos_embed, old_grid, new_grid,
                                 num_extra_tokens: int = 1) -> np.ndarray:
    """The eval-time pos-embed resize: size-based bicubic, align_corners
    False, no '+0.1' offset (``isegprobe_tpu/models/convert.py:
    interpolate_pos_embed_params``). ``pos_embed``: ``[1, extra + gh*gw,
    D]``; returns float32 numpy."""
    from isegprobe_torch.ops.resize import resize

    pe = np.asarray(pos_embed, dtype=np.float32)
    (gh0, gw0), (gh, gw) = tuple(old_grid), tuple(new_grid)
    if (gh0, gw0) == (gh, gw):
        return pe
    patch = torch.from_numpy(
        np.ascontiguousarray(pe[:, num_extra_tokens:].reshape(1, gh0, gw0,
                                                              -1)))
    patch = resize(patch, (gh, gw), "bicubic", align_corners=False).numpy()
    return np.concatenate([pe[:, :num_extra_tokens],
                           patch.reshape(1, gh * gw, -1)], axis=1)
