"""Weight bridge: the JAX package's flax param trees into the port's modules.

Counterpart of ``isegprobe_tpu/models/convert.py`` in the other direction.
A param tree is nested dicts of numpy arrays (``params["backbone"]["model"]
["blocks_0"]["attn"]["qkv"]["kernel"]`` ...). The rules:

* Dense ``kernel [in, out]`` becomes Linear ``weight [out, in]``;
* conv ``kernel`` HWIO becomes ``weight`` OIHW;
* LayerNorm and FrozenBatchNorm ``scale`` becomes ``weight``, and so does
  the RITM maps transform's ``ScaleLayer`` ``scale`` ``[1]``
  (``maps_transform/scale/scale`` becomes ``maps_transform.scale.weight``);
* ``blocks_i``, ``convs_i``, ``ca_i``, ``ff_i``, ``attn_i`` (SimpleViT)
  and ``resblocks_i`` (CLIP) become ``blocks.i``, ``convs.i``, ``ca.i``,
  ``ff.i``, ``attn.i`` and ``resblocks.i``;
* ``bias``, ``cls_token``, ``pos_embed`` and ``gamma`` pass through, and so
  do the packed attention projection ``in_proj_weight`` / ``in_proj_bias``
  of CLIP and LoftUp (already in torch layout), CLIP's
  ``class_embedding``, ``positional_embedding`` and right-multiplied
  ``proj`` ``[width, out]``, ``ImplicitFeaturizer.biases``, FrozenBatchNorm
  ``mean`` and ``var``, ConvNeXtLayerNorm ``weight``, and JBU's scalars
  ``range_temp`` and ``sigma_spatial``. A bias-free conv (CLIP's ``conv1``)
  has no ``bias``, and LiFT's 2x2 transposed-conv kernel ``[2, 2, cin, f]``
  takes the conv rule into ``[f, cin, 2, 2]``.

Loading raises on any missing or unexpected key and on any shape mismatch.
:func:`state_dict_to_jax_params` runs the bridge the other way, onto the
names and layouts of a template param tree (the trainer's checkpoints).

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

__all__ = ["jax_params_to_state_dict", "state_dict_to_jax_params",
           "load_jax_params",
           "load_upsampler_params", "overlay_upsampler_params",
           "interpolate_pos_embed_params"]

_INDEXED = re.compile(r"^(blocks|convs|ca|ff|attn|resblocks)_(\d+)$")
_PASS_THROUGH = ("bias", "cls_token", "pos_embed", "gamma", "weight",
                 "in_proj_weight", "in_proj_bias", "biases", "mean", "var",
                 "range_temp", "sigma_spatial", "class_embedding",
                 "positional_embedding", "proj")


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


def _leaves(tree: Mapping):
    """(flax path, port prefix, key, leaf) of every leaf of a param tree."""
    def walk(node: Mapping, path: tuple, prefix: list):
        for key, value in node.items():
            if isinstance(value, Mapping):
                m = _INDEXED.match(key)
                yield from walk(value, path + (key,),
                                prefix + ([m[1], m[2]] if m else [key]))
            else:
                yield path + (key,), prefix, key, value

    yield from walk(tree, (), [])


def jax_params_to_state_dict(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flatten a flax param tree into a float32 torch state dict with the
    port's names and layouts."""
    out: dict[str, torch.Tensor] = {}
    for path, prefix, key, value in _leaves(tree):
        name, arr = _leaf("/".join(path), key, value)
        out[".".join(prefix + [name])] = torch.from_numpy(
            np.array(arr, order="C"))  # a writable copy
    return out


def state_dict_to_jax_params(state_dict: Mapping, template: Mapping) -> dict:
    """The inverse of :func:`jax_params_to_state_dict` for the leaves of
    ``template`` (a flax param tree whose values give only the names and
    shapes): a nested dict of float32 numpy arrays in flax's layouts, read
    from the port's ``state_dict``. Raises ``KeyError`` on a leaf the state
    dict lacks and ``ValueError`` on a shape mismatch."""
    out: dict = {}
    for path, prefix, key, value in _leaves(template):
        name, _ = _leaf("/".join(path), key, np.zeros(np.shape(value)))
        port_name = ".".join(prefix + [name])
        if port_name not in state_dict:
            raise KeyError(f"{'/'.join(path)}: no {port_name!r} in the "
                           "state dict")
        arr = state_dict[port_name].detach().float().cpu().numpy()
        if key == "kernel":
            arr = arr.T if arr.ndim == 2 else arr.transpose(2, 3, 1, 0)
        if arr.shape != tuple(np.shape(value)):
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape} in the "
                             f"state dict, {tuple(np.shape(value))} in the "
                             "template")
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[key] = np.ascontiguousarray(arr, dtype=np.float32)
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


def overlay_upsampler_params(params: Dict,
                             upsampler_cfg: Optional[Mapping]) -> Dict:
    """``params`` with the weights of :func:`load_upsampler_params`
    overlaid on its ``upsampler`` subtree, or ``params`` itself when there
    are none (the JAX trainer's ``_load_pretrained`` and evaluate.py do
    this)."""
    loaded = load_upsampler_params(upsampler_cfg)
    if loaded is None:
        return params
    from isegprobe_torch.utils.serialization import merge_params

    return dict(params, upsampler=merge_params(params["upsampler"], loaded))


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
