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
  ``proj`` ``[width, out]`` (and its text tower's ``token_embedding`` and
  ``text_projection``), ``ImplicitFeaturizer.biases``, FrozenBatchNorm
  ``mean`` and ``var``, ConvNeXtLayerNorm ``weight``, and JBU's scalars
  ``range_temp`` and ``sigma_spatial``. A bias-free conv (CLIP's ``conv1``)
  has no ``bias``, and LiFT's 2x2 transposed-conv kernel ``[2, 2, cin, f]``
  takes the conv rule into ``[f, cin, 2, 2]``.

Loading raises on any missing or unexpected key and on any shape mismatch.
:func:`state_dict_to_jax_params` runs the bridge the other way, onto the
names and layouts of a template param tree (the trainer's checkpoints).

The converters of published torch checkpoints run the other way, into
the flax-named numpy trees that :func:`load_jax_params` takes (counterparts
of the JAX package's ``convert_*`` functions, each tree bitwise the JAX
converter's on the same state dict): :func:`convert_vit` (DINOv2 with
LayerScale, and DINO), :func:`convert_clip_visual`,
:func:`convert_clip_text`, :func:`convert_lift`, :func:`convert_loftup`
and :func:`convert_loftup_raw`, :func:`pad_loftup_params` (LoftUp's
zero-padded ``mxu_pad`` layout) and :func:`convert_reference_checkpoint`
(a reference-trained probe). A state dict's values may be torch tensors
or numpy arrays; every leaf comes out float32 (CLIP's fp16 widens).

``load_upsampler_params`` reads the frozen upsampler weights a config's
``upsampler_path`` names, and ``interpolate_pos_embed_params`` resizes a
pos-embed to the eval grid once (counterparts of the JAX package's functions
of those names).
"""

from __future__ import annotations

import re
import warnings
from pathlib import Path
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from isegprobe_torch.utils.serialization import _JAX_MODEL_CLASS

__all__ = ["jax_params_to_state_dict", "state_dict_to_jax_params",
           "load_jax_params",
           "load_upsampler_params", "overlay_upsampler_params",
           "interpolate_pos_embed_params", "convert_vit",
           "convert_clip_visual", "convert_clip_text", "convert_lift",
           "convert_loftup", "convert_loftup_raw", "pad_loftup_params",
           "convert_reference_checkpoint", "load_torch_state_dict",
           "restrict_to_module"]

_INDEXED = re.compile(r"^(blocks|convs|ca|ff|attn|resblocks)_(\d+)$")
_PASS_THROUGH = ("bias", "cls_token", "pos_embed", "gamma", "weight",
                 "in_proj_weight", "in_proj_bias", "biases", "mean", "var",
                 "range_temp", "sigma_spatial", "class_embedding",
                 "positional_embedding", "proj", "token_embedding",
                 "text_projection")


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


def load_torch_state_dict(path, unwrap_model: bool = False) -> Mapping:
    """The state dict of a torch checkpoint file, read with
    ``torch.load(weights_only=True)``: a file that needs a pickled global
    (a whole pickled module, say) is refused. A ``state_dict`` entry, and
    with ``unwrap_model`` a dict ``model`` entry (the hub's DINO files),
    is unwrapped, as the JAX package's scripts do."""
    obj = torch.load(str(path), map_location="cpu", weights_only=True)
    if isinstance(obj, Mapping) and "state_dict" in obj:
        obj = obj["state_dict"]
    if (unwrap_model and isinstance(obj, Mapping) and "model" in obj
            and isinstance(obj["model"], Mapping)):
        obj = obj["model"]
    return obj


def restrict_to_module(tree: Mapping, module: nn.Module) -> dict:
    """The leaves of the flax-named ``tree`` that ``module`` has a
    parameter for (by the bridge's names), dropping the rest: a converted
    checkpoint holds layers that a probe builds but never calls (MaskCLIP's
    last block keeps only ``ln_1`` and ``attn``; the DINO key probe stops
    at the last block's keys), which flax would leave unused and
    :func:`load_jax_params` rejects."""
    own = module.state_dict()
    out: dict = {}
    for path, prefix, key, value in _leaves(tree):
        name, _ = _leaf("/".join(path), key, np.zeros(np.shape(value)))
        if ".".join(prefix + [name]) in own:
            node = out
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[key] = value
    return out


def load_upsampler_params(upsampler_cfg: Optional[Mapping]):
    """The frozen LoftUp or LiFT weights that ``upsampler_cfg["params"]
    ["upsampler_path"]`` names, as a flax param tree, or None when no path
    is configured (counterpart of ``isegprobe_tpu/models/convert.py:
    load_upsampler_params``).

    A ``.msgpack`` file (converted weights) is read with
    ``utils.serialization.msgpack_restore``; any other file is a raw torch
    checkpoint of the reference, read by :func:`load_torch_state_dict` and
    converted with :func:`convert_lift` or :func:`convert_loftup_raw`
    (``num_layers`` from the config). A configured path that does not
    exist warns and returns None, so the upsampler keeps its PRNGKey(0)
    init; the JAX package returns None there without a word."""
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
    sd = load_torch_state_dict(p)
    if utype == "lift":
        return convert_lift(sd)
    return convert_loftup_raw(sd, num_layers=int(uparams.get("num_layers",
                                                             2)))


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


# -- published torch checkpoints -> flax-named numpy trees --------------------

def _to_np(v: Any) -> np.ndarray:
    """A torch tensor or array as float32 numpy (fp16 widens exactly)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype=np.float32)


def _linear(sd: Mapping, prefix: str) -> Dict:
    out = {"kernel": _to_np(sd[f"{prefix}.weight"]).T}
    if f"{prefix}.bias" in sd:
        out["bias"] = _to_np(sd[f"{prefix}.bias"])
    return out


def _layernorm(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _to_np(sd[f"{prefix}.weight"]),
            "bias": _to_np(sd[f"{prefix}.bias"])}


def _conv(sd: Mapping, prefix: str) -> Dict:
    """torch conv ``weight [O, I, kh, kw]`` -> flax ``kernel [kh, kw, I,
    O]``, with the bias where there is one (also the patch embeddings')."""
    out = {"kernel": _to_np(sd[f"{prefix}.weight"]).transpose(2, 3, 1, 0)}
    if f"{prefix}.bias" in sd:
        out["bias"] = _to_np(sd[f"{prefix}.bias"])
    return out


def _bn(sd: Mapping, prefix: str) -> Dict:
    return {"scale": _to_np(sd[f"{prefix}.weight"]),
            "bias": _to_np(sd[f"{prefix}.bias"]),
            "mean": _to_np(sd[f"{prefix}.running_mean"]),
            "var": _to_np(sd[f"{prefix}.running_var"])}


def _packed_attention(sd: Mapping, prefix: str) -> Dict:
    """torch ``nn.MultiheadAttention``'s packed projections (kept in torch
    layout) and its ``out_proj``."""
    return {"in_proj_weight": _to_np(sd[f"{prefix}.in_proj_weight"]),
            "in_proj_bias": _to_np(sd[f"{prefix}.in_proj_bias"]),
            "out_proj": _linear(sd, f"{prefix}.out_proj")}


def _clip_resblocks(sd: Mapping, layers: int) -> Dict:
    out = {}
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        out[f"resblocks_{i}"] = {
            "ln_1": _layernorm(sd, f"{p}.ln_1"),
            "ln_2": _layernorm(sd, f"{p}.ln_2"),
            "attn": _packed_attention(sd, f"{p}.attn"),
            "c_fc": _linear(sd, f"{p}.mlp.c_fc"),
            "c_proj": _linear(sd, f"{p}.mlp.c_proj"),
        }
    return out


# DINOv2's block_chunks nest block params as blocks.{chunk}.{i}.* with a
# global i
_CHUNKED_BLOCK = re.compile(r"^blocks\.\d+\.(\d+)\.")


def convert_vit(state_dict: Mapping, depth: int,
                layerscale: bool = False) -> Dict:
    """A DINO or DINOv2 (``layerscale``: ``ls1`` / ``ls2``) torch ViT state
    dict -> the ViT's params. DINOv2's ``block_chunks`` layout is
    flattened; keys the ViT has no place for (``mask_token``, ``head.*``,
    register tokens) are ignored."""
    sd = dict(state_dict)
    if any(_CHUNKED_BLOCK.match(k) for k in sd):
        sd = {_CHUNKED_BLOCK.sub(r"blocks.\1.", k): v for k, v in sd.items()}
    params: Dict[str, Any] = {
        "cls_token": _to_np(sd["cls_token"]),
        "pos_embed": _to_np(sd["pos_embed"]),
        "patch_embed": {"proj": _conv(sd, "patch_embed.proj")},
        "norm": _layernorm(sd, "norm"),
    }
    for i in range(depth):
        p = f"blocks.{i}"
        blk = {
            "norm1": _layernorm(sd, f"{p}.norm1"),
            "norm2": _layernorm(sd, f"{p}.norm2"),
            "attn": {"qkv": _linear(sd, f"{p}.attn.qkv"),
                     "proj": _linear(sd, f"{p}.attn.proj")},
            "mlp": {"fc1": _linear(sd, f"{p}.mlp.fc1"),
                    "fc2": _linear(sd, f"{p}.mlp.fc2")},
        }
        if layerscale:
            blk["ls1"] = {"gamma": _to_np(sd[f"{p}.ls1.gamma"])}
            blk["ls2"] = {"gamma": _to_np(sd[f"{p}.ls2.gamma"])}
        params[f"blocks_{i}"] = blk
    return params


def convert_clip_visual(state_dict: Mapping, layers: int = 12) -> Dict:
    """CLIP's visual tower -> ``CLIPVisionTransformer`` params, from a full
    CLIP state dict (``visual.*``) or the tower's own keys. In a full state
    dict only the ``visual.`` keys are read: the text tower's
    ``transformer.resblocks.*`` and ``positional_embedding`` have the
    names that the visual ones take once the prefix is stripped. (The JAX
    package strips the prefix from every key, so whichever tower comes
    later in the file wins; in OpenAI's files that is the text tower.)"""
    sd = dict(state_dict)
    if any(k.startswith("visual.") for k in sd):
        sd = {k.removeprefix("visual."): v for k, v in sd.items()
              if k.startswith("visual.")}
    params: Dict[str, Any] = {
        "conv1": {"kernel": _to_np(sd["conv1.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": _to_np(sd["class_embedding"]),
        "positional_embedding": _to_np(sd["positional_embedding"]),
        "ln_pre": _layernorm(sd, "ln_pre"),
        "ln_post": _layernorm(sd, "ln_post"),
        "proj": _to_np(sd["proj"]),
    }
    params.update(_clip_resblocks(sd, layers))
    return params


def convert_clip_text(state_dict: Mapping, layers: int = 12) -> Dict:
    """CLIP's text tower (the top-level keys of a full CLIP state dict) ->
    ``CLIPTextEncoder`` params."""
    sd = dict(state_dict)
    params: Dict[str, Any] = {
        "token_embedding": _to_np(sd["token_embedding.weight"]),
        "positional_embedding": _to_np(sd["positional_embedding"]),
        "ln_final": _layernorm(sd, "ln_final"),
        "text_projection": _to_np(sd["text_projection"]),
    }
    params.update(_clip_resblocks(sd, layers))
    return params


def convert_lift(state_dict: Mapping) -> Dict:
    """A LiFT torch checkpoint (``module.`` prefixes stripped) ->
    ``LiFTUpsampler`` params; its ConvTranspose weight is ``[in, out, kh,
    kw]``."""
    sd = {k.removeprefix("module."): v for k, v in dict(state_dict).items()}

    def conv_bn(conv: str, bn: str) -> Dict:
        return {"conv": _conv(sd, conv), "bn": _bn(sd, bn)}

    return {
        "image_convs_1a": conv_bn("image_convs_1.0", "image_convs_1.1"),
        "image_convs_1b": conv_bn("image_convs_1.3", "image_convs_1.4"),
        "image_convs_2": conv_bn("image_convs_2.0", "image_convs_2.1"),
        "up_transpose": {
            "kernel": _to_np(sd["up1.up.weight"]).transpose(2, 3, 0, 1),
            "bias": _to_np(sd["up1.up.bias"]),
        },
        "up_conv": {
            "c1": conv_bn("up1.conv_1.double_conv.0",
                          "up1.conv_1.double_conv.1"),
            "c2": conv_bn("up1.conv_1.double_conv.3",
                          "up1.conv_1.double_conv.4"),
        },
        "outc": _conv(sd, "outc"),
    }


def convert_loftup(upsampler_sd: Mapping, channelnorm_sd: Mapping,
                   num_layers: int = 2) -> Dict:
    """LoftUp's ('sine') upsampler and input-ChannelNorm state dicts, as
    the reference's loader leaves them after its key surgery ->
    ``LoftUpUpsampler`` params (unpadded)."""
    sd = dict(upsampler_sd)
    ca: Dict[str, Any] = {"norm": _layernorm(sd, "ca_transformer.norm")}
    for i in range(num_layers):
        p = f"ca_transformer.layers.{i}"
        ca[f"ca_{i}"] = {
            "norm_q": _layernorm(sd, f"{p}.0.norm_q"),
            "norm_kv": _layernorm(sd, f"{p}.0.norm_kv"),
            "attention": _packed_attention(sd, f"{p}.0.attention"),
        }
        ca[f"ff_{i}"] = {
            "norm": _layernorm(sd, f"{p}.1.net.0"),
            "fc1": _linear(sd, f"{p}.1.net.1"),
            "fc2": _linear(sd, f"{p}.1.net.4"),
        }
    return {
        "channelnorm": {"norm": _layernorm(dict(channelnorm_sd), "norm")},
        "fourier_feat": {"biases": _to_np(sd["fourier_feat.1.biases"])},
        "lr_pe": {"biases": _to_np(sd["lr_pe.biases"])},
        "first_norm": {"norm": _layernorm(sd, "first_conv.0.norm")},
        "first_conv1": {"conv": _conv(sd, "first_conv.1"),
                        "bn": _bn(sd, "first_conv.2")},
        "first_conv2": {"conv": _conv(sd, "first_conv.4"),
                        "bn": _bn(sd, "first_conv.5")},
        "ca_transformer": ca,
        "final_conv": _conv(sd, "final_conv.0"),
        "final_ln": {"weight": _to_np(sd["final_conv.1.weight"]),
                     "bias": _to_np(sd["final_conv.1.bias"])},
    }


def convert_loftup_raw(state_dict: Mapping, num_layers: int = 2) -> Dict:
    """A raw LoftUp training checkpoint -> ``LoftUpUpsampler`` params, with
    the reference loader's key surgery: the ChannelNorm under ``model.1.``
    and the upsampler under ``upsampler.``. Both are selected by prefix.
    (The JAX package selects the ChannelNorm by the substring ``model.1``
    but strips the prefix ``model.1.``, so a key such as
    ``upsampler.model.1.x`` lands in its ChannelNorm dict unstripped;
    the two agree on every key that holds ``model.1`` only as its
    prefix.)"""
    sd = dict(state_dict)
    channelnorm_sd = {k.removeprefix("model.1."): v for k, v in sd.items()
                      if k.startswith("model.1.")}
    upsampler_sd = {k.removeprefix("upsampler."): v for k, v in sd.items()
                    if k.startswith("upsampler")}
    return convert_loftup(upsampler_sd, channelnorm_sd, num_layers=num_layers)


def pad_loftup_params(params: Mapping, n_dim: int = 384, n_freqs: int = 20,
                      heads: int = 4, num_layers: int = 2) -> Dict:
    """LoftUp's params zero-padded to the ``mxu_pad=True`` layout: cdim 404
    -> 512, stem 203 -> 256, head dim 101 -> 128 (the next multiples of
    128). Zero rows and columns add nothing to any product, padded norm
    scales and biases are zero so padded activations stay exactly zero,
    and the padded BatchNorm variances are one. The packed in-projection
    is head-interleaved: head h's real row i lands at ``h * dh_pad + i``,
    so a plain reshape to ``(heads, dh_pad)`` puts each head's channels in
    its own padded slot, and ``out_proj``'s input rows are scattered to
    match. Input: the unpadded upsampler subtree; output: the padded tree
    (bitwise ``isegprobe_tpu/models/convert.py:pad_loftup_params``)."""
    creal = n_dim + 2 * 5 * 2
    cpad = -(-creal // 128) * 128
    sreal = 2 * n_freqs * 5 + 3
    spad = -(-sreal // 128) * 128
    rdh, pdh = creal // heads, cpad // heads
    ar = np.arange(creal)
    hidx = (ar // rdh) * pdh + (ar % rdh)  # head-interleaved target rows

    def tail(a, axis: int, to: int) -> np.ndarray:
        a = np.asarray(a)
        pads = [(0, 0)] * a.ndim
        pads[axis] = (0, to - a.shape[axis])
        return np.pad(a, pads)

    def ln(p: Mapping, to: int) -> Dict:
        return {"scale": tail(p["scale"], 0, to),
                "bias": tail(p["bias"], 0, to)}

    def bn(p: Mapping, to: int) -> Dict:
        var = np.asarray(p["var"])
        return {"scale": tail(p["scale"], 0, to),
                "bias": tail(p["bias"], 0, to),
                "mean": tail(p["mean"], 0, to),
                "var": np.concatenate(
                    [var, np.ones(to - var.shape[0], var.dtype)])}

    def conv(p: Mapping, cin_to: int, cout_to: int) -> Dict:
        out = {"kernel": tail(tail(p["kernel"], 2, cin_to), 3, cout_to)}
        if "bias" in p:
            out["bias"] = tail(p["bias"], 0, cout_to)
        return out

    p = dict(params)
    p["first_norm"] = {"norm": ln(params["first_norm"]["norm"], spad)}
    p["first_conv1"] = {
        "conv": conv(params["first_conv1"]["conv"], spad, cpad),
        "bn": bn(params["first_conv1"]["bn"], cpad)}
    p["first_conv2"] = {
        "conv": conv(params["first_conv2"]["conv"], cpad, cpad),
        "bn": bn(params["first_conv2"]["bn"], cpad)}

    ca_in = params["ca_transformer"]
    ca: Dict[str, Any] = {"norm": ln(ca_in["norm"], cpad)}
    for i in range(num_layers):
        layer = ca_in[f"ca_{i}"]
        w = np.asarray(layer["attention"]["in_proj_weight"])
        b = np.asarray(layer["attention"]["in_proj_bias"])
        wp = np.zeros((3 * cpad, cpad), w.dtype)
        bp = np.zeros((3 * cpad,), b.dtype)
        for blk in range(3):
            wp[blk * cpad + hidx, :creal] = w[blk * creal:(blk + 1) * creal]
            bp[blk * cpad + hidx] = b[blk * creal:(blk + 1) * creal]
        ok = np.asarray(layer["attention"]["out_proj"]["kernel"])
        okp = np.zeros((cpad, cpad), ok.dtype)
        okp[np.ix_(hidx, ar)] = ok
        ca[f"ca_{i}"] = {
            "norm_q": ln(layer["norm_q"], cpad),
            "norm_kv": ln(layer["norm_kv"], cpad),
            "attention": {
                "in_proj_weight": wp,
                "in_proj_bias": bp,
                "out_proj": {
                    "kernel": okp,
                    "bias": tail(layer["attention"]["out_proj"]["bias"],
                                 0, cpad)},
            },
        }
        ff = ca_in[f"ff_{i}"]
        ca[f"ff_{i}"] = {
            "norm": ln(ff["norm"], cpad),
            "fc1": {"kernel": tail(ff["fc1"]["kernel"], 0, cpad),
                    "bias": np.asarray(ff["fc1"]["bias"])},
            "fc2": {"kernel": tail(ff["fc2"]["kernel"], 1, cpad),
                    "bias": tail(ff["fc2"]["bias"], 0, cpad)},
        }
    p["ca_transformer"] = ca
    fc = params["final_conv"]
    p["final_conv"] = {"kernel": tail(fc["kernel"], 2, cpad),
                       "bias": np.asarray(fc["bias"])}
    return p


# the reference config's keys that the probe's constructor shares
_REFERENCE_KEYS = (
    "backbone_cfg", "head_cfg", "embed_coords_cfg", "neck_cfg",
    "upsampler_cfg", "save_cfg", "architecture", "use_disks",
    "norm_radius", "with_prev_mask", "with_aux_output",
    "use_rgb_conv", "use_leaky_relu",
)


def _unwrap_serialized(v):
    """A reference checkpoint's ``@serialize`` wraps every constructor
    param as ``{'type', 'value', 'specified'}``; plain values pass."""
    if (isinstance(v, Mapping)
            and set(v.keys()) == {"type", "value", "specified"}):
        return v["value"]
    return v


def convert_reference_checkpoint(torch_checkpoint: Mapping) -> Dict:
    """A reference-trained probe checkpoint (``{'state_dict', 'config'}``)
    -> ``{'params', 'config'}``: the trained click embedding
    (``embed_coords.proj``) and conv head (``head.convs.{i}.conv``,
    ``head.classifier``), and the constructor config (None when the
    checkpoint has none). The frozen backbone and upsampler are reloaded
    separately."""
    sd = torch_checkpoint["state_dict"]
    ref_cfg = torch_checkpoint.get("config", {})

    params: Dict[str, Any] = {}
    if "embed_coords.proj.weight" in sd:
        params["embed_coords"] = {"proj": _conv(sd, "embed_coords.proj")}
    head: Dict[str, Any] = {}
    i = 0
    while f"head.convs.{i}.conv.weight" in sd:
        head[f"convs_{i}"] = _conv(sd, f"head.convs.{i}.conv")
        i += 1
    if "head.classifier.weight" in sd:
        head["classifier"] = _conv(sd, "head.classifier")
    if head:
        params["head"] = head

    config = None
    if ref_cfg:
        ref_params = ref_cfg.get("params", ref_cfg)
        config = {"class": _JAX_MODEL_CLASS,
                  "params": {k: _unwrap_serialized(ref_params[k])
                             for k in _REFERENCE_KEYS if k in ref_params}}
    return {"params": params, "config": config}
