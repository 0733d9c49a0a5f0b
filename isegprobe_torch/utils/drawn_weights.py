"""Torch state dicts in the layouts of published checkpoints, drawn from a
seed, and the inverse of the converters.

The published weights the converters read (DINOv2-S/14, DINO-S/16, CLIP
ViT-B/16, LiFT, LoftUp and reference-trained probes) are not in the
repository. What stands in for them here has each file's real key names,
shapes and dtype (fp16 for CLIP), with values drawn from a seed at sane
scales, so that a model built on them computes finite features of a
realistic size:

* ``*_layout`` give the keys and shapes of each checkpoint;
* :func:`draw_state_dict` draws a layout's values from a seed;
* :func:`vit_state_dict` and :func:`reference_checkpoint` turn a flax-named
  tree back into the hub's and the reference's layouts (the inverses of
  ``models.convert.convert_vit`` and ``convert_reference_checkpoint``);
* :func:`write_merges` writes a small BPE merges file for the CLIP
  tokenizer.
"""

from __future__ import annotations

import gzip
from pathlib import Path
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

__all__ = ["vit_layout", "clip_layout", "lift_layout", "loftup_raw_layout",
           "draw_state_dict", "vit_state_dict", "reference_checkpoint",
           "write_merges"]

Layout = List[Tuple[str, Tuple[int, ...]]]

# an entry of BatchNorm2d's state dict that the converters skip
_COUNTER = "num_batches_tracked"


def _linear(prefix: str, fan_in: int, out: int, bias: bool = True) -> Layout:
    return [(f"{prefix}.weight", (out, fan_in))] + (
        [(f"{prefix}.bias", (out,))] if bias else [])


def _norm(prefix: str, dim: int) -> Layout:
    return [(f"{prefix}.weight", (dim,)), (f"{prefix}.bias", (dim,))]


def _conv(prefix: str, cin: int, cout: int, k: int,
          bias: bool = True) -> Layout:
    return [(f"{prefix}.weight", (cout, cin, k, k))] + (
        [(f"{prefix}.bias", (cout,))] if bias else [])


def _bn(prefix: str, dim: int) -> Layout:
    return _norm(prefix, dim) + [(f"{prefix}.running_mean", (dim,)),
                                 (f"{prefix}.running_var", (dim,)),
                                 (f"{prefix}.{_COUNTER}", ())]


def vit_layout(depth: int = 12, dim: int = 384, patch: int = 14,
               grid: int = 37, layerscale: bool = True, chunks: int = 0,
               mlp_ratio: int = 4) -> Layout:
    """A DINOv2 (``layerscale``, with ``mask_token``) or DINO hub ViT's
    keys and shapes; ``chunks`` > 0 nests the blocks as DINOv2's
    ``block_chunks`` does (``blocks.{chunk}.{i}.``, i global)."""
    out: Layout = [("cls_token", (1, 1, dim)),
                   ("pos_embed", (1, grid * grid + 1, dim))]
    if layerscale:
        out.append(("mask_token", (1, dim)))
    out += _conv("patch_embed.proj", 3, dim, patch)
    per_chunk = -(-depth // chunks) if chunks else depth
    for i in range(depth):
        p = f"blocks.{i // per_chunk}.{i}" if chunks else f"blocks.{i}"
        out += _norm(f"{p}.norm1", dim)
        out += _linear(f"{p}.attn.qkv", dim, 3 * dim)
        out += _linear(f"{p}.attn.proj", dim, dim)
        if layerscale:
            out.append((f"{p}.ls1.gamma", (dim,)))
        out += _norm(f"{p}.norm2", dim)
        out += _linear(f"{p}.mlp.fc1", dim, mlp_ratio * dim)
        out += _linear(f"{p}.mlp.fc2", mlp_ratio * dim, dim)
        if layerscale:
            out.append((f"{p}.ls2.gamma", (dim,)))
    out += _norm("norm", dim)
    if not layerscale:  # DINO's hub files keep the classifier head
        out += _linear("head", dim, 1000)
    return out


def _clip_blocks(prefix: str, layers: int, width: int) -> Layout:
    out: Layout = []
    for i in range(layers):
        p = f"{prefix}transformer.resblocks.{i}"
        out += [(f"{p}.attn.in_proj_weight", (3 * width, width)),
                (f"{p}.attn.in_proj_bias", (3 * width,))]
        out += _linear(f"{p}.attn.out_proj", width, width)
        out += _norm(f"{p}.ln_1", width)
        out += _linear(f"{p}.mlp.c_fc", width, 4 * width)
        out += _linear(f"{p}.mlp.c_proj", 4 * width, width)
        out += _norm(f"{p}.ln_2", width)
    return out


def clip_layout(layers: int = 12, width: int = 768, patch: int = 16,
                grid: int = 14, output_dim: int = 512, text_layers: int = 12,
                text_width: int = 512, vocab: int = 49408,
                context: int = 77) -> Layout:
    """A full CLIP state dict's keys and shapes (ViT-B/16 by default): the
    text tower at the top level, the visual tower under ``visual.``."""
    out: Layout = [("positional_embedding", (context, text_width)),
                   ("text_projection", (text_width, output_dim)),
                   ("logit_scale", ())]
    out += [("visual.class_embedding", (width,)),
            ("visual.positional_embedding", (grid * grid + 1, width)),
            ("visual.proj", (width, output_dim))]
    out += _conv("visual.conv1", 3, width, patch, bias=False)
    out += _norm("visual.ln_pre", width)
    out += _clip_blocks("visual.", layers, width)
    out += _norm("visual.ln_post", width)
    out += [("token_embedding.weight", (vocab, text_width))]
    out += _clip_blocks("", text_layers, text_width)
    out += _norm("ln_final", text_width)
    return out


def lift_layout(c: int = 384) -> Layout:
    """A LiFT checkpoint's keys and shapes for ``c``-wide features, saved
    from ``DataParallel`` (every key under ``module.``)."""
    half, mid = c // 2, (c + 32) // 2
    out: Layout = []
    out += _conv("image_convs_1.0", 3, 32, 3) + _bn("image_convs_1.1", 32)
    out += _conv("image_convs_1.3", 32, 32, 3) + _bn("image_convs_1.4", 32)
    out += _conv("image_convs_2.0", 32, 32, 3) + _bn("image_convs_2.1", 32)
    out += [("up1.up.weight", (c + 32, mid, 2, 2)), ("up1.up.bias", (mid,))]
    out += _conv("up1.conv_1.double_conv.0", mid + 32, half, 3, bias=False)
    out += _bn("up1.conv_1.double_conv.1", half)
    out += _conv("up1.conv_1.double_conv.3", half, half, 3, bias=False)
    out += _bn("up1.conv_1.double_conv.4", half)
    out += _conv("outc", half, c, 1)
    return [(f"module.{k}", s) for k, s in out]


def loftup_raw_layout(n_dim: int = 384, n_freqs: int = 20,
                      num_layers: int = 2) -> Layout:
    """A raw LoftUp training checkpoint's keys and shapes: the upsampler
    under ``upsampler.``, the input ChannelNorm under ``model.1.``, and two
    keys of the wrapped backbone under ``model.0.`` (which the converter
    skips)."""
    cdim = n_dim + 2 * 5 * 2
    stem = 2 * n_freqs * 5 + 3
    up: Layout = [("fourier_feat.1.biases", (2, 5, n_freqs)),
                  ("lr_pe.biases", (2, 2, 5))]
    up += _norm("first_conv.0.norm", stem)
    up += _conv("first_conv.1", stem, cdim, 3) + _bn("first_conv.2", cdim)
    up += _conv("first_conv.4", cdim, cdim, 3) + _bn("first_conv.5", cdim)
    for i in range(num_layers):
        p = f"ca_transformer.layers.{i}"
        up += _norm(f"{p}.0.norm_q", cdim) + _norm(f"{p}.0.norm_kv", cdim)
        up += [(f"{p}.0.attention.in_proj_weight", (3 * cdim, cdim)),
               (f"{p}.0.attention.in_proj_bias", (3 * cdim,))]
        up += _linear(f"{p}.0.attention.out_proj", cdim, cdim)
        up += _norm(f"{p}.1.net.0", cdim)
        up += _linear(f"{p}.1.net.1", cdim, n_dim)
        up += _linear(f"{p}.1.net.4", n_dim, cdim)
    up += _norm("ca_transformer.norm", cdim)
    up += _conv("final_conv.0", cdim, n_dim, 1)
    up += _norm("final_conv.1", n_dim)
    return ([("model.0.cls_token", (1, 1, n_dim)),
             ("model.0.pos_embed", (1, 37 * 37 + 1, n_dim))]
            + [(f"upsampler.{k}", s) for k, s in up]
            + _norm("model.1.norm", n_dim))


def _stats(key: str, shape: Sequence[int]) -> Tuple[float, float]:
    """(mean, std) of a drawn value by its role: norm and BatchNorm scales
    and running variances near 1, biases and running means near 0,
    LayerScale gammas near 0.1, embeddings and tokens at 0.02, LoftUp's
    Fourier biases N(0, 1), weights at 1/sqrt(fan-in)."""
    name = key.rsplit(".", 1)[-1]
    if name == "logit_scale":
        return 4.6052, 0.0
    if name == "running_var":
        return 1.0, 0.05
    if name == "biases":
        return 0.0, 1.0
    if name == "gamma":
        return 0.1, 0.02
    if name in ("bias", "running_mean", "in_proj_bias"):
        return 0.0, 0.02
    if len(shape) <= 1 and name == "weight":
        return 1.0, 0.1
    if name in ("cls_token", "pos_embed", "mask_token", "class_embedding",
                "positional_embedding") or key.startswith("token_embedding"):
        return 0.0, 0.02
    # weights; CLIP's right-multiplied projections read [in, out]
    fan_in = shape[0] if name in ("proj", "text_projection") else int(
        np.prod(shape[1:]))
    return 0.0, fan_in ** -0.5


def draw_state_dict(layout: Layout, seed: int,
                    dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """``layout``'s values drawn from ``seed`` (numpy's default generator,
    one float32 normal draw an entry in layout order), in ``dtype``; every
    ``num_batches_tracked`` entry is an int64 0, as in a saved BatchNorm."""
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}
    for key, shape in layout:
        if key.endswith(_COUNTER):
            out[key] = torch.zeros((), dtype=torch.int64)
            continue
        mean, std = _stats(key, shape)
        value = rng.standard_normal(shape, dtype=np.float32) * np.float32(
            std) + np.float32(mean)
        out[key] = torch.from_numpy(np.asarray(value, np.float32)).to(dtype)
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def vit_state_dict(tree: Mapping, layerscale: bool = True, chunks: int = 0,
                   mask_token: bool = True) -> Dict[str, torch.Tensor]:
    """A flax ViT tree (``params["backbone"]["model"]``) in the hub's
    layout, the inverse of ``convert_vit``: ``chunks`` > 0 nests the
    blocks as DINOv2's ``block_chunks``; ``mask_token`` adds DINOv2's
    (zeros), which the converter skips."""
    depth = sum(1 for k in tree if k.startswith("blocks_"))
    per_chunk = -(-depth // chunks) if chunks else depth
    out = {"cls_token": _t(tree["cls_token"]),
           "pos_embed": _t(tree["pos_embed"])}
    if mask_token:
        out["mask_token"] = torch.zeros(1, tree["cls_token"].shape[-1])

    def dense(prefix: str, node: Mapping) -> None:
        out[f"{prefix}.weight"] = _t(np.asarray(node["kernel"]).T)
        out[f"{prefix}.bias"] = _t(node["bias"])

    def norm(prefix: str, node: Mapping) -> None:
        out[f"{prefix}.weight"] = _t(node["scale"])
        out[f"{prefix}.bias"] = _t(node["bias"])

    proj = tree["patch_embed"]["proj"]
    out["patch_embed.proj.weight"] = _t(
        np.asarray(proj["kernel"]).transpose(3, 2, 0, 1))
    out["patch_embed.proj.bias"] = _t(proj["bias"])
    for i in range(depth):
        blk = tree[f"blocks_{i}"]
        p = f"blocks.{i // per_chunk}.{i}" if chunks else f"blocks.{i}"
        norm(f"{p}.norm1", blk["norm1"])
        norm(f"{p}.norm2", blk["norm2"])
        dense(f"{p}.attn.qkv", blk["attn"]["qkv"])
        dense(f"{p}.attn.proj", blk["attn"]["proj"])
        dense(f"{p}.mlp.fc1", blk["mlp"]["fc1"])
        dense(f"{p}.mlp.fc2", blk["mlp"]["fc2"])
        if layerscale:
            out[f"{p}.ls1.gamma"] = _t(blk["ls1"]["gamma"])
            out[f"{p}.ls2.gamma"] = _t(blk["ls2"]["gamma"])
    norm("norm", tree["norm"])
    return out


def _serialized(value) -> Dict:
    """A reference ``@serialize`` wrapper around a constructor value."""
    return {"type": type(value).__name__, "value": value, "specified": True}


def reference_checkpoint(params: Mapping, config: Mapping,
                         wrapped: bool = True) -> Dict:
    """A probe checkpoint (``params``: its trained ``embed_coords`` and
    ``head``; ``config``: its constructor params) in the reference's torch
    layout: ``{'state_dict', 'config'}`` with ``embed_coords.proj.*``,
    ``head.convs.{i}.conv.*`` and ``head.classifier.*``, and, with
    ``wrapped``, every config value in its ``@serialize`` wrapper (the
    inverse of ``convert_reference_checkpoint``)."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(prefix: str, node: Mapping) -> None:
        sd[f"{prefix}.weight"] = _t(
            np.asarray(node["kernel"]).transpose(3, 2, 0, 1))
        if "bias" in node:
            sd[f"{prefix}.bias"] = _t(node["bias"])

    conv("embed_coords.proj", params["embed_coords"]["proj"])
    head = params["head"]
    i = 0
    while f"convs_{i}" in head:
        conv(f"head.convs.{i}.conv", head[f"convs_{i}"])
        i += 1
    conv("head.classifier", head["classifier"])
    cfg = {k: _serialized(v) if wrapped else v for k, v in config.items()}
    return {"state_dict": sd,
            "config": {"class": "core.model.iseg_probe_model.iSegProbeModel",
                       "params": cfg}}


def write_merges(path, words: Sequence[str]) -> Path:
    """A gzip BPE merges file (CLIP's format: a header line, then one
    merge a line) that spells each of ``words`` left to right: its first
    two characters, then that token and the next character, up to the
    whole word with its ``</w>`` end; duplicates are kept once."""
    merges: List[str] = []
    for word in words:
        parts = list(word[:-1]) + [word[-1] + "</w>"]
        token = parts[0]
        for nxt in parts[1:]:
            merge = f"{token} {nxt}"
            if merge not in merges:
                merges.append(merge)
            token += nxt
    path = Path(path)
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2", *merges]))
    return path
