"""Megatron tensor parallelism of the port's ViT blocks over a mesh's model
group: the counterpart of ``isegprobe_tpu/parallel/tp.py``.

- attention qkv and MLP fc1 are column parallel (each rank computes its
  slice of the outputs), proj and fc2 row parallel (each rank contracts its
  slice of the inputs, and one all-reduce over the model group sums the
  partial outputs), so each block runs two all-reduces: one a pair;
- the column-parallel biases follow their kernel's outputs; the
  row-parallel biases are added once, after the all-reduce; everything
  else (norms, LayerScale, embeddings, the click encoder, upsampler and
  head) is replicated.

The JAX rule shards the packed qkv kernel's outputs contiguously and GSPMD
keeps that correct. Here each rank holds whole heads: its q, k and v
columns, repacked ``[q_r | k_r | v_r]``, so that kernel A reads its packed
``[B, N, 3·C/M]`` by stride with ``heads/M`` heads (DINOv2-S's 6 heads over
2 ranks: 3 a rank). The all-reduces are the Megatron f/g pair as autograd
Functions: f is the identity forward and an all-reduce of the gradient
backward, g the reverse, so the click encoder's gradient crosses the
frozen blocks.

:func:`shard_state_dict` cuts a rank's shard from the full state dict
(:func:`shard_vit_tp` cuts the model's weights through it), and
:func:`full_state_dict` gathers the full one back over the model group
(both exact), for checkpoints in the full layout the JAX reader and
``load_model_for_eval`` read. A block's ``keys`` (the DINO key probe's
last-block keys) are gathered over the model group too, so a split model
returns the full keys.
"""

from __future__ import annotations

import re
from typing import Dict, List

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from isegprobe_torch.models.dtype import compute_dtype
from isegprobe_torch.ops.attention import mha_qkv

__all__ = ["vit_param_shardings", "shard_state_dict", "shard_vit_tp",
           "full_state_dict", "is_sharded"]

# flax leaf-path suffixes -> the spec of a 2D kernel [in, out] (the JAX
# rule's PartitionSpec entries)
_COLUMN_PARALLEL = ("attn/qkv/kernel", "mlp/fc1/kernel")
_ROW_PARALLEL = ("attn/proj/kernel", "mlp/fc2/kernel")
_COLUMN_BIAS = ("attn/qkv/bias", "mlp/fc1/bias")
# the port's state-dict names of the split leaves
_SPLIT = re.compile(r"(^|\.)blocks\.\d+\.(attn\.(qkv|proj)|mlp\.(fc1|fc2))"
                    r"\.(weight|bias)$")


def _spec_for(path: str, ndim: int) -> tuple:
    if ndim == 2:
        if path.endswith(_COLUMN_PARALLEL):
            return (None, "model")
        if path.endswith(_ROW_PARALLEL):
            return ("model", None)
    if ndim == 1 and path.endswith(_COLUMN_BIAS):
        return ("model",)
    return ()


def vit_param_shardings(params: Dict, prefix: str = "") -> Dict:
    """The split of every leaf of a flax-named param tree (the whole probe
    tree or any subtree), as the JAX ``vit_param_shardings`` gives it: a
    tree of ``PartitionSpec`` entries as tuples, ``(None, "model")`` for
    the column-parallel kernels, ``("model", None)`` for the row-parallel
    ones, ``("model",)`` for the column-parallel biases and ``()``
    (replicated) for every other leaf."""
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        out[k] = (vit_param_shardings(v, path) if isinstance(v, dict)
                  else _spec_for(path, len(getattr(v, "shape", ()))))
    return out


def is_sharded(name: str) -> bool:
    """Whether a state-dict name is a leaf tensor parallelism splits."""
    return bool(_SPLIT.search(name)) and not (
        name.endswith(("proj.bias", "fc2.bias")))


def _cut(name: str, t: torch.Tensor, rank: int, size: int,
         heads: int) -> torch.Tensor:
    kind = name.rsplit(".", 2)[-2]
    if kind == "qkv":  # [3C(, in)]: whole heads of q, k and v
        c = t.shape[0] // 3
        if heads % size:
            raise ValueError(f"{heads} heads do not split over {size} ranks")
        w = c // size
        return torch.cat([t[j * c + rank * w:j * c + (rank + 1) * w]
                          for j in range(3)]).clone()
    if kind == "fc1":  # [hidden(, in)]
        w = t.shape[0] // size
        return t[rank * w:(rank + 1) * w].clone()
    # proj, fc2: the weight's input columns [out, in]
    w = t.shape[1] // size
    return t[:, rank * w:(rank + 1) * w].clone()


def shard_state_dict(state: Dict[str, torch.Tensor], rank: int, size: int,
                     heads: int) -> Dict[str, torch.Tensor]:
    """Rank ``rank``'s shard (of ``size``) of a full state dict of the
    port's model, whose blocks have ``heads`` heads."""
    return {k: (_cut(k, v, rank, size, heads) if is_sharded(k) else v)
            for k, v in state.items()}


def _join(name: str, parts: List[torch.Tensor]) -> torch.Tensor:
    kind = name.rsplit(".", 2)[-2]
    if kind == "qkv":
        thirds = [p.chunk(3) for p in parts]
        return torch.cat([torch.cat([t[j] for t in thirds])
                          for j in range(3)])
    if kind == "fc1":
        return torch.cat(parts)
    return torch.cat(parts, dim=1)


class _CopyToModel(torch.autograd.Function):
    """Megatron's f: the identity forward, an all-reduce of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    """Megatron's gather: every rank's slice of the last axis, joined in
    rank order, forward; the rank's own slice of the gradient backward
    (what follows is replicated, so every rank's gradient is the same)."""

    @staticmethod
    def forward(ctx, x, group, rank, size):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        lo = ctx.rank * ctx.width
        return grad[..., lo:lo + ctx.width], None, None, None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's g: an all-reduce forward, the identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _row_parallel(layer: nn.Linear, x: torch.Tensor, group) -> torch.Tensor:
    """A row-parallel layer: the partial product, summed over the group,
    then the bias once."""
    dt = compute_dtype(layer, layer.weight)
    y = _ReduceFromModel.apply(F.linear(x.to(dt), layer.weight.to(dt)),
                               group)
    return y + layer.bias.to(dt) if layer.bias is not None else y


class TPAttention(nn.Module):
    """A rank's heads of a block's attention: qkv column parallel (its
    ``[q_r | k_r | v_r]``), kernel A over ``heads/M`` heads, proj row
    parallel."""

    def __init__(self, attn: nn.Module, group, rank: int, size: int) -> None:
        super().__init__()
        self.qkv, self.proj = attn.qkv, attn.proj
        self.num_heads = attn.num_heads // size
        self.dh = attn.proj.weight.shape[0] // attn.num_heads
        self.group, self.rank, self.size = group, rank, size

    def forward(self, x: torch.Tensor, key_mask=None) -> torch.Tensor:
        qkv = self.qkv(_CopyToModel.apply(x, self.group))
        out = mha_qkv(qkv, self.num_heads, scale=self.dh**-0.5,
                      key_mask=key_mask)
        return _row_parallel(self.proj, out, self.group)

    def keys(self, x: torch.Tensor) -> torch.Tensor:
        """The full keys ``[B, N, C]``: this rank's heads' k columns,
        gathered over the model group in head order."""
        qkv = self.qkv(_CopyToModel.apply(x, self.group))
        c = qkv.shape[-1] // 3
        return _GatherFromModel.apply(qkv[..., c:2 * c], self.group,
                                      self.rank, self.size)


class TPMlp(nn.Module):
    """A rank's slice of a block's MLP: fc1 column parallel, fc2 row
    parallel."""

    def __init__(self, mlp: nn.Module, group) -> None:
        super().__init__()
        self.fc1, self.fc2 = mlp.fc1, mlp.fc2
        self.group = group

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.gelu(self.fc1(_CopyToModel.apply(x, self.group)),
                   approximate="none")
        return _row_parallel(self.fc2, h, self.group)


def shard_vit_tp(model: nn.Module, mesh) -> nn.Module:
    """Split every ViT block of ``model`` over ``mesh``'s model group, in
    place: each rank keeps its shard of the model's current weights (cut by
    :func:`shard_state_dict`) and runs the blocks through the f/g pairs.
    Returns ``model``. A mesh with one model rank leaves it as it is."""
    size, rank = mesh.model, mesh.model_index
    if size == 1:
        return model
    from isegprobe_torch.models.vit import Block
    from isegprobe_torch.ops.quant import QuantLinear

    state = model.state_dict()
    blocks = [(prefix, m) for prefix, m in model.named_modules()
              if isinstance(m, Block)]
    for prefix, block in blocks:
        if any(isinstance(m, QuantLinear) for m in block.modules()):
            raise ValueError("tensor parallelism of int8 (W8A8) blocks is "
                             "not supported")
        shard = shard_state_dict(
            {k: v for k, v in state.items() if k.startswith(f"{prefix}.")},
            rank, size, block.attn.num_heads)
        for name, layer in (("attn.qkv", block.attn.qkv),
                            ("attn.proj", block.attn.proj),
                            ("mlp.fc1", block.mlp.fc1),
                            ("mlp.fc2", block.mlp.fc2)):
            for leaf in ("weight", "bias"):
                old = getattr(layer, leaf)
                key = f"{prefix}.{name}.{leaf}"
                if old is not None and is_sharded(key):
                    setattr(layer, leaf, nn.Parameter(
                        shard[key], requires_grad=old.requires_grad))
            if layer.weight.shape == state[f"{prefix}.{name}.weight"].shape:
                raise ValueError(f"{prefix} is not a ViT's blocks.<i>: "
                                 "its layers were not split")
            layer.out_features, layer.in_features = layer.weight.shape
        block.attn = TPAttention(block.attn, mesh.model_group, rank, size)
        block.mlp = TPMlp(block.mlp, mesh.model_group)
    model.tp_mesh = mesh
    return model


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The full state dict of a model split by :func:`shard_vit_tp`,
    gathered over its model group (every rank of the group must call it;
    every rank gets it). A model that is not split gives its own."""
    mesh = getattr(model, "tp_mesh", None)
    state = model.state_dict()
    if mesh is None or mesh.model == 1:
        return state
    out = {}
    for k, v in state.items():
        if not is_sharded(k):
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(mesh.model)]
        dist.all_gather(parts, v.contiguous(), group=mesh.model_group)
        out[k] = _join(k, parts)
    return out
