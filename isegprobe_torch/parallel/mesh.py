"""The device mesh on ``torch.distributed``: the port's counterpart of
``isegprobe_tpu/parallel/mesh.py`` (the reference's NCCL/DDP story,
core/utils/distributed.py and core/utils/exp.py:33-36).

One process a device. A ``(data, model)`` mesh of ``D × M`` ranks is laid
out data-major, as ``mesh_utils.create_device_mesh`` lays out JAX's device
array: rank ``d·M + m`` sits at data index ``d`` and model index ``m``.
Each rank belongs to one data group (the ``D`` ranks of its model index:
gradients are averaged over it) and one model group (the ``M`` ranks of its
data index: they share a batch, and tensor parallelism, ``parallel/tp.py``,
splits the ViT blocks over them). Each data index holds its rows of the
global batch: rows ``[d·b, (d+1)·b)`` of the ``D·b`` rows, the order in
which JAX's ``make_array_from_process_local_data`` assembles process-local
rows.

Without ``torch.distributed`` initialized, :func:`make_mesh` gives a
``1 × 1`` mesh with no groups, and every collective here does nothing; a
process group of one still runs them (an all-reduce of one rank leaves its
values as they are).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["Mesh", "maybe_init_distributed", "local_device", "make_mesh",
           "shard_batch", "put_global_batch", "process_is_master",
           "reduce_loss_dict", "all_reduce_mean"]


def _backend(backend: Optional[str]) -> str:
    if backend:
        return backend
    return "nccl" if torch.cuda.is_available() else "gloo"


def local_device(device=None, rank: Optional[int] = None) -> torch.device:
    """This process's device: ``device`` if given, else ``cuda:<local
    rank>`` (torchrun's ``LOCAL_RANK``, else the global rank, ``rank`` or
    the group's, modulo the visible GPUs) when a GPU is visible, else the
    CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    if local is None:
        if rank is None:
            rank = (dist.get_rank() if dist.is_initialized()
                    else int(os.environ.get("RANK", 0)))
        local = rank % torch.cuda.device_count()
    return torch.device("cuda", int(local))


def maybe_init_distributed(backend: Optional[str] = None) -> bool:
    """The multi-process launch gate, called by ``train.py`` before any
    device use (the JAX ``maybe_init_distributed``). It initializes only
    when a launch is configured, so a single-process run pays nothing:

    * ``ISEG_COORDINATOR=host:port`` with ``ISEG_NUM_PROCESSES`` and
      ``ISEG_PROCESS_ID``: ``init_process_group(init_method=
      "tcp://host:port")`` at that world size and rank (one command a
      process, the same coordinator);
    * ``ISEG_DISTRIBUTED=auto``: torchrun's ``env://`` rendezvous
      (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).

    The backend is NCCL when a GPU is visible and gloo otherwise (or
    ``backend``). Under NCCL the process's GPU (:func:`local_device`) is
    made current first. A group that fails to form raises. Returns True
    iff a process group was initialized."""
    coord = os.environ.get("ISEG_COORDINATOR")
    auto = os.environ.get("ISEG_DISTRIBUTED", "").lower() == "auto"
    if not coord and not auto:
        return False
    backend = _backend(backend)
    if coord:
        kwargs = dict(init_method=f"tcp://{coord}",
                      world_size=int(os.environ["ISEG_NUM_PROCESSES"]),
                      rank=int(os.environ["ISEG_PROCESS_ID"]))
    else:
        kwargs = dict(init_method="env://")
    if backend == "nccl":
        torch.cuda.set_device(local_device(rank=kwargs.get("rank")))
    dist.init_process_group(backend=backend, **kwargs)
    return True


@dataclass
class Mesh:
    """A ``(data, model)`` mesh of ranks; this process's place in it."""

    shape: Dict[str, int]
    rank: int = 0
    data_index: int = 0
    model_index: int = 0
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    data_group: object = None
    model_group: object = None

    @property
    def data(self) -> int:
        return self.shape["data"]

    @property
    def model(self) -> int:
        return self.shape["model"]

    @property
    def distributed(self) -> bool:
        return self.data_group is not None


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """The ``(data, model)`` mesh over ``n_devices`` ranks (by default the
    world; one process a device, so it must be the world size) with
    ``model_parallel`` ranks on the model axis. Every rank must call it:
    it makes one ``new_group`` for each data and model group, in the same
    order on every rank. ``device`` is this rank's device
    (:func:`local_device` by default)."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(
            f"a mesh of {n} devices needs {n} processes (one a device; "
            f"launch them with ISEG_COORDINATOR or torchrun), got a world "
            f"of {world}")
    model_parallel = int(model_parallel)
    if model_parallel < 1 or n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} must divide the "
                         f"{n} devices")
    d_size = n // model_parallel
    d, m = divmod(rank, model_parallel)
    mesh = Mesh(shape={"data": d_size, "model": model_parallel}, rank=rank,
                data_index=d, model_index=m, device=local_device(device))
    if not initialized:
        return mesh
    for mi in range(model_parallel):
        ranks = [di * model_parallel + mi for di in range(d_size)]
        group = dist.new_group(ranks)
        if mi == m:
            mesh.data_group = group
    for di in range(d_size):
        ranks = [di * model_parallel + mi for mi in range(model_parallel)]
        group = dist.new_group(ranks)
        if di == d:
            mesh.model_group = group
    return mesh


def shard_batch(batch: Dict, mesh: Mesh) -> Dict:
    """This rank's rows of a global host batch: rows ``[d·b, (d+1)·b)`` of
    each array's leading axis of ``D·b`` rows, as numpy."""
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        if v.shape[0] % mesh.data:
            raise ValueError(f"batch key {k!r}: {v.shape[0]} rows do not "
                             f"split over {mesh.data} data ranks")
        b = v.shape[0] // mesh.data
        out[k] = v[mesh.data_index * b:(mesh.data_index + 1) * b]
    return out


def put_global_batch(batch: Dict, mesh: Mesh,
                     multiprocess: Optional[bool] = None) -> Dict:
    """Batch placement for both launch modes, as torch tensors on the
    mesh's device. Several processes (the default when the mesh has
    groups): every process already holds only its rows (the loader's rank
    striding), so they go up as they are; the global batch is the data
    ranks' rows in data order. One process: the global batch, of which
    this rank takes its rows (:func:`shard_batch`). ``multiprocess``
    overrides the mode."""
    if multiprocess is None:
        multiprocess = mesh.distributed and mesh.data > 1
    rows = batch if multiprocess else shard_batch(batch, mesh)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(mesh.device)
            for k, v in rows.items()}


def process_is_master() -> bool:
    """'rank 0' of the reference's DDP world."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _reduce_device() -> torch.device:
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_loss_dict(loss_dict: Dict) -> Dict:
    """Scalar losses averaged over every process for logging (the
    reference's ``dist.reduce``, the JAX ``process_allgather`` mean); the
    dict as it is in a world of one. Every rank must call it."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_world_size() == 1:
        return loss_dict
    names = list(loss_dict)
    values = torch.tensor([float(loss_dict[k]) for k in names],
                          dtype=torch.float64, device=_reduce_device())
    dist.all_reduce(values)
    values = (values / dist.get_world_size()).tolist()
    return dict(zip(names, values))


def all_reduce_mean(tensors: List[torch.Tensor], group, size: int) -> None:
    """Average ``tensors`` in place over ``group`` (of ``size`` ranks) with
    one all-reduce of one flat bucket per dtype. Nothing happens without a
    group."""
    if group is None or not tensors:
        return
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group_tensors in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group_tensors])
        dist.all_reduce(flat, group=group)
        flat.div_(size)
        offset = 0
        for t in group_tensors:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()
