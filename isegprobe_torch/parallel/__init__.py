"""Data and tensor parallelism on ``torch.distributed`` (the JAX package's
``parallel/``: the device mesh and the Megatron rules)."""

from isegprobe_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    maybe_init_distributed,
    process_is_master,
    put_global_batch,
    reduce_loss_dict,
    shard_batch,
)

__all__ = ["Mesh", "make_mesh", "maybe_init_distributed",
           "process_is_master", "put_global_batch", "reduce_loss_dict",
           "shard_batch"]
