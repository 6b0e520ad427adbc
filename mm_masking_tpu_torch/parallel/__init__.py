"""Data parallelism over cards (counterpart of ``mm_masking_tpu.parallel``)."""
from mm_masking_tpu_torch.parallel.mesh import (
    Mesh,
    ShardedBatch,
    backend_for,
    batch_mesh,
    init_distributed,
    make_mesh,
    replicate,
    shard_axis,
    shard_batch,
)

__all__ = [
    "Mesh",
    "ShardedBatch",
    "backend_for",
    "batch_mesh",
    "init_distributed",
    "make_mesh",
    "replicate",
    "shard_axis",
    "shard_batch",
]
