from .mesh import make_mesh, batch_sharding, shard_batch
from .multihost import initialize_multihost, global_mesh, allreduce_counts
from .staged import sharded_staged_decode, staged_local_eval
from .spmd import (
    sharded_batch_decode,
    decode_with_stats,
    sharded_mixed_decode,
    make_check_sharded_minsum_fn,
    make_check_sharded_sumproduct_fn,
)

__all__ = [
    "make_mesh",
    "batch_sharding",
    "shard_batch",
    "sharded_batch_decode",
    "decode_with_stats",
    "sharded_mixed_decode",
    "make_check_sharded_minsum_fn",
    "make_check_sharded_sumproduct_fn",
    "initialize_multihost",
    "global_mesh",
    "allreduce_counts",
    "sharded_staged_decode",
    "staged_local_eval",
]
