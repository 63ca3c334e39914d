"""Distribution over `torch.distributed`: the device mesh, the
collectives of data-, head- and expert-parallel training and serving,
and the head-, data- and context-parallel attention.

The port of the JAX package's `parallel/` for serving and for training
over the data and heads axes.  Each rank is one process holding its own
block of every sharded tensor (`parallel.mesh`); the collectives that
carry a gradient are `torch.autograd.Function`s there.  Not ported yet:
`ring_attention`, the `zigzag_*` functions and `pipeline`, so a training
mesh with a context axis of more than one rank raises (ROADMAP.md, port
queue: sharded training).
"""

from metal_flash_attention_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS,
    DATA_AXIS,
    HEAD_AXIS,
    NamedSharding,
    P,
    PartitionSpec,
    make_mesh,
    shard,
    unshard,
)
from metal_flash_attention_tpu_torch.parallel.sharded_attention import (
    context_parallel_attention,
    context_parallel_decode,
    context_parallel_paged_decode,
    shard_paged_cache_pages,
    sharded_flash_attention,
)

__all__ = [
    "make_mesh",
    "DATA_AXIS",
    "HEAD_AXIS",
    "CONTEXT_AXIS",
    "PartitionSpec",
    "P",
    "NamedSharding",
    "shard",
    "unshard",
    "sharded_flash_attention",
    "context_parallel_attention",
    "context_parallel_decode",
    "shard_paged_cache_pages",
    "context_parallel_paged_decode",
]
