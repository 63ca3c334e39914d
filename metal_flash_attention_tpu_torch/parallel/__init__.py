"""Distribution over `torch.distributed`: the device mesh, the
collectives of data-, head-, context- and expert-parallel training and
serving, head-, data- and context-parallel attention, ring and zigzag
ring attention, and the GPipe pipeline.

The port of the JAX package's `parallel/`.  Each rank is one process
holding its own block of every sharded tensor (`parallel.mesh`); the
collectives that carry a gradient are `torch.autograd.Function`s there,
and so are ring and zigzag attention (`parallel.ring_attention`,
`parallel.zigzag`: K/V shards rotating over the context axis, with their
backward) and the pipeline's stage-to-stage hop (`parallel.pipeline`).
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
from metal_flash_attention_tpu_torch.parallel.ring_attention import (
    ring_attention,
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
    "ring_attention",
    "sharded_flash_attention",
    "context_parallel_attention",
    "context_parallel_decode",
    "shard_paged_cache_pages",
    "context_parallel_paged_decode",
]

from metal_flash_attention_tpu_torch.parallel.zigzag import (
    zigzag_ring_attention,
    zigzag_shard,
    zigzag_unshard,
)

__all__ += [
    "zigzag_ring_attention",
    "zigzag_shard",
    "zigzag_unshard",
]

from metal_flash_attention_tpu_torch.parallel.pipeline import (
    STAGE_AXIS,
    make_pipeline_mesh,
    pipeline,
    stack_stage_params,
    stage_param_sharding,
)

__all__ += [
    "pipeline",
    "make_pipeline_mesh",
    "stack_stage_params",
    "stage_param_sharding",
    "STAGE_AXIS",
]
