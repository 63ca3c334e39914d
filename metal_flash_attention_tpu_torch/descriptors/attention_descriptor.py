"""Problem-level attention descriptor and kernel-config resolution.

The port of the JAX package's `descriptors/attention_descriptor.py`: a
hashable problem description (shapes, precisions, masking family) that
`dispatch` caches callables on, and the three-kernel family it resolves
to (forward, backwardQuery, backwardKeyValue).

On the TPU `kernel_config` read block sizes from measured parameter
tables and an autotune cache.  The port's CUDA kernels have one fixed
tile each, defined in `csrc/flash_tiles.cuh`, which the kernels include
and `kernel_tiles` reads, so `kernel_config` returns that tile; H100
tables and autotune wait for the runtime module (ROADMAP.md, port queue:
runtime).
"""

from __future__ import annotations

import enum
import functools
import math
from dataclasses import dataclass
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.native.build import (  # noqa: F401
    TILES_HEADER,
    tile_defines,
)


class AttentionKernelType(enum.Enum):
    """The three-kernel family."""
    FORWARD = "forward"                        # computes O, L
    BACKWARD_QUERY = "backward_query"          # computes dQ; needs L, D
    BACKWARD_KEY_VALUE = "backward_key_value"  # computes dK, dV; needs L, D


# Each kernel's `csrc/flash_tiles.cuh` prefix: (head dims 64 and 128,
# head dim 256).
_TILE_PREFIX = {
    AttentionKernelType.FORWARD: ("FWD90", "FWD90_D256"),
    AttentionKernelType.BACKWARD_QUERY: ("BWD90_DQ", "BWD90_D256_DQ"),
    AttentionKernelType.BACKWARD_KEY_VALUE: ("BWD90_DKV", "BWD90_D256_DKV")}


@functools.cache
def kernel_tiles(head_dim: int = 128
                 ) -> dict[AttentionKernelType, tuple[int, int]]:
    """(block_q, block_kv) of each CUDA kernel at ``head_dim``, as
    `csrc/flash_tiles.cuh` defines them for the kernels (each has its own
    at head_dim 256)."""
    defines = tile_defines()
    return {kind: (defines[f"MFA_{p}_BLOCK_Q"], defines[f"MFA_{p}_BLOCK_KV"])
            for kind, p in ((kind, prefixes[head_dim > 128])
                            for kind, prefixes in _TILE_PREFIX.items())}


@dataclass(frozen=True)
class KernelConfig:
    """Resolved per-kernel configuration."""
    kernel_type: AttentionKernelType
    block_q: int
    block_kv: int
    head_dim: int
    compute_dtype: torch.dtype
    accumulator_dtype: torch.dtype = torch.float32


@dataclass(frozen=True)
class AttentionDescriptor:
    """Problem description; hashable, the dispatch cache's key."""
    batch: int = 1
    q_heads: int = 1
    kv_heads: int = 1
    q_len: int = 1
    kv_len: int = 1
    head_dim: int = 64
    input_precision: OperandPrecision = OperandPrecision.FP32
    # Storage precision of O; None -> same as the inputs.
    output_precision: Optional[OperandPrecision] = None
    low_precision_intermediates: bool = False
    kv_precision: Optional[OperandPrecision] = None  # quantized KV cache
    causal: bool = False
    has_mask: bool = False
    has_mask2: bool = False
    has_bias: bool = False
    has_segments: bool = False
    window_size: Optional[int] = None
    # Softmax scale; None -> 1/sqrt(head_dim).
    scale: Optional[float] = None
    logit_softcap: Optional[float] = None

    @property
    def resolved_scale(self) -> float:
        return (self.scale if self.scale is not None
                else 1.0 / math.sqrt(self.head_dim))

    @property
    def quantized_kv(self) -> bool:
        return self.kv_precision is not None and self.kv_precision.is_quantized

    def kernel_config(self, kernel_type: AttentionKernelType) -> KernelConfig:
        """The fixed tile of ``kernel_type``'s CUDA kernel."""
        block_q, block_kv = kernel_tiles(self.head_dim)[kernel_type]
        return KernelConfig(kernel_type=kernel_type, block_q=block_q,
                            block_kv=block_kv, head_dim=self.head_dim,
                            compute_dtype=self.input_precision.compute_dtype)
