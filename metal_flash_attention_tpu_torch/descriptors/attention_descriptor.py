"""Problem-level attention descriptor and kernel-config resolution.

The port of the JAX package's `descriptors/attention_descriptor.py`: a
hashable problem description (shapes, precisions, masking family) that
`dispatch` caches callables on, and the three-kernel family it resolves
to (forward, backwardQuery, backwardKeyValue).

`kernel_config` resolves a kernel's tile as the JAX package resolves its
blocks (`resolve_kernel_config`): a caller's ``block_q`` / ``block_kv``
clamped to the card's rules, else a measured winner from the runtime's
config cache, else the H100 table (`descriptors.parameters`), whose rows
are the kernels' default tiles in `csrc/flash_tiles.cuh` (`kernel_tiles`
reads them), else a one-time sweep on a miss.  A `KernelConfig` names the
library variant that launches its tile (`library`: () for the plain
library, else the -D pairs of `native.build`'s variant).
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
    """Resolved per-kernel configuration; ``library`` names the variant
    that launches the tile (() for the plain library)."""
    kernel_type: AttentionKernelType
    block_q: int
    block_kv: int
    head_dim: int
    compute_dtype: torch.dtype
    accumulator_dtype: torch.dtype = torch.float32
    library: tuple = ()


# Resolved configs by problem, kept while the config cache is unchanged
# (its identity and version are part of the key): a launch pays a dict
# lookup, not a table walk.
_RESOLVED: dict = {}


def resolve_kernel_config(kernel_type: AttentionKernelType, head_dim: int,
                          dtype: torch.dtype, *,
                          q_len: Optional[int] = None, causal: bool = False,
                          block_q: Optional[int] = None,
                          block_kv: Optional[int] = None, device=None,
                          generation: Optional[str] = None) -> KernelConfig:
    """The tile a launch of ``kernel_type`` takes: the caller's
    (``block_q`` / ``block_kv``, either one completing the resolved
    tile) clamped to the card's rules, else `select_block_sizes` on the
    ``_causal`` table for causal or windowed problems, with the q_len
    bucket reaching the tuned-winner lookup.  ``device``: the card (None:
    the default card)."""
    from metal_flash_attention_tpu_torch.descriptors import parameters
    from metal_flash_attention_tpu_torch.runtime.cache import (
        KernelConfigCache,
    )

    cache = KernelConfigCache.get()
    bucket = None if q_len is None else 1 << (max(q_len, 1) - 1).bit_length()
    key = (id(cache), cache.version, kernel_type, head_dim, dtype, bucket,
           causal, block_q, block_kv, None if device is None else
           str(device), generation)
    hit = _RESOLVED.get(key)
    if hit is not None:
        return hit
    table = kernel_type.value + ("_causal" if causal else "")
    limit = parameters.smem_limit(device)
    if block_q is None or block_kv is None:
        bq, bkv = parameters.select_block_sizes(
            table, head_dim, dtype, seq_len=bucket, device=device,
            generation=generation)
        block_q, block_kv = block_q or bq, block_kv or bkv
    bq, bkv = parameters.clamp_to_card(table, block_q, block_kv, head_dim,
                                       limit=limit)
    config = KernelConfig(
        kernel_type=kernel_type, block_q=bq, block_kv=bkv,
        head_dim=head_dim, compute_dtype=dtype,
        library=parameters.tile_library(table, bq, bkv, head_dim))
    _RESOLVED[key] = config
    return config


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

    def kernel_config(self, kernel_type: AttentionKernelType, *,
                      generation: Optional[str] = None,
                      block_q: Optional[int] = None,
                      block_kv: Optional[int] = None,
                      device=None) -> KernelConfig:
        """``kernel_type``'s tile for this problem (`resolve_kernel_config`:
        the caller's, a tuned winner, the table's; causal or windowed
        problems read the ``_causal`` entries)."""
        return resolve_kernel_config(
            kernel_type, self.head_dim, self.input_precision.compute_dtype,
            q_len=self.q_len,
            causal=self.causal or self.window_size is not None,
            block_q=block_q, block_kv=block_kv, device=device,
            generation=generation)
