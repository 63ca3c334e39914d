"""GEMM problem descriptor and kernel configuration.

The port of the JAX package's `descriptors/gemm_descriptor.py`: the
problem (batch, M, N, K, per-operand memory precisions, transposes,
`load_previous_c`) and its work count.

On the TPU `kernel_config` chose block sizes by a VMEM budget, a config
cache and an autotune sweep on a miss.  The port's CUDA GEMM has one
fixed tile a route (`ops/gemm.py` `_route`), defined in
`csrc/flash_tiles.cuh` (``MFA_GEMM_*`` for "mma", ``MFA_GEMM90_*`` for
"sm90"), which the kernels include and `kernel_config` reads; H100
tables, the cache key and autotune wait for the runtime slice (ROADMAP.md,
port queue: runtime).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.native.build import tile_defines

_TILE_PREFIX = {"mma": "MFA_GEMM", "sm90": "MFA_GEMM90"}


@dataclass(frozen=True)
class GEMMKernelConfig:
    """Resolved block geometry: the output tile and the K step."""
    block_m: int
    block_n: int
    block_k: int


@dataclass(frozen=True)
class GEMMDescriptor:
    """Problem description; hashable."""
    m: int
    n: int
    k: int
    precision_a: OperandPrecision = OperandPrecision.FP32
    precision_b: OperandPrecision = OperandPrecision.FP32
    precision_out: Optional[OperandPrecision] = None
    transpose_a: bool = False
    transpose_b: bool = False
    batch: int = 1
    load_previous_c: bool = False

    def kernel_config(self, route: str = "mma") -> GEMMKernelConfig:
        """The tile of the CUDA kernel that `route` ("mma" or "sm90")
        launches, as `csrc/flash_tiles.cuh` defines it.  The sm90 tile is
        taller for a quantized B (each decoded element feeds more rows)
        and narrow at a decode batch (M <= MFA_GEMM90_DECODE_M), so that
        more blocks stream the weight."""
        if route not in _TILE_PREFIX:
            raise ValueError(f"route must be 'mma' or 'sm90', got {route!r}")
        d, prefix = tile_defines(), _TILE_PREFIX[route]
        block_m, block_n = d[f"{prefix}_BLOCK_M"], d[f"{prefix}_BLOCK_N"]
        if route == "sm90":
            if self.m <= d["MFA_GEMM90_DECODE_M"]:
                block_n = d["MFA_GEMM90_BLOCK_N_DECODE"]
            elif self.precision_b.is_quantized:
                block_m = d["MFA_GEMM90_QUANT_BLOCK_M"]
                block_n = d["MFA_GEMM90_QUANT_BLOCK_N"]
        return GEMMKernelConfig(block_m, block_n, d[f"{prefix}_BLOCK_K"])

    @property
    def flops(self) -> int:
        return 2 * self.batch * self.m * self.n * self.k
