"""GEMM problem descriptor and kernel configuration.

The port of the JAX package's `descriptors/gemm_descriptor.py`: the
problem (batch, M, N, K, per-operand memory precisions, transposes,
`load_previous_c`) and its work count.

On the TPU `kernel_config` chose block sizes by a VMEM budget, a config
cache and an autotune sweep on a miss.  The port's CUDA GEMM has one
fixed tile, defined in `csrc/flash_tiles.cuh` (``MFA_GEMM_*``), which the
kernel includes and `kernel_config` reads; H100 tables, the cache key and
autotune wait for the runtime slice (ROADMAP.md, port queue: runtime).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.native.build import tile_defines


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

    def kernel_config(self) -> GEMMKernelConfig:
        """The CUDA kernel's tile, as `csrc/flash_tiles.cuh` defines it."""
        defines = tile_defines()
        return GEMMKernelConfig(defines["MFA_GEMM_BLOCK_M"],
                                defines["MFA_GEMM_BLOCK_N"],
                                defines["MFA_GEMM_BLOCK_K"])

    @property
    def flops(self) -> int:
        return 2 * self.batch * self.m * self.n * self.k
