"""Operand precision enum (torch dtypes).

The port of the JAX package's `descriptors/precision.py`: the same
seven members with the same names and values.  FP32, FP16 and BF16 are
full-precision operands; FP8-E4M3, FP8-E5M2, INT8 and NF4 are quantized
storage with a per-head scale: the GEMM's weights, the paged pools and
dense caches of quantized-KV serving (the paged and dense decode paths
and the engine's ``kv_precision``) take them.
"""

from __future__ import annotations

import enum

import torch


class OperandPrecision(enum.Enum):
    FP32 = "fp32"
    FP16 = "fp16"
    BF16 = "bf16"
    FP8_E4M3 = "fp8_e4m3"
    FP8_E5M2 = "fp8_e5m2"
    INT8 = "int8"
    NF4 = "nf4"

    @property
    def storage_dtype(self) -> torch.dtype:
        """Dtype of the operand as stored in device memory (NF4 packs
        two values per uint8 byte)."""
        return {
            OperandPrecision.FP32: torch.float32,
            OperandPrecision.FP16: torch.float16,
            OperandPrecision.BF16: torch.bfloat16,
            OperandPrecision.FP8_E4M3: torch.float8_e4m3fn,
            OperandPrecision.FP8_E5M2: torch.float8_e5m2,
            OperandPrecision.INT8: torch.int8,
            OperandPrecision.NF4: torch.uint8,
        }[self]

    @property
    def compute_dtype(self) -> torch.dtype:
        """Dtype fed to the tensor cores; quantized operands compute in
        bf16 after dequantization."""
        if self is OperandPrecision.FP32:
            return torch.float32
        if self is OperandPrecision.FP16:
            return torch.float16
        return torch.bfloat16

    @property
    def bits(self) -> int:
        return {
            OperandPrecision.FP32: 32,
            OperandPrecision.FP16: 16,
            OperandPrecision.BF16: 16,
            OperandPrecision.FP8_E4M3: 8,
            OperandPrecision.FP8_E5M2: 8,
            OperandPrecision.INT8: 8,
            OperandPrecision.NF4: 4,
        }[self]

    @property
    def requires_scale(self) -> bool:
        return self in (OperandPrecision.FP8_E4M3, OperandPrecision.FP8_E5M2,
                        OperandPrecision.INT8, OperandPrecision.NF4)

    @property
    def is_quantized(self) -> bool:
        return self.requires_scale

    @classmethod
    def from_dtype(cls, dtype: torch.dtype) -> "OperandPrecision":
        table = {
            torch.float32: cls.FP32,
            torch.float16: cls.FP16,
            torch.bfloat16: cls.BF16,
            torch.float8_e4m3fn: cls.FP8_E4M3,
            torch.float8_e5m2: cls.FP8_E5M2,
            torch.int8: cls.INT8,
        }
        return table[dtype]
