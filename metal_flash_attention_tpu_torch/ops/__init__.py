"""Compute ops.  The slice-4 standalone ops are exported here, as the
JAX package's `ops/__init__.py` exports them; the attention ops are
imported from their modules."""

from metal_flash_attention_tpu_torch.ops.gemm import batched_gemm, gemm
from metal_flash_attention_tpu_torch.ops.quantization import (
    QuantizedMatrix,
    QuantizedTensor,
    dequantize,
    dequantize_matrix,
    quantize,
    quantize_matrix,
)
from metal_flash_attention_tpu_torch.ops.softmax import (
    derivative_softmax,
    scaled_softmax,
)

__all__ = [
    "gemm",
    "batched_gemm",
    "quantize",
    "dequantize",
    "quantize_matrix",
    "dequantize_matrix",
    "QuantizedTensor",
    "QuantizedMatrix",
    "scaled_softmax",
    "derivative_softmax",
]
