"""metal_flash_attention_tpu_torch: the PyTorch / CUDA port of
`metal_flash_attention_tpu`, for an NVIDIA H100.

Each module mirrors the JAX package's file of the same name, so each has
one reference to be held against.  Plain tensor code is PyTorch; every
TPU kernel on a ported path becomes a kernel written by hand for Hopper
under `csrc/`, built with nvcc at first use (`native/build.py`), never
at import.  A CPU tensor runs the kernel's plain PyTorch version; a CUDA
tensor runs the kernel or raises.

Ported so far:

- slice 1, the paged serving engine: `ops.paged_attention` (kernel
  `csrc/paged_attention.cu`), `models.serving` (paged steps),
  `models.engine` (`ServingEngine`), `native.page_allocator`;
- slice 2, the training step: `ops.flash_attention` (kernel
  `csrc/flash_attention.cu`) and `ops.flash_attention_bwd` (kernels
  `csrc/flash_attention_bwd.cu`), `descriptors`, `dispatch`,
  `models.losses` (fused cross-entropy), `models.llama` (forward,
  loss, SGD demo step) and `models.optim` (AdamW with float32 master
  weights);
- slice 3, dense serving: `ops.flash_decode` (kernel
  `csrc/flash_decode.cu`) and the dense part of `models.serving`
  (`KVCache`, `init_cache`, `prefill`, `decode_step`, `generate`,
  `sink_decode`), whose prefill runs slice 2's fused forward;
- slice 4, the standalone ops: `ops.gemm` (`gemm`, `batched_gemm`,
  `gemm_chain`; kernel `csrc/gemm.cu`, dequantizing INT8 / FP8 / NF4
  weights inside it), `ops.quantization` (host side; `__device__`
  helpers in `csrc/quant_common.cuh`), `ops.softmax` (`scaled_softmax`,
  `derivative_softmax`; kernels `csrc/softmax.cu`) and
  `descriptors.gemm_descriptor`;
- slices 5 to 8 redesigned the kernels for Hopper (GEMM, fused forward,
  backward pair, decode family);
- slice 9, quantized KV serving: INT8 / FP8 / NF4 pages in
  `ops.paged_attention` (`QuantizedPagedKVCache`, `quantize_paged`) and
  `QuantizedTensor` caches in `ops.flash_decode`, decoded inside the
  kernels; the quantized steps of `models.serving` and the engine's
  ``kv_precision``;
- slice 10, the engine's sampling and bursts: `models.serving`
  (`sample_token`, `sample_token_per_row`, `generate_sampled`,
  `paged_decode_burst`, `paged_decode_burst_q`) and the engine's
  temperature / top_k / top_p, ``logprobs``, ``logit_bias``, ``seed``
  and `step_burst`;
- shared: `ops.reference`, `native.build`, `utils`.

Constructors (`init_params`, `params_from_numpy`, `init_cache`,
`init_paged_cache`, ...) put their tensors on the card unless the caller passes
``device="cpu"``.
"""

__version__ = "0.1.0"

from metal_flash_attention_tpu_torch.dispatch import attention
from metal_flash_attention_tpu_torch.models.engine import ServingEngine
from metal_flash_attention_tpu_torch.models.llama import (
    LlamaConfig,
    init_params,
)
from metal_flash_attention_tpu_torch.models.losses import fused_cross_entropy
from metal_flash_attention_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_forward,
)
from metal_flash_attention_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_backward,
)
from metal_flash_attention_tpu_torch.ops.flash_decode import flash_decode
from metal_flash_attention_tpu_torch.ops.gemm import batched_gemm, gemm
from metal_flash_attention_tpu_torch.ops.paged_attention import (
    LAUNCH_COUNTS,
    PagedKVCache,
    init_paged_cache,
    paged_append,
    paged_append_chunk,
    paged_decode,
    paged_prefill,
    reset_launch_counts,
)
from metal_flash_attention_tpu_torch.ops.quantization import (
    QuantizedMatrix,
    QuantizedTensor,
    quantize,
    quantize_matrix,
)
from metal_flash_attention_tpu_torch.ops.reference import attention_reference

__all__ = [
    "LAUNCH_COUNTS",
    "LlamaConfig",
    "PagedKVCache",
    "QuantizedMatrix",
    "QuantizedTensor",
    "ServingEngine",
    "attention",
    "attention_reference",
    "batched_gemm",
    "flash_attention",
    "flash_attention_backward",
    "flash_attention_forward",
    "flash_decode",
    "fused_cross_entropy",
    "gemm",
    "init_paged_cache",
    "init_params",
    "paged_append",
    "paged_append_chunk",
    "paged_decode",
    "paged_prefill",
    "quantize",
    "quantize_matrix",
    "reset_launch_counts",
    "__version__",
]
