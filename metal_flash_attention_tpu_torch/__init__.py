"""metal_flash_attention_tpu_torch: the PyTorch / CUDA port of
`metal_flash_attention_tpu`, for an NVIDIA H100.

Each module mirrors the JAX package's file of the same name, so each has
one reference to be held against.  Plain tensor code is PyTorch; every
TPU kernel on a ported path becomes a kernel written by hand for Hopper
under `csrc/`, built with nvcc at first use (`native/build.py`), never
at import.  A CPU tensor runs the kernel's plain PyTorch version; a CUDA
tensor runs the kernel or raises.

Ported so far (slice 1, the paged serving engine): `ops.paged_attention`
(kernel `csrc/paged_attention.cu`), `ops.reference`, `models.llama`
(serving blocks), `models.serving` (paged steps), `models.engine`
(`ServingEngine`), `native.page_allocator`, `utils`.
"""

__version__ = "0.1.0"

from metal_flash_attention_tpu_torch.models.engine import ServingEngine
from metal_flash_attention_tpu_torch.models.llama import (
    LlamaConfig,
    init_params,
)
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
from metal_flash_attention_tpu_torch.ops.reference import attention_reference

__all__ = [
    "LAUNCH_COUNTS",
    "LlamaConfig",
    "PagedKVCache",
    "ServingEngine",
    "attention_reference",
    "init_paged_cache",
    "init_params",
    "paged_append",
    "paged_append_chunk",
    "paged_decode",
    "paged_prefill",
    "reset_launch_counts",
    "__version__",
]
