"""Runtime layer: device context, kernel-config cache, autotuning.

The port of the JAX package's `runtime/`.  The compiled artifacts are
the kernel libraries `native.build` makes (one a source and one a tile
variant); this layer holds what sits above them: the card's constants
(`DeviceContext`), the measured tile winners keyed by problem
(`KernelConfigCache`, persisted in JSON and a C++ store), and the sweeps
that measure them (`autotune_attention` and its GEMM and decode
siblings; `python -m metal_flash_attention_tpu_torch.runtime autotune`).
"""

from metal_flash_attention_tpu_torch.runtime.autotune import (
    autotune_attention,
)
from metal_flash_attention_tpu_torch.runtime.cache import KernelConfigCache
from metal_flash_attention_tpu_torch.runtime.context import DeviceContext

__all__ = ["DeviceContext", "KernelConfigCache", "autotune_attention"]
