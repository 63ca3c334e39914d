"""Device context: the card's constants for tile rules and bounds.

The port of the JAX package's `runtime/context.py`.  Where JAX held a
table of TPU generations (`TpuGenerationInfo`), the port holds a
`CudaGenerationInfo` per card: the peak dense bf16 rate and the memory
rate come from a table keyed by the generation parsed from
`torch.cuda.get_device_name()` ("NVIDIA H100 80GB HBM3" -> ``h100``);
the SM count, the shared memory a block may opt into and the L2's size
come from `torch.cuda.get_device_properties` on the card itself.  The
``cpu`` row (JAX's rates) serves CPU runs, whose tile rules read the
kernels' own shared-memory limit (the 232,448 bytes of their
``static_assert``s, an H100 block's opt-in).
"""

from __future__ import annotations

from dataclasses import dataclass
import torch

from metal_flash_attention_tpu_torch.utils.device import resolve_device

# The shared memory every kernel of `csrc/` asserts it fits in: an H100
# block's opt-in (227 KiB).
KERNEL_SMEM_LIMIT = 232448


@dataclass(frozen=True)
class CudaGenerationInfo:
    """One card's constants."""
    name: str
    peak_bf16_flops: float   # dense, per card
    hbm_bandwidth: float     # bytes/s per card
    smem_per_block: int      # shared memory a block may opt into
    sm_count: int
    l2_bytes: int


# Peak dense bf16 FLOP/s and memory bytes/s by generation: the H100 SXM
# and H200 data sheets (989.4 TFLOP/s dense; 3.35 and 4.8 TB/s), the
# A100 SXM 80GB data sheet (312 TFLOP/s, 2.039 TB/s); cpu as in the JAX
# package.
_RATES = {
    "h100": (989e12, 3.35e12),
    "h200": (989e12, 4.8e12),
    "a100": (312e12, 2.039e12),
    "cpu": (1e12, 0.1e12),
}


class DeviceContext:
    """The card's context, one a device (reference: `MTLContext.global`).

    `get(device=None)`: ``None`` is the card (it raises without one, as
    every entry point of the port does); ``"cpu"`` gives the cpu row."""

    _instances: dict = {}

    def __init__(self, device=None) -> None:
        dev = resolve_device(device)
        self.platform: str = dev.type
        if dev.type == "cuda":
            index = dev.index if dev.index is not None else \
                torch.cuda.current_device()
            props = torch.cuda.get_device_properties(index)
            self.device_kind: str = torch.cuda.get_device_name(index)
            self.num_devices: int = torch.cuda.device_count()
            self.generation: str = self._parse_generation(self.device_kind)
            card = (props.shared_memory_per_block_optin,
                    props.multi_processor_count, props.L2_cache_size)
        elif dev.type == "cpu":
            self.device_kind = "cpu"
            self.num_devices = 1
            self.generation = "cpu"
            card = (KERNEL_SMEM_LIMIT, 1, 0)
        else:
            raise ValueError(f"no device context for {dev}")
        self.num_local_devices: int = self.num_devices
        self.info: CudaGenerationInfo = CudaGenerationInfo(
            self.generation, *_RATES[self.generation], *card)

    @staticmethod
    def _parse_generation(kind: str) -> str:
        """"NVIDIA H100 80GB HBM3" -> "h100"; a card with no row -> "cpu",
        as the JAX package maps an unknown device kind."""
        k = kind.lower()
        for gen in ("h200", "h100", "a100"):
            if gen in k:
                return gen
        return "cpu"

    @classmethod
    def get(cls, device=None) -> "DeviceContext":
        key = str(resolve_device(device))
        if key not in cls._instances:
            cls._instances[key] = cls(device)
        return cls._instances[key]

    @classmethod
    def reset(cls) -> None:
        """Drop every context (tests)."""
        cls._instances.clear()

    # ---- roofline accounting (reference: README.md:104-129) ----------

    @property
    def roofline_ginstrs_per_s(self) -> float:
        """GINSTRS = FLOPS / 2 (one FMA = 2 FLOPs), the reference's
        throughput unit."""
        return self.info.peak_bf16_flops / 2.0 / 1e9

    def attention_ginstrs(self, n: int, d: int, *, heads: int = 1,
                          with_backward: bool = False,
                          causal: bool = False) -> float:
        """Work model: fwd (2D+5)N^2, fwd+bwd (9D+15)N^2 (reference
        `README.md:41-46`), halved when causal."""
        per = (9 * d + 15) if with_backward else (2 * d + 5)
        work = per * n * n * heads
        return work / 2 if causal else work


def default_generation() -> str:
    """The generation of the card, or "cpu" on a machine without one: the
    generation a cache key names when none is given."""
    if torch.cuda.is_available():
        return DeviceContext.get().generation
    return "cpu"

