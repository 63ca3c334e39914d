"""GEMM problem descriptor and kernel-config resolution.

The port of the JAX package's `descriptors/gemm_descriptor.py`: the
problem (batch, M, N, K, per-operand memory precisions, transposes,
`load_previous_c`), its canonical cache key and work count, and the tile
its kernel launches with.

`kernel_config(route)` resolves the tile of the route `ops/gemm.py`
picks ("sm90" or "mma"), as the JAX package resolves its blocks: the
caller's ``block_m`` / ``block_n`` / ``block_k`` clamped to the card's
rules, else a measured winner from the runtime's config cache
(`cache_key`), else the route's table row (`csrc/flash_tiles.cuh`:
``MFA_GEMM90_*`` for sm90, taller for a quantized B and narrow at a
decode batch; ``MFA_GEMM_*`` for mma), else, on a card the table was not
measured on, a one-time sweep (`runtime.autotune.autotune_gemm_descriptor`).

The card's rules (`gemm_tile_legal`, from csrc/gemm.cu's
`static_assert`s): the sm90 tile is 128 or 256 rows by 128 or 256
columns with at most 128 x 256 accumulators (128 a consumer thread), a
K step of 64, and at least three ring stages beside the decoded tiles in
the shared memory a block may opt into; the mma route has one tile
(128 x 128, K step 32).  The plain library holds, for each class of B,
the decode tile and the class's table tile; any other legal tile
launches from a variant library (`GEMMKernelConfig.library`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.native.build import tile_defines

_TILE_PREFIX = {"mma": "MFA_GEMM", "sm90": "MFA_GEMM90"}
# The sm90 kernel's widths and its largest tile (BM x BN accumulators
# over two consumer warpgroups); its ring (csrc/gemm.cu `Ring90`).
SM90_WIDTHS = (128, 256)
SM90_MAX_AREA = 128 * 256
SM90_DECODED_TILES = 3
SM90_SMEM_SLACK = 2048


@dataclass(frozen=True)
class GEMMKernelConfig:
    """Resolved block geometry: the output tile and the K step, and the
    library variant that launches it (() for the plain library)."""
    block_m: int
    block_n: int
    block_k: int
    library: tuple = ()


def gemm_tile_legal(block_m: int, block_n: int, quantized_b: bool,
                    limit: int) -> bool:
    """Whether the sm90 kernel builds and launches this tile for a bf16
    (``quantized_b`` False) or byte-format B in ``limit`` bytes of shared
    memory a block (`Ring90`'s asserts and sums)."""
    if block_m not in SM90_WIDTHS or block_n not in SM90_WIDTHS or \
            block_m * block_n > SM90_MAX_AREA:
        return False
    step = tile_defines()["MFA_GEMM90_BLOCK_K"]
    a_tile, b_tile = block_m * step * 2, block_n * step * 2
    stage = a_tile + (block_n * step if quantized_b else b_tile)
    decoded = SM90_DECODED_TILES * b_tile if quantized_b else 0
    stages = min((limit - SM90_SMEM_SLACK - decoded) // stage,
                 tile_defines()["MFA_GEMM90_STAGES"])
    ring = stages * stage + decoded
    return (stages >= 3 and ring + 2 * stages * 8 + 32 + 1024 <= limit
            and block_m * (block_n + 8) * 4 <= ring)


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

    def cache_key(self, generation: Optional[str] = None) -> str:
        """The JAX package's key (sizes bucketed to powers of two, A's
        stored dtype, the transposes, the card), with each quantized
        operand's precision after it: a winner for an INT8 weight is not
        a bf16 weight's."""
        from metal_flash_attention_tpu_torch.runtime.cache import (
            KernelConfigCache,
        )

        def bucket(x: int) -> int:
            return 1 << max(x - 1, 1).bit_length()

        key = KernelConfigCache.gemm_key(
            bucket(self.m), bucket(self.n), bucket(self.k),
            self.precision_a.storage_dtype, self.transpose_a,
            self.transpose_b, generation=generation)
        for side, p in (("a", self.precision_a), ("b", self.precision_b)):
            if p.is_quantized:
                key += f"|{side}{p.value}"
        return key

    def table_config(self, route: str = "mma") -> GEMMKernelConfig:
        """The route's table tile, as `csrc/flash_tiles.cuh` defines it:
        the sm90 tile is taller for a quantized B (each decoded element
        feeds more rows) and narrow at a decode batch (M <=
        MFA_GEMM90_DECODE_M), so that more blocks stream the weight."""
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

    def clamp(self, route: str, block_m: int, block_n: int, *,
              limit: Optional[int] = None) -> tuple[int, int]:
        """The legal tile nearest (block_m, block_n) on ``route``: the
        largest legal tile inside it, else the one closest by powers of
        two (the mma route's one tile)."""
        import math

        from metal_flash_attention_tpu_torch.descriptors.parameters import (
            smem_limit,
        )
        table = self.table_config(route)
        if route == "mma":
            return table.block_m, table.block_n
        limit = smem_limit() if limit is None else limit
        quant = self.precision_b.is_quantized
        legal = [(a, b) for a in SM90_WIDTHS for b in SM90_WIDTHS
                 if gemm_tile_legal(a, b, quant, limit)]
        bm, bn = max(int(block_m), 1), max(int(block_n), 1)
        return min(legal, key=lambda t: (
            not (t[0] <= bm and t[1] <= bn),
            abs(math.log2(t[0] / bm)) + abs(math.log2(t[1] / bn)),
            -t[0] * t[1]))

    def library(self, route: str, block_m: int, block_n: int) -> tuple:
        """The library variant that launches this tile: () where the plain
        library holds it (the decode tile and B's class's table tile),
        else the -D pairs of the class's tile macros."""
        if route == "mma":
            return ()
        d = tile_defines()
        quant = self.precision_b.is_quantized
        plain = {(d["MFA_GEMM90_BLOCK_M"], d["MFA_GEMM90_BLOCK_N_DECODE"]),
                 (d["MFA_GEMM90_QUANT_BLOCK_M"], d["MFA_GEMM90_QUANT_BLOCK_N"])
                 if quant else (d["MFA_GEMM90_BLOCK_M"],
                                d["MFA_GEMM90_BLOCK_N"])}
        if (block_m, block_n) in plain:
            return ()
        prefix = "MFA_GEMM90_QUANT" if quant else "MFA_GEMM90"
        return tuple(sorted(((f"{prefix}_BLOCK_M", int(block_m)),
                             (f"{prefix}_BLOCK_N", int(block_n)))))

    def kernel_config(self, route: str = "mma", *,
                      block_m: Optional[int] = None,
                      block_n: Optional[int] = None,
                      block_k: Optional[int] = None,
                      generation: Optional[str] = None,
                      device=None) -> GEMMKernelConfig:
        """The tile ``route``'s kernel launches with (module docstring):
        the caller's, a tuned winner, the table's, or a miss's sweep.
        ``block_k`` is clamped to the route's K step."""
        from metal_flash_attention_tpu_torch.descriptors import parameters
        from metal_flash_attention_tpu_torch.runtime.cache import (
            KernelConfigCache,
        )
        from metal_flash_attention_tpu_torch.runtime.context import (
            default_generation,
        )

        table = self.table_config(route)
        del block_k
        if block_m is not None or block_n is not None:
            bm, bn = self.clamp(route, block_m or table.block_m,
                                block_n or table.block_n,
                                limit=parameters.smem_limit(device))
            return GEMMKernelConfig(bm, bn, table.block_k,
                                    self.library(route, bm, bn))
        gen = generation or default_generation()
        key = self.cache_key(gen)
        tuned = KernelConfigCache.get().lookup(key)
        if tuned is None and gen not in (parameters.TUNED_GENERATION,
                                         "cpu") \
                and parameters.autotune_on_miss_enabled(device) \
                and key not in parameters._MISS_SWEEP_ACTIVE:
            tuned = self._sweep_miss(route, table, key, device, gen)
        if tuned is None:
            return table
        bm, bn = self.clamp(route, *tuned, limit=parameters.smem_limit(device))
        return GEMMKernelConfig(bm, bn, table.block_k,
                                self.library(route, bm, bn))

    def _sweep_miss(self, route, table, key, device, generation):
        """A one-time sweep of the table tile and its legal neighbours
        (`autotune_gemm_descriptor`); its winner persists under ``key``.
        None where the sweep cannot run."""
        import logging

        from metal_flash_attention_tpu_torch.descriptors import parameters

        parameters._MISS_SWEEP_ACTIVE.add(key)
        try:
            from metal_flash_attention_tpu_torch.runtime.autotune import (
                autotune_gemm_descriptor,
            )
            bm, bn = table.block_m, table.block_n
            cands = list(dict.fromkeys(
                self.clamp(route, *c) for c in (
                    (bm, bn), (bm // 2, bn), (bm, bn // 2),
                    (bm // 2, bn // 2))))
            winner, _ = autotune_gemm_descriptor(
                self, cands, device=device, generation=generation)
            return winner
        except Exception as e:
            logging.getLogger(__name__).warning(
                "gemm autotune-on-miss sweep failed (%s: %s); using the "
                "table tile", type(e).__name__, e)
            return None
        finally:
            parameters._MISS_SWEEP_ACTIVE.discard(key)

    @property
    def flops(self) -> int:
        return 2 * self.batch * self.m * self.n * self.k
