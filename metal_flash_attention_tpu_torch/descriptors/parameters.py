"""Tile tables and the card's tile rules.

The port of the JAX package's `descriptors/parameters.py`.  JAX kept
per-TPU-generation tables of (block_q, block_kv) and a VMEM budget; the
port keeps

- the **H100 table**: one row a head-dim class (64 and 128 share their
  kernels' macros; 256 has its own) and kernel type, whose values are the
  kernels' default tiles (`csrc/flash_tiles.cuh`, read through
  `descriptors.attention_descriptor.kernel_tiles`), so that a launch with
  no tuned entry and no requested tile runs the plain library;
- the **card's rules** for a legal tile, one function a kernel family,
  read from the kernels' `static_assert`s and shared-memory sums: tiles
  are 64, 128 or 256 wide, the forward and dQ have one or two consumer
  warpgroups of 64 rows, dK/dV's split of D stays a wgmma's N, and the
  ring's stages fit the shared memory a block may opt into
  (`DeviceContext`).  A variant library compiles every instantiation of
  its class (bf16 / fp16, the cap, the options, quantized K/V), so a tile
  is legal when all of them fit;
- `clamp_to_card`, which moves a tuned or requested tile to the nearest
  legal one, as `clamp_to_vmem` shrank to VMEM;
- `select_block_sizes`: a tuned winner in the config cache first, then
  the table, then a one-time sweep on a miss.

On-miss autotune keeps JAX's policy: it is on only where the card is
(`autotune_on_miss_enabled`: a CUDA device; `MFA_TORCH_AUTOTUNE_ON_MISS=0`
turns it off), and it sweeps only a head dim outside `MEASURED_HEAD_DIMS`
or a generation the table was not measured on.  The H100 rows are
measured on ``h100``, so on an H100 it never fires; a CPU tensor never
reaches it (its wrappers run the plain versions and resolve no tile).
"""

from __future__ import annotations

import functools
import itertools
import logging
import math
import os
from dataclasses import dataclass
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.runtime.context import (
    KERNEL_SMEM_LIMIT,
    DeviceContext,
    default_generation,
)

logger = logging.getLogger(__name__)

# Tri-state: None = the default (on where the card is, unless
# MFA_TORCH_AUTOTUNE_ON_MISS=0); True = on (tests); False = off.
_AUTOTUNE_ON_MISS: Optional[bool] = None


def set_autotune_on_miss(enabled: Optional[bool]) -> None:
    """Override the on-miss policy (None restores the default)."""
    global _AUTOTUNE_ON_MISS
    _AUTOTUNE_ON_MISS = enabled


def autotune_on_miss_enabled(device=None) -> bool:
    """Whether a miss may sweep: the override if set, else off with
    MFA_TORCH_AUTOTUNE_ON_MISS=0, else on for a CUDA ``device`` (None:
    where a card exists)."""
    if _AUTOTUNE_ON_MISS is not None:
        return _AUTOTUNE_ON_MISS
    if os.environ.get("MFA_TORCH_AUTOTUNE_ON_MISS", "1") == "0":
        return False
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type == "cuda"


# Reentrancy guard: a sweep calls the kernels with explicit tiles, and
# must never sweep again inside itself.
_MISS_SWEEP_ACTIVE: set = set()

# Head dims the table was measured at on TUNED_GENERATION: its rows are
# the kernels' tiles, which run at these head dims (32 runs the D 64
# kernels, over 32-column rows, with D 64's tiles).
MEASURED_HEAD_DIMS = (32, 64, 128, 256)
# The card the table's rows were measured on.
TUNED_GENERATION = "h100"
# The longest sequence a miss's sweep runs at (its winner also serves
# longer ones).
MISS_SWEEP_MAX_N = 8192

FAMILIES = ("forward", "backward_query", "backward_key_value")
# The widths a tile takes: the N of a wgmma (`static_assert`s of
# csrc/flash_attention{,_bwd}.cu).
TILE_WIDTHS = (64, 128, 256)


@dataclass(frozen=True)
class ParameterRow:
    """One row: applies when head_dim <= max_head_dim."""
    max_head_dim: int
    block_q: int
    block_kv: int


def family(kernel_type: str) -> str:
    """"forward_causal" -> "forward": the kernel a table name runs."""
    return kernel_type.removesuffix("_causal")


@functools.cache
def h100_table() -> dict[str, tuple[ParameterRow, ...]]:
    """kernel type (and its "_causal" twin) -> rows: the kernels' default
    tiles at head dims 64/128 and 256."""
    from metal_flash_attention_tpu_torch.descriptors.attention_descriptor \
        import AttentionKernelType, kernel_tiles

    table = {}
    for kind in AttentionKernelType:
        rows = tuple(ParameterRow(d, *kernel_tiles(d)[kind])
                     for d in (128, 256))
        table[kind.value] = table[f"{kind.value}_causal"] = rows
    return table


def _class_dims(head_dim: int) -> tuple[int, ...]:
    """The head dims whose kernels one variant library compiles with the
    macros ``head_dim`` reads: 64 and 128 share theirs, 256 has its own."""
    return (256,) if head_dim > 128 else (64, 128)


def smem_limit(device=None) -> int:
    """Shared memory a block of the port's kernels may take on ``device``
    (None: the card, or the kernels' own limit where none is)."""
    if device is None and not torch.cuda.is_available():
        device = "cpu"
    return min(DeviceContext.get(device).info.smem_per_block,
               KERNEL_SMEM_LIMIT)


def _fwd_smem(d: int, bq: int, bkv: int, stages: int, precision: str
              ) -> int:
    """`Smem<D, P>::kBytes` of csrc/flash_attention.cu, plus the `kAux`
    kernels' static segment scratch (4 bytes a key a consumer warp)."""
    quant = precision != "none"
    panels = d // 64
    q_bytes, tile = panels * bq * 128, panels * bkv * 128
    raw_row = d // 2 if precision == "nf4" else d
    raw_stages = 2 if quant else 0
    raw = raw_stages * 2 * bkv * raw_row if quant else 0
    table = 256 * 4 if precision == "nf4" else 0
    total = (q_bytes + 2 * stages * tile + raw + table
             + (1 + 4 * stages + raw_stages) * 8 + 1024)
    aux = 0 if quant or d > 128 else bq // 64 * 4 * bkv * 4
    return total + aux


def forward_tile_legal(block_q: int, block_kv: int, head_dim: int,
                       limit: int) -> bool:
    """The forward (`FwdTiles`, `Smem` of csrc/flash_attention.cu): one
    or two consumer warpgroups of 64 rows, 64/128/256-key tiles, and every
    instantiation's ring in ``limit`` bytes (quantized K/V's raw stages at
    D 64 and 128)."""
    if block_q not in (64, 128) or block_kv not in TILE_WIDTHS:
        return False
    for d in _class_dims(head_dim):
        stages = 2
        kinds = ("none",) if d > 128 else ("none", "int8", "nf4")
        for precision in kinds:
            raw_row = d // 2 if precision == "nf4" else d
            if precision != "none" and block_kv * raw_row // 16 % 128:
                return False  # whole decode pieces a producer thread
            if _fwd_smem(d, block_q, block_kv, stages, precision) > limit:
                return False
    return True


def _operand(d: int, rows: int) -> int:
    return d // 64 * rows * 128


def backward_query_tile_legal(block_q: int, block_kv: int, head_dim: int,
                              limit: int) -> bool:
    """dQ (`BwdTiles`, `DqSmem` of csrc/flash_attention_bwd.cu): one or
    two warpgroups of 64 rows, 64- or 128-key tiles, Q and dO kept beside
    two stages of K and V."""
    if block_q not in (64, 128) or block_kv not in (64, 128):
        return False
    stages = 2
    return all(2 * _operand(d, block_q) + stages * 2 * _operand(d, block_kv)
               + (1 + 2 * stages) * 8 + 1024 <= limit
               for d in _class_dims(head_dim))


def backward_key_value_tile_legal(block_q: int, block_kv: int,
                                  head_dim: int, limit: int) -> bool:
    """dK/dV (`BwdTiles`, `DkvSmem`): blocks of 64 or 128 keys, steps of
    64 or 128 query rows; over 64 keys the two warpgroups split D, whose
    halves must stay whole 64-column panels of at most 256; K and V kept
    beside two stages of Q and dO, and at D 64/128 the options' stages
    (96 bytes a row a warp)."""
    if block_kv not in (64, 128) or block_q not in (64, 128):
        return False
    stages = 2
    for d in _class_dims(head_dim):
        cols = d // 2 if block_kv == 64 else d
        if cols % 64 or cols > 256:
            return False
        bar = (2 * _operand(d, block_kv) + stages * 2 * _operand(d, block_q))
        plain = bar + (1 + 2 * stages) * 8 + 1024
        aux = ((bar + (1 + 2 * stages) * 8 + 127) // 128 * 128 + 1024
               + 8 * 96 * block_q) if d <= 128 else 0
        if max(plain, aux) > limit:
            return False
    return True


_RULES = {"forward": forward_tile_legal,
          "backward_query": backward_query_tile_legal,
          "backward_key_value": backward_key_value_tile_legal}


def tile_is_legal(kernel_type: str, block_q: int, block_kv: int,
                  head_dim: int, *, limit: Optional[int] = None) -> bool:
    """Whether the card can build and launch ``kernel_type``'s kernel with
    this tile (``limit``: shared memory a block, default the card's)."""
    limit = smem_limit() if limit is None else limit
    return _RULES[family(kernel_type)](block_q, block_kv, head_dim, limit)


def legal_tiles(kernel_type: str, head_dim: int, *,
                limit: Optional[int] = None) -> list[tuple[int, int]]:
    """Every legal (block_q, block_kv) of ``kernel_type`` at
    ``head_dim``."""
    return [t for t in itertools.product(TILE_WIDTHS, TILE_WIDTHS)
            if tile_is_legal(kernel_type, *t, head_dim, limit=limit)]


def clamp_to_card(kernel_type: str, block_q: int, block_kv: int,
                  head_dim: int, *, limit: Optional[int] = None
                  ) -> tuple[int, int]:
    """The legal tile nearest (block_q, block_kv): the largest legal tile
    that fits inside it, else the one closest to it by powers of two.  A
    legal tile comes back as it is."""
    legal = legal_tiles(kernel_type, head_dim, limit=limit)
    if not legal:
        raise ValueError(f"no legal {kernel_type} tile at head_dim "
                         f"{head_dim} in {limit or smem_limit()} bytes of "
                         "shared memory")
    bq, bkv = max(int(block_q), 1), max(int(block_kv), 1)

    def distance(tile):
        inside = tile[0] <= bq and tile[1] <= bkv
        far = abs(math.log2(tile[0] / bq)) + abs(math.log2(tile[1] / bkv))
        return (not inside, far, -tile[0] * tile[1])
    return min(legal, key=distance)


def _tile_prefix(kernel_type: str, head_dim: int) -> str:
    wide = "_D256" if head_dim > 128 else ""
    return {"forward": f"MFA_FWD90{wide}",
            "backward_query": f"MFA_BWD90{wide}_DQ",
            "backward_key_value": f"MFA_BWD90{wide}_DKV"}[family(kernel_type)]


def tile_library(kernel_type: str, block_q: int, block_kv: int,
                 head_dim: int) -> tuple:
    """The library variant that launches this tile: () for the plain
    library (the tile is the default), else its sorted -D pairs."""
    from metal_flash_attention_tpu_torch.descriptors.attention_descriptor \
        import AttentionKernelType, kernel_tiles

    default = kernel_tiles(head_dim)[AttentionKernelType(family(
        kernel_type))]
    if (block_q, block_kv) == default:
        return ()
    prefix = _tile_prefix(kernel_type, head_dim)
    return tuple(sorted(((f"{prefix}_BLOCK_Q", int(block_q)),
                         (f"{prefix}_BLOCK_KV", int(block_kv)))))


def select_block_sizes(
    kernel_type: str,
    head_dim: int,
    dtype,
    *,
    generation: Optional[str] = None,
    seq_len: Optional[int] = None,
    device=None,
) -> tuple[int, int]:
    """A tuned winner in the config cache (with ``seq_len``), clamped to
    the card's rules; else the table's first row covering ``head_dim``;
    and on a miss where the policy allows, a one-time sweep whose winner
    persists.  ``device``: the card the tile is for (None: the default
    card, or the CPU's rules where none is)."""
    gen = generation or default_generation()
    limit = smem_limit(device)
    if seq_len is not None:
        from metal_flash_attention_tpu_torch.runtime.autotune import (
            lookup_tuned_blocks,
        )
        tuned = lookup_tuned_blocks(kernel_type, head_dim, dtype, seq_len,
                                    generation=gen)
        if tuned is not None:
            return clamp_to_card(kernel_type, tuned[0], tuned[1], head_dim,
                                 limit=limit)
    rows = h100_table()[kernel_type]
    inherited = gen not in (TUNED_GENERATION, "cpu")
    if inherited:
        _note_generation_fallback(gen, kernel_type)
    bq, bkv = rows[-1].block_q, rows[-1].block_kv
    for row in rows:
        if head_dim <= row.max_head_dim:
            bq, bkv = row.block_q, row.block_kv
            break
    bq, bkv = clamp_to_card(kernel_type, bq, bkv, head_dim, limit=limit)

    novel = head_dim not in MEASURED_HEAD_DIMS or inherited
    if seq_len is not None and novel and autotune_on_miss_enabled(device):
        tuned = _sweep_attention_miss(kernel_type, head_dim, dtype, seq_len,
                                      gen, device)
        if tuned is not None:
            return clamp_to_card(kernel_type, tuned[0], tuned[1], head_dim,
                                 limit=limit)
    return bq, bkv


def _bucket(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()


def _sweep_attention_miss(kernel_type, head_dim, dtype, seq_len, generation,
                          device) -> Optional[tuple]:
    """A one-time sweep of the family's candidate tiles (at most four) at
    min(bucket, MISS_SWEEP_MAX_N) tokens; the winner persists under the
    caller's bucket too, so that a longer sequence finds it.  None where
    the sweep cannot run."""
    from metal_flash_attention_tpu_torch.runtime.cache import dtype_name

    bucket = _bucket(seq_len)
    key = (kernel_type, head_dim, dtype_name(dtype), bucket, generation)
    if key in _MISS_SWEEP_ACTIVE:
        return None
    _MISS_SWEEP_ACTIVE.add(key)
    try:
        from metal_flash_attention_tpu_torch.runtime.autotune import (
            autotune_attention,
        )
        from metal_flash_attention_tpu_torch.runtime.cache import (
            KernelConfigCache,
        )

        causal = kernel_type.endswith("_causal")
        n = min(bucket, MISS_SWEEP_MAX_N)
        logger.info("autotune-on-miss: sweeping %s D=%d N-bucket=%d "
                    "(one-time, winner persists)", kernel_type, head_dim,
                    bucket)
        winner, _ = autotune_attention(
            kernel_type=family(kernel_type), n=n, head_dim=head_dim,
            heads=4, dtype=dtype, causal=causal, iters=20, repeats=2,
            device=device, generation=generation)
        if bucket > n:
            cache = KernelConfigCache.get()
            cache.insert(cache.attention_key(
                kernel_type, head_dim, dtype, q_len_bucket=bucket,
                generation=generation), winner)
        return winner
    except Exception as e:
        logger.warning("autotune-on-miss sweep failed (%s: %s); using the "
                       "table row", type(e).__name__, e)
        return None
    finally:
        _MISS_SWEEP_ACTIVE.discard(key)


# (generation, kernel type) pairs whose inheritance of the H100 rows has
# been logged: one note each, not one a dispatch.
_FALLBACK_NOTED: set[tuple[str, str]] = set()


def _note_generation_fallback(gen: str, kernel_type: str) -> None:
    """A card without measured rows inherits the H100's (the kernels'
    default tiles), checked against its own shared memory by
    `clamp_to_card`; logged once so that its user knows to run
    `python -m metal_flash_attention_tpu_torch.runtime autotune`."""
    if gen in (TUNED_GENERATION, "cpu") or (gen, kernel_type) in \
            _FALLBACK_NOTED:
        return
    _FALLBACK_NOTED.add((gen, kernel_type))
    logger.warning(
        "No measured %s tile table for the %r card; inheriting the %s "
        "rows (clamped to this card's shared memory).  Run `python -m "
        "metal_flash_attention_tpu_torch.runtime autotune` once on this "
        "card to measure real winners.", kernel_type, gen, TUNED_GENERATION)
