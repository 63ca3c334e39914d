"""Paged attention over a block-table KV pool (PyTorch, CUDA on Hopper).

The port of the JAX package's `ops/paged_attention.py`.  K/V live in a
global pool of fixed-size pages, each sequence owns an ordered page
list, and growing a sequence never copies: the serving engine's
continuous batching is built on this.

Layout (the JAX package's, at every public function):

- q: [batch, q_heads, head_dim] (decode) or
  [batch, q_heads, q_chunk, head_dim] (chunked prefill);
- pools: [num_pages, kv_heads, page_size, head_dim].  Unlike the JAX
  package, head_dim is NOT padded to 128 lanes: that was a TPU DMA rule;
- page_table: [batch, max_pages] int32.  Entries past a sequence's live
  pages, cdiv(length, page_size), are never used (the kernels may read
  them while the lengths load, and ignore them);
- lengths: [batch] int32, live tokens per sequence, at most
  max_pages * page_size.

The appends update the pools IN PLACE (the JAX package donates them to
the jit instead) and return a cache whose lengths moved on.

Quantized pools (`QuantizedPagedKVCache`, made by `quantize_paged`):
INT8 / FP8-E4M3 / FP8-E5M2 pages [num_pages, kv_heads, page_size,
head_dim], or NF4 [num_pages, kv_heads, page_size / 2, head_dim] (byte
(r, c) holds column c of tokens r, low nibble, and r + page_size / 2,
high nibble), each page quantized on its own with one float32 scale per
(page, kv head), so pages stay shareable.  Both modes take them; the
kernel decodes each tile in shared memory.

Gemma-2's options, in both modes: ``kv_starts`` int [batch], each
sequence's first attended position (a sliding window as a start), and
``logit_softcap`` c, which soft-caps each scaled logit s (after a
quantized page's K scale) to c * tanh(s / c) before the mask.

Dispatch: a CPU tensor takes the plain PyTorch version
(`_paged_attention_plain`, which dequantizes the gathered pages in
float32); a CUDA tensor takes the hand-written kernels in
`csrc/paged_attention.cu` (bf16 q; bf16 or quantized pools at head dims
32, 64 and 128, bf16 pools at 256; the soft cap and starts over every
pool),
or raises.  There is no fallback from one to the other.  Both
modes gather their pages through the cp.async ring of
`csrc/decode_common.cuh` and split the keys in fixed chunks
(`decode_splits`); decode runs the decode core that `flash_decode` runs.
A decode whose GQA group is wider than the decode kernel's
(MFA_DECODE_MAX_GROUP: a serving chunk's positions folded into the head
axis) runs on the prefill kernel with q_chunk = 1, where every row sits
at position lengths - 1, and counts as `paged_decode_wide`.  Each kernel
launch adds one to its `LAUNCH_COUNTS` entry (`paged_decode`,
`paged_decode_wide`, `paged_prefill`), to the entry of its Hopper kernel
(`<name>_sm90`), over quantized pools to `<name>_<precision>`
(`paged_decode_int8`, ...), with the soft cap to `<name>_softcap`, at
head_dim 256 to `<name>_d256` and at head_dim 32 to `<name>_d32`, and
`LAUNCH_TILES[<name>]` counts the
chunk (keys a split block) it launched with.

The chunk's cap (`chunk_cap`): ``pages_per_chunk`` pages (the JAX
kernel's gather width), in whole key tiles; else, for a decode, a tuned
``paged_<precision>`` winner of the runtime's config cache
(`runtime.autotune.autotune_paged`); else the default
(MFA_DECODE_CHUNK, MFA_PAGED_PREFILL_CHUNK).  `decode_splits` sizes each
call's chunk up to it, so no cap needs a rebuild.  ``heads_per_chunk``
and ``interpret`` (the TPU kernel's) are taken and ignored.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.native.build import tile_defines
from metal_flash_attention_tpu_torch.ops.quantization import (
    FP8_MAX,
    KV_PRECISIONS,
    PRECISION_CODE,
    nf4_nearest_indices,
    nf4_unpack,
)
from metal_flash_attention_tpu_torch.ops.reference import softcap_value
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.utils.errors import not_ported
from metal_flash_attention_tpu_torch.utils.shapes import cdiv

# Head dims over every pool (32: the tiny Llama and Gemma-2 configs').
KERNEL_HEAD_DIMS = (32, 64, 128)
# Head dims over bf16 pools (Gemma-2's 256).
BF16_HEAD_DIMS = (32, 64, 128, 256)
MODES = ("paged_decode", "paged_decode_wide", "paged_prefill")

# One count per kernel, bumped only where its wrapper launches it: each
# mode, its Hopper kernel, its launches over quantized pools by precision,
# with the soft cap, and at head_dim 256 and 32.
LAUNCH_COUNTS = {f"{mode}{suffix}": 0 for mode in MODES for suffix in
                 ("", "_sm90", *(f"_{p.value}" for p in KV_PRECISIONS),
                  "_softcap", "_d256", "_d32")}
# The chunks each mode launched with: {keys a split block: launches}.
LAUNCH_TILES = {mode: collections.Counter() for mode in MODES}

KERNEL_ITEM = "flash-kernel coverage"


def as_kv_precision(value) -> OperandPrecision:
    """An INT8 / FP8-E4M3 / FP8-E5M2 / NF4 KV storage precision, from an
    `OperandPrecision` of either package or its value ("int8", ...)."""
    try:
        precision = OperandPrecision(getattr(value, "value", value))
    except ValueError:
        precision = None
    if precision not in KV_PRECISIONS:
        raise ValueError(f"unsupported streaming KV precision: {value!r}")
    return precision


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
    for tiles in LAUNCH_TILES.values():
        tiles.clear()


class PagedKVCache(NamedTuple):
    """A paged KV pool plus per-sequence bookkeeping."""
    k_pages: torch.Tensor     # [num_pages, kv_heads, page_size, head_dim]
    v_pages: torch.Tensor
    page_table: torch.Tensor  # [batch, max_pages] int32
    lengths: torch.Tensor     # [batch] int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]


class QuantizedPagedKVCache(NamedTuple):
    """A paged pool of INT8 / FP8 / NF4 pages with one scale per (page,
    kv head)."""
    k_pages: torch.Tensor     # [num_pages, kv_heads, page_size, d] storage
    v_pages: torch.Tensor     # (NF4: [num_pages, kv_heads, page/2, d] uint8)
    k_scales: torch.Tensor    # [num_pages, kv_heads] float32
    v_scales: torch.Tensor
    page_table: torch.Tensor  # [batch, max_pages] int32
    lengths: torch.Tensor     # [batch] int32
    precision: OperandPrecision

    @property
    def page_size(self) -> int:
        rows = self.k_pages.shape[2]
        return 2 * rows if self.precision is OperandPrecision.NF4 else rows


def quantize_page_block(x: torch.Tensor, precision: OperandPrecision
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Quantize pages [..., page_size, d] each on its own: (payload
    [..., page_size, d] in the storage dtype, NF4 [..., page_size / 2, d]
    uint8 two tokens a byte; scale [...] float32, the page's absmax over
    the format's largest value).  Bit for bit the JAX package's
    `quantize_paged` and `models.serving._quantize_page_block`."""
    xf = x.float()
    absmax = xf.abs().amax(dim=(-1, -2)).clamp_min(1e-12)
    if precision is OperandPrecision.INT8:
        scale = absmax / 127.0
        q = torch.round(xf / scale[..., None, None]).clamp(-127, 127)
        return q.to(torch.int8), scale
    if precision in FP8_MAX:
        scale = absmax / FP8_MAX[precision]
        return (xf / scale[..., None, None]).to(precision.storage_dtype), \
            scale
    if precision is OperandPrecision.NF4:
        ps = x.shape[-2]
        if ps % 2:
            raise ValueError(f"NF4 pages need an even page_size, got {ps}")
        idx = nf4_nearest_indices(xf / absmax[..., None, None])
        packed = idx[..., :ps // 2, :] | (idx[..., ps // 2:, :] << 4)
        return packed.to(torch.uint8), absmax
    raise ValueError(f"unsupported paged KV precision: {precision}")


def dequantize_pages(pages: torch.Tensor, scales: torch.Tensor,
                     precision: OperandPrecision,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Stored pages [..., rows, d] and their scales [...] -> float32
    [..., page_size, d] (NF4: low nibbles are the page's first half of
    tokens, high nibbles its second; its codebook values rounded to
    ``dtype``, the queries' type, as the kernels of both packages round
    them)."""
    if precision is OperandPrecision.NF4:
        vals = nf4_unpack(pages, dim=-2, dtype=dtype)
    else:
        vals = pages.float()
    return vals * scales[..., None, None]


def quantize_paged(cache: PagedKVCache, precision: OperandPrecision
                   ) -> QuantizedPagedKVCache:
    """Quantize a paged pool page by page (one absmax scale per page and
    kv head), for decoding against it; new tokens then go to a bf16 tail
    merged by lse (`models.serving`)."""
    precision = as_kv_precision(precision)
    kq, ks = quantize_page_block(cache.k_pages, precision)
    vq, vs = quantize_page_block(cache.v_pages, precision)
    return QuantizedPagedKVCache(kq, vq, ks, vs, cache.page_table,
                                 cache.lengths, precision)


def init_paged_cache(*, num_pages: int, kv_heads: int, page_size: int,
                     head_dim: int, batch: int, max_pages: int,
                     dtype: torch.dtype = torch.bfloat16,
                     device=None) -> PagedKVCache:
    """Empty pool with a zero-filled page table (every entry on the
    null page 0), on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    shape = (num_pages, kv_heads, page_size, head_dim)
    return PagedKVCache(
        k_pages=torch.zeros(shape, dtype=dtype, device=device),
        v_pages=torch.zeros(shape, dtype=dtype, device=device),
        page_table=torch.zeros((batch, max_pages), dtype=torch.int32,
                               device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def paged_append(cache: PagedKVCache, new_k: torch.Tensor,
                 new_v: torch.Tensor) -> PagedKVCache:
    """Append one token per sequence at its live position (in place).
    new_k/new_v: [batch, kv_heads, head_dim]."""
    return paged_append_chunk(cache, new_k[:, :, None, :],
                              new_v[:, :, None, :])


def paged_append_chunk(cache: PagedKVCache, new_k: torch.Tensor,
                       new_v: torch.Tensor) -> PagedKVCache:
    """Write a chunk of tokens per sequence at positions
    lengths .. lengths + k - 1, IN PLACE, and return the cache with
    lengths + k.

    new_k/new_v: [batch, kv_heads, k, head_dim].  The pages for the
    covered positions must already be in the table.  Page ownership is
    per sequence, so the (page, row) pairs are unique and one
    `index_put_` scatter writes the whole chunk.
    """
    ps = cache.page_size
    kc = new_k.shape[2]
    pos = (cache.lengths.long()[:, None]
           + torch.arange(kc, device=new_k.device)[None, :])    # [b, k]
    page_idx = torch.gather(cache.page_table.long(), 1, pos // ps)
    row = pos % ps
    for pages, new in ((cache.k_pages, new_k), (cache.v_pages, new_v)):
        # [pages, rows, heads, d] view: the indexed slots are
        # [b, k, heads, d], the layout of `new` once heads and tokens
        # swap.
        pages.permute(0, 2, 1, 3).index_put_(
            (page_idx, row), new.permute(0, 2, 1, 3).to(pages.dtype))
    return cache._replace(lengths=cache.lengths + kc)


def paged_decode(q: torch.Tensor, cache: PagedKVCache, *,
                 kv_starts: Optional[torch.Tensor] = None,
                 scale: Optional[float] = None,
                 logit_softcap: Optional[float] = None,
                 window_size: Optional[int] = None,
                 interpret: Optional[bool] = None,
                 return_residuals: bool = False,
                 pages_per_chunk: Optional[int] = None,
                 heads_per_chunk: Optional[int] = None):
    """Decode one token per sequence against a paged pool.

    q: [batch, q_heads, head_dim]; returns o of q's shape and, with
    ``return_residuals``, the natural-log lse [batch, q_heads].  The
    query sits at position lengths - 1; ``window_size`` w keeps the last
    w positions, ``kv_starts`` int [batch] the positions from each
    sequence's start; ``logit_softcap`` c soft-caps the logits.
    ``cache`` is a `PagedKVCache` or a `QuantizedPagedKVCache`.  On a
    CUDA tensor this launches the split-KV decode kernel (the prefill
    kernel for groups above MFA_DECODE_MAX_GROUP), its chunk capped at
    ``pages_per_chunk`` pages (module docstring)."""
    del interpret, heads_per_chunk
    o, lse = _paged_attention(
        q[:, :, None, :], cache, kv_starts=kv_starts, scale=scale,
        logit_softcap=logit_softcap, window_size=window_size, decode=True,
        pages_per_chunk=pages_per_chunk)
    o = o[:, :, 0]
    return (o, lse[:, :, 0]) if return_residuals else o


def paged_prefill(q: torch.Tensor, cache: PagedKVCache, *,
                  kv_starts: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  logit_softcap: Optional[float] = None,
                  window_size: Optional[int] = None,
                  interpret: Optional[bool] = None,
                  return_residuals: bool = False,
                  pages_per_chunk: Optional[int] = None):
    """Multi-token attention against a paged pool (chunked prefill).

    q: [batch, q_heads, q_chunk, head_dim], the last q_chunk tokens of
    each sequence, whose K/V are already in the pool.  Query t sits at
    position lengths - q_chunk + t and attends causally (within
    ``window_size`` when given, and from ``kv_starts`` when given).
    Returns o of q's shape and, with ``return_residuals``, lse [batch,
    q_heads, q_chunk].  ``pages_per_chunk``: the cap on a split block's
    keys, in pages."""
    del interpret
    o, lse = _paged_attention(
        q, cache, kv_starts=kv_starts, scale=scale,
        logit_softcap=logit_softcap, window_size=window_size, decode=False,
        pages_per_chunk=pages_per_chunk)
    return (o, lse) if return_residuals else o


def _paged_attention(q, cache, *, kv_starts, scale, logit_softcap,
                     window_size, decode, pages_per_chunk=None):
    """Shared driver: q [batch, q_heads, q_tokens, head_dim] ->
    (o like q, lse [batch, q_heads, q_tokens] float32)."""
    if pages_per_chunk is not None and pages_per_chunk <= 0:
        raise ValueError(f"pages_per_chunk must be positive, got "
                         f"{pages_per_chunk}")
    precision = getattr(cache, "precision", None)
    if precision is None and cache.k_pages.dtype not in (
            torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{cache.k_pages.dtype} pools: quantized pools "
                        "come as a QuantizedPagedKVCache (quantize_paged)")
    if precision is not None and precision not in KV_PRECISIONS:
        raise ValueError(f"unsupported paged KV precision: {precision}")
    if window_size is not None and window_size <= 0:
        raise ValueError(f"window_size must be positive, got {window_size}")
    if kv_starts is not None and tuple(kv_starts.shape) != (q.shape[0],):
        raise ValueError(f"kv_starts must be [batch], got "
                         f"{tuple(kv_starts.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(kv_starts=kv_starts, scale=scale,
              softcap=softcap_value(logit_softcap), window_size=window_size)
    if q.is_cuda:
        return _paged_attention_cuda(q, cache, decode=decode,
                                     pages_per_chunk=pages_per_chunk, **kw)
    if q.device.type != "cpu":
        raise ValueError(f"paged attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    return _paged_attention_plain(q, cache, **kw)


def _paged_attention_plain(q, cache, *, scale, window_size, kv_starts=None,
                           softcap=None):
    """The plain PyTorch version: gather every sequence's pages into a
    dense [batch, kv_heads, max_pages * page_size, d] K/V, soft-cap the
    scaled logits, mask, and take the softmax in float32 (quantized pages
    dequantized, each by its own scale).  It is what a CPU tensor runs
    and what the kernel is held against on the card."""
    k_pages, v_pages, table, lengths = (cache.k_pages, cache.v_pages,
                                        cache.page_table, cache.lengths)
    b, qh, qc, d = q.shape
    kvh, ps = k_pages.shape[1], cache.page_size
    group = qh // kvh
    max_pages = table.shape[1]
    n = max_pages * ps
    lengths = lengths.long()
    # Entries past a sequence's live pages are ignored: read the null
    # page there instead.
    live_pages = torch.arange(max_pages, device=q.device)[None, :] < \
        (lengths[:, None] + ps - 1) // ps
    idx = torch.where(live_pages, table.long(), 0)

    def gather(pages, scales):
        x = pages[idx]                          # [b, max_pages, kvh, ps, d]
        x = (x.float() if scales is None else
             dequantize_pages(x, scales[idx], cache.precision, q.dtype))
        return x.permute(0, 2, 1, 3, 4).reshape(b, kvh, n, d)

    quantized = getattr(cache, "precision", None) is not None
    k = gather(k_pages, cache.k_scales if quantized else None)
    v = gather(v_pages, cache.v_scales if quantized else None)
    qg = q.reshape(b, kvh, group, qc, d).float()
    s = torch.einsum("bhgtd,bhnd->bhgtn", qg, k) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(n, device=q.device)[None, None, :]
    qpos = (lengths[:, None] - qc
            + torch.arange(qc, device=q.device)[None, :])[:, :, None]
    live = cols <= qpos                            # [b, qc, n]
    if window_size is not None:
        live &= cols > qpos - window_size
    if kv_starts is not None:
        live &= cols >= kv_starts.long()[:, None, None]
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgtn,bhnd->bhgtd", p, v) / safe_l
    lse = torch.where(l > 0.0, m + torch.log(safe_l),
                      torch.full_like(l, float("-inf")))
    return (o.reshape(b, qh, qc, d).to(q.dtype),
            lse.reshape(b, qh, qc))


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """Build (if stale) and bind csrc/paged_attention.cu."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    return bind_library(load_library("paged_attention"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of csrc/paged_attention.cu."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    f32 = ctypes.c_float
    args = [ptr] * 10 + [i32] * 7 + [f32, f32, i32, ptr, ptr, i32, i32, i32,
                                     ptr]
    for fn in (lib.mfa_paged_prefill, lib.mfa_paged_decode):
        fn.argtypes = args
        fn.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(
        device_index).multi_processor_count


def decode_splits(pairs: int, max_tokens: int, sm_count: int, tile: int,
                  max_chunk: int, *, at_most: bool = False
                  ) -> tuple[int, int]:
    """(chunk, splits) of a split-KV kernel whose key tile is ``tile``:
    each of the ``pairs`` (rows, kv head) units of a call is split into
    blocks of ``chunk`` keys, counted at run time from its rows' first live
    tile, and ``splits`` such blocks cover ``max_tokens`` keys.  The chunk
    is a whole number of tiles, at most ``max_chunk`` keys, and sized for
    two waves of blocks over the SMs when every unit is ``max_tokens``
    long: at least two for the decode modes (short, memory-bound blocks:
    a partial last wave costs less than longer blocks), at most two with
    ``at_most`` for the prefill (long, latency-bound blocks, two to an
    SM: a third wave would cost a whole block's time).  It depends on
    shapes only, so no length is read back to the host; a block past its
    rows' live keys leaves at once."""
    tiles = cdiv(max_tokens, tile)
    blocks = 2 * sm_count
    if at_most:
        chunk_tiles = cdiv(tiles, max(1, blocks // pairs))
    else:
        chunk_tiles = tiles // cdiv(blocks, pairs)
    chunk_tiles = max(1, min(max_chunk // tile, chunk_tiles))
    return chunk_tiles * tile, max(1, cdiv(tiles, chunk_tiles))


def chunk_cap(requested: Optional[int], tile: int, default: int) -> int:
    """The most keys one split-KV block takes: ``requested`` keys in
    whole tiles of ``tile`` (at least one), or ``default`` without a
    request."""
    if requested is None:
        return default
    if requested <= 0:
        raise ValueError(f"a chunk cap must be positive, got {requested}")
    return max(tile, requested // tile * tile)


# Tuned caps by problem, kept while the config cache is unchanged.
_TUNED_CAPS: dict = {}


def tuned_chunk(kind: str, precision, head_dim: int, dtype,
                n: int) -> Optional[int]:
    """A measured winner of ``kind`` ("decode" or "paged") for this
    KV precision, head dim and key length (`runtime.autotune`'s
    ``<kind>_<precision>`` entries: keys for "decode", pages for "paged"),
    or None."""
    from metal_flash_attention_tpu_torch.runtime.autotune import (
        lookup_tuned_blocks,
    )
    from metal_flash_attention_tpu_torch.runtime.cache import (
        KernelConfigCache,
    )

    cache = KernelConfigCache.get()
    tag = precision.value if precision is not None else "bf16"
    bucket = 1 << (max(n, 1) - 1).bit_length()
    key = (id(cache), cache.version, kind, tag, head_dim, dtype, bucket)
    if key not in _TUNED_CAPS:
        tuned = lookup_tuned_blocks(f"{kind}_{tag}", head_dim, dtype, n)
        _TUNED_CAPS[key] = None if tuned is None else tuned[1]
    return _TUNED_CAPS[key]


def split_scratch(batch: int, kv_heads: int, splits: int, rows: int,
                  d: int, device):
    """The float32 partials of a split-KV launch: part_o [batch,
    kv_heads, splits, rows, d] and part_lse [..., rows], or (None, None)
    when there is one split (the kernel then writes o and lse itself)."""
    if splits == 1:
        return None, None
    part_o = torch.empty((batch, kv_heads, splits, rows, d),
                         dtype=torch.float32, device=device)
    part_lse = torch.empty((batch, kv_heads, splits, rows),
                           dtype=torch.float32, device=device)
    return part_o, part_lse


def data_ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    """A tensor's address as a kernel argument; None (null) for None."""
    return None if t is None else t.data_ptr()


def _paged_attention_cuda(q, cache, *, scale, window_size, decode,
                          kv_starts=None, softcap=None,
                          pages_per_chunk=None):
    """Launch the Hopper kernel; raise on anything it does not take.
    The chunk cap: ``pages_per_chunk`` pages, a tuned winner (decode), or
    the default."""
    precision = getattr(cache, "precision", None)
    k_pages, v_pages, table, lengths = (cache.k_pages, cache.v_pages,
                                        cache.page_table, cache.lengths)
    b, qh, qc, d = q.shape
    _, kvh, _, d_kv = k_pages.shape
    ps = cache.page_size
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   page_table=table, lengths=lengths)
    if kv_starts is not None:
        if kv_starts.device != q.device:
            raise ValueError(f"kv_starts is on {kv_starts.device}, q on "
                             f"{q.device}")
        tensors["kv_starts"] = kv_starts = kv_starts.to(
            torch.int32).contiguous()
    if precision is not None:
        tensors.update(k_scales=cache.k_scales, v_scales=cache.v_scales)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    store = q.dtype if precision is None else precision.storage_dtype
    if k_pages.dtype != store or v_pages.dtype != store:
        raise TypeError(f"the pools must be {store}, got {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if precision is not None:
        for name in ("k_scales", "v_scales"):
            t = tensors[name]
            if t.dtype != torch.float32 or \
                    tuple(t.shape) != tuple(k_pages.shape[:2]):
                raise ValueError(f"{name} must be float32 [num_pages, "
                                 f"kv_heads], got {t.dtype} "
                                 f"{tuple(t.shape)}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if d_kv != d or v_pages.shape != k_pages.shape or qh % kvh or \
            table.dim() != 2 or table.shape[0] != b or \
            lengths.shape != (b,):
        raise ValueError("shape mismatch: q %s, pools %s/%s, table %s, "
                         "lengths %s" % (tuple(q.shape),
                                         tuple(k_pages.shape),
                                         tuple(v_pages.shape),
                                         tuple(table.shape),
                                         tuple(lengths.shape)))
    if q.dtype != torch.bfloat16:
        raise not_ported(f"{q.dtype} queries in the paged kernel (it takes "
                         "bf16)", KERNEL_ITEM)
    head_dims = BF16_HEAD_DIMS if precision is None else KERNEL_HEAD_DIMS
    if d not in head_dims:
        raise not_ported(f"head_dim {d} in the paged kernel (it takes "
                         f"{head_dims} over these pools)", KERNEL_ITEM)
    tiles = tile_defines()
    group = qh // kvh
    lib = _kernel_library()
    max_pages = table.shape[1]
    max_tokens = max_pages * ps
    sm_count = _sm_count(q.device.index or 0)
    if decode and group <= tiles["MFA_DECODE_MAX_GROUP"]:
        tile = tiles["MFA_DECODE_BLOCK_KV"]
        if window_size is not None:
            # The last `window` keys start mid-tile at worst; an NF4
            # tile's keys lie in halves of whole pages.
            reach = (window_size + 2 * ps + 2 * tile
                     if precision is OperandPrecision.NF4
                     else window_size + tile)
            max_tokens = min(max_tokens, reach)
        pages = pages_per_chunk
        if pages is None:
            pages = tuned_chunk("paged", precision, d, q.dtype,
                                max_pages * ps)
        cap = chunk_cap(None if pages is None else pages * ps, tile,
                        tiles["MFA_DECODE_CHUNK"])
        chunk, splits = decode_splits(b * kvh, max_tokens, sm_count, tile,
                                      cap)
        rows, name, entry = group, "paged_decode", lib.mfa_paged_decode
    else:
        row_tiles = cdiv(group * qc, tiles["MFA_PAGED_BLOCK_Q"])
        tile = tiles["MFA_PAGED_BLOCK_KV"]
        cap = chunk_cap(None if pages_per_chunk is None
                        else pages_per_chunk * ps, tile,
                        tiles["MFA_PAGED_PREFILL_CHUNK"])
        chunk, splits = decode_splits(row_tiles * kvh * b, max_tokens,
                                      sm_count, tile, cap, at_most=True)
        rows, entry = group * qc, lib.mfa_paged_prefill
        name = "paged_decode_wide" if decode else "paged_prefill"
    o = torch.empty_like(q)
    lse = torch.empty((b, qh, qc), dtype=torch.float32, device=q.device)
    part_o, part_lse = split_scratch(b, kvh, splits, rows, d, q.device)
    code = PRECISION_CODE[precision or OperandPrecision.BF16]
    scales = ((None, None) if precision is None
              else (cache.k_scales.data_ptr(), cache.v_scales.data_ptr()))
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = entry(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *scales,
            table.data_ptr(), lengths.data_ptr(), data_ptr(kv_starts),
            o.data_ptr(), lse.data_ptr(), b, qh, kvh, qc, d, ps, max_pages,
            ctypes.c_float(scale), ctypes.c_float(softcap or 0.0),
            window_size or 0, data_ptr(part_o),
            data_ptr(part_lse), splits, chunk, code, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.mfa_cuda_error_string(rc).decode()})")
    LAUNCH_COUNTS[name] += 1
    LAUNCH_COUNTS[f"{name}_sm90"] += 1
    LAUNCH_TILES[name][chunk] += 1
    if precision is not None:
        LAUNCH_COUNTS[f"{name}_{precision.value}"] += 1
    if softcap is not None:
        LAUNCH_COUNTS[f"{name}_softcap"] += 1
    if d in (32, 256):
        LAUNCH_COUNTS[f"{name}_d{d}"] += 1
    return o, lse
