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

Dispatch: a CPU tensor takes the plain PyTorch version
(`_paged_attention_plain`); a CUDA tensor takes the hand-written kernels
in `csrc/paged_attention.cu` (bf16 pools, head dims 64 and 128), or
raises.  There is no fallback from one to the other.  Both modes gather
their pages through the cp.async ring of `csrc/decode_common.cuh` and
split the keys in fixed chunks (`decode_splits`); decode runs the decode
core that `flash_decode` runs.  Each kernel launch adds one to its
`LAUNCH_COUNTS` entry and to the entry of its Hopper kernel
(`paged_decode_sm90`, `paged_prefill_sm90`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from metal_flash_attention_tpu_torch.native.build import tile_defines
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.utils.errors import not_ported
from metal_flash_attention_tpu_torch.utils.shapes import cdiv

KERNEL_HEAD_DIMS = (64, 128)

# One count per kernel, bumped only where its wrapper launches it.
LAUNCH_COUNTS = {"paged_decode": 0, "paged_prefill": 0,
                 "paged_decode_sm90": 0, "paged_prefill_sm90": 0}

KERNEL_ITEM = "flash-kernel coverage"


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


class PagedKVCache(NamedTuple):
    """A paged KV pool plus per-sequence bookkeeping."""
    k_pages: torch.Tensor     # [num_pages, kv_heads, page_size, head_dim]
    v_pages: torch.Tensor
    page_table: torch.Tensor  # [batch, max_pages] int32
    lengths: torch.Tensor     # [batch] int32

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]


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
                 return_residuals: bool = False):
    """Decode one token per sequence against a paged pool.

    q: [batch, q_heads, head_dim]; returns o of q's shape and, with
    ``return_residuals``, the natural-log lse [batch, q_heads].  The
    query sits at position lengths - 1; ``window_size`` w keeps the last
    w positions.  On a CUDA tensor this launches the split-KV decode
    kernel."""
    o, lse = _paged_attention(
        q[:, :, None, :], cache, kv_starts=kv_starts, scale=scale,
        logit_softcap=logit_softcap, window_size=window_size, decode=True)
    o = o[:, :, 0]
    return (o, lse[:, :, 0]) if return_residuals else o


def paged_prefill(q: torch.Tensor, cache: PagedKVCache, *,
                  kv_starts: Optional[torch.Tensor] = None,
                  scale: Optional[float] = None,
                  logit_softcap: Optional[float] = None,
                  window_size: Optional[int] = None,
                  return_residuals: bool = False):
    """Multi-token attention against a paged pool (chunked prefill).

    q: [batch, q_heads, q_chunk, head_dim], the last q_chunk tokens of
    each sequence, whose K/V are already in the pool.  Query t sits at
    position lengths - q_chunk + t and attends causally (and within
    ``window_size`` when given).  Returns o of q's shape and, with
    ``return_residuals``, lse [batch, q_heads, q_chunk]."""
    o, lse = _paged_attention(
        q, cache, kv_starts=kv_starts, scale=scale,
        logit_softcap=logit_softcap, window_size=window_size, decode=False)
    return (o, lse) if return_residuals else o


def _paged_attention(q, cache, *, kv_starts, scale, logit_softcap,
                     window_size, decode):
    """Shared driver: q [batch, q_heads, q_tokens, head_dim] ->
    (o like q, lse [batch, q_heads, q_tokens] float32)."""
    if getattr(cache, "precision", None) is not None or \
            cache.k_pages.dtype not in (torch.bfloat16, torch.float16,
                                        torch.float32):
        raise not_ported("quantized paged pools (INT8/FP8/NF4)",
                         "quantized KV")
    if kv_starts is not None:
        raise not_ported("kv_starts (per-sequence first position)",
                         "paged-kernel options for Gemma and sinks")
    if logit_softcap is not None:
        raise not_ported("logit_softcap",
                         "paged-kernel options for Gemma and sinks")
    if window_size is not None and window_size <= 0:
        raise ValueError(f"window_size must be positive, got {window_size}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        return _paged_attention_cuda(q, cache, scale=scale,
                                     window_size=window_size, decode=decode)
    if q.device.type != "cpu":
        raise ValueError(f"paged attention runs on cpu or cuda tensors, "
                         f"got {q.device}")
    return _paged_attention_plain(q, cache, scale=scale,
                                  window_size=window_size)


def _paged_attention_plain(q, cache, *, scale, window_size):
    """The plain PyTorch version: gather every sequence's pages into a
    dense [batch, kv_heads, max_pages * page_size, d] K/V, mask, and
    take the softmax in float32.  It is what a CPU tensor runs and what
    the kernel is held against on the card."""
    k_pages, v_pages, table, lengths = cache
    b, qh, qc, d = q.shape
    _, kvh, ps, _ = k_pages.shape
    group = qh // kvh
    max_pages = table.shape[1]
    n = max_pages * ps
    lengths = lengths.long()
    # Entries past a sequence's live pages are ignored: read the null
    # page there instead.
    live_pages = torch.arange(max_pages, device=q.device)[None, :] < \
        (lengths[:, None] + ps - 1) // ps
    idx = torch.where(live_pages, table.long(), 0)

    def gather(pages):
        x = pages[idx]                          # [b, max_pages, kvh, ps, d]
        return x.permute(0, 2, 1, 3, 4).reshape(b, kvh, n, d).float()

    k, v = gather(k_pages), gather(v_pages)
    qg = q.reshape(b, kvh, group, qc, d).float()
    s = torch.einsum("bhgtd,bhnd->bhgtn", qg, k) * scale
    cols = torch.arange(n, device=q.device)[None, None, :]
    qpos = (lengths[:, None] - qc
            + torch.arange(qc, device=q.device)[None, :])[:, :, None]
    live = cols <= qpos                            # [b, qc, n]
    if window_size is not None:
        live &= cols > qpos - window_size
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
    args = [ptr] * 7 + [i32] * 7 + [ctypes.c_float, i32, ptr, ptr, i32,
                                    i32, ptr]
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


def _paged_attention_cuda(q, cache, *, scale, window_size, decode):
    """Launch the Hopper kernel; raise on anything it does not take."""
    k_pages, v_pages, table, lengths = cache
    b, qh, qc, d = q.shape
    _, kvh, ps, d_kv = k_pages.shape
    tensors = dict(q=q, k_pages=k_pages, v_pages=v_pages,
                   page_table=table, lengths=lengths)
    for name, t in tensors.items():
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    if k_pages.dtype != q.dtype or v_pages.dtype != q.dtype:
        raise TypeError("q and the pools must share a dtype, got "
                        f"{q.dtype}, {k_pages.dtype}, {v_pages.dtype}")
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
        raise not_ported(f"{q.dtype} pools in the paged kernel (it takes "
                         "bf16)", KERNEL_ITEM)
    if d not in KERNEL_HEAD_DIMS:
        raise not_ported(f"head_dim {d} in the paged kernel (it takes "
                         f"{KERNEL_HEAD_DIMS})", KERNEL_ITEM)
    tiles = tile_defines()
    group = qh // kvh
    if decode and group > tiles["MFA_DECODE_MAX_GROUP"]:
        raise not_ported(f"GQA groups above {tiles['MFA_DECODE_MAX_GROUP']} "
                         "in the paged decode kernel", KERNEL_ITEM)
    lib = _kernel_library()
    max_pages = table.shape[1]
    max_tokens = max_pages * ps
    sm_count = _sm_count(q.device.index or 0)
    if decode:
        tile = tiles["MFA_DECODE_BLOCK_KV"]
        if window_size is not None:
            # The last `window` keys start mid-tile at worst.
            max_tokens = min(max_tokens, window_size + tile)
        chunk, splits = decode_splits(b * kvh, max_tokens, sm_count, tile,
                                      tiles["MFA_DECODE_CHUNK"])
        rows, name = group, "paged_decode"
    else:
        row_tiles = cdiv(group * qc, tiles["MFA_PAGED_BLOCK_Q"])
        chunk, splits = decode_splits(row_tiles * kvh * b, max_tokens,
                                      sm_count, tiles["MFA_PAGED_BLOCK_KV"],
                                      tiles["MFA_PAGED_PREFILL_CHUNK"],
                                      at_most=True)
        rows, name = group * qc, "paged_prefill"
    o = torch.empty_like(q)
    lse = torch.empty((b, qh, qc), dtype=torch.float32, device=q.device)
    part_o, part_lse = split_scratch(b, kvh, splits, rows, d, q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"mfa_{name}")(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            table.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, qh, kvh, qc, d, ps, max_pages,
            ctypes.c_float(scale), window_size or 0, data_ptr(part_o),
            data_ptr(part_lse), splits, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.mfa_cuda_error_string(rc).decode()})")
    LAUNCH_COUNTS[name] += 1
    LAUNCH_COUNTS[f"{name}_sm90"] += 1
    return o, lse
