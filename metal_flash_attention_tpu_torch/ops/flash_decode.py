"""Fused decode attention against a dense KV cache (PyTorch, CUDA on
Hopper).

The port of the JAX package's `ops/flash_decode.py`: one new query token
per sequence attends its sequence's cached keys.  Layout (the JAX
package's, at every public function):

- q: [batch, q_heads, head_dim];
- k, v: [batch, kv_heads, max_seq, head_dim], q_heads a multiple of
  kv_heads (GQA: q head h reads kv head h // group);
- o: like q; lse (``return_residuals``): the natural-log row logsumexp
  [batch, q_heads] in float32, the merge residual of split caches.

Row b attends the positions ``kv_starts[b] <= col < kv_lens[b]``
(``kv_lens=None``: the whole cache; ``kv_starts=None``: from 0).  A row
that sees no key gives o = 0 and lse = -inf.

``logit_softcap`` c (Gemma-2) soft-caps each scaled logit s to
c * tanh(s / c) before the mask.

``max_span`` (it needs ``kv_starts`` and ``kv_lens``) bounds each row's
span.  The JAX kernel uses it to shorten its grid and silently drops the
tail of a row whose span is longer; the port clamps each row's end to
``kv_start + max_span`` instead, which is JAX's result exactly on every
valid call (span <= max_span).

k and v may be `QuantizedTensor`s (INT8 / FP8-E4M3 / FP8-E5M2 payloads
[batch, kv_heads, max_seq, head_dim], NF4 [..., head_dim / 2] packed
split-half along D; one scale per (batch, kv head)): the JAX kernel's
quantized cache, dequantized inside the kernel.

Dispatch: a CPU tensor takes the plain PyTorch version
(`_flash_decode_plain`: float32 scores and softmax, a quantized cache
dequantized in float32 first, NF4's codebook rounded to the queries'
type as the kernels round it); a CUDA tensor takes the hand-written
kernel in `csrc/flash_decode.cu` (bf16, fp16 and true fp32, head dims
32, 64 and 128, and bf16 and fp16 at 256; the soft cap over K/V in the
queries' type; quantized K/V with bf16 queries at 32, 64 and 128,
uncapped), or raises.  There is no
fallback from one to the other.  The kernel is the decode core of
`csrc/decode_common.cuh` (a cp.async K/V ring, tensor cores for 16-bit
inputs) split over the keys in fixed chunks
(`paged_attention.decode_splits`).  Each kernel launch adds one to
``LAUNCH_COUNTS["flash_decode"]`` and to
``LAUNCH_COUNTS["flash_decode_sm90"]``, over a quantized cache to
``LAUNCH_COUNTS["flash_decode_<precision>"]``, with the soft cap to
``["flash_decode_softcap"]``, at head_dim 256 to
``["flash_decode_d256"]`` and at head_dim 32 to ``["flash_decode_d32"]``
too; ``LAUNCH_TILES["flash_decode"]`` counts
the chunk (keys a split block) of each launch.

``block_kv`` (the JAX kernel's key block) is the cap on that chunk, in
whole MFA_DECODE_BLOCK_KV tiles (`paged_attention.chunk_cap`); without
it a tuned ``decode_<precision>`` winner of the runtime's config cache
(`runtime.autotune.autotune_decode`) caps it, else MFA_DECODE_CHUNK.
`decode_splits` sizes the chunk up to the cap, so none needs a rebuild.
``interpret`` (the TPU kernel's) is taken and ignored.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.native.build import tile_defines
from metal_flash_attention_tpu_torch.ops.paged_attention import (
    _sm_count,
    chunk_cap,
    data_ptr,
    decode_splits,
    split_scratch,
    tuned_chunk,
)
from metal_flash_attention_tpu_torch.ops.quantization import (
    KV_PRECISIONS,
    PRECISION_CODE,
    QuantizedTensor,
    dequantize,
    logical_shape,
)
from metal_flash_attention_tpu_torch.ops.reference import softcap_value
from metal_flash_attention_tpu_torch.utils.errors import not_ported

# Head dims of every type and precision (32: the tiny configs').
KERNEL_HEAD_DIMS = (32, 64, 128)
# Head dims of 16-bit queries over K/V in their type (Gemma-2's 256).
WIDE_HEAD_DIMS = (32, 64, 128, 256)
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# One count per kernel, bumped only where its wrapper launches it; the
# `_sm90` count names the Hopper kernel (`flash_decode90_kernel`) that every
# launch now runs, and `flash_decode_<precision>` counts its launches over
# a quantized cache (and `_softcap`, `_d256`, `_d32` its capped, head_dim
# 256 and head_dim 32 launches).
LAUNCH_COUNTS = {"flash_decode": 0, "flash_decode_sm90": 0,
                 **{f"flash_decode_{p.value}": 0 for p in KV_PRECISIONS},
                 "flash_decode_softcap": 0, "flash_decode_d256": 0,
                 "flash_decode_d32": 0}
# The chunks the kernel launched with: {keys a split block: launches}.
LAUNCH_TILES = {"flash_decode": collections.Counter()}

KERNEL_ITEM = "flash-kernel coverage"


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
    for tiles in LAUNCH_TILES.values():
        tiles.clear()


def flash_decode(q: torch.Tensor, k, v, *,
                 kv_lens: Optional[torch.Tensor] = None,
                 kv_starts: Optional[torch.Tensor] = None,
                 max_span: Optional[int] = None,
                 scale: Optional[float] = None,
                 logit_softcap: Optional[float] = None,
                 block_kv: Optional[int] = None,
                 interpret: Optional[bool] = None,
                 return_residuals: bool = False):
    """Decode-step attention for one new token per sequence.

    q: [batch, q_heads, head_dim]; k, v: [batch, kv_heads, max_seq,
    head_dim] (on the card, any batch, head and sequence strides with a
    contiguous last axis, so a slice along the sequence needs no copy),
    or both `QuantizedTensor`s of one precision.
    ``kv_lens``, ``kv_starts``: int [batch].  The query token itself must
    already be in the cache (at position kv_lens - 1).  ``scale``
    defaults to 1/sqrt(head_dim); ``logit_softcap`` c soft-caps each
    scaled logit to c * tanh(s / c).  ``block_kv``: the cap on a split
    block's keys on the card (module docstring); the plain version has
    none.

    Returns o [batch, q_heads, head_dim] in q's dtype, and with
    ``return_residuals`` also lse [batch, q_heads] (float32, natural
    log)."""
    del interpret
    if block_kv is not None and block_kv <= 0:
        raise ValueError(f"block_kv must be positive, got {block_kv}")
    quantized = isinstance(k, QuantizedTensor)
    kinds = (QuantizedTensor if quantized else torch.Tensor,)
    if not (isinstance(k, kinds) and isinstance(v, kinds)) or (
            quantized and k.precision is not v.precision):
        raise TypeError("k and v must both be tensors or both "
                        "QuantizedTensors of one precision")
    if quantized and k.precision not in KV_PRECISIONS:
        raise ValueError(f"not a KV precision: {k.precision}")
    softcap = softcap_value(logit_softcap)
    if max_span is not None:
        if kv_starts is None or kv_lens is None:
            raise ValueError("max_span requires kv_starts and kv_lens")
        if max_span <= 0:
            raise ValueError(f"max_span must be positive, got {max_span}")
    kv_shape = logical_shape(k)
    if q.dim() != 3 or len(kv_shape) != 4 or \
            logical_shape(v) != kv_shape or q.shape[0] != kv_shape[0] or \
            q.shape[2] != kv_shape[3] or kv_shape[1] == 0 or \
            q.shape[1] % kv_shape[1]:
        raise ValueError("expected q [b, q_heads, d] and k/v [b, kv_heads, "
                         "max_seq, d] with kv_heads dividing q_heads; got "
                         f"{tuple(q.shape)}, {kv_shape}, "
                         f"{logical_shape(v)}")
    for name, t in (("kv_lens", kv_lens), ("kv_starts", kv_starts)):
        if t is not None and tuple(t.shape) != (q.shape[0],):
            raise ValueError(f"{name} must be [batch], got {tuple(t.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kw = dict(kv_lens=kv_lens, kv_starts=kv_starts, max_span=max_span,
              scale=scale, softcap=softcap)
    if q.is_cuda:
        o, lse = _flash_decode_cuda(q, k, v, block_kv=block_kv, **kw)
    elif q.device.type == "cpu":
        o, lse = _flash_decode_plain(q, k, v, **kw)
    else:
        raise ValueError(f"flash_decode runs on cpu or cuda tensors, got "
                         f"{q.device}")
    return (o, lse) if return_residuals else o


def _flash_decode_plain(q, k, v, *, kv_lens, kv_starts, max_span, scale,
                        softcap=None):
    """The plain PyTorch version: float32 scores of each group against
    its kv head (soft-capped by ``softcap``), a mask from the rows'
    [lo, hi), and a float32 softmax
    (a quantized cache dequantized in float32 first, NF4's codebook
    rounded to q's type as the kernels round it).  It is what a CPU
    tensor runs and what the kernel is held against on the card."""
    if isinstance(k, QuantizedTensor):
        k, v = dequantize(k, q.dtype), dequantize(v, q.dtype)
    b, qh, d = q.shape
    _, kvh, n, _ = k.shape
    group = qh // kvh
    # Row b attends [lo, hi): lo = kv_starts (at least 0), hi = kv_lens
    # (at most n), clamped to lo + max_span.
    lo = (torch.zeros(b, dtype=torch.long, device=q.device)
          if kv_starts is None else kv_starts.long().clamp_min(0))
    hi = (torch.full((b,), n, dtype=torch.long, device=q.device)
          if kv_lens is None else kv_lens.long().clamp_max(n))
    if max_span is not None:
        hi = torch.minimum(hi, lo + max_span)
    qg = q.reshape(b, kvh, group, d).float()
    s = torch.einsum("bhgd,bhnd->bhgn", qg, k.float()) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    cols = torch.arange(n, device=q.device)[None, :]
    live = (cols >= lo[:, None]) & (cols < hi[:, None])         # [b, n]
    s = s.masked_fill(~live[:, None, None], float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgn,bhnd->bhgd", p, v.float()) / safe_l
    lse = torch.where(l > 0.0, m + torch.log(safe_l),
                      torch.full_like(l, float("-inf")))
    return o.reshape(b, qh, d).to(q.dtype), lse.reshape(b, qh)


def write_rows(cache: torch.Tensor, new: torch.Tensor,
               positions: torch.Tensor) -> None:
    """cache [batch, kv_heads, max_seq, d] <- new [batch, kv_heads, d]
    at each sequence's position, IN PLACE, by one `index_put_` scatter
    (no host sync)."""
    rows = torch.arange(cache.shape[0], device=cache.device)
    cache.permute(0, 2, 1, 3).index_put_(
        (rows, positions.long()), new.to(cache.dtype))


def decode_step(q_token: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, new_k: torch.Tensor,
                new_v: torch.Tensor, kv_lens: torch.Tensor, *,
                scale: Optional[float] = None,
                block_kv: Optional[int] = None,
                interpret: Optional[bool] = None):
    """One full decode step: write (new_k, new_v) [batch, kv_heads, d] at
    each sequence's live position, then attend.  The caches are updated
    IN PLACE (the JAX package donates them instead).  kv_lens: int
    [batch], the lengths before this step.

    ``block_kv``: `flash_decode`'s chunk cap (None: a tuned winner or
    the default, where the JAX package defaults to its TPU block of
    2048); ``interpret`` is ignored.  Returns (o [batch, q_heads,
    head_dim], k_cache, v_cache, kv_lens + 1)."""
    del interpret
    write_rows(k_cache, new_k, kv_lens)
    write_rows(v_cache, new_v, kv_lens)
    new_lens = kv_lens + 1
    o = flash_decode(q_token, k_cache, v_cache, kv_lens=new_lens,
                     scale=scale, block_kv=block_kv)
    return o, k_cache, v_cache, new_lens


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """Build (if stale) and bind csrc/flash_decode.cu."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    return bind_library(load_library("flash_decode"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of csrc/flash_decode.cu."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfa_flash_decode.argtypes = ([ptr] * 11 + [i32] * 5 + [
        ptr, i32, ctypes.c_float, ctypes.c_float, i32, i32, i32, i32, ptr])
    lib.mfa_flash_decode.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def decode_chunk_cap(block_kv, precision, head_dim: int, dtype,
                     n: int) -> int:
    """The most keys one split block of `flash_decode` takes: the caller's
    ``block_kv``, else a tuned ``decode_<precision>`` winner, else
    MFA_DECODE_CHUNK; in whole key tiles."""
    tiles = tile_defines()
    if block_kv is None:
        block_kv = tuned_chunk("decode", precision, head_dim, dtype, n)
    return chunk_cap(block_kv, tiles["MFA_DECODE_BLOCK_KV"],
                     tiles["MFA_DECODE_CHUNK"])


def _flash_decode_cuda(q, k, v, *, kv_lens, kv_starts, max_span, scale,
                       softcap, block_kv=None):
    """Launch the Hopper kernel; raise on anything it does not take.  q
    is made contiguous (a [batch, q_heads, d] copy at most); K and V are
    read in place through their strides."""
    b, qh, d = q.shape
    _, kvh, n, _ = logical_shape(k)
    precision = k.precision if isinstance(k, QuantizedTensor) else None
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the decode kernel takes bf16, fp16 or fp32, got "
                        f"{q.dtype}")
    if precision is None:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        scales = (None, None)
        head_dims = (KERNEL_HEAD_DIMS if q.dtype == torch.float32
                     else WIDE_HEAD_DIMS)
    else:
        if softcap is not None:
            raise not_ported("logit_softcap over a quantized cache in the "
                             "decode kernel", KERNEL_ITEM)
        head_dims = KERNEL_HEAD_DIMS
        if q.dtype != torch.bfloat16:
            raise not_ported(f"{q.dtype} queries over a quantized cache in "
                             "the decode kernel (it takes bf16)",
                             KERNEL_ITEM)
        for name, t in (("k", k), ("v", v)):
            if t.values.dtype != precision.storage_dtype:
                raise TypeError(f"{name} holds {t.values.dtype}, not "
                                f"{precision.value}'s "
                                f"{precision.storage_dtype}")
            if t.scales.dtype != torch.float32 or \
                    tuple(t.scales.shape) != (b, kvh) or \
                    not t.scales.is_contiguous() or \
                    t.scales.device != q.device:
                raise ValueError(f"{name}'s scales must be float32 [batch, "
                                 f"kv_heads] on {q.device}, contiguous")
        scales = (k.scales, v.scales)
        k, v = k.values, v.values
    if d not in head_dims:
        raise not_ported(f"head_dim {d} in the decode kernel (it takes "
                         f"{head_dims} here)", KERNEL_ITEM)
    # The key tile, the largest chunk and the largest group one block
    # holds, as the kernel reads them from csrc/flash_tiles.cuh.
    tiles = tile_defines()
    tile = tiles["MFA_DECODE_BLOCK_KV"]
    max_group = tiles["MFA_DECODE_MAX_GROUP"]
    if qh // kvh > max_group:
        raise not_ported(f"GQA groups above {max_group} in the decode "
                         "kernel", KERNEL_ITEM)
    q = q.contiguous()
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.stride(-1) != 1 or t.data_ptr() % 16 or \
                any(s * t.element_size() % 16 for s in t.stride()[:3]):
            raise ValueError(f"{name} needs a contiguous last axis, 16-byte "
                             f"aligned rows and start; strides "
                             f"{t.stride()}")
    idx = []
    for name, t in (("kv_lens", kv_lens), ("kv_starts", kv_starts)):
        if t is not None:
            if t.device != q.device:
                raise ValueError(f"{name} is on {t.device}, q on "
                                 f"{q.device}")
            t = t.to(torch.int32).contiguous()
        idx.append(t)
    lens, starts = idx
    lib = _kernel_library()
    # A span that starts mid-tile touches one tile more than it fills.
    max_tokens = n if max_span is None else min(n, max_span + tile)
    chunk, splits = decode_splits(
        b * kvh, max_tokens, _sm_count(q.device.index or 0), tile,
        decode_chunk_cap(block_kv, precision, d, q.dtype, n))
    o = torch.empty_like(q)
    lse = torch.empty((b, qh), dtype=torch.float32, device=q.device)
    part_o, part_lse = split_scratch(b, kvh, splits, qh // kvh, d, q.device)
    strides = (ctypes.c_longlong * 6)(*k.stride()[:3], *v.stride()[:3])
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = lib.mfa_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(data_ptr(t) for t in scales), data_ptr(lens),
            data_ptr(starts), o.data_ptr(), lse.data_ptr(),
            data_ptr(part_o), data_ptr(part_lse), b, qh, kvh, n, d, strides,
            max_span or 0, ctypes.c_float(scale),
            ctypes.c_float(softcap or 0.0), splits, chunk,
            KERNEL_DTYPES[q.dtype],
            0 if precision is None else PRECISION_CODE[precision], stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc} ({lib.mfa_cuda_error_string(rc).decode()})")
    LAUNCH_COUNTS["flash_decode"] += 1
    LAUNCH_COUNTS["flash_decode_sm90"] += 1
    LAUNCH_TILES["flash_decode"][chunk] += 1
    if precision is not None:
        LAUNCH_COUNTS[f"flash_decode_{precision.value}"] += 1
    if softcap is not None:
        LAUNCH_COUNTS["flash_decode_softcap"] += 1
    if d in (32, 256):
        LAUNCH_COUNTS[f"flash_decode_d{d}"] += 1
    return o, lse
