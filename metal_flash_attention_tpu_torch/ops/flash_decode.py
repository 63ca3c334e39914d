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
kernel in `csrc/flash_decode.cu` (bf16, fp16 and true fp32, head dims 64
and 128; quantized K/V with bf16 queries), or raises.  There is no
fallback from one to the other.  The kernel is the decode core of
`csrc/decode_common.cuh` (a cp.async K/V ring, tensor cores for 16-bit
inputs) split over the keys in fixed chunks
(`paged_attention.decode_splits`).  Each kernel launch adds one to
``LAUNCH_COUNTS["flash_decode"]`` and to
``LAUNCH_COUNTS["flash_decode_sm90"]``, and over a quantized cache to
``LAUNCH_COUNTS["flash_decode_<precision>"]`` too.

Not ported yet, and refused on every device: ``logit_softcap``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.native.build import tile_defines
from metal_flash_attention_tpu_torch.ops.paged_attention import (
    KV_PRECISIONS,
    _sm_count,
    data_ptr,
    decode_splits,
    split_scratch,
)
from metal_flash_attention_tpu_torch.ops.quantization import (
    PRECISION_CODE,
    QuantizedTensor,
    dequantize,
)
from metal_flash_attention_tpu_torch.utils.errors import not_ported

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}

# One count per kernel, bumped only where its wrapper launches it; the
# `_sm90` count names the Hopper kernel (`flash_decode90_kernel`) that every
# launch now runs, and `flash_decode_<precision>` counts its launches over
# a quantized cache.
LAUNCH_COUNTS = {"flash_decode": 0, "flash_decode_sm90": 0,
                 **{f"flash_decode_{p.value}": 0 for p in KV_PRECISIONS}}

KERNEL_ITEM = "flash-kernel coverage"


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def flash_decode(q: torch.Tensor, k, v, *,
                 kv_lens: Optional[torch.Tensor] = None,
                 kv_starts: Optional[torch.Tensor] = None,
                 max_span: Optional[int] = None,
                 scale: Optional[float] = None,
                 logit_softcap: Optional[float] = None,
                 block_kv: Optional[int] = None,
                 return_residuals: bool = False):
    """Decode-step attention for one new token per sequence.

    q: [batch, q_heads, head_dim]; k, v: [batch, kv_heads, max_seq,
    head_dim] (on the card, any batch, head and sequence strides with a
    contiguous last axis, so a slice along the sequence needs no copy),
    or both `QuantizedTensor`s of one precision.
    ``kv_lens``, ``kv_starts``: int [batch].  The query token itself must
    already be in the cache (at position kv_lens - 1).  ``scale``
    defaults to 1/sqrt(head_dim).  ``block_kv`` is the TPU kernel's
    key-block size: accepted and ignored on both devices (the CUDA
    kernel's tile is fixed).

    Returns o [batch, q_heads, head_dim] in q's dtype, and with
    ``return_residuals`` also lse [batch, q_heads] (float32, natural
    log)."""
    del block_kv
    quantized = isinstance(k, QuantizedTensor)
    kinds = (QuantizedTensor if quantized else torch.Tensor,)
    if not (isinstance(k, kinds) and isinstance(v, kinds)) or (
            quantized and k.precision is not v.precision):
        raise TypeError("k and v must both be tensors or both "
                        "QuantizedTensors of one precision")
    if quantized and k.precision not in KV_PRECISIONS:
        raise ValueError(f"not a KV precision: {k.precision}")
    if logit_softcap is not None:
        raise not_ported("logit_softcap in flash_decode", "decode softcap")
    if max_span is not None:
        if kv_starts is None or kv_lens is None:
            raise ValueError("max_span requires kv_starts and kv_lens")
        if max_span <= 0:
            raise ValueError(f"max_span must be positive, got {max_span}")
    kv_shape = _logical_shape(k)
    if q.dim() != 3 or len(kv_shape) != 4 or \
            _logical_shape(v) != kv_shape or q.shape[0] != kv_shape[0] or \
            q.shape[2] != kv_shape[3] or kv_shape[1] == 0 or \
            q.shape[1] % kv_shape[1]:
        raise ValueError("expected q [b, q_heads, d] and k/v [b, kv_heads, "
                         "max_seq, d] with kv_heads dividing q_heads; got "
                         f"{tuple(q.shape)}, {kv_shape}, "
                         f"{_logical_shape(v)}")
    for name, t in (("kv_lens", kv_lens), ("kv_starts", kv_starts)):
        if t is not None and tuple(t.shape) != (q.shape[0],):
            raise ValueError(f"{name} must be [batch], got {tuple(t.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.is_cuda:
        o, lse = _flash_decode_cuda(q, k, v, kv_lens=kv_lens,
                                    kv_starts=kv_starts, max_span=max_span,
                                    scale=scale)
    elif q.device.type == "cpu":
        o, lse = _flash_decode_plain(q, k, v, kv_lens=kv_lens,
                                     kv_starts=kv_starts, max_span=max_span,
                                     scale=scale)
    else:
        raise ValueError(f"flash_decode runs on cpu or cuda tensors, got "
                         f"{q.device}")
    return (o, lse) if return_residuals else o


def _logical_shape(x) -> tuple:
    """[batch, kv_heads, max_seq, head_dim] of a cache or a quantized one
    (NF4 payloads hold head_dim / 2 bytes a row)."""
    if not isinstance(x, QuantizedTensor):
        return tuple(x.shape)
    shape = tuple(x.values.shape)
    if x.precision is OperandPrecision.NF4:
        shape = shape[:-1] + (2 * shape[-1],)
    return shape


def _flash_decode_plain(q, k, v, *, kv_lens, kv_starts, max_span, scale):
    """The plain PyTorch version: float32 scores of each group against
    its kv head, a mask from the rows' [lo, hi), and a float32 softmax
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
                scale: Optional[float] = None, block_kv: int = 2048):
    """One full decode step: write (new_k, new_v) [batch, kv_heads, d] at
    each sequence's live position, then attend.  The caches are updated
    IN PLACE (the JAX package donates them instead).  kv_lens: int
    [batch], the lengths before this step.

    Returns (o [batch, q_heads, head_dim], k_cache, v_cache,
    kv_lens + 1)."""
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
        ptr, i32, ctypes.c_float, i32, i32, i32, i32, ptr])
    lib.mfa_flash_decode.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _flash_decode_cuda(q, k, v, *, kv_lens, kv_starts, max_span, scale):
    """Launch the Hopper kernel; raise on anything it does not take.  q
    is made contiguous (a [batch, q_heads, d] copy at most); K and V are
    read in place through their strides."""
    b, qh, d = q.shape
    _, kvh, n, _ = _logical_shape(k)
    precision = k.precision if isinstance(k, QuantizedTensor) else None
    if q.dtype not in KERNEL_DTYPES:
        raise TypeError(f"the decode kernel takes bf16, fp16 or fp32, got "
                        f"{q.dtype}")
    if precision is None:
        if k.dtype != q.dtype or v.dtype != q.dtype:
            raise TypeError(f"q, k and v must share a dtype, got "
                            f"{q.dtype}, {k.dtype}, {v.dtype}")
        scales = (None, None)
    else:
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
    if d not in KERNEL_HEAD_DIMS:
        raise not_ported(f"head_dim {d} in the decode kernel (it takes "
                         f"{KERNEL_HEAD_DIMS})", KERNEL_ITEM)
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
    chunk, splits = decode_splits(b * kvh, max_tokens,
                                  _sm_count(q.device.index or 0), tile,
                                  tiles["MFA_DECODE_CHUNK"])
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
            max_span or 0, ctypes.c_float(scale), splits, chunk,
            KERNEL_DTYPES[q.dtype],
            0 if precision is None else PRECISION_CODE[precision], stream)
    if rc != 0:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc} ({lib.mfa_cuda_error_string(rc).decode()})")
    LAUNCH_COUNTS["flash_decode"] += 1
    LAUNCH_COUNTS["flash_decode_sm90"] += 1
    if precision is not None:
        LAUNCH_COUNTS[f"flash_decode_{precision.value}"] += 1
    return o, lse
