"""Fused flash-attention forward (PyTorch, CUDA on Hopper).

The port of the JAX package's `ops/flash_attention.py`: O =
softmax(Q K^T * scale) V and the natural-log row logsumexp lse, for

- q: [batch, q_heads, q_len, head_dim];
- k, v: [batch, kv_heads, kv_len, head_dim], q_heads a multiple of
  kv_heads (GQA: q head h reads kv head h // group).

Causal masking is aligned bottom-right: with offset = kv_len - q_len,
row r sees keys c <= r + offset; ``window_size`` w keeps keys
c > r + offset - w (with or without causal).  ``logit_softcap`` c
(Gemma-2) soft-caps each scaled logit s to c * tanh(s / c) before the
mask.  A row that sees no key gives o = 0 and lse = -inf.

`flash_attention` is differentiable (the backward is
`ops.flash_attention_bwd`, two more kernels), with the soft cap and at
every head dim the forward takes, 256 included (Gemma-2 training);
`flash_attention_forward` returns (o, lse) without a graph.

k and v may both be `QuantizedTensor`s of one precision (INT8,
FP8-E4M3, FP8-E5M2, NF4; `ops.quantization`'s layout: payload [batch,
kv_heads, kv_len, head_dim], NF4 [.., head_dim / 2] split-half, scales
float32 [batch, kv_heads]), as a serving path's quantized cache.  Such a
call is not differentiated: `flash_attention` returns the forward, as in
the JAX package.

Dispatch: a CPU tensor takes the plain PyTorch version
(`_forward_plain`: materialised float32 scores); a CUDA tensor takes the
hand-written kernel in `csrc/flash_attention.cu` (TMA-fed, wgmma, for
sm_90a), or raises.  The kernel takes bf16 and fp16 (computed natively
on fp16 tensor cores, where the JAX package computes fp16 in bf16) at
head dims 64, 128 and 256, with or without causal masking, a window and
the soft cap, any q_len and kv_len, and a bf16/fp16 or float32 O; over
quantized K/V (head dims 64 and 128, no cap) it decodes each tile in
shared memory and takes bf16 queries (fp16 ones raise
NotImplementedError on the card; the plain version takes them).
The plain version dequantizes in float32 first, NF4's codebook rounded
to the queries' type as the kernel rounds it.  Each launch adds one to
``LAUNCH_COUNTS["flash_fwd"]`` (the op) and to
``LAUNCH_COUNTS["flash_fwd_sm90"]`` (the kernel that ran), over
quantized K/V to ``LAUNCH_COUNTS["flash_fwd_<precision>"]``, with the
soft cap to ``["flash_fwd_softcap"]`` and at head_dim 256 to
``["flash_fwd_d256"]`` too.

Not ported yet, and refused on every device: mask / bias / mask2,
segment ids and low_precision_intermediates.  The TPU
block sizes (``block_q``, ``block_kv``) have no meaning
here: the kernels' tiles are fixed (`descriptors.attention_descriptor`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.ops.quantization import (
    KV_PRECISIONS,
    PRECISION_CODE,
    QuantizedTensor,
    dequantize,
    logical_shape,
)
from metal_flash_attention_tpu_torch.ops.reference import (
    attention_reference,
    softcap_value,
)
from metal_flash_attention_tpu_torch.utils.errors import not_ported

# Head dims of every attention kernel; the forward and the backward over
# K/V in q's type also take Gemma-2's 256.
KERNEL_HEAD_DIMS = (64, 128)
UNQUANTIZED_HEAD_DIMS = (64, 128, 256)
KERNEL_DTYPES = (torch.bfloat16, torch.float16)

# One count per kernel, bumped only where its wrapper launches it.
LAUNCH_COUNTS = {"flash_fwd": 0, "flash_fwd_sm90": 0,
                 **{f"flash_fwd_{p.value}": 0 for p in KV_PRECISIONS},
                 "flash_fwd_softcap": 0, "flash_fwd_d256": 0}

OPTIONS_ITEM = "flash-attention options"
KERNEL_ITEM = "flash-kernel coverage"


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def check_options(k, *, mask=None, bias=None, mask2=None,
                  q_segment_ids=None, kv_segment_ids=None,
                  logit_softcap=None, low_precision_intermediates=False,
                  window_size=None) -> None:
    """Refuse, on every device, what the port does not compute yet."""
    if mask is not None or bias is not None or mask2 is not None:
        raise not_ported("mask, bias and mask2 operands", OPTIONS_ITEM)
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise not_ported("segment ids", OPTIONS_ITEM)
    if low_precision_intermediates:
        raise not_ported("low_precision_intermediates", OPTIONS_ITEM)
    if window_size is not None and window_size <= 0:
        raise ValueError(f"window_size must be positive, got {window_size}")


def check_shapes(q, k, v) -> None:
    quantized = isinstance(k, QuantizedTensor)
    kind = QuantizedTensor if quantized else torch.Tensor
    if not (isinstance(k, kind) and isinstance(v, kind)) or (
            quantized and k.precision is not v.precision):
        raise TypeError("k and v must both be tensors or both "
                        "QuantizedTensors of one precision")
    if quantized and k.precision not in KV_PRECISIONS:
        raise ValueError(f"not a KV precision: {k.precision}")
    ks, vs = logical_shape(k), logical_shape(v)
    if q.dim() != 4 or len(ks) != 4 or vs != ks or q.shape[0] != ks[0] or \
            q.shape[3] != ks[3] or ks[1] == 0 or q.shape[1] % ks[1]:
        raise ValueError("expected q [b, q_heads, q_len, d] and k/v "
                         "[b, kv_heads, kv_len, d] with kv_heads dividing "
                         f"q_heads; got {tuple(q.shape)}, {ks}, {vs}")


def check_kernel_operands(tensors: dict, dtype: torch.dtype,
                          device: torch.device,
                          head_dims=KERNEL_HEAD_DIMS) -> None:
    """What every attention kernel of the port takes: tensors on one card,
    contiguous and 16-byte aligned, 16-bit inputs at one of the kernel's
    ``head_dims``."""
    if dtype == torch.float32:
        raise not_ported("float32 attention on CUDA (true fp32, no TF32)",
                         KERNEL_ITEM)
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the attention kernels take bf16 or fp16, got "
                        f"{dtype}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             "aligned")
    d = tensors["q"].shape[-1]
    if d not in head_dims:
        raise not_ported(f"head_dim {d} in this CUDA kernel (it takes "
                         f"{head_dims})", KERNEL_ITEM)


def raise_on_launch_error(lib, rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.mfa_cuda_error_string(rc).decode()})")


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = False,
                            window_size: Optional[int] = None,
                            mask=None, bias=None, mask2=None,
                            q_segment_ids=None, kv_segment_ids=None,
                            scale: Optional[float] = None,
                            logit_softcap: Optional[float] = None,
                            low_precision_intermediates: bool = False,
                            out_dtype: Optional[torch.dtype] = None):
    """Fused forward attention -> (o, lse).

    o is [batch, q_heads, q_len, head_dim] in ``out_dtype`` (default
    q's dtype); lse is the float32 natural-log row logsumexp
    [batch, q_heads, q_len].  No autograd graph: see `flash_attention`.
    """
    check_options(k, mask=mask, bias=bias, mask2=mask2,
                  q_segment_ids=q_segment_ids,
                  kv_segment_ids=kv_segment_ids,
                  logit_softcap=logit_softcap,
                  low_precision_intermediates=low_precision_intermediates,
                  window_size=window_size)
    check_shapes(q, k, v)
    return _forward(q, k, v, causal=causal, window_size=window_size,
                    scale=scale, out_dtype=out_dtype,
                    softcap=softcap_value(logit_softcap))


def _forward(q, k, v, *, causal, window_size, scale, out_dtype,
             softcap=None):
    """The forward on checked operands: the kernel for a CUDA tensor,
    the plain version for a CPU tensor.  ``softcap``: the cap, or None."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = out_dtype or q.dtype
    quantized = isinstance(k, QuantizedTensor)
    with torch.no_grad():
        if q.is_cuda:
            if not quantized:
                k, v = k.contiguous(), v.contiguous()
            return _forward_cuda(q.contiguous(), k, v, causal=causal,
                                 window_size=window_size, scale=scale,
                                 out_dtype=out_dtype, softcap=softcap)
        if q.device.type != "cpu":
            raise ValueError(f"flash attention runs on cpu or cuda "
                             f"tensors, got {q.device}")
        plain = _forward_plain_quantized if quantized else _forward_plain
        return plain(q, k, v, causal=causal, window_size=window_size,
                     scale=scale, out_dtype=out_dtype, softcap=softcap)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask=None, bias=None, mask2=None, q_segment_ids=None,
                    kv_segment_ids=None, *, causal: bool = False,
                    window_size: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None,
                    return_residuals: bool = False,
                    low_precision_intermediates: bool = False,
                    out_dtype: Optional[torch.dtype] = None):
    """Differentiable fused attention: o, or (o, lse) with
    ``return_residuals``.  Gradients reach q, k and v through the
    atomic-free backward (`ops.flash_attention_bwd`); lse carries
    none, as in the JAX package.  Over quantized K/V it is the forward,
    with no graph.  See `flash_attention_forward` for the arguments."""
    from metal_flash_attention_tpu_torch.ops.flash_attention_bwd import (
        FlashAttentionFunction,
    )

    check_options(k, mask=mask, bias=bias, mask2=mask2,
                  q_segment_ids=q_segment_ids,
                  kv_segment_ids=kv_segment_ids,
                  logit_softcap=logit_softcap,
                  low_precision_intermediates=low_precision_intermediates,
                  window_size=window_size)
    check_shapes(q, k, v)
    softcap = softcap_value(logit_softcap)
    if isinstance(k, QuantizedTensor):
        o, lse = _forward(q, k, v, causal=causal, window_size=window_size,
                          scale=scale, out_dtype=out_dtype, softcap=softcap)
        return (o, lse) if return_residuals else o
    o, lse = FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal,
        window_size, scale, out_dtype, softcap)
    return (o, lse) if return_residuals else o


def _forward_plain(q, k, v, *, causal, window_size, scale, out_dtype,
                   softcap=None):
    """The plain PyTorch version: materialised float32 scores and
    softmax (`ops.reference`).  It is what a CPU tensor runs and what the
    kernel is held against on the card."""
    o, lse = attention_reference(q, k, v, causal=causal,
                                 window_size=window_size, scale=scale,
                                 logit_softcap=softcap,
                                 return_residuals=True)
    return o.to(out_dtype), lse


def _forward_plain_quantized(q, k, v, *, causal, window_size, scale,
                             out_dtype, softcap=None):
    """The plain version over quantized K/V: each dequantized in float32
    (NF4's codebook rounded to q's type, as the kernel rounds it), then
    `_forward_plain`.  What a CPU tensor runs, and what the kernel is
    held against on the card."""
    return _forward_plain(q, dequantize(k, q.dtype), dequantize(v, q.dtype),
                          causal=causal, window_size=window_size,
                          scale=scale, out_dtype=out_dtype, softcap=softcap)


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """Build (if stale) and bind csrc/flash_attention.cu."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    return bind_library(load_library("flash_attention"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of csrc/flash_attention.cu."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfa_flash_fwd.argtypes = ([ptr] * 7 + [i32] * 6
                                  + [ctypes.c_float] * 2 + [i32] * 5 + [ptr])
    lib.mfa_flash_fwd.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _quantized_operands(q, k, v):
    """The payloads and scales of quantized K/V as the kernel takes them,
    or raise on what it does not take."""
    precision = k.precision
    if q.dtype != torch.bfloat16:
        raise not_ported(f"{q.dtype} queries over quantized K/V in the "
                         "forward kernel (it takes bf16)", KERNEL_ITEM)
    b, kvh = k.values.shape[:2]
    for name, t in (("k", k), ("v", v)):
        if t.values.dtype != precision.storage_dtype:
            raise TypeError(f"{name} holds {t.values.dtype}, not "
                            f"{precision.value}'s {precision.storage_dtype}")
        if t.scales.dtype != torch.float32 or \
                tuple(t.scales.shape) != (b, kvh) or \
                t.scales.device != q.device:
            raise ValueError(f"{name}'s scales must be float32 [batch, "
                             f"kv_heads] on {q.device}")
    return (k.values.contiguous(), v.values.contiguous(),
            k.scales.contiguous(), v.scales.contiguous(), precision)


def _forward_cuda(q, k, v, *, causal, window_size, scale, out_dtype,
                  softcap=None):
    """Launch the Hopper kernel; raise on anything it does not take."""
    precision, scales = None, (None, None)
    head_dims = UNQUANTIZED_HEAD_DIMS
    if isinstance(k, QuantizedTensor):
        if softcap is not None:
            raise not_ported("logit_softcap over quantized K/V in the "
                             "forward kernel", KERNEL_ITEM)
        k, v, *scales, precision = _quantized_operands(q, k, v)
        head_dims = KERNEL_HEAD_DIMS
    elif k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    check_kernel_operands(dict(q=q, k=k, v=v), q.dtype, q.device,
                          head_dims)
    if out_dtype not in (q.dtype, torch.float32):
        raise TypeError(f"out_dtype must be q's dtype or float32, got "
                        f"{out_dtype}")
    b, qh, n, d = q.shape
    kvh, m = k.shape[1], k.shape[2]
    lib = _kernel_library()
    o = torch.empty((b, qh, n, d), dtype=out_dtype, device=q.device)
    lse = torch.empty((b, qh, n), dtype=torch.float32, device=q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = lib.mfa_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            *(None if s is None else s.data_ptr() for s in scales),
            o.data_ptr(), lse.data_ptr(), b, qh, kvh, n, m, d,
            ctypes.c_float(scale), ctypes.c_float(softcap or 0.0),
            int(causal), window_size or 0,
            int(q.dtype == torch.float16), int(out_dtype == torch.float32),
            0 if precision is None else PRECISION_CODE[precision], stream)
    raise_on_launch_error(lib, rc, "flash_fwd")
    LAUNCH_COUNTS["flash_fwd"] += 1
    LAUNCH_COUNTS["flash_fwd_sm90"] += 1
    if precision is not None:
        LAUNCH_COUNTS[f"flash_fwd_{precision.value}"] += 1
    if softcap is not None:
        LAUNCH_COUNTS["flash_fwd_softcap"] += 1
    if d == 256:
        LAUNCH_COUNTS["flash_fwd_d256"] += 1
    return o, lse
