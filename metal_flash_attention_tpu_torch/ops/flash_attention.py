"""Fused flash-attention forward (PyTorch, CUDA on Hopper).

The port of the JAX package's `ops/flash_attention.py`: O =
softmax(Q K^T * scale) V and the natural-log row logsumexp lse, for

- q: [batch, q_heads, q_len, head_dim];
- k, v: [batch, kv_heads, kv_len, head_dim], q_heads a multiple of
  kv_heads (GQA: q head h reads kv head h // group).

Causal masking is aligned bottom-right: with offset = kv_len - q_len,
row r sees keys c <= r + offset; ``window_size`` w keeps keys
c > r + offset - w (with or without causal).  A row that sees no key
gives o = 0 and lse = -inf.

`flash_attention` is differentiable (the backward is
`ops.flash_attention_bwd`, two more kernels); `flash_attention_forward`
returns (o, lse) without a graph.

Dispatch: a CPU tensor takes the plain PyTorch version
(`_forward_plain`: materialised float32 scores); a CUDA tensor takes the
hand-written kernel in `csrc/flash_attention.cu` (TMA-fed, wgmma, for
sm_90a), or raises.  The kernel takes bf16 and fp16 (computed natively
on fp16 tensor cores, where the JAX package computes fp16 in bf16) at
head dims 64 and 128, with or without causal masking and a window, any
q_len and kv_len, and a bf16/fp16 or float32 O.  Each launch adds one to
``LAUNCH_COUNTS["flash_fwd"]`` (the op) and to
``LAUNCH_COUNTS["flash_fwd_sm90"]`` (the kernel that ran).

Not ported yet, and refused on every device: mask / bias / mask2,
segment ids, logit_softcap, low_precision_intermediates and quantized
K/V.  The TPU block sizes (``block_q``, ``block_kv``) have no meaning
here: the kernels' tiles are fixed (`descriptors.attention_descriptor`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.ops.reference import attention_reference
from metal_flash_attention_tpu_torch.utils.errors import not_ported

KERNEL_HEAD_DIMS = (64, 128)
KERNEL_DTYPES = (torch.bfloat16, torch.float16)

# One count per kernel, bumped only where its wrapper launches it.
LAUNCH_COUNTS = {"flash_fwd": 0, "flash_fwd_sm90": 0}

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
    if not isinstance(k, torch.Tensor):
        raise not_ported("quantized K/V (QuantizedTensor)", "quantized KV")
    if mask is not None or bias is not None or mask2 is not None:
        raise not_ported("mask, bias and mask2 operands", OPTIONS_ITEM)
    if q_segment_ids is not None or kv_segment_ids is not None:
        raise not_ported("segment ids", OPTIONS_ITEM)
    if logit_softcap is not None:
        raise not_ported("logit_softcap", OPTIONS_ITEM)
    if low_precision_intermediates:
        raise not_ported("low_precision_intermediates", OPTIONS_ITEM)
    if window_size is not None and window_size <= 0:
        raise ValueError(f"window_size must be positive, got {window_size}")


def check_shapes(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            k.shape[1] == 0 or q.shape[1] % k.shape[1]:
        raise ValueError("expected q [b, q_heads, q_len, d] and k/v "
                         "[b, kv_heads, kv_len, d] with kv_heads dividing "
                         f"q_heads; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")


def check_kernel_operands(tensors: dict, dtype: torch.dtype,
                          device: torch.device) -> None:
    """What every attention kernel of the port takes: tensors on one card,
    contiguous and 16-byte aligned, 16-bit inputs at head dim 64 or
    128."""
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
    if d not in KERNEL_HEAD_DIMS:
        raise not_ported(f"head_dim {d} in the CUDA kernels (they take "
                         f"{KERNEL_HEAD_DIMS})", KERNEL_ITEM)


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
                    scale=scale, out_dtype=out_dtype)


def _forward(q, k, v, *, causal, window_size, scale, out_dtype):
    """The forward on checked operands: the kernel for a CUDA tensor,
    the plain version for a CPU tensor."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = out_dtype or q.dtype
    with torch.no_grad():
        if q.is_cuda:
            return _forward_cuda(q.contiguous(), k.contiguous(),
                                 v.contiguous(), causal=causal,
                                 window_size=window_size, scale=scale,
                                 out_dtype=out_dtype)
        if q.device.type != "cpu":
            raise ValueError(f"flash attention runs on cpu or cuda "
                             f"tensors, got {q.device}")
        return _forward_plain(q, k, v, causal=causal,
                              window_size=window_size, scale=scale,
                              out_dtype=out_dtype)


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
    none, as in the JAX package.  See `flash_attention_forward` for the
    arguments."""
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
    o, lse = FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), causal,
        window_size, scale, out_dtype)
    return (o, lse) if return_residuals else o


def _forward_plain(q, k, v, *, causal, window_size, scale, out_dtype):
    """The plain PyTorch version: materialised float32 scores and
    softmax (`ops.reference`).  It is what a CPU tensor runs and what the
    kernel is held against on the card."""
    o, lse = attention_reference(q, k, v, causal=causal,
                                 window_size=window_size, scale=scale,
                                 return_residuals=True)
    return o.to(out_dtype), lse


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """Build (if stale) and bind csrc/flash_attention.cu."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    lib = load_library("flash_attention")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfa_flash_fwd.argtypes = ([ptr] * 5 + [i32] * 6
                                  + [ctypes.c_float] + [i32] * 4 + [ptr])
    lib.mfa_flash_fwd.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _forward_cuda(q, k, v, *, causal, window_size, scale, out_dtype):
    """Launch the Hopper kernel; raise on anything it does not take."""
    check_kernel_operands(dict(q=q, k=k, v=v), q.dtype, q.device)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
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
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, qh, kvh, n, m, d, ctypes.c_float(scale),
            int(causal), window_size or 0, int(q.dtype == torch.float16),
            int(out_dtype == torch.float32), stream)
    raise_on_launch_error(lib, rc, "flash_fwd")
    LAUNCH_COUNTS["flash_fwd"] += 1
    LAUNCH_COUNTS["flash_fwd_sm90"] += 1
    return o, lse
