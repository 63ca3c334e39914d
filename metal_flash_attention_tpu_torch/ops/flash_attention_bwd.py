"""Atomic-free flash-attention backward (PyTorch, CUDA on Hopper).

The port of the JAX package's `ops/flash_attention_bwd.py`: the
reference's two-kernel split, each kernel owning its output tiles.

- backwardQuery (`flash_bwd_dq`): per query rows, recompute
  S = Q K^T and P = exp(S * scale - L), then dP = dO V^T,
  dS = P * (dP - D) and dQ = scale * dS K;
- backwardKeyValue (`flash_bwd_dkv`): per key columns, dV = P^T dO and
  dK = scale * dS^T Q, the GQA group summed inside the kernel, so no
  atomics and no reduction afterwards.

D = rowsum(dO * O) is computed once in PyTorch, in float32, and shared
by both kernels (the JAX package computes it in XLA outside its
kernels).  A row that saw no key carries L = -inf; the kernels read it as
0 so that its P, masked everywhere, is exactly 0.

`FlashAttentionFunction` is the `torch.autograd.Function` behind
`ops.flash_attention.flash_attention`, the counterpart of the JAX
package's `_flash_attention_vjp` / `_flash_attention_vjp_o`: its forward
saves q, k, v, o and lse, and its backward runs both kernels.

Dispatch: a CPU tensor takes the plain version (`_backward_plain`, the
analytic gradients of `ops.reference.attention_reference_grads`); a CUDA
tensor launches the Hopper kernels of `csrc/flash_attention_bwd.cu`
(TMA-fed, wgmma, for sm_90a), or raises.  Each launch adds one to
``LAUNCH_COUNTS["flash_bwd_dq"]`` or ``["flash_bwd_dkv"]`` (the op) and
to ``["flash_bwd_dq_sm90"]`` or ``["flash_bwd_dkv_sm90"]`` (the kernel
that ran).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.ops.flash_attention import (
    _forward as _flash_forward,
    check_kernel_operands,
    check_options,
    check_shapes,
    raise_on_launch_error,
)
from metal_flash_attention_tpu_torch.ops.reference import (
    attention_reference_grads,
)

# One count per op and per kernel, bumped only where the wrapper launches
# it.
LAUNCH_COUNTS = {"flash_bwd_dq": 0, "flash_bwd_dkv": 0,
                 "flash_bwd_dq_sm90": 0, "flash_bwd_dkv_sm90": 0}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = False,
                             window_size: Optional[int] = None,
                             mask=None, bias=None, mask2=None,
                             q_segment_ids=None, kv_segment_ids=None,
                             scale: Optional[float] = None,
                             logit_softcap: Optional[float] = None,
                             low_precision_intermediates: bool = False):
    """Both backward kernels -> (dq, dk, dv), each in its input's dtype.

    do and o are [batch, q_heads, q_len, head_dim]; lse is the forward's
    float32 natural-log logsumexp [batch, q_heads, q_len].  dk and dv are
    [batch, kv_heads, kv_len, head_dim], summed over each kv head's
    group."""
    check_options(k, mask=mask, bias=bias, mask2=mask2,
                  q_segment_ids=q_segment_ids,
                  kv_segment_ids=kv_segment_ids,
                  logit_softcap=logit_softcap,
                  low_precision_intermediates=low_precision_intermediates,
                  window_size=window_size)
    check_shapes(q, k, v)
    if do.shape != q.shape or o.shape != q.shape or \
            lse.shape != q.shape[:3]:
        raise ValueError(f"do/o must be shaped like q {tuple(q.shape)} and "
                         f"lse like {tuple(q.shape[:3])}; got "
                         f"{tuple(do.shape)}, {tuple(o.shape)}, "
                         f"{tuple(lse.shape)}")
    return _backward(q, k, v, do, o, lse, causal=causal,
                     window_size=window_size, scale=scale)


def _backward(q, k, v, do, o, lse, *, causal, window_size, scale):
    """The backward on checked operands: both kernels for a CUDA tensor,
    the plain version for a CPU tensor."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    with torch.no_grad():
        if q.is_cuda:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            do = do.to(q.dtype).contiguous()
            lse = lse.float().contiguous()
            d_term = (do.float() * o.float()).sum(dim=-1)
            kw = dict(causal=causal, window_size=window_size, scale=scale)
            dq = _dq_cuda(q, k, v, do, lse, d_term, **kw)
            dk, dv = _dkv_cuda(q, k, v, do, lse, d_term, **kw)
            return dq, dk, dv
        if q.device.type != "cpu":
            raise ValueError(f"flash attention runs on cpu or cuda "
                             f"tensors, got {q.device}")
        return _backward_plain(q, k, v, do, causal=causal,
                               window_size=window_size, scale=scale)


class FlashAttentionFunction(torch.autograd.Function):
    """(q, k, v, causal, window_size, scale, out_dtype) -> (o, lse); lse
    is not differentiable (its cotangent is dropped, as in JAX)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window_size, scale, out_dtype):
        o, lse = _flash_forward(q, k, v, causal=causal,
                                window_size=window_size, scale=scale,
                                out_dtype=out_dtype)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.options = dict(causal=causal, window_size=window_size,
                           scale=scale)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(q, k, v, do, o, lse, **ctx.options)
        return dq, dk, dv, None, None, None, None


def _backward_plain(q, k, v, do, *, causal, window_size, scale):
    """The plain PyTorch version: the analytic float32 gradients of
    `attention_reference_grads`, cast to the inputs' dtypes.  It is what
    a CPU tensor runs and what the kernels are held against on the
    card."""
    dq, dk, dv, *_ = attention_reference_grads(
        q, k, v, do, causal=causal, window_size=window_size, scale=scale)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """Build (if stale) and bind csrc/flash_attention_bwd.cu."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    return bind_library(load_library("flash_attention_bwd"))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of csrc/flash_attention_bwd.cu."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32] * 6 + [f32] + [i32] * 3 + [ptr]
    lib.mfa_flash_bwd_dq.argtypes = [ptr] * 7 + shape
    lib.mfa_flash_bwd_dq.restype = i32
    lib.mfa_flash_bwd_dkv.argtypes = [ptr] * 8 + shape
    lib.mfa_flash_bwd_dkv.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, outputs, q, k, v, do, lse, d_term, *, causal,
            window_size, scale):
    """Check the operands and launch one backward kernel."""
    check_kernel_operands(dict(q=q, k=k, v=v, do=do, lse=lse,
                               d_term=d_term), q.dtype, q.device)
    if k.dtype != q.dtype or v.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError("q, k, v and do must share a dtype")
    if lse.dtype != torch.float32 or d_term.dtype != torch.float32:
        raise TypeError("lse and the D term must be float32")
    b, qh, n, d = q.shape
    kvh, m = k.shape[1], k.shape[2]
    lib = _kernel_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"mfa_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), d_term.data_ptr(),
            *[t.data_ptr() for t in outputs], b, qh, kvh, n, m, d,
            ctypes.c_float(scale), int(causal), window_size or 0,
            int(q.dtype == torch.float16), stream)
    raise_on_launch_error(lib, rc, name)
    LAUNCH_COUNTS[name] += 1
    LAUNCH_COUNTS[f"{name}_sm90"] += 1


def _dq_cuda(q, k, v, do, lse, d_term, **kw):
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (dq,), q, k, v, do, lse, d_term, **kw)
    return dq


def _dkv_cuda(q, k, v, do, lse, d_term, **kw):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", (dk, dv), q, k, v, do, lse, d_term, **kw)
    return dk, dv
