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

Gemma-2's ``logit_softcap`` c is differentiated as the JAX kernels do
it: P is the capped logits', and dS takes the chain factor
1 - tanh(s / c)^2 before dQ and dK.  Head dims 32, 64, 128 and 256 (32
on the D 64 kernels over 32-column rows, without the options).

The options (`ops.flash_attention`): P is the biased, gated and
segmented logits', as the forward's; mask, mask2 and the segment ids
get no gradient; a bias that needs one gets dbias = P (dP - D) in
natural units, before the cap's factor (the JAX dQ kernel writes it
beside dQ), summed over the bias's size-1 dims with `torch.sum` as JAX's
`jnp.sum`.  A bias whose batch or head dim repeats (1 < B_b < batch)
has no such reduction in JAX either: its gradient raises ValueError, as
JAX's `custom_vjp` does on the shape.  With ``low_precision_intermediates``
the kernels read D rounded to bf16, as JAX stores it (lse comes in
bf16 from the forward).  On the card the options run on the `kAux`
kernels, also counted as ``["<op>_aux"]``.

Dispatch: a CPU tensor takes the plain version (`_backward_plain`, the
analytic gradients of `ops.reference.attention_reference_grads`, P read
from the given lse and D from the given o as the kernels read them, so
that residuals of a longer key set, a ring step's, give that function's
gradients; `FlashAttentionFunction`, whose residuals are the block's
own, recomputes both from the block, the same values); a CUDA
tensor launches the Hopper kernels of `csrc/flash_attention_bwd.cu`
(TMA-fed, wgmma, for sm_90a) in bf16 and fp16, or the true-fp32 ones of
`csrc/flash_attention_f32.cu` (FFMA on CUDA cores, never TF32; without
the options), or raises.  Each launch adds one to
``LAUNCH_COUNTS["flash_bwd_dq"]`` or ``["flash_bwd_dkv"]`` (the op) and
to ``["flash_bwd_dq_sm90"]`` or ``["flash_bwd_dkv_sm90"]`` (the kernel
that ran), with the soft cap to ``["<op>_softcap"]`` and at head_dim 256
or 32 to ``["<op>_d256"]`` or ``["<op>_d32"]`` too; a float32 launch
counts ``["<op>_f32"]`` in place of ``["<op>_sm90"]`` and runs its one
tile a head dim (`csrc/flash_tiles.cuh`'s ``MFA_F32_*``), outside
``LAUNCH_TILES``.  Each 16-bit kernel
launches the tile `ops.flash_attention.kernel_config` resolves for it
(the caller's ``block_q`` / ``block_kv`` clamped to that kernel's rules,
a tuned winner under ``backward_query`` / ``backward_key_value``,
"_causal" for causal or windowed calls, or the table's) from the library
variant that holds it, and counts it in ``LAUNCH_TILES["<op>"]``.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.descriptors.attention_descriptor import (
    AttentionKernelType,
)
from metal_flash_attention_tpu_torch.ops.flash_attention import (
    UNQUANTIZED_HEAD_DIMS,
    AuxOperands,
    _forward as _flash_forward,
    aux_operands,
    check_kernel_operands,
    check_options,
    check_shapes,
    count_f32_launch,
    f32_library,
    kernel_config,
    raise_on_launch_error,
    requested_tiles,
)
from metal_flash_attention_tpu_torch.ops.reference import (
    attention_reference_grads,
    softcap_value,
)

# One count per op and per kernel, bumped only where the wrapper launches
# it.
LAUNCH_COUNTS = {f"flash_bwd_{op}{suffix}": 0 for op in ("dq", "dkv")
                 for suffix in ("", "_sm90", "_softcap", "_d256", "_d32",
                               "_aux", "_f32")}
# The tiles each kernel launched with: {(block_q, block_kv): launches}.
LAUNCH_TILES = {"flash_bwd_dq": collections.Counter(),
                "flash_bwd_dkv": collections.Counter()}
_KINDS = {"flash_bwd_dq": AttentionKernelType.BACKWARD_QUERY,
          "flash_bwd_dkv": AttentionKernelType.BACKWARD_KEY_VALUE}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
    for tiles in LAUNCH_TILES.values():
        tiles.clear()


def flash_attention_backward(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, do: torch.Tensor,
                             o: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = False,
                             window_size: Optional[int] = None,
                             mask=None, bias=None, mask2=None,
                             q_segment_ids=None, kv_segment_ids=None,
                             scale: Optional[float] = None,
                             logit_softcap: Optional[float] = None,
                             block_q: Optional[int] = None,
                             block_kv: Optional[int] = None,
                             interpret: Optional[bool] = None,
                             low_precision_intermediates: bool = False,
                             compute_dbias: bool = False):
    """Both backward kernels -> (dq, dk, dv), each in its input's dtype,
    and dbias with ``compute_dbias`` (float32 [batch, q_heads, q_len,
    kv_len], reduced over the bias's size-1 dims, in the bias's dtype).

    do and o are [batch, q_heads, q_len, head_dim]; lse is the forward's
    natural-log logsumexp [batch, q_heads, q_len].  dk and dv are
    [batch, kv_heads, kv_len, head_dim], summed over each kv head's
    group.  Quantized K/V is not differentiated (a TypeError), as in
    the JAX package.  ``block_q`` / ``block_kv``: both kernels' tile,
    each clamped to its rules; ``interpret`` is ignored."""
    del interpret
    if not isinstance(k, torch.Tensor) or not isinstance(v, torch.Tensor):
        raise TypeError("the backward takes k and v as tensors: quantized "
                        "K/V is not differentiated")
    check_shapes(q, k, v)
    options = check_options(q, k, mask=mask, bias=bias, mask2=mask2,
                            q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids,
                            window_size=window_size)
    if do.shape != q.shape or o.shape != q.shape or \
            lse.shape != q.shape[:3]:
        raise ValueError(f"do/o must be shaped like q {tuple(q.shape)} and "
                         f"lse like {tuple(q.shape[:3])}; got "
                         f"{tuple(do.shape)}, {tuple(o.shape)}, "
                         f"{tuple(lse.shape)}")
    if compute_dbias and bias is None:
        raise ValueError("compute_dbias needs a bias")
    dq, dk, dv, dbias = _backward(
        q, k, v, do, o, lse, causal=causal, window_size=window_size,
        scale=scale, softcap=softcap_value(logit_softcap), options=options,
        low_precision=low_precision_intermediates,
        compute_dbias=compute_dbias, tiles=requested_tiles(block_q, block_kv))
    if not compute_dbias:
        return dq, dk, dv
    return dq, dk, dv, reduce_dbias(dbias, bias)


def reduce_dbias(dbias: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The full [batch, q_heads, q_len, kv_len] dbias summed over the
    bias's size-1 batch and head dims (JAX `ops/flash_attention_bwd.py`
    :604-611), in the bias's dtype."""
    dims = tuple(i for i in (0, 1) if bias.shape[i] == 1)
    if dims:
        dbias = dbias.sum(dim=dims, keepdim=True)
    return dbias.to(bias.dtype)


def _backward(q, k, v, do, o, lse, *, causal, window_size, scale,
              softcap=None, options=None, low_precision=False,
              compute_dbias=False, tiles=None, own_residuals=False):
    """The backward on checked operands: both kernels for a CUDA tensor,
    the plain version for a CPU tensor.  ``softcap``: the cap, or None;
    lse must be that of the capped logits; ``tiles``: a (block_q,
    block_kv) request for both kernels, or {"backward_query": ...,
    "backward_key_value": ...}, or None.  ``own_residuals``: o and lse
    are this block's own forward's (`FlashAttentionFunction`).  Returns
    (dq, dk, dv, dbias), dbias the full float32 one with
    ``compute_dbias``, else None."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    with torch.no_grad():
        d_term = (do.float() * o.float()).sum(dim=-1)
        lse = lse.float()
        if low_precision:
            # The JAX backward stores D in bf16 beside L.
            d_term = d_term.to(torch.bfloat16).float()
        if q.is_cuda:
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
            do = do.to(q.dtype).contiguous()
            lse, d_term = lse.contiguous(), d_term.contiguous()
            kw = dict(causal=causal, window_size=window_size, scale=scale,
                      softcap=softcap, options=options, tiles=tiles)
            dbias = None
            if compute_dbias:
                # Tiles the dQ kernel skips (causal, window) stay zero.
                alloc = torch.zeros if causal or window_size is not None \
                    else torch.empty
                dbias = alloc((*q.shape[:3], k.shape[2]),
                              dtype=torch.float32, device=q.device)
            dq = _dq_cuda(q, k, v, do, lse, d_term, dbias=dbias, **kw)
            dk, dv = _dkv_cuda(q, k, v, do, lse, d_term, **kw)
            return dq, dk, dv, dbias
        if q.device.type != "cpu":
            raise ValueError(f"flash attention runs on cpu or cuda "
                             f"tensors, got {q.device}")
        # P from the given L and D from the given O, as the kernels read
        # them (and as the JAX backward does): a ring step's residuals
        # are the whole sequence's, not this block's own.  The block's own
        # residuals (the autograd path) give the same P and D recomputed
        # from the block, as they always have there, to the last bit;
        # bf16-stored ones (``low_precision``) are read as stored.
        stored = {} if own_residuals and not low_precision else dict(
            lse=lse, d_term=d_term)
        *grads, dbias = _backward_plain(
            q, k, v, do, causal=causal, window_size=window_size,
            scale=scale, softcap=softcap, options=options,
            compute_dbias=True, **stored)
        return (*grads, dbias if compute_dbias else None)


class FlashAttentionFunction(torch.autograd.Function):
    """(q, k, v, bias, options, causal, window_size, scale, out_dtype,
    softcap, low_precision, tiles) -> (o, lse); ``bias`` is
    ``options.bias``, passed apart so that autograd sees it (None without
    one); lse is not differentiable (its cotangent is dropped, as in
    JAX).  ``softcap``: the cap (`ops.reference.softcap_value`), or None;
    ``tiles``: the caller's (block_q, block_kv) for all three kernels, or
    None."""

    @staticmethod
    def forward(ctx, q, k, v, bias, options, causal, window_size, scale,
                out_dtype, softcap=None, low_precision=False, tiles=None):
        o, lse = _flash_forward(q, k, v, causal=causal,
                                window_size=window_size, scale=scale,
                                out_dtype=out_dtype, softcap=softcap,
                                options=options,
                                low_precision=low_precision, tiles=tiles)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.options = dict(causal=causal, window_size=window_size,
                           scale=scale, softcap=softcap, options=options,
                           low_precision=low_precision, tiles=tiles)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        bias = ctx.options["options"].bias if ctx.options["options"] \
            else None
        need_dbias = ctx.needs_input_grad[3]
        if need_dbias and (1 < bias.shape[0] < q.shape[0]
                           or 1 < bias.shape[1] < q.shape[1]):
            raise ValueError(
                f"the gradient of a bias {tuple(bias.shape)} that repeats "
                f"over batch {q.shape[0]} or heads {q.shape[1]}: dbias is "
                "reduced over size-1 dims only, as in the JAX package, "
                "whose custom_vjp refuses the shape")
        dq, dk, dv, dbias = _backward(q, k, v, do, o, lse,
                                      compute_dbias=need_dbias,
                                      own_residuals=True, **ctx.options)
        if need_dbias:
            dbias = reduce_dbias(dbias, bias)
        return (dq, dk, dv, dbias, None, None, None, None, None, None, None,
                None)


def _backward_plain(q, k, v, do, *, causal, window_size, scale,
                    softcap=None, options=None, lse=None, d_term=None,
                    compute_dbias=False):
    """The plain PyTorch version: the analytic float32 gradients of
    `attention_reference_grads`, cast to the inputs' dtypes (P and D from
    ``lse`` and ``d_term`` where given, as the kernels read them).  It is
    what a CPU tensor runs and what the kernels are held against on the
    card.  Returns (dq, dk, dv), and the full float32 dbias with
    ``compute_dbias``."""
    dq, dk, dv, _, _, _, dbias = attention_reference_grads(
        q, k, v, do, causal=causal, window_size=window_size, scale=scale,
        logit_softcap=softcap, options=options, lse=lse, d_term=d_term)
    grads = dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    return (*grads, dbias) if compute_dbias else grads


@functools.cache
def _kernel_library(library: tuple = ()) -> ctypes.CDLL:
    """Build (if stale) and bind csrc/flash_attention_bwd.cu, or its tile
    variant ``library`` (-D pairs)."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    return bind_library(load_library("flash_attention_bwd", library))


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of csrc/flash_attention_bwd.cu."""
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32] * 6 + [f32] * 2 + [i32] * 3 + [ptr]
    shape = shape[:-1] + [ctypes.POINTER(AuxOperands), ptr]
    lib.mfa_flash_bwd_dq.argtypes = [ptr] * 7 + shape
    lib.mfa_flash_bwd_dq.restype = i32
    lib.mfa_flash_bwd_dkv.argtypes = [ptr] * 8 + shape
    lib.mfa_flash_bwd_dkv.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(name, outputs, q, k, v, do, lse, d_term, *, causal,
            window_size, scale, softcap=None, options=None, dbias=None,
            tiles=None):
    """Check the operands and launch one backward kernel with its
    resolved tile's library (``dbias``: the dQ kernel's float32 output, or
    None; ``tiles``: as `_backward`'s)."""
    check_kernel_operands(dict(q=q, k=k, v=v, do=do, lse=lse,
                               d_term=d_term), q.dtype, q.device,
                          UNQUANTIZED_HEAD_DIMS)
    if k.dtype != q.dtype or v.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError("q, k, v and do must share a dtype")
    if lse.dtype != torch.float32 or d_term.dtype != torch.float32:
        raise TypeError("lse and the D term must be float32")
    b, qh, n, d = q.shape
    kvh, m = k.shape[1], k.shape[2]
    if dbias is not None and (
            options is None or options.bias is None
            or dbias.dtype != torch.float32 or not dbias.is_contiguous()
            or tuple(dbias.shape) != (b, qh, n, m)):
        raise ValueError(f"dbias must be a contiguous float32 [{b}, {qh}, "
                         f"{n}, {m}] beside a bias")
    aux, keep = aux_operands(options, q, dbias)
    if q.dtype == torch.float32:
        lib = f32_library()
        stream = ctypes.c_void_p(
            torch.cuda.current_stream(q.device).cuda_stream)
        with torch.cuda.device(q.device):
            rc = getattr(lib, f"mfa_{name}_f32")(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                lse.data_ptr(), d_term.data_ptr(),
                *[t.data_ptr() for t in outputs], b, qh, kvh, n, m, d,
                ctypes.c_float(scale), ctypes.c_float(softcap or 0.0),
                int(causal), window_size or 0, stream)
        raise_on_launch_error(lib, rc, f"{name}_f32")
        count_f32_launch(LAUNCH_COUNTS, name, d, softcap)
        return
    cfg = kernel_config(_KINDS[name], q, causal=causal,
                        window_size=window_size, tiles=tiles)
    lib = _kernel_library(cfg.library)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = getattr(lib, f"mfa_{name}")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), d_term.data_ptr(),
            *[t.data_ptr() for t in outputs], b, qh, kvh, n, m, d,
            ctypes.c_float(scale), ctypes.c_float(softcap or 0.0),
            int(causal), window_size or 0, int(q.dtype == torch.float16),
            None if aux is None else ctypes.byref(aux), stream)
    del keep
    raise_on_launch_error(lib, rc, name)
    LAUNCH_COUNTS[name] += 1
    LAUNCH_COUNTS[f"{name}_sm90"] += 1
    LAUNCH_TILES[name][(cfg.block_q, cfg.block_kv)] += 1
    if softcap is not None:
        LAUNCH_COUNTS[f"{name}_softcap"] += 1
    if d in (32, 256):
        LAUNCH_COUNTS[f"{name}_d{d}"] += 1
    if aux is not None:
        LAUNCH_COUNTS[f"{name}_aux"] += 1


def _dq_cuda(q, k, v, do, lse, d_term, *, dbias=None, **kw):
    """dQ; with ``dbias`` (float32 [b, q_heads, q_len, kv_len], zeroed
    where a causal or window loop skips tiles), dS beside it."""
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", (dq,), q, k, v, do, lse, d_term, dbias=dbias,
            **kw)
    return dq


def _dkv_cuda(q, k, v, do, lse, d_term, **kw):
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", (dk, dv), q, k, v, do, lse, d_term, **kw)
    return dk, dv
