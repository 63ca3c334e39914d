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
(`_forward_plain`: materialised float32 scores); a CUDA tensor takes a
hand-written kernel, or raises.  bf16 and fp16 run on the kernel in
`csrc/flash_attention.cu` (TMA-fed, wgmma, for sm_90a; fp16 computed
natively on fp16 tensor cores, where the JAX package computes fp16 in
bf16) at head dims 32, 64, 128 and 256, with or without causal masking,
a window and the soft cap, any q_len and kv_len, and a bf16/fp16 or
float32 O; over quantized K/V (head dims 64 and 128, no cap) it decodes
each tile in shared memory and takes bf16 queries (fp16 or float32 ones
raise NotImplementedError on the card; the plain version takes them).
float32 runs on the true-fp32 kernel of `csrc/flash_attention_f32.cu`
(FFMA on CUDA cores, never TF32: the JAX kernels' Precision.HIGHEST) at
the same head dims, masks, window and cap, with a float32 O, counted as
``LAUNCH_COUNTS["flash_fwd_f32"]`` in place of ``["flash_fwd_sm90"]``;
it has one tile a head dim (`csrc/flash_tiles.cuh`'s ``MFA_F32_*``), so
``block_q`` / ``block_kv`` do not change it and ``LAUNCH_TILES`` does not
count it.
The plain version dequantizes in float32 first, NF4's codebook rounded
to the queries' type as the kernel rounds it.  Each launch adds one to
``LAUNCH_COUNTS["flash_fwd"]`` (the op) and to
``LAUNCH_COUNTS["flash_fwd_sm90"]`` (the kernel that ran), over
quantized K/V to ``LAUNCH_COUNTS["flash_fwd_<precision>"]``, with the
soft cap to ``["flash_fwd_softcap"]`` and at head_dim 256 to
``["flash_fwd_d256"]`` too.

The options of the JAX kernels, on every device: ``mask`` (nonzero
attends; cast to int8 first, as the JAX wrapper does, so 0.5 gates off)
and ``mask2`` (ANDed with it; only beside a mask), an additive ``bias``
(natural units, added after the soft cap), all [B_m, H_m, q_len, kv_len]
with B_m and H_m 1 (broadcast) or any divisor of batch and q_heads
(repeated: batch b reads b % B_m, as the JAX index maps); packed-sequence
``q_segment_ids`` [batch, q_len] / ``kv_segment_ids`` [batch, kv_len] (a
pair attends only within equal ids); and ``low_precision_intermediates``,
which returns lse in bf16 (a cast after the kernel, the value JAX's bf16
store holds; the backward then reads D in bf16 too).  A row whose keys
are all masked or gated gives o = 0 and lse = -inf.  On the card the
options run on the `kAux` kernels (bf16 / fp16, head_dim 64 and 128,
with or without the cap), counted also as ``["flash_fwd_aux"]``; with
head_dim 256, quantized K/V or float32 they raise there (the plain
versions take them).

The tile: a 16-bit CUDA launch takes the one
`descriptors.attention_descriptor` resolves (`resolve_kernel_config`):
the caller's ``block_q`` /
``block_kv``, clamped to the nearest tile the card builds
(`descriptors.parameters.clamp_to_card`), else a tuned winner of the
runtime's config cache, else the H100 table's row (the kernel's default
tile in `csrc/flash_tiles.cuh`), and loads the library variant that
holds it (`native.build`; a tile that fails to build or launch raises,
nothing falls back).  Each launch also counts its tile in
``LAUNCH_TILES["flash_fwd"]``.  A CPU tensor resolves no tile (its plain
version has none); ``interpret`` (the TPU kernel's) is taken and
ignored.
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
    resolve_kernel_config,
)
from metal_flash_attention_tpu_torch.ops.quantization import (
    KV_PRECISIONS,
    PRECISION_CODE,
    QuantizedTensor,
    dequantize,
    logical_shape,
)
from metal_flash_attention_tpu_torch.ops.reference import (
    AttentionOptions,
    attention_reference,
    softcap_value,
)
from metal_flash_attention_tpu_torch.utils.errors import not_ported

# Head dims of every attention kernel; the forward and the backward over
# K/V in q's type also take Gemma-2's 256 and the tiny configs' 32 (the
# D 64 kernels over 32-column rows, csrc/flash_attention.cu), without the
# options.
KERNEL_HEAD_DIMS = (64, 128)
UNQUANTIZED_HEAD_DIMS = (32, 64, 128, 256)
# What the kernels take: bf16 and fp16 on the wgmma kernels, float32 on
# the true-fp32 ones (csrc/flash_attention_f32.cu), without the options
# or quantized K/V.
KERNEL_DTYPES = (torch.bfloat16, torch.float16, torch.float32)

# One count per kernel, bumped only where its wrapper launches it.
LAUNCH_COUNTS = {"flash_fwd": 0, "flash_fwd_sm90": 0,
                 **{f"flash_fwd_{p.value}": 0 for p in KV_PRECISIONS},
                 "flash_fwd_softcap": 0, "flash_fwd_d256": 0,
                 "flash_fwd_d32": 0, "flash_fwd_aux": 0, "flash_fwd_f32": 0}
# The tiles each kernel launched with: {(block_q, block_kv): launches}.
LAUNCH_TILES = {"flash_fwd": collections.Counter()}

KERNEL_ITEM = "flash-kernel coverage"


class AuxOperands(ctypes.Structure):
    """The kernels' options as `csrc/attention_common.cuh` declares them
    (`AuxOperands`), passed by pointer."""

    _fields_ = [("mask", ctypes.c_void_p), ("mask2", ctypes.c_void_p),
                ("bias", ctypes.c_void_p), ("q_seg", ctypes.c_void_p),
                ("kv_seg", ctypes.c_void_p), ("dbias", ctypes.c_void_p),
                *[(name, ctypes.c_int) for name in (
                    "mask_b", "mask_h", "mask2_b", "mask2_h", "bias_b",
                    "bias_h", "bias_f32", "ld")]]


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0
    for tiles in LAUNCH_TILES.values():
        tiles.clear()


def check_options(q, k, *, mask=None, bias=None, mask2=None,
                  q_segment_ids=None, kv_segment_ids=None,
                  window_size=None) -> Optional[AttentionOptions]:
    """The options as every path takes them (None without any), or raise
    on what the JAX wrapper asserts (`ops/flash_attention.py:983-988`,
    `:1166-1170`): mask2 needs mask, segment ids come in pairs, mask and
    bias dims divide batch and q_heads.  Masks become int8, as JAX casts
    them; segment ids int32."""
    if window_size is not None and window_size <= 0:
        raise ValueError(f"window_size must be positive, got {window_size}")
    if mask2 is not None and mask is None:
        raise ValueError("mask2 requires mask")
    if (q_segment_ids is None) != (kv_segment_ids is None):
        raise ValueError("q_segment_ids and kv_segment_ids must come "
                         "together")
    if mask is None and bias is None and q_segment_ids is None:
        return None
    batch, heads, r = q.shape[0], q.shape[1], q.shape[2]
    c = logical_shape(k)[2]
    for name, t in (("mask", mask), ("mask2", mask2), ("bias", bias)):
        if t is None:
            continue
        if t.dim() != 4 or tuple(t.shape[2:]) != (r, c) or \
                batch % t.shape[0] or heads % t.shape[1]:
            raise ValueError(f"{name} must be [B, H, {r}, {c}] with B "
                             f"dividing {batch} and H dividing {heads}; "
                             f"got {tuple(t.shape)}")
    for name, t, n in (("q_segment_ids", q_segment_ids, r),
                       ("kv_segment_ids", kv_segment_ids, c)):
        if t is not None and tuple(t.shape) != (batch, n):
            raise ValueError(f"{name} must be [{batch}, {n}], got "
                             f"{tuple(t.shape)}")
    if bias is not None and not bias.is_floating_point():
        raise TypeError(f"bias must be a float tensor, got {bias.dtype}")

    def as_int8(m):
        if m is None:
            return None
        return m.view(torch.int8) if m.dtype == torch.bool else \
            m.to(torch.int8)

    def as_int32(ids):
        return None if ids is None else ids.to(torch.int32)
    options = AttentionOptions(
        mask=as_int8(mask), mask2=as_int8(mask2), bias=bias,
        q_segment_ids=as_int32(q_segment_ids),
        kv_segment_ids=as_int32(kv_segment_ids))
    for name, t in vars(options).items():
        if t is not None and t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{q.device}")
    return options


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
    contiguous and 16-byte aligned, bf16, fp16 or float32 inputs at one of
    the kernel's ``head_dims``."""
    if dtype not in KERNEL_DTYPES:
        raise TypeError(f"the attention kernels take bf16, fp16 or "
                        f"float32, got {dtype}")
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
                            block_q: Optional[int] = None,
                            block_kv: Optional[int] = None,
                            interpret: Optional[bool] = None,
                            low_precision_intermediates: bool = False,
                            out_dtype: Optional[torch.dtype] = None,
                            emit_lse: bool = True):
    """Fused forward attention -> (o, lse), or (o, None) without
    ``emit_lse``, as in the JAX package.

    o is [batch, q_heads, q_len, head_dim] in ``out_dtype`` (default
    q's dtype); lse is the natural-log row logsumexp [batch, q_heads,
    q_len], float32 (bf16 with ``low_precision_intermediates``).
    ``block_q`` / ``block_kv``: the kernel's tile (module docstring).  No
    autograd graph: see `flash_attention`.
    """
    del interpret
    check_shapes(q, k, v)
    options = check_options(q, k, mask=mask, bias=bias, mask2=mask2,
                            q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids,
                            window_size=window_size)
    o, lse = _forward(q, k, v, causal=causal, window_size=window_size,
                      scale=scale, out_dtype=out_dtype,
                      softcap=softcap_value(logit_softcap), options=options,
                      low_precision=low_precision_intermediates,
                      tiles=requested_tiles(block_q, block_kv))
    return o, (lse if emit_lse else None)


def requested_tiles(block_q, block_kv):
    """A caller's tile request, (block_q, block_kv), or None without
    one."""
    if block_q is None and block_kv is None:
        return None
    return (block_q, block_kv)


def _forward(q, k, v, *, causal, window_size, scale, out_dtype,
             softcap=None, options=None, low_precision=False, tiles=None):
    """The forward on checked operands: the kernel for a CUDA tensor,
    the plain version for a CPU tensor.  ``softcap``: the cap, or None;
    ``options``: `check_options`'s; ``low_precision``: lse in bf16;
    ``tiles``: the caller's (block_q, block_kv), or None."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    out_dtype = out_dtype or q.dtype
    quantized = isinstance(k, QuantizedTensor)
    kw = dict(causal=causal, window_size=window_size, scale=scale,
              out_dtype=out_dtype, softcap=softcap, options=options)
    with torch.no_grad():
        if q.is_cuda:
            if not quantized:
                k, v = k.contiguous(), v.contiguous()
            o, lse = _forward_cuda(q.contiguous(), k, v, tiles=tiles, **kw)
        elif q.device.type != "cpu":
            raise ValueError(f"flash attention runs on cpu or cuda "
                             f"tensors, got {q.device}")
        else:
            plain = _forward_plain_quantized if quantized else _forward_plain
            o, lse = plain(q, k, v, **kw)
    # The JAX kernel's bf16 store of L (lowPrecisionIntermediates): the
    # same rounding of the same float32 value.
    return o, (lse.to(torch.bfloat16) if low_precision else lse)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask=None, bias=None, mask2=None, q_segment_ids=None,
                    kv_segment_ids=None, *, causal: bool = False,
                    window_size: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None,
                    interpret: Optional[bool] = None,
                    return_residuals: bool = False,
                    low_precision_intermediates: bool = False,
                    out_dtype: Optional[torch.dtype] = None):
    """Differentiable fused attention: o, or (o, lse) with
    ``return_residuals``.  Gradients reach q, k and v through the
    atomic-free backward (`ops.flash_attention_bwd`); lse carries
    none, as in the JAX package.  Over quantized K/V it is the forward,
    with no graph.  ``block_q`` / ``block_kv`` set the tile of all three
    kernels, each clamped to its own rules.  See
    `flash_attention_forward` for the arguments."""
    from metal_flash_attention_tpu_torch.ops.flash_attention_bwd import (
        FlashAttentionFunction,
    )

    check_shapes(q, k, v)
    options = check_options(q, k, mask=mask, bias=bias, mask2=mask2,
                            q_segment_ids=q_segment_ids,
                            kv_segment_ids=kv_segment_ids,
                            window_size=window_size)
    del interpret
    softcap = softcap_value(logit_softcap)
    tiles = requested_tiles(block_q, block_kv)
    if isinstance(k, QuantizedTensor):
        o, lse = _forward(q, k, v, causal=causal, window_size=window_size,
                          scale=scale, out_dtype=out_dtype, softcap=softcap,
                          options=options,
                          low_precision=low_precision_intermediates,
                          tiles=tiles)
        return (o, lse) if return_residuals else o
    o, lse = FlashAttentionFunction.apply(
        q.contiguous(), k.contiguous(), v.contiguous(), bias, options,
        causal, window_size, scale, out_dtype, softcap,
        low_precision_intermediates, tiles)
    return (o, lse) if return_residuals else o


def _forward_plain(q, k, v, *, causal, window_size, scale, out_dtype,
                   softcap=None, options=None):
    """The plain PyTorch version: materialised float32 scores and
    softmax (`ops.reference`), with the options.  It is what a CPU tensor
    runs and what the kernel is held against on the card."""
    o, lse = attention_reference(q, k, v, causal=causal,
                                 window_size=window_size, scale=scale,
                                 logit_softcap=softcap,
                                 return_residuals=True, options=options)
    return o.to(out_dtype), lse


def _forward_plain_quantized(q, k, v, *, causal, window_size, scale,
                             out_dtype, softcap=None, options=None):
    """The plain version over quantized K/V: each dequantized in float32
    (NF4's codebook rounded to q's type, as the kernel rounds it), then
    `_forward_plain`.  What a CPU tensor runs, and what the kernel is
    held against on the card."""
    return _forward_plain(q, dequantize(k, q.dtype), dequantize(v, q.dtype),
                          causal=causal, window_size=window_size,
                          scale=scale, out_dtype=out_dtype, softcap=softcap,
                          options=options)


@functools.cache
def _kernel_library(library: tuple = ()) -> ctypes.CDLL:
    """Build (if stale) and bind csrc/flash_attention.cu, or its tile
    variant ``library`` (-D pairs)."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    return bind_library(load_library("flash_attention", library))


def kernel_config(kind, q, *, causal, window_size, tiles):
    """The resolved `KernelConfig` of one launch of ``kind``
    (`AttentionKernelType`) on q's card: the caller's ``tiles`` (a
    (block_q, block_kv) request, or a {kernel type: request} dict), a
    tuned winner or the table's."""
    if isinstance(tiles, dict):
        tiles = tiles.get(kind.value)
    block_q, block_kv = tiles or (None, None)
    return resolve_kernel_config(
        kind, q.shape[-1], q.dtype, q_len=q.shape[2],
        causal=causal or window_size is not None, block_q=block_q,
        block_kv=block_kv, device=q.device)


def bind_library(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a build of csrc/flash_attention.cu."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfa_flash_fwd.argtypes = ([ptr] * 7 + [i32] * 6
                                  + [ctypes.c_float] * 2 + [i32] * 5
                                  + [ctypes.POINTER(AuxOperands), ptr])
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


def aux_operands(options, q, dbias=None):
    """`options` (`check_options`'s, on q's card) as the kernels take
    them, or None without options: a 16-bit bias in q's type or float32
    (any other float type widened), every operand contiguous and 16-byte
    aligned, the planes of mask, mask2 and bias padded to rows of a
    multiple of 16 keys (whole 16-byte copies for dK/dV's stage; a
    thread of the forward and dQ loads its two side-by-side keys at once);
    ``dbias``: the dQ kernel's float32 output.  Returns (struct, the
    tensors it points into, to be kept alive over the launch)."""
    if options is None or all(t is None for t in vars(options).values()):
        return None, ()
    if q.dtype == torch.float32:
        raise not_ported("the flash-attention options with float32 on "
                         "CUDA", KERNEL_ITEM)
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise not_ported(f"the flash-attention options at head_dim "
                         f"{q.shape[-1]} on CUDA (they take "
                         f"{KERNEL_HEAD_DIMS})", KERNEL_ITEM)
    bias = options.bias
    if bias is not None and bias.dtype not in (q.dtype, torch.float32):
        bias = bias.float()
    planes = dict(mask=options.mask, mask2=options.mask2, bias=bias)
    kv_len = next(t.shape[-1] for t in (*planes.values(),
                                         options.kv_segment_ids)
                  if t is not None)
    ld = -(-kv_len // 16) * 16

    def laid_out(t, pad=False):
        if t is None:
            return None
        if pad and t.shape[-1] != ld:
            t = torch.nn.functional.pad(t, (0, ld - t.shape[-1]))
        t = t.contiguous()
        return t if t.data_ptr() % 16 == 0 else t.clone()
    tensors = {n: laid_out(t, pad=True) for n, t in planes.items()}
    tensors["q_seg"] = laid_out(options.q_segment_ids)
    tensors["kv_seg"] = laid_out(options.kv_segment_ids)
    if dbias is not None:
        tensors["dbias"] = dbias
    aux = AuxOperands(**{n: None if t is None else t.data_ptr()
                         for n, t in tensors.items()})
    for name in ("mask", "mask2", "bias"):
        t = tensors[name]
        if t is not None:
            setattr(aux, f"{name}_b", t.shape[0])
            setattr(aux, f"{name}_h", t.shape[1])
    aux.bias_f32 = int(bias is not None and bias.dtype == torch.float32)
    aux.ld = ld
    return aux, tuple(t for t in tensors.values() if t is not None)


def _forward_cuda(q, k, v, *, causal, window_size, scale, out_dtype,
                  softcap=None, options=None, tiles=None):
    """Launch the Hopper kernel with the resolved tile's library; raise
    on anything it does not take."""
    precision, scales = None, (None, None)
    head_dims = UNQUANTIZED_HEAD_DIMS
    if isinstance(k, QuantizedTensor):
        if options is not None:
            raise not_ported("the flash-attention options over quantized "
                             "K/V in the forward kernel", KERNEL_ITEM)
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
    aux, keep = aux_operands(options, q)
    if q.dtype == torch.float32:
        return _forward_cuda_f32(q, k, v, causal=causal,
                                 window_size=window_size, scale=scale,
                                 softcap=softcap)
    b, qh, n, d = q.shape
    kvh, m = k.shape[1], k.shape[2]
    cfg = kernel_config(AttentionKernelType.FORWARD, q, causal=causal,
                        window_size=window_size, tiles=tiles)
    lib = _kernel_library(cfg.library)
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
            0 if precision is None else PRECISION_CODE[precision],
            None if aux is None else ctypes.byref(aux), stream)
    del keep
    raise_on_launch_error(lib, rc, "flash_fwd")
    LAUNCH_COUNTS["flash_fwd"] += 1
    LAUNCH_COUNTS["flash_fwd_sm90"] += 1
    LAUNCH_TILES["flash_fwd"][(cfg.block_q, cfg.block_kv)] += 1
    if precision is not None:
        LAUNCH_COUNTS[f"flash_fwd_{precision.value}"] += 1
    if softcap is not None:
        LAUNCH_COUNTS["flash_fwd_softcap"] += 1
    if d in (32, 256):
        LAUNCH_COUNTS[f"flash_fwd_d{d}"] += 1
    if aux is not None:
        LAUNCH_COUNTS["flash_fwd_aux"] += 1
    return o, lse


@functools.cache
def f32_library() -> ctypes.CDLL:
    """Build (if stale) and bind csrc/flash_attention_f32.cu: the
    true-fp32 forward, dQ and dK/dV."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    lib = load_library("flash_attention_f32")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    shape = [i32] * 6 + [f32] * 2 + [i32] * 2 + [ptr]
    lib.mfa_flash_fwd_f32.argtypes = [ptr] * 5 + shape
    lib.mfa_flash_bwd_dq_f32.argtypes = [ptr] * 7 + shape
    lib.mfa_flash_bwd_dkv_f32.argtypes = [ptr] * 8 + shape
    for fn in (lib.mfa_flash_fwd_f32, lib.mfa_flash_bwd_dq_f32,
               lib.mfa_flash_bwd_dkv_f32):
        fn.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def count_f32_launch(counts: dict, name: str, d: int, softcap) -> None:
    """One launch of the true-fp32 kernel ``name`` counted: the op,
    ``<name>_f32``, the cap and the head dim."""
    counts[name] += 1
    counts[f"{name}_f32"] += 1
    if softcap is not None:
        counts[f"{name}_softcap"] += 1
    if d in (32, 256):
        counts[f"{name}_d{d}"] += 1


def _forward_cuda_f32(q, k, v, *, causal, window_size, scale, softcap):
    """Launch the true-fp32 forward (operands checked by `_forward_cuda`):
    a float32 O and lse."""
    b, qh, n, d = q.shape
    kvh, m = k.shape[1], k.shape[2]
    lib = f32_library()
    o = torch.empty((b, qh, n, d), dtype=torch.float32, device=q.device)
    lse = torch.empty((b, qh, n), dtype=torch.float32, device=q.device)
    stream = ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream)
    with torch.cuda.device(q.device):
        rc = lib.mfa_flash_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, qh, kvh, n, m, d, ctypes.c_float(scale),
            ctypes.c_float(softcap or 0.0), int(causal), window_size or 0,
            stream)
    raise_on_launch_error(lib, rc, "flash_fwd_f32")
    count_f32_launch(LAUNCH_COUNTS, "flash_fwd", d, softcap)
    return o, lse
