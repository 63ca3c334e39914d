"""GEMM with per-operand precisions and quantized operands (PyTorch, CUDA
on Hopper).

The port of the JAX package's `ops/gemm.py`: C = op(A) op(B) [+ C_prev]
with per-operand transposes, misaligned sizes, mixed storage precisions
and `QuantizedMatrix` operands (INT8 / FP8-E4M3 / FP8-E5M2 / NF4 with a
per-tensor or per-channel scale).

Routing, as in the JAX package:

- ``backend="auto"`` with no explicit blocks and no quantized operand,
  or ``backend="xla"``, is a plain product: `torch.matmul` (cuBLAS on the
  card; the JAX package leaves it to XLA's dot).  fp32 registers are
  true fp32: the port does not touch `torch.backends`' TF32 flags.
- ``backend="pallas"``, any of ``block_m/n/k``, or a quantized operand
  runs the hand-written kernel `csrc/gemm.cu` on a CUDA tensor and its
  plain PyTorch version (`_plain_product`) on a CPU tensor; nothing falls
  back from one to the other.  Each kernel launch adds one to
  ``LAUNCH_COUNTS["gemm"]``, and a launch of the sm90 route also to
  ``LAUNCH_COUNTS["gemm_sm90"]``.

The kernel's two routes (`_route`, decided from types and layouts before
the launch; a dispatch, not a fallback: a CUDA call sent to a route
launches that route's kernel or raises):

  registers  A                    B                        route
  bf16       bf16, K contiguous   bf16 or quantized,       sm90 (TMA ring,
                                  [K, N] N contiguous      wgmma)
  bf16       quantized            any                      mma
  bf16       any                  [N, K] K contiguous      mma
  fp32       any                  any                      mma (CUDA-core
                                                           FMA)

and any base address or non-unit stride of A or B that is not a 16-byte
multiple (TMA cannot describe it) goes to mma.

The register truth table (the JAX package's, on the card as on the TPU):

  memory pair                default registers
  fp32 x fp32                fp32 (CUDA-core FMA, true fp32)
  fp32 x {bf16, quantized}   fp32
  bf16 x bf16                bf16 (tensor cores, fp32 accumulator)
  bf16 x quantized           bf16
  quantized x quantized      bf16

``register_precision`` ("bf16" | "fp32") overrides it.  A dense fp16
operand is recast to bf16 first and an fp16 result comes from a final
cast, as in the JAX package.  Quantized payloads are dequantized inside
the kernel (no scale), rounded to the register type, and the scales and
C apply to the float32 result in this order: ``* scale_a[:, None]``,
``* scale_b[None, :]``, ``+ C``, cast.  For dense operands C seeds the
accumulator.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Union

import torch

from metal_flash_attention_tpu_torch.descriptors.gemm_descriptor import (
    GEMMDescriptor,
)
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.ops.paged_attention import _sm_count
from metal_flash_attention_tpu_torch.ops.quantization import (
    NF4_GEMM_GROUP,
    PRECISION_CODE,
    QuantizedMatrix,
    nf4_unpack_groups,
)
from metal_flash_attention_tpu_torch.utils.shapes import cdiv, round_up

# One count per kernel, bumped only where its wrapper launches it.
LAUNCH_COUNTS = {"gemm": 0, "gemm_sm90": 0}

_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_C_NONE, _C_SEED, _C_AFTER_SCALE = 0, 1, 2
# A split of K keeps at least this many K steps.
MIN_STEPS_PER_SPLIT = 8


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


Operand = Union[torch.Tensor, QuantizedMatrix]


def _operand_info(x):
    """(payload, quant precision | None, scale | None, logical shape)."""
    if isinstance(x, QuantizedMatrix):
        return x.values, x.precision, x.scale, tuple(x.shape)
    return x, None, None, tuple(x.shape[-2:])


def _resolve_register_dtype(a_dtype, b_dtype, quant_a, quant_b,
                            register_precision) -> torch.dtype:
    """The register-precision truth table (module docstring)."""
    if register_precision is not None:
        if register_precision not in ("bf16", "fp32"):
            raise ValueError(
                f"register_precision must be 'bf16' or 'fp32', got "
                f"{register_precision!r} (registers are bf16 or fp32; "
                f"quantized dtypes are memory-only)")
        return torch.bfloat16 if register_precision == "bf16" \
            else torch.float32
    has_fp32 = ((quant_a is None and a_dtype == torch.float32)
                or (quant_b is None and b_dtype == torch.float32))
    return torch.float32 if has_fp32 else torch.bfloat16


def gemm(a: Operand, b: Operand, c: Optional[torch.Tensor] = None, *,
         transpose_a: bool = False, transpose_b: bool = False,
         out_dtype: Optional[torch.dtype] = None,
         block_m: Optional[int] = None, block_n: Optional[int] = None,
         block_k: Optional[int] = None, interpret: Optional[bool] = None,
         backend: str = "auto", register_precision: Optional[str] = None):
    """C = op(A) op(B) [+ C_prev].

    op(A) is [M, K] (A is [K, M] when ``transpose_a``); op(B) is [K, N]
    (B is [N, K] when ``transpose_b``).  ``c`` [M, N] is the reference's
    `loadPreviousC` accumulation.  Either operand may be a
    `QuantizedMatrix` (module docstring).

    ``backend``: "auto" takes `torch.matmul` for dense operands without
    explicit blocks; explicit blocks, quantized operands or "pallas"
    select the hand kernel; "xla" forces `torch.matmul` for dense
    operands.  ``block_m/n/k`` and ``interpret`` are the TPU kernel's:
    accepted, and a block selects the kernel, but on the card the tile
    is the CUDA kernel's own (`GEMMDescriptor.kernel_config`).
    """
    return _gemm(a, b, c, batched=False, transpose_a=transpose_a,
                 transpose_b=transpose_b, out_dtype=out_dtype,
                 block_m=block_m, block_n=block_n, block_k=block_k,
                 interpret=interpret, backend=backend,
                 register_precision=register_precision)


def batched_gemm(a: Operand, b: Operand, **kwargs):
    """GEMM over a leading batch dimension of both operands (a
    `QuantizedMatrix` carries it on its payload and scale), in one kernel
    launch; ``kwargs`` as `gemm`, where ``c`` may be [M, N] (shared) or
    [batch, M, N]."""
    c = kwargs.pop("c", None)
    return _gemm(a, b, c, batched=True, **kwargs)


def gemm_chain(x, weights, **kwargs):
    """Dependent GEMM chain x @ w1 @ w2 @ ...; ``kwargs`` forward to
    `gemm` (quantized weights welcome)."""
    for w in weights:
        x = gemm(x, w, **kwargs)
    return x


def _gemm_plain(a: Operand, b: Operand, c: Optional[torch.Tensor] = None,
                *, batched: bool = False, **kwargs):
    """`gemm`'s kernel route through the plain version on any device: the
    reference the kernel is held against on the card."""
    return _gemm(a, b, c, batched=batched, plain=True,
                 **dict(kwargs, backend="pallas"))


def _gemm(a, b, c, *, batched, transpose_a=False, transpose_b=False,
          out_dtype=None, block_m=None, block_n=None, block_k=None,
          interpret=None, backend="auto", register_precision=None,
          plain=False):
    del interpret
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"backend must be 'auto', 'xla' or 'pallas', got "
                         f"{backend!r}")
    a_pay, quant_a, scale_a, a_shape = _operand_info(a)
    b_pay, quant_b, scale_b, b_shape = _operand_info(b)
    any_quant = quant_a is not None or quant_b is not None
    rank = 3 if batched else 2
    for name, t in (("a", a_pay), ("b", b_pay)):
        if t.dim() != rank:
            raise ValueError(f"{name} must be {rank}-D, got "
                             f"{tuple(t.shape)}")

    a_f16 = quant_a is None and a_pay.dtype == torch.float16
    b_f16 = quant_b is None and b_pay.dtype == torch.float16
    if a_f16 or b_f16:
        # fp16 operands run as bf16 (the JAX package's recast, Mosaic
        # having no fp16 matrix path); an fp16 result is a final cast.
        out16 = out_dtype
        if out16 is None and not any_quant:
            out16 = torch.promote_types(a_pay.dtype, b_pay.dtype)
        a = a_pay.to(torch.bfloat16) if a_f16 else a
        b = b_pay.to(torch.bfloat16) if b_f16 else b
        out = _gemm(a, b, None if c is None else c.to(torch.bfloat16),
                    batched=batched, transpose_a=transpose_a,
                    transpose_b=transpose_b,
                    out_dtype=None if out16 is None else torch.bfloat16,
                    block_m=block_m, block_n=block_n, block_k=block_k,
                    interpret=None, backend=backend,
                    register_precision=register_precision, plain=plain)
        return out if out16 is None else out.to(out16)

    m, k = (a_shape[1], a_shape[0]) if transpose_a else a_shape
    kb, n = (b_shape[1], b_shape[0]) if transpose_b else b_shape
    if k != kb:
        raise ValueError(f"contraction mismatch: op(A) is [{m}, {k}], "
                         f"op(B) is [{kb}, {n}]")
    register_dtype = _resolve_register_dtype(
        a_pay.dtype, b_pay.dtype, quant_a, quant_b, register_precision)
    explicit_blocks = (block_m is not None or block_n is not None
                       or block_k is not None)
    if not any_quant and (backend == "xla" or (backend == "auto"
                                               and not explicit_blocks)):
        if out_dtype is None:
            out_dtype = torch.promote_types(a_pay.dtype, b_pay.dtype)
        return _matmul(a_pay, b_pay, c, transpose_a, transpose_b,
                       register_dtype, out_dtype)

    if out_dtype is None:
        if any_quant:
            out_dtype = register_dtype
        else:
            out_dtype = torch.promote_types(a_pay.dtype, b_pay.dtype)
    ops = _Operands(a_pay, quant_a, scale_a, b_pay, quant_b, scale_b,
                    m, n, k, transpose_a, transpose_b, batched)
    if c is not None and tuple(c.shape[-2:]) != (m, n):
        raise ValueError(f"c must be [{m}, {n}], got {tuple(c.shape)}")
    devices = {t.device for t in ops.tensors() + ([] if c is None else [c])}
    if len(devices) != 1:
        raise ValueError(f"gemm operands lie on several devices: {devices}")
    device = devices.pop()
    if plain or device.type == "cpu":
        out = _plain_product(ops, c, register_dtype, out_dtype)
    elif device.type == "cuda":
        out = _gemm_cuda(ops, c, register_dtype, out_dtype, any_quant)
    else:
        raise ValueError(f"gemm runs on cpu or cuda tensors, got {device}")
    return out if batched else out[0]


def _matmul(a, b, c, transpose_a, transpose_b, register_dtype, out_dtype):
    """The dense product outside any kernel of the port (`torch.matmul`),
    with the JAX package's float32 result before C and the cast."""
    a = a.transpose(-1, -2) if transpose_a else a
    b = b.transpose(-1, -2) if transpose_b else b
    a, b = a.to(register_dtype), b.to(register_dtype)
    if register_dtype == torch.bfloat16 and out_dtype == torch.bfloat16 \
            and c is None:
        return torch.matmul(a, b)   # one rounding of the fp32 sum
    out = torch.matmul(a.float(), b.float())
    if c is not None:
        out = out + c.float()
    return out.to(out_dtype)


class _Operands:
    """Both operands of one call with a leading batch axis: payloads
    [batch, rows, cols] as stored, scales [batch] (per tensor) or
    [batch, channels], and the logical problem [batch, M, N, K]."""

    def __init__(self, a, quant_a, scale_a, b, quant_b, scale_b, m, n, k,
                 transpose_a, transpose_b, batched):
        lead = (lambda t: t) if batched else (lambda t: t.unsqueeze(0))
        self.a, self.b = lead(a), lead(b)
        self.quant_a, self.quant_b = quant_a, quant_b
        self.scale_a = None if scale_a is None else lead(scale_a)
        self.scale_b = None if scale_b is None else lead(scale_b)
        self.m, self.n, self.k = m, n, k
        self.transpose_a, self.transpose_b = transpose_a, transpose_b
        if self.a.shape[0] != self.b.shape[0]:
            raise ValueError(f"batch mismatch: {self.a.shape[0]} and "
                             f"{self.b.shape[0]}")
        self.batch = self.a.shape[0]
        for name, quant, pay, contract in (
                ("a", quant_a, self.a, 1 if transpose_a else 2),
                ("b", quant_b, self.b, 2 if transpose_b else 1)):
            if quant is None:
                continue
            if pay.dtype != quant.storage_dtype:
                raise TypeError(f"{name}'s {quant.value} payload must be "
                                f"{quant.storage_dtype}, got {pay.dtype}")
            want = (round_up(k, NF4_GEMM_GROUP) // 2
                    if quant is OperandPrecision.NF4 else k)
            if pay.shape[contract] != want:
                raise ValueError(f"{name}'s payload has K extent "
                                 f"{pay.shape[contract]}, expected {want}")

    def tensors(self) -> list:
        return [t for t in (self.a, self.b, self.scale_a, self.scale_b)
                if t is not None]

    def register_values(self, register_dtype):
        """op(A) [batch, M, K] and op(B) [batch, K, N] as float32: each
        payload dequantized without its scale, then rounded to the
        register type."""
        def values(pay, quant, contract, logical_k):
            if quant is OperandPrecision.NF4:
                vals = nf4_unpack_groups(pay, contract)
                vals = vals.narrow(contract, 0, logical_k)
            else:
                vals = pay.float()
            return vals.to(register_dtype).float()
        a = values(self.a, self.quant_a, 1 if self.transpose_a else 2, self.k)
        b = values(self.b, self.quant_b, 2 if self.transpose_b else 1, self.k)
        return (a.transpose(1, 2) if self.transpose_a else a,
                b.transpose(1, 2) if self.transpose_b else b)


def _plain_product(ops: _Operands, c, register_dtype, out_dtype):
    """The plain PyTorch version: dequantize without the scale, round to
    the register type, multiply in float32, then the scales, C and the
    cast.  It is what a CPU tensor runs and, through `_gemm_plain`, what
    the kernel is held against on the card."""
    a, b = ops.register_values(register_dtype)
    out = torch.matmul(a, b)
    if ops.scale_a is not None:
        s = ops.scale_a.float()
        out = out * (s[:, None, None] if s.dim() == 1 else s[:, :, None])
    if ops.scale_b is not None:
        s = ops.scale_b.float()
        out = out * (s[:, None, None] if s.dim() == 1 else s[:, None, :])
    if c is not None:
        out = out + c.float()
    return out.to(out_dtype)


def k_splits(m: int, n: int, k: int, batch: int, sm_count: int,
             tile_m: int, tile_n: int, tile_k: int) -> tuple[int, int]:
    """(splits, K elements a split) for the kernel: the output tiles once
    they fill the card, else K split until about two blocks an SM, each
    split at least MIN_STEPS_PER_SPLIT K steps and none empty."""
    steps = max(cdiv(k, tile_k), 1)
    tiles = cdiv(m, tile_m) * cdiv(n, tile_n) * batch
    want = cdiv(2 * sm_count, tiles) if tiles < sm_count else 1
    splits = max(1, min(want, steps // MIN_STEPS_PER_SPLIT,
                        65535 // max(batch, 1)))
    per = cdiv(steps, splits)
    return cdiv(steps, per), per * tile_k


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """Build (if stale) and bind csrc/gemm.cu."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    lib = load_library("gemm")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.mfa_gemm.argtypes = [ptr] * 8 + [i32] * 13 + [ptr]
    lib.mfa_gemm.restype = i32
    lib.mfa_gemm_sm90.argtypes = [ptr] * 8 + [i32] * 12 + [ptr]
    lib.mfa_gemm_sm90.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _chunks_ok(pay: torch.Tensor, s_batch: int, s_row: int,
               sk: int) -> bool:
    """Whether the kernel may read a payload in 16-byte chunks along its
    contiguous axis (k when sk == 1, else the rows): that axis has stride
    1, and the start and the other strides are 16-byte multiples."""
    other = s_row if sk == 1 else sk
    size = pay.element_size()
    return ((sk == 1 or s_row == 1) and pay.data_ptr() % 16 == 0
            and other * size % 16 == 0
            and (pay.shape[0] == 1 or s_batch * size % 16 == 0))


def _strides(ops: _Operands) -> tuple:
    """(a_sb, a_sm, a_sk, b_sb, b_sk, b_sn): each payload's batch, row
    and contraction strides in its elements, for op(A) [M, K] and op(B)
    [K, N] whatever the transposes."""
    a_sb, a_r, a_c = ops.a.stride()
    b_sb, b_r, b_c = ops.b.stride()
    a_sm, a_sk = (a_c, a_r) if ops.transpose_a else (a_r, a_c)
    b_sk, b_sn = (b_c, b_r) if ops.transpose_b else (b_r, b_c)
    return a_sb, a_sm, a_sk, b_sb, b_sk, b_sn


def _route(ops: _Operands, register_dtype) -> str:
    """"sm90" or "mma": which kernel of `csrc/gemm.cu` a call takes (the
    module docstring's table).  Pure: reads types, shapes, strides and
    addresses, builds nothing."""
    if (register_dtype != torch.bfloat16 or ops.quant_a is not None
            or ops.a.dtype != torch.bfloat16
            or (ops.quant_b is None and ops.b.dtype != torch.bfloat16)):
        return "mma"
    a_sb, a_sm, a_sk, b_sb, b_sk, b_sn = _strides(ops)
    eb = ops.b.element_size()
    n_extent = ops.b.shape[1 if ops.transpose_b else 2]
    k_extent = ops.a.shape[1 if ops.transpose_a else 2]
    tma = (a_sk == 1 and b_sn == 1
           and ops.a.data_ptr() % 16 == 0 and ops.b.data_ptr() % 16 == 0
           and a_sm >= k_extent and a_sm * 2 % 16 == 0
           and b_sk >= n_extent and b_sk * eb % 16 == 0
           and (ops.batch == 1 or (a_sb > 0 and a_sb * 2 % 16 == 0
                                   and b_sb > 0 and b_sb * eb % 16 == 0)))
    return "sm90" if tma else "mma"


def _gemm_cuda(ops: _Operands, c, register_dtype, out_dtype, any_quant):
    """Launch the route's Hopper kernel; raise on anything it does not
    take.  The payloads are read in place through their strides; scales
    and C are made float32 and contiguous (C: [batch or 1, M, N])."""
    if out_dtype not in _OUT_CODE:
        raise TypeError(f"the gemm kernel writes fp32, bf16 or fp16, got "
                        f"{out_dtype}")
    for name, pay, quant in (("a", ops.a, ops.quant_a),
                             ("b", ops.b, ops.quant_b)):
        if quant is None and pay.dtype not in (torch.float32,
                                               torch.bfloat16):
            raise TypeError(f"the gemm kernel reads fp32, bf16 or "
                            f"quantized operands; {name} is {pay.dtype}")
    device = ops.a.device
    prec_a = ops.quant_a or OperandPrecision.from_dtype(ops.a.dtype)
    prec_b = ops.quant_b or OperandPrecision.from_dtype(ops.b.dtype)
    route = _route(ops, register_dtype)
    cfg = GEMMDescriptor(
        m=ops.m, n=ops.n, k=ops.k, precision_a=prec_a, precision_b=prec_b,
        transpose_a=ops.transpose_a, transpose_b=ops.transpose_b,
        batch=ops.batch, load_previous_c=c is not None).kernel_config(route)
    out = torch.empty((ops.batch, ops.m, ops.n), dtype=out_dtype,
                      device=device)
    if out.numel() == 0:
        return out
    splits, per = k_splits(ops.m, ops.n, ops.k, ops.batch,
                           _sm_count(device.index or 0), cfg.block_m,
                           cfg.block_n, cfg.block_k)
    partial = (torch.empty((splits, ops.batch, ops.m, ops.n),
                           dtype=torch.float32, device=device)
               if splits > 1 else None)

    def scale(s):
        return None if s is None else s.to(torch.float32).contiguous()
    sa, sb = scale(ops.scale_a), scale(ops.scale_b)
    c_mode = _C_NONE
    if c is not None:
        c = c.to(torch.float32)
        c = (c if c.dim() == 3 else c.unsqueeze(0)).contiguous()
        if c.shape[0] not in (1, ops.batch):
            raise ValueError(f"c's batch {c.shape[0]} is not {ops.batch}")
        c_mode = _C_AFTER_SCALE if any_quant else _C_SEED
    a_sb, a_sm, a_sk, b_sb, b_sk, b_sn = _strides(ops)

    def scale_strides(s):
        if s is None:
            return 0, 0
        return (s.stride(0), 0) if s.dim() == 1 else tuple(s.stride())
    strides = (ctypes.c_longlong * 11)(
        a_sb, a_sm, a_sk, b_sb, b_sk, b_sn,
        0 if c is None or c.shape[0] == 1 else ops.m * ops.n,
        *scale_strides(sa), *scale_strides(sb))
    lib = _kernel_library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)

    def ptr(t):
        return None if t is None else t.data_ptr()
    args = (ptr(ops.a), ptr(ops.b), ptr(c), ptr(sa), ptr(sb), ptr(out),
            ptr(partial), strides, ops.m, ops.n, ops.k, ops.batch, splits,
            per)
    with torch.cuda.device(device):
        if route == "sm90":
            b_rows = ops.b.shape[2 if ops.transpose_b else 1]
            rc = lib.mfa_gemm_sm90(*args, PRECISION_CODE[prec_b], b_rows,
                                   cfg.block_m, cfg.block_n,
                                   _OUT_CODE[out_dtype], c_mode, stream)
        else:
            rc = lib.mfa_gemm(
                *args, PRECISION_CODE[prec_a], PRECISION_CODE[prec_b],
                _OUT_CODE[out_dtype], c_mode,
                int(register_dtype == torch.float32),
                int(_chunks_ok(ops.a, a_sb, a_sm, a_sk)),
                int(_chunks_ok(ops.b, b_sb, b_sn, b_sk)), stream)
    if rc != 0:
        raise RuntimeError(f"gemm kernel ({route}) launch failed: CUDA "
                           f"error {rc} "
                           f"({lib.mfa_cuda_error_string(rc).decode()})")
    LAUNCH_COUNTS["gemm"] += 1
    if route == "sm90":
        LAUNCH_COUNTS["gemm_sm90"] += 1
    return out

