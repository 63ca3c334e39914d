"""Quantized operands: FP8-E4M3 / FP8-E5M2 / INT8 / NF4 (host side).

The port of the JAX package's `ops/quantization.py`, in plain PyTorch:
the payload layouts, scales and host (de)quantizers.  The payloads are
bit for bit the JAX package's: IEEE FP8 (`torch.float8_e4m3fn`,
`torch.float8_e5m2`), symmetric INT8, and the 16-value NF4 codebook
nibble-packed two per byte.

- KV half (`QuantizedTensor`, `quantize`, `dequantize`, `nf4_unpack`):
  [batch, heads, seq, head_dim] with one scale per (batch, head); NF4
  packs head_dim split-half (byte j holds elements j and j + D/2).
  `ops.flash_decode` decodes these payloads inside its CUDA kernel; the
  paged pools' per-page quantizer is `ops.paged_attention.quantize_paged`.
- GEMM half (`QuantizedMatrix`, `quantize_matrix`, `dequantize_matrix`):
  a 2-D operand with a per-tensor or per-channel scale; NF4 packs the
  contraction axis split-half within 512-element groups (byte g * 256 +
  j of the packed axis holds elements g * 512 + j and g * 512 + 256 + j).
  `ops.gemm` dequantizes these payloads inside its CUDA kernel, with the
  helpers of `csrc/quant_common.cuh`.

The JAX package's `fp8_expand_bits`, `dequant_block` and the codebook
gathers are TPU vector-unit tricks inside its kernels; on the card they
are the `__device__` helpers of `csrc/quant_common.cuh`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.utils.shapes import round_up

# The NF4 codebook: 16 quantiles of a standard normal, normalized to
# [-1, 1] (the same float32 values as the JAX package's table and
# csrc/quant_common.cuh's).
NF4_CODEBOOK = (
    -1.0, -0.6961928009986877, -0.5250730514526367,
    -0.39491748809814453, -0.28444138169288635, -0.18477343022823334,
    -0.09105003625154495, 0.0, 0.07958029955625534,
    0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
)

# The largest finite value of each FP8 format: the scale maps absmax here.
FP8_MAX = {OperandPrecision.FP8_E4M3: 448.0,
           OperandPrecision.FP8_E5M2: 57344.0}

# NF4 GEMM payloads pack the contraction axis split-half within groups of
# this many elements.
NF4_GEMM_GROUP = 512

# Memory precision codes at the kernels' C interfaces (the Precision enum
# of csrc/quant_common.cuh).
PRECISION_CODE = {
    OperandPrecision.FP32: 0, OperandPrecision.BF16: 1,
    OperandPrecision.INT8: 2, OperandPrecision.FP8_E4M3: 3,
    OperandPrecision.FP8_E5M2: 4, OperandPrecision.NF4: 5,
}


class QuantizedTensor(NamedTuple):
    """A quantized KV operand: payload + per-(batch, head) scale.

    values: [batch, heads, seq, head_dim] in the storage dtype (NF4:
        [batch, heads, seq, head_dim // 2] nibble-packed uint8).
    scales: [batch, heads] float32 dequantization scale.
    precision: which scheme.
    """
    values: torch.Tensor
    scales: torch.Tensor
    precision: OperandPrecision


class QuantizedMatrix(NamedTuple):
    """A quantized GEMM operand: payload + dequantization scale.

    values: storage-dtype payload in the layout the dense operand would
        have (NF4: the contraction axis nibble-packed to half length,
        after padding it to whole NF4_GEMM_GROUPs).
    scale: float32 [] per-tensor scale, or a per-channel vector along the
        operand's non-contracted axis ([M] for A, [N] for B).
    precision: storage scheme (INT8 / FP8_E4M3 / FP8_E5M2 / NF4).
    shape: logical (rows, cols) of the dequantized matrix.
    """
    values: torch.Tensor
    scale: torch.Tensor
    precision: OperandPrecision
    shape: tuple


def _codebook(device) -> torch.Tensor:
    return torch.tensor(NF4_CODEBOOK, dtype=torch.float32, device=device)


def nf4_nearest_indices(normalized: torch.Tensor) -> torch.Tensor:
    """Nearest NF4 codebook index per element (uint8): the codebook is
    sorted, so nearest = left searchsorted on the midpoints, as in the
    JAX package."""
    codebook = _codebook(normalized.device)
    midpoints = (codebook[1:] + codebook[:-1]) / 2.0
    return torch.searchsorted(midpoints, normalized.contiguous()).to(
        torch.uint8)


def nf4_codebook_lookup(idx: torch.Tensor, scale=None) -> torch.Tensor:
    """Codebook value (float32) of each 4-bit index, times ``scale``."""
    out = _codebook(idx.device)[idx.long()]
    return out if scale is None else out * scale


def _nibbles(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    p = packed.to(torch.int32)
    return p & 0x0F, (p >> 4) & 0x0F


def _absmax_scale(x32: torch.Tensor, target_max: float) -> torch.Tensor:
    """Per-(batch, head) scale so the payload fits the target range."""
    absmax = x32.abs().amax(dim=(-1, -2))
    return absmax.clamp_min(1e-12) / target_max


def quantize(x: torch.Tensor, precision: OperandPrecision) -> QuantizedTensor:
    """Quantize [batch, heads, seq, head_dim] for the KV cache."""
    x32 = x.float()
    if precision is OperandPrecision.INT8:
        scale = _absmax_scale(x32, 127.0)
        q = torch.round(x32 / scale[:, :, None, None])
        return QuantizedTensor(q.clamp(-127, 127).to(torch.int8), scale,
                               precision)
    if precision in FP8_MAX:
        scale = _absmax_scale(x32, FP8_MAX[precision])
        q = (x32 / scale[:, :, None, None]).to(precision.storage_dtype)
        return QuantizedTensor(q, scale, precision)
    if precision is OperandPrecision.NF4:
        if x.shape[-1] % 2:
            raise ValueError("NF4 packs 2 values a byte along head_dim")
        scale = _absmax_scale(x32, 1.0)
        idx = nf4_nearest_indices(x32 / scale[:, :, None, None])
        half = x.shape[-1] // 2
        packed = idx[..., :half] | (idx[..., half:] << 4)
        return QuantizedTensor(packed.to(torch.uint8), scale, precision)
    raise ValueError(f"not a quantized precision: {precision}")


def nf4_unpack(packed: torch.Tensor, dim: int = -1,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Split-half NF4 -> float32 codebook values: the low nibbles, then
    the high ones, along ``dim`` (the last axis for the dense cache,
    head_dim; the rows for a paged pool's pages, whose first and second
    halves of tokens share a byte row), each value rounded to ``dtype``
    (the kernels round the codebook to their bf16 inputs)."""
    lo, hi = _nibbles(packed)
    vals = torch.cat([nf4_codebook_lookup(lo), nf4_codebook_lookup(hi)],
                     dim=dim)
    return vals if dtype == torch.float32 else vals.to(dtype).float()


def dequantize(t: QuantizedTensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Host dequantization of a KV operand (float32; NF4's codebook
    values rounded to ``dtype`` first)."""
    s = t.scales[:, :, None, None]
    if t.precision is OperandPrecision.NF4:
        return nf4_unpack(t.values, dtype=dtype) * s
    return t.values.float() * s


def _matrix_absmax_scale(x32: torch.Tensor, target_max: float,
                         channel_axis) -> torch.Tensor:
    if channel_axis is None:
        absmax = x32.abs().amax()
    else:
        absmax = x32.abs().amax(dim=1 - channel_axis)
    return absmax.clamp_min(1e-12) / target_max


def _nf4_pack_groups(idx: torch.Tensor, contract_axis: int) -> torch.Tensor:
    """Pack 4-bit indices split-half within NF4_GEMM_GROUP-element groups
    along ``contract_axis`` (whose extent must be a whole number of
    groups)."""
    k = idx.shape[contract_axis]
    if k % NF4_GEMM_GROUP:
        raise ValueError(f"K {k} is not a whole number of NF4 groups")
    half = NF4_GEMM_GROUP // 2
    if contract_axis == 1:
        g = idx.reshape(idx.shape[0], k // NF4_GEMM_GROUP, NF4_GEMM_GROUP)
        packed = g[..., :half] | (g[..., half:] << 4)
        return packed.reshape(idx.shape[0], k // 2).to(torch.uint8)
    g = idx.reshape(k // NF4_GEMM_GROUP, NF4_GEMM_GROUP, idx.shape[1])
    packed = g[:, :half] | (g[:, half:] << 4)
    return packed.reshape(k // 2, idx.shape[1]).to(torch.uint8)


def nf4_unpack_groups(packed: torch.Tensor, contract_axis: int,
                      scale=None) -> torch.Tensor:
    """Unpack a group-packed NF4 payload (any whole number of groups,
    NF4_GEMM_GROUP // 2 bytes each along ``contract_axis``) to float32
    codebook values, times ``scale``, in logical K order.

    The JAX function unpacks one kernel block of one group (a concat of
    the low and high planes); over a payload of several groups that
    concat puts the groups' planes out of order, which this version does
    not (ROADMAP.md §3)."""
    half = NF4_GEMM_GROUP // 2
    axis = contract_axis % packed.dim()
    kp = packed.shape[axis]
    if kp % half:
        raise ValueError(f"packed K {kp} is not a whole number of groups")
    shape = list(packed.shape)
    grouped = packed.reshape(shape[:axis] + [kp // half, half]
                             + shape[axis + 1:])
    lo, hi = _nibbles(grouped)
    vals = torch.cat([nf4_codebook_lookup(lo, scale),
                      nf4_codebook_lookup(hi, scale)], dim=axis + 1)
    return vals.reshape(shape[:axis] + [2 * kp] + shape[axis + 1:])


def quantize_matrix(x: torch.Tensor, precision: OperandPrecision, *,
                    contract_axis: int,
                    per_channel: bool = False) -> QuantizedMatrix:
    """Quantize a 2-D GEMM operand.

    ``contract_axis`` is the K axis of the *stored* layout (A: 1
    normally, 0 when transpose_a; B: 0 normally, 1 when transpose_b).
    ``per_channel`` puts one scale per non-contracted row or column
    (standard weight quantization) instead of one per tensor."""
    if x.dim() != 2 or contract_axis not in (0, 1):
        raise ValueError(f"expected a 2-D operand and contract_axis 0 or "
                         f"1, got {tuple(x.shape)} and {contract_axis}")
    x32 = x.float()
    channel_axis = (1 - contract_axis) if per_channel else None

    def scaled(target_max):
        scale = _matrix_absmax_scale(x32, target_max, channel_axis)
        s = scale if channel_axis is None else scale.unsqueeze(
            contract_axis)
        return scale, x32 / s
    shape = tuple(x.shape)
    if precision is OperandPrecision.INT8:
        scale, v = scaled(127.0)
        q = torch.round(v).clamp(-127, 127).to(torch.int8)
        return QuantizedMatrix(q, scale, precision, shape)
    if precision in FP8_MAX:
        scale, v = scaled(FP8_MAX[precision])
        return QuantizedMatrix(v.to(precision.storage_dtype), scale,
                               precision, shape)
    if precision is OperandPrecision.NF4:
        scale, v = scaled(1.0)
        # Pad K to whole groups; zero is codebook index 7 (0.0) exactly,
        # so the padding is inert in the product.
        k = shape[contract_axis]
        pad = round_up(k, NF4_GEMM_GROUP) - k
        if pad:
            v = torch.nn.functional.pad(
                v, (0, pad) if contract_axis == 1 else (0, 0, 0, pad))
        packed = _nf4_pack_groups(nf4_nearest_indices(v), contract_axis)
        return QuantizedMatrix(packed, scale, precision, shape)
    raise ValueError(f"not a quantized precision: {precision}")


def dequantize_matrix(t: QuantizedMatrix, *,
                      contract_axis: int) -> torch.Tensor:
    """Host dequantization of a GEMM operand (float32, logical shape)."""
    if t.precision is OperandPrecision.NF4:
        vals = nf4_unpack_groups(t.values, contract_axis)
        vals = vals.narrow(contract_axis, 0, t.shape[contract_axis])
    else:
        vals = t.values.float()
    s = t.scale
    if s.dim() == 1:
        s = s.unsqueeze(contract_axis)
    return vals * s
