"""Standalone softmax kernels on a materialized attention matrix
(PyTorch, CUDA on Hopper).

The port of the JAX package's `ops/softmax.py`: `scaled_softmax`, the row
softmax of s * scale by exp2 with scale * log2(e), and
`derivative_softmax`, dS = P * (dP - rowsum(P * dP)) * scale, both in
float32 inside and in the first input's dtype out.

Dispatch: a CPU tensor takes the plain PyTorch version (float32); a CUDA
tensor takes the hand-written kernels of `csrc/softmax.cu` (fp32, bf16
and fp16, any number of columns, last axis contiguous), or raises.
There is no fallback from one to the other.  Each launch adds one to
``LAUNCH_COUNTS["scaled_softmax"]`` or ``["derivative_softmax"]``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch

LOG2E = math.log2(math.e)

# One count per kernel, bumped only where its wrapper launches it.
LAUNCH_COUNTS = {"scaled_softmax": 0, "derivative_softmax": 0}

_DTYPE_CODE = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}


def reset_launch_counts() -> None:
    for name in LAUNCH_COUNTS:
        LAUNCH_COUNTS[name] = 0


def scaled_softmax(s: torch.Tensor, *, scale: Optional[float] = None,
                   block_rows: int = 512,
                   interpret: Optional[bool] = None) -> torch.Tensor:
    """Row-wise softmax(s * scale) over the last axis.

    ``s``: [..., rows, cols].  ``scale`` defaults to 1/sqrt(cols).
    ``block_rows`` and ``interpret`` are the TPU kernel's: accepted and
    ignored (a CUDA block takes one row)."""
    del block_rows, interpret
    if s.dim() < 2:
        raise ValueError(f"s must be [..., rows, cols], got {tuple(s.shape)}")
    if scale is None:
        scale = 1.0 / math.sqrt(s.shape[-1])
    if s.is_cuda:
        return _scaled_softmax_cuda(s, scale)
    if s.device.type == "cpu":
        return _scaled_softmax_plain(s, scale)
    raise ValueError(f"scaled_softmax runs on cpu or cuda tensors, got "
                     f"{s.device}")


def derivative_softmax(p: torch.Tensor, dp: torch.Tensor, *,
                       scale: float = 1.0, block_rows: int = 512,
                       interpret: Optional[bool] = None) -> torch.Tensor:
    """dS = P * (dP - rowsum(P * dP)) * scale, in P's dtype.

    The softmax Jacobian-vector product over a materialized attention
    matrix; ``p`` and ``dp`` are [..., rows, cols] of one shape.
    ``block_rows`` and ``interpret`` are accepted and ignored."""
    del block_rows, interpret
    if p.shape != dp.shape or p.dim() < 2:
        raise ValueError(f"p and dp must be [..., rows, cols] of one shape, "
                         f"got {tuple(p.shape)} and {tuple(dp.shape)}")
    if p.device != dp.device:
        raise ValueError(f"p is on {p.device}, dp on {dp.device}")
    if p.is_cuda:
        return _derivative_softmax_cuda(p, dp, scale)
    if p.device.type == "cpu":
        return _derivative_softmax_plain(p, dp, scale)
    raise ValueError(f"derivative_softmax runs on cpu or cuda tensors, got "
                     f"{p.device}")


def _scaled_softmax_plain(s: torch.Tensor, scale: float) -> torch.Tensor:
    """The plain PyTorch version, in float32: x = s * scale * log2(e),
    exp2(x - max x) over its row sum.  It is what a CPU tensor runs and
    what the kernel is held against on the card."""
    x = s.float() * (scale * LOG2E)
    p = torch.exp2(x - x.amax(dim=-1, keepdim=True))
    return (p / p.sum(dim=-1, keepdim=True)).to(s.dtype)


def _derivative_softmax_plain(p: torch.Tensor, dp: torch.Tensor,
                              scale: float) -> torch.Tensor:
    """The plain PyTorch version, in float32."""
    pv, dpv = p.float(), dp.float()
    d = (pv * dpv).sum(dim=-1, keepdim=True)
    return (pv * (dpv - d) * scale).to(p.dtype)


@functools.cache
def _kernel_library() -> ctypes.CDLL:
    """Build (if stale) and bind csrc/softmax.cu."""
    from metal_flash_attention_tpu_torch.native.build import load_library

    lib = load_library("softmax")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mfa_scaled_softmax.argtypes = [ptr, ptr, i64, i64, i32, i32,
                                       ctypes.c_float, i32, i32, ptr]
    lib.mfa_scaled_softmax.restype = i32
    lib.mfa_derivative_softmax.argtypes = [ptr, ptr, ptr, i64, i64, i64, i32,
                                           i32, ctypes.c_float, i32, i32, i32,
                                           ptr]
    lib.mfa_derivative_softmax.restype = i32
    lib.mfa_cuda_error_string.argtypes = [i32]
    lib.mfa_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _rows(t: torch.Tensor) -> torch.Tensor:
    """t as [rows, cols] with a contiguous last axis: a view where one
    exists, else a copy."""
    if t.dtype not in _DTYPE_CODE:
        raise TypeError(f"the softmax kernels take bf16, fp16 or fp32, got "
                        f"{t.dtype}")
    t2 = t.reshape(-1, t.shape[-1])
    return t2 if t2.stride(-1) == 1 else t2.contiguous()


def _vec_ok(*ts: torch.Tensor) -> bool:
    """Whether every row of every [rows, cols] tensor starts 16-byte
    aligned and holds whole 16-byte pieces."""
    return all(t.data_ptr() % 16 == 0
               and (t.stride(0) * t.element_size()) % 16 == 0
               and (t.shape[1] * t.element_size()) % 16 == 0 for t in ts)


def _check(rc: int, lib, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                           f"({lib.mfa_cuda_error_string(rc).decode()})")


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _scaled_softmax_cuda(s: torch.Tensor, scale: float) -> torch.Tensor:
    s2 = _rows(s)
    out = torch.empty(s2.shape, dtype=s.dtype, device=s.device)
    if s2.shape[0] >= 2 ** 31 or s2.shape[1] >= 2 ** 31:
        raise ValueError(f"rows and cols must stay below 2**31, got "
                         f"{tuple(s2.shape)}")
    lib = _kernel_library()
    with torch.cuda.device(s.device):
        rc = lib.mfa_scaled_softmax(
            s2.data_ptr(), out.data_ptr(), s2.stride(0), out.stride(0),
            s2.shape[0], s2.shape[1], ctypes.c_float(scale * LOG2E),
            int(_vec_ok(s2, out)), _DTYPE_CODE[s.dtype], _stream(s))
    _check(rc, lib, "scaled_softmax")
    LAUNCH_COUNTS["scaled_softmax"] += 1
    return out.reshape(s.shape)


def _derivative_softmax_cuda(p: torch.Tensor, dp: torch.Tensor,
                             scale: float) -> torch.Tensor:
    p2, dp2 = _rows(p), _rows(dp)
    out = torch.empty(p2.shape, dtype=p.dtype, device=p.device)
    if p2.shape[0] >= 2 ** 31 or p2.shape[1] >= 2 ** 31:
        raise ValueError(f"rows and cols must stay below 2**31, got "
                         f"{tuple(p2.shape)}")
    vec = p.dtype == dp.dtype and _vec_ok(p2, dp2, out)
    lib = _kernel_library()
    with torch.cuda.device(p.device):
        rc = lib.mfa_derivative_softmax(
            p2.data_ptr(), dp2.data_ptr(), out.data_ptr(), p2.stride(0),
            dp2.stride(0), out.stride(0), p2.shape[0], p2.shape[1],
            ctypes.c_float(scale), int(vec), _DTYPE_CODE[p.dtype],
            _DTYPE_CODE[dp.dtype], _stream(p))
    _check(rc, lib, "derivative_softmax")
    LAUNCH_COUNTS["derivative_softmax"] += 1
    return out.reshape(p.shape)
