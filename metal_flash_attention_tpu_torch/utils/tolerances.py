"""Tolerance tiers by precision regime, on torch dtypes.

The same numbers as the JAX package's `utils/tolerances.py`: FP32 2e-5
everywhere; mixed precision 5e-2 for O and the gradients, 7e-3 for the
log-sum-exp L, 1e-1 for D.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Tolerances:
    o: float
    grads: float
    lse: float
    d_term: float


FP32_TOL = Tolerances(o=2e-5, grads=2e-5, lse=2e-5, d_term=2e-5)
MIXED_TOL = Tolerances(o=5e-2, grads=5e-2, lse=7e-3, d_term=1e-1)


def tolerances_for(dtype: torch.dtype) -> Tolerances:
    return FP32_TOL if dtype == torch.float32 else MIXED_TOL


def max_abs_err(a, b) -> float:
    """Largest |a - b| over two tensors or arrays, compared in float32.
    Infinities at the same place (an empty row's lse) count as equal."""
    def as_np(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().float().cpu().numpy()
        return np.asarray(x, np.float32)
    a, b = as_np(a), as_np(b)
    same_inf = np.isinf(a) & (a == b)
    with np.errstate(invalid="ignore"):
        diff = np.where(same_inf, 0.0, np.abs(a - b))
    return float(np.max(diff)) if diff.size else 0.0
