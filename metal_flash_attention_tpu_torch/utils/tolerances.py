"""Tolerance tiers by precision regime, on torch dtypes.

The same numbers as the JAX package's `utils/tolerances.py`: FP32 2e-5
everywhere; mixed precision 5e-2 for O and the gradients, 7e-3 for the
log-sum-exp L, 1e-1 for D.  On the card a kernel is held against its
plain version on the same inputs by the worst relative rms error of any
64-row tile (`worst_tile_rel_rms`, KERNEL_TILE_REL_RMS), so that a fault
confined to one tile cannot hide among the rest.
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


# A kernel's output against its plain version: the worst 64-row tile's
# relative rms error.
KERNEL_TILE_ROWS = 64
KERNEL_TILE_REL_RMS = 1.5e-2


def worst_tile_rel_rms(got: torch.Tensor, ref: torch.Tensor,
                       tile_rows: int = KERNEL_TILE_ROWS) -> float:
    """max over tiles of ``tile_rows`` rows (the second axis from the end)
    by whole rows of ||got - ref|| / ||ref||, in float32."""
    ref = ref.float()
    err = (got.float() - ref).pow(2)

    def per_tile(x):
        x = torch.nn.functional.pad(x.sum(dim=-1),
                                    (0, -x.shape[-2] % tile_rows))
        return x.unflatten(-1, (-1, tile_rows)).sum(dim=-1)
    e2, r2 = per_tile(err), per_tile(ref.pow(2))
    floor = 1e-12 * float(r2.mean()) + 1e-30
    return float((e2 / r2.clamp_min(floor)).sqrt().max())


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
