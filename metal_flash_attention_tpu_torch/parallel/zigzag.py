"""Zigzag (load-balanced) causal ring attention.

The port of the JAX package's `parallel/zigzag.py`.  Causal ring
attention over contiguous shards is imbalanced: the rank holding the
first chunk attends one K/V chunk while the last attends all of them.
The zigzag layout splits the sequence into 2n chunks and gives rank i
the pair (i, 2n-1-i), so every rank owns the same number of visible
chunk pairs, and every ring step does the same two full products:

    step s > 0, src = (my - s) mod n:
      src < my:  [q_lo; q_hi] x k_lo   (one fused call, both full)
      src > my:  q_hi x [k_lo; k_hi]   (one fused call, both full)
    step 0 (src == my):
      diag(q_lo, k_lo), diag(q_hi, k_hi), full(q_hi, k_lo)

Partials merge by `parallel.ring_attention.merge`; the backward rotates
the float32 dK/dV accumulators with the K/V shards and recomputes every
chunk pair's gradient from the GLOBAL residuals, as
`parallel.ring_attention` does, with the same ``rotate`` argument and
the same overlap of each hop with the kernels.  A rank makes 3 + (n - 1)
forward calls and as many backward pairs, whatever its index.

Callers lay the sequence out with :func:`zigzag_shard` before sharding
it over the context axis, and undo it with :func:`zigzag_unshard`.
"""

from __future__ import annotations

from typing import Optional

import torch

from metal_flash_attention_tpu_torch.ops.flash_attention import (
    flash_attention_forward,
)
from metal_flash_attention_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_backward,
)
from metal_flash_attention_tpu_torch.parallel.ring_attention import (
    add_rows,
    merge,
    ring_callable,
    rows,
)


def zigzag_order(n_chips: int) -> list[int]:
    """Chunk order such that a contiguous split over ranks gives rank i
    the chunks (i, 2n-1-i)."""
    order = []
    for i in range(n_chips):
        order.extend([i, 2 * n_chips - 1 - i])
    return order


def zigzag_shard(x: torch.Tensor, n_chips: int, axis: int = 2
                 ) -> torch.Tensor:
    """Permute the sequence axis into zigzag chunk order (before cutting
    it over the context axis)."""
    seq = x.shape[axis]
    if seq % (2 * n_chips):
        raise ValueError(f"sequence {seq} does not split into "
                         f"{2 * n_chips} chunks")
    chunks = torch.chunk(x, 2 * n_chips, dim=axis)
    return torch.cat([chunks[c] for c in zigzag_order(n_chips)], dim=axis)


def zigzag_unshard(x: torch.Tensor, n_chips: int, axis: int = 2
                   ) -> torch.Tensor:
    """Inverse of :func:`zigzag_shard`."""
    order = zigzag_order(n_chips)
    inverse = [0] * len(order)
    for pos, c in enumerate(order):
        inverse[c] = pos
    chunks = torch.chunk(x, 2 * n_chips, dim=axis)
    return torch.cat([chunks[p] for p in inverse], dim=axis)


def zigzag_fwd_local(q, k, v, *, index: int, n: int, rotate,
                     scale: Optional[float] = None,
                     block_q: Optional[int] = None,
                     block_kv: Optional[int] = None):
    """One rank's forward (JAX `_zigzag_fwd_local`): q, k, v hold its
    chunks [lo; hi].  Returns (o in q's dtype, float32 lse)."""
    c = q.shape[2] // 2
    q_hi = rows(q, c, 2 * c)

    def attend(q_, k_, v_, causal):
        o_, lse_ = flash_attention_forward(q_, k_, v_, causal=causal,
                                           scale=scale, block_q=block_q,
                                           block_kv=block_kv)
        return o_.float(), lse_

    pending = rotate([k, v]) if n > 1 else None
    # Step 0: both diagonals and the shard's own lower block.
    o_lo, lse_lo = attend(rows(q, 0, c), rows(k, 0, c), rows(v, 0, c), True)
    o_hi, lse_hi = merge(*attend(q_hi, rows(k, c, 2 * c),
                                 rows(v, c, 2 * c), True),
                         *attend(q_hi, rows(k, 0, c), rows(v, 0, c), False))
    for s in range(1, n):
        k_blk, v_blk = pending()
        pending = rotate([k_blk, v_blk]) if s < n - 1 else None
        if index >= s:
            # src < my: the whole shard attends src's low chunk.
            o_, lse_ = attend(q, rows(k_blk, 0, c), rows(v_blk, 0, c),
                              False)
            o_lo, lse_lo = merge(o_lo, lse_lo, rows(o_, 0, c),
                                 rows(lse_, 0, c))
            o_hi, lse_hi = merge(o_hi, lse_hi, rows(o_, c, 2 * c),
                                 rows(lse_, c, 2 * c))
        else:
            # src > my: only the high chunk attends, both of src's.
            o_hi, lse_hi = merge(o_hi, lse_hi,
                                 *attend(q_hi, k_blk, v_blk, False))
    return (torch.cat([o_lo, o_hi], dim=2).to(q.dtype),
            torch.cat([lse_lo, lse_hi], dim=2))


def zigzag_bwd_local(q, k, v, do, o, lse, *, index: int, n: int, rotate,
                     scale: Optional[float] = None,
                     block_q: Optional[int] = None,
                     block_kv: Optional[int] = None):
    """One rank's backward (JAX `_zigzag_bwd_local`), every chunk pair
    from the global ``o`` and ``lse``; the dK/dV accumulators travel as
    in `ring_attention_bwd_local`.  Returns (dq, dk, dv)."""
    c = q.shape[2] // 2
    lo, hi = (0, c), (c, 2 * c)

    def bwd(span, k_, v_, causal):
        """The pair of q's rows ``span`` against k_, v_."""
        return flash_attention_backward(
            rows(q, *span), k_, v_, rows(do, *span), rows(o, *span),
            rows(lse, *span), causal=causal, scale=scale, block_q=block_q,
            block_kv=block_kv)

    pending = rotate([k, v]) if n > 1 else None
    # Step 0 (within the shard).
    k_lo, v_lo = rows(k, *lo), rows(v, *lo)
    dq_lo, dk_lo, dv_lo = bwd(lo, k_lo, v_lo, True)
    dq_hi, dk_hi, dv_hi = bwd(hi, rows(k, *hi), rows(v, *hi), True)
    dq2, dk2, dv2 = bwd(hi, k_lo, v_lo, False)
    dq = torch.cat([dq_lo.float(), dq_hi.float() + dq2.float()], dim=2)
    acc = [torch.cat([a.float() + b.float(), h.float()], dim=2)
           for a, b, h in ((dk_lo, dk2, dk_hi), (dv_lo, dv2, dv_hi))]
    sent = rotate(acc)
    for s in range(1, n):
        k_blk, v_blk = pending()
        pending = rotate([k_blk, v_blk]) if s < n - 1 else None
        if index >= s:
            pdq, pdk, pdv = bwd((0, 2 * c), rows(k_blk, *lo),
                                rows(v_blk, *lo), False)
            dq = dq + pdq.float()
        else:
            pdq, pdk, pdv = bwd(hi, k_blk, v_blk, False)
            dq = add_rows(dq, pdq, c)
        acc = [add_rows(a, g, 0) for a, g in zip(sent(), (pdk, pdv))]
        sent = rotate(acc)
    # One closing hop takes each shard's K/V gradient home.
    dk, dv = sent()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _ZigzagAttention(torch.autograd.Function):
    """(q, k, v, body keywords) -> (o, lse); lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        o, lse = zigzag_fwd_local(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*zigzag_bwd_local(q, k, v, do.to(q.dtype), o, lse,
                                  **ctx.kw), None)


def zigzag_ring_attention(mesh, *, scale: Optional[float] = None,
                          block_q: Optional[int] = None,
                          block_kv: Optional[int] = None,
                          return_residuals: bool = False):
    """Load-balanced causal ring attention over ``mesh``'s context axis:
    a callable on this rank's blocks of q, k, v in zigzag order
    (:func:`zigzag_shard` on the sequence, then cut P(data, heads,
    context)); its block of o (and lse with ``return_residuals``) comes
    back in zigzag order (:func:`zigzag_unshard` undoes it).
    Differentiable."""
    return ring_callable(_ZigzagAttention, mesh, return_residuals,
                         scale=scale, block_q=block_q, block_kv=block_kv)
