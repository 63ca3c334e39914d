"""Ring attention: K/V shards rotate around the context axis while each
rank attends the block in front of it, with its differentiable backward.

The port of the JAX package's `parallel/ring_attention.py`, the
long-context tier (128K tokens, K/V sharded over ranks).  Each rank
holds its context shard of q, k and v [batch, heads, seq / n, d] (under
P(data, heads, context)).  Each step attends the K/V shard in hand with
the fused forward (`ops.flash_attention.flash_attention_forward`, the
Hopper kernel on the card) and folds the partial in by the associative
online-softmax merge on the natural-log lse:

    lse' = logaddexp(lse, lse_i)
    O'   = O * exp(lse - lse') + O_i * exp(lse_i - lse')

then passes the shard to the next rank.  Causal masking is resolved by
chunk: a K/V chunk before the rank's own is attended in full, the
diagonal one causally, and a later one launches no kernel.

The backward rotates K/V exactly as the forward did, and the dK/dV
accumulators (float32) travel with their shards; one closing hop sends
each home.  Every chunk pair's gradient is the two backward kernels
(`ops.flash_attention_bwd.flash_attention_backward`) reading the
GLOBAL residuals: P from the whole sequence's lse, D from its o.

The per-rank bodies (`ring_attention_local`, `ring_attention_bwd_local`)
take a ``rotate`` argument: ``rotate(tensors)`` sends each tensor to the
next rank and returns ``wait()``, which gives the previous rank's.  The
default is `parallel.mesh.start_ring_permute` on the context axis
(`torch.distributed.batch_isend_irecv`); a caller may drive the same
bodies with another transport (chip_smoke.py runs four ranks as threads
on one card).  Each step's rotation is issued before the step's kernels
and waited for after them, so the hop overlaps the compute; the
accumulators' hop overlaps the next step's kernels.  Partials are merged
and summed in float32.

`ring_attention(mesh, ...)` returns the callable on a rank's blocks; it
is a `torch.autograd.Function` in place of JAX's `custom_vjp` (the lse
output carries no gradient, as in JAX).
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.ops.flash_attention import (
    check_shapes,
    flash_attention_forward,
)
from metal_flash_attention_tpu_torch.ops.flash_attention_bwd import (
    flash_attention_backward,
)
from metal_flash_attention_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS,
    axis_index,
    axis_size,
    check_mesh,
    start_ring_permute,
)


def merge(o, lse, o_i, lse_i):
    """The associative online-softmax merge of two normalized float32
    partials (o [..., rows, d], lse [..., rows]); a row of lse -inf
    (no key seen) weighs 0."""
    lse_new = torch.logaddexp(lse, lse_i)
    safe = torch.where(torch.isfinite(lse_new), lse_new, 0.0)
    w_old = torch.where(torch.isfinite(lse), torch.exp(lse - safe), 0.0)
    w_new = torch.where(torch.isfinite(lse_i), torch.exp(lse_i - safe), 0.0)
    return o * w_old[..., None] + o_i * w_new[..., None], lse_new


def rows(t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    """Rows lo:hi of the sequence dim (dim 2)."""
    return t[:, :, lo:hi]


def add_rows(acc: torch.Tensor, part: torch.Tensor, lo: int
             ) -> torch.Tensor:
    """A new float32 ``acc`` with ``part`` added to its rows lo.. (the
    received accumulator is never written in place: a transport may hand
    over the sender's own tensor)."""
    out = acc.clone()
    out[:, :, lo:lo + part.shape[2]] += part.float()
    return out


def ring_attention_local(q, k, v, *, index: int, n: int, rotate,
                         causal: bool, scale: Optional[float] = None,
                         block_q: Optional[int] = None,
                         block_kv: Optional[int] = None):
    """One rank's forward (JAX `_ring_attention_local`): its context
    shard q [b, hq, r, d] against every rank's k/v [b, hkv, r, d],
    ``index`` its place on the ring of ``n``.  Returns (o in q's dtype,
    float32 lse [b, hq, r])."""
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full(q.shape[:3], float("-inf"), dtype=torch.float32,
                     device=q.device)
    k_blk, v_blk = k, v
    for step in range(n):
        src = (index - step) % n
        pending = rotate([k_blk, v_blk]) if step < n - 1 else None
        if not causal or src <= index:
            o_i, lse_i = flash_attention_forward(
                q, k_blk, v_blk, causal=causal and src == index,
                scale=scale, block_q=block_q, block_kv=block_kv)
            o, lse = merge(o, lse, o_i.float(), lse_i)
        if pending is not None:
            k_blk, v_blk = pending()
    return o.to(q.dtype), lse


def ring_attention_bwd_local(q, k, v, do, o, lse, *, index: int, n: int,
                             rotate, causal: bool,
                             scale: Optional[float] = None,
                             block_q: Optional[int] = None,
                             block_kv: Optional[int] = None):
    """One rank's backward (JAX `_ring_attention_bwd_local`): ``o`` and
    ``lse`` are the rank's rows of the whole sequence's output and
    residual.  K/V rotate as in the forward; the float32 dK/dV
    accumulator of the chunk in hand comes from the previous rank, takes
    this rank's share and goes on, and after the last step one more hop
    takes each home.  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    k_blk, v_blk = k, v
    acc, sent = None, None
    for step in range(n):
        src = (index - step) % n
        pending = rotate([k_blk, v_blk]) if step < n - 1 else None
        part = None
        if not causal or src <= index:
            part = flash_attention_backward(
                q, k_blk, v_blk, do, o, lse,
                causal=causal and src == index, scale=scale,
                block_q=block_q, block_kv=block_kv)
            dq = dq + part[0].float()
        # The accumulators of the chunk in hand (this rank's own at step
        # 0), sent on from the previous rank while the kernels ran.
        acc = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
               for _ in range(2)] if sent is None else sent()
        if part is not None:
            acc = [a + g.float() for a, g in zip(acc, part[1:])]
        sent = rotate(acc)
        if pending is not None:
            k_blk, v_blk = pending()
    dk, dv = sent()
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    """(q, k, v, body keywords) -> (o, lse); lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, kw):
        o, lse = ring_attention_local(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        return (*ring_attention_bwd_local(q, k, v, do.to(q.dtype), o, lse,
                                          **ctx.kw), None)


def ring_rotate(mesh):
    """The default ``rotate`` of the bodies: `start_ring_permute` on the
    mesh's context axis."""
    return functools.partial(start_ring_permute, mesh=mesh,
                             axis=CONTEXT_AXIS)


def ring_callable(function, mesh, return_residuals: bool, **kw):
    """A callable on a rank's q, k, v blocks (P(data, heads, context))
    running ``function`` (an autograd Function over the bodies) on the
    mesh's context ring: o, or (o, lse) with ``return_residuals``."""
    check_mesh(mesh)
    kw.update(index=axis_index(mesh, CONTEXT_AXIS),
              n=axis_size(mesh, CONTEXT_AXIS), rotate=ring_rotate(mesh))

    def local(q, k, v):
        check_shapes(q, k, v)
        if k.shape[2] != q.shape[2]:
            raise ValueError(f"q and k/v shards must hold the same rows, got "
                             f"{q.shape[2]} and {k.shape[2]}")
        o, lse = function.apply(q, k, v, dict(kw))
        return (o, lse) if return_residuals else o
    return local


def ring_attention(mesh, *, causal: bool = False,
                   scale: Optional[float] = None,
                   block_q: Optional[int] = None,
                   block_kv: Optional[int] = None,
                   return_residuals: bool = False):
    """Differentiable ring attention over ``mesh``'s context axis: a
    callable on this rank's blocks of q [b, hq, seq, d] and k, v [b, hkv,
    seq, d] under P(data, heads, context) (seq divided evenly over the
    axis), returning its block of o, or (o, lse) with
    ``return_residuals``.  The data and heads axes shard as usual: the
    ring runs along the context axis only.  ``block_q`` / ``block_kv``:
    every kernel's tile."""
    return ring_callable(_RingAttention, mesh, return_residuals,
                         causal=causal, scale=scale, block_q=block_q,
                         block_kv=block_kv)
