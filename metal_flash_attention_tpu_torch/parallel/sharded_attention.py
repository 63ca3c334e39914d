"""Head-, data- and context-parallel attention over a device mesh.

The port of the JAX package's `parallel/sharded_attention.py`.  JAX wraps
each function in `shard_map` over global arrays; here each rank calls the
returned function on ITS OWN BLOCK of every input, the block that JAX's
``in_specs`` name, and gets its block of the output under JAX's
``out_specs``:

- `sharded_flash_attention`: batch over the data axis, query heads with
  their GQA KV heads over the heads axis; each rank runs the fused
  forward (`ops.flash_attention`) on its block, with no collective;
- `context_parallel_attention`: K/V sharded on their sequence over the
  context axis, q whole; each rank attends its key shard and
  `_merge_partials` combines the partials across ranks;
- `context_parallel_decode`: `flash_decode` over each rank's slice of a
  dense cache, with each row's live length clipped into the slice;
- `shard_paged_cache_pages` (host) and `context_parallel_paged_decode`:
  page pools split across the context axis, `paged_decode` over each
  rank's pages, then the merge.

`_merge_partials` is the online-softmax combine lifted to the mesh: an
`all_reduce(MAX)` of the natural-log lse, then SUMs of the weights and of
o * w, in float32.  A rank that saw no key of a row (lse = -inf, o = 0,
as every kernel reached here returns for a length of 0) weighs 0.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from metal_flash_attention_tpu_torch.ops.flash_attention import (
    flash_attention_forward,
)
from metal_flash_attention_tpu_torch.ops.flash_decode import flash_decode
from metal_flash_attention_tpu_torch.ops.paged_attention import (
    PagedKVCache,
    paged_decode,
)
from metal_flash_attention_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS,
    axis_group,
    axis_index,
    check_mesh,
)


def sharded_flash_attention(mesh, *, causal: bool = False,
                            window_size: Optional[int] = None,
                            scale: Optional[float] = None,
                            block_q: Optional[int] = None,
                            block_kv: Optional[int] = None):
    """Head- and data-parallel fused attention.

    Returns a callable (q, k, v) -> o on this rank's blocks under
    P(data, heads): q [batch / data, q_heads / heads, n, d], k/v [batch /
    data, kv_heads / heads, n, d] (a GQA group stays on one rank)."""
    check_mesh(mesh)

    def local(q, k, v):
        o, _ = flash_attention_forward(
            q, k, v, causal=causal, window_size=window_size, scale=scale,
            block_q=block_q, block_kv=block_kv, emit_lse=False)
        return o
    return local


def _merge_partials(o_local: torch.Tensor, lse_local: torch.Tensor, mesh,
                    axis: str = CONTEXT_AXIS) -> torch.Tensor:
    """Merge each rank's partial attention (o_i float32, natural-log
    lse_i) over ``axis`` into the exact result:
    o = sum_i o_i exp(lse_i - m) / sum_i exp(lse_i - m), m the max lse."""
    group = axis_group(mesh, axis)
    m = lse_local.clone()
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.where(torch.isfinite(lse_local), torch.exp(lse_local - m_safe),
                    torch.zeros_like(lse_local))
    o = o_local * w[..., None]
    dist.all_reduce(w, group=group)
    dist.all_reduce(o, group=group)
    safe_l = torch.where(w == 0.0, torch.ones_like(w), w)
    return o / safe_l[..., None]


def context_parallel_attention(mesh, *, scale: Optional[float] = None,
                               block_q: Optional[int] = None,
                               block_kv: Optional[int] = None):
    """KV-sequence-sharded attention with the cross-rank softmax combine.

    Returns a callable (q, k_shard, v_shard) -> o: q [batch / data,
    q_heads / heads, n, d] whole over the context axis, k/v [batch /
    data, kv_heads / heads, n_kv / context, d] (rank i holds the i-th
    contiguous slice of the keys); o like q.  As in the JAX package the
    attention is not causal.  Communication per query is O(d + 1),
    independent of the context length."""
    check_mesh(mesh)

    def local(q, k_shard, v_shard):
        o_i, lse_i = flash_attention_forward(
            q, k_shard, v_shard, scale=scale, block_q=block_q,
            block_kv=block_kv)
        return _merge_partials(o_i.float(), lse_i, mesh).to(q.dtype)
    return local


def context_parallel_decode(mesh, *, scale: Optional[float] = None,
                            block_kv: Optional[int] = None):
    """Decode attention over a context-sharded dense KV cache.

    Returns a callable (q, k_shard, v_shard, kv_lens) -> o: q [batch /
    data, q_heads / heads, d] whole over the context axis, k/v [batch /
    data, kv_heads / heads, S / context, d] (rank i holds positions i *
    S_local .. (i + 1) * S_local - 1 of every sequence), kv_lens int
    [batch / data] the global lengths; o like q.  Each rank runs
    `flash_decode` on its slice with the live lengths clipped into it
    (0 where a row's tokens end before the slice), then the merge.

    ``block_kv`` caps the decode kernel's split block on the card, as in
    `ops.flash_decode.decode_step`; None leaves the kernel's own cap
    (JAX's default is its TPU block of 2,048)."""
    check_mesh(mesh)

    def local(q, k_shard, v_shard, kv_lens):
        s_local = k_shard.shape[2]
        start = axis_index(mesh, CONTEXT_AXIS) * s_local
        local_lens = (kv_lens - start).clamp(0, s_local).to(torch.int32)
        o_i, lse_i = flash_decode(
            q, k_shard, v_shard, kv_lens=local_lens, scale=scale,
            block_kv=None if block_kv is None else min(block_kv, s_local),
            return_residuals=True)
        return _merge_partials(o_i.float(), lse_i, mesh).to(q.dtype)
    return local


def shard_paged_cache_pages(cache, n_dev: int):
    """Host-side preparation for `context_parallel_paged_decode`: split a
    global paged cache so that rank d holds the global pages {g : g %
    n_dev == d} (local id g // n_dev).

    Each sequence's table row keeps its page ORDER, filtered to each
    rank, so its one partial tail page stays last in its rank's walk (the
    only order the masked kernel needs; full pages are order-invariant
    under the online softmax).  ``cache`` has ``k_pages`` / ``v_pages``
    [P, kv_heads, page, d], ``page_table`` [b, max_pages] and ``lengths``
    [b] (numpy arrays or tensors).  Returns ``(k_stack, v_stack,
    tables, lens)`` with a leading rank axis: the stacks of the pools'
    type ([n_dev, ceil(P / n_dev), kv_heads, page, d]; numpy for numpy,
    a CPU tensor for a tensor), tables and lens int32 numpy.  Rank d
    takes block d of each (``shard`` under P(context))."""
    kp, vp, tbl, lens = cache.k_pages, cache.v_pages, cache.page_table, \
        cache.lengths
    if isinstance(kp, torch.Tensor):
        kp, vp = kp.cpu(), vp.cpu()
    tbl, lens = (x.cpu().numpy() if isinstance(x, torch.Tensor)
                 else np.asarray(x) for x in (tbl, lens))
    num_pages, kvh, page, d = kp.shape
    b, mp = tbl.shape
    p_local = -(-num_pages // n_dev)
    shape = (n_dev, p_local, kvh, page, d)
    if isinstance(kp, torch.Tensor):
        k_stack, v_stack = kp.new_zeros(shape), vp.new_zeros(shape)
    else:
        k_stack = np.zeros(shape, kp.dtype)
        v_stack = np.zeros_like(k_stack)
    for g in range(num_pages):
        k_stack[g % n_dev, g // n_dev] = kp[g]
        v_stack[g % n_dev, g // n_dev] = vp[g]
    tables = np.zeros((n_dev, b, mp), np.int32)
    lens_out = np.zeros((n_dev, b), np.int32)
    for i in range(b):
        n_live = -(-int(lens[i]) // page)
        tail_tokens = int(lens[i]) - (n_live - 1) * page if n_live else 0
        for dev in range(n_dev):
            row = [g for g in tbl[i][:n_live] if g % n_dev == dev]
            tables[dev, i, :len(row)] = [g // n_dev for g in row]
            t = 0
            for j, g in enumerate(tbl[i][:n_live]):
                if g % n_dev != dev:
                    continue
                t += tail_tokens if j == n_live - 1 else page
            lens_out[dev, i] = t
    return k_stack, v_stack, tables, lens_out


def context_parallel_paged_decode(mesh):
    """Paged decode over page pools split across the context axis: each
    rank walks only its own pages for its own token count, and one
    `_merge_partials` combines the partials.  Communication per token is
    O(heads * d), independent of the context length.

    Returns a callable (q, kp, vp, tbl, lens) -> o: q [b, q_heads, d]
    whole on every rank; kp / vp [1, P_local, kv_heads, page, d], tbl
    [1, b, max_pages] and lens [1, b], this rank's blocks under
    P(context) of `shard_paged_cache_pages`' stacks (on the rank's
    device); o like q.  A row whose tokens lie on other ranks only has a
    local length of 0 here."""
    check_mesh(mesh)

    def local(q, kp, vp, tbl, lens):
        cache = PagedKVCache(kp[0], vp[0], tbl[0], lens[0])
        o_i, lse_i = paged_decode(q, cache, return_residuals=True)
        return _merge_partials(o_i.float(), lse_i, mesh).to(q.dtype)
    return local
