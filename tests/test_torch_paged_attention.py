"""Paged attention in the PyTorch port against the JAX package.

The same numpy inputs go through the JAX `paged_decode` /
`paged_prefill` (the Pallas kernel in interpret mode, as the JAX tests
run it on the CPU) and the port's plain PyTorch version, and both are
held against `attention_reference` on the equivalent dense K/V.

Tolerances: float32 at FP32_TOL (o and lse 2e-5); bf16 at MIXED_TOL
(o 5e-2, lse 7e-3), because the JAX kernel rounds q * scale * log2(e)
to bf16 before QK^T and P to bf16 before PV, where the port's plain
version stays in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.ops import paged_attention as jpa
from metal_flash_attention_tpu_torch.ops import paged_attention as tpa
from metal_flash_attention_tpu_torch.ops.reference import attention_reference
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
    tolerances_for,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _round(x, dtype):
    """Round a float32 array through ``dtype`` so both packages see the
    same values."""
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32))


def _case(seed, *, q_heads, kv_heads, d, page_size, lengths, q_chunk,
          dtype):
    """Random pools, a shuffled page table (page 0 kept null), q, and
    the dense per-sequence K/V the golden needs."""
    rng = np.random.default_rng(seed)
    batch = len(lengths)
    max_pages = max(-(-n // page_size) for n in lengths) + 1
    num_pages = batch * max_pages + 2
    shape = (num_pages, kv_heads, page_size, d)
    k = _round(rng.standard_normal(shape), dtype)
    v = _round(rng.standard_normal(shape), dtype)
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((batch, max_pages), np.int32)
    for b in range(batch):
        n = -(-lengths[b] // page_size)
        table[b, :n] = perm[b * max_pages:b * max_pages + n]
    qshape = (batch, q_heads, q_chunk or 1, d)
    q = _round(rng.standard_normal(qshape), dtype)
    return q, k, v, table, np.asarray(lengths, np.int32)


def _jax(q, k, v, table, lengths, *, q_chunk, window, jdt, starts=None,
         cap=None):
    cache = jpa.PagedKVCache(jnp.asarray(k, jdt), jnp.asarray(v, jdt),
                             jnp.asarray(table), jnp.asarray(lengths))
    kw = dict(window_size=window, return_residuals=True, logit_softcap=cap,
              kv_starts=None if starts is None else jnp.asarray(starts))
    if q_chunk is None:
        o, lse = jpa.paged_decode(jnp.asarray(q[:, :, 0], jdt), cache, **kw)
        o, lse = o[:, :, None], lse[:, :, None]
    else:
        o, lse = jpa.paged_prefill(jnp.asarray(q, jdt), cache, **kw)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _torch(q, k, v, table, lengths, *, q_chunk, window, tdt, starts=None,
           cap=None):
    def t(x, dtype=tdt):
        return None if x is None else torch.as_tensor(x).to(dtype)
    cache = tpa.PagedKVCache(t(k), t(v), t(table, torch.int32),
                             t(lengths, torch.int32))
    kw = dict(window_size=window, return_residuals=True, logit_softcap=cap,
              kv_starts=t(starts, torch.int32))
    if q_chunk is None:
        o, lse = tpa.paged_decode(t(q[:, :, 0]), cache, **kw)
        return o[:, :, None], lse[:, :, None]
    return tpa.paged_prefill(t(q), cache, **kw)


def _golden(q, k, v, table, lengths, *, window):
    """attention_reference per sequence on its gathered dense K/V; the
    query block is causal at the end of the sequence."""
    ps = k.shape[2]
    outs, lses = [], []
    for b, n in enumerate(lengths):
        if n == 0:
            outs.append(np.zeros(q.shape[1:], np.float32))
            lses.append(np.full(q.shape[1:3], -np.inf, np.float32))
            continue
        pages = table[b, :-(-n // ps)]
        kd = np.concatenate(list(k[pages].transpose(1, 0, 2, 3)
                                 .reshape(1, k.shape[1], -1, k.shape[3])),
                            axis=0)[:, :n]
        vd = np.concatenate(list(v[pages].transpose(1, 0, 2, 3)
                                 .reshape(1, v.shape[1], -1, v.shape[3])),
                            axis=0)[:, :n]
        o, lse = attention_reference(
            torch.as_tensor(q[b]), torch.as_tensor(kd), torch.as_tensor(vd),
            causal=True, window_size=window, return_residuals=True)
        outs.append(o.numpy())
        lses.append(lse.numpy())
    return np.stack(outs), np.stack(lses)


# (q_heads, kv_heads, head_dim, page_size, lengths, window): GQA groups
# 1, 2 and 4, head dims 32/64/128, partial last pages, an empty row.
DECODE_CASES = [
    (4, 4, 32, 8, [13, 0, 40], None),
    (4, 2, 64, 16, [16, 57, 3], None),
    (8, 2, 128, 16, [33, 20], None),
    (8, 2, 64, 8, [30, 5, 17], 7),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES)
def test_paged_decode_matches_jax(case, dtype):
    qh, kvh, d, ps, lengths, window = case
    jdt, tdt = DTYPES[dtype]
    args = _case(0, q_heads=qh, kv_heads=kvh, d=d, page_size=ps,
                 lengths=lengths, q_chunk=None, dtype=jdt)
    jo, jl = _jax(*args, q_chunk=None, window=window, jdt=jdt)
    to, tl = _torch(*args, q_chunk=None, window=window, tdt=tdt)
    go, gl = _golden(*args, window=window)
    tol = tolerances_for(tdt)
    assert max_abs_err(to, jo) < tol.o
    assert max_abs_err(tl, jl) < tol.lse
    assert max_abs_err(to, go) < tol.o
    assert max_abs_err(tl, gl) < tol.lse
    empty = np.asarray(lengths) == 0
    assert np.all(to.float().numpy()[empty] == 0.0)
    assert np.all(np.isneginf(tl.numpy()[empty]))


# (q_heads, kv_heads, head_dim, page_size, q_chunk, lengths, window)
PREFILL_CASES = [
    (4, 4, 32, 8, 8, [8, 21], None),
    (4, 2, 64, 16, 12, [12, 40, 29], None),
    (8, 2, 128, 16, 16, [16, 35], None),
    (4, 2, 32, 8, 6, [6, 26], 5),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", PREFILL_CASES)
def test_paged_prefill_matches_jax(case, dtype):
    qh, kvh, d, ps, qc, lengths, window = case
    jdt, tdt = DTYPES[dtype]
    args = _case(1, q_heads=qh, kv_heads=kvh, d=d, page_size=ps,
                 lengths=lengths, q_chunk=qc, dtype=jdt)
    jo, jl = _jax(*args, q_chunk=qc, window=window, jdt=jdt)
    to, tl = _torch(*args, q_chunk=qc, window=window, tdt=tdt)
    go, gl = _golden(*args, window=window)
    tol = tolerances_for(tdt)
    assert max_abs_err(to, jo) < tol.o
    assert max_abs_err(tl, jl) < tol.lse
    assert max_abs_err(to, go) < tol.o
    assert max_abs_err(tl, gl) < tol.lse


@pytest.mark.parametrize("kc", [1, 5])
def test_paged_append_chunk_matches_jax(kc):
    """The scatter writes the same pool rows, in place, and advances the
    lengths by the chunk (kc == 1 goes through `paged_append`)."""
    rng = np.random.default_rng(2)
    num_pages, kvh, ps, d = 9, 2, 8, 16
    k = rng.standard_normal((num_pages, kvh, ps, d)).astype(np.float32)
    v = rng.standard_normal((num_pages, kvh, ps, d)).astype(np.float32)
    table = np.array([[3, 7, 1, 0], [5, 2, 8, 0]], np.int32)
    lengths = np.array([6, 13], np.int32)
    nk = rng.standard_normal((2, kvh, kc, d)).astype(np.float32)
    nv = rng.standard_normal((2, kvh, kc, d)).astype(np.float32)
    jcache = jpa.PagedKVCache(jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(table), jnp.asarray(lengths))
    tk, tv = torch.as_tensor(k.copy()), torch.as_tensor(v.copy())
    tcache = tpa.PagedKVCache(tk, tv, torch.as_tensor(table),
                              torch.as_tensor(lengths))
    if kc == 1:
        jc = jpa.paged_append(jcache, jnp.asarray(nk[:, :, 0]),
                              jnp.asarray(nv[:, :, 0]))
        tc = tpa.paged_append(tcache, torch.as_tensor(nk[:, :, 0]),
                              torch.as_tensor(nv[:, :, 0]))
    else:
        jc = jpa.paged_append_chunk(jcache, jnp.asarray(nk), jnp.asarray(nv))
        tc = tpa.paged_append_chunk(tcache, torch.as_tensor(nk),
                                    torch.as_tensor(nv))
    assert tc.k_pages is tk and tc.v_pages is tv      # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jc.k_pages))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jc.v_pages))
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_unported_options_raise():
    """The Gemma options are ported (the soft cap, kv_starts); what is
    malformed still raises."""
    cache = tpa.init_paged_cache(num_pages=4, kv_heads=1, page_size=8,
                                 head_dim=16, batch=1, max_pages=2,
                                 dtype=torch.float32, device="cpu")
    cache = cache._replace(page_table=torch.tensor([[1, 2]],
                                                   dtype=torch.int32),
                           lengths=torch.tensor([9], dtype=torch.int32))
    q = torch.ones((1, 2, 16))
    assert torch.isfinite(tpa.paged_decode(q, cache,
                                           logit_softcap=30.0)).all()
    assert torch.isfinite(tpa.paged_decode(
        q, cache, kv_starts=torch.zeros(1, dtype=torch.int32))).all()
    with pytest.raises(ValueError, match="kv_starts"):
        tpa.paged_decode(q, cache, kv_starts=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError, match="window_size"):
        tpa.paged_decode(q, cache, window_size=0)


# Gemma-2's options in both modes: the soft cap (the model's 50; 2 over
# queries scaled by 4, where the tanh saturates) at head dims 64 and 256,
# kv_starts (a sliding window as each sequence's first position), with
# and without a window.  Every start is at most its chunk's first query
# position: a query that sees no key is where the two packages differ by
# design (the JAX kernel returns its masked average, the port o = 0 and
# lse = -inf).
GEMMA_CASES = [
    # (q_heads, kv_heads, d, page, lengths, q_chunk, window, starts, gain,
    #  cap)
    (4, 2, 64, 16, [57, 20], None, None, [30, 0], 4.0, 2.0),
    (4, 2, 64, 16, [57, 40], 8, 24, [10, 30], 1.0, 50.0),
    (8, 4, 256, 16, [70, 33], None, 32, None, 4.0, 2.0),
    (8, 4, 256, 16, [70, 40], 16, None, [50, 0], 4.0, 2.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", GEMMA_CASES)
def test_gemma_options_match_jax(case, dtype):
    """Both modes with the soft cap and kv_starts against the JAX kernel
    (interpret mode), at the dtype's tier (FP32_TOL / MIXED_TOL); o also
    against the capped reference on each row's visible keys; at a
    saturating cap the capped output differs from the uncapped one by
    far more than the tier.  In bf16 the lse is held against the float32
    reference only (the JAX kernel's bf16 rounding of q * scale * log2(e)
    moves short rows' lse by about 1e-2 at head_dim 256, queries x4)."""
    qh, kvh, d, ps, lengths, qc, window, starts, gain, cap = case
    jdt, tdt = DTYPES[dtype]
    q, k, v, table, lens = _case(9, q_heads=qh, kv_heads=kvh, d=d,
                                 page_size=ps, lengths=lengths, q_chunk=qc,
                                 dtype=jdt)
    q = _round(q * gain, jdt)
    starts = None if starts is None else np.asarray(starts, np.int32)
    kw = dict(q_chunk=qc, window=window, starts=starts, cap=cap)
    jo, jl = _jax(q, k, v, table, lens, jdt=jdt, **kw)
    to, tl = _torch(q, k, v, table, lens, tdt=tdt, **kw)
    tol = tolerances_for(tdt)
    assert max_abs_err(to, jo) < tol.o
    if tdt == torch.float32:
        assert max_abs_err(tl, jl) < tol.lse
    # The reference: row t of sequence b at position n - qc + t sees the
    # keys in [start, position], within the window.
    for b, n in enumerate(lens):
        kd = k[table[b]].transpose(1, 0, 2, 3).reshape(kvh, -1, d)[:, :n]
        vd = v[table[b]].transpose(1, 0, 2, 3).reshape(kvh, -1, d)[:, :n]
        lo = 0 if starts is None else int(starts[b])
        go, gl = attention_reference(
            torch.as_tensor(q[b]), torch.as_tensor(kd[:, lo:]),
            torch.as_tensor(vd[:, lo:]), causal=True, window_size=window,
            logit_softcap=cap, return_residuals=True)
        assert max_abs_err(to[b], go) < tol.o
        assert max_abs_err(tl[b], gl) < tol.lse
    if cap < 10:
        uo, _ = _torch(q, k, v, table, lens, tdt=tdt, q_chunk=qc,
                       window=window, starts=starts)
        assert max_abs_err(uo, to) > 10 * tol.o


def test_shape_helpers_match_jax():
    from metal_flash_attention_tpu.utils import shapes as js
    from metal_flash_attention_tpu_torch.utils import shapes as ts
    for a, b in [(0, 8), (1, 8), (8, 8), (9, 8), (1100, 128), (127, 1)]:
        assert ts.round_up(a, b) == js.round_up(a, b)
        assert ts.cdiv(a, b) == js.cdiv(a, b)


def test_tolerance_tiers_match_jax():
    from metal_flash_attention_tpu.utils import tolerances as jt
    assert (FP32_TOL.o, FP32_TOL.lse) == (jt.FP32_TOL.o, jt.FP32_TOL.lse)
    assert (MIXED_TOL.o, MIXED_TOL.lse, MIXED_TOL.d_term) == \
        (jt.MIXED_TOL.o, jt.MIXED_TOL.lse, jt.MIXED_TOL.d_term)
    assert tolerances_for(torch.float32) is FP32_TOL
    assert tolerances_for(torch.bfloat16) is MIXED_TOL
