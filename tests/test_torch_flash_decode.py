"""Dense decode attention in the PyTorch port against the JAX package.

The same numpy inputs go through the JAX `flash_decode` (the Pallas
kernel in interpret mode, as the JAX tests run it on the CPU) and the
port's plain PyTorch version, and the port is also held against
`attention_reference` on each row's live keys.

Tolerances: float32 at FP32_TOL (o and lse 2e-5); bf16 and fp16 at
MIXED_TOL (o 5e-2, lse 7e-3), because the JAX kernel rounds
q * scale * log2(e) and P to bf16 (and computes fp16 in bf16), where the
port's plain version stays in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.ops.flash_decode import (
    decode_step as jax_decode_step,
    flash_decode as jax_flash_decode,
)
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.ops import flash_decode as tfd
from metal_flash_attention_tpu_torch.ops.reference import attention_reference
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    max_abs_err,
    tolerances_for,
)

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float16": (jnp.float16, torch.float16)}


def _round(x, dtype):
    """Round a float32 array through ``dtype`` so both packages see the
    same values."""
    return np.array(jnp.asarray(x, dtype).astype(jnp.float32))


def _case(seed, *, q_heads, kv_heads, d, max_seq, batch, dtype):
    rng = np.random.default_rng(seed)
    q = _round(rng.standard_normal((batch, q_heads, d)), dtype)
    k = _round(rng.standard_normal((batch, kv_heads, max_seq, d)), dtype)
    v = _round(rng.standard_normal((batch, kv_heads, max_seq, d)), dtype)
    return q, k, v


def _ints(x):
    return None if x is None else np.asarray(x, np.int32)


def _jax(q, k, v, lens, starts, max_span, jdt, cap=None):
    o, lse = jax_flash_decode(
        jnp.asarray(q, jdt), jnp.asarray(k, jdt), jnp.asarray(v, jdt),
        kv_lens=None if lens is None else jnp.asarray(lens),
        kv_starts=None if starts is None else jnp.asarray(starts),
        max_span=max_span, logit_softcap=cap, return_residuals=True)
    return np.asarray(o.astype(jnp.float32)), np.asarray(lse)


def _torch(q, k, v, lens, starts, max_span, tdt, cap=None):
    def t(x, dtype=tdt):
        return None if x is None else torch.as_tensor(x).to(dtype)
    return tfd.flash_decode(t(q), t(k), t(v), kv_lens=t(lens, torch.int32),
                            kv_starts=t(starts, torch.int32),
                            max_span=max_span, logit_softcap=cap,
                            return_residuals=True)


def _golden(q, k, v, lo, hi):
    """attention_reference per sequence on its keys [lo, hi)."""
    outs, lses = [], []
    for b in range(q.shape[0]):
        if hi[b] <= lo[b]:
            outs.append(np.zeros(q.shape[1:], np.float32))
            lses.append(np.full(q.shape[1:2], -np.inf, np.float32))
            continue
        o, lse = attention_reference(
            torch.as_tensor(q[b][:, None]),
            torch.as_tensor(k[b, :, lo[b]:hi[b]]),
            torch.as_tensor(v[b, :, lo[b]:hi[b]]), return_residuals=True)
        outs.append(o[:, 0].numpy())
        lses.append(lse[:, 0].numpy())
    return np.stack(outs), np.stack(lses)


def _bounds(batch, max_seq, lens, starts, max_span=None):
    lo = np.zeros(batch, int) if starts is None else np.maximum(starts, 0)
    hi = np.full(batch, max_seq) if lens is None else np.minimum(lens,
                                                                 max_seq)
    if max_span is not None:
        hi = np.minimum(hi, lo + max_span)
    return lo, hi


# (q_heads, kv_heads, head_dim, max_seq, lens, starts, max_span): GQA
# groups 1 and 4, head dims 64 and 128, empty and one-key rows, lengths
# off the 64-key tile, starts, spans within max_span, the full cache.
CASES = [
    (4, 4, 64, 200, [13, 0, 200, 1], None, None),
    (8, 2, 128, 160, [100, 1, 64], [30, 0, 10], None),
    (8, 2, 64, 300, None, None, None),
    (16, 4, 128, 129, [129, 77], [0, 76], None),
    (8, 2, 64, 256, [200, 50, 129], [100, 0, 29], 128),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", CASES)
def test_flash_decode_matches_jax(case, dtype):
    qh, kvh, d, n, lens, starts, span = case
    jdt, tdt = DTYPES[dtype]
    batch = 2 if lens is None else len(lens)
    q, k, v = _case(0, q_heads=qh, kv_heads=kvh, d=d, max_seq=n,
                    batch=batch, dtype=jdt)
    lens, starts = _ints(lens), _ints(starts)
    jo, jl = _jax(q, k, v, lens, starts, span, jdt)
    to, tl = _torch(q, k, v, lens, starts, span, tdt)
    go, gl = _golden(q, k, v, *_bounds(batch, n, lens, starts, span))
    tol = tolerances_for(tdt)
    assert to.dtype == tdt and tl.dtype == torch.float32
    assert max_abs_err(to, jo) < tol.o
    assert max_abs_err(tl, jl) < tol.lse
    assert max_abs_err(to, go) < tol.o
    assert max_abs_err(tl, gl) < tol.lse
    if lens is not None:
        empty = lens == 0
        assert np.all(to.float().numpy()[empty] == 0.0)
        assert np.all(np.isneginf(tl.numpy()[empty]))


# Gemma-2's soft cap: head dims 64 and 256, the model's cap (50) and a
# saturating one (2, over queries scaled by 4), a window as kv_starts.
SOFTCAP_CASES = [
    # (q_heads, kv_heads, d, max_seq, lens, starts, q_gain, cap)
    (4, 2, 64, 160, [160, 77], [30, 0], 1.0, 50.0),
    (4, 2, 64, 160, [160, 77], [30, 0], 4.0, 2.0),
    (8, 4, 256, 200, [200, 65, 1], [100, 0, 0], 4.0, 2.0),
    (8, 4, 256, 130, [130, 64], None, 1.0, 50.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SOFTCAP_CASES)
def test_flash_decode_softcap_matches_jax(case, dtype):
    """The capped decode against the JAX kernel (interpret mode) and the
    capped reference, at the dtype's tier (FP32_TOL / MIXED_TOL); at a
    saturating cap the capped output must differ from the uncapped one
    by far more than that tier.  In bf16 the lse is held against the
    capped float32 reference only: the JAX kernel rounds q * scale *
    log2(e) to bf16, which at head_dim 256 with queries scaled by 4
    moves a one-key row's lse by about 1e-2 on its own."""
    qh, kvh, d, n, lens, starts, gain, cap = case
    jdt, tdt = DTYPES[dtype]
    q, k, v = _case(7, q_heads=qh, kv_heads=kvh, d=d, max_seq=n,
                    batch=len(lens), dtype=jdt)
    q = _round(q * gain, jdt)
    lens, starts = _ints(lens), _ints(starts)
    jo, jl = _jax(q, k, v, lens, starts, None, jdt, cap)
    to, tl = _torch(q, k, v, lens, starts, None, tdt, cap)
    tol = tolerances_for(tdt)
    assert max_abs_err(to, jo) < tol.o
    if tdt == torch.float32:
        assert max_abs_err(tl, jl) < tol.lse
    lo, hi = _bounds(len(lens), n, lens, starts)
    for b in range(len(lens)):
        if hi[b] > lo[b]:
            go, gl = attention_reference(
                torch.as_tensor(q[b][:, None]),
                torch.as_tensor(k[b, :, lo[b]:hi[b]]),
                torch.as_tensor(v[b, :, lo[b]:hi[b]]), logit_softcap=cap,
                return_residuals=True)
            assert max_abs_err(to[b], go[:, 0]) < tol.o
            assert max_abs_err(tl[b], gl[:, 0]) < tol.lse
    if cap < 10:
        uo, _ = _torch(q, k, v, lens, starts, None, tdt)
        assert max_abs_err(uo, to) > 10 * tol.o


def test_over_long_span_is_clamped_to_the_window():
    """A row whose live span exceeds max_span attends
    [start, start + max_span): the JAX kernel drops a data-dependent
    part of its tail instead, so this is held against the masked
    reference only."""
    lens, starts, span = np.array([200, 90], np.int32), \
        np.array([10, 0], np.int32), 64
    q, k, v = _case(3, q_heads=4, kv_heads=2, d=64, max_seq=256, batch=2,
                    dtype=jnp.float32)
    to, tl = _torch(q, k, v, lens, starts, span, torch.float32)
    go, gl = _golden(q, k, v, [10, 0], [74, 64])
    assert max_abs_err(to, go) < FP32_TOL.o
    assert max_abs_err(tl, gl) < FP32_TOL.lse


def test_two_segment_merge_equals_the_whole():
    q, k, v = (torch.as_tensor(x) for x in _case(
        4, q_heads=4, kv_heads=4, d=64, max_seq=512, batch=1,
        dtype=jnp.float32))
    o1, l1 = tfd.flash_decode(q, k[:, :, :256], v[:, :, :256],
                              return_residuals=True)
    o2, l2 = tfd.flash_decode(q, k[:, :, 256:], v[:, :, 256:],
                              return_residuals=True)
    whole = tfd.flash_decode(q, k, v)
    assert max_abs_err(ts._merge_partials(o1, l1, o2, l2),
                       whole) < FP32_TOL.o


def test_decode_step_matches_jax():
    """Append one row per sequence at its length, then attend: the same
    output, caches and lengths as the JAX `decode_step`."""
    rng = np.random.default_rng(5)
    b, qh, kvh, n, d = 2, 8, 2, 96, 64
    k = rng.standard_normal((b, kvh, n, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, n, d)).astype(np.float32)
    lens = np.array([40, 0], np.int32)
    for t in range(3):
        q = rng.standard_normal((b, qh, d)).astype(np.float32)
        nk = rng.standard_normal((b, kvh, d)).astype(np.float32)
        nv = rng.standard_normal((b, kvh, d)).astype(np.float32)
        jo, jk, jv, jlens = jax_decode_step(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(nk),
            jnp.asarray(nv), jnp.asarray(lens))
        tk, tv = torch.as_tensor(k.copy()), torch.as_tensor(v.copy())
        to, tk2, tv2, tlens = tfd.decode_step(
            torch.as_tensor(q), tk, tv, torch.as_tensor(nk),
            torch.as_tensor(nv), torch.tensor(lens))
        assert tk2 is tk and tv2 is tv            # updated in place
        assert max_abs_err(to, jo) < FP32_TOL.o
        assert max_abs_err(tk, jk) == 0.0 and max_abs_err(tv, jv) == 0.0
        assert tlens.tolist() == np.asarray(jlens).tolist()
        k, v, lens = np.asarray(jk), np.asarray(jv), np.asarray(jlens)


def test_unported_and_invalid_options_raise():
    q, k, v = (torch.as_tensor(x) for x in _case(
        6, q_heads=4, kv_heads=2, d=64, max_seq=32, batch=1,
        dtype=jnp.float32))
    lens = torch.tensor([20], dtype=torch.int32)
    with pytest.raises(TypeError, match="QuantizedTensors"):
        tfd.flash_decode(q, object(), object())
    # logit_softcap is ported: a cap of 0 is no cap, as the JAX kernel
    # reads it, and a cap's sign does not matter (c tanh(s / c) is even).
    assert torch.equal(tfd.flash_decode(q, k, v, logit_softcap=0.0),
                       tfd.flash_decode(q, k, v))
    assert torch.equal(tfd.flash_decode(q, k, v, logit_softcap=-30.0),
                       tfd.flash_decode(q, k, v, logit_softcap=30.0))
    with pytest.raises(ValueError, match="max_span"):
        tfd.flash_decode(q, k, v, kv_lens=lens, max_span=8)
    with pytest.raises(ValueError):
        tfd.flash_decode(q, k[:, :, :, :32], v)
    with pytest.raises(ValueError):
        tfd.flash_decode(q.to("meta"), k.to("meta"), v.to("meta"))
    # block_kv is a TPU tiling choice: accepted, and it changes nothing.
    assert torch.equal(tfd.flash_decode(q, k, v, block_kv=128),
                       tfd.flash_decode(q, k, v))
