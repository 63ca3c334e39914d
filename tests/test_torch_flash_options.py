"""The flash-attention options in the PyTorch port against the JAX package.

mask (broadcast, per head and repeated over the batch), mask2, an
additive bias with its gradient, packed-sequence segment ids and the
bf16 L residual (``low_precision_intermediates``), alone and with
causal, window, GQA and the soft cap: the same numpy inputs go through
the JAX `flash_attention` (its Pallas kernels in interpret mode, as the
JAX tests run them on the CPU) under `jax.grad`, and through the port's
`flash_attention` under torch autograd (the plain versions, which a CPU
tensor runs).  `dispatch.attention` with options and
`compat.dot_product_attention` the same way, after the JAX package's
`tests/test_compat.py` and `tests/test_segments.py`.

Tolerances: float32 at FP32_TOL (2e-5); bf16 and the bf16 L residual at
MIXED_TOL (o and grads 5e-2, lse 7e-3), because the JAX kernels round
the prescaled Q, P and dS to bf16 while the port's plain version stays
in float32.  A gradient is held relative to its own size where that
exceeds 1 (err <= tol * max(1, max |ref|), as the card tests hold
theirs): dbias of a bias broadcast over the batch sums 4 batches' dS.
The bf16 L residual: each package's lies within 2^-8 (1 + max |lse|) of
its float32 lse (half a bf16 ulp, the JAX package's own bound in
tests/test_precision_modes.py), so the two within twice that.
Shapes are few and small (D 64, N <= 128), so that JAX compiles few
kernels.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu import compat as jcompat
from metal_flash_attention_tpu import dispatch as jdispatch
from metal_flash_attention_tpu_torch import compat as tcompat
from metal_flash_attention_tpu_torch import dispatch as tdispatch
from metal_flash_attention_tpu_torch.ops import flash_attention as tfa
from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as tfb
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
)

jfa = importlib.import_module("metal_flash_attention_tpu.ops.flash_attention")

DTYPES = {"float32": (jnp.float32, torch.float32, FP32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, MIXED_TOL)}
B, QH, KVH, N, D = 4, 4, 2, 128, 64
OPTION_NAMES = ("mask", "bias", "mask2", "q_segment_ids", "kv_segment_ids")


def _rng_arrays(seed, b=B, qh=QH, kvh=KVH, r=N, c=N, d=D, jdt=jnp.float32):
    """q, k, v, dO as float32 numpy, rounded through the working dtype."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.array(jnp.asarray(x, jdt).astype(jnp.float32))
    return a(b, qh, r, d), a(b, kvh, c, d), a(b, kvh, c, d), a(b, qh, r, d)


def _mask(seed, shape, keep=0.7):
    return np.random.default_rng(seed).random(shape) < keep


def _bias(seed, shape, jdt=jnp.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.array(jnp.asarray(x, jdt).astype(jnp.float32))


def _segments(b, n, bounds):
    """Packed documents: segment i covers positions [bounds[i],
    bounds[i + 1]) of every row."""
    ids = np.zeros((b, n), np.int32)
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        ids[:, lo:hi] = i
    return ids


def _jax(q, k, v, do, jdt, opts, **kw):
    """o, lse and the gradients (q, k, v, and the bias when there is
    one) of sum(dO * O) through the JAX kernels."""
    qj, kj, vj = (jnp.asarray(x, jdt) for x in (q, k, v))
    ops = [None if opts.get(n) is None else jnp.asarray(opts[n])
           for n in OPTION_NAMES]
    if ops[1] is not None:
        ops[1] = ops[1].astype(jdt)
    doj = jnp.asarray(do, jnp.float32)

    def phi(q_, k_, v_, bias_):
        a = list(ops)
        a[1] = bias_
        o_ = jfa.flash_attention(q_, k_, v_, *a, **kw)
        return jnp.sum(o_.astype(jnp.float32) * doj)
    o, lse = jfa.flash_attention(qj, kj, vj, *ops, return_residuals=True,
                                 **kw)
    argnums = (0, 1, 2, 3) if ops[1] is not None else (0, 1, 2)
    grads = jax.grad(phi, argnums=argnums)(qj, kj, vj, ops[1])
    return o, lse, grads


def _torch(q, k, v, do, tdt, opts, **kw):
    leaves = [torch.as_tensor(x).to(tdt).requires_grad_(True)
              for x in (q, k, v)]
    ops = {n: None if opts.get(n) is None else torch.as_tensor(opts[n])
           for n in OPTION_NAMES}
    if ops["bias"] is not None:
        ops["bias"] = ops["bias"].to(tdt).requires_grad_(True)
        leaves.append(ops["bias"])
    o, lse = tfa.flash_attention(*leaves[:3], **ops, return_residuals=True,
                                 **kw)
    (o.float() * torch.as_tensor(do)).sum().backward()
    return o, lse, [x.grad for x in leaves]


def _compare(seed, dtype, opts, **kw):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, do = _rng_arrays(seed, jdt=jdt)
    jo, jlse, jg = _jax(q, k, v, do, jdt, opts, **kw)
    to, tlse, tg = _torch(q, k, v, do, tdt, opts, **kw)
    lse_tol = tol.lse
    if kw.get("low_precision_intermediates"):
        lse_tol = 2.0 ** -7 * (1.0 + float(np.max(np.abs(np.asarray(
            jlse, np.float32)[np.isfinite(np.asarray(jlse, np.float32))]))))
    assert to.dtype == tdt
    assert max_abs_err(to, jo) <= tol.o
    assert tlse.dtype == (torch.bfloat16 if kw.get(
        "low_precision_intermediates") else torch.float32)
    assert max_abs_err(tlse, jlse) <= lse_tol
    assert len(tg) == len(jg)
    for name, t, j in zip(("dq", "dk", "dv", "dbias"), tg, jg):
        assert t.shape == j.shape, name
        scale = max(1.0, float(np.max(np.abs(np.asarray(j, np.float32)))))
        assert max_abs_err(t, j) <= tol.grads * scale, name
    return to, tlse, tg


# (dtype, mask shape, mask2 shape, bias shape, kwargs): each mask and bias
# shape broadcasts (1) or repeats (2 over the batch of 4) as the JAX
# index maps.
OPTION_CASES = [
    ("float32", (1, 1, N, N), None, None, dict(causal=True)),
    ("bfloat16", (1, 1, N, N), None, None, dict(causal=True)),
    ("float32", (1, QH, N, N), None, (1, QH, N, N), dict(causal=True)),
    ("bfloat16", (1, QH, N, N), None, (1, QH, N, N), dict(causal=True)),
    ("float32", (2, 1, N, N), None, None, dict()),
    ("float32", (B, 1, N, N), (1, QH, N, N), None, dict(window_size=40)),
    ("float32", None, None, (B, QH, N, N),
     dict(causal=True, logit_softcap=2.0)),
    ("bfloat16", None, None, (B, QH, N, N),
     dict(causal=True, logit_softcap=2.0)),
    ("bfloat16", (1, 1, N, N), None, (1, 1, N, N),
     dict(causal=True, window_size=50, logit_softcap=5.0)),
]
# Rows whose mask gates off every key.
GATED_ROWS = (5, 77)


@pytest.mark.parametrize("dtype,mshape,m2shape,bshape,kw", OPTION_CASES)
def test_masks_and_bias_match_jax(dtype, mshape, m2shape, bshape, kw):
    """o, lse, dq, dk, dv and dbias (reduced over the bias's size-1 dims)
    with the mask, mask2 and bias options, GQA 4 over 2.  Rows that the
    mask gates off whole give o = 0 and lse = -inf in both packages, with
    finite gradients."""
    opts = {}
    if mshape is not None:
        opts["mask"] = _mask(1, mshape)
        opts["mask"][..., GATED_ROWS, :] = False
    if m2shape is not None:
        opts["mask2"] = _mask(2, m2shape, keep=0.8)
    if bshape is not None:
        opts["bias"] = _bias(3, bshape, DTYPES[dtype][0])
    to, tlse, tg = _compare(10, dtype, opts, **kw)
    if mshape is not None:
        assert torch.all(to[:, :, GATED_ROWS] == 0)
        assert torch.all(torch.isneginf(tlse[:, :, GATED_ROWS]))
    assert all(torch.isfinite(g).all() for g in tg)


def test_repeated_mask_reads_b_mod_r():
    """A mask [2, 1, N, N] over batch 4: batch b reads entry b % 2 (the
    JAX index map), not b // 2; the two entries differ, so the other
    reading moves batches 1 and 2."""
    q, k, v, _ = _rng_arrays(11)
    mask = _mask(4, (2, 1, N, N), keep=0.5)
    t = tfa.flash_attention_forward(*(torch.as_tensor(x) for x in (q, k, v)),
                                    mask=torch.as_tensor(mask))[0]
    tiled = np.concatenate([mask, mask])          # b % 2
    blocked = np.repeat(mask, 2, axis=0)          # b // 2
    want = tfa.flash_attention_forward(
        *(torch.as_tensor(x) for x in (q, k, v)),
        mask=torch.as_tensor(tiled))[0]
    other = tfa.flash_attention_forward(
        *(torch.as_tensor(x) for x in (q, k, v)),
        mask=torch.as_tensor(blocked))[0]
    assert torch.equal(t, want)
    assert max_abs_err(t, other) > 1e-2


def test_float_mask_is_read_as_int8():
    """A float mask goes through int8 first, as in JAX: 0.5 gates off,
    -3 attends."""
    q, k, v, _ = _rng_arrays(12)
    m = np.where(_mask(5, (1, 1, N, N)), -3.0, 0.5).astype(np.float32)
    got = tfa.flash_attention_forward(*(torch.as_tensor(x)
                                        for x in (q, k, v)),
                                      mask=torch.as_tensor(m))
    want = tfa.flash_attention_forward(*(torch.as_tensor(x)
                                         for x in (q, k, v)),
                                       mask=torch.as_tensor(m < 0))
    jo, _ = jfa.flash_attention_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                        mask=jnp.asarray(m))
    assert torch.equal(got[0], want[0])
    assert max_abs_err(got[0], jo) <= FP32_TOL.o


# Packed documents of every row: lengths 40, 56 and 32.
SEG_BOUNDS = (0, 40, 96, 128)


@pytest.mark.parametrize("dtype,kw", [
    ("bfloat16", dict(causal=True)),
    ("float32", dict(causal=True, window_size=24, logit_softcap=2.0)),
    ("bfloat16", dict(causal=True, window_size=24, logit_softcap=2.0)),
])
def test_packed_segments_match_jax(dtype, kw):
    ids = _segments(B, N, SEG_BOUNDS)
    _compare(14, dtype, {"q_segment_ids": ids, "kv_segment_ids": ids}, **kw)


def test_query_segment_without_keys():
    """A q segment id that no kv position carries: those rows give o = 0
    and lse = -inf in both packages, with finite gradients."""
    q_ids = _segments(B, N, SEG_BOUNDS)
    kv_ids = q_ids.copy()
    q_ids[:, 100:110] = 9
    to, tlse, tg = _compare(15, "float32", {"q_segment_ids": q_ids,
                                            "kv_segment_ids": kv_ids},
                            causal=True)
    assert torch.all(to[:, :, 100:110] == 0)
    assert torch.all(torch.isneginf(tlse[:, :, 100:110]))
    assert all(torch.isfinite(g).all() for g in tg)


def test_every_option_at_once_matches_jax():
    """mask, mask2, bias, segments, window, GQA and the cap together."""
    ids = _segments(B, N, SEG_BOUNDS)
    _compare(16, "float32", {
        "mask": _mask(7, (1, QH, N, N), keep=0.85),
        "mask2": _mask(8, (2, 1, N, N), keep=0.85),
        "bias": _bias(9, (1, 1, N, N)),
        "q_segment_ids": ids, "kv_segment_ids": ids},
        causal=True, window_size=60, logit_softcap=3.0)


def test_low_precision_intermediates_match_jax():
    """lse stored bf16, and D read as bf16 by the backward, as JAX stores
    both."""
    ids = _segments(B, N, SEG_BOUNDS)
    dtype = "bfloat16"
    _compare(17, dtype, {"q_segment_ids": ids, "kv_segment_ids": ids,
                         "bias": _bias(10, (1, QH, N, N),
                                       DTYPES[dtype][0])},
             causal=True, low_precision_intermediates=True)


def test_repeated_bias_gradient_raises_as_in_jax():
    """A bias whose batch dim repeats (2 over batch 4) has no gradient in
    either package: JAX's custom_vjp refuses dbias's [4, ...] shape, the
    port raises before computing it.  Its forward runs in both."""
    q, k, v, do = _rng_arrays(18)
    bias = _bias(11, (2, QH, N, N))
    jq, jk, jv, jb = (jnp.asarray(x) for x in (q, k, v, bias))
    with pytest.raises(ValueError):
        jax.grad(lambda b_: jnp.sum(jfa.flash_attention(
            jq, jk, jv, bias=b_) * jnp.asarray(do)))(jb)
    tb = torch.as_tensor(bias).requires_grad_(True)
    o = tfa.flash_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                            bias=tb)
    jo = jfa.flash_attention(jq, jk, jv, bias=jb)
    assert max_abs_err(o, jo) <= FP32_TOL.o
    with pytest.raises(ValueError, match="repeats"):
        (o * torch.as_tensor(do)).sum().backward()


def test_backward_entry_point_returns_dbias():
    """`flash_attention_backward` with compute_dbias, as JAX's."""
    q, k, v, do = _rng_arrays(19)
    bias = _bias(12, (1, QH, N, N))
    jq, jk, jv, jb, jdo = (jnp.asarray(x) for x in (q, k, v, bias, do))
    jo, jlse = jfa.flash_attention_forward(jq, jk, jv, bias=jb, causal=True)
    from metal_flash_attention_tpu.ops import flash_attention_bwd as jfb
    want = jfb.flash_attention_backward(jq, jk, jv, jdo, jo, jlse, bias=jb,
                                        causal=True, compute_dbias=True)
    tq, tk, tv, tb, tdo = (torch.as_tensor(x) for x in (q, k, v, bias, do))
    to, tlse = tfa.flash_attention_forward(tq, tk, tv, bias=tb, causal=True)
    got = tfb.flash_attention_backward(tq, tk, tv, tdo, to, tlse, bias=tb,
                                       causal=True, compute_dbias=True)
    assert len(got) == 4 and got[3].shape == (1, QH, N, N)
    for t, j in zip(got, want):
        assert max_abs_err(t, j) <= FP32_TOL.grads


@pytest.mark.parametrize("option,error", [
    (dict(mask2=np.ones((1, 1, N, N), bool)), "mask2 requires mask"),
    (dict(q_segment_ids=np.zeros((B, N), np.int32)), "come together"),
    (dict(mask=np.ones((3, 1, N, N), bool)), "dividing"),
    (dict(bias=np.zeros((1, 3, N, N), np.float32)), "dividing"),
])
def test_what_jax_asserts_raises(option, error):
    q, k, v, _ = _rng_arrays(20)
    with pytest.raises(ValueError, match=error):
        tfa.flash_attention(*(torch.as_tensor(x) for x in (q, k, v)),
                            **{n: torch.as_tensor(x)
                               for n, x in option.items()})
    with pytest.raises(AssertionError):
        jfa.flash_attention_forward(*(jnp.asarray(x) for x in (q, k, v)),
                                    **{n: jnp.asarray(x)
                                       for n, x in option.items()})


def test_dispatch_with_options_matches_jax_and_keys_its_cache():
    """`dispatch.attention` with options, against JAX's; each set of
    options (its descriptor's has_* flags) is a cache entry of its own."""
    q, k, v, do = _rng_arrays(21)
    ids = _segments(B, N, SEG_BOUNDS)
    mask, bias = _mask(13, (1, 1, N, N)), _bias(14, (1, QH, N, N))
    tdispatch.clear_dispatch_cache()
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    tb = torch.as_tensor(bias).requires_grad_(True)
    to = tdispatch.attention(tq, tk, tv, torch.as_tensor(mask), tb,
                             causal=True)
    assert tdispatch.cache_info()["dispatch_entries"] == 1
    tdispatch.attention(tq, tk, tv, torch.as_tensor(mask), causal=True)
    assert tdispatch.cache_info()["dispatch_entries"] == 2
    ts = tdispatch.attention(tq, tk, tv, q_segment_ids=torch.as_tensor(ids),
                             kv_segment_ids=torch.as_tensor(ids),
                             causal=True)
    assert tdispatch.cache_info()["dispatch_entries"] == 3
    tdispatch.attention(tq, tk, tv, torch.as_tensor(mask), tb, causal=True)
    assert tdispatch.cache_info()["dispatch_entries"] == 3
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jo = jdispatch.attention(jq, jk, jv, jnp.asarray(mask),
                             jnp.asarray(bias), causal=True)
    js = jdispatch.attention(jq, jk, jv, q_segment_ids=jnp.asarray(ids),
                             kv_segment_ids=jnp.asarray(ids), causal=True)
    assert max_abs_err(to, jo) <= FP32_TOL.o
    assert max_abs_err(ts, js) <= FP32_TOL.o
    (to * torch.as_tensor(do)).sum().backward()
    jdb = jax.grad(lambda b_: jnp.sum(jdispatch.attention(
        jq, jk, jv, jnp.asarray(mask), b_, causal=True)
        * jnp.asarray(do)))(jnp.asarray(bias))
    assert max_abs_err(tb.grad, jdb) <= FP32_TOL.grads


# compat.dot_product_attention, BTNH, after tests/test_compat.py.
def _btnh(seed, t, s, n=4, kh=2, h=64, b=2):
    rng = np.random.default_rng(seed)

    def a(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return a(b, t, n, h), a(b, s, kh, h), a(b, s, kh, h), a(b, t, n, h)


def _compat(seed, t, s, bias=None, mask=None, **kw):
    """Output and q, k, v (and bias) gradients of both adapters."""
    q, k, v, do = _btnh(seed, t, s)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    jex = [None if x is None else jnp.asarray(x) for x in (bias, mask)]

    def phi(q_, k_, v_, b_):
        return jnp.sum(jcompat.dot_product_attention(
            q_, k_, v_, b_, jex[1], **kw) * jnp.asarray(do))
    jo = jcompat.dot_product_attention(*jargs, *jex, **kw)
    argnums = (0, 1, 2, 3) if bias is not None else (0, 1, 2)
    jg = jax.grad(phi, argnums=argnums)(*jargs, jex[0])
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    tb = None if bias is None else torch.as_tensor(bias).requires_grad_(
        True)
    tm = None if mask is None else torch.as_tensor(mask)
    kwt = dict(kw)
    for name in ("query_seq_lengths", "key_value_seq_lengths"):
        if kwt.get(name) is not None:
            kwt[name] = torch.as_tensor(np.asarray(kwt[name]))
    to = tcompat.dot_product_attention(*leaves, tb, tm, **kwt)
    (to * torch.as_tensor(do)).sum().backward()
    tg = [x.grad for x in leaves] + ([] if tb is None else [tb.grad])
    assert to.shape == jo.shape
    assert max_abs_err(to, jo) <= FP32_TOL.o
    for t_, j in zip(tg, jg):
        assert max_abs_err(t_, j) <= FP32_TOL.grads
    return to


@pytest.mark.parametrize("t,s", [(96, 96), (48, 96)])
def test_compat_causal_matches_jax(t, s):
    """T == S on the kernels' causal path; T != S through jax.nn's
    top-left mask."""
    _compat(30, t, s, is_causal=True)


@pytest.mark.parametrize("window", [16, (16, 0)])
def test_compat_windows_match_jax(window):
    _compat(31, 96, 96, is_causal=True, local_window_size=window)


def test_compat_rectangular_causal_with_a_mask_matches_jax():
    """T != S causal beside a user mask: the mask and mask2 path."""
    mask = _mask(15, (2, 1, 48, 96), keep=0.8)
    _compat(32, 48, 96, mask=mask, is_causal=True, local_window_size=(20, 0))


def test_compat_lengths_match_jax():
    """Lengths as segment ids: a padded row attends only padding."""
    out = _compat(33, 96, 96, is_causal=True,
                  query_seq_lengths=np.array([96, 50], np.int32),
                  key_value_seq_lengths=np.array([96, 50], np.int32))
    assert torch.isfinite(out).all()


def test_compat_bias_with_mask_matches_jax():
    _compat(34, 64, 64, bias=_bias(16, (1, 4, 64, 64)),
            mask=_mask(17, (2, 4, 64, 64)))


def test_compat_right_window_without_causal_raises():
    q, k, v, _ = _btnh(35, 32, 32)
    with pytest.raises(NotImplementedError):
        jcompat.dot_product_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                      local_window_size=(4, 4))
    with pytest.raises(NotImplementedError):
        tcompat.dot_product_attention(*(torch.as_tensor(x)
                                        for x in (q, k, v)),
                                      local_window_size=(4, 4))


def test_entry_logits_match_jax():
    """`entry()` on the CPU with the JAX entry's weights carried over:
    the 2-layer tiny Llama forward's logits (bf16 weights) at MIXED_TOL."""
    import __graft_entry__

    from metal_flash_attention_tpu_torch.entry import entry
    from metal_flash_attention_tpu_torch.utils.params import (
        params_from_numpy,
    )

    jfn, (jparams, jtokens) = __graft_entry__.entry()
    fn, (params, tokens) = entry(device="cpu")
    assert tokens.shape == jtokens.shape
    assert {n: t.shape for n, t in params.items() if n != "layers"} == \
        {n: tuple(a.shape) for n, a in jparams.items() if n != "layers"}
    carried = params_from_numpy(
        jax.tree.map(lambda x: np.asarray(x, np.float32), jparams),
        device="cpu")
    got = fn(carried, torch.as_tensor(np.asarray(jtokens)))
    want = jfn(jparams, jtokens)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert max_abs_err(got, want) <= MIXED_TOL.o
