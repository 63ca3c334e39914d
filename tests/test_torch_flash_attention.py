"""Fused flash attention in the PyTorch port against the JAX package.

The same numpy inputs go through the JAX `flash_attention` (its Pallas
kernels in interpret mode, as the JAX tests run them on the CPU) under
`jax.grad`, and through the port's `flash_attention` under torch
autograd (the plain PyTorch versions, which a CPU tensor runs).  Both
compute o, lse and the gradients of sum(dO * O) w.r.t. q, k and v.

Tolerances: float32 at FP32_TOL (2e-5 everywhere); bf16 at MIXED_TOL
(o and grads 5e-2, lse 7e-3), because the JAX kernels round P and dS to
bf16 before the products that consume them while the port's plain
version stays in float32.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu import dispatch as jdispatch
from metal_flash_attention_tpu_torch import dispatch as tdispatch
from metal_flash_attention_tpu_torch.descriptors.attention_descriptor import (
    TILES_HEADER,
    AttentionDescriptor,
    AttentionKernelType,
)
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.ops import flash_attention as tfa
from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as tfb
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
)

# The module itself: the package re-exports a function of the same name.
jfa = importlib.import_module("metal_flash_attention_tpu.ops.flash_attention")
jfb = importlib.import_module(
    "metal_flash_attention_tpu.ops.flash_attention_bwd")

DTYPES = {"float32": (jnp.float32, torch.float32, FP32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, MIXED_TOL)}


def _inputs(seed, b, qh, kvh, r, c, d, jdt):
    """q, k, v, dO as float32 numpy, rounded through the working dtype
    so that both packages see the same values."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        x = rng.standard_normal(shape).astype(np.float32)
        return np.array(jnp.asarray(x, jdt).astype(jnp.float32))
    return a(b, qh, r, d), a(b, kvh, c, d), a(b, kvh, c, d), a(b, qh, r, d)


def _jax(q, k, v, do, jdt, **kw):
    qj, kj, vj = (jnp.asarray(x, jdt) for x in (q, k, v))
    doj = jnp.asarray(do, jnp.float32)

    def phi(q_, k_, v_):
        o_ = jfa.flash_attention(q_, k_, v_, **kw)
        return jnp.sum(o_.astype(jnp.float32) * doj)
    o, lse = jfa.flash_attention(qj, kj, vj, return_residuals=True, **kw)
    grads = jax.grad(phi, argnums=(0, 1, 2))(qj, kj, vj)
    return o, lse, grads


def _torch(q, k, v, do, tdt, **kw):
    leaves = [torch.as_tensor(x).to(tdt).requires_grad_(True)
              for x in (q, k, v)]
    o, lse = tfa.flash_attention(*leaves, return_residuals=True, **kw)
    (o.float() * torch.as_tensor(do)).sum().backward()
    return o, lse, [x.grad for x in leaves]


def _compare(q, k, v, do, dtype, **kw):
    jdt, tdt, tol = DTYPES[dtype]
    jo, jlse, jg = _jax(q, k, v, do, jdt, **kw)
    to, tlse, tg = _torch(q, k, v, do, tdt, **kw)
    assert to.dtype == tdt
    assert max_abs_err(to, jo) <= tol.o
    assert max_abs_err(tlse, jlse) <= tol.lse
    for name, t, j in zip(("dq", "dk", "dv"), tg, jg):
        assert t.dtype == tdt, name
        assert max_abs_err(t, j) <= tol.grads, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,c,d", [(128, 128, 64), (93, 77, 32),
                                   (250, 123, 64)])
def test_causal_forward_and_grads_match_jax(dtype, r, c, d):
    q, k, v, do = _inputs(0, 1, 2, 2, r, c, d, DTYPES[dtype][0])
    _compare(q, k, v, do, dtype, causal=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_matches_jax(dtype):
    q, k, v, do = _inputs(1, 2, 4, 2, 128, 128, 64, DTYPES[dtype][0])
    _compare(q, k, v, do, dtype, causal=True)


@pytest.mark.parametrize("causal", [True, False])
def test_window_matches_jax(causal):
    q, k, v, do = _inputs(2, 1, 4, 2, 160, 200, 64, jnp.float32)
    _compare(q, k, v, do, "float32", causal=causal, window_size=37)


def test_non_causal_scale_and_out_dtype_match_jax():
    q, k, v, do = _inputs(3, 1, 2, 1, 70, 130, 32, jnp.bfloat16)
    jo, jlse, _ = _jax(q, k, v, do, jnp.bfloat16, scale=0.3,
                       out_dtype=jnp.float32)
    to, tlse, _ = _torch(q, k, v, do, torch.bfloat16, scale=0.3,
                         out_dtype=torch.float32)
    assert to.dtype == torch.float32 and jo.dtype == jnp.float32
    assert max_abs_err(to, jo) <= MIXED_TOL.o
    assert max_abs_err(tlse, jlse) <= MIXED_TOL.lse


def test_rows_that_see_no_key():
    """Causal with q_len > kv_len: the first q_len - kv_len rows see
    nothing.  Both packages give o = 0 and lse = -inf there, and every
    gradient is finite, zero for those rows' queries."""
    q, k, v, do = _inputs(4, 1, 2, 2, 250, 123, 64, jnp.float32)
    to, tlse, tg = _torch(q, k, v, do, torch.float32, causal=True)
    jo, jlse, _ = _jax(q, k, v, do, jnp.float32, causal=True)
    blind = 250 - 123
    assert torch.all(to[:, :, :blind] == 0)
    assert torch.all(torch.isneginf(tlse[:, :, :blind]))
    assert np.all(np.isneginf(np.asarray(jlse)[:, :, :blind]))
    assert torch.all(tg[0][:, :, :blind] == 0)
    for g in tg:
        assert torch.isfinite(g).all()


def test_backward_reads_the_residuals_it_is_given():
    """`flash_attention_backward` with the o and lse of q against a
    longer key set (the block's 64 keys and 64 more: a ring step's
    global residuals) recomputes P from that lse and D from that o, as
    the JAX backward and the port's kernels do, and not from the block's
    own forward."""
    q, k, v, do = _inputs(5, 1, 2, 2, 64, 64, 64, jnp.float32)
    _, more_k, more_v, _ = _inputs(6, 1, 2, 2, 64, 64, 64, jnp.float32)
    kk = np.concatenate([k, more_k], axis=2)
    vv = np.concatenate([v, more_v], axis=2)
    o, lse = jfa.flash_attention_forward(jnp.asarray(q), jnp.asarray(kk),
                                         jnp.asarray(vv))
    o, lse = np.array(o), np.array(lse)
    jgrads = jfb.flash_attention_backward(*(jnp.asarray(x) for x in (
        q, k, v, do, o, lse)))
    tgrads = tfb.flash_attention_backward(*(torch.as_tensor(x) for x in (
        q, k, v, do, o, lse)))
    for name, t, j in zip(("dq", "dk", "dv"), tgrads, jgrads):
        assert max_abs_err(t, j) <= FP32_TOL.grads, name


@pytest.fixture
def force_dynamic():
    """Route the JAX forward through its visible-blocks-only kernel
    (`_make_fwd_kernel_dynamic`) at a small shape."""
    jfa._FORCE_DYNAMIC = True
    yield
    jfa._FORCE_DYNAMIC = None


@pytest.mark.parametrize("n,c,window", [(256, 384, None), (384, 384, 100)])
def test_dynamic_traversal_forward_matches_jax(force_dynamic, n, c, window):
    """The JAX kernel of row 3 (called un-jitted, so the override is
    seen) against the port's forward, which has one kernel for rows 2
    and 3."""
    q, k, v, _ = _inputs(5, 1, 4, 2, n, c, 64, jnp.float32)
    jo, jlse = jfa.flash_attention_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window_size=window, block_q=128, block_kv=128)
    to, tlse = tfa.flash_attention_forward(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        causal=True, window_size=window)
    assert max_abs_err(to, jo) <= FP32_TOL.o
    assert max_abs_err(tlse, jlse) <= FP32_TOL.lse


def test_dispatch_matches_jax_and_caches():
    """One cache entry serves every length of the same options (a decode
    loop's growing kv_len); other options get their own."""
    q, k, v, _ = _inputs(6, 1, 4, 2, 64, 64, 32, jnp.float32)
    tdispatch.clear_dispatch_cache()
    tq, tk, tv = (torch.as_tensor(x) for x in (q, k, v))
    to = tdispatch.attention(tq, tk, tv, causal=True)
    tdispatch.attention(tq[:, :, :8], tk[:, :, :40], tv[:, :, :40],
                        causal=True)
    assert tdispatch.cache_info()["dispatch_entries"] == 1
    tdispatch.attention(tq, tk, tv, causal=False)
    assert tdispatch.cache_info()["dispatch_entries"] == 2
    jo = jdispatch.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True)
    assert max_abs_err(to, jo) <= FP32_TOL.o
    # The soft cap (ported with Gemma-2) is an option of its own.
    tc = tdispatch.attention(tq, tk, tv, causal=True, logit_softcap=3.0)
    assert tdispatch.cache_info()["dispatch_entries"] == 3
    jc = jdispatch.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=True, logit_softcap=3.0)
    assert max_abs_err(tc, jc) <= FP32_TOL.o


def test_dispatch_differentiates_the_cap_as_jax():
    """`dispatch.attention`, the models' route, keeps the soft cap on the
    differentiable path: its gradients with the cap and a window equal
    jax.grad of the JAX dispatch's."""
    q, k, v, do = _inputs(7, 1, 4, 2, 90, 90, 64, jnp.float32)
    q = q * 4.0
    kw = dict(causal=True, window_size=50, logit_softcap=2.0)
    leaves = [torch.as_tensor(x).requires_grad_(True) for x in (q, k, v)]
    (tdispatch.attention(*leaves, **kw) * torch.as_tensor(do)).sum() \
        .backward()
    jgrads = jax.grad(lambda *a: jnp.sum(jdispatch.attention(*a, **kw)
                                         * jnp.asarray(do)),
                      argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    for leaf, j in zip(leaves, jgrads):
        assert max_abs_err(leaf.grad, j) <= FP32_TOL.grads


def test_descriptor_resolves_the_kernel_tiles():
    """kernel_config returns the tiles that csrc/flash_tiles.cuh defines
    for the kernels."""
    desc = AttentionDescriptor(
        q_heads=32, kv_heads=8, q_len=8192, kv_len=8192, head_dim=128,
        input_precision=OperandPrecision.BF16, causal=True)
    with open(TILES_HEADER) as f:
        header = f.read()
    for kind, prefix in ((AttentionKernelType.FORWARD, "FWD90"),
                         (AttentionKernelType.BACKWARD_QUERY, "BWD90_DQ"),
                         (AttentionKernelType.BACKWARD_KEY_VALUE,
                          "BWD90_DKV")):
        cfg = desc.kernel_config(kind)
        assert f"#define MFA_{prefix}_BLOCK_Q {cfg.block_q} " in header
        assert f"#define MFA_{prefix}_BLOCK_KV {cfg.block_kv} " in header
        assert cfg.block_q % 16 == 0 and cfg.block_kv % 16 == 0
        assert cfg.compute_dtype == torch.bfloat16
        assert cfg.accumulator_dtype == torch.float32
    assert desc.resolved_scale == pytest.approx(128 ** -0.5)
    assert hash(desc) == hash(AttentionDescriptor(**desc.__dict__))


def test_precision_members_match_jax():
    from metal_flash_attention_tpu.descriptors.precision import (
        OperandPrecision as JaxPrecision,
    )
    assert [(p.name, p.value, p.bits, p.is_quantized)
            for p in OperandPrecision] == \
        [(p.name, p.value, p.bits, p.is_quantized) for p in JaxPrecision]
    for dtype in (torch.float32, torch.float16, torch.bfloat16, torch.int8):
        assert OperandPrecision.from_dtype(dtype).storage_dtype == dtype


class _Quantized:
    """Stands in for a QuantizedTensor: K/V that are neither tensors nor
    QuantizedTensors."""
    precision = OperandPrecision.INT8


# Gemma-2's forward options: the soft cap (the model's 50; 2 over queries
# scaled by 4, where the tanh saturates) at head dims 64 and 256, causal,
# with and without its local layers' window.
SOFTCAP_CASES = [
    # (b, qh, kvh, r, c, d, window, q_gain, cap)
    (1, 4, 2, 128, 128, 64, None, 1.0, 50.0),
    (1, 4, 2, 93, 160, 64, 40, 4.0, 2.0),
    (1, 4, 2, 130, 130, 256, None, 4.0, 2.0),
    (1, 2, 1, 100, 140, 256, 64, 1.0, 50.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SOFTCAP_CASES)
def test_softcap_forward_matches_jax(case, dtype):
    """The capped forward against the JAX kernel (interpret mode) at the
    dtype's tier; at a saturating cap the capped output differs from the
    uncapped one by far more than the tier.  In bf16 the lse is held
    against the port's float32 forward on the same inputs (the JAX
    kernel's bf16 rounding of q * scale * log2(e) moves it by about 1e-2
    at head_dim 256 with queries scaled by 4)."""
    b, qh, kvh, r, c, d, window, gain, cap = case
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v, _ = _inputs(7, b, qh, kvh, r, c, d, jdt)
    q = np.array(jnp.asarray(q * gain, jdt).astype(jnp.float32))
    kw = dict(causal=True, window_size=window, logit_softcap=cap)
    jo, jlse = jfa.flash_attention_forward(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), **kw)
    tq, tk, tv = (torch.as_tensor(x).to(tdt) for x in (q, k, v))
    to, tlse = tfa.flash_attention_forward(tq, tk, tv, **kw)
    assert to.dtype == tdt
    assert max_abs_err(to, jo) <= tol.o
    if tdt == torch.float32:
        assert max_abs_err(tlse, jlse) <= tol.lse
    else:
        _, flse = tfa.flash_attention_forward(tq.float(), tk.float(),
                                              tv.float(), **kw)
        assert max_abs_err(tlse, flse) <= tol.lse
    # Without a graph to build, flash_attention is the same forward.
    assert torch.equal(tfa.flash_attention(tq, tk, tv, **kw), to)
    if cap < 10:
        uo, _ = tfa.flash_attention_forward(tq, tk, tv, causal=True,
                                            window_size=window)
        assert max_abs_err(uo, to) > 10 * tol.o


def test_softcap_dynamic_traversal_matches_jax(force_dynamic):
    """Row 3's JAX kernel with the soft cap at head_dim 256."""
    q, k, v, _ = _inputs(8, 1, 2, 1, 256, 256, 256, jnp.float32)
    q = q * 4.0
    jo, jlse = jfa.flash_attention_forward(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window_size=100, logit_softcap=2.0, block_q=128, block_kv=128)
    to, tlse = tfa.flash_attention_forward(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        causal=True, window_size=100, logit_softcap=2.0)
    assert max_abs_err(to, jo) <= FP32_TOL.o
    assert max_abs_err(tlse, jlse) <= FP32_TOL.lse


# Gemma-2's backward: the soft cap at the model's 50 and at 2 over
# queries scaled by 4 (the tanh saturates, so 1 - t^2 is far from 1),
# causal, with a window and GQA group 2, at ragged lengths.
BWD_SOFTCAP_CASES = [
    # (b, qh, kvh, r, c, d, window, q_gain, cap)
    (1, 2, 2, 128, 128, 64, None, 1.0, 50.0),
    (1, 4, 2, 93, 160, 64, 40, 4.0, 2.0),
    (1, 4, 2, 77, 77, 32, None, 4.0, 2.0),
    (1, 2, 1, 100, 70, 64, 33, 1.0, 50.0),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", BWD_SOFTCAP_CASES)
def test_softcap_grads_match_jax(dtype, case):
    """o, lse, dq, dk and dv with the soft cap against jax.grad of the
    JAX kernels (the capped backward, ops/flash_attention_bwd.py:156-159,
    :194-196, :310-313, :359-360)."""
    b, qh, kvh, r, c, d, window, gain, cap = case
    q, k, v, do = _inputs(20, b, qh, kvh, r, c, d, DTYPES[dtype][0])
    _compare(q * gain, k, v, do, dtype, causal=True, window_size=window,
             logit_softcap=cap)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,c,window,cap", [(96, 96, None, None),
                                            (80, 96, 40, 50.0)])
def test_head_dim_256_grads_match_jax(dtype, r, c, window, cap):
    """Gemma-2's head_dim 256 in the backward (the JAX kernels pad D to
    128 lanes, :433), with and without its cap."""
    q, k, v, do = _inputs(21, 1, 2, 1, r, c, 256, DTYPES[dtype][0])
    _compare(q, k, v, do, dtype, causal=True, window_size=window,
             logit_softcap=cap)


def test_softcap_reference_grads_are_autograd_of_the_reference():
    """The plain version's chain factor 1 - tanh^2: the analytic
    gradients equal autograd through `attention_reference` with the cap,
    saturating (cap 2, queries x4), GQA and a window."""
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
        attention_reference_grads,
    )

    q, k, v, do = (torch.as_tensor(x) for x in
                   _inputs(22, 1, 4, 2, 50, 60, 32, jnp.float32))
    q = (q * 4.0).requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    kw = dict(causal=True, window_size=20, logit_softcap=2.0)
    o = attention_reference(q, k, v, **kw)
    want = torch.autograd.grad((o * do).sum(), (q, k, v))
    got = attention_reference_grads(q, k, v, do, **kw)[:3]
    for g, w in zip(got, want):
        assert max_abs_err(g, w) <= FP32_TOL.grads


def test_quantized_kv_raises():
    """Quantized K/V is ported: a QuantizedTensor pair runs the forward
    (held against JAX in tests/test_torch_flash_attention_quantized.py);
    what still raises is K/V that are not a tensor pair or a
    QuantizedTensor pair, and the backward over quantized K/V."""
    from metal_flash_attention_tpu_torch.ops.quantization import quantize

    q = torch.randn(1, 2, 8, 32)
    k = quantize(torch.randn(1, 1, 8, 32), OperandPrecision.INT8)
    o = tfa.flash_attention(q, k, k, causal=True)
    assert o.shape == q.shape and torch.isfinite(o).all()
    with pytest.raises(TypeError, match="both"):
        tfa.flash_attention(q, _Quantized(), _Quantized())
    with pytest.raises(TypeError, match="not differentiated"):
        tfb.flash_attention_backward(q, k, k, q, q, q[..., 0])


def test_cpu_tensors_never_build_a_kernel():
    """fp32, an odd head dim and fp16 all run the plain version on the
    CPU (only the kernels refuse them) and nothing is built or
    launched."""
    fwd, bwd = dict(tfa.LAUNCH_COUNTS), dict(tfb.LAUNCH_COUNTS)
    for dtype, d in ((torch.float32, 48), (torch.float16, 64)):
        q = torch.randn(1, 2, 16, d).to(dtype).requires_grad_(True)
        k = torch.randn(1, 1, 16, d).to(dtype).requires_grad_(True)
        o = tfa.flash_attention(q, k, k, causal=True)
        o.float().sum().backward()
        assert o.dtype == dtype and q.grad.dtype == dtype
    assert tfa._kernel_library.cache_info().currsize == 0
    assert tfb._kernel_library.cache_info().currsize == 0
    assert dict(tfa.LAUNCH_COUNTS) == fwd and dict(tfb.LAUNCH_COUNTS) == bwd
