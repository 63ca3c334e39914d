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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tdispatch.attention(tq, tk, tv, logit_softcap=30.0)


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
    """Stands in for a QuantizedTensor: K/V that are not plain tensors."""
    precision = OperandPrecision.INT8


@pytest.mark.parametrize("option", [
    dict(mask=torch.ones(1, 1, 8, 8, dtype=torch.bool)),
    dict(bias=torch.zeros(1, 1, 8, 8)),
    dict(q_segment_ids=torch.zeros(1, 8, dtype=torch.int32),
         kv_segment_ids=torch.zeros(1, 8, dtype=torch.int32)),
    dict(logit_softcap=30.0),
    dict(low_precision_intermediates=True),
])
def test_unported_options_raise_on_every_device(option):
    q = torch.zeros(1, 2, 8, 32)
    k = torch.zeros(1, 1, 8, 32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfa.flash_attention(q, k, k, **option)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfa.flash_attention_forward(q, k, k, **option)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfb.flash_attention_backward(q, k, k, q, q, q[..., 0], **option)


def test_quantized_kv_raises():
    with pytest.raises(NotImplementedError, match="quantized KV"):
        tfa.flash_attention(torch.zeros(1, 2, 8, 32), _Quantized(),
                            _Quantized())


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
