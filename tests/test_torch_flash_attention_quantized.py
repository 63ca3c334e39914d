"""The fused forward over quantized K/V in the PyTorch port against the
JAX package.

The same JAX-made payloads (`ops.quantization.quantize` in INT8,
FP8-E4M3, FP8-E5M2 and NF4 split-half along D, one scale per (batch, kv
head)) go through the JAX `flash_attention_forward` (its Pallas kernel
in interpret mode, as the JAX tests run it on the CPU) and, carried
across by `utils.params.quantized_tensor_from_numpy`, through the port's
plain version (`_forward_plain_quantized`, what a CPU tensor runs):
causal and not, q_len below kv_len, a window, GQA group 4, D 64, two
batches whose scales differ.

Tolerances: float32 queries at FP32_TOL, FP8 at FP32_TOL + 2^-14 *
absmax (the JAX kernel expands FP8 subnormals into float32 subnormals
that XLA flushes to zero; the port decodes them exactly); bf16 queries
at MIXED_TOL (the JAX kernel rounds the dequantized tile and q * scale *
log2(e) to bf16, the plain version stays in float32).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu import dispatch as jdispatch
from metal_flash_attention_tpu.descriptors.precision import (
    OperandPrecision as JP,
)
from metal_flash_attention_tpu.ops import quantization as jq
from metal_flash_attention_tpu_torch import dispatch as tdispatch
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision as TP,
)
from metal_flash_attention_tpu_torch.ops import flash_attention as tfa
from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as tfb
from metal_flash_attention_tpu_torch.ops import quantization as tq
from metal_flash_attention_tpu_torch.utils.params import (
    quantized_tensor_from_numpy,
)
from metal_flash_attention_tpu_torch.utils.tolerances import (
    max_abs_err,
    tolerances_for,
)

# The module itself: the package re-exports a function of the same name.
jfa = importlib.import_module("metal_flash_attention_tpu.ops.flash_attention")

PRECISIONS = ["int8", "fp8_e4m3", "fp8_e5m2", "nf4"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# (causal, window): masks of the forward, at q_len 24 against kv_len 40.
MASKS = {"causal": (True, None), "full": (False, None),
         "window": (True, 13)}
B, QH, KVH, Q_LEN, KV_LEN, D = 2, 8, 2, 24, 40, 64


def _operands(precision, jdt, seed=0):
    """q as float32 numpy (rounded through the working dtype), the JAX
    payloads, and the port's copies of them."""
    rng = np.random.default_rng(seed)
    q = np.array(jnp.asarray(rng.standard_normal((B, QH, Q_LEN, D)), jdt)
                 .astype(jnp.float32))
    # K/V of at most unit scale (the JAX kernel's bf16 rounding of q *
    # scale * log2(e) grows with the scores), their magnitudes apart so
    # that the scales differ between heads and batches.
    mag = np.array([[1.0, 0.5], [0.8, 0.65]], np.float32)[:, :, None, None]
    jk, jv = (jq.quantize(jnp.asarray(
        rng.standard_normal((B, KVH, KV_LEN, D)).astype(np.float32) * mag),
        JP(precision)) for _ in range(2))
    tk, tv = (quantized_tensor_from_numpy(x, device="cpu") for x in (jk, jv))
    return q, jk, jv, tk, tv


def _tolerances(tdt, precision, absmax):
    tol = tolerances_for(tdt)
    extra = (2.0 ** -14 * absmax if tdt == torch.float32
             and precision.startswith("fp8") else 0.0)
    return tol.o + extra, tol.lse + extra


@pytest.mark.parametrize("mask", list(MASKS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("precision", PRECISIONS)
def test_quantized_forward_matches_jax(precision, dtype, mask):
    jdt, tdt = DTYPES[dtype]
    causal, window = MASKS[mask]
    q, jk, jv, tk, tv = _operands(precision, jdt)
    for jt, tt in ((jk, tk), (jv, tv)):
        assert tt.precision is TP(precision)
        assert np.array_equal(
            tt.values.view(torch.uint8).numpy(),
            np.asarray(jt.values).view(np.uint8))
        assert np.array_equal(tt.scales.numpy(), np.asarray(jt.scales))
    jo, jl = jfa.flash_attention_forward(
        jnp.asarray(q, jdt), jk, jv, causal=causal, window_size=window)
    to, tl = tfa.flash_attention_forward(
        torch.from_numpy(q).to(tdt), tk, tv, causal=causal,
        window_size=window)
    assert to.dtype == tdt and tuple(to.shape) == (B, QH, Q_LEN, D)
    absmax = max(float(jnp.max(jnp.abs(jq.dequantize(x))))
                 for x in (jk, jv))
    tol_o, tol_lse = _tolerances(tdt, precision, absmax)
    assert max_abs_err(to, np.asarray(jo.astype(jnp.float32))) < tol_o
    assert max_abs_err(tl, np.asarray(jl)) < tol_lse


@pytest.mark.parametrize("precision", ["int8", "nf4"])
def test_dispatch_attention_takes_quantized_kv(precision):
    """`dispatch.attention` reads kv_heads and kv_len from the payload,
    sets the descriptor's kv_precision, and returns the forward (no
    graph), as JAX's does."""
    q, jk, jv, tk, tv = _operands(precision, jnp.bfloat16, seed=1)
    qt = torch.from_numpy(q).to(torch.bfloat16).requires_grad_(True)
    tdispatch.clear_dispatch_cache()
    o, lse = tdispatch.attention(qt, tk, tv, causal=True,
                                 return_residuals=True)
    jo, jl = jdispatch.attention(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                 causal=True, return_residuals=True)
    assert o.grad_fn is None and not o.requires_grad
    assert max_abs_err(o, np.asarray(jo.astype(jnp.float32))) < 5e-2
    assert max_abs_err(lse, np.asarray(jl)) < 7e-3
    (desc,) = tdispatch._DISPATCH_CACHE
    assert desc.kv_precision is TP(precision) and desc.quantized_kv
    assert (desc.kv_heads, desc.head_dim) == (KVH, D)
    # A second call at another kv_len reuses the entry.
    tdispatch.attention(qt, tk._replace(values=tk.values[:, :, :30]),
                        tv._replace(values=tv.values[:, :, :30]),
                        causal=True)
    assert tdispatch.cache_info()["dispatch_entries"] == 1


def test_flash_attention_over_quantized_kv_is_the_forward():
    """`flash_attention` with quantized K/V returns the forward with no
    graph; the plain version equals attention over the dequantized K/V,
    NF4's codebook rounded to the queries' type."""
    q, _, _, tk, tv = _operands("nf4", jnp.bfloat16, seed=2)
    qt = torch.from_numpy(q).to(torch.bfloat16).requires_grad_(True)
    o = tfa.flash_attention(qt, tk, tv, causal=True)
    o2, lse = tfa.flash_attention(qt, tk, tv, causal=True,
                                  return_residuals=True)
    assert o.grad_fn is None and torch.equal(o, o2)
    want, want_lse = tfa._forward_plain(
        qt.detach(), tq.dequantize(tk, torch.bfloat16),
        tq.dequantize(tv, torch.bfloat16), causal=True, window_size=None,
        scale=D ** -0.5, out_dtype=torch.bfloat16)
    assert torch.equal(o, want) and torch.equal(lse, want_lse)
    # fp16 queries take the plain version on the CPU (only the kernel
    # refuses them).
    o16 = tfa.flash_attention_forward(qt.detach().half(), tk, tv)[0]
    assert o16.dtype == torch.float16 and torch.isfinite(o16).all()


def test_quantized_kv_is_checked():
    q = torch.zeros(1, 2, 8, 32)
    k = tq.quantize(torch.randn(1, 1, 8, 32), TP.INT8)
    with pytest.raises(TypeError, match="both"):
        tfa.flash_attention_forward(q, k, torch.zeros(1, 1, 8, 32))
    with pytest.raises(TypeError, match="both"):
        tfa.flash_attention(q, k, tq.quantize(torch.randn(1, 1, 8, 32),
                                              TP.FP8_E4M3))
    with pytest.raises(ValueError, match="expected q"):
        tfa.flash_attention_forward(torch.zeros(1, 2, 8, 16), k, k)
    with pytest.raises(TypeError, match="not differentiated"):
        tfb.flash_attention_backward(q, k, k, q, q, q[..., 0])
    # The CPU builds no library for them.
    before = dict(tfa.LAUNCH_COUNTS)
    tfa.flash_attention_forward(q, k, k, causal=True)
    assert tfa._kernel_library.cache_info().currsize == 0
    assert dict(tfa.LAUNCH_COUNTS) == before
