"""Quantized operands in the PyTorch port against the JAX package.

The same numpy inputs go through both packages' `quantize_matrix`,
`dequantize_matrix`, `quantize` and `dequantize`.  Payloads must agree
bit for bit (INT8 round-half-even then clip to +-127; FP8 the cast after
scaling to 448 or 57344; NF4 the left searchsorted on the codebook's
midpoints, K padded to whole 512-groups by zeros), scales exactly, and
the dequantized values exactly (the same float32 products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.descriptors.precision import (
    OperandPrecision as JP,
)
from metal_flash_attention_tpu.ops import quantization as jq
from metal_flash_attention_tpu.ops.gemm import gemm as jax_gemm
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision as TP,
)
from metal_flash_attention_tpu_torch.ops import quantization as tq
from metal_flash_attention_tpu_torch.utils.params import (
    quantized_matrix_from_numpy,
)

PRECISIONS = ["int8", "fp8_e4m3", "fp8_e5m2", "nf4"]


def _bits(x) -> np.ndarray:
    """A payload's bytes, from either package."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _matrix(seed, shape):
    rng = np.random.default_rng(seed)
    # Columns of very different magnitudes, so per-channel scales differ.
    mag = np.exp(rng.uniform(-3, 3, (1, shape[1]))).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32) * mag


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("shape,contract_axis", [
    ((256, 384), 0), ((192, 512), 1), ((200, 96), 0), ((64, 200), 1)])
def test_quantize_matrix_payload_is_bit_equal(precision, per_channel, shape,
                                              contract_axis):
    x = _matrix(0, shape)
    j = jq.quantize_matrix(jnp.asarray(x), JP(precision),
                           contract_axis=contract_axis,
                           per_channel=per_channel)
    t = tq.quantize_matrix(torch.from_numpy(x), TP(precision),
                           contract_axis=contract_axis,
                           per_channel=per_channel)
    assert t.values.dtype == TP(precision).storage_dtype
    assert tuple(t.values.shape) == tuple(j.values.shape)
    assert t.shape == tuple(j.shape)
    diff = int(np.sum(_bits(t.values) != _bits(j.values)))
    assert diff == 0, f"{diff} payload codes differ"
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("contract_axis", [0, 1])
def test_dequantize_matrix_matches_jax(precision, contract_axis):
    """One NF4 group or less along K (the JAX host function's range)."""
    shape = (200, 96) if contract_axis == 0 else (96, 512)
    j = jq.quantize_matrix(jnp.asarray(_matrix(1, shape)), JP(precision),
                           contract_axis=contract_axis, per_channel=True)
    t = quantized_matrix_from_numpy(*[np.asarray(v) for v in j[:2]],
                                    j.precision, j.shape, device="cpu")
    got = tq.dequantize_matrix(t, contract_axis=contract_axis)
    want = np.asarray(jq.dequantize_matrix(j, contract_axis=contract_axis))
    assert tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("contract_axis", [0, 1])
def test_nf4_dequantize_over_several_groups_follows_the_jax_kernel(
        contract_axis):
    """K = 1,100 spans three NF4 groups.  The JAX host `dequantize_matrix`
    concatenates the payload's two nibble planes whole, which orders K
    right for one group only; the JAX GEMM kernel reads a group a block.
    The port's dequantize is held against that kernel: the product with
    an identity in float32 registers returns the operand's values
    exactly."""
    k, other = 1100, 64
    shape = (k, other) if contract_axis == 0 else (other, k)
    x = _matrix(2, shape)
    j = jq.quantize_matrix(jnp.asarray(x), JP.NF4,
                           contract_axis=contract_axis, per_channel=True)
    t = tq.quantize_matrix(torch.from_numpy(x), TP.NF4,
                           contract_axis=contract_axis, per_channel=True)
    assert np.array_equal(_bits(t.values), _bits(j.values))
    got = tq.dequantize_matrix(t, contract_axis=contract_axis).numpy()
    eye = jnp.eye(k, dtype=jnp.float32)
    if contract_axis == 0:
        want = jax_gemm(eye, j, out_dtype=jnp.float32)
    else:
        want = jax_gemm(j, eye, out_dtype=jnp.float32)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=0)
    # Quantization error stays within half of the codebook's widest gap.
    s = np.asarray(j.scale)
    s = s[None, :] if contract_axis == 0 else s[:, None]
    assert np.max(np.abs(got - x) / s) <= 0.16


def test_nf4_pads_k_to_whole_groups():
    x = _matrix(3, (200, 32))
    t = tq.quantize_matrix(torch.from_numpy(x), TP.NF4, contract_axis=0)
    assert tuple(t.values.shape) == (256, 32)
    # Rows 200..255 of the low plane and all of the high plane are the
    # code of 0.0 (index 7).
    lo, hi = t.values & 0x0F, t.values >> 4
    assert (lo[200:] == 7).all() and (hi == 7).all()


@pytest.mark.parametrize("precision", PRECISIONS)
def test_kv_quantize_and_dequantize_match_jax(precision):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((2, 3, 40, 64)) * 3).astype(np.float32)
    j = jq.quantize(jnp.asarray(x), JP(precision))
    t = tq.quantize(torch.from_numpy(x), TP(precision))
    assert tuple(t.values.shape) == tuple(j.values.shape)
    assert np.array_equal(_bits(t.values), _bits(j.values))
    np.testing.assert_array_equal(t.scales.numpy(), np.asarray(j.scales))
    np.testing.assert_array_equal(tq.dequantize(t).numpy(),
                                  np.asarray(jq.dequantize(j)))


def test_quantized_matrix_from_numpy_keeps_the_bits():
    x = _matrix(5, (64, 48))
    for precision in PRECISIONS:
        j = jq.quantize_matrix(jnp.asarray(x), JP(precision),
                               contract_axis=0)
        t = quantized_matrix_from_numpy(np.asarray(j.values),
                                        np.asarray(j.scale), j.precision,
                                        j.shape, device="cpu")
        assert t.precision is TP(precision)
        assert t.values.dtype == TP(precision).storage_dtype
        assert np.array_equal(_bits(t.values), _bits(j.values))
        assert t.scale.dtype == torch.float32 and t.scale.dim() == 0
    with pytest.raises(ValueError):
        quantized_matrix_from_numpy(np.zeros((2, 2), np.float32), 1.0,
                                    "bf16", (2, 2), device="cpu")
