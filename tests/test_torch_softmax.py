"""The standalone softmax ops in the PyTorch port against the JAX
package.

The same numpy inputs go through the JAX `scaled_softmax` and
`derivative_softmax` (their Pallas kernels in interpret mode, as the JAX
tests run them on the CPU) and the port's plain PyTorch versions, at the
shapes of `tests/test_softmax_ops.py`.  Tolerances: float32 at that
file's own tiers (2e-6 for the softmax, 1e-5 for the derivative); bf16
at one bf16 rounding of the output (2^-8 relative, as an absolute bound
on values within [-1, 1] for P, and relative to max |dS| for the
derivative).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.ops.softmax import (
    derivative_softmax as jax_derivative_softmax,
    scaled_softmax as jax_scaled_softmax,
)
from metal_flash_attention_tpu_torch.ops import softmax as ts

BF16_REL = 2.0 ** -8


def _pair(x, dtype):
    j = jnp.asarray(x, dtype)
    t = torch.from_numpy(np.array(j.astype(jnp.float32)))
    return j, t.to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("rows,cols", [(8, 128), (100, 100), (257, 777),
                                       (512, 512)])
def test_scaled_softmax_matches_jax(rows, cols):
    x = np.random.default_rng(0).standard_normal((rows, cols))
    j, t = _pair(x, jnp.float32)
    got = ts.scaled_softmax(t)
    assert got.dtype == torch.float32
    assert np.max(np.abs(_np(got) - _np(jax_scaled_softmax(j)))) < 2e-6


def test_scaled_softmax_batched_custom_scale():
    x = np.random.default_rng(1).standard_normal((2, 3, 64, 200))
    j, t = _pair(x, jnp.float32)
    got = ts.scaled_softmax(t, scale=0.25, block_rows=64)
    assert got.shape == t.shape
    want = jax_scaled_softmax(j, scale=0.25)
    assert np.max(np.abs(_np(got) - _np(want))) < 2e-6


def test_scaled_softmax_extreme_logits():
    x = np.random.default_rng(2).standard_normal((16, 256)) * 1e4
    j, t = _pair(x, jnp.float32)
    got = ts.scaled_softmax(t, scale=1.0)
    assert torch.isfinite(got).all()
    assert float((got.sum(-1) - 1).abs().max()) < 1e-5
    assert np.max(np.abs(_np(got) - _np(jax_scaled_softmax(j, scale=1.0)))) \
        < 2e-6


@pytest.mark.parametrize("shape", [(3, 40, 300), (64, 1000)])
def test_scaled_softmax_bf16(shape):
    x = np.random.default_rng(3).standard_normal(shape) * 4
    j, t = _pair(x, jnp.bfloat16)
    got = ts.scaled_softmax(t)
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(_np(got) - _np(jax_scaled_softmax(j)))) <= BF16_REL


def test_derivative_softmax_matches_jax():
    rng = np.random.default_rng(4)
    s = rng.standard_normal((64, 300)).astype(np.float32)
    dp = rng.standard_normal((64, 300))
    p = np.asarray(jnp.exp(s) / jnp.sum(jnp.exp(s), -1, keepdims=True))
    (jp, tp), (jdp, tdp) = _pair(p, jnp.float32), _pair(dp, jnp.float32)
    got = ts.derivative_softmax(tp, tdp, scale=0.5)
    want = jax_derivative_softmax(jp, jdp, scale=0.5)
    assert got.dtype == torch.float32
    assert np.max(np.abs(_np(got) - _np(want))) < 1e-5


@pytest.mark.parametrize("shape", [(2, 50, 777), (128, 256)])
def test_derivative_softmax_bf16(shape):
    rng = np.random.default_rng(5)
    p = rng.dirichlet(np.ones(shape[-1]), size=shape[:-1])
    dp = rng.standard_normal(shape)
    (jp, tp), (jdp, tdp) = _pair(p, jnp.bfloat16), _pair(dp, jnp.bfloat16)
    got = ts.derivative_softmax(tp, tdp, scale=0.125)
    want = _np(jax_derivative_softmax(jp, jdp, scale=0.125))
    assert got.dtype == torch.bfloat16
    assert np.max(np.abs(_np(got) - want)) <= BF16_REL * np.abs(want).max()


def test_no_launch_and_no_library_on_the_cpu(monkeypatch):
    def refuse():
        raise AssertionError("the CPU path asked for the CUDA library")
    monkeypatch.setattr(ts, "_kernel_library", refuse)
    before = dict(ts.LAUNCH_COUNTS)
    s = torch.randn(4, 33)
    ts.derivative_softmax(ts.scaled_softmax(s), torch.randn(4, 33))
    assert ts.LAUNCH_COUNTS == before
    with pytest.raises(ValueError):
        ts.derivative_softmax(s, torch.randn(4, 34))
