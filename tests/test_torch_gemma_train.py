"""Gemma-2 training in the port against the JAX package, on
`GemmaConfig.tiny` (2 layers, head_dim 32, a sliding window of 64 below
the 80 positions the model sees, so the local layer's window cuts), with
the weights carried through numpy.

JAX runs its Pallas attention kernels (forward and the capped backward)
in interpret mode on the CPU, under `jax.value_and_grad`; the port runs
the kernels' plain versions under torch autograd, which is what a CPU
tensor takes.

Tolerances (`utils/tolerances.py`): float32 losses at FP32_TOL.o and
every gradient and SGD-updated parameter at FP32_TOL.grads (2e-5
absolute); bf16 at MIXED_TOL (loss at .o, gradients at .grads, 5e-2),
since the JAX kernels round P and dS to bf16 before their products
while the port's plain versions keep them in float32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import gemma as jg
from metal_flash_attention_tpu_torch.models import gemma as tg
from metal_flash_attention_tpu_torch.utils.params import (
    params_from_numpy,
    params_to_numpy,
)
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
)
from metal_flash_attention_tpu_torch.utils.tree import flatten

DTYPES = {"float32": (jnp.float32, torch.float32, FP32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, MIXED_TOL)}
BATCH, SEQ = 2, 81   # the model sees 80 positions, above the window of 64
LR = 1e-2


def _setup(dtype, **cfg_kw):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jg.GemmaConfig.tiny(dtype=jdt, **cfg_kw)
    tcfg = tg.GemmaConfig.tiny(dtype=tdt, **cfg_kw)
    jparams = jg.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jparams)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return (jcfg, tcfg, jparams, params_from_numpy(tree, dtype=tdt,
                                                   device="cpu"),
            tokens, tol)


@pytest.fixture(scope="module")
def fp32():
    return _setup("float32")


def _jax_value_and_grad(jparams, tokens, jcfg):
    return jax.jit(jax.value_and_grad(
        lambda p, t: jg.loss_fn(p, t, jcfg)))(jparams, jnp.asarray(tokens))


def _torch_value_and_grad(params, loss):
    leaves, rebuild = flatten(params)
    work = [p.detach().clone().requires_grad_(True) for p in leaves]
    value = loss(rebuild(work))
    return value.detach(), list(torch.autograd.grad(value, work))


def _grads_match(tgrads, jgrads, tol):
    """tgrads: the port's list in `flatten` order; jgrads: the JAX pytree
    of the same structure."""
    jleaves, _ = flatten(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jgrads))
    assert len(tgrads) == len(jleaves)
    for t, j in zip(tgrads, jleaves):
        assert t.shape == j.shape
        assert torch.isfinite(t).all()
    worst = max(max_abs_err(t, j) for t, j in zip(tgrads, jleaves))
    assert worst <= tol, worst


def _check(setup, fused_ce=True, **kw):
    jcfg, tcfg, jparams, tparams, tokens, tol = setup
    jloss, jgrads = _jax_value_and_grad(jparams, tokens, jcfg)
    tloss, tgrads = _torch_value_and_grad(
        tparams, lambda p: tg.loss_fn(p, torch.as_tensor(tokens), tcfg,
                                      fused_ce=fused_ce, **kw))
    assert tloss.dtype == torch.float32
    assert abs(float(tloss) - float(jloss)) <= tol.o
    _grads_match(tgrads, jgrads, tol.grads)


@pytest.mark.parametrize("fused_ce", [True, False])
def test_loss_and_every_gradient_match_jax(fp32, fused_ce):
    """The fused chunked cross-entropy over the tied head with the final
    cap, and the materialised logits, both against jax.value_and_grad of
    the JAX loss (fused by default; the two agree in float32)."""
    _check(fp32, fused_ce=fused_ce)


def test_bf16_loss_and_gradients_match_jax():
    _check(_setup("bfloat16"))


def test_head_dim_256_loss_and_gradients_match_jax():
    """A 2-layer tiny config at Gemma-2's head_dim 256: the backward's
    D 256 path through the whole model."""
    _check(_setup("float32", head_dim=256))


def test_remat_gives_the_same_gradients(fp32):
    _, tcfg, _, tparams, tokens, _ = fp32
    toks = torch.as_tensor(tokens)
    loss, grads = _torch_value_and_grad(
        tparams, lambda p: tg.loss_fn(p, toks, tcfg))
    rloss, rgrads = _torch_value_and_grad(
        tparams, lambda p: tg.loss_fn(p, toks, tcfg, remat=True))
    assert float(rloss) == float(loss)
    for a, b in zip(grads, rgrads):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_two_sgd_train_steps_match_jax(fp32):
    """Two `train_step`s at lr 1e-2 against JAX's, the parameters
    compared leaf by leaf after each; the caller's parameters are left
    as they were (out of place)."""
    jcfg, tcfg, jparams, tparams, tokens, tol = fp32
    jstep = jax.jit(lambda p, t: jg.train_step(p, t, jcfg, lr=LR))
    before = [t.clone() for t in flatten(tparams)[0]]
    jp, tp = jparams, tparams
    for _ in range(2):
        jp, jloss = jstep(jp, jnp.asarray(tokens))
        tp, tloss = tg.train_step(tp, torch.as_tensor(tokens), tcfg, lr=LR)
        assert abs(float(tloss) - float(jloss)) <= tol.o
        tleaves, _ = flatten(params_to_numpy(tp))
        jleaves, _ = flatten(jax.tree.map(np.asarray, jp))
        assert max(max_abs_err(t, j) for t, j in zip(tleaves, jleaves)) \
            <= tol.grads
    assert all(torch.equal(a, b)
               for a, b in zip(before, flatten(tparams)[0]))


def test_loss_falls_over_four_steps(fp32):
    """As the JAX package's test_train_step_decreases_loss."""
    _, tcfg, _, tparams, tokens, _ = fp32
    toks = torch.as_tensor(tokens)
    p, l0 = tg.train_step(tparams, toks, tcfg, lr=LR)
    for _ in range(3):
        p, loss = tg.train_step(p, toks, tcfg, lr=LR)
    assert np.isfinite(float(l0)) and np.isfinite(float(loss))
    assert float(loss) < float(l0)
    assert float(tg.loss_fn(p, toks, tcfg)) < float(loss)


def test_params_round_trip_through_numpy(fp32):
    """`params_to_numpy` is the inverse of `params_from_numpy`: the
    structure and every value (norm gains float32, projections in the
    model dtype)."""
    _, _, _, tparams, _, _ = fp32
    back = params_from_numpy(params_to_numpy(tparams), dtype=torch.float32,
                             device="cpu")
    for a, b in zip(flatten(tparams)[0], flatten(back)[0]):
        assert a.dtype == b.dtype and torch.equal(a, b)
