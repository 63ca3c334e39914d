"""The port's training path against the JAX package, on
`LlamaConfig.tiny(n_layers=2)` in float32 (batch 2, 64 tokens), with
the weights carried from the JAX params through numpy.

JAX runs its Pallas attention kernels in interpret mode on the CPU; the
port runs the kernels' plain versions, which is what a CPU tensor takes.

Tolerances, all float32:
- the fused cross-entropy against JAX at FP32_TOL (2e-5);
- losses at 2e-5 and gradients at 1e-4 relative to each tensor's
  largest entry: two layers of float32 products summed in another
  order, so the gradients of the wide projections drift a few 1e-6
  relative, well inside the bound;
- SGD steps on the parameters at 1e-5 absolute;
- AdamW steps at 1% of the most a weight can move (lr = 1e-3 a step, 3
  steps: 3e-5): Adam divides each gradient by its own running rms, so
  an entry whose gradient is near zero takes a step of about lr whose
  size the last bits of that gradient decide.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import losses as jlosses
from metal_flash_attention_tpu.models import optim as joptim
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models import losses as tlosses
from metal_flash_attention_tpu_torch.models import optim as toptim
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    max_abs_err,
)
from metal_flash_attention_tpu_torch.utils.tree import flatten

LOSS_TOL = 2e-5
GRAD_REL_TOL = 1e-4
PARAM_TOL = 1e-5
ADAM_LR, ADAM_STEPS = 1e-3, 3
ADAM_TOL = 0.01 * ADAM_LR * ADAM_STEPS
BATCH, SEQ = 2, 64


@pytest.fixture(scope="module")
def model():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, tokens


def _rel_err(t, j):
    ref = np.asarray(j, np.float32)
    return max_abs_err(t, ref) / max(float(np.max(np.abs(ref))), 1e-30)


def _grads_match(tgrads, jgrads):
    """tgrads: the port's list in `flatten` order; jgrads: the JAX
    pytree of the same structure."""
    jleaves, _ = flatten(jax.tree.map(np.asarray, jgrads))
    assert len(tgrads) == len(jleaves)
    worst = max(_rel_err(t, j) for t, j in zip(tgrads, jleaves))
    assert worst <= GRAD_REL_TOL, worst


def _torch_value_and_grad(params, loss):
    leaves, rebuild = flatten(params)
    work = [p.detach().clone().requires_grad_(True) for p in leaves]
    value = loss(rebuild(work))
    return value.detach(), list(torch.autograd.grad(value, work))


@pytest.mark.parametrize("t,d,vocab,chunk,softcap", [
    (24, 48, 200, 64, None),     # vocab needs padding to a chunk multiple
    (17, 32, 96, 128, None),     # vocab narrower than one chunk
    (16, 32, 300, 128, 30.0),    # Gemma-2 softcap, ragged tail
])
def test_fused_cross_entropy_matches_jax(t, d, vocab, chunk, softcap):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((t, d)).astype(np.float32)
    w = (rng.standard_normal((d, vocab)) * 0.1).astype(np.float32)
    targets = rng.integers(0, vocab, (t,)).astype(np.int32)
    g = rng.standard_normal((t,)).astype(np.float32)

    def jloss(x_, w_):
        nll = jlosses.fused_cross_entropy(x_, w_, jnp.asarray(targets),
                                          chunk, softcap)
        return jnp.sum(nll * g), nll
    (_, jnll), (jdx, jdw) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))

    tx = torch.as_tensor(x).requires_grad_(True)
    tw = torch.as_tensor(w).requires_grad_(True)
    tnll = tlosses.fused_cross_entropy(tx, tw, torch.as_tensor(targets),
                                       chunk, softcap)
    (tnll * torch.as_tensor(g)).sum().backward()
    assert tnll.dtype == torch.float32 and tnll.shape == (t,)
    assert max_abs_err(tnll, jnll) <= FP32_TOL.o
    assert max_abs_err(tx.grad, jdx) <= FP32_TOL.grads
    assert max_abs_err(tw.grad, jdw) <= FP32_TOL.grads


def test_fused_cross_entropy_rejects_a_bad_chunk():
    with pytest.raises(ValueError):
        tlosses.fused_cross_entropy(torch.zeros(2, 4), torch.zeros(4, 8),
                                    torch.zeros(2, dtype=torch.int32), 0)


@pytest.mark.parametrize("fused_ce", [True, False])
def test_loss_and_every_gradient_match_jax(model, fused_ce):
    jcfg, tcfg, jparams, tparams, tokens = model
    jloss, jgrads = jax.value_and_grad(
        lambda p: jl.loss_fn(p, jnp.asarray(tokens), jcfg,
                             fused_ce=fused_ce))(jparams)
    tloss, tgrads = _torch_value_and_grad(
        tparams, lambda p: tl.loss_fn(p, torch.as_tensor(tokens), tcfg,
                                      fused_ce=fused_ce))
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    _grads_match(tgrads, jgrads)


def test_forward_logits_match_jax(model):
    jcfg, tcfg, jparams, tparams, tokens = model
    jlogits, jcaches = jl.forward(jparams, jnp.asarray(tokens), jcfg)
    tlogits, tcaches = tl.forward(tparams, torch.as_tensor(tokens), tcfg)
    assert tlogits.dtype == torch.float32
    assert max_abs_err(tlogits, jlogits) <= 1e-4
    for (tk, tv), (jk, jv) in zip(tcaches, jcaches):
        assert tk.shape == jk.shape and tv.shape == jv.shape
        assert max_abs_err(tk, jk) <= 1e-4


def test_forward_with_kv_cache_matches_jax(model):
    """Decode-style forward: the last 8 tokens against the K/V of the
    first 56 (bottom-right causal, q_len < kv_len)."""
    jcfg, tcfg, jparams, tparams, tokens = model
    head, tail = tokens[:, :56], tokens[:, 56:]
    pos = np.tile(np.arange(56, SEQ, dtype=np.int32), (BATCH, 1))
    _, jc = jl.forward(jparams, jnp.asarray(head), jcfg)
    jlogits, _ = jl.forward(jparams, jnp.asarray(tail), jcfg,
                            positions=jnp.asarray(pos), kv_caches=jc)
    _, tc = tl.forward(tparams, torch.as_tensor(head), tcfg)
    tlogits, tc2 = tl.forward(tparams, torch.as_tensor(tail), tcfg,
                              positions=torch.as_tensor(pos), kv_caches=tc)
    assert tc2[0][0].shape[2] == SEQ
    assert max_abs_err(tlogits, jlogits) <= 1e-4


def test_remat_gives_the_same_gradients(model):
    _, tcfg, _, tparams, tokens = model
    toks = torch.as_tensor(tokens)
    loss, grads = _torch_value_and_grad(
        tparams, lambda p: tl.loss_fn(p, toks, tcfg))
    rloss, rgrads = _torch_value_and_grad(
        tparams, lambda p: tl.loss_fn(p, toks, tcfg, remat=True))
    assert float(rloss) == float(loss)
    for a, b in zip(grads, rgrads):
        assert torch.allclose(a, b, rtol=0, atol=1e-6)


def test_sgd_train_step_matches_jax(model):
    jcfg, tcfg, jparams, tparams, tokens = model
    jnew, jloss = jl.train_step(jparams, jnp.asarray(tokens), jcfg, lr=0.1)
    tnew, tloss = tl.train_step(tparams, torch.as_tensor(tokens), tcfg,
                                lr=0.1)
    assert abs(float(tloss) - float(jloss)) <= LOSS_TOL
    tleaves, _ = flatten(tnew)
    jleaves, _ = flatten(jax.tree.map(np.asarray, jnew))
    assert max(max_abs_err(t, j) for t, j in zip(tleaves, jleaves)) \
        <= PARAM_TOL
    # Out of place: the caller's parameters are untouched.
    assert torch.equal(flatten(tparams)[0][1], flatten(
        params_from_numpy(jax.tree.map(np.asarray, jparams),
                          dtype=torch.float32, device="cpu"))[0][1])


def _fresh(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             dtype=torch.float32, device="cpu")


def test_adamw_steps_with_master_weights_match_optax(model):
    """Three steps of the default optimizer (optax.adamw(1e-4)'s
    settings, weight decay 1e-4) at lr 1e-3, against optax."""
    jcfg, tcfg, jparams, _, tokens = model
    batches = np.stack([np.roll(tokens, i, axis=1)
                        for i in range(ADAM_STEPS)])

    init, step = joptim.make_train_step(
        lambda p, b: jl.loss_fn(p, b, jcfg),
        optax.adamw(ADAM_LR, weight_decay=1e-4))
    jp, js = jparams, init(jparams)
    jlosses_ = []
    for b in batches:
        jp, js, loss = step(jp, js, jnp.asarray(b))
        jlosses_.append(float(loss))

    def adamw_1e3(tensors):
        return torch.optim.AdamW(tensors, lr=ADAM_LR, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)
    init_t, step_t = toptim.make_train_step(
        lambda p, b: tl.loss_fn(p, b, tcfg), adamw_1e3)
    tp = _fresh(jparams)
    ts = init_t(tp)
    for i, b in enumerate(batches):
        tp, ts, loss = step_t(tp, ts, torch.as_tensor(b))
        assert abs(float(loss) - jlosses_[i]) <= LOSS_TOL
    tleaves, _ = flatten(tp)
    jleaves, _ = flatten(jax.tree.map(np.asarray, jp))
    assert max(max_abs_err(t, j) for t, j in zip(tleaves, jleaves)) \
        <= ADAM_TOL
    sleaves, _ = flatten(jax.tree.map(np.asarray, js["shadow"]))
    assert max(max_abs_err(t, j) for t, j in zip(ts["shadow"], sleaves)) \
        <= ADAM_TOL


def test_default_optimizer_is_optax_adamw_defaults():
    opt = toptim.adamw([torch.zeros(2, requires_grad=True)])
    group = opt.param_groups[0]
    assert (group["lr"], group["betas"], group["eps"],
            group["weight_decay"]) == (1e-4, (0.9, 0.999), 1e-8, 1e-4)


def test_master_weights_accumulate_small_updates():
    """Updates far below one bf16 ulp accumulate in the float32 shadow
    and reach the bf16 working copy; without the shadow they vanish."""
    def loss_fn(p, _):
        return p["w"].float().sum() * 1e-2

    def sgd(tensors):
        return torch.optim.SGD(tensors, lr=1.0)
    for master, moved in ((True, True), (False, False)):
        p = {"w": torch.full((128,), 256.0, dtype=torch.bfloat16)}
        init, step = toptim.make_train_step(loss_fn, sgd,
                                            master_weights=master)
        state = init(p)
        for _ in range(150):
            p, state, _ = step(p, state, None)
        assert p["w"].dtype == torch.bfloat16
        assert (float(p["w"][0]) < 256.0) == moved


def test_accumulation_matches_the_large_batch(model):
    """accum_steps=2 over two microbatches of 1 equals one step on the
    batch of 2 (equal microbatches: the mean of means is the mean)."""
    _, tcfg, jparams, _, tokens = model

    def loss_fn(p, b):
        return tl.loss_fn(p, b, tcfg)
    results = []
    for accum, batch in ((1, tokens), (2, tokens[:, None])):
        init, step = toptim.make_train_step(loss_fn, accum_steps=accum)
        p = _fresh(jparams)
        p, _, loss = step(p, init(p), torch.as_tensor(batch))
        results.append((float(loss), flatten(p)[0]))
    (l1, p1), (l2, p2) = results
    assert abs(l1 - l2) <= LOSS_TOL
    assert max(max_abs_err(a, b) for a, b in zip(p1, p2)) <= PARAM_TOL
    with pytest.raises(ValueError):
        toptim.make_train_step(loss_fn, accum_steps=0)


def test_train_loop_matches_single_steps(model):
    _, tcfg, jparams, _, tokens = model
    batches = torch.as_tensor(np.stack([tokens, tokens[::-1]]))

    def loss_fn(p, b):
        return tl.loss_fn(p, b, tcfg)
    init, step = toptim.make_train_step(loss_fn)
    p = _fresh(jparams)
    s = init(p)
    single = []
    for b in batches:
        p, s, loss = step(p, s, b)
        single.append(float(loss))
    init_l, loop = toptim.make_train_loop(loss_fn, steps_per_call=2)
    lp = _fresh(jparams)
    lp, _, losses = loop(lp, init_l(lp), batches)
    assert losses.tolist() == single
    for a, b in zip(flatten(p)[0], flatten(lp)[0]):
        assert torch.equal(a, b)


def test_unported_model_options_raise(model):
    _, tcfg, _, tparams, tokens = model
    toks = torch.as_tensor(tokens)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tl.loss_fn(tparams, toks, tcfg, lora={"layers": []})
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tl.forward(tparams, toks, tcfg, mesh=object())
