"""The port's Mixtral-style MoE (`models.moe`) against the JAX package on
`MoEConfig.tiny(n_layers=2)` (4 experts, top-2), with the weights
carried through numpy (`params_from_numpy` keeps the router float32).

`route` must give JAX's dispatch and combine bit for bit on the same
gates, at top-1 and top-2, with and without experts over capacity, and
its aux too where every sum is exact (coarse gates, multiples of 1/16,
so that many tie); over softmax gates the aux's means are summed in
another order than XLA's and may differ in the last bits.  `moe_ffn`,
`forward` and the losses (fused and not) with every gradient, the
router's included, against `jax.value_and_grad` (JAX runs its Pallas
attention kernels in interpret mode; the port the kernels' plain
versions): float32 at FP32_TOL, bf16 at MIXED_TOL.  In bf16 the two
attentions round differently, and a token whose two best gates nearly
tie may pick another expert in each package (a margin of 1e-3 at this
seed), which moves every gradient by far more than the tolerance; so
there the port takes JAX's choices (`_top_k` replaced), and each choice
the port would have made otherwise must be a near-tie (ROUTE_TIE).  The
SGD `train_step` is held against JAX's leaf by leaf.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import moe as jm
from metal_flash_attention_tpu_torch.models import moe as tm
from metal_flash_attention_tpu_torch.utils.params import (
    params_from_numpy,
    params_to_numpy,
)
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
)
from metal_flash_attention_tpu_torch.utils.tree import flatten, leaf_paths

DTYPES = {"float32": (jnp.float32, torch.float32, FP32_TOL),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, MIXED_TOL)}
# 2 x 32 positions: 128 choices over 4 experts of capacity 40.
BATCH, SEQ = 2, 33
LR = 1e-2
# Gate margin (in probability) under which two experts count as tied.
ROUTE_TIE = 2e-2


def _setup(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jm.MoEConfig.tiny(n_layers=2, dtype=jdt)
    tcfg = tm.MoEConfig.tiny(n_layers=2, dtype=tdt)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jparams)
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (BATCH, SEQ)).astype(np.int32)
    return (jcfg, tcfg, jparams,
            params_from_numpy(tree, dtype=tdt, device="cpu"), tokens, tol)


@pytest.fixture(scope="module")
def models():
    return {dtype: _setup(dtype) for dtype in DTYPES}


# (top_k, capacity, gates): "coarse" multiples of 1/16, "softmax" of
# normal logits; 32 tokens over 4 experts.
ROUTE_CASES = {
    "top1_coarse_overflow": (1, 5, "coarse"),
    "top2_coarse_overflow": (2, 12, "coarse"),
    "top2_softmax_overflow": (2, 14, "softmax"),
    "top2_softmax_ample": (2, 64, "softmax"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_route_matches_jax_exactly(case):
    k, cap, kind = ROUTE_CASES[case]
    rng = np.random.default_rng(len(case))
    if kind == "coarse":
        gates = (rng.integers(0, 16, (32, 4)) / 16).astype(np.float32)
    else:
        gates = np.array(jax.nn.softmax(jnp.asarray(
            rng.standard_normal((32, 4)), jnp.float32), axis=-1))
    jd, jc, ja = jm.route(jnp.asarray(gates), k, cap)
    td, tc, ta = tm.route(torch.as_tensor(gates), k, cap)
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(tc.numpy(), np.asarray(jc))
    ulps = 0 if kind == "coarse" else 4
    assert abs(ta.item() - float(ja)) <= ulps * np.spacing(np.float32(ja))
    dropped = 32 * k - int(td.sum())
    assert (dropped > 0) == case.endswith("overflow")


def test_top_k_breaks_ties_like_jax():
    """Equal gates go to the lower expert index first, as in
    `jax.lax.top_k`, whatever order the sort meets them in."""
    gates = np.zeros((64, 8), np.float32)
    gates[:, [1, 4, 6]] = 0.25
    gates[::2, 6] = 0.5
    _, ti = tm._top_k(torch.as_tensor(gates), 3)
    _, ji = jax.lax.top_k(jnp.asarray(gates), 3)
    assert ti.numpy().tolist() == np.asarray(ji).tolist()


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_ffn_matches_jax(models, dtype):
    jcfg, tcfg, jparams, tparams, _, tol = models[dtype]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((BATCH, 24, jcfg.dim)).astype(np.float32)
    jy, jaux = jm.moe_ffn(jparams["layers"][0]["moe"],
                          jnp.asarray(x, jcfg.dtype), jcfg)
    ty, taux = tm.moe_ffn(tparams["layers"][0]["moe"],
                          torch.as_tensor(x).to(tcfg.dtype), tcfg)
    assert ty.dtype == tcfg.dtype
    assert max_abs_err(ty, jy) < tol.o
    assert abs(taux.item() - float(jaux)) < tol.o


def test_forward_matches_jax(models):
    jcfg, tcfg, jparams, tparams, tokens, tol = models["float32"]
    jlog, _, jaux = jax.jit(lambda p, t: jm.forward(p, t, jcfg))(
        jparams, jnp.asarray(tokens))
    tlog, caches, taux = tm.forward(tparams, torch.as_tensor(tokens), tcfg)
    assert max_abs_err(tlog, jlog) < tol.o
    assert abs(taux.item() - float(jaux)) < tol.o
    assert len(caches) == tcfg.n_layers
    assert caches[0][0].shape == (BATCH, tcfg.n_kv_heads, SEQ,
                                  tcfg.head_dim)


def _torch_value_and_grad(params, loss):
    leaves, rebuild = flatten(params)
    work = [p.detach().clone().requires_grad_(True) for p in leaves]
    value = loss(rebuild(work))
    return value.detach(), list(torch.autograd.grad(value, work))


def _grads_match(tgrads, jgrads, tol):
    jleaves, _ = flatten(jax.tree.map(
        lambda a: np.asarray(a.astype(jnp.float32)), jgrads))
    assert len(tgrads) == len(jleaves)
    for t, j in zip(tgrads, jleaves):
        assert max_abs_err(t, j) < tol.grads


def _jax_choices(jparams, tokens, jcfg) -> list:
    """JAX's expert choices [T, k] in each layer of its forward."""
    real = jm.route

    def choices(p, t):
        seen = []

        def spy(gates, top_k, capacity):
            seen.append(jax.lax.top_k(gates, top_k)[1])
            return real(gates, top_k, capacity)
        with mock.patch.object(jm, "route", spy):
            jm.forward_hidden(p, t, jcfg)
        return seen
    return [np.asarray(c) for c in jax.jit(choices)(
        jparams, jnp.asarray(tokens))]


def _taking_choices(choices: list, margins: list):
    """A `_top_k` that returns the next layer's ``choices`` with the
    port's own gates at them, and notes in ``margins`` how far each of
    the port's own differing choices lies above the one taken."""
    layers = iter(choices)
    real = tm._top_k

    def top_k(gates, k):
        own = real(gates, k)[1]
        topi = torch.as_tensor(next(layers)).long()
        diff = own != topi
        margins.extend((gates.gather(1, own) - gates.gather(1, topi))[
            diff].tolist())
        topw = gates.gather(1, topi)
        return topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9), topi
    return top_k


# (dtype, fused_ce)
LOSS_CASES = [("float32", True), ("float32", False), ("bfloat16", True)]


@pytest.mark.parametrize("dtype,fused", LOSS_CASES)
def test_loss_and_grads_match_jax(models, dtype, fused):
    """Every gradient, the router's included (through the combine
    weights and the aux loss's mean gates); in bf16 on JAX's routes."""
    jcfg, tcfg, jparams, tparams, tokens, tol = models[dtype]
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t: jm.loss_fn(p, t, jcfg, fused_ce=fused)))(
            jparams, jnp.asarray(tokens))
    margins = []
    top_k = tm._top_k
    if dtype != "float32":
        top_k = _taking_choices(
            _jax_choices(jparams, tokens[:, :-1], jcfg), margins)
    with mock.patch.object(tm, "_top_k", top_k):
        tloss, tgrads = _torch_value_and_grad(
            tparams, lambda p: tm.loss_fn(p, torch.as_tensor(tokens), tcfg,
                                          fused_ce=fused))
    assert max(margins, default=0.0) <= ROUTE_TIE
    assert abs(tloss.item() - float(jloss)) < tol.o
    _grads_match(tgrads, jgrads, tol)
    router = [g for g, path in zip(tgrads, leaf_paths(tparams))
              if path.endswith("w_router")]
    assert len(router) == tcfg.n_layers
    assert all(float(g.abs().max()) > 0 for g in router)


def test_remat_is_the_same_step(models):
    """`remat=True` recomputes each layer (its routes too) in the
    backward: the loss and every gradient come out the same."""
    _, tcfg, _, tparams, tokens, _ = models["float32"]
    tok = torch.as_tensor(tokens)
    loss, grads = _torch_value_and_grad(
        tparams, lambda p: tm.loss_fn(p, tok, tcfg))
    rloss, rgrads = _torch_value_and_grad(
        tparams, lambda p: tm.loss_fn(p, tok, tcfg, remat=True))
    assert torch.equal(loss, rloss)
    for g, r in zip(grads, rgrads):
        assert torch.equal(g, r)


def test_train_step_matches_jax(models):
    jcfg, tcfg, jparams, tparams, tokens, tol = models["float32"]
    jnew, jloss = jax.jit(
        lambda p, t: jm.train_step(p, t, jcfg, lr=LR))(
            jparams, jnp.asarray(tokens))
    tnew, tloss = tm.train_step(tparams, torch.as_tensor(tokens), tcfg,
                                lr=LR)
    assert abs(tloss.item() - float(jloss)) < tol.o
    tleaves, _ = flatten(params_to_numpy(tnew))
    jleaves, _ = flatten(jax.tree.map(np.asarray, jnew))
    for t, j in zip(tleaves, jleaves):
        assert t.dtype == np.float32
        assert max_abs_err(t, j) < tol.grads
    assert tnew["layers"][0]["moe"]["w_router"].dtype == torch.float32


def test_init_params_layout():
    """The expert bank replaces the dense MLP (none is allocated), the
    router stays float32 in a bf16 model, and each expert matrix is
    normal / sqrt(its fan-in)."""
    cfg = tm.MoEConfig.tiny(n_layers=2, hidden_dim=512)
    params = tm.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    e, d, h = cfg.n_experts, cfg.dim, cfg.hidden_dim
    for layer in params["layers"]:
        assert not {"w_gate", "w_up", "w_down"} & set(layer)
        bank = layer["moe"]
        assert bank["w_router"].dtype == torch.float32
        assert bank["w_router"].shape == (d, e)
        for name, shape, fan_in in (("w_gate", (e, d, h), d),
                                    ("w_up", (e, d, h), d),
                                    ("w_down", (e, h, d), h)):
            w = bank[name]
            assert w.shape == shape and w.dtype == cfg.dtype
            std = float(w.float().std()) * fan_in ** 0.5
            assert abs(std - 1.0) < 0.05, (name, std)
    assert params["embed"].dtype == cfg.dtype
    tree = {"layers": [{"moe": {"w_router": np.ones((4, 2), np.float32),
                                "w_up": np.ones((2, 4, 4), np.float32)},
                        "mlp_norm": np.ones(4, np.float32)}]}
    carried = params_from_numpy(tree, device="cpu")["layers"][0]
    assert carried["moe"]["w_router"].dtype == torch.float32
    assert carried["moe"]["w_up"].dtype == torch.bfloat16


def test_unported_mesh_and_shardings_raise(models):
    _, tcfg, _, tparams, tokens, _ = models["float32"]
    tok = torch.as_tensor(tokens)
    x = torch.zeros((1, 4, tcfg.dim))
    # Expert parallelism in serving (slice 19,
    # tests/test_torch_serving_tp.py) and in training (slice 20,
    # tests/test_torch_train_tp.py) is ported: a mesh that is not one is
    # a TypeError.
    for call in (lambda: tm.forward(tparams, tok, tcfg, mesh=object()),
                 lambda: tm.loss_fn(tparams, tok, tcfg, mesh=object()),
                 lambda: tm.moe_ffn(tparams["layers"][0]["moe"], x, tcfg,
                                    mesh=object()),
                 lambda: tm.param_shardings(tcfg, object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            call()
