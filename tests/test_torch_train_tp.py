"""Data-, head- and expert-parallel training in the port (dp 2 x tp 2, four
gloo ranks) against the JAX package's jitted ``train_step(mesh=)`` on
four of its virtual CPU devices.

The configurations are the JAX dry runs' (`__graft_entry__.py`): the dp
x tp leg's `LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2)` on
tokens [2, 129], the EP leg's `MoEConfig.tiny(n_heads=4, n_kv_heads=2,
n_experts=4)` on [2, 65], and `GemmaConfig.tiny` (window 64, both soft
caps) on [2, 129].  Weights come from the JAX package through numpy;
each rank keeps its blocks (`param_shardings`) and its data-axis rows.
All port-side cases run in ONE module-scoped spawn
(`tests/_torch_tp_workers.py`), beside the JAX runs after the first
(the bf16 MoE case, whose expert choices the ranks replay).

- One SGD step a family, float32 at FP32_TOL and bf16 at MIXED_TOL: the
  loss on every rank against JAX's (`o`), and every rank's update (new
  - old, blocks) against the same block of JAX's update, the worst
  leaf's relative rms within `grads`, so the copies of a data group
  agree too.  The rate, 1024, makes the update outweigh the parameter,
  so that new - old reads the gradient in bf16 as well: a dropped data
  average or heads sum moves it by far more than the limit.
- The float32 MoE case runs at capacity factor 0.5, so experts overflow
  and the global capacity (JAX's, over both data ranks' tokens) drops
  other choices than a rank routing its own rows would.  In bf16 the
  port takes JAX's choices (`moe._top_k` replaced, as
  tests/test_torch_moe.py does) and each choice it would have made
  otherwise must be a near-tie (ROUTE_TIE).
- `make_train_step` (AdamW, float32 shadows) over the mesh loss against
  JAX's, one step.
- The collectives' gradients against their closed form, `TokenLoader
  (sharding=)` blocks and resume against JAX's sharded batches, a
  context axis in training (Llama's ring and Gemma's whole sequence give
  the loss without a mesh) and the refusals (a windowed Llama on a
  context axis).
"""

import concurrent.futures
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_tp_workers as w
from metal_flash_attention_tpu.models import gemma as jg
from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import moe as jm
from metal_flash_attention_tpu.models import optim as jo
from metal_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from metal_flash_attention_tpu.utils import data as jdata
from metal_flash_attention_tpu_torch.models import moe as tm
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
)

WORLD = 4
TOLS = {"float32": FP32_TOL, "bfloat16": MIXED_TOL}
SEQ = {"llama": 129, "gemma": 129, "moe": 65}
ROUTE_TIE = 2e-2
JMODULES = {"llama": jl, "gemma": jg, "moe": jm}


def _jax_config(family, dtype):
    jdt = getattr(jnp, dtype)
    if family == "llama":
        return jl.LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2,
                                   dtype=jdt)
    if family == "gemma":
        return jg.GemmaConfig.tiny(dtype=jdt)
    return jm.MoEConfig.tiny(
        n_heads=4, n_kv_heads=2, n_experts=4, dtype=jdt,
        capacity_factor=w.train_configs("moe", dtype).capacity_factor)


def _numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _jax_step(family, cfg, params, tokens, mesh):
    """JAX's jitted train_step on the mesh -> (update: new - old params,
    loss, expert choices a layer [T, k] for MoE)."""
    module = JMODULES[family]
    shardings = module.param_shardings(cfg, mesh)
    params = jax.device_put(params, shardings)
    tokens = jax.device_put(jnp.asarray(tokens),
                            JNamedSharding(mesh, JP("data", None)))
    real = jm.route

    def run(p, t):
        seen = []

        def spy(gates, top_k, capacity):
            seen.append(jax.lax.top_k(gates, top_k)[1])
            return real(gates, top_k, capacity)
        with mock.patch.object(jm, "route", spy):
            new, loss = module.train_step(p, t, cfg, lr=w.TRAIN_LR,
                                          mesh=mesh)
        return new, loss, seen
    new, loss, seen = jax.jit(run)(params, tokens)
    update = jax.tree.map(np.subtract, _numpy(new), _numpy(params))
    return update, float(loss), [np.asarray(c) for c in seen]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs and the ranks' results.  The ranks need of JAX's steps
    only the bf16 MoE case's expert choices: that case runs first, and
    the spawn then runs beside the other JAX compiles."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 (virtual) JAX devices")
    mesh = jmake_mesh(data=2, heads=2, devices=jax.devices()[:WORLD])
    payload = {"params": {}, "tokens": {}, "choices": {}}
    inputs, want = {}, {}
    for i, (case, (family, dtype)) in enumerate(w.TRAIN_CASES.items()):
        cfg = _jax_config(family, dtype)
        params = JMODULES[family].init_params(jax.random.PRNGKey(i), cfg)
        tokens = np.random.default_rng(i).integers(
            0, cfg.vocab_size, (2, SEQ[family])).astype(np.int32)
        payload["params"][case] = _numpy(params)
        payload["tokens"][case] = tokens
        inputs[case] = (family, cfg, params, tokens)
    want["moe_bfloat16"] = _jax_step(*inputs["moe_bfloat16"], mesh)
    payload["choices"]["moe_bfloat16"] = want["moe_bfloat16"][2]

    # Two token shards for the loaders.
    workdir = tmp_path_factory.mktemp("train_tp")
    shards = []
    for j, (n, dt) in enumerate(((300, np.uint16), (170, np.int32))):
        path = str(workdir / f"shard{j}.bin")
        jdata.write_shard(path, np.random.default_rng(10 + j).integers(
            0, 256, n).astype(dt))
        shards.append(path)
    payload["loader_shards"] = shards
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(w.spawn, w.train_tp_body, WORLD, str(workdir),
                            payload)
        for case, args in inputs.items():
            if case not in want:
                want[case] = _jax_step(*args, mesh)

        # make_train_step over the mesh loss: one AdamW step.
        cfg = _jax_config("llama", "float32")
        params = jax.device_put(jl.init_params(jax.random.PRNGKey(0), cfg),
                                jl.param_shardings(cfg, mesh))
        tokens = jax.device_put(
            jnp.asarray(payload["tokens"]["llama_float32"]),
            JNamedSharding(mesh, JP("data", None)))
        init_fn, step_fn = jo.make_train_step(
            lambda p, b: jl.loss_fn(p, b, cfg, mesh=mesh))
        new, _, loss = jax.jit(step_fn)(params, init_fn(params), tokens)
        want["adamw"] = (_numpy(new), float(loss))

        # JAX's batches laid over the data axis.
        loader = jdata.TokenLoader(
            shards, w.LOADER["batch"], w.LOADER["seq_len"],
            seed=w.LOADER["seed"],
            sharding=JNamedSharding(mesh, JP("data", None)))
        want["loader"] = [np.asarray(b)
                          for b in loader.take(w.LOADER["steps"])]
        assert loader.sharding is not None
        return want, ranks.result()


def _block(full: np.ndarray, spec: tuple, heads: int) -> np.ndarray:
    """Rank (., heads)'s block of a global array under a spec of a
    dp 2 x tp 2 mesh (parameters split over the heads axis only)."""
    for dim, axis in enumerate(spec):
        assert axis in (None, "heads"), spec
        if axis == "heads":
            n = full.shape[dim] // 2
            full = np.take(full, range(heads * n, (heads + 1) * n),
                           axis=dim)
    return full


def _leaf_pairs(got, want, specs, heads, path=""):
    """(path, a rank's leaf, the same block of JAX's global leaf) over
    every leaf of a rank's tree."""
    if isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            yield from _leaf_pairs(got[k], want[k], specs[k], heads,
                                   f"{path}/{k}")
    elif isinstance(got, list):
        for i, (g, x, s) in enumerate(zip(got, want, specs)):
            yield from _leaf_pairs(g, x, s, heads, f"{path}/{i}")
    else:
        block = _block(np.asarray(want), specs, heads)
        assert got.shape == block.shape, path
        yield path, got, block


def _rel_rms(got, want) -> float:
    err = np.sqrt(np.mean(np.square(got - want, dtype=np.float64)))
    ref = np.sqrt(np.mean(np.square(want, dtype=np.float64)))
    return float(err / max(ref, 1e-30))


@pytest.mark.parametrize("case", list(w.TRAIN_CASES))
def test_train_step_on_the_mesh_matches_jax(runs, case):
    want, ranks = runs
    jnew, jloss, _ = want[case]       # jnew: JAX's update
    tol = TOLS[w.TRAIN_CASES[case][1]]
    losses = {r["cases"][case]["loss"] for r in ranks}
    assert len(losses) == 1, losses             # one global loss
    assert abs(losses.pop() - jloss) < tol.o
    for r in ranks:
        res = r["cases"][case]
        worst = max((_rel_rms(g, x), p) for p, g, x in _leaf_pairs(
            res["update"], jnew, res["specs"], r["index"][1]))
        assert worst[0] <= tol.grads, worst
        assert max(res["margins"], default=0.0) <= ROUTE_TIE


def test_moe_capacity_counts_the_global_batch(runs):
    """The float32 MoE case's first layer overflows, and JAX's global
    slots keep other choices than each data rank's own routing would:
    the port matched JAX (above) only by routing over both."""
    want, _ = runs
    choices = want["moe_float32"][2][0]
    cfg = w.train_configs("moe", "float32")
    t = choices.shape[0]
    topi = torch.as_tensor(np.array(choices)).long()
    _, kept = tm._slots(topi, cfg.n_experts, tm._capacity(cfg, t))
    local = [tm._slots(topi[i * t // 2:(i + 1) * t // 2], cfg.n_experts,
                       tm._capacity(cfg, t // 2))[1] for i in range(2)]
    assert not bool(kept.all())
    assert not np.array_equal(kept.numpy(),
                              np.concatenate([k.numpy() for k in local]))


def test_make_train_step_on_the_mesh_matches_jax(runs):
    want, ranks = runs
    jnew, jloss = want["adamw"]
    for r in ranks:
        assert abs(r["adamw"]["loss"] - jloss) < FP32_TOL.o
        specs = r["cases"]["llama_float32"]["specs"]
        for path, got, block in _leaf_pairs(r["adamw"]["blocks"], jnew,
                                            specs, r["index"][1]):
            assert max_abs_err(got, block) < FP32_TOL.grads, path


def test_collectives_carry_the_gradient(runs):
    """d/dx of sum(gather(a_h x) w) + sum(row_sum(c_h x) u) is the closed
    form on every rank: the column-parallel input's gradient summed over
    the heads ranks, the gather's and the sum's passed back."""
    _, ranks = runs
    a, c, wt, u, _ = w.collective_inputs()
    want = wt[:, :4] * a[0] + wt[:, 4:] * a[1] + u * (c[0] + c[1])
    for r in ranks:
        np.testing.assert_allclose(r["collective_grad"], want, rtol=1e-12)


def test_token_loader_sharding_matches_jax(runs):
    """Each rank's batches are its data block of JAX's sharded batches,
    also after a resume from the state after the first."""
    want, ranks = runs
    rows = w.LOADER["batch"] // 2
    for r in ranks:
        d = r["index"][0]
        assert len(r["loader"]) == len(want["loader"])
        for got, full in zip(r["loader"], want["loader"]):
            assert np.array_equal(got, full[d * rows:(d + 1) * rows])


def test_training_mesh_refusals(runs):
    """A context axis trains: Llama's loss over the ring (data 1 x heads 2
    x context 2) and Gemma's, whose sequence stays whole, equal the loss
    without a mesh; a windowed Llama with a context axis raises
    ValueError (the JAX ring drops the window); shardings that are not
    ones raise."""
    _, ranks = runs
    for r in ranks:
        for family, (got, want) in r["context_loss"].items():
            assert abs(got - want) < FP32_TOL.o, family
        kind, msg = r["raises"]["context_window"]
        assert kind == "ValueError" and "sliding window" in msg
        assert r["raises"]["loader_object"] == "TypeError"
        assert r["raises"]["loader_split"] == "ValueError"
        assert r["raises"]["mesh_object"] == "TypeError"
