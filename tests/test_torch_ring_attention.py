"""Ring and zigzag attention with their backward, the context axis in
Llama training, and the GPipe pipeline in the port (four gloo ranks)
against the JAX package on four of its virtual CPU devices.

All port-side cases run in ONE module-scoped spawn
(`tests/_torch_tp_workers.py`, `ring_body`), beside the JAX runs.
Inputs come from seeds or from the JAX package through numpy.

- `ring_attention` causal and not, and with one kv head (GQA), at data 1
  x heads 1 x context 4: o, lse (``return_residuals``) and the gradients
  of sum(o * dO) against JAX's `ring_attention`, float32 at FP32_TOL;
  `zigzag_ring_attention` the same way in zigzag order, and
  `zigzag_shard` / `zigzag_unshard` exactly.
- The dry run's dp x tp x cp leg (`__graft_entry__.py`):
  `LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2)` at data 1 x
  heads 2 x context 2 on tokens [2, 257], one SGD step: the loss on every
  rank and every rank's update against JAX's jitted
  ``train_step(mesh=)``, float32 at FP32_TOL and bf16 at MIXED_TOL (the
  rate, 1024, makes new - old read the gradient in bf16 too).
- Gemma-2 and MoE leave the sequence whole over the context axis, as
  their JAX specs do: one step on that mesh equals the port's step
  without a mesh.  A windowed Llama with a context axis raises
  ValueError.
- `pipeline` against JAX's `pipeline` and the sequential chain: the MLP
  stages of tests/test_pipeline.py at (4 stages, 8 microbatches) and (2,
  3), the parameter gradients of its differentiability test, and the dry
  run's PP leg (`LlamaConfig.tiny(n_layers=4)` in float32, one layer a
  stage, b 2, s 64, 4 microbatches: loss and gradients).
"""

import concurrent.futures
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_tp_workers as w
from metal_flash_attention_tpu.models import gemma as jg
from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import moe as jm
from metal_flash_attention_tpu.parallel import zigzag as jz
from metal_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from metal_flash_attention_tpu.parallel.ring_attention import (
    ring_attention as jring,
)
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
)
from metal_flash_attention_tpu_torch.utils.tree import flatten

# The module itself: the package re-exports a function of the same name.
jpipe = importlib.import_module("metal_flash_attention_tpu.parallel.pipeline")
WORLD = 4
TOLS = {"float32": FP32_TOL, "bfloat16": MIXED_TOL}
FAMILY_SEQ = {"gemma": 129, "moe": 65}


def _numpy(tree):
    return jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)


def _jax_ring(fn, q, k, v, do):
    """o, lse and the gradients of sum(o * dO) of a JAX ring callable."""
    def phi(q_, k_, v_):
        o, lse = fn(q_, k_, v_)
        return jnp.sum(o * do), (o, lse)
    (_, (o, lse)), grads = jax.jit(jax.value_and_grad(
        phi, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return {"o": o, "lse": lse, "dq": grads[0], "dk": grads[1],
            "dv": grads[2]}


def _jax_cp_step(dtype, tokens, devices):
    """JAX's jitted train_step on the dp x tp x cp mesh -> (update: new -
    old params, loss); the parameters are the payload's (the same key)."""
    mesh = jmake_mesh(**w.CP_TRAIN_MESH, devices=devices)
    cfg = jl.LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2,
                              dtype=getattr(jnp, dtype))
    params = jax.device_put(jl.init_params(jax.random.PRNGKey(0), cfg),
                            jl.param_shardings(cfg, mesh))
    tokens = jax.device_put(jnp.asarray(tokens),
                            JNamedSharding(mesh, JP("data", None)))
    new, loss = jax.jit(lambda p, t: jl.train_step(
        p, t, cfg, lr=w.TRAIN_LR, mesh=mesh))(params, tokens)
    return jax.tree.map(np.subtract, _numpy(new), _numpy(params)), \
        float(loss)


def _jax_pipelines(pp_params, pp_x):
    """JAX's pipeline outputs (and the sequential chain's) of the MLP
    cases, the gradient case's, and the PP leg's loss and gradients."""
    out = {}
    for case, c in w.PIPE_MLP.items():
        stacked, x = w.mlp_stages(case)
        stacked = {k: jnp.asarray(v) for k, v in stacked.items()}
        mesh = jpipe.make_pipeline_mesh(c["stages"])

        def stage(p, x_):
            h = jnp.tanh(x_ @ p["w1"] + p["b1"])
            return h @ p["w2"] + p["b2"]

        def seq(p, x_):
            for i in range(c["stages"]):
                x_ = stage(jax.tree.map(lambda a: a[i], p), x_)
            return x_
        res = {"out": np.asarray(jax.jit(lambda p, x_: jpipe.pipeline(
            stage, p, x_, mesh=mesh))(stacked, jnp.asarray(x))),
               "seq": np.asarray(jax.vmap(lambda xi: seq(stacked, xi))(
                   jnp.asarray(x)))}
        if case == "grads":
            res["grads"] = jax.tree.map(np.asarray, jax.jit(jax.grad(
                lambda p, x_: jnp.sum(jpipe.pipeline(
                    stage, p, x_, mesh=mesh) ** 2)))(stacked,
                                                     jnp.asarray(x)))
            res["seq_grads"] = jax.tree.map(np.asarray, jax.grad(
                lambda p, x_: jnp.sum(jax.vmap(
                    lambda xi: seq(p, xi))(x_) ** 2))(stacked,
                                                      jnp.asarray(x)))
        out[case] = res

    cfg = jl.LlamaConfig.tiny(n_layers=WORLD, dtype=jnp.float32)
    b, s = w.PIPE_LLAMA["b"], w.PIPE_LLAMA["s"]
    cos, sin = jl.rope_frequencies(cfg, jnp.broadcast_to(jnp.arange(s),
                                                         (b, s)))

    def stage_fn(layer, h):
        h, _ = jl.attention_block(layer, h, cfg, cos, sin)
        return jl.mlp_block(layer, h, cfg)
    stacked = jpipe.stack_stage_params(pp_params)
    mesh = jpipe.make_pipeline_mesh(WORLD)
    loss, grads = jax.jit(jax.value_and_grad(lambda p, x: jnp.mean(
        jpipe.pipeline(stage_fn, p, x, mesh=mesh) ** 2)))(
            stacked, jnp.asarray(pp_x))
    out["pp"] = (float(loss), jax.tree.map(np.asarray, grads))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's runs and the ranks' results (the spawn runs beside the JAX
    compiles, which the ranks do not need)."""
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 (virtual) JAX devices")
    devices = jax.devices()[:WORLD]
    llama_cfg = jl.LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2,
                                   dtype=jnp.float32)
    llama_params = jl.init_params(jax.random.PRNGKey(0), llama_cfg)
    pp_cfg = jl.LlamaConfig.tiny(n_layers=WORLD, dtype=jnp.float32)
    pp_params = jl.init_params(jax.random.PRNGKey(2), pp_cfg)["layers"]
    pp_x = np.asarray(jax.random.normal(
        jax.random.PRNGKey(3), (w.PIPE_LLAMA["micro"], w.PIPE_LLAMA["b"],
                                w.PIPE_LLAMA["s"], pp_cfg.dim)))
    payload = {"params": {"llama": _numpy(llama_params),
                          "pp": _numpy(pp_params)},
               "tokens": {"llama": np.random.default_rng(5).integers(
                   0, llama_cfg.vocab_size, w.CP_TOKENS).astype(np.int32)},
               "pp_x": pp_x}
    for i, family in enumerate(w.CONTEXT_FAMILIES):
        cfg = {"gemma": jg.GemmaConfig, "moe": jm.MoEConfig}[family]
        module = {"gemma": jg, "moe": jm}[family]
        kw = dict(n_heads=4, n_kv_heads=2, n_experts=4) \
            if family == "moe" else {}
        params = module.init_params(jax.random.PRNGKey(10 + i),
                                    cfg.tiny(dtype=jnp.float32, **kw))
        payload["params"][family] = _numpy(params)
        payload["tokens"][family] = np.random.default_rng(10 + i).integers(
            0, 256, (2, FAMILY_SEQ[family])).astype(np.int32)
    workdir = tmp_path_factory.mktemp("ring")
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(w.spawn, w.ring_body, WORLD, str(workdir),
                            payload)
        want = {"ring": {}}
        mesh = jmake_mesh(context=WORLD, devices=devices)
        for name, (causal, _) in w.RING_CASES.items():
            fn = jring(mesh, causal=causal, return_residuals=True)
            want["ring"][name] = _jax_ring(
                fn, *(jnp.asarray(x) for x in w.ring_inputs(name)))
        zq, zk, zv, zdo = (jz.zigzag_shard(jnp.asarray(x), WORLD)
                           for x in w.ring_inputs("causal"))
        want["zigzag"] = _jax_ring(
            jz.zigzag_ring_attention(mesh, return_residuals=True),
            zq, zk, zv, zdo)
        want["cp_train"] = {dtype: _jax_cp_step(
            dtype, payload["tokens"]["llama"], devices)
            for dtype in w.DTYPES}
        want["pipe"] = _jax_pipelines(pp_params, pp_x)
        return want, ranks.result()


def _gathered(ranks, case, key):
    """The ranks' context blocks of a ring case's output, in order."""
    blocks = sorted((r["context_index"], r[case] if key is None
                     else r[case][key]) for r in ranks)
    return {k: np.concatenate([b[k] for _, b in blocks], axis=2)
            for k in blocks[0][1]}


@pytest.mark.parametrize("name", list(w.RING_CASES))
def test_ring_attention_matches_jax(runs, name):
    want, ranks = runs
    got = _gathered(ranks, "ring", name)
    for key in ("o", "lse", "dq", "dk", "dv"):
        tol = FP32_TOL.lse if key == "lse" else (
            FP32_TOL.o if key == "o" else FP32_TOL.grads)
        assert max_abs_err(got[key], want["ring"][name][key]) <= tol, key


def test_zigzag_matches_jax(runs):
    """Forward and gradients in zigzag order, and the layout itself."""
    want, ranks = runs
    got = _gathered(ranks, "zigzag", None)
    for key in ("o", "lse", "dq", "dk", "dv"):
        tol = FP32_TOL.lse if key == "lse" else (
            FP32_TOL.o if key == "o" else FP32_TOL.grads)
        assert max_abs_err(got[key], want["zigzag"][key]) <= tol, key
    seq = np.arange(2 * 3 * 64 * 5, dtype=np.float32).reshape(2, 3, 64, 5)
    jax_order = np.asarray(jz.zigzag_shard(jnp.asarray(seq), WORLD))
    for r in ranks:
        order, round_trip = r["zigzag_order"]
        assert np.array_equal(order, jax_order) and round_trip


def _head_block(full: np.ndarray, spec: tuple, heads: int) -> np.ndarray:
    """Heads rank ``heads``'s block of a global parameter (specs split
    over the heads axis only, 2 ranks)."""
    for dim, axis in enumerate(spec):
        if axis == "heads":
            n = full.shape[dim] // 2
            full = np.take(full, range(heads * n, (heads + 1) * n), axis=dim)
    return full


def _leaf_pairs(got, want, specs):
    """(a rank's leaf, JAX's global leaf, its spec) over a rank's tree,
    matched by key (JAX's trees come back with sorted keys)."""
    if isinstance(got, dict):
        assert set(got) == set(want)
        for k in got:
            yield from _leaf_pairs(got[k], want[k], specs[k])
    elif isinstance(got, list):
        for g, x, sp in zip(got, want, specs):
            yield from _leaf_pairs(g, x, sp)
    else:
        yield got, np.asarray(want), specs


def _worst_rel_rms(update, want, specs, heads):
    """The worst leaf's relative rms error of a rank's update against its
    block of JAX's."""
    worst = 0.0
    for got, ref, spec in _leaf_pairs(update, want, specs):
        ref = _head_block(ref, spec, heads)
        assert got.shape == ref.shape
        worst = max(worst, _rel_rms(got, ref))
    return worst


def _rel_rms(got, want) -> float:
    err = np.sqrt(np.mean(np.square(got - want, dtype=np.float64)))
    ref = np.sqrt(np.mean(np.square(want, dtype=np.float64)))
    return float(err / max(ref, 1e-30))


@pytest.mark.parametrize("dtype", w.DTYPES)
def test_context_axis_train_step_matches_jax(runs, dtype):
    """The dp x tp x cp leg: the global loss on every rank and each
    rank's update against its block of JAX's update."""
    want, ranks = runs
    jupdate, jloss = want["cp_train"][dtype]
    tol = TOLS[dtype]
    losses = {r["cp_train"][dtype]["loss"] for r in ranks}
    assert len(losses) == 1, losses
    assert abs(losses.pop() - jloss) < tol.o
    for r in ranks:
        worst = _worst_rel_rms(r["cp_train"][dtype]["update"], jupdate,
                               r["cp_specs"], r["cp_index"][0])
        assert worst <= tol.grads, (r["cp_index"], worst)


@pytest.mark.parametrize("family", w.CONTEXT_FAMILIES)
def test_context_axis_leaves_gemma_and_moe_whole(runs, family):
    """One step on the mesh with a context axis equals the step without a
    mesh: the loss, and each rank's update against its block of the
    plain update by the worst leaf's relative rms (the rate, 1024,
    scales the update)."""
    _, ranks = runs
    for r in ranks:
        res = r["families"][family]
        assert abs(res["loss"] - res["ref_loss"]) <= FP32_TOL.o
        worst = max(_rel_rms(g, x) for g, x in zip(
            flatten(res["update"])[0], flatten(res["ref_update"])[0]))
        assert worst <= FP32_TOL.grads, worst


def test_windowed_llama_refuses_the_context_axis(runs):
    _, ranks = runs
    for r in ranks:
        kind, msg = r["window_raises"]
        assert kind == "ValueError" and "sliding window" in msg


@pytest.mark.parametrize("case", ["s4_m8", "s2_m3"])
def test_pipeline_matches_jax_and_the_chain(runs, case):
    want, ranks = runs
    for r in ranks:
        got = r["pipe"][case]["out"]
        assert max_abs_err(got, want["pipe"][case]["out"]) <= FP32_TOL.o
        assert max_abs_err(got, want["pipe"][case]["seq"]) <= FP32_TOL.o


def test_pipeline_gradients_match_the_chain(runs):
    """Each stage's parameter gradients of sum(out^2): its block of
    JAX's pipeline gradients and of the sequential chain's."""
    want, ranks = runs
    res = want["pipe"]["grads"]
    for r in ranks:
        s = r["stage"]
        for k, g in r["pipe"]["grads"]["grads"].items():
            assert max_abs_err(g, res["grads"][k][s:s + 1]) <= \
                FP32_TOL.grads, k
            assert max_abs_err(g, res["seq_grads"][k][s:s + 1]) <= \
                FP32_TOL.grads, k


def test_pipeline_dryrun_leg_matches_jax(runs):
    """The PP leg: Llama layers one a stage, loss mean(out^2) and each
    stage's gradients against JAX's pipeline."""
    want, ranks = runs
    jloss, jgrads = want["pipe"]["pp"]
    for r in ranks:
        assert abs(r["pp"]["loss"] - jloss) <= FP32_TOL.o
        s = r["stage"]
        for k, g in r["pp"]["grads"].items():
            assert max_abs_err(g, jgrads[k][s:s + 1]) <= FP32_TOL.grads, k
