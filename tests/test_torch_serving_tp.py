"""Tensor-parallel serving in the port at tp 2 (two gloo ranks) against
the JAX package: `paged_chunk_step` / `paged_decode_step` and their Gemma
counterparts with ``mesh=``, and the `ServingEngine` with
``kv_sharding``, by `step()` and `step_burst(4)` (and, for Llama, with
the prefix cache).

One float32 configuration a family (`LlamaConfig.tiny(n_layers=2)`,
`GemmaConfig.tiny` with a window of 24 below the prompts,
`MoEConfig.tiny(n_layers=2)`: 4 experts, 2 a rank) and one engine
configuration (16-token pages).  The weights come from the JAX package
through numpy; each rank keeps its blocks (`parallel.mesh.shard` under
`param_shardings`).  All port-side cases run in ONE module-scoped spawn
(`tests/_torch_tp_workers.py`).

- The steps' logits (each rank's, whole after the gather) against JAX's
  jitted ``mesh=`` steps on two virtual devices, at FP32_TOL (o): the
  row-parallel sums add the same partials in another order.
- The engine streams against the JAX engine's (unsharded; JAX's own
  tests/test_serving_tp.py holds its tp 2 engine equal to it) token for
  token; every rank emitted the same tokens at every call (the workers
  gather them).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as JP

import _torch_tp_workers as w
from metal_flash_attention_tpu.descriptors.precision import (
    OperandPrecision as JPrec,
)
from metal_flash_attention_tpu.models import gemma as jg
from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import moe as jm
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu.models.engine import ServingEngine as JEngine
from metal_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models.engine import (
    ServingEngine as TEngine,
)
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    max_abs_err,
)

TP = 2
GEMMA_KW = dict(sliding_window=24)
PROMPT_LENS = (12, 28, 44)        # one remainder: two chunk shapes
MAX_NEW = 6
STEP_PROMPT = (2, 32)


def _jax_models():
    f32 = jnp.float32
    cfgs = {"llama": jl.LlamaConfig.tiny(n_layers=2, dtype=f32),
            "gemma": jg.GemmaConfig.tiny(**GEMMA_KW, dtype=f32),
            "moe": jm.MoEConfig.tiny(n_layers=2, dtype=f32)}
    inits = {"llama": jl.init_params, "gemma": jg.init_params,
             "moe": jm.init_params}
    params = {f: inits[f](jax.random.PRNGKey(i), cfgs[f])
              for i, f in enumerate(cfgs)}
    return cfgs, params


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    if len(jax.devices()) < TP:
        pytest.skip("needs 2 (virtual) JAX devices")
    cfgs, params = _jax_models()
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    step_prompt = rng.integers(0, 256, STEP_PROMPT).astype(np.int32)
    payload = {"params": {f: jax.tree.map(np.asarray, p)
                          for f, p in params.items()},
               "gemma_kw": GEMMA_KW, "prompts": prompts,
               "max_new": MAX_NEW, "step_prompt": step_prompt}
    ranks = w.spawn(w.serving_body, TP,
                    str(tmp_path_factory.mktemp("serving_tp")), payload)
    return cfgs, params, prompts, step_prompt, ranks


def _jax_tp_steps(cfg, params, family, prompt):
    """JAX's jitted mesh= chunk and decode steps at tp 2."""
    mesh = jmake_mesh(heads=TP, devices=jax.devices()[:TP])
    mod = jg if family == "gemma" else jl
    sharded = jax.device_put(params, mod.param_shardings(cfg, mesh))
    kv = JNamedSharding(mesh, JP(None, "heads", None, None))
    cache = js.init_paged_model_cache(cfg, prompt.shape[0], 64, page_size=16)
    cache = cache._replace(k=tuple(jax.device_put(x, kv) for x in cache.k),
                           v=tuple(jax.device_put(x, kv) for x in cache.v))
    chunk, decode = ((js.gemma_paged_chunk_step, js.gemma_paged_decode_step)
                     if family == "gemma" else
                     (js.paged_chunk_step, js.paged_decode_step))
    chunk = jax.jit(functools.partial(chunk, mesh=mesh),
                    static_argnames=("cfg",))
    decode = jax.jit(functools.partial(decode, mesh=mesh),
                     static_argnames=("cfg",))
    logits, cache = chunk(sharded, jnp.asarray(prompt), cfg, cache)
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    logits2, _ = decode(sharded, tok, cfg, cache)
    return np.asarray(logits[:, -1]), np.asarray(logits2)


@pytest.mark.parametrize("family", ["llama", "gemma"])
def test_tp_paged_steps_match_jax_mesh_steps(setup, family):
    """A 32-token chunk of two rows (beyond Gemma's window of 24), then
    one decode step of its argmax tokens."""
    cfgs, params, _, step_prompt, ranks = setup
    want = _jax_tp_steps(cfgs[family], params[family], family, step_prompt)
    for r in ranks:
        for got, ref in zip(r["steps"][family], want):
            assert max_abs_err(got, ref) < FP32_TOL.o


def _jax_streams(cfg, params, family, prompts):
    kw = {}
    if family == "gemma":
        kw = dict(chunk_step=js.gemma_paged_chunk_step,
                  decode_step=js.gemma_paged_decode_step)
    eng = JEngine(params, cfg, **w.ENGINE, **kw)
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    calls = 0
    while not eng.idle:
        eng.step()
        calls += 1
        assert calls < 100
    return [eng.result(r).tolist() for r in rids]


@pytest.mark.parametrize("family", ["llama", "gemma", "moe"])
def test_tp_engine_streams_match_jax(setup, family):
    """By step() and by step_burst(4), on both ranks; for Llama also with
    the prefix cache, the prompts served twice (the second round from the
    first's cached pages)."""
    cfgs, params, prompts, _, ranks = setup
    want = _jax_streams(cfgs[family], params[family], family, prompts)
    for r in ranks:
        for burst in (0, 4):
            assert r["streams"][family, burst] == want, burst
        if family == "llama":
            assert r["prefix"] == want + want


def test_kv_precision_with_kv_sharding_raises_as_in_jax(setup):
    cfgs, params, *_ = setup
    kw = dict(kv_sharding=object(), kv_precision="int8", **w.ENGINE)
    with pytest.raises(ValueError, match="kv_sharding"):
        JEngine(params["llama"], cfgs["llama"],
                **dict(kw, kv_precision=JPrec.INT8))
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params["llama"]),
                                dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="kv_sharding"):
        TEngine(tparams, tcfg, **kw)


def test_what_tp_does_not_divide_or_is_not_a_mesh_raises(setup):
    """One kv head over two ranks (the step and the engine), three experts
    over two, a kv_sharding with another spec: ValueError; a kv_sharding
    or a mesh that is not one: TypeError."""
    *_, ranks = setup
    for r in ranks:
        assert r["raises"] == {"kv_heads": "ValueError",
                               "engine_kv_heads": "ValueError",
                               "experts": "ValueError",
                               "kv_spec": "ValueError",
                               "kv_object": "TypeError",
                               "step_object": "TypeError"}
