"""The port's `ServingEngine(kv_precision=...)` against the JAX engine,
built from the same float32 tiny weights (`LlamaConfig.tiny(n_layers=2)`)
carried through numpy: token streams at max_batch 1 and 2 across page
flushes (16-token pages, prompts of 9 to 40 tokens, 12 to 20 new
tokens), exactly; the engine's invariance to the other requests in its
batch; abort and stop tokens; and its arguments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.descriptors.precision import (
    OperandPrecision as JP,
)
from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models.engine import ServingEngine as JEngine
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision as TP,
)
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models.engine import (
    ServingEngine as TEngine,
)
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy

PAGE = 16


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


# Requests that cross page boundaries in prefill and while decoding.
ENGINE_PROMPTS = (40, 21, 9)
ENGINE_NEW = (12, 14, 20)


def _drain(eng, limit=300):
    for _ in range(limit):
        if eng.idle:
            return
        eng.step()
    raise AssertionError("engine did not drain")


@pytest.mark.parametrize("max_batch,precision", [(1, "int8"), (2, "nf4")])
def test_engine_streams_match_jax(models, max_batch, precision):
    jcfg, tcfg, jparams, tparams = models
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in ENGINE_PROMPTS]
    args = dict(max_batch=max_batch, num_pages=32, page_size=PAGE,
                max_seq=128)
    jeng = JEngine(jparams, jcfg, kv_precision=JP(precision), **args)
    teng = TEngine(tparams, tcfg, kv_precision=TP(precision), **args)
    results = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, m) for p, m in zip(prompts, ENGINE_NEW)]
        _drain(eng)
        results.append([eng.result(r).tolist() for r in rids])
    assert results[1] == results[0]
    for out, p, m in zip(results[1], prompts, ENGINE_NEW):
        assert len(out) == len(p) + m
    assert teng.alloc.free_pages == 31
    assert np.all(teng._full == 0) and np.all(teng._tlen == 0)


def test_engine_is_batch_composition_invariant(models):
    """At a fixed max_batch a request's stream is the same alone (the
    other slot riding along frozen) and beside a staggered second
    request."""
    _, tcfg, _, tparams = models
    rng = np.random.default_rng(7)
    main = rng.integers(0, tcfg.vocab_size, (40,)).astype(np.int32)
    side = rng.integers(0, tcfg.vocab_size, (21,)).astype(np.int32)

    def run(with_side):
        eng = TEngine(tparams, tcfg, max_batch=2, num_pages=32,
                      page_size=PAGE, max_seq=128, kv_precision="int8")
        rid = eng.submit(main, 12)
        if with_side:
            eng.submit(side, 9)
        _drain(eng)
        return eng.result(rid).tolist()
    assert run(False) == run(True)


def test_engine_kv_precision_arguments(models):
    """Members of either package's enum and their values are taken; what
    is not a KV storage precision, or a combination the JAX engine
    refuses, raises; sampling, step_burst and the prefix cache are
    taken."""
    _, tcfg, _, tparams = models
    kw = dict(max_batch=1, num_pages=8, page_size=PAGE, max_seq=64)
    for value in (TP.INT8, JP.FP8_E5M2, "nf4", "fp8_e4m3"):
        eng = TEngine(tparams, tcfg, kv_precision=value, **kw)
        assert eng._kv_precision is TP(getattr(value, "value", value))
    for value in ("int4", TP.BF16, "fp32"):
        with pytest.raises(ValueError, match="streaming KV precision"):
            TEngine(tparams, tcfg, kv_precision=value, **kw)
    with pytest.raises(ValueError, match="incompatible"):
        TEngine(tparams, tcfg, kv_precision="int8",
                draft_fn=lambda *a: None, **kw)
    with pytest.raises(ValueError, match="lora"):
        TEngine(tparams, tcfg, kv_precision="int8", lora={"layers": []},
                **kw)
    eng = TEngine(tparams, tcfg, kv_precision="int8", prefix_cache=True,
                  **kw)
    prompt = np.arange(20, dtype=np.int32)
    for _ in range(2):
        rid = eng.submit(prompt, 3)
        _drain(eng)
        assert len(eng.result(rid)) == 23
    assert eng.stats["prefix_hit_tokens"] == PAGE
    assert eng.stats["prefix_cached_pages"] == 1
    with pytest.raises(ValueError, match="incompatible"):
        TEngine(tparams, tcfg, kv_precision="int8",
                decode_step=lambda *a: None, **kw)
    eng = TEngine(tparams, tcfg, kv_precision="int8", seed=3, **kw)
    rid = eng.submit(np.zeros(4, np.int32), 2, temperature=0.5,
                     logprobs=True)
    while not eng.idle:
        eng.step_burst(2)
    assert len(eng.result(rid)) == 6
    assert eng.result_logprobs(rid).shape == (2,)


def test_abort_resets_the_slot_and_leaves_the_others(models):
    """Aborting a running request frees its pages and its slot's length
    mirrors; the request beside it streams as it does alone, stop tokens
    included."""
    _, tcfg, _, tparams = models
    rng = np.random.default_rng(9)
    main = rng.integers(0, tcfg.vocab_size, (40,)).astype(np.int32)
    side = rng.integers(0, tcfg.vocab_size, (21,)).astype(np.int32)

    def engine():
        return TEngine(tparams, tcfg, max_batch=2, num_pages=32,
                       page_size=PAGE, max_seq=128, kv_precision="int8")
    alone = engine()
    rid = alone.submit(main, 12)
    _drain(alone)
    want = alone.result(rid).tolist()

    eng = engine()
    rid = eng.submit(main, 12)
    other = eng.submit(side, 30)
    for _ in range(6):
        eng.step()
    slot = next(i for i, r in enumerate(eng._slots)
                if r is not None and r.rid == other)
    assert eng.abort(other)
    assert eng._full[slot] == 0 and eng._tlen[slot] == 0
    _drain(eng)
    assert eng.result(rid).tolist() == want
    assert eng.alloc.free_pages == 31
    stop = want[len(main) + 3]
    eng = engine()
    rid = eng.submit(main, 12, stop_tokens=[stop])
    _drain(eng)
    assert eng.result(rid).tolist() == want[:want.index(stop, len(main)) + 1]
