"""The port's `ServingEngine` with the Gemma-2 family hooks
(``chunk_step=serving.gemma_paged_chunk_step``,
``decode_step=serving.gemma_paged_decode_step``) against the JAX engine
with the JAX Gemma hooks, on `GemmaConfig.tiny` in float32 (a sliding
window of 64 below the longer prompts), weights carried through numpy.

One engine configuration throughout (16-token pages, max_seq 128, two
slots).  Greedy float32 streams are compared token for token (the logits
agree to ~1e-5, far inside any argmax margin of these random weights),
logprobs at FP32_TOL; by `step()`, by `step_burst(4)` (the family's
decode as each burst step) and with ``prefix_cache=True``.  Sampled
streams are the port's own under `step()` and `step_burst` (the JAX
engine draws other random bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.descriptors.precision import (
    OperandPrecision as JP,
)
from metal_flash_attention_tpu.models import gemma as jg
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu.models.engine import ServingEngine as JEngine
from metal_flash_attention_tpu_torch.models import gemma as tg
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.models.engine import (
    ServingEngine as TEngine,
)
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy
from metal_flash_attention_tpu_torch.utils.tolerances import FP32_TOL

ARGS = dict(max_batch=2, num_pages=32, page_size=16, max_seq=128)
PROMPT_LENS = (70, 20, 90)
MAX_NEW = (6, 9, 4)


@pytest.fixture(scope="module")
def models():
    jcfg = jg.GemmaConfig.tiny(dtype=jnp.float32)
    tcfg = tg.GemmaConfig.tiny(dtype=torch.float32)
    jparams = jg.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(models, **kw):
    jcfg, tcfg, jparams, tparams = models
    jeng = JEngine(jparams, jcfg, chunk_step=js.gemma_paged_chunk_step,
                   decode_step=js.gemma_paged_decode_step, **ARGS, **kw)
    teng = TEngine(tparams, tcfg, chunk_step=ts.gemma_paged_chunk_step,
                   decode_step=ts.gemma_paged_decode_step, **ARGS, **kw)
    return jeng, teng


def _prompts(seed=0, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _run(eng, requests, burst=0, limit=100):
    """Submit (prompt, max_new, kwargs) requests and drain; returns each
    request's tokens and logprobs (or None) and the engine calls."""
    rids = [eng.submit(p, n, **kw) for p, n, kw in requests]
    calls = 0
    while not eng.idle:
        eng.step_burst(burst) if burst else eng.step()
        calls += 1
        assert calls < limit
    out = []
    for rid, (_, _, kw) in zip(rids, requests):
        lp = eng.result_logprobs(rid) if kw.get("logprobs") else None
        out.append((eng.result(rid).tolist(), lp))
    return out, calls


def _same(got, want):
    for (gt, glp), (wt, wlp) in zip(got, want):
        assert gt == wt
        if wlp is not None:
            assert np.max(np.abs(np.asarray(glp) - np.asarray(wlp))) \
                <= FP32_TOL.o


def _requests(seed=0):
    prompts = _prompts(seed)
    return [(prompts[0], MAX_NEW[0], dict(logprobs=True)),
            (prompts[1], MAX_NEW[1], dict(logit_bias={7: 5.0})),
            (prompts[2], MAX_NEW[2], {})]


def test_greedy_streams_match_jax(models):
    """By `step()`: the same tokens, the same logprobs (one request asks
    for them) under a logit bias on another, and the same number of
    engine steps; every page comes back."""
    jeng, teng = _engines(models)
    requests = _requests()
    want, jcalls = _run(jeng, requests)
    got, tcalls = _run(teng, requests)
    _same(got, want)
    assert tcalls == jcalls
    assert teng.alloc.free_pages == ARGS["num_pages"] - 1


def test_burst_streams_match_jax(models):
    """`step_burst(4)` with the family's decode as each burst step: the
    JAX engine's burst streams, and the port's own `step()` streams;
    sampled streams the same under both."""
    jeng, teng = _engines(models)
    requests = _requests(1)
    want, _ = _run(jeng, requests, burst=4)
    got, _ = _run(teng, requests, burst=4)
    _same(got, want)
    stepped, _ = _run(_engines(models)[1], requests)
    _same(stepped, want)
    sampled = [(p, n, dict(temperature=0.8, top_k=20, top_p=0.9))
               for p, n, _ in requests]
    by_step, _ = _run(_engines(models, seed=3)[1], sampled)
    by_burst, _ = _run(_engines(models, seed=3)[1], sampled, burst=4)
    assert by_step == by_burst


def test_prefix_cache_streams_match_jax(models):
    """``prefix_cache=True``: a request, then two more sharing its first
    two pages (one beyond the window), borrow them and stream as the JAX
    engine's do; hit tokens and free pages equal."""
    jeng, teng = _engines(models, prefix_cache=True)
    base = _prompts(2, (32,))[0]
    tails = _prompts(3, (45, 9, 50))
    batch = [(np.concatenate([base, t]), 5, {}) for t in tails]
    for stage, requests in enumerate((batch[:1], batch[1:])):
        want, jcalls = _run(jeng, requests)
        got, tcalls = _run(teng, requests)
        _same(got, want)
        assert tcalls == jcalls, stage
        assert teng.prefix_cache.hit_tokens == jeng.prefix_cache.hit_tokens
        assert teng.alloc.free_pages == jeng.alloc.free_pages, stage
    assert teng.prefix_cache.hit_tokens == 2 * 32


def test_hooks_refuse_kv_precision_and_lora(models):
    """The family hooks with ``kv_precision`` or ``lora``: the JAX
    engine's ValueError, on both."""
    jcfg, tcfg, jparams, tparams = models
    hooks = dict(chunk_step=ts.gemma_paged_chunk_step,
                 decode_step=ts.gemma_paged_decode_step)
    jhooks = dict(chunk_step=js.gemma_paged_chunk_step,
                  decode_step=js.gemma_paged_decode_step)
    for kw, jkw in ((dict(kv_precision="int8"),
                     dict(kv_precision=JP.INT8)),
                    (dict(lora={"layers": []}), dict(lora={"layers": []}))):
        for key in ("chunk_step", "decode_step"):
            with pytest.raises(ValueError):
                TEngine(tparams, tcfg, **{key: hooks[key]}, **ARGS, **kw)
            with pytest.raises(ValueError):
                JEngine(jparams, jcfg, **{key: jhooks[key]}, **ARGS, **jkw)
