"""The slice as a whole: the port's `ServingEngine` against the JAX
`ServingEngine`, built from the same float32 tiny weights carried
through numpy.  Both must emit the same streams token for token (greedy
float32: the logits agree to ~1e-5, far inside any argmax margin of
these random weights)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models.engine import ServingEngine as JEngine
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models.engine import (
    ServingEngine as TEngine,
)
from metal_flash_attention_tpu.native.page_allocator import (
    PythonPageAllocator,
)
from metal_flash_attention_tpu_torch.native.page_allocator import (
    PageAllocator,
    PagerError,
)
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy

PROMPT_LENS = (16, 9, 24)
MAX_NEW = (8, 11, 5)
NUM_PAGES = 32


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _drain(eng, limit=200):
    streamed = {}
    for _ in range(limit):
        if eng.idle:
            return streamed
        for rid, tok in eng.step():
            streamed.setdefault(rid, []).append(tok)
    raise AssertionError("engine did not drain")


def _engines(models, **kw):
    jcfg, tcfg, jparams, tparams = models
    args = dict(dict(max_batch=2, num_pages=NUM_PAGES, max_seq=256), **kw)
    return JEngine(jparams, jcfg, **args), TEngine(tparams, tcfg, **args)


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX engine's run of the three requests (shared by tests)."""
    jeng, _ = _engines(models)
    rids = [jeng.submit(p, m) for p, m in zip(_prompts(), MAX_NEW)]
    streamed = _drain(jeng)
    return rids, streamed, [jeng.result(r) for r in rids]


def test_engine_streams_match_jax(models, jax_streams):
    _, teng = _engines(models)
    j_rids, j_streamed, j_results = jax_streams
    rids = [teng.submit(p, m) for p, m in zip(_prompts(), MAX_NEW)]
    streamed = _drain(teng)
    for rid, jrid, jres, p, m in zip(rids, j_rids, j_results, _prompts(),
                                     MAX_NEW):
        out = teng.result(rid)
        assert out.tolist() == jres.tolist(), rid
        assert streamed[rid] == j_streamed[jrid] == out[len(p):].tolist()
        assert len(out) == len(p) + m
    assert teng.alloc.free_pages == NUM_PAGES - 1      # null page only
    st = teng.stats
    assert st["emitted_tokens"] == sum(MAX_NEW)
    assert st["active_slots"] == 0 and st["queue_depth"] == 0


# Settings whose requests cross page boundaries, many times each: 8-token
# pages against prompts of 5-50 tokens with 9-20 new ones, alone, with
# two admissions a step, and with a 16-token sliding window in both
# packages' configs; and a 12-page pool of 16-token pages.
# (engine arguments, sliding window)
PAGE_CASES = {
    "page8": (dict(page_size=8), None),
    "page8_two_admissions": (dict(page_size=8, admissions_per_step=2), None),
    "page8_window16": (dict(page_size=8), 16),
    "pool12_page16": (dict(page_size=16, num_pages=12), None),
}
LONG_PROMPT_LENS = (5, 50, 23, 37)
LONG_MAX_NEW = (20, 9, 14, 11)


@pytest.mark.parametrize("case", list(PAGE_CASES))
def test_engine_streams_match_jax_across_pages(models, case):
    engine_kw, window = PAGE_CASES[case]
    jcfg, tcfg, jparams, tparams = models
    if window is not None:
        jcfg = dataclasses.replace(jcfg, sliding_window=window)
        tcfg = dataclasses.replace(tcfg, sliding_window=window)
    args = dict(dict(max_batch=2, num_pages=NUM_PAGES, max_seq=256),
                **engine_kw)
    jeng = JEngine(jparams, jcfg, **args)
    teng = TEngine(tparams, tcfg, **args)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, (n,)).astype(np.int32)
               for n in LONG_PROMPT_LENS]
    results = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, m) for p, m in zip(prompts, LONG_MAX_NEW)]
        _drain(eng)
        results.append([eng.result(r).tolist() for r in rids])
    assert results[1] == results[0]
    for out, p, m in zip(results[1], prompts, LONG_MAX_NEW):
        assert len(out) == len(p) + m
    assert teng.alloc.free_pages == args["num_pages"] - 1


def test_stop_token_ends_request_like_jax(models, jax_streams):
    """A stop token taken from the JAX stream ends the port's request
    there, stop token included, in both engines."""
    jeng, teng = _engines(models)
    _, _, j_results = jax_streams
    p = _prompts()[1]
    stop = int(j_results[1][len(p) + 3])
    jr = jeng.submit(p, 11, stop_tokens=[stop])
    tr = teng.submit(p, 11, stop_tokens=[stop])
    _drain(jeng)
    _drain(teng)
    out = teng.result(tr)
    assert out.tolist() == jeng.result(jr).tolist()
    assert out[-1] == stop and len(out) <= len(p) + 4
    assert teng.alloc.free_pages == NUM_PAGES - 1


def test_priority_admits_first_like_jax(models):
    """With one slot, the high-priority request submitted last is
    admitted right after the one already running."""
    jeng, teng = _engines(models, max_batch=1)
    orders = []
    for eng in (jeng, teng):
        rids = [eng.submit(p, 3, priority=pr)
                for p, pr in zip(_prompts(2), (0, 0, 5))]
        _drain(eng)
        stats = [eng.request_stats(r) for r in rids]
        orders.append([s["queue_steps"] for s in stats])
        assert [len(eng.result(r)) for r in rids] == \
            [n + 3 for n in PROMPT_LENS]
    assert orders[0] == orders[1]
    assert orders[1][2] < orders[1][1]


def test_abort_frees_slot_and_pages(models):
    _, teng = _engines(models)
    prompts = _prompts(3)
    rids = [teng.submit(p, 6) for p in prompts]
    teng.step()
    teng.step()
    assert teng.abort(rids[0])                 # running
    assert teng.abort(rids[2])                 # queued, or just admitted
    assert not teng.abort(rids[0])             # already done
    assert not teng.abort(999)                 # unknown
    partial = teng.result(rids[0])
    assert len(partial) >= len(prompts[0])
    _drain(teng)
    assert len(teng.result(rids[1])) == len(prompts[1]) + 6
    assert teng.alloc.free_pages == NUM_PAGES - 1
    assert teng.request_stats(rids[0])["total_steps"] is not None


def test_unported_engine_features_raise(models):
    """What the port does not have raises, naming its ROADMAP item; the
    JAX engine's keywords are all accepted, and its ValueErrors (the
    combinations, an adapter id without adapters) stay ValueErrors.  (Sampling, logprobs, logit_bias and
    step_burst are held in tests/test_torch_engine_burst.py, the prefix
    cache in tests/test_torch_prefix_cache.py, the family hooks
    (chunk_step / decode_step, taken since Gemma-2) in
    tests/test_torch_gemma_engine.py.)"""
    _, tcfg, _, tparams = models
    eng = TEngine(tparams, tcfg, max_batch=1, num_pages=8,
                  prefix_cache=True)
    assert eng.prefix_cache is not None and len(eng.prefix_cache) == 0
    assert eng.stats["prefix_hit_tokens"] == 0
    # Tensor-parallel pools (taken since slice 19,
    # tests/test_torch_serving_tp.py): a kv_sharding that is not a
    # parallel.mesh.NamedSharding is a TypeError.
    with pytest.raises(TypeError, match="NamedSharding"):
        TEngine(tparams, tcfg, max_batch=1, num_pages=8,
                kv_sharding=object())
    # LoRA (taken since slice 16, tests/test_torch_lora.py) and
    # speculative decoding (taken since slice 17,
    # tests/test_torch_engine_speculative.py) are accepted as the JAX
    # engine accepts them.
    for kw in (dict(chunk_step=lambda *a: None),
               dict(decode_step=lambda *a: None),
               dict(lora={"layers": []}),
               dict(draft_fn=lambda *a: None, draft_len=2)):
        TEngine(tparams, tcfg, max_batch=1, num_pages=8, **kw)
    for kw in (dict(kv_precision="int8", decode_step=lambda *a: None),
               dict(lora={"layers": []}, chunk_step=lambda *a: None)):
        with pytest.raises(ValueError):
            TEngine(tparams, tcfg, max_batch=1, num_pages=8, **kw)
    eng = TEngine(tparams, tcfg, max_batch=1, num_pages=8, seed=0,
                  draft_len=0, draft_history=16)
    # As in the JAX engine: an adapter id needs an engine with adapters.
    with pytest.raises(ValueError, match="without lora adapters"):
        eng.submit(np.zeros(4, np.int32), 2, lora_id=1)
    with pytest.raises(ValueError):
        eng.step_burst(0)


def test_page_allocator_matches_jax():
    """The same reserve / release sequence hands out the same pages,
    never page 0, and fails the same way when the pool runs short."""
    ops = [("reserve", 0, 20), ("reserve", 1, 9), ("reserve", 0, 33),
           ("release", 1, 0), ("reserve", 2, 40), ("reserve", 3, 200),
           ("release", 0, 0), ("reserve", 3, 60), ("release", 9, 0)]
    j, t = PythonPageAllocator(12, 8), PageAllocator(12, 8)
    for op, seq, n in ops:
        if op == "release":
            j.release(seq)
            t.release(seq)
        else:
            try:
                want = j.reserve(seq, n)
            except Exception:
                with pytest.raises(PagerError):
                    t.reserve(seq, n)
                continue
            got = t.reserve(seq, n)
            assert got == want and 0 not in got
        assert t.free_pages == j.free_pages
    with pytest.raises(PagerError):
        PageAllocator(1, 8)
