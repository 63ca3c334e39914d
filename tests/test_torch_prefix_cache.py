"""Automatic prefix caching in the PyTorch port against the JAX package.

- `PrefixCache` op by op against JAX's: JAX's unit scenario (chained
  lookup, exact tokens, the last-token cap, leaves-first eviction) and a
  seeded random sequence of register / lookup / evict / flush, each cache
  over its package's allocator (the port's C++ one): the same pages,
  hits, entries, frees and refcounts.
- The port's engine against the JAX engine, both with
  ``prefix_cache=True``, on `LlamaConfig.tiny(n_layers=2)` in float32 at
  16-token pages: token streams, hit tokens, cached pages, free pages and
  step counts for a repeated prompt and a one-page share, eviction under
  pool pressure, INT8 pools, `step_burst` and the abort of a borrowing
  request.  Greedy float32 streams are compared token for token.
"""

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
from metal_flash_attention_tpu.models.prefix_cache import (
    PrefixCache as JCache,
)
from metal_flash_attention_tpu.native.page_allocator import (
    PythonPageAllocator as JAlloc,
)
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models.engine import (
    ServingEngine as TEngine,
)
from metal_flash_attention_tpu_torch.models.prefix_cache import (
    PrefixCache as TCache,
)
from metal_flash_attention_tpu_torch.native.page_allocator import (
    NativePageAllocator,
    PythonPageAllocator,
)
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy

PAGE = 16


@pytest.mark.parametrize("alloc_cls", [NativePageAllocator,
                                       PythonPageAllocator])
def test_prefix_cache_unit(alloc_cls):
    """JAX's `test_prefix_cache_unit` on the port's cache and both of its
    allocators."""
    alloc = alloc_cls(16, 4)
    cache = TCache(alloc)
    prompt = np.arange(13, dtype=np.int32)          # 3 complete pages
    pages = alloc.reserve(seq=0, num_tokens=16)     # 4 pages
    assert cache.register(prompt, pages) == 3
    assert cache.register(prompt, pages) == 0       # already cached
    alloc.release(0)                                # the request retires
    assert alloc.free_pages == 15 - 4 + 1           # 3 stay cached
    # A full-chain hit stops at len(prompt) - 1 = 12 tokens: 3 pages.
    hit_pages, n = cache.lookup(prompt)
    assert n == 12 and hit_pages == [int(p) for p in pages[:3]]
    assert all(alloc.refcount(p) == 2 for p in hit_pages)
    alloc.release_pages(hit_pages)
    hp, n = cache.lookup(prompt[:12])               # the 12th recomputes
    assert n == 8
    alloc.release_pages(hp)
    div = prompt.copy()
    div[6] = 99                                     # inside page 1
    hp, n = cache.lookup(div)
    assert n == 4 and hp == [int(pages[0])]
    alloc.release_pages(hp)
    assert cache.evict(1) == 1 and len(cache) == 2  # a leaf went
    hp, n = cache.lookup(prompt)
    assert n == 8
    alloc.release_pages(hp)
    cache.flush()
    assert alloc.free_pages == 15 and len(cache) == 0


def test_prefix_cache_matches_jax_op_by_op():
    """300 seeded calls on both caches, each over its own allocator with
    the same page ids: prompts that share 0 to 3 pages of a few roots,
    requests that borrow, retire and register, evictions of 1 to 3 pages
    and a flush now and then."""
    n_pages, ps = 40, 4
    ja, ta = JAlloc(n_pages, ps), NativePageAllocator(n_pages, ps)
    jc, tc = JCache(ja), TCache(ta)
    rng = np.random.default_rng(3)
    roots = [rng.integers(0, 50, (16,)).astype(np.int32) for _ in range(3)]
    live: list = []              # (seq, prompt, borrowed) of running ones
    for step in range(300):
        op = rng.choice(["admit", "admit", "retire", "evict", "flush"],
                        p=[0.35, 0.15, 0.3, 0.17, 0.03])
        if op == "admit" and len(live) < 5:
            root = roots[rng.integers(3)]
            prompt = np.concatenate([root[:ps * rng.integers(0, 4)],
                                     rng.integers(0, 50, (rng.integers(
                                         1, 9),))]).astype(np.int32)
            jp, jn = jc.lookup(prompt)
            tp, tn = tc.lookup(prompt)
            assert (tp, tn) == (jp, jn), step
            ok = []
            for a in (ja, ta):
                try:
                    a.reserve(step, len(prompt) + 2 - jn)
                    ok.append(True)
                except Exception:
                    ok.append(False)
                    if jp:
                        a.release_pages(jp)
            assert ok[0] == ok[1], step
            if ok[0]:
                assert ta.pages(step) == ja.pages(step)
                live.append((step, prompt, jp))
        elif op == "retire" and live:
            seq, prompt, borrowed = live.pop(int(rng.integers(len(live))))
            pages = borrowed + ja.pages(seq)
            assert tc.register(prompt, pages) == jc.register(prompt, pages)
            for a in (ja, ta):
                a.release(seq)
                if borrowed:
                    a.release_pages(borrowed)
        elif op == "evict":
            k = int(rng.integers(1, 4))
            assert tc.evict(k) == jc.evict(k), step
        elif op == "flush":
            jc.flush()
            tc.flush()
        assert len(tc) == len(jc) and ta.free_pages == ja.free_pages
        assert [ta.refcount(p) for p in range(n_pages)] == \
            [ja.refcount(p) for p in range(n_pages)], step
    assert tc.hit_tokens == jc.hit_tokens == 0   # the engine counts them


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _engines(models, **kw):
    jcfg, tcfg, jparams, tparams = models
    args = dict(dict(max_batch=2, num_pages=32, page_size=PAGE, max_seq=128,
                     prefix_cache=True), **kw)
    jkw, tkw = dict(args), dict(args)
    if "kv_precision" in args:
        jkw["kv_precision"] = JP(args["kv_precision"])
    return JEngine(jparams, jcfg, **jkw), TEngine(tparams, tcfg, **tkw)


def _run(eng, prompts, new, burst=0, limit=80):
    """Submit ``prompts`` (``new`` tokens each), drain; returns the
    results and the engine calls taken."""
    rids = [eng.submit(p, new) for p in prompts]
    steps = 0
    while not eng.idle:
        eng.step_burst(burst) if burst else eng.step()
        steps += 1
        assert steps < limit
    return [eng.result(r).tolist() for r in rids], steps


def _state(eng):
    return (eng.prefix_cache.hit_tokens, eng.prefix_cache.miss_tokens,
            len(eng.prefix_cache), eng.alloc.free_pages)


def _prompts(seed, n, length=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (length,)).astype(np.int32)
            for _ in range(n)]


def test_engine_prefix_reuse_matches_jax(models):
    """JAX's `test_engine_prefix_reuse_bitwise`: the repeated prompt
    borrows both full pages and takes fewer steps, a prompt sharing one
    page borrows it; every stage equal to the JAX engine's."""
    jeng, teng = _engines(models)
    (prompt,) = _prompts(11, 1)
    p3 = prompt.copy()
    p3[20] = (p3[20] + 1) % 256
    for stage, p in enumerate((prompt, prompt, p3)):
        want, jsteps = _run(jeng, [p], 6)
        got, tsteps = _run(teng, [p], 6)
        assert got == want and tsteps == jsteps, stage
        assert _state(teng) == _state(jeng), stage
    assert teng.prefix_cache.hit_tokens == 32 + 16
    assert len(teng.prefix_cache) == 3
    stats = teng.stats
    assert stats["prefix_hit_tokens"] == 48
    assert stats["prefix_cached_pages"] == 3
    assert stats["free_pages"] == 32 - 1 - 3
    teng.prefix_cache.flush()
    assert teng.alloc.free_pages == 32 - 1
    assert type(teng.alloc) is NativePageAllocator


def test_engine_eviction_under_pressure_matches_jax(models):
    """JAX's eviction test at num_pages 10 (9 usable, a 40-token prompt
    and 6 new need 3 and cache 2): cold chains are evicted to admit, and
    a prompt seen before hits what is left of its chain."""
    jeng, teng = _engines(models, max_batch=1, num_pages=10, max_seq=64)
    prompts = _prompts(12, 4)
    for p in prompts + [prompts[3], prompts[0]]:
        want, jsteps = _run(jeng, [p], 6)
        got, tsteps = _run(teng, [p], 6)
        assert got == want and tsteps == jsteps
        assert _state(teng) == _state(jeng)
        assert teng.alloc.free_pages >= 1
    assert teng.prefix_cache.hit_tokens == 64


def test_engine_int8_pools_with_prefix_cache_match_jax(models):
    """JAX's `test_engine_quantized_kv_with_prefix_cache`: INT8 pools
    borrow quantized pages (per-page scales keep them shareable); then two
    requests share a prefix in one batch."""
    jeng, teng = _engines(models, max_batch=2, kv_precision="int8")
    (prompt,) = _prompts(34, 1)
    side = np.concatenate([prompt[:32], _prompts(35, 1, 9)[0]])
    for stage, batch in enumerate(([prompt], [prompt], [side, prompt])):
        want, jsteps = _run(jeng, batch, 8)
        got, tsteps = _run(teng, batch, 8)
        assert got == want and tsteps == jsteps, stage
        assert _state(teng) == _state(jeng), stage
    assert teng.prefix_cache.hit_tokens == 32 + 32 + 32
    assert np.all(teng._full == 0) and np.all(teng._tlen == 0)


def test_engine_burst_with_prefix_cache_matches_jax(models):
    """`step_burst(4)` with the cache: the shared prefix's requests borrow
    and burst as the JAX engine's do."""
    jeng, teng = _engines(models, admissions_per_step=2)
    base = _prompts(41, 1, 33)[0]
    tails = _prompts(42, 3, 7)
    batch = [np.concatenate([base, t]) for t in tails]
    for stage, prompts in enumerate((batch[:1], batch[1:])):
        want, jsteps = _run(jeng, prompts, 9, burst=4)
        got, tsteps = _run(teng, prompts, 9, burst=4)
        assert got == want and tsteps == jsteps, stage
        assert _state(teng) == _state(jeng), stage
    assert teng.prefix_cache.hit_tokens == 2 * 32


def test_engine_abort_of_a_borrowing_request_matches_jax(models):
    """Aborting a request that borrows cached pages releases them (and
    caches nothing of its prompt); the request beside it streams on."""
    jeng, teng = _engines(models)
    (prompt,) = _prompts(51, 1)
    other = _prompts(52, 1, 21)[0]
    for eng in (jeng, teng):
        _run(eng, [prompt], 4)
    states = []
    for eng in (jeng, teng):
        borrower = eng.submit(np.concatenate([prompt[:32], other[:5]]), 20)
        rid = eng.submit(other, 10)
        for _ in range(3):
            eng.step()
        held = eng.alloc.free_pages
        assert eng.abort(borrower)
        states.append((held, _state(eng)))
        while not eng.idle:
            eng.step()
        states.append((eng.result(rid).tolist(), _state(eng)))
    assert states[2:] == states[:2]
    teng.prefix_cache.flush()
    assert teng.alloc.free_pages == 31
