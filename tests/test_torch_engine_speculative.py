"""The port's `ServingEngine` in speculative mode (``draft_fn``,
``draft_len``) against the JAX engine's, on `LlamaConfig.tiny(n_layers=2)`
in float32 with weights carried through numpy, 16-token pages and
draft_len 3 throughout.

One JAX engine (with the prefix cache) serves three runs, computed once
in a module-scoped fixture, and a port engine replays them:

- three requests with a random draft (the same numpy stream in both),
  two slots, the third admitted while the others verify and prefilled
  over two steps as they do, one ending on a stop token: streams, the
  order of emission, steps and free pages equal to JAX's, and the
  streams equal to the port's plain greedy engine;
- the second prompt again: its cached pages borrowed (hit tokens equal to
  JAX's) and the same stream;
- two requests drained by `step_burst(4)`, which in speculative mode is
  the plain greedy burst, as in the JAX engine (it falls back to a
  verify `step()` while a slot prefills).

Then what the speculative engine refuses (a sampled or logprobs request,
draft_len 0), a draft of the wrong shape, and a prompt-lookup drafter
over the engine's right-aligned history, which must give the plain
streams in fewer steps.
"""

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
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy

KD = 3
ARGS = dict(max_batch=2, num_pages=32, page_size=16, max_seq=128)
PROMPT_LENS = (16, 40, 24)
MAX_NEW = (9, 7, 11)
REPEAT_NEW = 5
BURST_LENS, BURST_NEW = (24, 40), (10, 6)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(seed=21, lens=PROMPT_LENS):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (n,)).astype(np.int32) for n in lens]


def _random_draft(seed=5):
    rng = np.random.default_rng(seed)
    return lambda last, history: rng.integers(0, 256, (last.shape[0], KD))


def _drain(eng, burst=0, limit=200):
    """Drain the engine; returns the (rid, token) pairs in emission
    order."""
    emitted = []
    for _ in range(limit):
        if eng.idle:
            return emitted
        emitted += eng.step_burst(burst) if burst else eng.step()
    raise AssertionError("engine did not drain")


@pytest.fixture(scope="module")
def plain_streams(models):
    """The port's plain greedy engine over the three requests."""
    _, tcfg, _, tparams = models
    eng = TEngine(tparams, tcfg, **ARGS)
    rids = [eng.submit(p, m) for p, m in zip(_prompts(), MAX_NEW)]
    _drain(eng)
    return [eng.result(r).tolist() for r in rids]


@pytest.fixture(scope="module")
def stop_token(plain_streams):
    """The second request's 4th generated token."""
    return plain_streams[1][PROMPT_LENS[1] + 3]


def _runs(eng, stop, upto):
    """The runs of the module docstring on ``eng``, the first ``upto`` of
    them: each run's results, emission order, steps and free pages."""
    out = []
    p = _prompts()
    rids = [eng.submit(p[0], MAX_NEW[0]),
            eng.submit(p[1], MAX_NEW[1], stop_tokens=[stop]),
            eng.submit(p[2], MAX_NEW[2])]
    steps = eng.n_steps
    order = _drain(eng)
    out.append(dict(results=[eng.result(r).tolist() for r in rids],
                    order=order, steps=eng.n_steps - steps,
                    admitted=[eng.request_stats(r)["queue_steps"]
                              for r in rids],
                    free=eng.alloc.free_pages))
    if upto > 1:
        rid = eng.submit(p[1], REPEAT_NEW)
        _drain(eng)
        out.append(dict(results=[eng.result(rid).tolist()],
                        hits=eng.prefix_cache.hit_tokens))
    if upto > 2:
        # Prompt lengths whose chunks (16, 8) JAX compiled for the first
        # run already.
        q = _prompts(seed=8, lens=BURST_LENS)
        rids = [eng.submit(x, m) for x, m in zip(q, BURST_NEW)]
        steps = eng.n_steps
        order = _drain(eng, burst=4)
        out.append(dict(results=[eng.result(r).tolist() for r in rids],
                        order=order, steps=eng.n_steps - steps))
    return out


@pytest.fixture(scope="module")
def jax_runs(models, stop_token):
    jcfg, _, jparams, _ = models
    draw = _random_draft()
    eng = JEngine(jparams, jcfg, **ARGS, prefix_cache=True,
                  draft_fn=lambda last, history: jnp.asarray(
                      draw(last, history), jnp.int32), draft_len=KD)
    return _runs(eng, stop_token, 3)


def _port_runs(models, stop_token, upto):
    _, tcfg, _, tparams = models
    eng = TEngine(tparams, tcfg, **ARGS, prefix_cache=True,
                  draft_fn=_random_draft(), draft_len=KD)
    return eng, _runs(eng, stop_token, upto)


def test_speculative_engine_matches_jax(models, stop_token, plain_streams,
                                        jax_runs):
    eng, (got,) = _port_runs(models, stop_token, 1)
    want = jax_runs[0]
    assert got == want
    # The plain greedy streams, the second cut at its stop token.
    cut = plain_streams[1].index(stop_token, PROMPT_LENS[1]) + 1
    assert got["results"] == [plain_streams[0], plain_streams[1][:cut],
                              plain_streams[2]]
    # The third request waited for a slot: it was admitted, and
    # prefilled over two steps, while the first verified.
    assert got["admitted"][2] > 0
    # Rounds emit several tokens: fewer steps than tokens.
    assert got["steps"] < len(got["order"])
    # Every page back but the null page and the cached prompt pages.
    assert got["free"] == ARGS["num_pages"] - 1 - len(eng.prefix_cache)


def test_speculative_engine_prefix_cache_matches_jax(models, stop_token,
                                                     plain_streams,
                                                     jax_runs):
    _, got = _port_runs(models, stop_token, 2)
    assert got[1] == jax_runs[1]
    assert got[1]["hits"] == 32        # 2 of the 40-token prompt's pages
    assert got[1]["results"][0] == plain_streams[1][:PROMPT_LENS[1]
                                                     + REPEAT_NEW]


def test_speculative_engine_step_burst_matches_jax(models, stop_token,
                                                   jax_runs):
    _, got = _port_runs(models, stop_token, 3)
    assert got[2] == jax_runs[2]
    assert [len(r) for r in got[2]["results"]] == [
        n + m for n, m in zip(BURST_LENS, BURST_NEW)]


def test_speculative_engine_refusals(models):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="draft_len"):
        TEngine(tparams, tcfg, **ARGS, draft_fn=_random_draft())
    eng = TEngine(tparams, tcfg, **ARGS, draft_fn=_random_draft(),
                  draft_len=KD)
    p = _prompts()[0]
    for kw in (dict(temperature=0.5), dict(logprobs=True)):
        with pytest.raises(ValueError, match="greedy-only"):
            eng.submit(p, 4, **kw)
    eng = TEngine(tparams, tcfg, **ARGS, draft_len=KD,
                  draft_fn=lambda last, history: np.zeros((2, KD + 1)))
    eng.submit(p, 4)
    with pytest.raises(ValueError, match="draft_fn returned shape"):
        _drain(eng)


def test_prompt_lookup_drafter_fewer_steps(models, plain_streams):
    """A drafter that looks the history's last 2 tokens up in the known
    plain streams and proposes what follows (an oracle over the engine's
    right-aligned, -1 padded history): the plain streams, and fewer
    steps than the plain engine's."""
    _, tcfg, _, tparams = models
    calls = []

    def lookup(last, history):
        calls.append((last.dtype, history.dtype, tuple(history.shape)))
        hist = history.numpy()
        out = np.zeros((hist.shape[0], KD), np.int32)
        for b, row in enumerate(hist):
            tail = [int(t) for t in row if t >= 0][-2:]
            if len(tail) < 2:
                continue
            for full in plain_streams:
                for pos in range(2, len(full)):
                    if full[pos - 2:pos] == tail:
                        nxt = full[pos:pos + KD]
                        out[b, :len(nxt)] = nxt
                        break
                else:
                    continue
                break
        return out
    plain = TEngine(tparams, tcfg, **ARGS)
    spec = TEngine(tparams, tcfg, **ARGS, draft_fn=lookup, draft_len=KD,
                   draft_history=8)
    results = []
    for eng in (plain, spec):
        rids = [eng.submit(p, m) for p, m in zip(_prompts(), MAX_NEW)]
        _drain(eng)
        results.append([eng.result(r).tolist() for r in rids])
        assert eng.alloc.free_pages == ARGS["num_pages"] - 1
    assert results[1] == results[0] == plain_streams
    assert spec.n_steps < plain.n_steps
    assert calls[0] == (torch.int32, torch.int32, (2, 8))
