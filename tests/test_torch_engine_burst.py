"""The port's engine sampling, logprobs, logit bias and `step_burst`
against the JAX `ServingEngine`, and against itself.

Both engines are built from the same float32 tiny weights
(`LlamaConfig.tiny(n_layers=2)`) carried through numpy, with 16-token
pages.  Against JAX, token for token (greedy float32: the logits agree to
~1e-5, far inside any argmax margin of these random weights; a row with
temperature > 0 and top_k 1 keeps only its argmax):

the port's `step()` and `step_burst(4)` against the JAX engine drained by
`step_burst(4)` (which JAX's own tests hold equal to its `step()`), over
bf16 and INT8 pools, with a logit bias, logprobs (within 1e-5),
temperature > 0 with top_k 1, staggered admission, a stop token, a short
budget and a page flush inside a burst.

A sampled stream's randomness is the port's own (a hash of seed, request
id and token index; `tests/test_torch_sampling.py` holds its filter to
JAX's), so sampled streams are held to the port itself: the same alone
and beside another request, the same under `step()` and `step_burst(4)`,
the same for the same seed and other for another.

One JAX configuration per engine mode is reused by every case (each new
page size, chunk width, burst length, ``sampled`` or ``want_logprobs``
compiles the JAX steps anew).
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
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.models.engine import (
    ServingEngine as TEngine,
)
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy

PAGE = 16
ARGS = dict(max_batch=2, num_pages=32, page_size=PAGE, max_seq=128)
# Prompts of 20, 36 and 4 tokens: chunks of 16 and 4 only.  With 14 new
# tokens, the first request's tail (4 after its prompt) fills its page
# at its 12th decode step.
PROMPT_LENS = (20, 36, 4)
MAX_NEW = (14, 9, 2)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _drain(eng, burst=0, limit=200):
    for _ in range(limit):
        if eng.idle:
            return
        eng.step_burst(burst) if burst else eng.step()
    raise AssertionError("engine did not drain")


def _requests(vocab, stop):
    """(prompt, max_new, submit keywords) of the mix: greedy with a bias
    and logprobs, temperature > 0 with top_k 1 and a stop token, and a
    short budget."""
    p = _prompts(vocab)
    bias = {int(t): v for t, v in zip(p[0][:3], (4.0, -1e9, 2.5))}
    return [(p[0], MAX_NEW[0], dict(logit_bias=bias, logprobs=True)),
            (p[1], MAX_NEW[1], dict(temperature=0.9, top_k=1,
                                    stop_tokens=[stop])),
            (p[2], MAX_NEW[2], dict(logprobs=True))]


def _run(eng, requests, burst=0):
    rids = [eng.submit(p, m, **kw) for p, m, kw in requests]
    _drain(eng, burst)
    return ([eng.result(r).tolist() for r in rids],
            [eng.result_logprobs(r) for r, (_, _, kw) in zip(rids, requests)
             if kw.get("logprobs")])


@pytest.fixture(scope="module")
def stop_token(models):
    """The 4th generated token of the second request, from the port's
    own greedy run (the stop cuts that request short in both engines)."""
    _, tcfg, _, tparams = models
    eng = TEngine(tparams, tcfg, **ARGS)
    p = _prompts(tcfg.vocab_size)[1]
    rid = eng.submit(p, MAX_NEW[1])
    _drain(eng)
    return int(eng.result(rid)[len(p) + 3])


@pytest.mark.parametrize("precision", [None, "int8"])
def test_step_and_burst_match_jax(models, stop_token, precision,
                                  monkeypatch):
    """Greedy streams with a logit bias, logprobs, temperature > 0 with
    top_k 1, a stop token and a short budget: the port's `step()` and
    `step_burst(4)` against the JAX engine's, token for token, over bf16
    and INT8 pools; a page flush lands inside a burst."""
    jcfg, tcfg, jparams, tparams = models
    requests = _requests(tcfg.vocab_size, stop_token)
    jkw = {} if precision is None else dict(kv_precision=JP(precision))
    tkw = {} if precision is None else dict(kv_precision=precision)
    want, want_lp = _run(JEngine(jparams, jcfg, **ARGS, **jkw), requests,
                         burst=4)
    schedules = []
    real = ts.flush_schedule
    monkeypatch.setattr(ts, "flush_schedule", lambda *a: schedules.append(
        real(*a)) or schedules[-1])
    for burst in (0, 4):
        got, got_lp = _run(TEngine(tparams, tcfg, **ARGS, **tkw), requests,
                           burst)
        assert got == want, burst
        for a, b in zip(got_lp, want_lp):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    out = want[1][len(requests[1][0]):]
    assert out[-1] == stop_token and len(out) < MAX_NEW[1]
    assert len(want[2]) == len(requests[2][0]) + MAX_NEW[2]
    assert [len(lp) for lp in want_lp] == [MAX_NEW[0], MAX_NEW[2]]
    if precision is not None:
        # A row filled its page at the 2nd to 4th step of a burst.
        assert any(rows.size for s in schedules if len(s) == 4
                   for rows in s[1:])


def test_biased_tokens_are_banned_and_forced(models):
    """A -1e9 bias bans a token from the stream, +1e9 forces it, under
    `step()` and `step_burst(3)`, with the unbiased logprobs recorded."""
    _, tcfg, _, tparams = models
    p = _prompts(tcfg.vocab_size)[0]
    eng = TEngine(tparams, tcfg, **ARGS)
    rid = eng.submit(p, 5)
    _drain(eng)
    banned = int(eng.result(rid)[len(p)])
    forced = (banned + 7) % tcfg.vocab_size
    for burst in (0, 3):
        eng = TEngine(tparams, tcfg, **ARGS)
        r_ban = eng.submit(p, 5, logit_bias={banned: -1e9}, logprobs=True)
        r_force = eng.submit(p, 4, logit_bias=np.eye(
            tcfg.vocab_size, dtype=np.float32)[forced] * 1e9)
        _drain(eng, burst)
        assert banned not in eng.result(r_ban)[len(p):].tolist()
        assert eng.result(r_force)[len(p):].tolist() == [forced] * 4
        lp = eng.result_logprobs(r_ban)
        assert lp.shape == (5,) and np.all(lp <= 0) and np.all(lp > -1e3)
        assert eng._bias_count == 0 and not eng._bias_dev.any()
        with pytest.raises(ValueError):
            eng.result_logprobs(r_force)


SAMPLED = dict(temperature=0.9, top_k=20)


def _sampled_run(tparams, tcfg, requests, *, seed=42, burst=0, **args):
    eng = TEngine(tparams, tcfg, **dict(ARGS, **args), seed=seed)
    rids = [eng.submit(p, m, **kw) for p, m, kw in requests]
    _drain(eng, burst)
    return [eng.result(r).tolist() for r in rids]


def test_sampled_stream_is_batch_invariant(models):
    """A sampled request's stream is a pure function of (engine seed,
    request id, token index): alone, and beside a greedy request admitted
    with it, it is the same; the greedy companion keeps its own greedy
    stream; another seed gives another stream, and sampling samples."""
    _, tcfg, _, tparams = models
    p_sampled, p_greedy, _ = _prompts(tcfg.vocab_size, seed=7)
    alone = _sampled_run(tparams, tcfg, [(p_sampled, 8, SAMPLED)],
                         max_batch=1)[0]
    both = _sampled_run(tparams, tcfg, [(p_sampled, 8, SAMPLED),
                                        (p_greedy, 8, {})],
                        admissions_per_step=2)
    assert both[0] == alone
    assert both[1] == _sampled_run(tparams, tcfg, [(p_greedy, 8, {})])[0]
    greedy = _sampled_run(tparams, tcfg, [(p_sampled, 8, {})])[0]
    other = _sampled_run(tparams, tcfg, [(p_sampled, 8, SAMPLED)],
                         seed=43)[0]
    assert alone != greedy or other != greedy
    assert other != alone
    assert _sampled_run(tparams, tcfg, [(p_sampled, 8, SAMPLED)],
                        max_batch=1)[0] == alone


@pytest.mark.parametrize("precision", [None, "int8"])
def test_sampled_burst_matches_step(models, precision):
    """Sampled rows (top-k, top-p, a bias) beside a greedy one with
    logprobs: `step_burst(4)` gives `step()`'s streams, crossing page
    flushes, over bf16 and INT8 pools."""
    _, tcfg, _, tparams = models
    p = _prompts(tcfg.vocab_size, seed=3)
    requests = [(p[0], 13, dict(temperature=0.8, top_k=12)),
                (p[1], 10, dict(temperature=1.1, top_p=0.9,
                                logit_bias={5: 3.0})),
                (p[2], 11, dict(logprobs=True))]
    kw = dict(seed=5, kv_precision=precision)
    step = _sampled_run(tparams, tcfg, requests, **kw)
    assert step == _sampled_run(tparams, tcfg, requests, burst=4, **kw)
    assert step[0][len(p[0]):] != _sampled_run(
        tparams, tcfg, requests[:1], kv_precision=precision)[0][len(p[0]):]
