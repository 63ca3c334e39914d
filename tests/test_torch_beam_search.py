"""Beam search in the port (`serving.beam_generate`, `_beam_step`,
`_beam_steps`) against the JAX package, on `LlamaConfig.tiny(n_layers=2)`
in float32 with weights carried through numpy.

- one beam is greedy `generate`, token for token;
- three beams: the sequences equal to JAX's and the scores within
  FP32_TOL, ordered best first, distinct, each equal to a teacher-forced
  rescoring of its sequence by the port's `llama.forward`;
- an eos that finishes beams early: frozen scores, eos padding, equal to
  JAX's;
- `_top_k` keeps `lax.top_k`'s order on ties, and `_beam_step` gathers
  the cache rows by parent beam.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy
from metal_flash_attention_tpu_torch.utils.tolerances import FP32_TOL

BATCH, PROMPT = 2, 12
BEAMS, MAX_NEW = 3, 5
EOS_BEAMS, EOS_NEW = 2, 8


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(41).integers(
        0, 256, (BATCH, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def eos_token(models, prompt):
    """The 3rd generated token of the best beam of a search without eos:
    as eos, it finishes that beam early."""
    _, tcfg, _, tparams = models
    seqs, _ = ts.beam_generate(tparams, torch.as_tensor(prompt), tcfg,
                               num_beams=EOS_BEAMS, max_new_tokens=EOS_NEW)
    return int(seqs[0, 0, PROMPT + 2])


@pytest.fixture(scope="module")
def jax_beams(models, prompt, eos_token):
    jcfg, _, jparams, _ = models
    three = js.beam_generate(jparams, jnp.asarray(prompt), jcfg,
                             num_beams=BEAMS, max_new_tokens=MAX_NEW)
    eos = js.beam_generate(jparams, jnp.asarray(prompt), jcfg,
                           num_beams=EOS_BEAMS, max_new_tokens=EOS_NEW,
                           eos_token=eos_token)
    return jax.tree.map(np.asarray, (three, eos))


def test_beam_one_equals_greedy(models, prompt):
    _, tcfg, _, tparams = models
    p = torch.as_tensor(prompt)
    greedy = ts.generate(tparams, p, tcfg, max_new_tokens=6)
    seqs, scores = ts.beam_generate(tparams, p, tcfg, num_beams=1,
                                    max_new_tokens=6)
    assert seqs.shape == (BATCH, 1, PROMPT + 6) and seqs.dtype == torch.int32
    assert scores.shape == (BATCH, 1) and scores.dtype == torch.float32
    assert seqs[:, 0].tolist() == greedy.tolist()


def _rescore(tparams, tcfg, seq) -> float:
    """Teacher-forced sum of log P(generated token | prefix) through the
    port's full forward."""
    logits, _ = tl.forward(tparams, torch.as_tensor(seq[None]), tcfg)
    logp = torch.log_softmax(logits[0].double(), dim=-1)
    return float(sum(logp[t - 1, int(seq[t])]
                     for t in range(PROMPT, len(seq))))


def test_beam_search_matches_jax(models, prompt, jax_beams):
    _, tcfg, _, tparams = models
    (jseqs, jscores), _ = jax_beams
    seqs, scores = ts.beam_generate(tparams, torch.as_tensor(prompt), tcfg,
                                    num_beams=BEAMS, max_new_tokens=MAX_NEW)
    assert seqs.shape == (BATCH, BEAMS, PROMPT + MAX_NEW)
    assert seqs.tolist() == jseqs.tolist()
    assert np.abs(scores.numpy() - jscores).max() < FP32_TOL.o
    assert np.all(np.diff(scores.numpy(), axis=1) <= 0)      # best first
    for b in range(BATCH):
        assert len({tuple(s) for s in seqs[b].tolist()}) == BEAMS
        assert (seqs[b, :, :PROMPT] == torch.as_tensor(prompt[b])).all()
        for j in range(BEAMS):
            want = _rescore(tparams, tcfg, seqs[b, j].numpy()) / MAX_NEW
            assert abs(float(scores[b, j]) - want) < 1e-4, (b, j)


def test_beam_eos_freezes_and_pads_like_jax(models, prompt, eos_token,
                                            jax_beams):
    _, tcfg, _, tparams = models
    _, (jseqs, jscores) = jax_beams
    seqs, scores = ts.beam_generate(tparams, torch.as_tensor(prompt), tcfg,
                                    num_beams=EOS_BEAMS,
                                    max_new_tokens=EOS_NEW,
                                    eos_token=eos_token)
    assert seqs.tolist() == jseqs.tolist()
    assert np.abs(scores.numpy() - jscores).max() < FP32_TOL.o
    gen = seqs[:, :, PROMPT:].numpy()
    finished = 0
    for b in range(BATCH):
        for j in range(EOS_BEAMS):
            hits = np.flatnonzero(gen[b, j] == eos_token)
            if len(hits):
                finished += 1
                assert np.all(gen[b, j, hits[0]:] == eos_token), (b, j)
                # A finished beam's score is its sum over the tokens up
                # to its eos, divided by that length.
                seq = seqs[b, j, :PROMPT + hits[0] + 1].numpy()
                want = _rescore(tparams, tcfg, seq) / (hits[0] + 1)
                assert abs(float(scores[b, j]) - want) < 1e-4
    assert finished >= 1


def test_top_k_order_on_ties():
    x = torch.tensor([[0.5, 2.0, 2.0, -1.0, 2.0, 0.5]])
    values, idx = ts._top_k(x, 4)
    jvalues, jidx = jax.lax.top_k(jnp.asarray(x.numpy()), 4)
    assert idx.tolist() == np.asarray(jidx).tolist() == [[1, 2, 4, 0]]
    assert values.tolist() == np.asarray(jvalues).tolist()


def test_beam_step_gathers_cache_by_parent(models, prompt):
    """After a step, each beam's cache rows are its parent's (the step's
    own K/V row included) and its length the parent's + 1."""
    _, tcfg, _, tparams = models
    k = BEAMS
    cache = ts.init_cache(tcfg, BATCH, PROMPT + 4, device="cpu")
    _, cache = ts.prefill(tparams, torch.as_tensor(prompt), tcfg, cache)
    cache = ts.KVCache(
        k=[c.repeat_interleave(k, 0) for c in cache.k],
        v=[c.repeat_interleave(k, 0) for c in cache.v],
        lengths=cache.lengths.repeat_interleave(k, 0))
    tokens = torch.tensor([3, 50, 7, 9, 9, 200], dtype=torch.int32)
    scores = torch.tensor([[-1.0, -1.5, -9.0], [-2.0, -2.0, -2.5]])
    finished = torch.zeros((BATCH, k), dtype=torch.bool)
    before = ts.KVCache([c.clone() for c in cache.k],
                        [c.clone() for c in cache.v], cache.lengths.clone())
    _, after = ts.decode_step(tparams, tokens, tcfg, before)
    new, tok, new_scores, new_finished, parent = ts._beam_step(
        tparams, tcfg, cache, tokens, scores, finished, num_beams=k,
        eos_token=-1)
    rows = (torch.arange(BATCH)[:, None] * k + parent).reshape(-1)
    assert parent.shape == (BATCH, k) and tok.dtype == torch.int32
    for got, want in zip(new.k + new.v, after.k + after.v):
        assert torch.equal(got, want[rows])
    assert new.lengths.tolist() == [PROMPT + 1] * (BATCH * k)
    assert not new_finished.any()
    assert np.all(np.diff(new_scores.numpy(), axis=1) <= 0)
