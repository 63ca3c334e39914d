"""The port's sampler against the JAX package's.

A torch generator cannot draw JAX's `jax.random` stream, so the sampler
is held to JAX in three ways:

- the kept set: for the same logits and parameters, the tokens the
  port's filter keeps (`serving._filter_logits`, finite entries) equal
  the tokens JAX's `sample_token_per_row` draws over 2,000 keys, on
  logits where every kept token has probability >= 2% after filtering
  (so 2,000 draws miss one with probability below 1e-17): ties at the
  k-th value, a top-p boundary, k then p, and greedy / k-only / p-only
  rows in one batch;
- the port's own draws over 2,000 token indices lie within 4 sigma of
  the filtered softmax (binomial counts), and cover the kept set;
- temperature 0 and top_k 1 are greedy, for `sample_token` and for
  `generate_sampled` against JAX `generate` token for token (float32
  tiny model, weights carried through numpy).

Plus JAX's diversity test (`tests/test_serving.py`), and the row keys'
addressing by (seed, request id, token index).
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

VOCAB = 64
DRAWS = 2000


def _logits(*rows):
    """[len(rows), VOCAB] float32: each row's leading values, the rest
    -50 (never kept by any filter below)."""
    out = np.full((len(rows), VOCAB), -50.0, np.float32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


# (logits rows, temperature, top_k, top_p) per row.
CASES = {
    # Three logits tie at the 3rd highest: all of them stay.
    "ties_at_kth": (_logits([3, 2, 1, 1, 1, 0], [0.5, 2, 2, 2, 1, 1]),
                    [1.0, 1.0], [3, 2], [1.0, 1.0]),
    # probs ~ [.644, .237, .087, .032]: mass before position 2 is .881,
    # so 0.88 keeps two tokens, 0.89 three, 0.95 three, 0.97 four.
    "top_p_boundary": (_logits(*[[3, 2, 1, 0]] * 4), [1.0] * 4, [0] * 4,
                       [0.88, 0.89, 0.95, 0.97]),
    # Over the k survivors the nucleus is computed anew: top_k 2 leaves
    # p(0) = .731, so top_p 0.7 keeps only token 0, 0.8 both.
    "k_then_p": (_logits(*[[3, 2, 1, 0]] * 2), [1.0, 1.0], [2, 2],
                 [0.7, 0.8]),
    # One batch: greedy, k-only (ties), p-only at temperature 0.7, both.
    "mixed_rows": (_logits([1, 3, 2, 2], [3, 2, 2, 1, 0], [3, 2, 1, 0],
                           [2, 2, 1.5, 1, 0.5]),
                   [0.0, 1.0, 0.7, 1.3], [0, 2, 0, 3], [1.0, 1.0, 0.9, 0.7]),
}


def _params(case):
    rows, temp, top_k, top_p = CASES[case]
    return (rows, np.asarray(temp, np.float32), np.asarray(top_k, np.int32),
            np.asarray(top_p, np.float32))


@pytest.fixture(scope="module")
def jax_draws():
    """JAX's `sample_token_per_row` over DRAWS key sets, per case:
    [DRAWS, batch] tokens."""
    out = {}
    for case in CASES:
        rows, temp, top_k, top_p = _params(case)
        keys = jax.random.split(jax.random.PRNGKey(0),
                                DRAWS * len(rows)).reshape(DRAWS, len(rows),
                                                           -1)
        draw = jax.jit(jax.vmap(lambda k: js.sample_token_per_row(
            jnp.asarray(rows), k, jnp.asarray(temp), jnp.asarray(top_k),
            jnp.asarray(top_p))))
        out[case] = np.asarray(draw(keys))
    return out


def _port_draws(rows, temp, top_k, top_p, seed=0):
    """The port's draws at token indices 0 .. DRAWS - 1, request id =
    row: [DRAWS, batch]."""
    b = len(rows)
    rep = lambda a: torch.as_tensor(np.tile(a, DRAWS))    # noqa: E731
    keys = ts._row_keys(seed, rep(np.arange(b)),
                        torch.arange(DRAWS).repeat_interleave(b))
    toks = ts.sample_token_per_row(
        torch.as_tensor(np.tile(rows, (DRAWS, 1))), keys, rep(temp),
        rep(top_k), rep(top_p))
    return toks.reshape(DRAWS, b).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_kept_set_matches_jax(case, jax_draws):
    rows, temp, top_k, top_p = _params(case)
    kept = torch.isfinite(ts._filter_logits(
        torch.as_tensor(rows), torch.as_tensor(temp),
        torch.as_tensor(top_k), torch.as_tensor(top_p))).numpy()
    ours = _port_draws(rows, temp, top_k, top_p)
    for i in range(len(rows)):
        jax_set = set(jax_draws[case][:, i].tolist())
        if temp[i] <= 0:                       # greedy row
            assert jax_set == set(ours[:, i].tolist()) == \
                {int(np.argmax(rows[i]))}
            continue
        assert set(np.flatnonzero(kept[i]).tolist()) == jax_set, (case, i)


@pytest.mark.parametrize("case", list(CASES))
def test_draw_frequencies_follow_the_filtered_softmax(case):
    rows, temp, top_k, top_p = _params(case)
    probs = torch.softmax(ts._filter_logits(
        torch.as_tensor(rows), torch.as_tensor(temp),
        torch.as_tensor(top_k), torch.as_tensor(top_p)), dim=-1).numpy()
    draws = _port_draws(rows, temp, top_k, top_p, seed=11)
    for i in range(len(rows)):
        if temp[i] <= 0:
            continue
        counts = np.bincount(draws[:, i], minlength=VOCAB)
        p = probs[i].astype(np.float64)
        sigma = np.sqrt(DRAWS * p * (1 - p))
        assert np.all(np.abs(counts - DRAWS * p) <= 4 * sigma + 1e-9), \
            (case, i, counts[:8], (DRAWS * p)[:8])
        assert set(np.flatnonzero(counts)) == set(np.flatnonzero(p > 0))


def test_sample_token_kept_set_matches_jax():
    """The batch-wide `sample_token`: its top-p runs over the top-k
    filtered logits, ties at the k-th included (JAX :934-950)."""
    rows = _logits([3, 2, 2, 2, 0], [3, 2, 1, 0])
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(top_k=2), dict(top_p=0.9), dict(top_k=2, top_p=0.6),
               dict(top_k=3, top_p=0.95, temperature=0.8)):
        jdraw = jax.jit(jax.vmap(lambda k: js.sample_token(
            jnp.asarray(rows), k, **kw)))
        jax_sets = np.asarray(jdraw(jax.random.split(
            jax.random.PRNGKey(1), DRAWS)))
        ours = np.stack([ts.sample_token(torch.as_tensor(rows), gen, **kw)
                         .numpy() for _ in range(DRAWS)])
        for i in range(len(rows)):
            assert set(ours[:, i].tolist()) == \
                set(jax_sets[:, i].tolist()), (kw, i)


def test_greedy_settings_are_argmax():
    rng = np.random.default_rng(3)
    logits = torch.as_tensor(rng.standard_normal((5, 300)).astype(
        np.float32))
    want = logits.argmax(dim=-1).to(torch.int32)
    assert torch.equal(ts.sample_token(logits, temperature=0.0), want)
    assert torch.equal(ts.sample_token(logits, torch.Generator(),
                                       temperature=0.9, top_k=1), want)
    b = logits.shape[0]
    keys = ts._row_keys(7, torch.arange(b), torch.zeros(b, dtype=torch.int32))
    for temp, top_k in ((0.0, 0), (0.8, 1), (-1.0, 5)):
        got = ts.sample_token_per_row(
            logits, keys, torch.full((b,), temp), torch.full((b,), top_k),
            torch.full((b,), 0.9))
        assert torch.equal(got, want), (temp, top_k)


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


def test_generate_sampled_greedy_settings_match_jax_generate(models):
    jcfg, tcfg, jparams, tparams = models
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    want = np.asarray(js.generate(jparams, jnp.asarray(prompt), jcfg,
                                  max_new_tokens=6)).tolist()
    for kw in (dict(temperature=0.0),
               dict(temperature=0.8, top_k=1,
                    generator=torch.Generator().manual_seed(3))):
        got = ts.generate_sampled(tparams, torch.as_tensor(prompt), tcfg,
                                  max_new_tokens=6, **kw)
        assert got.tolist() == want, kw
    sampled = ts.generate_sampled(
        tparams, torch.as_tensor(prompt), tcfg, max_new_tokens=6,
        temperature=1.0, generator=torch.Generator().manual_seed(3))
    assert sampled.shape == (2, 17)
    assert ((sampled >= 0) & (sampled < tcfg.vocab_size)).all()
    with pytest.raises(ValueError, match="Generator"):
        ts.generate_sampled(tparams, torch.as_tensor(prompt), tcfg,
                            max_new_tokens=2, temperature=1.0)


def test_sampling_actually_samples():
    """The port of JAX's regression for the nucleus cutoff taken at the
    max (which made every row greedy): finite temperature with permissive
    filters draws more than the greedy token, inside the nucleus."""
    logits = torch.as_tensor(_logits([3.0, 2.0, 1.0, 0.0]))
    seen_single, seen_row, seen = set(), set(), set()
    gen = torch.Generator().manual_seed(0)
    one = lambda v, dt: torch.full((1,), v, dtype=dt)    # noqa: E731
    for trial in range(24):
        seen_single.add(int(ts.sample_token(logits, gen, temperature=1.0,
                                            top_p=0.95)[0]))
        keys = ts._row_keys(0, one(100 + trial, torch.int32),
                            one(0, torch.int32))
        seen_row.add(int(ts.sample_token_per_row(
            logits, keys, one(1.0, torch.float32), one(0, torch.int32),
            one(0.95, torch.float32))[0]))
        keys = ts._row_keys(0, one(200 + trial, torch.int32),
                            one(0, torch.int32))
        seen.add(int(ts.sample_token_per_row(
            logits, keys, one(1.0, torch.float32), one(0, torch.int32),
            one(1.0, torch.float32))[0]))
    assert seen_single <= {0, 1, 2} and len(seen_single) >= 2, seen_single
    assert seen_row <= {0, 1, 2} and len(seen_row) >= 2, seen_row
    assert len(seen) >= 2, seen


def test_row_keys_are_addressed_by_seed_request_and_index():
    rids = torch.tensor([4, 9, 4, 2**31 - 1], dtype=torch.int32)
    idxs = torch.tensor([0, 0, 1, 7], dtype=torch.int32)
    keys = ts._row_keys(3, rids, idxs)
    assert keys.dtype == torch.int64
    assert ((keys >= 0) & (keys < 2**32)).all()
    assert len(set(keys.tolist())) == 4
    # A row's key does not depend on its neighbours or its position.
    perm = torch.tensor([3, 1, 0, 2])
    assert torch.equal(ts._row_keys(3, rids[perm], idxs[perm]), keys[perm])
    assert torch.equal(ts._row_keys(3, rids[1:2], idxs[1:2]), keys[1:2])
    assert not torch.equal(ts._row_keys(4, rids, idxs), keys)
    assert not torch.equal(ts._row_keys(3 + 2**32, rids, idxs), keys)
