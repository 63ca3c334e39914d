"""Speculative decoding in the port against the JAX package, on
`LlamaConfig.tiny(n_layers=2)` in float32 with weights carried through
numpy (`utils.params.params_from_numpy`), 16-token pages and draft_len 3
throughout.

- `_speculative_round` on fixed drafts (full accept, partial, none, a
  row not live) over random pools whose rows' chunks straddle a page
  boundary: emissions, counts, next tokens and lengths equal to JAX's,
  the pools it wrote at FP32_TOL;
- `speculative_generate` with a random draft equal to JAX's output and
  to the port's `paged_generate`; the zero and oracle drafts, and the
  ragged-acceptance budget, against the port's own greedy;
- `make_model_draft_fn`: the drafts it proposes, round by round, equal
  to JAX's (the same model as drafter), and a 1-layer drafter still
  greedy;
- `speculative_generate_model` (rounds_per_dispatch 3) with self-draft
  and a weak drafter, equal to JAX's self-drafted output;
- Gemma-2 through ``chunk_step=serving.gemma_paged_chunk_step``: draft
  invariant, and the port's greedy `gemma_generate`.

Each JAX output is computed once (module-scoped fixtures): the Pallas
kernels run in interpret mode on the CPU, and every new shape compiles.
Float32 logits of the two packages agree to ~1e-5, far inside any argmax
margin of these random weights, so the token streams are compared
exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import gemma as jg
from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu_torch.models import gemma as tg
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    max_abs_err,
)

PAGE = 16
KD = 3
BATCH, PROMPT, MAX_NEW = 2, 32, 12


def _carry(jparams):
    return params_from_numpy(jax.tree.map(np.asarray, jparams),
                             dtype=torch.float32, device="cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jparams, _carry(jparams)


@pytest.fixture(scope="module")
def weak(models):
    """A 1-layer drafter with weights of its own."""
    jcfg = jl.LlamaConfig.tiny(n_layers=1, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=1, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(9), jcfg)
    return jcfg, tcfg, jparams, _carry(jparams)


@pytest.fixture(scope="module")
def prompt():
    return np.random.default_rng(0).integers(
        0, 256, (BATCH, PROMPT)).astype(np.int32)


@pytest.fixture(scope="module")
def greedy(models, prompt):
    """The port's plain paged greedy stream."""
    _, tcfg, _, tparams = models
    return ts.paged_generate(tparams, torch.as_tensor(prompt), tcfg,
                             max_new_tokens=MAX_NEW, page_size=PAGE).numpy()


def _random_draft(seed, vocab=256):
    rng = np.random.default_rng(seed)
    return lambda last, buf: rng.integers(0, vocab, (last.shape[0], KD))


# -- one verify round ---------------------------------------------------------

ROUND_LENGTHS = (14, 29)     # chunks 14..17 and 29..32 cross a page


def _round_pools(cfg, seed=3):
    """Random pools for ROUND_LENGTHS (head_dim padded to JAX's 128
    lanes) in the shape of `speculative_generate`'s cache, so that JAX
    compiles one round for both; pages assigned in a shuffled order."""
    rng = np.random.default_rng(seed)
    max_pages = -(-(PROMPT + MAX_NEW + 2 * (KD + 1)) // PAGE)
    num_pages = BATCH * max_pages
    shape = (num_pages, cfg.n_kv_heads, PAGE, 128)
    pools = []
    for _ in range(2 * cfg.n_layers):
        p = np.zeros(shape, np.float32)
        p[..., :cfg.head_dim] = rng.standard_normal(
            shape[:-1] + (cfg.head_dim,))
        pools.append(p)
    table = rng.permutation(num_pages).reshape(BATCH, max_pages).astype(
        np.int32)
    return pools, table, np.asarray(ROUND_LENGTHS, np.int32)


def _port_cache(cfg, pools, table, lengths):
    n = cfg.n_layers
    cut = [torch.from_numpy(p[..., :cfg.head_dim].copy()) for p in pools]
    return ts.PagedModelCache(tuple(cut[:n]), tuple(cut[n:]),
                              torch.from_numpy(table.copy()),
                              torch.from_numpy(lengths.copy()))


def _oracle_drafts(tparams, tcfg, pools, table, lengths, last):
    """Each row's kd greedy continuations of ``last`` over the pools,
    from the port's chunk step on fresh copies."""
    drafts = np.zeros((BATCH, KD), np.int32)
    for j in range(KD):
        chunk = np.concatenate([last[:, None], drafts], axis=1)
        logits, _ = ts.paged_chunk_step(
            tparams, torch.from_numpy(chunk), tcfg,
            _port_cache(tcfg, pools, table, lengths))
        drafts[:, j] = logits[:, j].argmax(-1).numpy()
    return drafts


def _wrong(tok):
    return (tok + 1) % 256


ROUND_CASES = ("full", "partial", "none", "not_live")


@pytest.fixture(scope="module")
def round_inputs(models):
    _, tcfg, _, tparams = models
    pools, table, lengths = _round_pools(tcfg)
    last = np.asarray([7, 200], np.int32)
    oracle = _oracle_drafts(tparams, tcfg, pools, table, lengths, last)
    cases = {}
    for case in ROUND_CASES:
        drafts, live = oracle.copy(), np.ones((BATCH,), bool)
        if case == "partial":
            drafts[0, 1] = _wrong(drafts[0, 1])
            drafts[1, 2] = _wrong(drafts[1, 2])
        elif case == "none":
            drafts[:, 0] = _wrong(drafts[:, 0])
        elif case == "not_live":
            live[1] = False
        cases[case] = (drafts, live)
    return pools, table, lengths, last, cases


@pytest.fixture(scope="module")
def jax_rounds(models, round_inputs):
    jcfg, _, jparams, _ = models
    pools, table, lengths, last, cases = round_inputs
    # `speculative_generate`'s own jit of the round: one compile.
    rnd = jax.jit(js._speculative_round,
                  static_argnames=("cfg", "chunk_step"))
    n = jcfg.n_layers
    out = {}
    for case, (drafts, live) in cases.items():
        cache = js.PagedModelCache(
            tuple(jnp.asarray(p) for p in pools[:n]),
            tuple(jnp.asarray(p) for p in pools[n:]),
            jnp.asarray(table), jnp.asarray(lengths))
        em, n_em, nxt, cache = rnd(jparams, jcfg, cache, jnp.asarray(last),
                                   jnp.asarray(drafts), jnp.asarray(live),
                                   chunk_step=js.paged_chunk_step)
        out[case] = jax.tree.map(np.asarray, (em, n_em, nxt, cache))
    return out


@pytest.mark.parametrize("case", ROUND_CASES)
def test_speculative_round_matches_jax(models, round_inputs, jax_rounds,
                                       case):
    _, tcfg, _, tparams = models
    pools, table, lengths, last, cases = round_inputs
    drafts, live = cases[case]
    cache = _port_cache(tcfg, pools, table, lengths)
    em, n_em, nxt, cache = ts._speculative_round(
        tparams, tcfg, cache, torch.from_numpy(last),
        torch.from_numpy(drafts), torch.from_numpy(live))
    jem, jn_em, jnxt, jcache = jax_rounds[case]
    assert em.tolist() == jem.tolist()
    assert n_em.tolist() == jn_em.tolist()
    assert nxt.tolist() == jnxt.tolist()
    assert cache.lengths.tolist() == jcache.lengths.tolist()
    for got, want in zip(cache.k + cache.v, jcache.k + jcache.v):
        assert max_abs_err(got, want[..., :tcfg.head_dim]) < FP32_TOL.o
    want_n = {"full": [KD + 1] * 2, "partial": [2, 3], "none": [1, 1],
              "not_live": [KD + 1, 0]}[case]
    assert n_em.tolist() == want_n
    # A row not live keeps its length and its last token.
    assert cache.lengths.tolist() == [
        n + e for n, e in zip(ROUND_LENGTHS, want_n)]
    if case == "not_live":
        assert nxt[1] == last[1]


# -- the host loop ------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_random_draft(models, prompt):
    jcfg, _, jparams, _ = models
    draw = _random_draft(5)
    out = js.speculative_generate(
        jparams, jnp.asarray(prompt), jcfg,
        draft_fn=lambda last, buf: jnp.asarray(draw(last, buf), jnp.int32),
        draft_len=KD, max_new_tokens=MAX_NEW, page_size=PAGE)
    return np.asarray(out)


def test_speculative_generate_random_draft_matches_jax(
        models, prompt, greedy, jax_random_draft):
    _, tcfg, _, tparams = models
    seen = []
    draw = _random_draft(5)

    def draft_fn(last, buf):
        seen.append((last.dtype, buf.dtype, tuple(buf.shape)))
        return draw(last, buf)
    out = ts.speculative_generate(tparams, torch.as_tensor(prompt), tcfg,
                                  draft_fn=draft_fn, draft_len=KD,
                                  max_new_tokens=MAX_NEW, page_size=PAGE)
    assert out.dtype == torch.int32
    assert out.numpy().tolist() == jax_random_draft.tolist()
    assert out.numpy().tolist() == greedy.tolist()
    assert seen[0] == (torch.int32, torch.int32,
                       (BATCH, MAX_NEW + 2 * (KD + 1)))


def test_speculative_zero_and_oracle_drafts_equal_greedy(models, prompt,
                                                          greedy):
    """A useless draft emits one token a round; an oracle draft (the
    greedy continuation itself) accepts fully: 12 tokens in at most 5
    rounds.  Both give the greedy stream."""
    _, tcfg, _, tparams = models
    zero = ts.speculative_generate(
        tparams, torch.as_tensor(prompt), tcfg,
        draft_fn=lambda last, buf: torch.zeros((BATCH, KD),
                                               dtype=torch.int32),
        draft_len=KD, max_new_tokens=MAX_NEW, page_size=PAGE)
    assert zero.numpy().tolist() == greedy.tolist()
    rounds = []

    def oracle(last, buf):
        rounds.append(1)
        out = np.zeros((BATCH, KD), np.int32)
        for r in range(BATCH):
            n = int((buf[r] != -1).sum())
            nxt = greedy[r, PROMPT + n:PROMPT + n + KD]
            out[r, :len(nxt)] = nxt
        return out
    out = ts.speculative_generate(tparams, torch.as_tensor(prompt), tcfg,
                                  draft_fn=oracle, draft_len=KD,
                                  max_new_tokens=MAX_NEW, page_size=PAGE)
    assert out.numpy().tolist() == greedy.tolist()
    assert len(rounds) <= 5


def test_speculative_ragged_acceptance_budget(models, prompt):
    """One row's drafts always rejected, the other's always accepted: the
    fast row finishes early and freezes (its pages stop growing) while
    the slow one drains, inside the 2 (kd + 1) margin of the page
    budget; the output is the all-reject run's."""
    _, tcfg, _, tparams = models
    max_new = 24
    p = torch.as_tensor(prompt)
    reject = torch.full((BATCH, KD), 255, dtype=torch.int32)
    ref = ts.speculative_generate(tparams, p, tcfg,
                                  draft_fn=lambda last, buf: reject,
                                  draft_len=KD, max_new_tokens=max_new,
                                  page_size=PAGE).numpy()

    def draft_fn(last, buf):
        out = np.full((BATCH, KD), 255, np.int32)
        n = int((buf[1] != -1).sum())
        nxt = ref[1, PROMPT + n:PROMPT + n + KD]
        out[1, :len(nxt)] = nxt
        return out
    out = ts.speculative_generate(tparams, p, tcfg, draft_fn=draft_fn,
                                  draft_len=KD, max_new_tokens=max_new,
                                  page_size=PAGE)
    assert out.numpy().tolist() == ref.tolist()


def test_draft_fn_shape_is_checked(models, prompt):
    _, tcfg, _, tparams = models
    with pytest.raises(ValueError, match="draft_fn returned shape"):
        ts.speculative_generate(
            tparams, torch.as_tensor(prompt), tcfg,
            draft_fn=lambda last, buf: np.zeros((BATCH, KD + 1), np.int32),
            draft_len=KD, max_new_tokens=MAX_NEW, page_size=PAGE)


# -- a draft model --------------------------------------------------------------

def _recording(draft_fn, record):
    def run(last, buf):
        drafts = draft_fn(last, buf)
        record.append(np.asarray(drafts).tolist())
        return drafts
    return run


@pytest.fixture(scope="module")
def jax_model_drafts(models, prompt):
    """JAX's self-drafted run: its output and each round's drafts."""
    jcfg, _, jparams, _ = models
    record = []
    draft_fn = js.make_model_draft_fn(
        jparams, jcfg, prompt=jnp.asarray(prompt), draft_len=KD,
        max_new_tokens=MAX_NEW, page_size=PAGE)
    out = js.speculative_generate(
        jparams, jnp.asarray(prompt), jcfg,
        draft_fn=_recording(draft_fn, record), draft_len=KD,
        max_new_tokens=MAX_NEW, page_size=PAGE)
    return np.asarray(out), record


def test_model_draft_fn_same_model_matches_jax(models, prompt, greedy,
                                               jax_model_drafts):
    """The target as its own drafter: every round's drafts equal JAX's
    (the drafter's cache stays in step through the ragged consume and
    the rollbacks), full accepts, the greedy stream in at most 5
    rounds."""
    _, tcfg, _, tparams = models
    record = []
    p = torch.as_tensor(prompt)
    draft_fn = ts.make_model_draft_fn(tparams, tcfg, prompt=p, draft_len=KD,
                                      max_new_tokens=MAX_NEW, page_size=PAGE)
    out = ts.speculative_generate(tparams, p, tcfg,
                                  draft_fn=_recording(draft_fn, record),
                                  draft_len=KD, max_new_tokens=MAX_NEW,
                                  page_size=PAGE)
    want, want_record = jax_model_drafts
    assert record == want_record
    assert out.numpy().tolist() == want.tolist() == greedy.tolist()
    assert len(record) <= 5


def test_model_draft_fn_weak_drafter_still_greedy(models, weak, prompt,
                                                  greedy):
    _, tcfg, _, tparams = models
    _, wcfg, _, wparams = weak
    p = torch.as_tensor(prompt)
    draft_fn = ts.make_model_draft_fn(wparams, wcfg, prompt=p, draft_len=KD,
                                      max_new_tokens=MAX_NEW, page_size=PAGE)
    out = ts.speculative_generate(tparams, p, tcfg, draft_fn=draft_fn,
                                  draft_len=KD, max_new_tokens=MAX_NEW,
                                  page_size=PAGE)
    assert out.numpy().tolist() == greedy.tolist()


@pytest.fixture(scope="module")
def jax_burst(models, prompt):
    """JAX's bursted run with the target as its own drafter."""
    jcfg, _, jparams, _ = models
    return np.asarray(js.speculative_generate_model(
        jparams, jnp.asarray(prompt), jcfg, draft_params=jparams,
        draft_cfg=jcfg, draft_len=KD, max_new_tokens=MAX_NEW,
        page_size=PAGE, rounds_per_dispatch=3))


@pytest.mark.parametrize("drafter", ["self", "weak"])
def test_speculative_generate_model_matches_jax(models, weak, prompt,
                                                greedy, jax_burst, drafter,
                                                monkeypatch):
    """The bursted rounds (3 a dispatch, drafter sync, ragged consume and
    emission scatter on the device) with the target as drafter and with
    a 1-layer one: JAX's self-drafted output, which is the greedy stream
    (the output does not depend on the drafter)."""
    _, tcfg, _, tparams = models
    td = (tparams, tcfg) if drafter == "self" else (weak[3], weak[1])
    kw = dict(draft_len=KD, max_new_tokens=MAX_NEW, page_size=PAGE,
              rounds_per_dispatch=3)
    reads = []
    real = ts._speculative_burst_rounds

    def counted(*args, **kwargs):
        reads.append(kwargs["rounds"])
        return real(*args, **kwargs)
    monkeypatch.setattr(ts, "_speculative_burst_rounds", counted)
    out = ts.speculative_generate_model(
        tparams, torch.as_tensor(prompt), tcfg, draft_params=td[0],
        draft_cfg=td[1], **kw)
    assert out.numpy().tolist() == jax_burst.tolist() == greedy.tolist()
    assert set(reads) == {3}
    if drafter == "self":
        assert len(reads) == 1     # 12 tokens at 4 a round: 3 rounds


# -- Gemma-2 --------------------------------------------------------------------

def test_gemma_speculative_through_chunk_step():
    """Gemma-2 (a sliding window below the prompt, soft caps) through
    ``chunk_step=gemma_paged_chunk_step``: a random draft gives the
    all-reject run's output, which is the port's greedy `gemma_generate`
    (held against JAX in tests/test_torch_gemma.py)."""
    cfg = tg.GemmaConfig.tiny(dtype=torch.float32, sliding_window=24)
    params = _carry(jax.tree.map(np.asarray, jg.init_params(
        jax.random.PRNGKey(1), jg.GemmaConfig.tiny(dtype=jnp.float32,
                                                   sliding_window=24))))
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, 256, (BATCH, PROMPT)).astype(np.int32))
    kw = dict(draft_len=KD, max_new_tokens=8, page_size=PAGE,
              chunk_step=ts.gemma_paged_chunk_step)
    out = ts.speculative_generate(params, prompt, cfg,
                                  draft_fn=_random_draft(11), **kw)
    reject = ts.speculative_generate(
        params, prompt, cfg,
        draft_fn=lambda last, buf: np.full((BATCH, KD), 255), **kw)
    assert out.tolist() == reject.tolist()
    assert out.tolist() == ts.gemma_generate(params, prompt, cfg,
                                             max_new_tokens=8).tolist()
