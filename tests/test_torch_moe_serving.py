"""Mixtral-style MoE serving in the port against the JAX package: the
paged steps are family-polymorphic (`serving._ffn_block` routes a layer
that carries an expert bank), so `paged_chunk_step`, the
`ServingEngine` with its bursts and a ``draft_fn`` serve an MoE
checkpoint.

One float32 configuration, `MoEConfig.tiny(n_layers=2, top_k=1)`, and
16-token pages.  Top-1, so that a decode step of the engine's two rows
can overflow an expert: its capacity is max(ceil(1.25 * 2 * 1 / 4), 1)
= 1, and two rows on one expert drop the second (at top-2 the capacity
is at least 2 and two rows never overflow).  Streams must equal the JAX
engine's token for token (greedy float32: the logits agree to ~1e-5).
The dense and quantized steps refuse MoE layers, as in the JAX package,
whose dense and quantized steps call `llama.mlp_block`.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import moe as jm
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu.models.engine import ServingEngine as JEngine
from metal_flash_attention_tpu_torch.models import moe as tm
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.models.engine import (
    ServingEngine as TEngine,
)
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    max_abs_err,
)

PAGE = 16
PROMPT_LENS = (16, 24, 8)
MAX_NEW = (9, 6, 12)
ENGINE = dict(max_batch=2, num_pages=16, page_size=PAGE, max_seq=64)


@pytest.fixture(scope="module")
def models():
    jcfg = jm.MoEConfig.tiny(n_layers=2, top_k=1, dtype=jnp.float32)
    tcfg = tm.MoEConfig.tiny(n_layers=2, top_k=1, dtype=torch.float32)
    jparams = jm.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(61)
    prompts = [rng.integers(0, jcfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    return jcfg, tcfg, jparams, tparams, prompts


def test_paged_chunk_step_matches_jax(models):
    """A 40-token prompt in chunks of 16, 16 and 8 (each chunk routed on
    its own): every position's logits.  JAX's step is jitted as the JAX
    engine jits it, on the engine's cache shapes (its pools, one
    request's row of the page table), so the engine tests below reuse
    its compiles."""
    jcfg, tcfg, jparams, tparams, prompts = models
    prompt = np.concatenate([prompts[1], prompts[0]])
    pages = np.zeros((1, ENGINE["max_seq"] // PAGE), np.int32)
    pages[0, :3] = [1, 2, 3]
    shape = (ENGINE["num_pages"], jcfg.n_kv_heads, PAGE)
    lanes = -(-jcfg.head_dim // 128) * 128
    jk, jv = ([jnp.zeros(shape + (lanes,), jcfg.dtype)
               for _ in range(jcfg.n_layers)] for _ in range(2))
    tk, tv = ([torch.zeros(shape + (tcfg.head_dim,), dtype=tcfg.dtype)
               for _ in range(tcfg.n_layers)] for _ in range(2))
    chunk = jax.jit(js.paged_chunk_step, static_argnames=("cfg",),
                    donate_argnums=(3,))
    for i in range(0, len(prompt), PAGE):
        part = prompt[None, i:i + PAGE]
        jlog, jcache = chunk(jparams, jnp.asarray(part), jcfg,
                             js.PagedModelCache(
                                 k=tuple(jk), v=tuple(jv),
                                 page_table=jnp.asarray(pages),
                                 lengths=jnp.full((1,), i, jnp.int32)))
        jk, jv = jcache.k, jcache.v
        tlog, tcache = ts.paged_chunk_step(
            tparams, torch.as_tensor(part), tcfg, ts.PagedModelCache(
                k=tuple(tk), v=tuple(tv),
                page_table=torch.as_tensor(pages),
                lengths=torch.full((1,), i, dtype=torch.int32)))
        assert max_abs_err(tlog, jlog) < FP32_TOL.o
    assert tcache.lengths.tolist() == [len(prompt)]


def test_last_writes_on_repeated_targets():
    slots = torch.tensor([5, 3, 5, 7, 3, 5, 0])
    assert ts._last_writes(slots).tolist() == [5, 4, 5, 3, 4, 5, 6]


@pytest.mark.parametrize("kc", [1, 3])
def test_routed_writes_to_one_slot_carry_the_last_rows_values(models, kc):
    """Two idle rows (1 and 3, at length 0 on the null page) beside two
    live ones: after `_take_writes` every write to a shared slot carries
    the last row's values, so a scatter in any order leaves what a
    sequential one leaves; a dense model and a single row keep theirs."""
    _, tcfg, _, tparams, _ = models
    cache = ts.init_paged_model_cache(tcfg, 4, 2 * PAGE, page_size=PAGE,
                                      device="cpu")
    cache = cache._replace(
        page_table=torch.tensor([[1, 2], [0, 0], [3, 4], [0, 0]],
                                dtype=torch.int32),
        lengths=torch.tensor([5, 0, 17, 0], dtype=torch.int32))
    order = ts._routed_write_order(tparams, cache, kc)
    new = torch.randn(4, tcfg.n_kv_heads, kc, tcfg.head_dim,
                      generator=torch.Generator().manual_seed(3))
    taken = ts._take_writes(new, order)
    assert torch.equal(taken[1], new[3]) and torch.equal(taken[3], new[3])
    assert torch.equal(taken[[0, 2]], new[[0, 2]])

    def scatter(vals, rows):
        pool = torch.zeros_like(cache.k[0])
        for r in rows:
            for j in range(kc):
                pos = int(cache.lengths[r]) + j
                pool[cache.page_table[r, pos // PAGE], :, pos % PAGE] = \
                    vals[r, :, j]
        return pool
    assert torch.equal(scatter(taken, [3, 2, 1, 0]),
                       scatter(new, [0, 1, 2, 3]))
    dense = dict(tparams, layers=[{k: v for k, v in layer.items()
                                   if k != "moe"}
                                  for layer in tparams["layers"]])
    assert ts._routed_write_order(dense, cache, kc) is None
    one = cache._replace(page_table=cache.page_table[:1],
                         lengths=cache.lengths[:1])
    assert ts._routed_write_order(tparams, one, kc) is None
    assert ts._take_writes(new, None) is new


def _drain(eng, burst=0, limit=200):
    streamed = {}
    for _ in range(limit):
        if eng.idle:
            return streamed
        for rid, tok in (eng.step_burst(burst) if burst else eng.step()):
            streamed.setdefault(rid, []).append(tok)
    raise AssertionError("engine did not drain")


def _serve(eng, prompts, burst=0):
    rids = [eng.submit(p, m) for p, m in zip(prompts, MAX_NEW)]
    streamed = _drain(eng, burst)
    return [eng.result(r).tolist() for r in rids], [streamed[r]
                                                    for r in rids]


@pytest.fixture(scope="module")
def port_streams(models):
    """The port engine's run by `step()`, and the choices each decode
    step dropped."""
    _, tcfg, _, tparams, prompts = models
    decode_drops = []
    real = tm._slots

    def slots(topi, n_experts, capacity):
        slot, kept = real(topi, n_experts, capacity)
        if topi.shape[0] == ENGINE["max_batch"]:
            decode_drops.append(int((~kept).sum()))
        return slot, kept
    teng = TEngine(tparams, tcfg, **ENGINE)
    with mock.patch.object(tm, "_slots", slots):
        streams = _serve(teng, prompts)
    return streams, decode_drops, teng.alloc.free_pages


def test_engine_streams_match_jax(models, port_streams):
    """Three requests through two slots (one waits for a slot), every
    decode step routing both rows (an idle one rides along on token 0),
    some of them over an expert's capacity."""
    jcfg, _, jparams, _, prompts = models
    want = _serve(JEngine(jparams, jcfg, **ENGINE), prompts)
    got, decode_drops, free_pages = port_streams
    assert got == want
    assert sum(decode_drops) > 0
    assert free_pages == ENGINE["num_pages"] - 1


def test_engine_burst_equals_step(models, port_streams):
    """Bursts run only once the queue is empty (a request admitted
    later in a burst than in `step()` would meet other rows), and a row
    that stops inside a burst rides along as an idle slot; so the
    streams are `step()`'s, also where the short request in slot 0
    stops in the first burst and the other decodes on beside it."""
    _, tcfg, _, tparams, prompts = models
    burst = _serve(TEngine(tparams, tcfg, **ENGINE), prompts, burst=4)
    assert burst == port_streams[0]
    pair, budgets = [prompts[2], prompts[0]], (5, 24)
    runs = []
    for k in (0, 8):
        eng = TEngine(tparams, tcfg, **ENGINE)
        rids = [eng.submit(p, m) for p, m in zip(pair, budgets)]
        _drain(eng, burst=k)
        runs.append([eng.result(r).tolist() for r in rids])
    assert runs[1] == runs[0]


def test_speculative_engine_matches_jax(models):
    """``draft_fn`` with a random draft (the same numpy stream in both
    engines): each verify round routes both rows' draft_len + 1 tokens
    together, as JAX's does."""
    jcfg, tcfg, jparams, tparams, prompts = models

    def draft(seed=5):
        rng = np.random.default_rng(seed)
        return lambda last, history: rng.integers(
            0, jcfg.vocab_size, (last.shape[0], 2))
    args = dict(ENGINE, draft_len=2)
    want = _serve(JEngine(jparams, jcfg, draft_fn=draft(), **args),
                  prompts)
    got = _serve(TEngine(tparams, tcfg, draft_fn=draft(), **args), prompts)
    assert got == want


def _dense_calls(tcfg, tparams):
    tok = torch.zeros((1,), dtype=torch.int32)
    cache = ts.init_cache(tcfg, 1, 16, device="cpu")
    _, filled = ts.prefill(
        dict(tparams, layers=[]), tok[None], tcfg, ts.init_cache(
            tcfg, 1, 16, device="cpu"))
    qcache = ts.quantize_cache(filled, "int8")
    pcache = ts.init_quantized_paged_model_cache(
        tcfg, 1, 32, precision="int8", page_size=PAGE, device="cpu")
    return {
        "prefill": lambda: ts.prefill(tparams, tok[None], tcfg, cache),
        "decode_step": lambda: ts.decode_step(tparams, tok, tcfg, cache),
        "decode_step_quantized": lambda: ts.decode_step_quantized(
            tparams, tok, tcfg, qcache),
        "paged_chunk_step_q": lambda: ts.paged_chunk_step_q(
            tparams, tok[None], tcfg, pcache),
        "paged_decode_step_q": lambda: ts.paged_decode_step_q(
            tparams, tok, tcfg, pcache),
    }


@pytest.mark.parametrize("step", ["prefill", "decode_step",
                                  "decode_step_quantized",
                                  "paged_chunk_step_q",
                                  "paged_decode_step_q"])
def test_dense_and_quantized_steps_refuse_moe_layers(models, step):
    _, tcfg, _, tparams, _ = models
    with pytest.raises(NotImplementedError,
                       match="paged bf16 steps only"):
        _dense_calls(tcfg, tparams)[step]()


def test_paged_steps_refuse_a_mesh(models):
    _, tcfg, _, tparams, _ = models
    cache = ts.init_paged_model_cache(tcfg, 1, 16, page_size=PAGE,
                                      device="cpu")
    tok = torch.zeros((1,), dtype=torch.int32)
    # Tensor-parallel serving is ported (slice 19,
    # tests/test_torch_serving_tp.py): a mesh that is not one is refused.
    with pytest.raises(TypeError, match="DeviceMesh"):
        ts.paged_decode_step(tparams, tok, tcfg, cache, mesh=object())
