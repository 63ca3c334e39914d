"""Multi-adapter LoRA in the port against the JAX package's
`models/lora.py`, on `LlamaConfig.tiny(n_layers=2)` in float32 with the
weights and the adapters carried from JAX through numpy.

- `apply_lora`, `loss_fn(lora=)` and its gradient with respect to every
  adapter leaf against `jax.value_and_grad` (FP32 tier: the loss at
  2e-5, each gradient at 1e-4 of its largest entry, as
  tests/test_torch_train.py holds the base model's);
- three `make_lora_train_step` steps against JAX's with `optax.adamw`
  (1% of the most a weight can move in them, as the AdamW test there,
  for every entry whose first gradient is not near zero; 1e-6 for the
  unused adapters' entries, whose gradient is exactly zero and which
  move by weight decay alone);
- `paged_chunk_step` / `paged_decode_step` with mixed ``lora_ids``
  against the JAX steps (FP32 tier on the logits);
- the engine with ``lora=`` against the JAX engine, streams token for
  token by `step()` and by `step_burst(4)` (greedy float32: the logits
  agree to ~1e-5, far inside these weights' argmax margins); adapter 0
  against the engine without LoRA; the prefix cache keyed by adapter
  (the JAX engine keys it by tokens alone, so this holds the port
  against itself without the cache); JAX's validation errors;
- `init_lora_adapters`: shapes, adapter 0's B = 0, alpha folded into B,
  and A's variance within 4 sigma of 1/in.

One JAX engine configuration (16-token pages, prompts of whole pages)
serves every engine case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import lora as jlora
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu.models.engine import ServingEngine as JEngine
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models import lora as tlora
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.models.engine import (
    ServingEngine as TEngine,
)
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    max_abs_err,
)
from metal_flash_attention_tpu_torch.utils.tree import flatten, leaf_paths

N_ADAPTERS, RANK = 4, 8
LOSS_TOL = 2e-5
GRAD_REL_TOL = 1e-4
ADAM_LR, ADAM_STEPS = 1e-2, 3
ADAM_TOL = 0.01 * ADAM_LR * ADAM_STEPS
NEAR_ZERO_GRAD = 1e-6
WEIGHT_DECAY_TOL = 1e-6
LOGIT_TOL = 1e-4
PAGE = 16
ARGS = dict(max_batch=2, num_pages=32, page_size=PAGE, max_seq=128)
PROMPT_LENS = (32, 16, 16)
MAX_NEW = (9, 6, 7)
LORA_IDS = (1, 2, 3)


@pytest.fixture(scope="module")
def setup():
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jnp.float32)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=torch.float32)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    jad = jlora.init_lora_adapters(jax.random.PRNGKey(1), jcfg,
                                   n_adapters=N_ADAPTERS, rank=RANK,
                                   b_scale=0.3)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    tad = params_from_numpy(jax.tree.map(np.asarray, jad),
                            dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (2, 33)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, jad, tad, tokens


def _close(got, want, tol):
    assert max_abs_err(got, np.asarray(want)) <= tol


def test_adapter_tree_carries_across(setup):
    *_, jad, tad, _ = setup
    assert tad["rank"] == RANK and isinstance(tad["rank"], int)
    a, b = tad["layers"][1]["wk"]
    assert isinstance(tad["layers"][1]["wk"], tuple)
    assert a.shape == (N_ADAPTERS, 128, RANK) and b.shape == (N_ADAPTERS,
                                                              RANK, 64)
    assert np.array_equal(b.numpy(), np.asarray(jad["layers"][1]["wk"][1]))


def test_apply_lora_matches_jax(setup):
    *_, jad, tad, _ = setup
    h = np.random.default_rng(1).standard_normal((3, 5, 128)).astype(
        np.float32)
    ids = np.array([2, 0, 3], np.int32)
    want = jlora.apply_lora(jnp.asarray(h), jad["layers"][0]["wq"],
                            jnp.asarray(ids))
    got = tlora.apply_lora(torch.from_numpy(h), tad["layers"][0]["wq"],
                           torch.from_numpy(ids))
    assert got.shape == (3, 5, 128)
    _close(got, want, FP32_TOL.o)


def test_loss_and_adapter_gradients_match_jax(setup):
    jcfg, tcfg, jparams, tparams, jad, tad, tokens = setup
    ids = np.array([1, 3], np.int32)

    def jloss(layers):
        return jl.loss_fn(jparams, jnp.asarray(tokens), jcfg,
                          lora={"rank": RANK, "layers": layers},
                          lora_ids=jnp.asarray(ids))
    jval, jgrads = jax.value_and_grad(jloss)(jad["layers"])

    tval, tgrads = _adapter_grads(setup, ids)
    assert abs(float(tval) - float(jval)) <= LOSS_TOL
    jflat = _jax_leaves(jgrads)
    assert len(jflat) == len(tgrads)
    for key, g in zip(leaf_paths(tad["layers"]), tgrads):
        want = jflat[key]
        scale = float(np.abs(want).max())
        assert scale > 0, key           # ids 1 and 3 both train
        assert max_abs_err(g, want) <= GRAD_REL_TOL * scale, key
    # Rows of adapters 0 and 2 took no part: their gradient is zero.
    a, b = tgrads[0], tgrads[1]
    for unused in (0, 2):
        assert not a[unused].any() and not b[unused].any()


def test_lora_train_steps_match_optax(setup):
    jcfg, tcfg, jparams, tparams, jad, tad, tokens = setup
    ids = np.array([1, 2], np.int32)
    tx = optax.adamw(ADAM_LR)
    jstep = jax.jit(jlora.make_lora_train_step(tx, jcfg))
    jstate = tx.init(jad["layers"])
    jcur = jad
    jlosses = []
    for _ in range(ADAM_STEPS):
        jcur, jstate, loss = jstep(jcur, jstate, jparams,
                                   jnp.asarray(tokens), jnp.asarray(ids))
        jlosses.append(float(loss))

    tcur = params_from_numpy(jax.tree.map(np.asarray, jad),
                             dtype=torch.float32, device="cpu")
    init_fn, step_fn = tlora.make_lora_train_step(
        tcfg, lambda ts_: torch.optim.AdamW(ts_, lr=ADAM_LR,
                                            weight_decay=1e-4))
    state = init_fn(tcur)
    tlosses = []
    for _ in range(ADAM_STEPS):
        tcur, state, loss = step_fn(tcur, state, tparams,
                                    torch.from_numpy(tokens),
                                    torch.from_numpy(ids))
        tlosses.append(float(loss))
    assert np.allclose(tlosses, jlosses, rtol=0, atol=LOSS_TOL), (
        tlosses, jlosses)
    assert tlosses[-1] < tlosses[0]
    # Entries with exactly zero gradient (the rows of adapters 0 and 3,
    # which no row uses) move by weight decay alone, so they match JAX to
    # WEIGHT_DECAY_TOL.  Adam divides each gradient by its own running
    # rms, so an entry whose gradient is near zero but not zero (|g|
    # below NEAR_ZERO_GRAD, ~100 x eps) takes a step whose size the
    # gradient's last bits decide: those few are held to the most Adam
    # can move them, the rest to ADAM_TOL.
    _, first = _adapter_grads(setup, ids)
    start = flatten(tad["layers"])[0]
    for key, tp, t0, g in zip(leaf_paths(tcur["layers"]),
                              flatten(tcur["layers"])[0], start, first):
        want = _jax_leaves(jcur["layers"])[key]
        err = (tp - torch.from_numpy(want)).abs()
        zero = g == 0
        assert zero[[0, 3]].all() and not zero[[1, 2]].any(), key
        assert float(err[zero].max()) <= WEIGHT_DECAY_TOL, key
        tiny = ~zero & (g.abs() < NEAR_ZERO_GRAD)
        assert float(tiny.float().mean()) < 0.01, key
        live = g.abs() >= NEAR_ZERO_GRAD
        assert float(err[live].max()) <= ADAM_TOL, key
        moved = (tp - t0).abs()[tiny]
        assert not moved.numel() or float(moved.max()) <= (
            ADAM_LR * ADAM_STEPS * 1.01), key
    # The base took no gradient and no optimizer state.
    assert all(not p.requires_grad and p.grad is None
               for p in flatten(tparams)[0])
    assert len(state["shadow"]) == len(flatten(tad["layers"])[0])


def _jax_leaves(tree) -> dict:
    """A JAX tree's leaves as numpy, keyed by path (JAX orders a dict's
    leaves by key, the port by insertion)."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _adapter_grads(setup, ids):
    """The port's loss gradient w.r.t. every adapter leaf, in
    `flatten`'s order."""
    _, tcfg, _, tparams, _, tad, tokens = setup
    leaves, rebuild = flatten(tad["layers"])
    work = [x.detach().requires_grad_(True) for x in leaves]
    loss = tl.loss_fn(tparams, torch.from_numpy(tokens), tcfg,
                      lora={"rank": RANK, "layers": rebuild(work)},
                      lora_ids=torch.from_numpy(ids))
    return loss.detach(), torch.autograd.grad(loss, work)


def test_paged_steps_with_mixed_adapters_match_jax(setup):
    jcfg, tcfg, jparams, tparams, jad, tad, tokens = setup
    ids = np.array([3, 1], np.int32)
    prompt = tokens[:, :PAGE]
    jcache = js.init_paged_model_cache(jcfg, 2, 64, page_size=PAGE)
    jl_chunk, jcache = js.paged_chunk_step(
        jparams, jnp.asarray(prompt), jcfg, jcache, lora=jad,
        lora_ids=jnp.asarray(ids))
    tcache = ts.init_paged_model_cache(tcfg, 2, 64, page_size=PAGE,
                                       device="cpu")
    tl_chunk, tcache = ts.paged_chunk_step(
        tparams, torch.from_numpy(prompt), tcfg, tcache, lora=tad,
        lora_ids=torch.from_numpy(ids))
    _close(tl_chunk, jl_chunk, LOGIT_TOL)
    tok = tokens[:, PAGE]
    jl_dec, _ = js.paged_decode_step(jparams, jnp.asarray(tok), jcfg,
                                     jcache, lora=jad,
                                     lora_ids=jnp.asarray(ids))
    tl_dec, _ = ts.paged_decode_step(tparams, torch.from_numpy(tok), tcfg,
                                     tcache, lora=tad,
                                     lora_ids=torch.from_numpy(ids))
    _close(tl_dec, jl_dec, LOGIT_TOL)
    # Each row took its own adapter: swapping the ids moves the logits.
    swapped, _ = ts.paged_chunk_step(
        tparams, torch.from_numpy(prompt), tcfg,
        ts.init_paged_model_cache(tcfg, 2, 64, page_size=PAGE,
                                  device="cpu"), lora=tad,
        lora_ids=torch.from_numpy(ids[::-1].copy()))
    assert max_abs_err(swapped, tl_chunk) > 1e-2


def _prompts(vocab):
    rng = np.random.default_rng(7)
    return [rng.integers(0, vocab, (n,)).astype(np.int32)
            for n in PROMPT_LENS]


def _drain(eng, burst=0, limit=200):
    for _ in range(limit):
        if eng.idle:
            return
        eng.step_burst(burst) if burst else eng.step()
    raise AssertionError("engine did not drain")


def _serve(eng, prompts, ids, burst=0):
    rids = [eng.submit(p, m, lora_id=i)
            for p, m, i in zip(prompts, MAX_NEW, ids)]
    _drain(eng, burst)
    return [eng.result(r).tolist() for r in rids]


@pytest.fixture(scope="module")
def jax_streams(setup):
    jcfg, _, jparams, _, jad, _, _ = setup
    prompts = _prompts(jcfg.vocab_size)
    mixed = _serve(JEngine(jparams, jcfg, lora=jad, **ARGS), prompts,
                   LORA_IDS, burst=4)
    return prompts, mixed


@pytest.mark.parametrize("burst", [0, 4])
def test_engine_with_mixed_adapters_matches_jax(setup, jax_streams, burst):
    """Three requests on adapters 1, 2 and 3, two slots: each step's
    batch mixes adapters, and a slot changes adapter when a request
    retires."""
    _, tcfg, _, tparams, _, tad, _ = setup
    prompts, want = jax_streams
    got = _serve(TEngine(tparams, tcfg, lora=tad, **ARGS), prompts,
                 LORA_IDS, burst=burst)
    assert got == want


def test_adapter_zero_is_the_base_engine(setup, jax_streams):
    _, tcfg, _, tparams, _, tad, _ = setup
    prompts, mixed = jax_streams
    base = _serve(TEngine(tparams, tcfg, **ARGS), prompts, (0, 0, 0))
    assert _serve(TEngine(tparams, tcfg, lora=tad, **ARGS), prompts,
                  (0, 0, 0), burst=4) == base
    assert base != mixed                 # the adapters act


def test_prefix_cache_keys_pages_by_adapter(setup):
    """Two adapters share one 3-page prompt: the second adapter's request
    finds none of the first's pages (its delta is in the K/V), a later
    request on the first adapter borrows two, and every stream equals
    the engine's without the cache."""
    _, tcfg, _, tparams, _, tad, _ = setup
    prompt = np.random.default_rng(9).integers(
        0, tcfg.vocab_size, (3 * PAGE,)).astype(np.int32)
    plain = TEngine(tparams, tcfg, lora=tad, **ARGS)
    want = {i: _serve(plain, [prompt], (i,))[0] for i in (1, 2)}
    assert want[1] != want[2]
    eng = TEngine(tparams, tcfg, lora=tad, prefix_cache=True, **ARGS)
    for lora_id, hit in ((1, 0), (2, 0), (1, 2 * PAGE)):
        before = eng.prefix_cache.hit_tokens
        assert _serve(eng, [prompt], (lora_id,)) == [want[lora_id]]
        assert eng.prefix_cache.hit_tokens - before == hit, lora_id


def test_engine_lora_validation_matches_jax(setup):
    jcfg, tcfg, jparams, tparams, jad, tad, _ = setup
    prompt = np.zeros((4,), np.int32)
    for make, params, adapters in ((JEngine, jparams, jad),
                                   (TEngine, tparams, tad)):
        cfg = jcfg if make is JEngine else tcfg
        with pytest.raises(ValueError, match="without lora"):
            make(params, cfg, **ARGS).submit(prompt, 2, lora_id=1)
        eng = make(params, cfg, lora=adapters, **ARGS)
        for bad in (-1, N_ADAPTERS):
            with pytest.raises(ValueError, match="out of range"):
                eng.submit(prompt, 2, lora_id=bad)
        for kw in (dict(kv_precision="int8"),
                   dict(chunk_step=lambda *a, **k: None),
                   dict(decode_step=lambda *a, **k: None),
                   dict(draft_fn=lambda *a: None, draft_len=2)):
            with pytest.raises(ValueError, match="lora rides"):
                make(params, cfg, lora=adapters, **ARGS, **kw)


def test_init_lora_adapters():
    cfg = tl.LlamaConfig.tiny(n_layers=2, dim=256, n_heads=4, n_kv_heads=2,
                              dtype=torch.float32)

    def make(**kw):
        return tlora.init_lora_adapters(
            cfg, 3, RANK, generator=torch.Generator().manual_seed(5),
            device="cpu", **kw)
    zero = make()
    assert zero["rank"] == RANK and len(zero["layers"]) == 2
    dims = {"wq": (256, 256), "wk": (256, 128), "wv": (256, 128),
            "wo": (256, 256)}
    for layer in zero["layers"]:
        assert sorted(layer) == sorted(tlora.ATTN_PROJS)
        for name, (a, b) in layer.items():
            assert a.shape == (3, dims[name][0], RANK)
            assert b.shape == (3, RANK, dims[name][1])
            assert not b.any()
    rand = make(b_scale=0.5)
    doubled = make(b_scale=0.5, alpha=2 * RANK)
    for layer, layer2, layer0 in zip(rand["layers"], doubled["layers"],
                                     zero["layers"]):
        for name, (a, b) in layer.items():
            assert not b[0].any() and b[1:].all()
            assert torch.equal(a, layer0[name][0])
            assert torch.equal(layer2[name][1], 2 * b)
    # A ~ N(0, 1/in): the sample variance of n draws has a standard
    # deviation of sqrt(2 / (n - 1)) times the variance.
    a = torch.cat([x[0].reshape(-1) for layer in zero["layers"]
                   for n, x in layer.items() if n != "wo"])
    n = a.numel()
    var = float(a.var()) * 256
    assert abs(var - 1.0) <= 4 * np.sqrt(2.0 / (n - 1)), var
    only_q = tlora.init_lora_adapters(
        cfg, 2, 4, projs=("wq",), generator=torch.Generator(),
        device="cpu")
    assert list(only_q["layers"][0]) == ["wq"]
    with pytest.raises(ValueError):
        tlora.init_lora_adapters(cfg, 2, 4, projs=("w_up",),
                                 generator=torch.Generator(), device="cpu")
