"""The docs' code snippets (README.md, docs/), as `tests/test_docs_examples.py`
runs them against the JAX package, written against the port's public API
(`metal_flash_attention_tpu_torch as mfa`, torch tensors) and held
against the JAX snippet on the same seeded numpy inputs.

One case per case of the JAX file except the profiling one
(`tests/test_torch_profiling.py` holds that).  Each still checks what
the snippet checks (shapes, dtypes, no NaN), and where the JAX snippet
fed all-zero inputs (the quickstart), both take seeded ones instead, so
that the comparison compares something.  Tolerances (the tiers of
`utils/tolerances.py`):

- bf16 attention (the quickstart, the dispatch facade, FP8 K/V, dense and
  paged decode, ring and head-parallel attention): o by max abs error at
  MIXED_TOL.o (5e-2); the quantized caches hold the same scales in both
  packages, so the tier is the same;
- `gemm`: relative to the output's largest value, MIXED_TOL.o for the
  INT8 weight (bf16 output), FP32_TOL.o for fp32 memory with bf16
  registers (both round the operands to bf16 and sum in float32);
- the pipeline (float32): FP32_TOL.o;
- training (bf16 tiny Llama, AdamW at optax.adamw(3e-4)'s settings): each
  step's loss at MIXED_TOL.lse (7e-3), and the float32 master weights'
  two-step update: at most ADAM_FLIP_SHARE of them off by more than the
  rate (a weight whose bf16 gradient is near 0 steps either way);
- the decode loop: the port is fed JAX's greedy tokens (teacher forcing)
  and its logits are held at MIXED_TOL.o, since the tiny random model's
  near-tied logits can break a bf16 argmax either way; the port's own
  greedy loop must still equal its own `generate`, as the snippet asks.

The two eight-device examples run in ONE spawn of 8 gloo ranks
(`tests/_torch_tp_workers.py`, `docs_body`, no JAX in the ranks) beside
JAX on the 8 virtual CPU devices of `tests/conftest.py`.  On the card
they would need 8 GPUs; they run on the CPU only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_workers as w
import metal_flash_attention_tpu as jmfa
import metal_flash_attention_tpu_torch as mfa
from metal_flash_attention_tpu.descriptors.precision import (
    OperandPrecision as JPrecision,
)
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
)
from metal_flash_attention_tpu_torch.utils.tree import flatten


# The training guide's AdamW rate, and the share of float32 master weights
# whose two-step update may differ from optax's by more than one step:
# AdamW moves every weight by about the rate whatever its gradient's
# size, so a weight whose bf16 gradient is near 0 steps either way in
# either package (0.07% to 0.8% of a leaf's elements on this model).  A
# wrong rate, sign or bias correction moves every element.
ADAM_LR = 3e-4
ADAM_FLIP_SHARE = 1e-2


def _pair(x, dtype="bfloat16"):
    """A numpy array as (JAX array, torch tensor) of one dtype."""
    return (jnp.asarray(x, getattr(jnp, dtype)),
            torch.as_tensor(np.asarray(x, np.float32)).to(
                getattr(torch, dtype)))


def _normal(rng, *shapes):
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _close(got, want, tol):
    assert max_abs_err(got, np.asarray(want, np.float32)) <= tol


def test_readme_quickstart_shapes():
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (_pair(x) for x in _normal(
        rng, (2, 8, 256, 64), (2, 2, 256, 64), (2, 2, 256, 64)))
    o = mfa.flash_attention(q, k, v, causal=True)
    assert o.shape == q.shape
    _close(o, jmfa.flash_attention(jq, jk, jv, causal=True), MIXED_TOL.o)

    mask = rng.random((2, 8, 256, 256)) < 0.8
    (jb, b), = (_pair(x, "float32") for x in _normal(rng, (2, 8, 256, 256)))
    o = mfa.flash_attention(q, k, v, mask=torch.as_tensor(mask), bias=b,
                            window_size=128)
    _close(o, jmfa.flash_attention(jq, jk, jv, mask=jnp.asarray(mask),
                                   bias=jb, window_size=128), MIXED_TOL.o)
    ids = np.sort(rng.integers(0, 3, (2, 256)), axis=1).astype(np.int32)
    o = mfa.flash_attention(q, k, v, q_segment_ids=torch.as_tensor(ids),
                            kv_segment_ids=torch.as_tensor(ids), causal=True)
    assert o.shape == q.shape
    _close(o, jmfa.flash_attention(jq, jk, jv, q_segment_ids=jnp.asarray(ids),
                                   kv_segment_ids=jnp.asarray(ids),
                                   causal=True), MIXED_TOL.o)
    # precision-mode lines
    o = mfa.flash_attention(q, k, v, low_precision_intermediates=True)
    o32 = mfa.flash_attention(q, k, v, out_dtype=torch.float32)
    assert o.dtype == torch.bfloat16 and o32.dtype == torch.float32
    _close(o, jmfa.flash_attention(jq, jk, jv,
                                   low_precision_intermediates=True),
           MIXED_TOL.o)
    _close(o32, jmfa.flash_attention(jq, jk, jv, out_dtype=jnp.float32),
           MIXED_TOL.o)


def test_migration_guide_dispatch_facade():
    from metal_flash_attention_tpu.dispatch import (
        build_attention as jbuild_attention,
    )
    from metal_flash_attention_tpu_torch.dispatch import build_attention

    shape = dict(batch=2, q_heads=8, kv_heads=2, q_len=256, kv_len=256,
                 head_dim=64, causal=True)
    fn = build_attention(mfa.AttentionDescriptor(**shape))
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (_pair(x) for x in _normal(
        rng, (2, 8, 256, 64), (2, 2, 256, 64), (2, 2, 256, 64)))
    o = fn(q, k, v)
    assert o.shape == q.shape and not bool(torch.isnan(o).any())
    jo = jbuild_attention(jmfa.AttentionDescriptor(**shape))(jq, jk, jv)
    _close(o, jo, MIXED_TOL.o)


def test_migration_guide_quantized_kv():
    rng = np.random.default_rng(0)
    (jq, q), (jk, k), (jv, v) = (_pair(x) for x in _normal(
        rng, (1, 4, 128, 64), (1, 2, 128, 64), (1, 2, 128, 64)))
    kq = mfa.quantize(k, OperandPrecision.FP8_E4M3)
    vq = mfa.quantize(v, OperandPrecision.FP8_E4M3)
    o = mfa.flash_attention(q, kq, vq)
    assert o.shape == q.shape and not bool(torch.isnan(o).any())
    jo = jmfa.flash_attention(jq, jmfa.quantize(jk, JPrecision.FP8_E4M3),
                              jmfa.quantize(jv, JPrecision.FP8_E4M3))
    _close(o, jo, MIXED_TOL.o)


def test_migration_guide_gemm_per_operand():
    """The GEMM per-operand-precision snippet: a quantized B operand and
    fp32-memory / bf16-register demotion through the top-level API."""
    rng = np.random.default_rng(0)
    (jx, x), = (_pair(a) for a in _normal(rng, (96, 160)))
    (jw, wt), = (_pair(a, "float32") for a in _normal(rng, (160, 64)))
    qb = mfa.quantize_matrix(wt, mfa.OperandPrecision.INT8,
                             contract_axis=0, per_channel=True)
    y = mfa.gemm(x, qb)
    ref = x.float() @ wt
    assert float((y.float() - ref).abs().max()) < (
        0.02 * float(ref.abs().max()))
    jy = jmfa.gemm(jx, jmfa.quantize_matrix(jw, jmfa.OperandPrecision.INT8,
                                            contract_axis=0,
                                            per_channel=True))
    jy = np.asarray(jy, np.float32)
    assert max_abs_err(y, jy) <= MIXED_TOL.o * np.abs(jy).max()

    (ja, a), = (_pair(m, "float32") for m in _normal(rng, (64, 128)))
    (jb, b), = (_pair(m, "float32") for m in _normal(rng, (128, 64)))
    y16 = mfa.gemm(a, b, register_precision="bf16")
    assert y16.dtype == torch.float32  # memory dtype preserved
    assert float((y16 - a @ b).abs().max()) < 0.1 * float(
        (a @ b).abs().max())
    jy16 = np.asarray(jmfa.gemm(ja, jb, register_precision="bf16"))
    assert max_abs_err(y16, jy16) <= FP32_TOL.o * np.abs(jy16).max()


def test_serving_guide_dense_decode():
    rng = np.random.default_rng(0)
    batch, qh, kvh, d, s = 2, 8, 2, 64, 256
    (jqt, qt), (jk, k), (jv, v) = (_pair(x) for x in _normal(
        rng, (batch, qh, d), (batch, kvh, s, d), (batch, kvh, s, d)))
    lens = torch.tensor([s, 100], dtype=torch.int32)
    jlens = jnp.asarray([s, 100], jnp.int32)
    o = mfa.flash_decode(qt, k, v, kv_lens=lens)
    assert o.shape == qt.shape
    _close(o, jmfa.flash_decode(jqt, jk, jv, kv_lens=jlens), MIXED_TOL.o)
    kq = mfa.quantize(k, OperandPrecision.INT8)
    vq = mfa.quantize(v, OperandPrecision.INT8)
    o = mfa.flash_decode(qt, kq, vq, kv_lens=lens)
    assert not bool(torch.isnan(o).any())
    jo = jmfa.flash_decode(jqt, jmfa.quantize(jk, JPrecision.INT8),
                           jmfa.quantize(jv, JPrecision.INT8), kv_lens=jlens)
    _close(o, jo, MIXED_TOL.o)


def test_serving_guide_paged_pool():
    from metal_flash_attention_tpu.ops import paged_attention as jpa
    from metal_flash_attention_tpu_torch.ops.paged_attention import (
        init_paged_cache,
        paged_append,
        paged_decode,
        quantize_paged,
    )

    rng = np.random.default_rng(0)
    cache = init_paged_cache(num_pages=16, kv_heads=2, page_size=128,
                             head_dim=64, batch=2, max_pages=4, device="cpu")
    jcache = jpa.init_paged_cache(num_pages=16, kv_heads=2, page_size=128,
                                  head_dim=64, batch=2, max_pages=4)
    # assign pages + fill two pages per sequence (the JAX pool pads
    # head_dim to 128 lanes: its pad stays zero, as its constructor makes
    # it, so both quantize the same values)
    kp, vp, qn = _normal(rng, cache.k_pages.shape, cache.v_pages.shape,
                         (2, 8, 64))
    pad = [(0, 0)] * 3 + [(0, jcache.k_pages.shape[-1] - 64)]
    table = np.asarray([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    cache = cache._replace(k_pages=_pair(kp)[1], v_pages=_pair(vp)[1],
                           page_table=torch.as_tensor(table),
                           lengths=torch.tensor([256, 129],
                                                dtype=torch.int32))
    jcache = jcache._replace(k_pages=_pair(np.pad(kp, pad))[0],
                             v_pages=_pair(np.pad(vp, pad))[0],
                             page_table=jnp.asarray(table),
                             lengths=jnp.asarray([256, 129], jnp.int32))
    jq, q = _pair(qn)
    o = paged_decode(q, cache)
    assert o.shape == q.shape and not bool(torch.isnan(o).any())
    _close(o, jpa.paged_decode(jq, jcache), MIXED_TOL.o)
    o = paged_decode(q, quantize_paged(cache, OperandPrecision.INT8))
    assert not bool(torch.isnan(o).any())
    _close(o, jpa.paged_decode(jq, jpa.quantize_paged(jcache,
                                                      JPrecision.INT8)),
           MIXED_TOL.o)
    grown = paged_append(cache, q[:, :2, :], q[:, :2, :])
    assert int(grown.lengths[0]) == 257
    jgrown = jpa.paged_append(jcache, jq[:, :2, :], jq[:, :2, :])
    # Sequence 0's new token: page 2, row 0, in both pools.
    assert torch.equal(grown.k_pages[2, :, 0].float(),
                       torch.as_tensor(np.asarray(
                           jgrown.k_pages[2, :, 0, :64], np.float32)))


@pytest.fixture(scope="module")
def eight_ranks(tmp_path_factory):
    """Both eight-device examples through the port: one spawn of 8 gloo
    ranks; rank 0's gathered outputs."""
    return w.spawn(w.docs_body, w.DOCS_WORLD,
                   str(tmp_path_factory.mktemp("docs_ranks")))[0]


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs 8 (virtual) devices")
def test_parallelism_guide_mesh_and_ring(eight_ranks):
    from metal_flash_attention_tpu.parallel import (
        make_mesh,
        ring_attention,
        sharded_flash_attention,
    )

    inputs = w.docs_inputs()
    mesh = make_mesh(data=1, heads=2, context=4)
    q, k, v = (jnp.asarray(x, jnp.bfloat16) for x in inputs["ring"])
    o = ring_attention(mesh, causal=True)(q, k, v)
    assert o.shape == q.shape == eight_ranks["ring"].shape
    _close(eight_ranks["ring"], o, MIXED_TOL.o)
    mesh2 = make_mesh(data=2, heads=4)
    q2, k2, v2 = (jnp.asarray(x, jnp.bfloat16) for x in inputs["sharded"])
    o2 = sharded_flash_attention(mesh2, causal=True)(q2, k2, v2)
    assert o2.shape == q2.shape == eight_ranks["sharded"].shape
    _close(eight_ranks["sharded"], o2, MIXED_TOL.o)


@pytest.mark.skipif(len(jax.devices()) < 8,
                    reason="needs 8 (virtual) devices")
def test_parallelism_guide_pipeline(eight_ranks):
    from metal_flash_attention_tpu.parallel.pipeline import (
        make_pipeline_mesh,
        pipeline,
        stack_stage_params,
    )

    inputs = w.docs_inputs()
    mesh = make_pipeline_mesh(n_stages=w.DOCS_STAGES)
    params = stack_stage_params([{"w": jnp.asarray(s)}
                                 for s in inputs["stages"]])
    xs = jnp.asarray(inputs["xs"])                   # [n_micro, mb, d]

    def stage_fn(p, x):
        return jnp.tanh(x @ p["w"])

    out = pipeline(stage_fn, params, xs, mesh=mesh)
    assert out.shape == xs.shape == eight_ranks["pipeline"].shape
    _close(eight_ranks["pipeline"], out, FP32_TOL.o)


def test_training_guide_stack(tmp_path):
    """docs/training.md: loss flag, optimizer step, data loader, and
    checkpoint round-trip compose; the port's two AdamW steps against
    optax's from the same weights and batches."""
    import optax

    from metal_flash_attention_tpu.models import llama as jllama
    from metal_flash_attention_tpu.models.optim import (
        make_train_step as jmake_train_step,
    )
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.models.optim import make_train_step
    from metal_flash_attention_tpu_torch.utils import checkpoint, data
    from metal_flash_attention_tpu_torch.utils.params import (
        params_from_numpy,
    )

    cfg = llama.LlamaConfig.tiny(n_layers=1)
    jcfg = jllama.LlamaConfig.tiny(n_layers=1)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x, np.float32), jparams), device="cpu",
        dtype=cfg.dtype)
    rng = np.random.default_rng(0)
    data.write_shard(str(tmp_path / "s.bin"),
                     rng.integers(0, cfg.vocab_size, 4000)
                     .astype(np.uint16))
    loader = data.TokenLoader([str(tmp_path / "s.bin")], batch=2,
                              seq_len=16, seed=0, device="cpu")

    def adamw(tensors):              # optax.adamw(3e-4)'s settings
        return torch.optim.AdamW(tensors, lr=ADAM_LR, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=1e-4)
    init, step = make_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg), adamw)
    state = init(params)
    start = [s.clone() for s in state["shadow"]]
    jinit, jstep = jmake_train_step(
        lambda p, b: jllama.loss_fn(p, b, jcfg), optax.adamw(ADAM_LR))
    jp, js = jparams, jinit(jparams)
    for batch in loader.take(2):
        params, state, loss = step(params, state, batch)
        jp, js, jloss = jstep(jp, js, jnp.asarray(batch.numpy()))
        assert abs(float(loss) - float(jloss)) <= MIXED_TOL.lse
    assert bool(torch.isfinite(loss))
    jshadow, _ = flatten(jax.tree.map(np.asarray, js["shadow"]))
    start_j, _ = flatten(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                      jparams))
    moved = [(t - t0).flatten() for t, t0 in zip(state["shadow"], start)]
    jmoved = [torch.as_tensor(np.asarray(j, np.float32) - j0).flatten()
              for j, j0 in zip(jshadow, start_j)]
    got, want = torch.cat(moved), torch.cat(jmoved)
    off = (got - want).abs() > ADAM_LR
    assert float(off.float().mean()) <= ADAM_FLIP_SHARE

    tree = {"params": params, "opt": state, "data": loader.state()}
    checkpoint.save(str(tmp_path / "ck"), tree, step=2)
    fresh = params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x, np.float32), jparams), device="cpu",
        dtype=cfg.dtype)
    like = {"params": fresh, "opt": init(fresh), "data": (0, 0)}
    restored = checkpoint.restore(
        checkpoint.latest(str(tmp_path / "ck")), like=like)
    assert restored["data"] == loader.state()
    a = flatten(restored["params"])[0][0]
    b = flatten(params)[0][0]
    assert a.dtype == b.dtype and bool(torch.equal(a, b))
    for got, want in zip(restored["opt"]["shadow"], state["shadow"]):
        assert torch.equal(got, want)


def test_serving_guide_decode_loop():
    from metal_flash_attention_tpu.models import llama as jllama
    from metal_flash_attention_tpu.models import serving as jserving
    from metal_flash_attention_tpu_torch.models import llama, serving
    from metal_flash_attention_tpu_torch.utils.params import (
        params_from_numpy,
    )

    cfg = llama.LlamaConfig.tiny(n_layers=1)
    jcfg = jllama.LlamaConfig.tiny(n_layers=1)
    jparams = jllama.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(jax.tree.map(
        lambda x: np.asarray(x, np.float32), jparams), device="cpu",
        dtype=cfg.dtype)
    prompt_np = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)

    # JAX's loop, as the guide writes it.
    cache = jserving.init_cache(jcfg, 2, 12)
    logits, cache = jax.jit(jserving.prefill, static_argnames=("cfg",))(
        jparams, jnp.asarray(prompt_np), jcfg, cache)
    jlogits = [logits]
    jtoks = [logits.argmax(-1).astype(jnp.int32)]
    jstep = jax.jit(jserving.decode_step, static_argnames=("cfg",))
    for _ in range(3):
        logits, cache = jstep(jparams, jtoks[-1], jcfg, cache)
        jlogits.append(logits)
        jtoks.append(logits.argmax(-1).astype(jnp.int32))

    # The port's loop, fed JAX's tokens: its logits against JAX's.
    prompt = torch.as_tensor(prompt_np)
    tcache = serving.init_cache(cfg, 2, 12, device="cpu")
    logits, tcache = serving.prefill(params, prompt, cfg, tcache)
    _close(logits, jlogits[0], MIXED_TOL.o)
    for i in range(3):
        tok = torch.as_tensor(np.array(jtoks[i]))
        logits, tcache = serving.decode_step(params, tok, cfg, tcache)
        _close(logits, jlogits[i + 1], MIXED_TOL.o)

    # The port's own greedy loop, as the snippet checks it.
    tcache = serving.init_cache(cfg, 2, 12, device="cpu")
    logits, tcache = serving.prefill(params, prompt, cfg, tcache)
    tok = logits.argmax(-1).to(torch.int32)
    toks = [tok]
    for _ in range(3):
        logits, tcache = serving.decode_step(params, tok, cfg, tcache)
        tok = logits.argmax(-1).to(torch.int32)
        toks.append(tok)
    ref = serving.generate(params, prompt, cfg, max_new_tokens=4)
    got = torch.stack(toks, dim=1)
    assert got.tolist() == ref[:, prompt.shape[1]:].tolist()
