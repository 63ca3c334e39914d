"""Quantized-KV serving in the PyTorch port against the JAX package, on
`LlamaConfig.tiny(n_layers=2)` with the same weights carried through
numpy.

- dense: `quantize_cache` + `decode_step_quantized`;
- paged: `paged_chunk_step_q` + `paged_decode_step_q` for 20 decode
  steps fed the same tokens, across page flushes (page 16: a 28-token
  prompt flushes one page in its chunks and two more while decoding);
  the pools after the run; `paged_generate_quantized`;
- (`test_torch_quantized_engine.py` holds the engine's.)

Tolerances: float32 logits at 1e-4 (two layers of float32 products
summed in another order than XLA's, as the dense serving tests), and in
float32 the flushed pages equal code for code.  bf16 logits at 1e-1 (the
JAX kernels round q and P to bf16; the port's plain versions keep
float32).
Greedy `paged_generate_quantized` must match token for token in
float32.  The JAX steps run under `jax.jit`, as its serving loops run
them (the Pallas kernels then interpret once a shape).
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
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision as TP,
)
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.utils.params import (
    params_from_numpy,
    quantized_kv_cache_from_numpy,
    quantized_paged_cache_from_numpy,
)
from metal_flash_attention_tpu_torch.utils.tolerances import max_abs_err

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 1e-1)}
PAGE = 16
PROMPT = 28
STEPS = 20


def _setup(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jdt)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=tdt)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, dtype=tdt,
                                                 device="cpu"), tol


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _code_flips(t_pools, j_pools, head_dim):
    """Codes that differ between the port's pools and the JAX package's
    (cut to head_dim)."""
    return sum(int(np.sum(t.contiguous().view(torch.uint8).numpy()
                          != np.asarray(j)[..., :head_dim].view(np.uint8)))
               for t, j in zip(t_pools, j_pools))


@pytest.mark.parametrize("precision,dtype", [
    ("int8", "float32"), ("fp8_e5m2", "float32"), ("nf4", "float32"),
    ("int8", "bfloat16")])
def test_decode_step_quantized_matches_jax(precision, dtype):
    """JAX prefills and quantizes the cache; both packages then decode 3
    steps from it (`quantized_kv_cache_from_numpy`)."""
    jcfg, tcfg, jparams, tparams, tol = _setup(dtype)
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jcfg.vocab_size, (2, 12 + 3)).astype(np.int32)
    jcache = js.init_cache(jcfg, 2, 32)
    _, jcache = js.prefill(jparams, jnp.asarray(toks[:, :12]), jcfg, jcache)
    jq = js.quantize_cache(jcache, JP(precision), tail_capacity=8)
    tq = quantized_kv_cache_from_numpy(
        jax.tree.map(np.asarray, jq), device="cpu",
        dtype=tcfg.dtype)
    assert tq.k_q[0].precision is TP(precision)
    step = jax.jit(js.decode_step_quantized, static_argnames=("cfg",))
    for i in range(3):
        tok = toks[:, 12 + i]
        jl_, jq = step(jparams, jnp.asarray(tok), jcfg, jq)
        tl_, tq = ts.decode_step_quantized(tparams, torch.from_numpy(tok),
                                           tcfg, tq)
        assert max_abs_err(tl_, _f32(jl_)) < tol, i
    assert tq.tail_len.tolist() == [3, 3]


def test_quantize_cache_matches_jax():
    jcfg, tcfg, jparams, tparams, _ = _setup("float32")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    jcache = js.init_cache(jcfg, 2, 16)
    _, jcache = js.prefill(jparams, jnp.asarray(toks), jcfg, jcache)
    tcache = ts.KVCache(
        k=[torch.from_numpy(np.array(x)) for x in jcache.k],
        v=[torch.from_numpy(np.array(x)) for x in jcache.v],
        lengths=torch.from_numpy(np.array(jcache.lengths)))
    for precision in ("int8", "fp8_e4m3", "nf4"):
        j = js.quantize_cache(jcache, JP(precision), tail_capacity=4)
        t = ts.quantize_cache(tcache, precision, tail_capacity=4)
        for jt, tt in zip(j.k_q + j.v_q, t.k_q + t.v_q):
            assert np.array_equal(tt.values.view(torch.uint8).numpy(),
                                  np.asarray(jt.values).view(np.uint8))
            np.testing.assert_array_equal(tt.scales.numpy(),
                                          np.asarray(jt.scales))
        assert tuple(t.k_tail[0].shape) == (2, jcfg.n_kv_heads, 4,
                                            jcfg.head_dim)
        assert t.tail_len.tolist() == [0, 0]


def _paged_run(jcfg, tcfg, jparams, tparams, precision, prompt):
    """Both packages' chunk steps, then STEPS decode steps fed the JAX
    greedy stream; returns per-step logits and the final caches."""
    b, s = prompt.shape
    max_seq = s + STEPS + 1
    jc = js.init_quantized_paged_model_cache(
        jcfg, b, max_seq, precision=JP(precision), page_size=PAGE)
    tc = ts.init_quantized_paged_model_cache(
        tcfg, b, max_seq, precision=precision, page_size=PAGE,
        device="cpu")
    chunk = jax.jit(js.paged_chunk_step_q, static_argnames=("cfg",))
    step = jax.jit(js.paged_decode_step_q, static_argnames=("cfg",))
    for i in range(0, s, PAGE):
        jlog, jc = chunk(jparams, jnp.asarray(prompt[:, i:i + PAGE]), jcfg,
                         jc)
        tlog, tc = ts.paged_chunk_step_q(
            tparams, torch.from_numpy(prompt[:, i:i + PAGE]), tcfg, tc)
    logits = [(_f32(jlog[:, -1]), tlog[:, -1])]
    assert tc.full_len.tolist() == np.asarray(jc.full_len).tolist()
    assert tc.tail_len.tolist() == np.asarray(jc.tail_len).tolist()
    token = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    flushes = 0
    for _ in range(STEPS):
        before = tc.full_len.clone()
        jlog, jc = step(jparams, jnp.asarray(token), jcfg, jc)
        tlog, tc = ts.paged_decode_step_q(tparams, torch.from_numpy(token),
                                          tcfg, tc)
        flushes += int((tc.full_len != before).any())
        logits.append((_f32(jlog), tlog))
        token = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    assert tc.full_len.tolist() == np.asarray(jc.full_len).tolist()
    assert tc.tail_len.tolist() == np.asarray(jc.tail_len).tolist()
    return logits, jc, tc, flushes


@pytest.mark.parametrize("precision,dtype", [
    ("int8", "float32"), ("fp8_e4m3", "float32"), ("nf4", "float32"),
    ("int8", "bfloat16"), ("nf4", "bfloat16")])
def test_paged_steps_match_jax_across_flushes(precision, dtype):
    jcfg, tcfg, jparams, tparams, tol = _setup(dtype)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    logits, jc, tc, flushes = _paged_run(jcfg, tcfg, jparams, tparams,
                                         precision, prompt)
    assert flushes == 2
    assert tc.lengths.tolist() == [PROMPT + STEPS] * 2
    if dtype == "float32":
        assert _code_flips(tc.qk + tc.qv, jc.qk + jc.qv,
                           jcfg.head_dim) == 0
        for ts_, ws in ((tc.k_scales, jc.k_scales),
                        (tc.v_scales, jc.v_scales)):
            for t, w in zip(ts_, ws):
                np.testing.assert_allclose(t.numpy(), np.asarray(w),
                                           rtol=1e-5)
    for i, (j, t) in enumerate(logits):
        assert max_abs_err(t, j) < tol, (i, max_abs_err(t, j))


def test_quantized_paged_cache_from_numpy_strips_the_lane_padding():
    """The JAX cache after a chunk (pools padded to 128 lanes) comes over
    with its payload bits; a pool whose padding holds payload is
    refused."""
    jcfg, tcfg, jparams, tparams, _ = _setup("float32")
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, (1, PAGE)).astype(np.int32)
    for precision in ("int8", "nf4"):
        jc = js.init_quantized_paged_model_cache(
            jcfg, 1, 2 * PAGE, precision=JP(precision), page_size=PAGE)
        _, jc = js.paged_chunk_step_q(jparams, jnp.asarray(prompt), jcfg, jc)
        tree = jax.tree.map(np.asarray, jc)
        tc = quantized_paged_cache_from_numpy(tree, jcfg.head_dim,
                                              device="cpu",
                                              dtype=torch.float32)
        assert tc.precision is TP(precision) and tc.page_size == PAGE
        assert tuple(tc.qk[0].shape[-1:]) == (jcfg.head_dim,)
        assert _code_flips(tc.qk + tc.qv, jc.qk + jc.qv,
                           jcfg.head_dim) == 0
        assert tc.full_len.tolist() == [PAGE]
        bad = tree._replace(qk=tuple(np.array(x) for x in tree.qk))
        bad.qk[0][..., -1] = 1
        with pytest.raises(ValueError, match="padding"):
            quantized_paged_cache_from_numpy(bad, jcfg.head_dim,
                                             device="cpu")


def test_paged_generate_quantized_matches_jax():
    jcfg, tcfg, jparams, tparams, _ = _setup("float32")
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, jcfg.vocab_size, (2, 20)).astype(np.int32)
    want = js.paged_generate_quantized(jparams, jnp.asarray(prompt), jcfg,
                                       max_new_tokens=8,
                                       precision=JP.INT8, page_size=PAGE)
    got = ts.paged_generate_quantized(tparams, torch.from_numpy(prompt),
                                      tcfg, max_new_tokens=8,
                                      precision=TP.INT8, page_size=PAGE)
    assert got.tolist() == np.asarray(want).tolist()
