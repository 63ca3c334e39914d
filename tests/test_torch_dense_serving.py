"""The port's dense serving path against the JAX package on
`LlamaConfig.tiny(n_layers=2)` with weights carried through numpy.

`prefill` logits and cache, then two `decode_step`s, with and without a
sliding window: float32 at 1e-4 (two layers of float32 products whose
sums run in another order than XLA's), bf16 logits at 5e-2 (the JAX
kernels round q and P to bf16 inside attention; the port's plain
versions keep them in float32).  Greedy `generate` must match token for
token in float32.  `sink_decode` and `_merge_partials` at FP32_TOL.
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
from metal_flash_attention_tpu_torch.utils.params import (
    cache_from_numpy,
    params_from_numpy,
)
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    max_abs_err,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
WINDOW = 8


def _setup(dtype, window=None):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jdt, sliding_window=window)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=tdt, sliding_window=window)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, dtype=tdt,
                                                 device="cpu"), tol


def _as_numpy(cache):
    return js.KVCache(
        k=[np.asarray(x.astype(jnp.float32)) for x in cache.k],
        v=[np.asarray(x.astype(jnp.float32)) for x in cache.v],
        lengths=np.asarray(cache.lengths))


@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_steps_match_jax(dtype, window):
    jcfg, tcfg, jparams, tparams, tol = _setup(dtype, window)
    rng = np.random.default_rng(0)
    batch, prompt, max_seq = 2, 20, 32
    toks = rng.integers(0, jcfg.vocab_size, (batch, prompt)).astype(np.int32)
    jlog, jc = js.prefill(jparams, jnp.asarray(toks), jcfg,
                          js.init_cache(jcfg, batch, max_seq))
    tlog, tc = ts.prefill(tparams, torch.as_tensor(toks), tcfg,
                          ts.init_cache(tcfg, batch, max_seq, device="cpu"))
    assert tlog.shape == (batch, jcfg.vocab_size)
    assert max_abs_err(tlog, jlog) < tol
    assert tc.lengths.tolist() == np.asarray(jc.lengths).tolist()
    jnp_cache = _as_numpy(jc)
    for a, b in zip(tc.k + tc.v, jnp_cache.k + jnp_cache.v):
        assert max_abs_err(a, b) < tol
    # Both packages decode on from the JAX cache.
    tc = cache_from_numpy(jnp_cache, device="cpu", dtype=tcfg.dtype)
    for _ in range(2):
        tok = rng.integers(0, jcfg.vocab_size, (batch,)).astype(np.int32)
        jlog, jc = js.decode_step(jparams, jnp.asarray(tok), jcfg, jc)
        tlog, tc = ts.decode_step(tparams, torch.as_tensor(tok), tcfg, tc)
        assert max_abs_err(tlog, jlog) < tol
    assert tc.lengths.tolist() == [prompt + 2] * batch
    for a, b in zip(tc.k + tc.v, _as_numpy(jc).k + _as_numpy(jc).v):
        assert max_abs_err(a, b) < tol


def test_generate_matches_jax_token_for_token():
    jcfg, tcfg, jparams, tparams, _ = _setup("float32")
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 17)).astype(np.int32)
    j = js.generate(jparams, jnp.asarray(prompt), jcfg, max_new_tokens=6)
    t = ts.generate(tparams, torch.as_tensor(prompt), tcfg,
                    max_new_tokens=6)
    assert t.dtype == torch.int32
    assert t.numpy().tolist() == np.asarray(j).tolist()


@pytest.mark.parametrize("lens", [[300, 3, 40], [1030, 1, 4]])
def test_sink_decode_matches_jax(lens):
    rng = np.random.default_rng(2)
    b, qh, kvh, n, d, window, sink = len(lens), 8, 2, 1040, 64, 32, 4
    q = rng.standard_normal((b, qh, d)).astype(np.float32)
    k = rng.standard_normal((b, kvh, n, d)).astype(np.float32)
    v = rng.standard_normal((b, kvh, n, d)).astype(np.float32)
    lens = np.asarray(lens, np.int32)
    jo = js.sink_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        jnp.asarray(lens), window=window, sink=sink)
    to = ts.sink_decode(torch.as_tensor(q), torch.as_tensor(k),
                        torch.as_tensor(v), torch.as_tensor(lens),
                        window=window, sink=sink)
    assert to.shape == (b, qh, d)
    assert max_abs_err(to, jo) < FP32_TOL.o


def test_merge_partials_matches_jax():
    rng = np.random.default_rng(3)
    o1, o2 = (rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
              for _ in range(2))
    l1, l2 = (rng.standard_normal((2, 3, 5)).astype(np.float32)
              for _ in range(2))
    l1[0, 0] = -np.inf                  # one side saw no key
    l1[1, 2, :2] = l2[1, 2, :2] = -np.inf   # neither did
    j = js._merge_partials(*(jnp.asarray(x) for x in (o1, l1, o2, l2)))
    t = ts._merge_partials(*(torch.as_tensor(x) for x in (o1, l1, o2, l2)))
    assert np.isfinite(t.numpy()).all()
    assert max_abs_err(t, j) < FP32_TOL.o


def test_unported_dense_serving_raises():
    _, tcfg, _, tparams, _ = _setup("float32")
    cache = ts.init_cache(tcfg, 1, 16, device="cpu")
    moe = dict(tparams, layers=[dict(tparams["layers"][0], moe={})])
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        ts.decode_step(moe, torch.zeros(1, dtype=torch.int32), tcfg, cache)


@pytest.mark.parametrize("precision", ["int8", "nf4"])
def test_quantized_dense_serving_runs(precision):
    """`quantize_cache` and `decode_step_quantized` run on a prefilled
    cache (they are held against JAX in test_torch_quantized_serving.py);
    a precision that is no KV storage format is refused."""
    _, tcfg, _, tparams, _ = _setup("float32")
    cache = ts.init_cache(tcfg, 1, 16, device="cpu")
    _, cache = ts.prefill(tparams, torch.arange(5)[None], tcfg, cache)
    qcache = ts.quantize_cache(cache, precision, tail_capacity=4)
    logits, qcache = ts.decode_step_quantized(
        tparams, torch.zeros(1, dtype=torch.int32), tcfg, qcache)
    assert logits.shape == (1, tcfg.vocab_size)
    assert torch.isfinite(logits).all()
    assert qcache.prefix_len.tolist() == [5]
    assert qcache.tail_len.tolist() == [1]
    with pytest.raises(ValueError, match="streaming KV precision"):
        ts.quantize_cache(cache, None)
