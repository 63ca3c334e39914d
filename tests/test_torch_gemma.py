"""The port's Gemma-2 model and serving steps against the JAX package on
`GemmaConfig.tiny` (2 layers, head_dim 32, a sliding window of 64 below
the prompts), with weights carried through numpy.

Tolerances (`utils/tolerances.py`): float32 logits at FP32_TOL.o (2e-5);
bf16 logits at MIXED_TOL.o (5e-2), since the JAX kernels round q and P
to bf16 inside attention while the port's plain versions keep them in
float32.  Greedy generation must match token for token in float32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import gemma as jg
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu_torch.models import gemma as tg
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.utils.params import (
    params_from_numpy,
    pools_from_numpy,
)
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    MIXED_TOL,
    max_abs_err,
)

DTYPES = {"float32": (jnp.float32, torch.float32, FP32_TOL.o),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, MIXED_TOL.o)}
PROMPT = 80     # above the tiny config's sliding window of 64
PAGE = 16


def _setup(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jg.GemmaConfig.tiny(dtype=jdt)
    tcfg = tg.GemmaConfig.tiny(dtype=tdt)
    jparams = jg.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, dtype=tdt,
                                                 device="cpu"), tol


def _tokens(batch, n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (batch, n)).astype(np.int32)


def test_config_matches_jax():
    """gemma2_2b's widths, caps and window, the tiny config, and the
    attention scale (with and without query_pre_attn_scalar)."""
    def fields(cfg):
        return {f.name: getattr(cfg, f.name)
                for f in dataclasses.fields(cfg) if f.name != "dtype"}
    assert fields(tg.GemmaConfig.gemma2_2b()) == \
        fields(jg.GemmaConfig.gemma2_2b())
    assert fields(tg.GemmaConfig.tiny()) == fields(jg.GemmaConfig.tiny())
    assert tg.GemmaConfig().dtype == torch.bfloat16
    assert tg.GemmaConfig().attn_scale == jg.GemmaConfig().attn_scale
    assert tg.GemmaConfig(query_pre_attn_scalar=144).attn_scale == \
        jg.GemmaConfig(query_pre_attn_scalar=144).attn_scale
    assert [tg.is_local_layer(i) for i in range(6)] == \
        [jg.is_local_layer(i) for i in range(6)]
    cfg = tg.GemmaConfig.tiny()
    assert [tg.layer_window(cfg, i) for i in range(3)] == [64, None, 64]


def test_params_from_numpy_keeps_norms_float32():
    """JAX bf16 params carried into the port: every projection bf16 and
    exact, every Gemma norm gain float32, the tree shaped as the port's
    own `init_params`."""
    jcfg = jg.GemmaConfig.tiny()
    jparams = jg.init_params(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jparams)
    tparams = params_from_numpy(tree, device="cpu")
    own = tg.init_params(tg.GemmaConfig.tiny(),
                         torch.Generator().manual_seed(0), device="cpu")
    assert tparams["final_norm"].dtype == torch.float32
    assert tparams["embed"].dtype == torch.bfloat16
    for jl, tl, ol in zip(tree["layers"], tparams["layers"], own["layers"]):
        assert tl.keys() == ol.keys()
        for name, t in tl.items():
            assert t.shape == ol[name].shape and t.dtype == ol[name].dtype
            want = torch.float32 if name.endswith("norm") else torch.bfloat16
            assert t.dtype == want, name
            np.testing.assert_array_equal(t.float().numpy(), jl[name])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(dtype):
    """`forward` over a prompt longer than the window: the soft-capped
    logits of every position (local layers windowed, the attention and
    final caps, the (1 + w) norms, GeGLU, sqrt(dim) scaling, tied head)."""
    jcfg, tcfg, jparams, tparams, tol = _setup(dtype)
    toks = _tokens(2, PROMPT)
    jl, _ = jg.forward(jparams, jnp.asarray(toks), jcfg)
    tl, _ = tg.forward(tparams, torch.as_tensor(toks), tcfg)
    assert tl.dtype == torch.float32 and tl.shape == (2, PROMPT, 256)
    assert max_abs_err(tl, jl) <= tol
    assert float(tl.abs().max()) <= tcfg.final_logit_softcap


def test_blocks_match_jax():
    """rms_norm with its (1 + w) gain and the GeGLU MLP, float32."""
    jcfg, tcfg, jparams, tparams, tol = _setup("float32")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, jcfg.dim)).astype(np.float32)
    w = rng.standard_normal((jcfg.dim,)).astype(np.float32)
    assert max_abs_err(tg.rms_norm(torch.as_tensor(x), torch.as_tensor(w),
                                   1e-6),
                       jg.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)) \
        <= FP32_TOL.o
    assert max_abs_err(
        tg.mlp_block(tparams["layers"][0], torch.as_tensor(x), tcfg),
        jg.mlp_block(jparams["layers"][0], jnp.asarray(x), jcfg)) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_steps_match_jax(dtype):
    """`gemma_prefill`, then decode steps whose local layers attend
    through a kv_starts window (the window slides past position 0)."""
    jcfg, tcfg, jparams, tparams, tol = _setup(dtype)
    toks = _tokens(2, PROMPT, seed=1)
    jcache = js.init_cache(jcfg, 2, PROMPT + 4)
    tcache = ts.init_cache(tcfg, 2, PROMPT + 4, device="cpu")
    jlog, jcache = js.gemma_prefill(jparams, jnp.asarray(toks), jcfg,
                                    jcache)
    tlog, tcache = ts.gemma_prefill(tparams, torch.as_tensor(toks), tcfg,
                                    tcache)
    assert max_abs_err(tlog, jlog) <= tol
    for k_t, k_j in zip(tcache.k, jcache.k):
        assert max_abs_err(k_t, k_j.astype(jnp.float32)) <= tol
    tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    for _ in range(3):
        jlog, jcache = js.gemma_decode_step(jparams, jnp.asarray(tok), jcfg,
                                            jcache)
        tlog, tcache = ts.gemma_decode_step(tparams, torch.as_tensor(tok),
                                            tcfg, tcache)
        assert max_abs_err(tlog, jlog) <= tol
        assert tcache.lengths.tolist() == np.asarray(jcache.lengths).tolist()
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)


def test_generate_matches_jax_token_for_token():
    jcfg, tcfg, jparams, tparams, _ = _setup("float32")
    toks = _tokens(2, PROMPT, seed=2)
    jout = js.gemma_generate(jparams, jnp.asarray(toks), jcfg,
                             max_new_tokens=6)
    tout = ts.gemma_generate(tparams, torch.as_tensor(toks), tcfg,
                             max_new_tokens=6)
    assert tout.dtype == torch.int32
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_steps_match_jax(dtype):
    """`gemma_paged_chunk_step` over a prompt in page-sized chunks (the
    later ones past the window), then `gemma_paged_decode_step`s: the
    logits of every step, and the pools (the JAX ones cut back from
    their 128 lanes)."""
    jcfg, tcfg, jparams, tparams, tol = _setup(dtype)
    toks = _tokens(2, PROMPT, seed=3)
    jcache = js.init_paged_model_cache(jcfg, 2, PROMPT + 8, page_size=PAGE)
    tcache = ts.init_paged_model_cache(tcfg, 2, PROMPT + 8, page_size=PAGE,
                                       device="cpu")
    for i in range(0, PROMPT, PAGE):
        chunk = toks[:, i:i + PAGE]
        jlog, jcache = js.gemma_paged_chunk_step(jparams, jnp.asarray(chunk),
                                                 jcfg, jcache)
        tlog, tcache = ts.gemma_paged_chunk_step(
            tparams, torch.as_tensor(chunk), tcfg, tcache)
        assert tlog.shape == (2, PAGE, 256)
        assert max_abs_err(tlog, jlog) <= tol
    pools = pools_from_numpy(
        [np.asarray(p.astype(jnp.float32)) for p in jcache.k],
        tcfg.head_dim, device="cpu", dtype=torch.float32)
    for p_t, p_j in zip(tcache.k, pools):
        assert max_abs_err(p_t, p_j) <= tol
    tok = np.asarray(jnp.argmax(jlog[:, -1], -1)).astype(np.int32)
    for _ in range(3):
        jlog, jcache = js.gemma_paged_decode_step(jparams, jnp.asarray(tok),
                                                  jcfg, jcache)
        tlog, tcache = ts.gemma_paged_decode_step(
            tparams, torch.as_tensor(tok), tcfg, tcache)
        assert max_abs_err(tlog, jlog) <= tol
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    assert tcache.lengths.tolist() == np.asarray(jcache.lengths).tolist()


def test_unported_gemma_features_raise():
    """Data- and head-parallel training (slice 20,
    tests/test_torch_train_tp.py) and tensor-parallel serving (slice 19,
    tests/test_torch_serving_tp.py) take a mesh: ``forward``,
    `param_shardings` and the paged steps given a mesh that is not one
    raise TypeError.  (Training is ported: tests/test_torch_gemma_train.py
    holds `loss_fn` and `train_step` against JAX.)"""
    _, tcfg, _, tparams, _ = _setup("float32")
    toks = torch.as_tensor(_tokens(1, 8))
    with pytest.raises(TypeError, match="DeviceMesh"):
        tg.forward(tparams, toks, tcfg, mesh=object())
    cache = ts.init_paged_model_cache(tcfg, 1, 32, page_size=PAGE,
                                      device="cpu")
    for fn in (lambda: tg.param_shardings(tcfg, object()),
               lambda: ts.gemma_paged_chunk_step(tparams, toks, tcfg, cache,
                                                 mesh=object()),
               lambda: ts.gemma_paged_decode_step(tparams, toks[:, 0], tcfg,
                                                  cache, mesh=object())):
        with pytest.raises(TypeError, match="DeviceMesh"):
            fn()
