"""The JAX package's keywords, called on both packages.

Each call below takes JAX's tile and TPU keywords (``block_q``,
``block_kv``, ``interpret``, ``emit_lse=False``, ``pages_per_chunk``,
``heads_per_chunk``, ``block_m/n/k``, and the references' ``mask=`` /
``bias=``) in the JAX package and in the port, on the same numpy inputs;
the JAX kernels run in interpret mode, the port's CPU tensors on their
plain versions.  float32 at FP32_TOL (the references 1e-5).  The decode
keywords are also held to what they mean on the card: the cap on the
chunk `decode_splits` is given, which moves the split and leaves the
plain path's results as they were.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.ops.gemm import gemm as jgemm
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.native.build import tile_defines
from metal_flash_attention_tpu_torch.ops.gemm import gemm as tgemm
from metal_flash_attention_tpu_torch.utils.params import params_from_numpy
from metal_flash_attention_tpu_torch.utils.tolerances import (
    FP32_TOL,
    max_abs_err,
)

# The ops packages export functions under their modules' names.
jfa, jfb, jfd, jpa, jref = (importlib.import_module(
    f"metal_flash_attention_tpu.ops.{m}") for m in (
        "flash_attention", "flash_attention_bwd", "flash_decode",
        "paged_attention", "reference"))
tfa, tfb, tfd, tpa, tref = (importlib.import_module(
    f"metal_flash_attention_tpu_torch.ops.{m}") for m in (
        "flash_attention", "flash_attention_bwd", "flash_decode",
        "paged_attention", "reference"))

# JAX's blocks for these shapes (its kernels take 128-multiples); the
# port clamps each to its card's rules.
BLOCKS = dict(block_q=128, block_kv=128)


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(*xs):
    return [torch.as_tensor(x) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def test_flash_attention_with_jax_keywords():
    q, k, v = _inputs(0, (1, 4, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64))
    o_j = jfa.flash_attention(*_j(q, k, v), causal=True, interpret=True,
                              **BLOCKS)
    o_t = tfa.flash_attention(*_t(q, k, v), causal=True, interpret=True,
                              **BLOCKS)
    assert max_abs_err(o_t, o_j) <= FP32_TOL.o


def test_flash_attention_forward_emit_lse_false():
    q, k, v = _inputs(1, (1, 2, 200, 64), (1, 2, 200, 64), (1, 2, 200, 64))
    o_j, lse_j = jfa.flash_attention_forward(
        *_j(q, k, v), window_size=64, emit_lse=False, interpret=True,
        **BLOCKS)
    o_t, lse_t = tfa.flash_attention_forward(
        *_t(q, k, v), window_size=64, emit_lse=False, interpret=True,
        **BLOCKS)
    assert lse_j is None and lse_t is None
    assert max_abs_err(o_t, o_j) <= FP32_TOL.o
    o_t, lse_t = tfa.flash_attention_forward(*_t(q, k, v), window_size=64,
                                             block_kv=64)
    assert lse_t.shape == (1, 2, 200)


def test_flash_attention_backward_with_jax_keywords():
    q, k, v, do = _inputs(2, (1, 4, 128, 64), (1, 2, 128, 64),
                          (1, 2, 128, 64), (1, 4, 128, 64))
    o, lse = jfa.flash_attention_forward(*_j(q, k, v), causal=True,
                                         interpret=True)
    got_j = jfb.flash_attention_backward(*_j(q, k, v, do), o, lse,
                                         causal=True, interpret=True,
                                         **BLOCKS)
    got_t = tfb.flash_attention_backward(
        *_t(q, k, v, do), torch.as_tensor(np.array(o)),
        torch.as_tensor(np.array(lse)), causal=True, interpret=True,
        **BLOCKS)
    for t, j in zip(got_t, got_j):
        assert max_abs_err(t, j) <= FP32_TOL.grads


def test_llama_attention_block_and_forward_hidden_take_blocks():
    jcfg = jl.LlamaConfig.tiny(dtype=jnp.float32, n_layers=2)
    tcfg = tl.LlamaConfig.tiny(dtype=torch.float32, n_layers=2)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    tokens = np.random.default_rng(3).integers(
        0, jcfg.vocab_size, (2, 40)).astype(np.int32)
    x_j, _ = jl.forward_hidden(jparams, jnp.asarray(tokens), jcfg,
                               **BLOCKS)
    x_t, _ = tl.forward_hidden(tparams, torch.as_tensor(tokens), tcfg,
                               **BLOCKS)
    assert max_abs_err(x_t, x_j) <= 1e-5
    # attention_block's positional order is JAX's: kv_cache, block_q,
    # block_kv.
    pos = np.tile(np.arange(40), (2, 1))
    cos_j, sin_j = jl.rope_frequencies(jcfg, jnp.asarray(pos))
    cos_t, sin_t = tl.rope_frequencies(tcfg, torch.as_tensor(pos))
    h = np.random.default_rng(4).standard_normal(
        (2, 40, jcfg.dim)).astype(np.float32)
    y_j, _ = jl.attention_block(jparams["layers"][0], jnp.asarray(h), jcfg,
                                cos_j, sin_j, None, 128, 128)
    y_t, _ = tl.attention_block(tparams["layers"][0], torch.as_tensor(h),
                                tcfg, cos_t, sin_t, None, 128, 128)
    assert max_abs_err(y_t, y_j) <= 1e-5


def _paged(seed, batch=2, kv_heads=2, q_heads=4, d=64, page=16, pages=6,
           q_chunk=None):
    rng = np.random.default_rng(seed)
    num = batch * pages + 1
    k, v = (rng.standard_normal((num, kv_heads, page, d)).astype(np.float32)
            for _ in range(2))
    table = (1 + np.arange(batch * pages).reshape(batch, pages)).astype(
        np.int32)
    lengths = np.asarray([pages * page, pages * page - 21], np.int32)
    shape = (batch, q_heads, d) if q_chunk is None else \
        (batch, q_heads, q_chunk, d)
    q = rng.standard_normal(shape).astype(np.float32)
    return q, k, v, table, lengths


@pytest.mark.parametrize("mode", ["decode", "prefill"])
def test_paged_attention_with_jax_keywords(mode):
    q, k, v, table, lengths = _paged(5, q_chunk=None if mode == "decode"
                                     else 8)
    jc = jpa.PagedKVCache(*_j(k, v, table, lengths))
    tc = tpa.PagedKVCache(*_t(k, v), torch.as_tensor(table),
                          torch.as_tensor(lengths))
    kw = dict(interpret=True, pages_per_chunk=2, return_residuals=True)
    if mode == "decode":
        o_j, lse_j = jpa.paged_decode(jnp.asarray(q), jc, heads_per_chunk=1,
                                      **kw)
        o_t, lse_t = tpa.paged_decode(torch.as_tensor(q), tc,
                                      heads_per_chunk=1, **kw)
        o_d = tpa.paged_decode(torch.as_tensor(q), tc)
    else:
        o_j, lse_j = jpa.paged_prefill(jnp.asarray(q), jc, **kw)
        o_t, lse_t = tpa.paged_prefill(torch.as_tensor(q), tc, **kw)
        o_d = tpa.paged_prefill(torch.as_tensor(q), tc)
    assert max_abs_err(o_t, o_j) <= FP32_TOL.o
    assert max_abs_err(lse_t, lse_j) <= FP32_TOL.lse
    assert torch.equal(o_t, o_d)


def test_flash_decode_and_decode_step_with_jax_keywords():
    q, k, v, nk, nv = _inputs(6, (2, 4, 64), (2, 2, 300, 64),
                              (2, 2, 300, 64), (2, 2, 64), (2, 2, 64))
    lens = np.asarray([300, 123], np.int32)
    o_j = jfd.flash_decode(*_j(q, k, v), kv_lens=jnp.asarray(lens),
                           block_kv=256, interpret=True)
    o_t = tfd.flash_decode(*_t(q, k, v), kv_lens=torch.as_tensor(lens),
                           block_kv=256, interpret=True)
    assert max_abs_err(o_t, o_j) <= FP32_TOL.o
    assert torch.equal(o_t, tfd.flash_decode(
        *_t(q, k, v), kv_lens=torch.as_tensor(lens)))
    lens = np.asarray([200, 17], np.int32)
    out_j = jfd.decode_step(*_j(q, k, v, nk, nv), jnp.asarray(lens),
                            block_kv=256, interpret=True)
    out_t = tfd.decode_step(*_t(q, k, v, nk, nv), torch.as_tensor(lens),
                            block_kv=256, interpret=True)
    for t, j in zip(out_t, out_j):
        assert max_abs_err(t, j) <= FP32_TOL.o


def test_gemm_block_keywords():
    a, b = _inputs(7, (96, 320), (320, 200))
    out_j = jgemm(*_j(a, b), block_m=128, block_n=128, block_k=128,
                  interpret=True)
    out_t = tgemm(*_t(a, b), block_m=128, block_n=128, block_k=128,
                       interpret=True)
    assert max_abs_err(out_t, out_j) <= 1e-4


@pytest.mark.parametrize("kind", ["mask", "bias", "both"])
def test_references_take_mask_and_bias(kind):
    q, k, v, do, bias = _inputs(8, (48, 32), (64, 32), (64, 32), (48, 32),
                                (48, 64))
    mask = np.random.default_rng(9).random((48, 64)) > 0.3
    kw_j, kw_t = {}, {}
    if kind in ("mask", "both"):
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), torch.as_tensor(mask)
    if kind in ("bias", "both"):
        kw_j["bias"], kw_t["bias"] = jnp.asarray(bias), torch.as_tensor(bias)
    o_j, lse_j = jref.attention_reference(*_j(q, k, v), causal=True,
                                          return_residuals=True, **kw_j)
    o_t, lse_t = tref.attention_reference(*_t(q, k, v), causal=True,
                                          return_residuals=True, **kw_t)
    live = np.isfinite(np.asarray(lse_t))
    assert max_abs_err(o_t, o_j) <= 1e-5
    assert max_abs_err(np.asarray(lse_t)[live], np.asarray(lse_j)[live]) \
        <= 1e-5
    grads_j = jref.attention_reference_grads(*_j(q, k, v, do), causal=True,
                                             **kw_j)
    grads_t = tref.attention_reference_grads(*_t(q, k, v, do), causal=True,
                                             **kw_t)
    for t, j in zip(grads_t[:3], grads_j[:3]):
        assert max_abs_err(t, j) <= 1e-5


@pytest.mark.parametrize("kind", ["decode", "paged"])
def test_chunk_keywords_move_the_split(kind):
    """``block_kv`` and ``pages_per_chunk`` cap the chunk that
    `decode_splits` is given (whole key tiles), so the split moves while
    the plain path's results stay."""
    tiles = tile_defines()
    tile = tiles["MFA_DECODE_BLOCK_KV"]
    default = tiles["MFA_DECODE_CHUNK"]
    if kind == "decode":
        caps = [tfd.decode_chunk_cap(r, None, 128, torch.bfloat16, 8192)
                for r in (None, 256, 200, 8192)]
        assert caps == [default, 256, 192, 8192]
    else:
        caps = [tpa.chunk_cap(None if p is None else p * 16, tile, default)
                for p in (None, 2, 8, 64)]
        assert caps == [default, tile, 128, 1024]
    plans = {cap: tpa.decode_splits(512, 8192, 132, tile, cap)
             for cap in caps}
    assert len(set(plans.values())) > 1
    for cap, (chunk, splits) in plans.items():
        assert chunk <= max(cap, tile) and chunk % tile == 0
        assert chunk * splits >= 8192
