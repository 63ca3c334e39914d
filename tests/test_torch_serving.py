"""The port's paged serving steps against the JAX package on
`LlamaConfig.tiny(n_layers=2)` with weights carried through numpy.

Logits and pools after two prefill chunks and two decode steps: float32
at 1e-4 (two layers of float32 products whose sums run in another order
than XLA's), bf16 logits at 5e-2 (the JAX kernel rounds q and P to
bf16 inside attention; the port's plain version keeps them in float32).
Greedy `paged_generate` must match token for token in float32.
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
    params_from_numpy,
    pools_from_numpy,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
PAGE = 16


def _setup(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jcfg = jl.LlamaConfig.tiny(n_layers=2, dtype=jdt)
    tcfg = tl.LlamaConfig.tiny(n_layers=2, dtype=tdt)
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                        jparams)
    return jcfg, tcfg, jparams, params_from_numpy(tree, dtype=tdt,
                                                 device="cpu"), tol


def _logits_err(t, j):
    return float(np.max(np.abs(t.float().numpy() - np.asarray(j))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_then_decode_steps_match_jax(dtype):
    jcfg, tcfg, jparams, tparams, tol = _setup(dtype)
    rng = np.random.default_rng(0)
    batch, max_seq = 2, 48
    jc = js.init_paged_model_cache(jcfg, batch, max_seq, page_size=PAGE)
    tc = ts.init_paged_model_cache(tcfg, batch, max_seq, page_size=PAGE,
                                   device="cpu")
    for kc in (12, 7):
        toks = rng.integers(0, jcfg.vocab_size, (batch, kc)).astype(np.int32)
        jlog, jc = js.paged_chunk_step(jparams, jnp.asarray(toks), jcfg, jc)
        tlog, tc = ts.paged_chunk_step(tparams, torch.as_tensor(toks), tcfg,
                                       tc)
        assert tlog.shape == (batch, kc, jcfg.vocab_size)
        assert _logits_err(tlog, jlog) < tol
    for _ in range(2):
        tok = rng.integers(0, jcfg.vocab_size, (batch,)).astype(np.int32)
        jlog, jc = js.paged_decode_step(jparams, jnp.asarray(tok), jcfg, jc)
        tlog, tc = ts.paged_decode_step(tparams, torch.as_tensor(tok), tcfg,
                                        tc)
        assert _logits_err(tlog, jlog) < tol
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))
    if dtype == "float32":
        jk = pools_from_numpy([np.asarray(p) for p in jc.k], jcfg.head_dim,
                              dtype=torch.float32, device="cpu")
        jv = pools_from_numpy([np.asarray(p) for p in jc.v], jcfg.head_dim,
                              dtype=torch.float32, device="cpu")
        for a, b in zip(list(tc.k) + list(tc.v), jk + jv):
            assert float((a - b).abs().max()) < tol


def test_paged_generate_matches_jax_token_for_token():
    jcfg, tcfg, jparams, tparams, _ = _setup("float32")
    prompt = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, (2, 21)).astype(np.int32)
    j = js.paged_generate(jparams, jnp.asarray(prompt), jcfg,
                          max_new_tokens=6, page_size=PAGE)
    t = ts.paged_generate(tparams, torch.as_tensor(prompt), tcfg,
                          max_new_tokens=6, page_size=PAGE)
    assert t.numpy().tolist() == np.asarray(j).tolist()


def test_unported_serving_options_raise():
    _, tcfg, _, tparams, _ = _setup("float32")
    cache = ts.init_paged_model_cache(tcfg, 1, 32, page_size=PAGE,
                                      device="cpu")
    tok = torch.zeros((1,), dtype=torch.int32)
    # mesh= is taken since slice 19 (tests/test_torch_serving_tp.py); a
    # mesh that is not one is a TypeError.
    with pytest.raises(TypeError, match="DeviceMesh"):
        ts.paged_decode_step(tparams, tok, tcfg, cache, mesh=object())
    # LoRA (taken since slice 16): as in JAX, adapter 0 (B = 0) is the
    # base model bit for bit, and another adapter moves the logits.
    from metal_flash_attention_tpu_torch.models.lora import (
        init_lora_adapters,
    )
    adapters = init_lora_adapters(tcfg, 2, 4, b_scale=0.3, device="cpu",
                                  generator=torch.Generator().manual_seed(0))
    base, _ = ts.paged_decode_step(tparams, tok, tcfg, cache)
    outs = [ts.paged_decode_step(
        tparams, tok, tcfg, cache, lora=adapters,
        lora_ids=torch.tensor([i], dtype=torch.int32))[0] for i in (0, 1)]
    assert torch.equal(outs[0], base)
    assert not torch.allclose(outs[1], base, atol=1e-3)
    # Mixtral-style layers (taken since slice 18) run there: one token at
    # position 0 gives `moe.forward`'s last logits.
    from metal_flash_attention_tpu_torch.models import moe as tmoe
    mcfg = tmoe.MoEConfig.tiny(n_layers=2, dtype=torch.float32)
    gen = torch.Generator().manual_seed(1)
    attn = ("wq", "wk", "wv", "wo", "attn_norm", "mlp_norm")
    mparams = dict(tparams, layers=[
        dict({k: layer[k] for k in attn},
             moe=tmoe.init_moe_ffn(mcfg, gen, device="cpu"))
        for layer in tparams["layers"]])
    logits, _ = ts.paged_decode_step(mparams, tok, mcfg, cache)
    want, _, _ = tmoe.forward(mparams, tok[None], mcfg)
    assert torch.isfinite(logits).all()
    assert float((logits - want[:, -1]).abs().max()) < 1e-4
