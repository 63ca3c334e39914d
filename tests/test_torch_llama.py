"""The port's Llama serving blocks against the JAX package, on
`LlamaConfig.tiny` in float32 at 1e-5, with weights carried from the
JAX params through numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.utils.params import (
    params_from_numpy,
    pools_from_numpy,
)

TOL = 1e-5


def _cfgs(**kw):
    return (jl.LlamaConfig.tiny(dtype=jnp.float32, **kw),
            tl.LlamaConfig.tiny(dtype=torch.float32, **kw))


@pytest.fixture(scope="module")
def carried():
    jcfg, tcfg = _cfgs()
    jparams = jl.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                dtype=torch.float32, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _err(t, j):
    return float(np.max(np.abs(t.detach().float().numpy()
                               - np.asarray(j, np.float32))))


def test_config_defaults_match_jax():
    for name in ("tiny", "llama3_8b"):
        jc = getattr(jl.LlamaConfig, name)()
        tc = getattr(tl.LlamaConfig, name)()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "hidden_dim", "rope_theta", "norm_eps", "head_dim",
                  "rope_scaling_factor", "rope_low_freq_factor",
                  "rope_high_freq_factor", "rope_original_max_position",
                  "sliding_window"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert tc.dtype == torch.bfloat16


def test_rms_norm_matches_jax(carried):
    jcfg, tcfg, jparams, tparams = carried
    x = np.random.default_rng(0).standard_normal((2, 5, 128)).astype(
        np.float32)
    w = np.random.default_rng(1).standard_normal(128).astype(np.float32)
    j = jl.rms_norm(jnp.asarray(x), jnp.asarray(w), jcfg.norm_eps)
    t = tl.rms_norm(torch.as_tensor(x), torch.as_tensor(w), tcfg.norm_eps)
    assert _err(t, j) < TOL


@pytest.mark.parametrize("scaling", [None, 8.0])
def test_rope_frequencies_match_jax(scaling):
    jcfg, tcfg = _cfgs(rope_scaling_factor=scaling,
                       rope_original_max_position=64)
    pos = np.array([[0, 1, 7, 63], [5, 30, 100, 200]], np.int32)
    jc, js = jl.rope_frequencies(jcfg, jnp.asarray(pos))
    tc, ts = tl.rope_frequencies(tcfg, torch.as_tensor(pos))
    assert _err(tc, jc) < TOL
    assert _err(ts, js) < TOL


def test_apply_rope_matches_jax():
    jcfg, tcfg = _cfgs()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 4, 6, jcfg.head_dim)).astype(np.float32)
    pos = np.tile(np.arange(6, dtype=np.int32) + 3, (2, 1))
    jc, js = jl.rope_frequencies(jcfg, jnp.asarray(pos))
    tc, ts = tl.rope_frequencies(tcfg, torch.as_tensor(pos))
    j = jl.apply_rope(jnp.asarray(x), jc, js)
    t = tl.apply_rope(torch.as_tensor(x), tc, ts)
    assert _err(t, j) < TOL


def test_mlp_block_matches_jax(carried):
    jcfg, tcfg, jparams, tparams = carried
    x = np.random.default_rng(3).standard_normal((2, 5, 128)).astype(
        np.float32)
    j = jl.mlp_block(jparams["layers"][0], jnp.asarray(x), jcfg)
    t = tl.mlp_block(tparams["layers"][0], torch.as_tensor(x), tcfg)
    assert _err(t, j) < TOL


def test_params_from_numpy_round_trips_exactly():
    """bf16 weights pass through numpy as float32 and come back bit for
    bit; norms stay float32."""
    jcfg = jl.LlamaConfig.tiny()
    jparams = jl.init_params(jax.random.PRNGKey(1), jcfg)
    tree = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jparams)
    tparams = params_from_numpy(tree, dtype=torch.bfloat16, device="cpu")
    assert tparams["layers"][1]["wq"].dtype == torch.bfloat16
    assert tparams["final_norm"].dtype == torch.float32
    back = jax.tree.map(lambda t: t.float().numpy(), tparams)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)


def test_pools_from_numpy_cuts_lane_padding():
    pool = np.arange(2 * 1 * 4 * 128, dtype=np.float32).reshape(2, 1, 4, 128)
    (t,) = pools_from_numpy([pool], head_dim=32, dtype=torch.float32,
                            device="cpu")
    assert t.shape == (2, 1, 4, 32)
    np.testing.assert_array_equal(t.numpy(), pool[..., :32])


def test_init_params_shapes_and_seed():
    cfg = tl.LlamaConfig.tiny(n_layers=1)
    a = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = tl.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert a["layers"][0]["wk"].shape == (cfg.dim,
                                          cfg.n_kv_heads * cfg.head_dim)
    assert a["lm_head"].shape == (cfg.dim, cfg.vocab_size)
    assert a["embed"].dtype == torch.bfloat16
    assert torch.equal(a["layers"][0]["w_up"], b["layers"][0]["w_up"])
