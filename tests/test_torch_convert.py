"""`models.convert` of the port against the JAX package's, and against
HuggingFace's own models.

- From an HF-named numpy state dict and a plain config object with HF's
  field names, the port's config equals JAX's and its parameters equal
  JAX's `convert` output bit for bit, in float32 and bf16: Llama-3.1 with
  llama3 rope scaling, Qwen2 q/k/v biases, tied embeddings without the
  ``model.`` prefix, a sliding window with and without Qwen2's
  ``use_sliding_window``, and Gemma-2.  No leaf shares memory with
  the caller's tensors or another leaf, and two training steps on a
  converted tied model match JAX's.
- With `transformers` installed (no download: tiny random models), the
  port's forward on converted `LlamaForCausalLM` and `Gemma2ForCausalLM`
  weights against HF's eager logits (float32, 2e-3 as the JAX package's
  tests/test_convert.py), and greedy generation token for token: a
  second reference beside JAX.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from metal_flash_attention_tpu.models import convert as jconvert
from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import optim as joptim
from metal_flash_attention_tpu_torch.models import convert as tconvert
from metal_flash_attention_tpu_torch.models import gemma as tgemma
from metal_flash_attention_tpu_torch.models import llama as tl
from metal_flash_attention_tpu_torch.models import optim as toptim
from metal_flash_attention_tpu_torch.models import serving as ts
from metal_flash_attention_tpu_torch.utils.tolerances import max_abs_err
from metal_flash_attention_tpu_torch.utils.tree import flatten, leaf_paths

HF_TOL = 2e-3
DIM, HEADS, KV_HEADS, HIDDEN, VOCAB, LAYERS = 128, 4, 2, 256, 256, 2

LLAMA_CASES = {
    "llama31": dict(rope_scaling={"rope_type": "llama3", "factor": 8.0,
                                  "low_freq_factor": 1.0,
                                  "high_freq_factor": 4.0,
                                  "original_max_position_embeddings": 32}),
    "qwen2": dict(bias=True, sliding_window=16, use_sliding_window=False),
    "qwen2_window": dict(bias=True, sliding_window=16,
                         use_sliding_window=True),
    "mistral": dict(sliding_window=8),
    "tied": dict(tied=True, prefix=""),
}


def _hf_config(**kw):
    base = dict(vocab_size=VOCAB, hidden_size=DIM, num_hidden_layers=LAYERS,
                num_attention_heads=HEADS, num_key_value_heads=KV_HEADS,
                intermediate_size=HIDDEN, rope_theta=10000.0,
                rms_norm_eps=1e-5, rope_scaling=None)
    base.update(kw)
    return SimpleNamespace(**base)


def _state_dict(seed, *, head_dim=DIM // HEADS, bias=False, tied=False,
                prefix="model.", gemma=False):
    """HF-named float32 numpy weights, [out, in] projections."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    qkv, kv = HEADS * head_dim, KV_HEADS * head_dim
    sd = {prefix + "embed_tokens.weight": w(VOCAB, DIM),
          prefix + "norm.weight": w(DIM)}
    norms = (("input_layernorm", "post_attention_layernorm",
              "pre_feedforward_layernorm", "post_feedforward_layernorm")
             if gemma else ("input_layernorm", "post_attention_layernorm"))
    for i in range(LAYERS):
        lp = f"{prefix}layers.{i}."
        for name, shape in (("self_attn.q_proj", (qkv, DIM)),
                            ("self_attn.k_proj", (kv, DIM)),
                            ("self_attn.v_proj", (kv, DIM)),
                            ("self_attn.o_proj", (DIM, qkv)),
                            ("mlp.gate_proj", (HIDDEN, DIM)),
                            ("mlp.up_proj", (HIDDEN, DIM)),
                            ("mlp.down_proj", (DIM, HIDDEN))):
            sd[lp + name + ".weight"] = w(*shape)
        for n in norms:
            sd[lp + n + ".weight"] = w(DIM)
        if bias:
            for n, size in (("q_proj", qkv), ("k_proj", kv), ("v_proj", kv)):
                sd[lp + f"self_attn.{n}.bias"] = w(size)
    if not tied and not gemma:
        sd["lm_head.weight"] = w(VOCAB, DIM)
    return sd


def _jax_leaves(tree) -> dict:
    """A JAX tree's leaves as numpy, keyed by path."""
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(x)
            for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_same(tparams, jparams):
    """Every leaf bit for bit, keyed by path."""
    want = _jax_leaves(jparams)
    leaves = flatten(tparams)[0]
    assert sorted(leaf_paths(tparams)) == sorted(want)
    for key, leaf in zip(leaf_paths(tparams), leaves):
        w = want[key]
        assert tuple(leaf.shape) == w.shape, key
        assert str(leaf.dtype).split(".")[-1] == w.dtype.name, key
        got = leaf.contiguous().view(
            torch.int16 if leaf.dtype == torch.bfloat16 else torch.int32)
        assert np.array_equal(got.numpy(), w.view(
            np.int16 if w.dtype.itemsize == 2 else np.int32)), key


def _fields(cfg):
    return {k: v for k, v in vars(cfg).items() if k != "dtype"}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(LLAMA_CASES))
def test_llama_family_matches_jax_bit_for_bit(case, dtype):
    kw = dict(LLAMA_CASES[case])
    sd_kw = {k: kw.pop(k) for k in ("bias", "tied", "prefix") if k in kw}
    hf_cfg = _hf_config(**kw)
    sd = _state_dict(11, **sd_kw)
    jcfg = jconvert.config_from_hf_llama(hf_cfg, dtype=getattr(jnp, dtype))
    tcfg = tconvert.config_from_hf_llama(hf_cfg,
                                         dtype=getattr(torch, dtype))
    assert _fields(tcfg) == _fields(jcfg)
    assert tcfg.dtype == getattr(torch, dtype)
    source = {k: torch.from_numpy(v) for k, v in sd.items()}
    tparams = tconvert.params_from_hf_llama(source, tcfg, device="cpu")
    _assert_same(tparams, jconvert.params_from_hf_llama(sd, jcfg))
    # Every leaf owns its memory: none is the caller's tensor or another
    # leaf (the training steps and `restore` write leaves in place).
    ptrs = [leaf.data_ptr() for leaf in flatten(tparams)[0]]
    assert len(set(ptrs)) == len(ptrs)
    assert not set(ptrs) & {t.data_ptr() for t in source.values()}
    # numpy arrays convert the same as torch tensors
    _assert_same(tconvert.params_from_hf_llama(sd, tcfg, device="cpu"),
                 jconvert.params_from_hf_llama(sd, jcfg))
    if case.startswith("qwen2"):
        assert "bq" in tparams["layers"][1]
        assert tcfg.sliding_window == (16 if case == "qwen2_window"
                                       else None)


def test_tied_model_trains_as_in_jax():
    """Two steps of full fine-tuning through `make_train_step` (float32
    shadows written back into the leaves in place) on a converted tied
    model, against JAX's on its own conversion: the head is a leaf of its
    own in both, so its update never lands in the embedding.  SGD, so
    that every entry's update is its gradient and every parameter is held
    at 1e-5 as tests/test_torch_train.py holds the SGD step (Adam's
    near-zero-gradient entries take steps that their last bits decide);
    the losses at 2e-5."""
    lr, steps = 0.1, 2
    hf_cfg = _hf_config()
    # Projections at 1/sqrt(fan-in), norm gains near 1: a trained
    # model's scales, not unit-normal logits.
    sd = {k: (v / np.sqrt(v.shape[1]) if v.ndim == 2 else 1 + 0.1 * v)
          for k, v in _state_dict(13, tied=True, prefix="").items()}
    batches = np.random.default_rng(3).integers(
        0, VOCAB, (steps, 2, 33)).astype(np.int32)
    jcfg = jconvert.config_from_hf_llama(hf_cfg, dtype=jnp.float32)
    tcfg = tconvert.config_from_hf_llama(hf_cfg, dtype=torch.float32)

    init, step = joptim.make_train_step(
        lambda p, b: jl.loss_fn(p, b, jcfg), optax.sgd(lr))
    jp = jconvert.params_from_hf_llama(sd, jcfg)
    js_ = init(jp)
    jlosses = []
    for b in batches:
        jp, js_, loss = step(jp, js_, jnp.asarray(b))
        jlosses.append(float(loss))

    init_t, step_t = toptim.make_train_step(
        lambda p, b: tl.loss_fn(p, b, tcfg),
        lambda ts_: torch.optim.SGD(ts_, lr=lr))
    tp = tconvert.params_from_hf_llama(sd, tcfg, device="cpu")
    ts_ = init_t(tp)
    for b, want in zip(batches, jlosses):
        tp, ts_, loss = step_t(tp, ts_, torch.from_numpy(b))
        assert abs(float(loss) - want) <= 2e-5
    jleaves = _jax_leaves(jp)
    for key, leaf in zip(leaf_paths(tp), flatten(tp)[0]):
        assert max_abs_err(leaf, jleaves[key]) <= 1e-5, key


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gemma2_matches_jax_bit_for_bit(dtype):
    hf_cfg = _hf_config(head_dim=32, sliding_window=64,
                        attn_logit_softcapping=50.0,
                        final_logit_softcapping=30.0,
                        query_pre_attn_scalar=24, rms_norm_eps=1e-6)
    sd = _state_dict(12, head_dim=32, gemma=True)
    jcfg = jconvert.config_from_hf_gemma2(hf_cfg, dtype=getattr(jnp, dtype))
    tcfg = tconvert.config_from_hf_gemma2(hf_cfg,
                                          dtype=getattr(torch, dtype))
    assert _fields(tcfg) == _fields(jcfg)
    _assert_same(tconvert.params_from_hf_gemma2(sd, tcfg, device="cpu"),
                 jconvert.params_from_hf_gemma2(sd, jcfg))


def test_unsupported_rope_scaling_raises_as_in_jax():
    hf_cfg = _hf_config(rope_scaling={"rope_type": "yarn", "factor": 4.0})
    for convert in (jconvert, tconvert):
        with pytest.raises(ValueError, match="yarn"):
            convert.config_from_hf_llama(hf_cfg)


@pytest.fixture(scope="module")
def hf_llama():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.LlamaConfig(
        vocab_size=VOCAB, hidden_size=DIM, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, num_key_value_heads=KV_HEADS,
        intermediate_size=HIDDEN, max_position_embeddings=512,
        attention_dropout=0.0, tie_word_embeddings=False)
    torch.manual_seed(0)
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    cfg = tconvert.config_from_hf_llama(hf_cfg, dtype=torch.float32)
    params = tconvert.params_from_hf_llama(model, cfg, device="cpu")
    tokens = np.random.default_rng(81).integers(0, VOCAB, (2, 24))
    return model, cfg, params, torch.from_numpy(tokens)


def test_llama_forward_matches_hf(hf_llama):
    model, cfg, params, tokens = hf_llama
    with torch.no_grad():
        want = model(tokens).logits
        got, _ = tl.forward(params, tokens, cfg)
        assert float((got - want).abs().max()) < HF_TOL
        # and through the paged serving path (chunked prefill)
        cache = ts.init_paged_model_cache(cfg, 2, 64, page_size=16,
                                          device="cpu")
        for i in range(0, 24, 16):
            logits, cache = ts.paged_chunk_step(params, tokens[:, i:i + 16],
                                                cfg, cache)
    assert float((logits - want[:, 16:]).abs().max()) < HF_TOL


def test_llama_greedy_generation_matches_hf(hf_llama):
    model, cfg, params, tokens = hf_llama
    with torch.no_grad():
        want = model.generate(tokens[:1], max_new_tokens=8, do_sample=False,
                              num_beams=1, pad_token_id=0)
    got = ts.generate(params, tokens[:1].to(torch.int32), cfg,
                      max_new_tokens=8)
    assert got[0].tolist() == want[0].tolist()


def test_gemma2_forward_matches_hf():
    transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.Gemma2Config(
        vocab_size=VOCAB, hidden_size=DIM, num_hidden_layers=LAYERS,
        num_attention_heads=HEADS, num_key_value_heads=KV_HEADS,
        head_dim=32, intermediate_size=HIDDEN, max_position_embeddings=512,
        sliding_window=16, attn_logit_softcapping=50.0,
        final_logit_softcapping=30.0, query_pre_attn_scalar=32,
        attention_dropout=0.0)
    torch.manual_seed(1)
    model = transformers.Gemma2ForCausalLM(hf_cfg).eval()
    cfg = tconvert.config_from_hf_gemma2(hf_cfg, dtype=torch.float32)
    params = tconvert.params_from_hf_gemma2(model, cfg, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(83).integers(
        0, VOCAB, (2, 24)))       # longer than the window
    with torch.no_grad():
        want = model(tokens).logits
        got, _ = tgemma.forward(params, tokens, cfg)
    assert float((got - want).abs().max()) < HF_TOL
