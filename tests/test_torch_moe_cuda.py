"""Mixtral-style MoE on the card: `moe_ffn` against the CPU's plain path
on the same weights, and a small engine at head_dim 128 whose steps are
held against the same steps on CPU copies.  Every test skips without a
CUDA card.  The file imports neither JAX nor the JAX package, so it also
runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_moe_cuda.py

Routes are compared exactly where the gates do not nearly tie (float32
router products on both sides); outputs and logits by their relative rms
error against the CPU's, REL_RMS (bf16 products in another order).
"""

from unittest import mock

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.models import moe, serving
from metal_flash_attention_tpu_torch.models.engine import ServingEngine
from metal_flash_attention_tpu_torch.ops import paged_attention as pa
from metal_flash_attention_tpu_torch.utils.tree import tree_map

REL_RMS = 2e-2
# Gate margin (in probability) under which two experts count as tied.
ROUTE_TIE = 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def model(cuda):
    """A 2-layer bf16 Mixtral-style model at head_dim 128 (8 experts,
    top-2) on the card, and its CPU copy."""
    cfg = moe.MoEConfig.tiny(dim=512, n_heads=4, n_kv_heads=2,
                             vocab_size=512, hidden_dim=1024, n_experts=8)
    params = moe.init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    return cfg, tree_map(lambda t: t.to(cuda), params), params


def _rel_rms(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt())


def test_moe_ffn_on_card(model, cuda):
    """600 tokens (capacity 188 an expert, some over it): the same
    routes as the CPU's away from near-ties, and the output."""
    cfg, params, cpu_params = model
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, 300, cfg.dim)), dtype=cfg.dtype)
    bank, cpu_bank = params["layers"][0]["moe"], cpu_params["layers"][0][
        "moe"]
    y, aux = moe.moe_ffn(bank, x.to(cuda), cfg)
    want, want_aux = moe.moe_ffn(cpu_bank, x, cfg)
    assert y.device == x.to(cuda).device and y.dtype == cfg.dtype
    assert _rel_rms(y, want) < REL_RMS
    assert abs(float(aux) - float(want_aux)) < 1e-4
    gates = torch.softmax(x.reshape(-1, cfg.dim).float()
                          @ cpu_bank["w_router"], dim=-1)
    card_gates = torch.softmax(x.reshape(-1, cfg.dim).to(cuda).float()
                               @ bank["w_router"], dim=-1)
    _, topi = moe._top_k(gates, cfg.top_k)
    _, card_topi = moe._top_k(card_gates, cfg.top_k)
    ordered = gates.sort(dim=-1, descending=True).values
    clear = (ordered[:, :cfg.top_k] - ordered[:, 1:cfg.top_k + 1]).min(
        dim=-1).values > ROUTE_TIE
    assert torch.equal(card_topi.cpu()[clear], topi[clear])


def test_moe_engine_on_card(model, cuda):
    """Three requests through two slots by `step()`: one `paged_prefill`
    a layer a chunk and one `paged_decode` a layer a decode step, each on
    the Hopper kernel; the first chunk's logits against the CPU's; and
    `step_burst(4)` giving the same streams."""
    cfg, params, cpu_params = model
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (40, 16, 70)]
    args = dict(max_batch=2, num_pages=24, page_size=16, max_seq=96)

    def drain(eng, burst=0):
        rids = [eng.submit(p, 8) for p in prompts]
        steps = 0
        while not eng.idle:
            eng.step_burst(burst) if burst else eng.step()
            steps += 1
            assert steps < 200
        return [eng.result(r).tolist() for r in rids]
    pa.reset_launch_counts()
    eng = ServingEngine(params, cfg, **args)
    streams = drain(eng)
    chunks = sum(-(-len(p) // 16) for p in prompts)
    assert pa.LAUNCH_COUNTS["paged_prefill"] == cfg.n_layers * chunks
    assert pa.LAUNCH_COUNTS["paged_prefill_sm90"] == \
        pa.LAUNCH_COUNTS["paged_prefill"]
    assert pa.LAUNCH_COUNTS["paged_decode"] > 0
    assert pa.LAUNCH_COUNTS["paged_decode"] % cfg.n_layers == 0
    assert pa.LAUNCH_COUNTS["paged_decode_sm90"] == \
        pa.LAUNCH_COUNTS["paged_decode"]
    for out, p in zip(streams, prompts):
        assert len(out) == len(p) + 8
        assert all(0 <= t < cfg.vocab_size for t in out)
    assert drain(ServingEngine(params, cfg, **args), burst=4) == streams

    def first_chunk(p, device):
        cache = serving.init_paged_model_cache(cfg, 1, 32, page_size=16,
                                               device=device)
        tok = torch.as_tensor(prompts[0][None, :16]).to(device)
        return serving.paged_chunk_step(p, tok, cfg, cache)[0]
    # The CPU takes the card's expert choices: a near-tie may route a
    # token another way on each side, which would move its logits far
    # more than the attention's rounding does.
    choices = []
    with _recording_top_k(choices):
        card = first_chunk(params, cuda)
    with _replaying_top_k(choices):
        cpu = first_chunk(cpu_params, "cpu")
    assert _rel_rms(card, cpu) < REL_RMS


def _recording_top_k(choices: list):
    """`moe._top_k`, each call's expert ids appended to ``choices``."""
    real = moe._top_k

    def top_k(gates, k):
        topw, topi = real(gates, k)
        choices.append(topi.cpu())
        return topw, topi
    return mock.patch.object(moe, "_top_k", top_k)


def _replaying_top_k(choices: list):
    """A `moe._top_k` that takes the recorded ``choices`` in call order,
    weighted by the gates it is given."""
    taken = iter(choices)

    def top_k(gates, k):
        topi = next(taken).to(gates.device)
        topw = gates.gather(1, topi)
        return topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9), topi
    return mock.patch.object(moe, "_top_k", top_k)
