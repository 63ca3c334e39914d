"""Speculative decoding and beam search on the card: the paged prefill
kernel at the verify shape (q_chunk = draft_len + 1, chunks across a page
boundary), a beam step's cache gather, and `speculative_generate` on a
tiny head_dim-128 model.  Every test skips without a CUDA card (the hand
kernels have no CPU mode).  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_speculative_cuda.py

Tolerance: the bf16 tier, MIXED_TOL, for the kernel against its plain
version; a step's logits on the card against the same step on the CPU
(the plain versions) by their relative rms error, LOGITS_REL_RMS.  Token
streams of two paths are equal up to their first difference, and there
both tokens' logits on the plain path must lie within TIE of its top
logit (the chunk and the decode kernels round bf16 logits their own
ways).
"""

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.models import llama
from metal_flash_attention_tpu_torch.models import serving
from metal_flash_attention_tpu_torch.ops import flash_decode as fd
from metal_flash_attention_tpu_torch.ops import paged_attention as pa
from metal_flash_attention_tpu_torch.utils.tree import tree_map
from metal_flash_attention_tpu_torch.utils.tolerances import (
    MIXED_TOL,
    max_abs_err,
)

KD = 4
LOGITS_REL_RMS = 2e-2
# A few bf16 steps of a logit of magnitude 4.
TIE = 0.125


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def model(cuda):
    """A 2-layer bf16 Llama at head_dim 128 on the card, and its CPU
    copy."""
    cfg = llama.LlamaConfig.tiny(dim=512, n_heads=4, n_kv_heads=2,
                                 vocab_size=512)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    return cfg, tree_map(lambda t: t.to(cuda), params), params


def test_verify_chunk_across_page_boundary(cuda):
    """q [4, 32, 5, 128] (Llama-3-8B's heads, draft_len 4) over 128-token
    pages, each sequence's chunk ending at its length: two chunks cross a
    page boundary (125..129, 252..256), one sits inside a page."""
    rng = np.random.default_rng(0)
    lengths = [130, 257, 300, 7]
    page, kvh, qh, d, kc = 128, 8, 32, 128, KD + 1
    max_pages = -(-max(lengths) // page)
    num_pages = len(lengths) * max_pages + 1
    shape = (num_pages, kvh, page, d)

    def t(x, dtype=torch.bfloat16):
        return torch.as_tensor(x).to(device=cuda, dtype=dtype)
    perm = rng.permutation(np.arange(1, num_pages))
    cache = pa.PagedKVCache(
        t(rng.standard_normal(shape)), t(rng.standard_normal(shape)),
        t(perm.reshape(len(lengths), max_pages), torch.int32),
        t(np.asarray(lengths), torch.int32))
    q = t(rng.standard_normal((len(lengths), qh, kc, d)))
    pa.reset_launch_counts()
    o, lse = pa.paged_prefill(q, cache, return_residuals=True)
    assert pa.LAUNCH_COUNTS["paged_prefill"] == 1
    assert pa.LAUNCH_COUNTS["paged_prefill_sm90"] == 1
    po, plse = pa._paged_attention_plain(q, cache, scale=d ** -0.5,
                                         window_size=None)
    assert max_abs_err(o, po) < MIXED_TOL.o
    assert max_abs_err(lse, plse) < MIXED_TOL.lse


def _rel_rms(got, want):
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt())


def test_beam_step_gather_on_card(model, cuda):
    """A beam step over 2 x 3 beams: its decode's logits against the same
    step on the CPU, every layer's K/V rows gathered by parent (the
    step's own row included), the lengths, and one `flash_decode` a
    layer."""
    cfg, params, cpu_params = model
    b, k, s = 2, 3, 40
    prompt = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32)

    def prefilled(p, device):
        cache = serving.init_cache(cfg, b, s + 4, device=device)
        _, cache = serving.prefill(p, prompt.to(device), cfg, cache)
        return serving.KVCache(
            k=[c.repeat_interleave(k, 0) for c in cache.k],
            v=[c.repeat_interleave(k, 0) for c in cache.v],
            lengths=cache.lengths.repeat_interleave(k, 0))
    tokens = torch.tensor([3, 50, 7, 9, 9, 200], dtype=torch.int32)
    card_cache = prefilled(params, cuda)
    _, after = serving.decode_step(
        params, tokens.to(cuda), cfg, serving.KVCache(
            [c.clone() for c in card_cache.k],
            [c.clone() for c in card_cache.v], card_cache.lengths.clone()))
    card_logits, _ = serving.decode_step(
        params, tokens.to(cuda), cfg, serving.KVCache(
            [c.clone() for c in card_cache.k],
            [c.clone() for c in card_cache.v], card_cache.lengths.clone()))
    cpu_logits, _ = serving.decode_step(cpu_params, tokens, cfg,
                                        prefilled(cpu_params, "cpu"))
    assert _rel_rms(card_logits, cpu_logits) < LOGITS_REL_RMS
    scores = torch.tensor([[-1.0, -1.5, -9.0], [-2.0, -2.0, -2.5]],
                          device=cuda)
    finished = torch.zeros((b, k), dtype=torch.bool, device=cuda)
    fd.reset_launch_counts()
    new, tok, new_scores, _, parent = serving._beam_step(
        params, cfg, card_cache, tokens.to(cuda), scores, finished,
        num_beams=k, eos_token=-1)
    assert fd.LAUNCH_COUNTS["flash_decode"] == cfg.n_layers
    assert fd.LAUNCH_COUNTS["flash_decode_sm90"] == cfg.n_layers
    rows = (torch.arange(b, device=cuda)[:, None] * k + parent).reshape(-1)
    for got, want in zip(new.k + new.v, after.k + after.v):
        assert torch.equal(got, want[rows])
    assert new.lengths.tolist() == [s + 1] * (b * k)
    logp = torch.log_softmax(card_logits.float(), -1).reshape(b, k, -1)
    want = scores.gather(1, parent) + logp.reshape(b, -1).gather(
        1, parent * logp.shape[-1] + tok.reshape(b, k).long())
    assert torch.allclose(new_scores, want)


def _plain_logits(cfg, params, prompt_row, prefix, budget):
    """The plain paged path's logits after the prompt and the generated
    ``prefix``, one row."""
    cache = serving.init_paged_model_cache(cfg, 1, budget, page_size=16,
                                           device=prompt_row.device)
    logits, cache = serving.paged_chunk_step(
        params, prompt_row[None], cfg, cache)
    logits = logits[:, -1]
    for tok in prefix:
        logits, cache = serving.paged_decode_step(
            params, torch.tensor([int(tok)], dtype=torch.int32,
                                 device=prompt_row.device), cfg, cache)
    return logits[0].float()


def test_speculative_generate_on_card(model, cuda):
    """A random draft: the all-reject run's stream exactly (the same
    verify chunks), and `paged_generate`'s up to a near-tie; one
    `paged_prefill` a layer a chunk, every one on the Hopper kernel, and
    no decode kernel."""
    cfg, params, _ = model
    b, s, new = 3, 40, 16
    prompt = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)), dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(3)
    kw = dict(draft_len=KD, max_new_tokens=new, page_size=16)
    pa.reset_launch_counts()
    rounds = []

    def draft_fn(last, buf):
        assert last.device == buf.device == prompt.device
        rounds.append(1)
        return rng.integers(0, cfg.vocab_size, (b, KD))
    out = serving.speculative_generate(params, prompt, cfg,
                                       draft_fn=draft_fn, **kw)
    chunks = -(-s // 16)
    assert pa.LAUNCH_COUNTS["paged_prefill"] == cfg.n_layers * (
        chunks + len(rounds))
    assert pa.LAUNCH_COUNTS["paged_prefill_sm90"] == \
        pa.LAUNCH_COUNTS["paged_prefill"]
    assert pa.LAUNCH_COUNTS["paged_decode"] == 0
    reject = serving.speculative_generate(
        params, prompt, cfg,
        draft_fn=lambda last, buf: torch.full((b, KD), cfg.vocab_size - 1),
        **kw)
    assert torch.equal(out, reject)
    plain = serving.paged_generate(params, prompt, cfg, max_new_tokens=new,
                                   page_size=16)
    for r in range(b):
        a, o = plain[r, s:].tolist(), out[r, s:].tolist()
        if a == o:
            continue
        j = next(i for i, (x, y) in enumerate(zip(a, o)) if x != y)
        logits = _plain_logits(cfg, params, prompt[r], a[:j], s + new + 1)
        for tok in (a[j], o[j]):
            assert float(logits.max() - logits[tok]) <= TIE, (r, j)
