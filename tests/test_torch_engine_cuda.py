"""The engine's sampler and `step_burst` on the card.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_engine_cuda.py

- The sampler on the card against the same sampler on the CPU: the same
  float32 logits [64, 32000] and row keys under three parameter sets
  must give at least 99% equal tokens (the hashed noise is the same bits
  on both devices; only the last ulp of a log or a softmax may differ,
  which flips a draw only where two noisy logits nearly tie).
- A 2-layer bf16 engine's `step_burst(8)` against its own `step()`, over
  bf16 and INT8 pools: equal streams, greedy and sampled, every burst's
  steps free of synchronising calls (`torch.cuda.set_sync_debug_mode`),
  and the decode kernels launched once a layer for every burst step.
"""

import contextlib

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.models import llama, serving
from metal_flash_attention_tpu_torch.models.engine import ServingEngine
from metal_flash_attention_tpu_torch.ops import flash_decode as fd
from metal_flash_attention_tpu_torch.ops import paged_attention as pa

SAME_TOKENS = 0.99
PARAMETER_SETS = [
    dict(temperature=0.8, top_k=50, top_p=0.95),
    dict(temperature=1.0, top_k=0, top_p=1.0),
    dict(temperature=0.6, top_k=0, top_p=0.9),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the engine's kernels have no CPU "
                    "mode on a CUDA tensor")
    return torch.device("cuda")


@pytest.mark.parametrize("params", PARAMETER_SETS)
def test_sampler_on_the_card_matches_the_cpu(cuda, params):
    b, vocab = 64, 32000
    rng = np.random.default_rng(0)
    logits = torch.as_tensor((3 * rng.standard_normal((b, vocab))).astype(
        np.float32))
    rids = torch.arange(b, dtype=torch.int32)
    idxs = torch.as_tensor(rng.integers(0, 1000, (b,)).astype(np.int32))

    def draw(device):
        full = lambda v: torch.full((b,), v, device=device)  # noqa: E731
        keys = serving._row_keys(9, rids.to(device), idxs.to(device))
        return serving.sample_token_per_row(
            logits.to(device), keys, full(float(params["temperature"])),
            full(int(params["top_k"])), full(float(params["top_p"]))).cpu()

    same = (draw(cuda) == draw("cpu")).float().mean().item()
    assert same >= SAME_TOKENS, same


@contextlib.contextmanager
def _watched_bursts(steps):
    """Each burst's device steps under sync debug mode "error"; steps
    gets each burst's n_steps."""
    originals = {n: getattr(serving, n) for n in ("paged_decode_burst",
                                                  "paged_decode_burst_q")}

    def wrap(fn):
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                steps.append(kwargs["n_steps"])
        return run
    for n, fn in originals.items():
        setattr(serving, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(serving, n, fn)


@pytest.mark.parametrize("precision", [None, "int8"])
def test_burst_matches_step(cuda, precision):
    """Greedy and sampled requests with 16-token pages: page flushes,
    staggered admission, a stop token, a logit bias and logprobs."""
    cfg = llama.LlamaConfig.tiny(n_layers=2, dim=512, n_heads=8,
                                 n_kv_heads=1)
    params = llama.init_params(cfg, torch.Generator(device=cuda)
                               .manual_seed(0), device=cuda)
    gen = np.random.default_rng(6)
    prompts = [gen.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (40, 21, 9)]
    requests = [(prompts[0], 20, dict(logprobs=True, logit_bias={3: 2.0})),
                (prompts[1], 18, dict(temperature=0.8, top_k=20,
                                      top_p=0.95)),
                (prompts[2], 12, {})]

    def run(burst, stop=()):
        eng = ServingEngine(params, cfg, max_batch=2, num_pages=24,
                            page_size=16, max_seq=128, seed=3,
                            kv_precision=precision)
        rids = [eng.submit(p, m, stop_tokens=stop if i == 2 else (), **kw)
                for i, (p, m, kw) in enumerate(requests)]
        steps = []
        pa.reset_launch_counts()
        fd.reset_launch_counts()
        with _watched_bursts(steps):
            while not eng.idle:
                eng.step_burst(burst) if burst else eng.step()
        torch.cuda.synchronize()
        assert eng.alloc.free_pages == 23
        return ([eng.result(r).tolist() for r in rids],
                eng.result_logprobs(rids[0]), steps,
                dict(pa.LAUNCH_COUNTS), dict(fd.LAUNCH_COUNTS))

    ref, ref_lp, _, _, _ = run(0)
    stop = [ref[2][len(prompts[2]) + 4]]
    ref_stop = run(0, stop)[0]
    for want, stop_tokens in ((ref, ()), (ref_stop, stop)):
        got, lp, steps, paged, dense = run(8, stop_tokens)
        assert got == want
        assert steps and all(0 < n <= 8 for n in steps) and 8 in steps
        if not stop_tokens:
            np.testing.assert_allclose(lp, ref_lp, rtol=0, atol=1e-6)
        decodes = paged["paged_decode"]
        assert decodes >= cfg.n_layers * sum(steps)
        assert paged["paged_decode_sm90"] == decodes
        if precision is not None:
            assert dense["flash_decode"] == dense["flash_decode_sm90"] > 0
    assert ref_stop[2][-1] == stop[0] and len(ref_stop[2]) < len(ref[2])
