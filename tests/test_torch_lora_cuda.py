"""LoRA fine-tuning and serving, the token loader and checkpoint restore
on the card.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_lora_cuda.py

A 2-layer bf16 model at head_dim 128 (the kernels' width), adapters of
rank 8 on wq/wk/wv/wo:
- the LoRA loss and every adapter gradient on the card against the
  plain versions in float32 on the CPU over the same weights (loss within
  2e-3, each gradient's relative rms within 4e-2: the training gates of
  `chip_smoke.py`), with the forward, dQ and dK/dV kernels launched once
  a layer, all on the Hopper kernels, and no gradient on a base tensor;
- the engine with mixed ``lora_ids``: every chunk and decode step on the
  card held against the same step on float32 CPU copies of its inputs
  (relative rms within 2e-2, REF_REL_RMS of `chip_smoke.py`);
- `TokenLoader`'s batches through the pinned buffers and the side stream
  equal to the CPU loader's;
- `restore` onto CUDA tensors and a CUDA optimizer: a run saved after
  step 1 and resumed takes steps 2 and 3 bit for bit as the
  uninterrupted run on the card (the kernels use no atomics).
"""

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.models import llama, lora, serving
from metal_flash_attention_tpu_torch.models.engine import ServingEngine
from metal_flash_attention_tpu_torch.ops import flash_attention as fa
from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
from metal_flash_attention_tpu_torch.ops import paged_attention as pa
from metal_flash_attention_tpu_torch.utils import checkpoint, data
from metal_flash_attention_tpu_torch.utils.tree import flatten, tree_map

LOSS_ABS = 2e-3
GRAD_REL_RMS = 4e-2
LOGIT_REL_RMS = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the attention kernels have no CPU "
                    "mode on a CUDA tensor")
    return torch.device("cuda")


def _model(device):
    cfg = llama.LlamaConfig.tiny(n_layers=2, dim=512, n_heads=4,
                                 n_kv_heads=2)
    g = torch.Generator(device=device).manual_seed(0)
    params = llama.init_params(cfg, g, device=device)
    adapters = lora.init_lora_adapters(cfg, 4, 8, generator=g, b_scale=0.1,
                                       device=device)
    return cfg, params, adapters


def _rel_rms(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt().clamp_min(1e-30))


def _grads(cfg, params, adapters, tokens, ids):
    leaves, rebuild = flatten(adapters["layers"])
    work = [x.detach().requires_grad_(True) for x in leaves]
    loss = llama.loss_fn(params, tokens, cfg,
                         lora={"rank": adapters["rank"],
                               "layers": rebuild(work)}, lora_ids=ids)
    return loss.detach(), torch.autograd.grad(loss, work)


def test_lora_gradients_match_the_plain_versions(cuda):
    cfg, params, adapters = _model(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 257), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(1))
    ids = torch.tensor([1, 3], dtype=torch.int32, device=cuda)
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    loss, grads = _grads(cfg, params, adapters, tokens, ids)
    torch.cuda.synchronize()
    for counts, name in ((fa.LAUNCH_COUNTS, "flash_fwd"),
                         (fb.LAUNCH_COUNTS, "flash_bwd_dq"),
                         (fb.LAUNCH_COUNTS, "flash_bwd_dkv")):
        assert counts[name] == counts[f"{name}_sm90"] == cfg.n_layers, name
    assert all(p.grad is None and not p.requires_grad
               for p in flatten(params)[0])
    cpu32 = llama.LlamaConfig.tiny(n_layers=2, dim=512, n_heads=4,
                                   n_kv_heads=2, dtype=torch.float32)
    ref_loss, ref_grads = _grads(
        cpu32, tree_map(lambda t: t.float().cpu(), params),
        tree_map(lambda t: t.float().cpu() if torch.is_tensor(t) else t,
                 adapters), tokens.cpu(), ids.cpu())
    assert abs(float(loss) - float(ref_loss)) <= LOSS_ABS
    for g, r in zip(grads, ref_grads):
        if r.abs().max() > 0:
            assert _rel_rms(g, r) <= GRAD_REL_RMS
        # adapters 0 and 2 took no part
        assert not g[0].any() and not g[2].any()


def test_engine_steps_with_lora_ids_match_the_plain_versions(cuda,
                                                            monkeypatch):
    cfg, params, adapters = _model(cuda)
    cpu_cfg = llama.LlamaConfig.tiny(n_layers=2, dim=512, n_heads=4,
                                     n_kv_heads=2, dtype=torch.float32)
    to_cpu = lambda t: t.float().cpu() if torch.is_tensor(t) else t  # noqa
    cpu_params = tree_map(to_cpu, params)
    cpu_adapters = tree_map(to_cpu, adapters)
    errors = []

    def held(step):
        def run(p, tokens, c, cache, lora=None, lora_ids=None):
            plain_cache = cache._replace(
                k=tuple(to_cpu(x) for x in cache.k),
                v=tuple(to_cpu(x) for x in cache.v),
                page_table=cache.page_table.cpu(),
                lengths=cache.lengths.cpu())
            logits, out = step(p, tokens, c, cache, lora=lora,
                               lora_ids=lora_ids)
            want, _ = step(cpu_params, tokens.cpu(), cpu_cfg, plain_cache,
                           lora=cpu_adapters, lora_ids=lora_ids.cpu())
            errors.append(_rel_rms(logits, want))
            return logits, out
        return run
    for name in ("paged_chunk_step", "paged_decode_step"):
        monkeypatch.setattr(serving, name, held(getattr(serving, name)))
    eng = ServingEngine(params, cfg, max_batch=2, num_pages=24,
                        page_size=16, max_seq=128, lora=adapters)
    gen = np.random.default_rng(2)
    for n, lid in ((40, 1), (21, 3), (9, 0)):
        eng.submit(gen.integers(0, cfg.vocab_size, (n,)).astype(np.int32),
                   10, lora_id=lid)
    pa.reset_launch_counts()
    while not eng.idle:
        eng.step()
    assert len(errors) > 10 and max(errors) <= LOGIT_REL_RMS, max(errors)
    assert pa.LAUNCH_COUNTS["paged_decode"] == \
        pa.LAUNCH_COUNTS["paged_decode_sm90"] > 0
    assert pa.LAUNCH_COUNTS["paged_prefill"] == \
        pa.LAUNCH_COUNTS["paged_prefill_sm90"] > 0


def test_token_loader_prefetch_matches_the_cpu(cuda, tmp_path):
    paths = [str(tmp_path / "a.bin"), str(tmp_path / "b.bin")]
    rng = np.random.default_rng(3)
    data.write_shard(paths[0], rng.integers(0, 32000, 20000)
                     .astype(np.uint16))
    data.write_shard(paths[1], rng.integers(0, 32000, 9000)
                     .astype(np.int32))
    on_card = data.TokenLoader(paths, 4, 1023, seed=1, device=cuda)
    on_cpu = data.TokenLoader(paths, 4, 1023, seed=1, device="cpu")
    x = torch.randn((4096, 4096), device=cuda)
    for got, want in zip(on_card.take(6), on_cpu.take(6)):
        x = x @ x.T * 1e-4       # keep the stream busy under the copies
        assert got.device.type == "cuda" and got.dtype == torch.int32
        assert torch.equal(got.cpu(), want)
    assert on_card.state() == (1, 6)


def test_restore_onto_the_card_resumes_bit_for_bit(cuda, tmp_path):
    cfg, params, fresh = _model(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 129), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(4))
    ids = torch.tensor([1, 2], dtype=torch.int32, device=cuda)
    init_fn, step_fn = lora.make_lora_train_step(
        cfg, lambda ts: torch.optim.AdamW(ts, lr=1e-3))

    def copy(ad):
        return tree_map(lambda t: t.clone() if torch.is_tensor(t) else t, ad)
    whole = copy(fresh)
    state = init_fn(whole)
    losses = []
    for _ in range(3):
        whole, state, loss = step_fn(whole, state, params, tokens, ids)
        losses.append(loss)
    part = copy(fresh)
    s = init_fn(part)
    part, s, _ = step_fn(part, s, params, tokens, ids)
    # Saved from the card, restored onto fresh CUDA structures.
    checkpoint.save(str(tmp_path), {"adapters": part, "state": s}, step=1)
    again = copy(fresh)
    s2 = init_fn(again)
    out = checkpoint.restore(checkpoint.latest(str(tmp_path)),
                             {"adapters": again, "state": s2})
    again, s2 = out["adapters"], out["state"]
    entry = s2["opt"].state_dict()["state"][0]
    assert entry["exp_avg"].device.type == "cuda"
    for i in (1, 2):
        again, s2, loss = step_fn(again, s2, params, tokens, ids)
        assert torch.equal(loss, losses[i])
    assert again["rank"] == whole["rank"]
    for got, want in zip(flatten(again["layers"])[0],
                         flatten(whole["layers"])[0]):
        assert got.device.type == "cuda" and torch.equal(got, want)
