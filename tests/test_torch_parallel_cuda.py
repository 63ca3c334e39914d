"""Tensor- and context-parallel serving on two cards: the port's tp 2
paged steps and the four `parallel.sharded_attention` functions against
the single-card kernels; and data-, head- and expert-parallel training on
four cards against one card's step.

Each case needs two or more CUDA cards with sm_90a and nvcc; elsewhere
it skips with its reason.  The file imports neither JAX nor the JAX
package:

    python -m pytest --noconftest -q tests/test_torch_parallel_cuda.py

All cases run in ONE module-scoped spawn of two NCCL ranks (cards 0 and
1, a `FileStore` in the test's directory); rank 0 also runs the
single-card reference on its card.  Limits: the paged steps' float32
logits by relative rms error, LOGITS_REL_RMS (bf16 weights: the
row-parallel sums round each rank's partial to bf16 once more than one
card does); attention outputs by the worst 64-row tile's relative rms,
KERNEL_TILE_REL_RMS; every paged launch on its Hopper kernel, counted
exactly on each rank.

The training cases run in a second spawn, of four NCCL ranks (cards 0 to
3): one SGD step (lr TRAIN_LR: the update reads the gradient) of the JAX
dry runs' tiny configs at head
dim 32 in bf16 (Llama and Gemma-2 at data 2 x heads 2; MoE at heads 4,
2 experts a rank, on rank 0's one-card routes), each rank's loss and
its updated blocks gathered against rank 0's one-card `train_step` on
the same weights and global rows, by chip_smoke.py's training gates
(loss TRAIN_LOSS_ABS; the update's relative rms TRAIN_UPDATE_REL_RMS),
the flash counts exact and on the D 32 kernels.
"""

import os
import pickle

import pytest
import torch

from metal_flash_attention_tpu_torch.utils.tolerances import (
    KERNEL_TILE_REL_RMS,
    worst_tile_rel_rms,
)

TP = 2
LOGITS_REL_RMS = 2e-2
CFG = dict(vocab_size=1024, dim=1024, n_layers=2, n_heads=8, n_kv_heads=4,
           hidden_dim=2048)
PROMPT = (2, 256)
PAGE = 64
KV_LENS = (4096, 3000, 1500, 100)   # over two 2,048-position slices


def _rel_rms(got, ref) -> float:
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm())


def _steps(params, cfg, prompt, mesh, dev):
    from metal_flash_attention_tpu_torch.models import serving
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.parallel import HEAD_AXIS, P, shard

    cache = serving.init_paged_model_cache(cfg, prompt.shape[0], 512,
                                           page_size=PAGE, device=dev)
    if mesh is not None:
        pools = [P(None, HEAD_AXIS)] * cfg.n_layers
        cache = cache._replace(k=shard(cache.k, pools, mesh),
                               v=shard(cache.v, pools, mesh))
    pa.reset_launch_counts()
    logits, cache = serving.paged_chunk_step(params, prompt, cfg, cache,
                                             mesh=mesh)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    logits2, _ = serving.paged_decode_step(params, tok, cfg, cache,
                                           mesh=mesh)
    launches = {k: n for k, n in pa.LAUNCH_COUNTS.items() if n}
    return logits[:, -1].cpu(), logits2.cpu(), launches


def _attention(rank, dev):
    """Each sharded-attention function's output (rank 0: with the
    single-card kernel's beside it)."""
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.ops.flash_attention import (
        flash_attention_forward,
    )
    from metal_flash_attention_tpu_torch.ops.flash_decode import flash_decode
    from metal_flash_attention_tpu_torch.parallel import (
        CONTEXT_AXIS,
        HEAD_AXIS,
        P,
        context_parallel_attention,
        context_parallel_decode,
        context_parallel_paged_decode,
        make_mesh,
        shard,
        shard_paged_cache_pages,
        sharded_flash_attention,
    )

    heads, ctx = make_mesh(heads=TP), make_mesh(context=TP)
    gen = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    out = {}
    q, k, v = randn(1, 8, 1024, 128), randn(1, 4, 1024, 128), randn(
        1, 4, 1024, 128)
    blocks = [shard(x, P(None, HEAD_AXIS), heads) for x in (q, k, v)]
    o = sharded_flash_attention(heads, causal=True)(*blocks)
    out["sharded_flash_attention"] = (
        o.cpu(), flash_attention_forward(q, k, v, causal=True)[0][
            :, 4 * rank:4 * rank + 4].cpu())

    q, k, v = randn(1, 8, 256, 128), randn(1, 4, 4096, 128), randn(
        1, 4, 4096, 128)
    kl, vl = (shard(x, P(None, None, CONTEXT_AXIS), ctx) for x in (k, v))
    out["context_parallel_attention"] = (
        context_parallel_attention(ctx)(q, kl, vl).cpu(),
        flash_attention_forward(q, k, v)[0].cpu())

    lens = torch.tensor(KV_LENS, dtype=torch.int32, device=dev)
    q, k, v = randn(4, 8, 128), randn(4, 4, 4096, 128), randn(4, 4, 4096, 128)
    kl, vl = (shard(x, P(None, None, CONTEXT_AXIS), ctx) for x in (k, v))
    out["context_parallel_decode"] = (
        context_parallel_decode(ctx)(q, kl, vl, lens)[:, :, None].cpu(),
        flash_decode(q, k, v, kv_lens=lens)[:, :, None].cpu())
    # The shards of length 0 (rows 2 and 3 lie on rank 0 alone).
    local = (lens - rank * 2048).clamp(0, 2048).to(torch.int32)
    o0, lse0 = flash_decode(q, kl, vl, kv_lens=local, return_residuals=True)
    out["decode_empty_rows"] = [
        bool((o0[r] == 0).all() and torch.isneginf(lse0[r]).all())
        for r in (local == 0).nonzero().flatten().tolist()]

    pages = 4096 // PAGE

    def pool(x):
        p = x.new_zeros((4 * pages + 1, 4, PAGE, 128))
        p[1:] = x.view(4, 4, pages, PAGE, 128).transpose(1, 2).reshape(
            -1, 4, PAGE, 128)
        return p
    table = (1 + torch.arange(4 * pages, device=dev)).view(4, pages).to(
        torch.int32)
    cache = pa.PagedKVCache(pool(k), pool(v), table, lens)
    stacks = shard_paged_cache_pages(cache, TP)
    blocks = [shard(torch.as_tensor(x), P(CONTEXT_AXIS), ctx).to(dev)
              for x in stacks]
    pa.reset_launch_counts()
    o = context_parallel_paged_decode(ctx)(q, *blocks)
    out["paged_launches"] = {k: n for k, n in pa.LAUNCH_COUNTS.items() if n}
    out["context_parallel_paged_decode"] = (
        o[:, :, None].cpu(), pa.paged_decode(q, cache)[:, :, None].cpu())
    return out


def _rank(rank: int, workdir: str) -> None:
    import torch.distributed as dist
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.parallel import make_mesh, shard

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=TP)
    try:
        with torch.inference_mode():
            cfg = llama.LlamaConfig(**CFG)
            params = llama.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            prompt = torch.randint(0, cfg.vocab_size, PROMPT, device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(1))
            mesh = make_mesh(heads=TP)
            local = shard(params, llama.param_shardings(cfg, mesh), mesh)
            result = {"tp": _steps(local, cfg, prompt, mesh, dev),
                      "one_card": _steps(params, cfg, prompt, None, dev),
                      "attention": _attention(rank, dev)}
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if torch.cuda.device_count() < TP:
        pytest.skip(f"needs {TP} CUDA cards: the tensor-parallel kernels "
                    "run on one card each")
    import torch.multiprocessing as mp
    from metal_flash_attention_tpu_torch.native.build import (
        build_all,
        build_native,
    )
    build_all()
    build_native()
    workdir = str(tmp_path_factory.mktemp("tp_cuda"))
    mp.spawn(_rank, args=(workdir,), nprocs=TP, join=True)
    out = []
    for rank in range(TP):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def test_tp_paged_steps_match_one_card(ranks):
    """Both ranks' whole logits against the 1-card steps on the same
    weights; each rank ran one paged prefill and one paged decode a layer,
    on its Hopper kernels."""
    want = {f"{k}{s}": CFG["n_layers"] for k in ("paged_prefill",
                                                 "paged_decode")
            for s in ("", "_sm90")}
    for r in ranks:
        chunk, decode, launches = r["tp"]
        ref_chunk, ref_decode, _ = r["one_card"]
        assert launches == want
        assert _rel_rms(chunk, ref_chunk) <= LOGITS_REL_RMS
        assert _rel_rms(decode, ref_decode) <= LOGITS_REL_RMS
    assert torch.equal(ranks[0]["tp"][0], ranks[1]["tp"][0])


@pytest.mark.parametrize("name", ["sharded_flash_attention",
                                  "context_parallel_attention",
                                  "context_parallel_decode",
                                  "context_parallel_paged_decode"])
def test_sharded_attention_matches_one_card(ranks, name):
    for r in ranks:
        got, ref = r["attention"][name]
        assert worst_tile_rel_rms(got, ref) <= KERNEL_TILE_REL_RMS


def test_decode_shards_of_length_zero(ranks):
    """Rank 1 holds none of rows 2 and 3's tokens: o = 0 and lse = -inf
    there; the paged decode ran once a rank on its Hopper kernel."""
    assert ranks[1]["attention"]["decode_empty_rows"] == [True, True]
    for r in ranks:
        assert r["attention"]["paged_launches"] == {
            "paged_decode": 1, "paged_decode_sm90": 1}


# Training on four cards (the training cases' spawn).  TRAIN_LR, a power
# of two, makes each update so much larger than its parameter that
# rounding the new parameter to bf16 costs 2^-9 of the update, so the
# update reads the gradient (tests/test_torch_flash_cuda.py's rule).
TRAIN_WORLD = 4
TRAIN_LR = 1024.0
TRAIN_LOSS_ABS = 2e-3
TRAIN_UPDATE_REL_RMS = 4e-2


def _train_cases():
    from metal_flash_attention_tpu_torch.models import gemma, llama, moe
    return {
        "llama": (llama, llama.LlamaConfig.tiny(n_layers=2, n_heads=4,
                                                n_kv_heads=2),
                  dict(data=2, heads=2), (2, 129)),
        "gemma": (gemma, gemma.GemmaConfig.tiny(), dict(data=2, heads=2),
                  (2, 129)),
        "moe": (moe, moe.MoEConfig.tiny(dim=256, n_heads=8, n_kv_heads=4,
                                        n_experts=8),
                dict(data=1, heads=4), (1, 129))}


def _routes(taken=None, record=None):
    """`moe._top_k` recording its choices, or taking ``taken``'s."""
    import contextlib

    from metal_flash_attention_tpu_torch.models import moe

    real = moe._top_k

    @contextlib.contextmanager
    def patched():
        calls = iter(taken or ())

        def top_k(gates, k):
            topw, topi = real(gates, k)
            if taken is not None:
                topi = next(calls).to(gates.device)
                topw = gates.gather(1, topi)
                topw = topw / topw.sum(dim=-1, keepdim=True)
            if record is not None:
                record.append(topi.cpu())
            return topw, topi
        moe._top_k = top_k
        try:
            yield
        finally:
            moe._top_k = real
    return patched()


def _spec_leaves(tree, specs) -> list:
    """The leaves of ``specs`` in `flatten`'s order of ``tree``."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, s in zip(tree, specs) for x in _spec_leaves(t, s)]
    return [specs]


def _train_rank(rank: int, workdir: str) -> None:
    import torch.distributed as dist
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.parallel import (
        DATA_AXIS,
        P,
        make_mesh,
        shard,
        unshard,
    )
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=TRAIN_WORLD)
    result = {}
    try:
        for name, (module, cfg, shape, rows) in _train_cases().items():
            full = module.init_params(
                cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
            tokens = torch.randint(0, cfg.vocab_size, rows, device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(1))
            record, ref = [], None
            if rank == 0:
                with _routes(record=record):
                    ref = module.train_step(full, tokens, cfg, lr=TRAIN_LR)
            taken = [record] if rank == 0 else [None]
            dist.broadcast_object_list(taken, src=0)
            mesh = make_mesh(**shape)
            specs = module.param_shardings(cfg, mesh)
            local = shard(full, specs, mesh)
            fa.reset_launch_counts()
            fb.reset_launch_counts()
            with _routes(taken=taken[0] if name == "moe" else None):
                new, loss = module.train_step(
                    local, shard(tokens, P(DATA_AXIS, None), mesh), cfg,
                    lr=TRAIN_LR, mesh=mesh)
            torch.cuda.synchronize(dev)
            launches = {k: n for k, n in {**fa.LAUNCH_COUNTS,
                                          **fb.LAUNCH_COUNTS}.items() if n}
            whole = [unshard(x, s, mesh) for x, s in zip(
                flatten(new)[0], _spec_leaves(new, specs))]
            out = {"loss": float(loss), "launches": launches}
            if rank == 0:
                rel = []
                for got, want, old in zip(whole, flatten(ref[0])[0],
                                          flatten(full)[0]):
                    du = got.float() - old.float()
                    dr = want.float() - old.float()
                    rel.append(float((du - dr).norm() / dr.norm()))
                out.update(ref_loss=float(ref[1]), update_rel_rms=max(rel))
            result[name] = out
            del full, local, new, whole, ref
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"train_rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


@pytest.fixture(scope="module")
def train_ranks(tmp_path_factory):
    if torch.cuda.device_count() < TRAIN_WORLD:
        pytest.skip(f"needs {TRAIN_WORLD} CUDA cards: the training mesh "
                    "runs one rank a card")
    import torch.multiprocessing as mp
    from metal_flash_attention_tpu_torch.native.build import build_all
    build_all(["flash_attention", "flash_attention_bwd"])
    workdir = str(tmp_path_factory.mktemp("train_cuda"))
    mp.spawn(_train_rank, args=(workdir,), nprocs=TRAIN_WORLD, join=True)
    out = []
    for rank in range(TRAIN_WORLD):
        with open(os.path.join(workdir, f"train_rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.mark.parametrize("name", ["llama", "gemma", "moe"])
def test_mesh_train_step_matches_one_card(train_ranks, name):
    """Every rank's global loss is the same and within TRAIN_LOSS_ABS of
    one card's; the gathered updates within TRAIN_UPDATE_REL_RMS of one
    card's; the flash counts of the step exact, at D 32 (and with
    Gemma-2's cap)."""
    layers = 2
    suffixes = ("", "_sm90", "_d32") + (("_softcap",) if name == "gemma"
                                        else ())
    want = {f"{op}{s}": layers for op in ("flash_fwd", "flash_bwd_dq",
                                          "flash_bwd_dkv")
            for s in suffixes}
    losses = {r[name]["loss"] for r in train_ranks}
    assert len(losses) == 1, losses
    ref = train_ranks[0][name]
    assert abs(ref["loss"] - ref["ref_loss"]) <= TRAIN_LOSS_ABS
    assert ref["update_rel_rms"] <= TRAIN_UPDATE_REL_RMS
    for r in train_ranks:
        assert r[name]["launches"] == want
