"""Rank bodies for the port's CPU tests of tensor- and context-parallel
serving (`tests/test_torch_parallel.py`, `tests/test_torch_serving_tp.py`).

`spawn` starts one process per rank with `torch.multiprocessing` (a gloo
group over a `FileStore` in the test's own directory, so xdist workers
never share a port), runs every case of a file in those ranks, and
returns each rank's results as numpy.  Spawned processes import this
module anew, so it imports no JAX; the inputs come from seeds
(`attention_inputs`, `paged_inputs`) or from the parent's pickle.
"""

from __future__ import annotations

import functools
import os
import pickle

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# The sharded-attention cases: (mesh axis sizes, input shapes).
FLASH_MESH = dict(data=2, heads=2, context=1)
FLASH_SHAPE = dict(b=2, h=4, hkv=2, n=128, d=64)
CP_MESH = dict(data=1, heads=2, context=2)
CP_SHAPE = dict(b=1, h=2, hkv=2, n=128, d=64)
DECODE_MESH = dict(data=1, heads=1, context=4)
DECODE_SHAPE = dict(b=2, h=4, s=256, d=64)
DECODE_LENS = (40, 200)           # row 0 lies on rank 0 alone
PAGED_SHAPE = dict(b=2, h=4, hkv=2, page=16, pages=24, d=128)
PAGED_LENS = (20, 150)            # row 0: two pages, so two ranks of 4
DTYPES = ("float32", "bfloat16")
ENGINE = dict(max_batch=2, num_pages=32, page_size=16, max_seq=128)


def attention_inputs(seed: int, b, h, hkv, n, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, n, d)).astype(np.float32),
            rng.standard_normal((b, hkv, n, d)).astype(np.float32),
            rng.standard_normal((b, hkv, n, d)).astype(np.float32))


def decode_inputs(seed: int, b, h, s, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, d)).astype(np.float32),
            rng.standard_normal((b, h, s, d)).astype(np.float32),
            rng.standard_normal((b, h, s, d)).astype(np.float32),
            np.asarray(DECODE_LENS, np.int32))


class PagedCache:
    """A global paged cache in numpy (the fields `shard_paged_cache_pages`
    reads)."""

    def __init__(self, k_pages, v_pages, page_table, lengths):
        self.k_pages, self.v_pages = k_pages, v_pages
        self.page_table, self.lengths = page_table, lengths


def paged_inputs(seed: int, b, h, hkv, page, pages, d):
    """q [b, h, d] and a cache whose table rows are a shuffle of the pages
    (page 0 unused)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((pages, hkv, page, d)).astype(np.float32)
    vp = rng.standard_normal((pages, hkv, page, d)).astype(np.float32)
    max_pages = (pages - 1) // b
    table = rng.permutation(np.arange(1, pages))[:b * max_pages].reshape(
        b, max_pages).astype(np.int32)
    return q, PagedCache(kp, vp, table, np.asarray(PAGED_LENS, np.int32))


def as_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.as_tensor(x).to(getattr(torch, dtype))


def as_numpy(x: torch.Tensor) -> np.ndarray:
    return x.detach().float().numpy()


def spawn(body, world: int, workdir: str, payload=None) -> list:
    """Run ``body(rank, world, payload)`` on ``world`` gloo ranks; returns
    each rank's result.  A rank that raises fails the call."""
    path = os.path.join(workdir, "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    mp.spawn(_rank_main, args=(body, world, workdir), nprocs=world,
             join=True)
    out = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(rank: int, body, world: int, workdir: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world)
    try:
        with open(os.path.join(workdir, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        result = body(rank, world, payload)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def _raises(fn) -> str:
    """The name of the exception ``fn()`` raises ('' if none)."""
    try:
        fn()
    except Exception as e:           # the test compares the type's name
        return type(e).__name__
    return ""


def _spec_trees(mesh) -> dict:
    from metal_flash_attention_tpu_torch.models import gemma, llama, moe

    return {
        "llama": llama.param_shardings(llama.LlamaConfig.tiny(), mesh),
        "llama_bias": llama.param_shardings(llama.LlamaConfig.tiny(), mesh,
                                            qkv_bias=True),
        "gemma": gemma.param_shardings(gemma.GemmaConfig.tiny(), mesh),
        "moe": moe.param_shardings(moe.MoEConfig.tiny(), mesh)}


def parallel_body(rank: int, world: int, payload) -> dict:
    """Every case of tests/test_torch_parallel.py on 4 ranks."""
    from metal_flash_attention_tpu_torch.parallel import (
        CONTEXT_AXIS,
        DATA_AXIS,
        HEAD_AXIS,
        P,
        context_parallel_attention,
        context_parallel_decode,
        context_parallel_paged_decode,
        make_mesh,
        shard,
        shard_paged_cache_pages,
        sharded_flash_attention,
        unshard,
    )

    out = {"raises": {
        "wrong_world": _raises(lambda: make_mesh(heads=2, devices="cpu")),
        "no_card": _raises(lambda: make_mesh(heads=4)),
        "bad_device": _raises(lambda: make_mesh(heads=4, devices="tpu")),
        "not_a_mesh": _raises(lambda: shard({}, {}, object()))}}
    flash_mesh = make_mesh(**FLASH_MESH, devices="cpu")
    cp_mesh = make_mesh(**CP_MESH, devices="cpu")
    ctx_mesh = make_mesh(**DECODE_MESH, devices="cpu")
    out["specs"] = {k: _plain_tree(v)
                    for k, v in _spec_trees(flash_mesh).items()}

    # shard / unshard round trips over a (2, 2, 1) mesh.
    rng = np.random.default_rng(0)
    tree = {"col": torch.as_tensor(rng.standard_normal((6, 8))),
            "row": torch.as_tensor(rng.standard_normal((8, 6))),
            "both": torch.as_tensor(rng.standard_normal((4, 8, 3))),
            "rep": [torch.as_tensor(rng.standard_normal((5,)))]}
    specs = {"col": P(None, HEAD_AXIS), "row": P(HEAD_AXIS, None),
             "both": P(DATA_AXIS, HEAD_AXIS), "rep": [P()]}
    blocks = shard(tree, specs, flash_mesh)
    out["blocks"] = {k: as_numpy(v) for k, v in blocks.items()
                     if k != "rep"}
    out["rep_is_whole"] = blocks["rep"][0] is tree["rep"][0]
    out["round_trip"] = {k: as_numpy(unshard(blocks[k], specs[k],
                                             flash_mesh))
                         for k in ("col", "row", "both")}
    out["bad_split"] = _raises(lambda: shard(
        {"w": torch.zeros((3, 3))}, {"w": P(HEAD_AXIS)}, flash_mesh))
    out["bad_tree"] = _raises(lambda: shard(
        {"w": torch.zeros((4,))}, {"v": P()}, flash_mesh))

    d_idx = flash_mesh.get_local_rank(DATA_AXIS)
    h_idx = flash_mesh.get_local_rank(HEAD_AXIS)
    c_idx = cp_mesh.get_local_rank(CONTEXT_AXIS)
    ch_idx = cp_mesh.get_local_rank(HEAD_AXIS)
    for dtype in DTYPES:
        q, k, v = (as_torch(x, dtype)
                   for x in attention_inputs(1, **FLASH_SHAPE))
        spec = P(DATA_AXIS, HEAD_AXIS)
        q, k, v = (shard(x, spec, flash_mesh) for x in (q, k, v))
        o = sharded_flash_attention(flash_mesh, causal=True)(q, k, v)
        out[f"flash_{dtype}"] = (d_idx, h_idx, as_numpy(o))

        q, k, v = (as_torch(x, dtype) for x in attention_inputs(2, **CP_SHAPE))
        q = shard(q, P(DATA_AXIS, HEAD_AXIS), cp_mesh)
        k, v = (shard(x, P(DATA_AXIS, HEAD_AXIS, CONTEXT_AXIS), cp_mesh)
                for x in (k, v))
        o = context_parallel_attention(cp_mesh)(q, k, v)
        out[f"cp_{dtype}"] = (ch_idx, c_idx, as_numpy(o))

        q, k, v, lens = decode_inputs(3, **DECODE_SHAPE)
        k, v = (shard(as_torch(x, dtype), P(None, None, CONTEXT_AXIS),
                      ctx_mesh) for x in (k, v))
        o = context_parallel_decode(ctx_mesh)(
            as_torch(q, dtype), k, v, torch.as_tensor(lens))
        out[f"decode_{dtype}"] = as_numpy(o)

        q, cache = paged_inputs(4, **PAGED_SHAPE)
        kst, vst, tbl, ln = shard_paged_cache_pages(cache, 4)
        cp = P(CONTEXT_AXIS)
        blocks = [shard(as_torch(kst, dtype), cp, ctx_mesh),
                  shard(as_torch(vst, dtype), cp, ctx_mesh),
                  shard(torch.as_tensor(tbl), cp, ctx_mesh),
                  shard(torch.as_tensor(ln), cp, ctx_mesh)]
        fn = context_parallel_paged_decode(ctx_mesh)
        out[f"paged_{dtype}"] = as_numpy(fn(as_torch(q, dtype), *blocks))
        out[f"paged_local_len_{dtype}"] = blocks[3].numpy()
    return out


def _plain_tree(tree):
    """Specs as plain tuples (picklable without the port)."""
    if isinstance(tree, dict):
        return {k: _plain_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_plain_tree(v) for v in tree]
    return tuple(tree)


def _engine_streams(params, cfg, prompts, family, mesh, kv_sharding,
                    burst: int, max_new: int, rounds: int = 1) -> list:
    from metal_flash_attention_tpu_torch.models import serving
    from metal_flash_attention_tpu_torch.models.engine import ServingEngine

    kw = {}
    if family == "gemma":
        kw = dict(chunk_step=functools.partial(
            serving.gemma_paged_chunk_step, mesh=mesh),
                  decode_step=functools.partial(
            serving.gemma_paged_decode_step, mesh=mesh))
    eng = ServingEngine(params, cfg, kv_sharding=kv_sharding,
                        prefix_cache=rounds > 1, **ENGINE, **kw)
    rids, calls, emitted = [], 0, []
    for _ in range(rounds):
        rids += [eng.submit(p, max_new) for p in prompts]
        while not eng.idle:
            emitted.append(eng.step_burst(burst) if burst else eng.step())
            calls += 1
            if calls > 200:
                raise RuntimeError("engine did not drain")
    # Every rank must have emitted the same tokens at every call.
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, emitted)
    if any(g != emitted for g in gathered):
        raise RuntimeError("ranks emitted different tokens")
    return [eng.result(r).tolist() for r in rids]


def serving_body(rank: int, world: int, payload) -> dict:
    """Every rank-side case of tests/test_torch_serving_tp.py on 2 ranks:
    ``payload`` holds each family's float32 parameters (numpy, from the
    JAX package), the step inputs and the engine prompts."""
    from metal_flash_attention_tpu_torch.models import (
        gemma,
        llama,
        moe,
        serving,
    )
    from metal_flash_attention_tpu_torch.models.engine import ServingEngine
    from metal_flash_attention_tpu_torch.parallel import (
        HEAD_AXIS,
        NamedSharding,
        P,
        make_mesh,
        shard,
    )
    from metal_flash_attention_tpu_torch.utils.params import (
        params_from_numpy,
    )

    mesh = make_mesh(heads=world, devices="cpu")
    kv = NamedSharding(mesh, P(None, HEAD_AXIS, None, None))
    f32 = torch.float32
    cfgs = {"llama": llama.LlamaConfig.tiny(n_layers=2, dtype=f32),
            "gemma": gemma.GemmaConfig.tiny(**payload["gemma_kw"], dtype=f32),
            "moe": moe.MoEConfig.tiny(n_layers=2, dtype=f32)}
    specs = {"llama": llama.param_shardings, "gemma": gemma.param_shardings,
             "moe": moe.param_shardings}
    out = {"steps": {}, "streams": {}}
    for family, cfg in cfgs.items():
        full = params_from_numpy(payload["params"][family], dtype=f32,
                                 device="cpu")
        local = shard(full, specs[family](cfg, mesh), mesh)
        if family != "moe":
            out["steps"][family] = _tp_steps(local, cfg, family, mesh,
                                             payload["step_prompt"])
        for burst in (0, 4):
            out["streams"][family, burst] = _engine_streams(
                local, cfg, payload["prompts"], family, mesh, kv, burst,
                payload["max_new"])
    # The prefix cache: the same prompts twice, the second time from the
    # first's cached pages.
    out["prefix"] = _engine_streams(
        shard(params_from_numpy(payload["params"]["llama"], dtype=f32,
                                device="cpu"),
              llama.param_shardings(cfgs["llama"], mesh), mesh),
        cfgs["llama"], payload["prompts"], "llama", mesh, kv, 0,
        payload["max_new"], rounds=2)

    # What a mesh does not divide, and what is not a mesh.
    lcfg = cfgs["llama"]
    odd = llama.LlamaConfig.tiny(n_layers=1, n_kv_heads=1, dtype=f32)
    cache = serving.init_paged_model_cache(odd, 1, 16, page_size=16,
                                           device="cpu")
    tok = torch.zeros((1,), dtype=torch.int32)
    moe3 = moe.MoEConfig.tiny(n_experts=3, dtype=f32)
    full = params_from_numpy(payload["params"]["llama"], dtype=f32,
                             device="cpu")
    out["raises"] = {
        "kv_heads": _raises(lambda: serving.paged_decode_step(
            {"layers": []}, tok, odd, cache, mesh=mesh)),
        "engine_kv_heads": _raises(lambda: ServingEngine(
            full, odd, kv_sharding=kv, **ENGINE)),
        "experts": _raises(lambda: moe.moe_ffn(
            {"w_router": torch.zeros((moe3.dim, 3))},
            torch.zeros((1, 2, moe3.dim)), moe3, mesh=mesh)),
        "kv_spec": _raises(lambda: ServingEngine(
            full, lcfg, kv_sharding=NamedSharding(mesh, P()), **ENGINE)),
        "kv_object": _raises(lambda: ServingEngine(
            full, lcfg, kv_sharding=object(), **ENGINE)),
        "step_object": _raises(lambda: serving.paged_decode_step(
            full, tok, lcfg, cache, mesh=object()))}
    return out


def _tp_steps(params, cfg, family, mesh, prompt) -> tuple:
    """A chunk step over the prompt [b, 32] and one decode step of its
    argmax tokens, both at tp: (chunk logits of the last position,
    decode logits)."""
    from metal_flash_attention_tpu_torch.models import serving

    chunk, decode = ((serving.gemma_paged_chunk_step,
                      serving.gemma_paged_decode_step) if family == "gemma"
                     else (serving.paged_chunk_step,
                           serving.paged_decode_step))
    from metal_flash_attention_tpu_torch.parallel import HEAD_AXIS, P, shard

    cache = serving.init_paged_model_cache(
        cfg, prompt.shape[0], 64, page_size=16, device="cpu")
    pools = [P(None, HEAD_AXIS)] * cfg.n_layers
    cache = cache._replace(k=shard(cache.k, pools, mesh),
                           v=shard(cache.v, pools, mesh))
    logits, cache = chunk(params, torch.as_tensor(prompt), cfg, cache,
                          mesh=mesh)
    tok = logits[:, -1].argmax(-1).to(torch.int32)
    logits2, _ = decode(params, tok, cfg, cache, mesh=mesh)
    return as_numpy(logits[:, -1]), as_numpy(logits2)


# Data- and head-parallel training (tests/test_torch_train_tp.py): the
# dry runs' mesh and configurations (JAX `__graft_entry__.py`: the
# dp x tp leg's Llama and the EP leg's MoE, Gemma-2 at the same mesh).
TRAIN_MESH = dict(data=2, heads=2, context=1)
# A power of two large enough that the step's update, lr x the gradient,
# outweighs the parameter: new - old then reads the gradient in bf16 too
# (a smaller update vanishes under the parameter's last bit).
TRAIN_LR = 1024.0
TRAIN_CASES = {f"{family}_{dtype}": (family, dtype)
               for family in ("llama", "gemma", "moe")
               for dtype in DTYPES}
# Slots under 0.5 x the mean load, so that experts overflow on the
# global token set (the JAX package's capacity).
MOE_OVERFLOW_FACTOR = 0.5
LOADER = dict(batch=4, seq_len=20, seed=3, steps=3)
COLLECTIVE_SEED = 7


def collective_inputs():
    """(a [2, 4], c [2, 4], w [3, 8], u [3, 4], x [3, 4]) float64: each
    heads rank's column factor a_h and row factor c_h, the loss weights
    of the gathered columns and of the sum, and x."""
    rng = np.random.default_rng(COLLECTIVE_SEED)
    return tuple(rng.standard_normal(s) for s in
                 ((2, 4), (2, 4), (3, 8), (3, 4), (3, 4)))


def train_configs(family: str, dtype: str):
    """The port's config of a training case (the JAX test builds the same
    from the JAX package)."""
    from metal_flash_attention_tpu_torch.models import gemma, llama, moe

    dt = getattr(torch, dtype)
    if family == "llama":
        return llama.LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2,
                                      dtype=dt)
    if family == "gemma":
        return gemma.GemmaConfig.tiny(dtype=dt)
    factor = MOE_OVERFLOW_FACTOR if dtype == "float32" else 1.25
    return moe.MoEConfig.tiny(n_heads=4, n_kv_heads=2, n_experts=4,
                              capacity_factor=factor, dtype=dt)


def _replayed_top_k(choices, lo: int, margins: list):
    """A `moe._top_k` that takes the next layer's JAX choices (rows lo..
    of the global tokens, this rank's) with the port's own gates at
    them, and notes in ``margins`` how far each of the port's own
    differing choices lies above the one taken."""
    from metal_flash_attention_tpu_torch.models import moe

    layers = iter(choices)
    real = moe._top_k

    def top_k(gates, k):
        own = real(gates, k)[1]
        topi = torch.as_tensor(next(layers))[lo:lo + gates.shape[0]].long()
        diff = own != topi
        margins.extend((gates.gather(1, own) - gates.gather(1, topi))[
            diff].tolist())
        topw = gates.gather(1, topi)
        return topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9), topi
    return top_k


def train_tp_body(rank: int, world: int, payload) -> dict:
    """Every rank-side case of tests/test_torch_train_tp.py on 4 ranks
    (dp 2 x tp 2): ``payload`` holds each case's float32 parameters and
    tokens (numpy, from the JAX package) and, for the bf16 MoE case,
    JAX's expert choices a layer."""
    from unittest import mock

    from metal_flash_attention_tpu_torch.models import (
        gemma,
        llama,
        moe,
        optim,
    )
    from metal_flash_attention_tpu_torch.parallel import (
        DATA_AXIS,
        HEAD_AXIS,
        NamedSharding,
        P,
        make_mesh,
        shard,
    )
    from metal_flash_attention_tpu_torch.parallel.mesh import (
        column_parallel_input,
        gather_columns,
        row_parallel_sum,
    )
    from metal_flash_attention_tpu_torch.utils.data import TokenLoader
    from metal_flash_attention_tpu_torch.utils.params import (
        params_from_numpy,
        params_to_numpy,
    )
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    mesh = make_mesh(**TRAIN_MESH, devices="cpu")
    d_idx = mesh.get_local_rank(DATA_AXIS)
    h_idx = mesh.get_local_rank(HEAD_AXIS)
    modules = {"llama": llama, "gemma": gemma, "moe": moe}
    out = {"index": (d_idx, h_idx), "cases": {}}

    def local_inputs(case, cfg, dtype):
        module = modules[TRAIN_CASES[case][0]]
        full = params_from_numpy(payload["params"][case],
                                 dtype=getattr(torch, dtype), device="cpu")
        specs = module.param_shardings(cfg, mesh)
        tokens = shard(torch.as_tensor(payload["tokens"][case]),
                       P(DATA_AXIS, None), mesh)
        return module, shard(full, specs, mesh), specs, tokens

    for case, (family, dtype) in TRAIN_CASES.items():
        cfg = train_configs(family, dtype)
        module, local, specs, tokens = local_inputs(case, cfg, dtype)
        margins = []
        top_k = moe._top_k
        if case in payload["choices"]:
            top_k = _replayed_top_k(payload["choices"][case],
                                    d_idx * tokens.shape[0]
                                    * (tokens.shape[1] - 1), margins)
        old, rebuild = flatten(local)
        with mock.patch.object(moe, "_top_k", top_k):
            new, loss = module.train_step(local, tokens, cfg, lr=TRAIN_LR,
                                          mesh=mesh)
        update = rebuild([(n.float() - o.float()).numpy()
                          for n, o in zip(flatten(new)[0], old)])
        out["cases"][case] = {"loss": float(loss), "update": update,
                              "specs": _plain_tree(specs),
                              "margins": margins}

    # make_train_step (AdamW with float32 shadows) over the mesh loss.
    cfg = train_configs("llama", "float32")
    _, local, _, tokens = local_inputs("llama_float32", cfg, "float32")
    init_fn, step_fn = optim.make_train_step(
        lambda p, b: llama.loss_fn(p, b, cfg, mesh=mesh))
    state = init_fn(local)
    new, state, loss = step_fn(local, state, tokens)
    out["adamw"] = {"loss": float(loss), "blocks": params_to_numpy(new)}

    # The collectives' gradients (COLLECTIVE_SEED): x whole on the heads
    # axis enters this rank's column block a_h x, gathered whole, and its
    # row-parallel partial c_h x, summed over the ranks.
    a, c, w, u, x = collective_inputs()
    x = torch.as_tensor(x).requires_grad_(True)
    z = column_parallel_input(x, mesh)
    whole = gather_columns(z * torch.as_tensor(a[h_idx]), mesh)
    total = row_parallel_sum(z * torch.as_tensor(c[h_idx]), mesh)
    ((whole * torch.as_tensor(w)).sum()
     + (total * torch.as_tensor(u)).sum()).backward()
    out["collective_grad"] = x.grad.numpy()

    # TokenLoader(sharding=): this rank's block of every batch, and a
    # resume from the state after one batch.
    sharding = NamedSharding(mesh, P(DATA_AXIS, None))
    shards = payload["loader_shards"]
    kw = dict(device="cpu", sharding=sharding)
    loader = TokenLoader(shards, LOADER["batch"], LOADER["seq_len"],
                         seed=LOADER["seed"], **kw)
    blocks = [t.numpy() for t in loader.take(1)]
    resumed = TokenLoader.from_state(shards, LOADER["batch"],
                                     LOADER["seq_len"], loader.state(), **kw)
    blocks += [t.numpy() for t in resumed.take(LOADER["steps"] - 1)]
    out["loader"] = blocks

    # The context axis in training (Llama's ring, Gemma's whole
    # sequence) against the loss without a mesh, a windowed Llama on it,
    # and shardings that are not ones.
    cp_mesh = make_mesh(data=1, heads=2, context=2, devices="cpu")
    out["context_loss"] = {}
    for family, module, gcfg in (
            ("llama", llama, cfg),
            ("gemma", gemma, train_configs("gemma", "float32"))):
        full = params_from_numpy(payload["params"][f"{family}_float32"],
                                 dtype=torch.float32, device="cpu")
        toks = torch.as_tensor(payload["tokens"][f"{family}_float32"])
        cp_local = shard(full, module.param_shardings(gcfg, cp_mesh),
                         cp_mesh)
        out["context_loss"][family] = (
            module.loss_fn(cp_local, toks, gcfg, mesh=cp_mesh).item(),
            module.loss_fn(full, toks, gcfg).item())
    windowed = llama.LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2,
                                      sliding_window=32, dtype=torch.float32)
    full_tokens = torch.as_tensor(payload["tokens"]["llama_float32"])
    cp_local = shard(params_from_numpy(payload["params"]["llama_float32"],
                                       dtype=torch.float32, device="cpu"),
                     llama.param_shardings(windowed, cp_mesh), cp_mesh)
    out["raises"] = {
        "context_window": _raises_message(lambda: llama.loss_fn(
            cp_local, full_tokens, windowed, mesh=cp_mesh)),
        "loader_object": _raises(lambda: TokenLoader(
            shards, LOADER["batch"], LOADER["seq_len"], device="cpu",
            sharding=object())),
        "loader_split": _raises(lambda: TokenLoader(
            shards, 3, LOADER["seq_len"], device="cpu", sharding=sharding)),
        "mesh_object": _raises(lambda: llama.loss_fn(
            cp_local, full_tokens, cfg, mesh=object()))}
    return out


def _raises_message(fn) -> tuple:
    """(the exception's type name, its message), ('', '') if none."""
    try:
        fn()
    except Exception as e:           # the test compares name and message
        return type(e).__name__, str(e)
    return "", ""


# Ring and zigzag attention, the context axis in training and the
# pipeline (tests/test_torch_ring_attention.py), on 4 ranks.
RING_SHAPE = dict(b=1, h=2, hkv=2, n=128, d=32)
RING_CASES = {"causal": (True, 2), "full": (False, 2), "gqa": (True, 1)}
CP_TRAIN_MESH = dict(data=1, heads=2, context=2)
CP_TOKENS = (2, 257)
CONTEXT_FAMILIES = ("gemma", "moe")
PIPE_MLP = {"s4_m8": dict(stages=4, micro=8, d=16, h=32, mb=4),
            "s2_m3": dict(stages=2, micro=3, d=16, h=32, mb=4),
            "grads": dict(stages=4, micro=4, d=8, h=16, mb=2)}
PIPE_LLAMA = dict(stages=4, micro=4, b=2, s=64)


def ring_inputs(name: str):
    """q, k, v and dO (float32) of a ring case."""
    causal, hkv = RING_CASES[name]
    q, k, v = attention_inputs(20 + hkv, **dict(RING_SHAPE, hkv=hkv))
    do = np.random.default_rng(30 + hkv).standard_normal(q.shape).astype(
        np.float32)
    return q, k, v, do


def mlp_stage(params, x):
    """tests/test_pipeline.py's stage (the JAX test's `mlp_stage`)."""
    h = torch.tanh(x @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def mlp_stages(case: str):
    """The stacked stage parameters and the microbatches of a pipeline
    case, float32 numpy (the JAX test's `make_stages` draws)."""
    c = PIPE_MLP[case]
    rng = np.random.default_rng(40 + c["stages"] + c["micro"])
    stages = []
    for _ in range(c["stages"]):
        stages.append({
            "w1": rng.standard_normal((c["d"], c["h"])) * 0.3,
            "b1": rng.standard_normal((c["h"],)) * 0.1,
            "w2": rng.standard_normal((c["h"], c["d"])) * 0.3,
            "b2": rng.standard_normal((c["d"],)) * 0.1})
    stacked = {k: np.stack([s[k] for s in stages]).astype(np.float32)
               for k in stages[0]}
    x = rng.standard_normal((c["micro"], c["mb"], c["d"])).astype(
        np.float32)
    return stacked, x


def _ring_results(fn, inputs, spec, mesh, order=None) -> dict:
    """A ring callable's (o, lse) and the gradients of sum(o * dO) on
    this rank's blocks of ``inputs`` (in ``order``: zigzag_shard first)."""
    from metal_flash_attention_tpu_torch.parallel import shard

    q, k, v, do = (torch.as_tensor(order(x) if order else x)
                   for x in inputs)
    leaves = [shard(x, spec, mesh).requires_grad_(True) for x in (q, k, v)]
    o, lse = fn(*leaves)
    (o * shard(do, spec, mesh)).sum().backward()
    return {"o": as_numpy(o), "lse": as_numpy(lse),
            **{n: as_numpy(x.grad) for n, x in zip(("dq", "dk", "dv"),
                                                   leaves)}}


def _update(new, old) -> object:
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    _, rebuild = flatten(old)
    return rebuild([(n.float() - o.float()).numpy()
                    for n, o in zip(flatten(new)[0], flatten(old)[0])])


def ring_body(rank: int, world: int, payload) -> dict:
    """Every rank-side case of tests/test_torch_ring_attention.py on 4
    ranks: ``payload`` holds the training cases' float32 parameters and
    tokens (numpy, from the JAX package)."""
    from torch.distributed.device_mesh import init_device_mesh

    from metal_flash_attention_tpu_torch.models import gemma, llama, moe
    from metal_flash_attention_tpu_torch.parallel import (
        CONTEXT_AXIS,
        HEAD_AXIS,
        P,
        make_mesh,
        make_pipeline_mesh,
        pipeline,
        ring_attention,
        shard,
        stack_stage_params,
        stage_param_sharding,
        zigzag_ring_attention,
        zigzag_shard,
        zigzag_unshard,
    )
    from metal_flash_attention_tpu_torch.utils.params import (
        params_from_numpy,
    )

    ring = make_mesh(context=world, devices="cpu")
    out = {"context_index": ring.get_local_rank(CONTEXT_AXIS), "ring": {}}
    spec = P(None, None, CONTEXT_AXIS)
    for name, (causal, _) in RING_CASES.items():
        fn = ring_attention(ring, causal=causal, return_residuals=True)
        out["ring"][name] = _ring_results(fn, ring_inputs(name), spec, ring)
    out["zigzag"] = _ring_results(
        zigzag_ring_attention(ring, return_residuals=True),
        ring_inputs("causal"), spec, ring,
        order=lambda x: zigzag_shard(torch.as_tensor(x), world))
    seq = torch.arange(2 * 3 * 64 * 5, dtype=torch.float32).reshape(
        2, 3, 64, 5)
    out["zigzag_order"] = (zigzag_shard(seq, world).numpy(),
                           bool(torch.equal(zigzag_unshard(
                               zigzag_shard(seq, world), world), seq)))

    # The dry run's dp x tp x cp leg, one SGD step a dtype.
    mesh = make_mesh(**CP_TRAIN_MESH, devices="cpu")
    out["cp_index"] = (mesh.get_local_rank(HEAD_AXIS),
                       mesh.get_local_rank(CONTEXT_AXIS))
    out["cp_train"] = {}
    tokens = torch.as_tensor(payload["tokens"]["llama"])
    for dtype in DTYPES:
        cfg = llama.LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2,
                                     dtype=getattr(torch, dtype))
        full = params_from_numpy(payload["params"]["llama"],
                                 dtype=getattr(torch, dtype), device="cpu")
        local = shard(full, llama.param_shardings(cfg, mesh), mesh)
        new, loss = llama.train_step(local, tokens, cfg, lr=TRAIN_LR,
                                     mesh=mesh)
        out["cp_train"][dtype] = {"loss": float(loss),
                                  "update": _update(new, local)}
    out["cp_specs"] = _plain_tree(llama.param_shardings(cfg, mesh))

    # Gemma and MoE leave the sequence whole over the context axis: one
    # step on the mesh against the same step without one.
    out["families"] = {}
    for family in CONTEXT_FAMILIES:
        module = {"gemma": gemma, "moe": moe}[family]
        cfg = train_configs(family, "float32")
        full = params_from_numpy(payload["params"][family],
                                 dtype=torch.float32, device="cpu")
        t = torch.as_tensor(payload["tokens"][family])
        local = shard(full, module.param_shardings(cfg, mesh), mesh)
        new, loss = module.train_step(local, t, cfg, lr=TRAIN_LR, mesh=mesh)
        ref_new, ref_loss = module.train_step(full, t, cfg, lr=TRAIN_LR)
        out["families"][family] = {
            "loss": float(loss), "ref_loss": float(ref_loss),
            "update": _update(new, local),
            "ref_update": _update(shard(ref_new, module.param_shardings(
                cfg, mesh), mesh), local)}
    windowed = llama.LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=2,
                                      sliding_window=16, dtype=torch.float32)
    out["window_raises"] = _raises_message(lambda: llama.loss_fn(
        shard(params_from_numpy(payload["params"]["llama"],
                                dtype=torch.float32, device="cpu"),
              llama.param_shardings(windowed, mesh), mesh),
        tokens, windowed, mesh=mesh))

    # The pipeline: the MLP stages, their gradients, and the dry run's PP
    # leg (Llama layers, one a stage).
    pmesh = make_pipeline_mesh(world, devices="cpu")
    pairs = init_device_mesh("cpu", (2, 2),
                             mesh_dim_names=("replica", "stage"))
    out["stage"] = pmesh.get_local_rank("stage")
    out["pipe"] = {}
    for case, c in PIPE_MLP.items():
        stacked, x = mlp_stages(case)
        stacked = {k: torch.as_tensor(v) for k, v in stacked.items()}
        m = pmesh if c["stages"] == world else pairs
        stage = m.get_local_rank("stage")
        local = {k: v[stage:stage + 1].clone().requires_grad_(True)
                 for k, v in stacked.items()}
        y = pipeline(mlp_stage, local, torch.as_tensor(x), mesh=m)
        res = {"out": as_numpy(y)}
        if case == "grads":
            (y ** 2).sum().backward()
            res["grads"] = {k: as_numpy(v.grad) for k, v in local.items()}
        out["pipe"][case] = res
    cfg = llama.LlamaConfig.tiny(n_layers=world, dtype=torch.float32)
    layers = params_from_numpy(payload["params"]["pp"],
                               dtype=torch.float32, device="cpu")
    stacked = stack_stage_params(layers)
    local = shard(stacked, stage_param_sharding(stacked, pmesh), pmesh)
    local = {k: v.requires_grad_(True) for k, v in local.items()}
    b, s = PIPE_LLAMA["b"], PIPE_LLAMA["s"]
    cos, sin = llama.rope_frequencies(cfg, torch.arange(s).expand(b, s))

    def stage_fn(layer, h):
        h, _ = llama.attention_block(layer, h, cfg, cos, sin)
        return llama.mlp_block(layer, h, cfg)
    y = pipeline(stage_fn, local, torch.as_tensor(payload["pp_x"]),
                 mesh=pmesh)
    loss = (y ** 2).mean()
    loss.backward()
    out["pp"] = {"loss": loss.item(),
                 "grads": {k: as_numpy(v.grad) for k, v in local.items()}}
    return out



def dryrun_body(rank: int, world: int, payload) -> dict:
    """The port's dry run (`entry._dryrun_rank`, the three legs) on
    ``world`` ranks, fed the JAX dry run's weights and PP input from
    ``payload`` (numpy): each rank's printed text and losses."""
    import contextlib
    import io

    from metal_flash_attention_tpu_torch import entry
    from metal_flash_attention_tpu_torch.utils.params import (
        params_from_numpy,
    )

    weights = {
        "mesh": params_from_numpy(payload["mesh"], device="cpu"),
        "ep": params_from_numpy(payload["ep"], device="cpu"),
        "pp": (params_from_numpy(payload["pp"], device="cpu",
                                 dtype=torch.float32),
               torch.as_tensor(payload["pp_x"]))}
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        losses = entry._dryrun_rank(world, "cpu", weights)
    return {"stdout": text.getvalue(), "losses": losses}


# The parallelism guide's examples (tests/test_torch_docs_examples.py):
# mesh and ring attention, head-parallel attention, and the pipeline.
DOCS_WORLD = 8
DOCS_RING_SHAPE = (1, 2, 512, 64)
DOCS_SHARDED_SHAPE = (2, 4, 256, 64)
DOCS_STAGES = 4
DOCS_PIPE = dict(width=16, micro=8, mb=2)


def docs_inputs() -> dict:
    """The examples' inputs, float32 numpy from one seed (the guide
    draws them with jax.random; both packages take these instead)."""
    rng = np.random.default_rng(0)
    ring = [rng.standard_normal(DOCS_RING_SHAPE).astype(np.float32)
            for _ in range(3)]
    sharded = [rng.standard_normal(DOCS_SHARDED_SHAPE).astype(np.float32)
               for _ in range(3)]
    w = DOCS_PIPE["width"]
    stages = [(rng.standard_normal((w, w)) * 0.1).astype(np.float32)
              for _ in range(DOCS_STAGES)]
    xs = rng.standard_normal((DOCS_PIPE["micro"], DOCS_PIPE["mb"],
                              w)).astype(np.float32)
    return {"ring": ring, "sharded": sharded, "stages": stages, "xs": xs}


def docs_body(rank: int, world: int, payload) -> dict:
    """The guide's two eight-device examples through the port on 8 ranks:
    ring attention at data 1 x heads 2 x context 4 and head-parallel
    attention at data 2 x heads 4 (bf16, each o gathered whole), and the
    4-stage pipeline on a (replica 2, stage 4) mesh of the 8 ranks (the
    port's `make_pipeline_mesh` takes a group of exactly its stages)."""
    from torch.distributed.device_mesh import init_device_mesh

    from metal_flash_attention_tpu_torch.parallel import (
        CONTEXT_AXIS,
        DATA_AXIS,
        HEAD_AXIS,
        STAGE_AXIS,
        P,
        make_mesh,
        pipeline,
        ring_attention,
        shard,
        sharded_flash_attention,
        stack_stage_params,
        unshard,
    )

    inputs = docs_inputs()
    mesh = make_mesh(data=1, heads=2, context=4, devices="cpu")
    spec = P(DATA_AXIS, HEAD_AXIS, CONTEXT_AXIS)
    q, k, v = (shard(as_torch(x, "bfloat16"), spec, mesh)
               for x in inputs["ring"])
    o = ring_attention(mesh, causal=True)(q, k, v)
    out = {"ring": as_numpy(unshard(o, spec, mesh))}

    mesh2 = make_mesh(data=2, heads=4, devices="cpu")
    spec2 = P(DATA_AXIS, HEAD_AXIS)
    q2, k2, v2 = (shard(as_torch(x, "bfloat16"), spec2, mesh2)
                  for x in inputs["sharded"])
    o2 = sharded_flash_attention(mesh2, causal=True)(q2, k2, v2)
    out["sharded"] = as_numpy(unshard(o2, spec2, mesh2))

    pmesh = init_device_mesh("cpu", (world // DOCS_STAGES, DOCS_STAGES),
                             mesh_dim_names=("replica", STAGE_AXIS))
    stage = pmesh.get_local_rank(STAGE_AXIS)
    params = stack_stage_params([{"w": torch.as_tensor(w)}
                                 for w in inputs["stages"]])
    local = {name: x[stage:stage + 1] for name, x in params.items()}

    def stage_fn(p, x):
        return torch.tanh(x @ p["w"])
    y = pipeline(stage_fn, local, torch.as_tensor(inputs["xs"]), mesh=pmesh)
    out["pipeline"] = as_numpy(y)
    return out
