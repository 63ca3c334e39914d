"""The port's counterpart of the JAX package's `__graft_entry__.py`.

- `entry()` returns (fn, example_args): the forward step of the flagship
  Llama-style model at its test scale (`LlamaConfig.tiny(n_layers=2)`,
  bf16, seeded random weights) over a [2, 256] batch of token ids, on the
  card unless the caller passes ``device="cpu"``.  ``fn(params, tokens)``
  gives float32 logits [2, 256, vocab]; the parameters are a dict of
  tensors, so weights made elsewhere (`utils.params.params_from_numpy` of
  the JAX package's) drop in.
- `dryrun_multichip(n)` runs one training step of each parallel layout
  over n ranks, with JAX's shapes and printed lines: Llama on a data x
  heads x context mesh (ring attention on the context axis), the MoE on a
  data x experts mesh, and a GPipe pipeline of float32 Llama layers held
  against the sequential chain.

Departure from the JAX package: JAX's one process drives n devices.  Here
a rank is a process, so `dryrun_multichip` called from a plain process
starts its ranks itself (one process a rank over a `FileStore` in a
temporary directory: NCCL on the cards, gloo with ``device="cpu"``; n = 1
runs in the calling process), and called inside a process group of
exactly n ranks it runs on that group.  Its weights come from seeded
`torch.Generator`s (JAX's from `PRNGKey(0)`..`(3)`); the legs
(`_dryrun_mesh`, `_dryrun_expert_parallel`, `_dryrun_pipeline_parallel`)
also take weights given to them, which is how the tests feed them JAX's.
"""

from __future__ import annotations

import os
import shutil
import tempfile

import torch
import torch.distributed as dist

from metal_flash_attention_tpu_torch.models import llama, moe
from metal_flash_attention_tpu_torch.parallel import (
    DATA_AXIS,
    P,
    make_mesh,
    make_pipeline_mesh,
    pipeline,
    shard,
    stack_stage_params,
)
from metal_flash_attention_tpu_torch.parallel.mesh import axis_index
from metal_flash_attention_tpu_torch.parallel.pipeline import STAGE_AXIS
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.utils.tree import flatten, tree_map

# The PP leg: batch, sequence and microbatches (`__graft_entry__.py`
# :154-162), and the pipeline's closeness to the chain (:191-197).
PP_BATCH, PP_SEQ, PP_MICRO = 2, 64, 4
PP_LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PP_GRAD_TOL = dict(rtol=1e-3, atol=1e-5)


def entry(device=None):
    """(fn, (params, tokens)): the 2-layer tiny Llama forward and its
    example arguments, on ``device`` (None: the card)."""
    dev = resolve_device(device)
    cfg = llama.LlamaConfig.tiny(n_layers=2)
    params = llama.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                               device=dev)
    tokens = torch.zeros((2, 256), dtype=torch.int32, device=dev)

    def fn(params, tokens):
        logits, _ = llama.forward(params, tokens, cfg)
        return logits

    return fn, (params, tokens)


def mesh_split(n_devices: int) -> tuple:
    """(dp, tp, cp) of the dry run's first leg: heads 2 and context 2 where
    4 divides n, heads 2 where 2 does, else data alone."""
    if n_devices % 4 == 0:
        return n_devices // 4, 2, 2
    if n_devices % 2 == 0:
        return n_devices // 2, 2, 1
    return n_devices, 1, 1


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One training step of each leg over ``n_devices`` ranks; rank 0
    prints JAX's three lines.  ``device``: None (the cards, NCCL) or
    "cpu" (gloo)."""
    kind = resolve_device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"dryrun_multichip runs on cuda or cpu, got {kind}")
    if dist.is_available() and dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) inside a "
                             f"process group of {dist.get_world_size()} "
                             "ranks")
        _dryrun_rank(n_devices, kind)
        return
    if kind == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"dryrun_multichip({n_devices}) needs "
                           f"{n_devices} cards, found "
                           f"{torch.cuda.device_count()}")
    store = tempfile.mkdtemp(prefix="mfa_dryrun_")
    try:
        if n_devices == 1:
            _rank_main(0, 1, kind, store)
        else:
            import torch.multiprocessing as mp
            mp.spawn(_rank_main, args=(n_devices, kind, store),
                     nprocs=n_devices, join=True)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _rank_main(rank: int, world: int, kind: str, store: str) -> None:
    """One rank of a dry run started by `dryrun_multichip`."""
    if kind == "cuda":
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                            init_method="file://" + os.path.join(store,
                                                                 "store"),
                            rank=rank, world_size=world)
    try:
        _dryrun_rank(world, kind)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _rank_device(kind: str) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) \
        if kind == "cuda" else torch.device("cpu")


def _dryrun_rank(n_devices: int, kind: str, weights=None) -> dict:
    """The three legs on this rank of a group of ``n_devices``; returns
    their losses.  ``weights``: {"mesh": Llama params, "ep": MoE params,
    "pp": (per-layer params, x)}, whole, on this rank's device (None:
    drawn from the seeds)."""
    weights = weights or {}
    out = {"mesh": _dryrun_mesh(n_devices, kind, weights.get("mesh")),
           "ep": _dryrun_expert_parallel(n_devices, kind,
                                         weights.get("ep"))}
    out["pp"] = _dryrun_pipeline_parallel(n_devices, kind,
                                          *weights.get("pp", (None, None)))
    return out


def _say(text: str) -> None:
    if dist.get_rank() == 0:
        print(text, flush=True)


def _data_rows(tokens: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's data-axis rows of a global batch."""
    return shard([tokens], [P(DATA_AXIS, None)], mesh)[0]


def _dryrun_mesh(n_devices: int, kind: str, params=None) -> float:
    """The dp x tp x cp leg: `LlamaConfig.tiny(n_layers=2, n_heads=max(4,
    2 tp), n_kv_heads=tp)` (bf16) on zero tokens [max(2, dp), 128 cp + 1],
    one `train_step(mesh=)`; ``params`` whole (None: seed 0)."""
    dp, tp, cp = mesh_split(n_devices)
    dev = _rank_device(kind)
    mesh = make_mesh(data=dp, heads=tp, context=cp, devices=kind)
    cfg = llama.LlamaConfig.tiny(n_layers=2, n_heads=max(4, 2 * tp),
                                 n_kv_heads=tp)
    if params is None:
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    local = shard(params, llama.param_shardings(cfg, mesh), mesh)
    # train_step trims one token; the rest divides over the context axis.
    tokens = torch.zeros((max(2, dp), 128 * cp + 1), dtype=torch.int32,
                         device=dev)
    _, loss = llama.train_step(local, _data_rows(tokens, mesh), cfg,
                               mesh=mesh)
    loss = float(loss)
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"dp x tp x cp loss {loss}")
    _say(f"dryrun_multichip({n_devices}): mesh dp={dp} tp={tp} cp={cp}, "
         f"loss={loss:.4f}")
    return loss


def _dryrun_expert_parallel(n_devices: int, kind: str, params=None) -> float:
    """The EP leg: `MoEConfig.tiny(n_heads=2 ep, n_kv_heads=ep,
    n_experts=2 ep)` with its experts over the heads axis (ep 2 where 2
    divides n), on zero tokens [max(2, dp), 65]; ``params`` whole (None:
    seed 1)."""
    ep = 2 if n_devices % 2 == 0 else 1
    dp = n_devices // ep
    dev = _rank_device(kind)
    mesh = make_mesh(data=dp, heads=ep, devices=kind)
    cfg = moe.MoEConfig.tiny(n_heads=2 * ep, n_kv_heads=ep,
                             n_experts=2 * ep)
    if params is None:
        params = moe.init_params(
            cfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    local = shard(params, moe.param_shardings(cfg, mesh), mesh)
    tokens = torch.zeros((max(2, dp), 65), dtype=torch.int32, device=dev)
    _, loss = moe.train_step(local, _data_rows(tokens, mesh), cfg,
                             mesh=mesh)
    loss = float(loss)
    if not torch.isfinite(torch.tensor(loss)):
        raise AssertionError(f"ep loss {loss}")
    _say(f"  ep dryrun: mesh dp={dp} ep={ep}, loss={loss:.4f}")
    return loss


def _pipeline_mesh(n_devices: int, n_stages: int, kind: str):
    """The stage mesh over ranks [0, n_stages), as JAX pipelines its first
    n_stages devices; the other ranks sit the leg out (None)."""
    if n_devices == n_stages:
        return make_pipeline_mesh(n_stages, devices=kind)
    from torch.distributed.device_mesh import DeviceMesh

    mesh = DeviceMesh(kind, torch.arange(n_stages),
                      mesh_dim_names=(STAGE_AXIS,))
    return mesh if mesh.get_coordinate() is not None else None


def _dryrun_pipeline_parallel(n_devices: int, kind: str, layers=None,
                              x=None) -> tuple:
    """The PP leg: min(4, n) stages of float32 `LlamaConfig.tiny` layers,
    one a stage, b 2, s 64, 4 microbatches, loss mean(out^2), its loss
    and this stage's gradients held to the sequential chain's at JAX's
    rtol / atol.  ``layers``: the per-layer params, whole (None: seed 2);
    ``x`` [4, b, s, dim] (None: seed 3).  Returns (loss, chain's loss),
    or None on a rank outside the stage mesh."""
    n_stages = min(4, n_devices)
    dev = _rank_device(kind)
    cfg = llama.LlamaConfig.tiny(n_layers=n_stages, dtype=torch.float32)
    if layers is None:
        layers = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(2),
            device=dev)["layers"]
    if x is None:
        x = torch.randn((PP_MICRO, PP_BATCH, PP_SEQ, cfg.dim),
                        generator=torch.Generator(device=dev).manual_seed(3),
                        device=dev)
    pos = torch.arange(PP_SEQ, device=dev).expand(PP_BATCH, PP_SEQ)
    cos, sin = llama.rope_frequencies(cfg, pos)

    def stage_fn(layer, h):
        h, _ = llama.attention_block(layer, h, cfg, cos, sin)
        return llama.mlp_block(layer, h, cfg)

    mesh = _pipeline_mesh(n_devices, n_stages, kind)
    if mesh is None:
        return None
    stacked = stack_stage_params(layers)
    stage = axis_index(mesh, STAGE_AXIS)
    local = tree_map(lambda a: a[stage:stage + 1].clone().requires_grad_(
        True), stacked)
    loss = (pipeline(stage_fn, local, x, mesh=mesh) ** 2).mean()
    loss.backward()
    loss = loss.detach()

    # The same stacked model without the pipeline: each microbatch through
    # the stages in turn on this rank.
    whole = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                     stacked)
    y = torch.stack([_chain(stage_fn, whole, n_stages, xm) for xm in x])
    ref_loss = (y ** 2).mean()
    ref_loss.backward()
    ref_loss = ref_loss.detach()
    if not torch.isfinite(loss):
        raise AssertionError(f"pp loss {float(loss)}")
    if not torch.allclose(loss, ref_loss, **PP_LOSS_TOL):
        raise AssertionError(f"pp loss {float(loss)} != no-pp loss "
                             f"{float(ref_loss)}")
    for g, rg in zip(flatten(local)[0], flatten(whole)[0]):
        if not torch.allclose(g.grad, rg.grad[stage:stage + 1],
                              **PP_GRAD_TOL):
            raise AssertionError("pp grads diverge from the no-pp "
                                 "reference")
    _say(f"  pp dryrun: {n_stages} stages fwd+bwd, loss={float(loss):.6f} "
         f"== no-pp loss {float(ref_loss):.6f} (grads allclose)")
    return float(loss), float(ref_loss)


def _chain(stage_fn, stacked, n_stages: int, h: torch.Tensor):
    for i in range(n_stages):
        h = stage_fn(tree_map(lambda a: a[i], stacked), h)
    return h
