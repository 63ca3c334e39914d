#!/usr/bin/env python3
"""Tensor- and context-parallel serving, and data-, head-, context- and
expert-parallel and pipelined training, of the PyTorch port on 4 cards.

Run from the root of a checkout, on one machine with four CUDA cards:

    python3 tools/tp_probe.py

It builds every kernel library once, then starts one NCCL rank per card
(`torch.multiprocessing.spawn`, a `FileStore` in a temporary directory)
and runs these phases, each printing its numbers with every card's name
and power limit:

1. tp_serve: Llama-3-8B at full width and depth (32 layers), tp 4 (8 q
   heads and 2 kv heads a rank).  Every rank draws the whole model from
   a torch.Generator seeded with SEED on its own card and keeps its
   blocks (`parallel.mesh.shard` under `llama.param_shardings`); rank 0
   first serves the 6 requests of chip_smoke.py's serve phase on its own
   card without a mesh (the 1-card engine), then every rank serves them
   through `ServingEngine` with ``kv_sharding`` and the mesh steps.
   Checks: the streams equal the 1-card streams, or part only at a
   near-tie (chip_smoke's tie gate, SPEC_TIE: where a row first departs,
   both tokens' logits in the 1-card engine's own step lie within
   SPEC_TIE of its top; the logits' relative rms error until then is
   printed); every rank emitted the same tokens at every step; each rank's
   paged launch counts exact and all on the Hopper kernels.  Printed:
   new tokens/s of both, each rank's peak memory, and one decode step of
   four live rows profiled on every rank (the NCCL kernels' share of the
   card's time).
2. gemma_tp_serve: gemma2_2b (26 layers), tp 4 (2 q heads and 1 kv head
   a rank, head_dim 256, the soft cap); the same checks.
3. moe_tp_serve: Mixtral-8x7B widths, experts 2 a rank, first at
   MOE_CUT_LAYERS layers against the 1-card engine (the tie gate; where
   it fails, the TP run again with the 1-card run's routes replayed, so
   that capacity couples a step's rows as it did on one card:
   chip_smoke's moe_routes; then the tie gate again, and each of its own
   routes that differs from the replayed one within MOE_TIE in the first
   chip_smoke.MOE_REF_LAYERS layers), then at all MOE_FULL_LAYERS layers,
   which no single card holds (each layer drawn whole, cut to its blocks
   and freed): new tokens/s, each rank's peak memory, and a decode step's
   card ms by family (the experts' products inside "moe_experts").
4. cp_checks: the four `parallel.sharded_attention` functions over 4
   ranks against the single-card kernel on card 0 at Llama-3-8B's
   attention widths (CP_* below), by the worst 64-row tile's relative
   rms error (KERNEL_TILE_REL_RMS), lse at MIXED_TOL where the function
   yields one; each call's ms (CUDA events, the slowest rank) beside the
   1-card kernel's; a planted fault (rank 1's partial dropped from the
   merge) that the limit must see; and on every rank the decode kernels'
   rows of local length 0 (o = 0, lse = -inf).

5. tp_train: Llama-3-8B at full depth (32 layers), data 2 x heads 2, one
   8,193-token row a data rank, SGD at TRAIN_LR (no remat).  Every rank
   draws the model whole from SEED and keeps its blocks; rank 0 keeps
   the whole 2-layer cut.  Checks: the mesh's 2-layer loss and gathered
   gradients (`unshard`) against rank 0's one-card `loss_fn` on the same
   weights and global rows, by chip_smoke's training gates
   (TRAIN_LOSS_ABS, TRAIN_GRAD_REL_RMS), and the same readings with
   TRAIN_FAULTS planted in the collectives' backward, which the gates must
   see; then TRAIN_STEPS `train_step(mesh=)`s: losses (the same on every
   rank, falling), seconds a step, tokens/s, each rank's blocks and peak
   memory, exact flash counts, and one more step profiled on every rank
   (NCCL's share of the card's time).
6. gemma_tp_train: `gemma2_2b` (26 layers), data 2 x heads 2; the same.
7. moe_tp_train: Mixtral-8x7B widths at MOE_TRAIN_LAYERS layers, heads 4
   (experts 2 a rank), one 8,193-token row; the layers drawn whole one
   at a time and cut; the mesh's reference run replays rank 0's one-card
   expert choices (no data average to drop at data 1).

8. ring_train_checks: `ring_attention` (causal) and
   `zigzag_ring_attention` over a context axis of every rank at
   Llama-3-8B's attention widths on a 131,072-token sequence (RING_TRAIN,
   bf16), through the entry points under autograd: the gathered o, lse
   and gradients against the one-card kernels on rank 0's card (the worst
   64-row tile, KERNEL_TILE_REL_RMS; lse at MIXED_TOL), exact launch
   counts on every rank (the ring c + 1 calls on context rank c, zigzag
   n + 2 on each), a planted fault (the causal ring's closing dK/dV hop
   skipped); each body's forward and backward ms (CUDA events, the
   slowest rank) beside the one-card kernels'.
9. cp_train: Llama-3-8B at full depth, data 1 x heads 2 x context 2 (the
   JAX dry run's dp x tp x cp leg at 4 cards: ring attention over the
   context axis); `tp_train`'s 2-layer gate at CP_REF_TOKENS tokens with
   the heads-input sum dropped and the ring's closing hop skipped as the
   planted faults, then TRAIN_STEPS steps on one CP_TRAIN_TOKENS-token row
   with remat (each layer checkpointed: the saved activations of 32
   layers at 65,536 tokens a rank would not fit).
10. pp_train: Llama-3-8B's 32 layers over 4 stages of 8 (`pipeline`),
   bf16, PP_TRAIN["micro"] microbatches of [1, PP_TRAIN["tokens"]] hidden
   states, one loss mean(out^2) of the last stage's output (the JAX dry
   run's PP leg), SGD: a 4-layer cut (one layer a stage) against rank
   0's sequential chain by the training gates, then TRAIN_STEPS steps:
   seconds a step, each rank's peak memory, exact flash counts, and one
   profiled step a rank (busy share beside the bubble (S - 1) / (M + S -
   1)).
11. dryrun: the port's `entry.dryrun_multichip(world)` on this group
   (every rank calls it, rank 0 prints the JAX dry run's three lines): at
   4 ranks mesh data 1 x heads 2 x context 2 (ring attention), the MoE at
   ep 2, and 4 pipeline stages of float32 tiny Llama layers whose loss
   and gradients the leg holds to its chain (it raises otherwise); each
   rank's launch counts, the true-fp32 kernels' exact (`dryrun_f32`).

The training phases need 4 ranks and run outside inference mode.
``--phases a,b`` runs a subset; ``--world N`` another rank count.
``--rehearse`` runs the same code on the CPU (gloo ranks, the kernels'
plain versions) at tiny sizes, to find faults before a chip run.

Any failure exits non-zero.  The last line is {"ok": true, ...}.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402  (the repo's helpers; no JAX)

SEED = cs.SEED
PROMPT_LENS = cs.PROMPT_LENS
MAX_NEW = cs.MAX_NEW
MAX_BATCH = cs.MAX_BATCH
PAGE = cs.PAGE
MOE_CUT_LAYERS = 16
MOE_FULL_LAYERS = 32
# cp_checks, at Llama-3-8B's attention widths (32 q heads, 8 kv heads,
# head_dim 128), bf16.
CP_FLASH = (1, 32, 8192, 128)        # causal, heads over 4 ranks
CP_ATTN = (1, 32, 2048, 128)         # queries, against CP_ATTN_KEYS keys
CP_ATTN_KEYS = 32768
CP_DECODE_KEYS = 32768
CP_DECODE_LENS = (32768, 30000, 20000, 16385, 8192, 5000, 1000, 129)
CP_KV_HEADS = 8
CP_ITERS = 20
PHASES = ("tp_serve", "gemma_tp_serve", "moe_tp_serve", "cp_checks",
          "tp_train", "gemma_tp_train", "moe_tp_train", "ring_train_checks",
          "cp_train", "pp_train", "dryrun")
TRAINING = ("tp_train", "gemma_tp_train", "moe_tp_train",
            "ring_train_checks", "cp_train", "pp_train", "dryrun")
NCCL = {"nccl": ("nccl",)}
# --rehearse: the same phases on the CPU at tiny sizes.
REHEARSE = {"prompt_lens": (40, 12, 30, 21), "max_new": 5, "page": 16,
            "cp_flash": (1, 8, 128, 64), "cp_attn": (1, 8, 64, 64),
            "cp_attn_keys": 256, "cp_decode_keys": 256,
            "cp_decode_lens": (256, 200, 60, 9), "cp_kv_heads": 4}


class Run:
    """What every phase of one rank needs: rank, world, device, the card
    line, the sizes (full, or tiny under --rehearse)."""

    def __init__(self, rank, world, dev, card, rehearse):
        self.rank, self.world, self.dev, self.card = rank, world, dev, card
        self.rehearse = rehearse
        self.failures = []      # checks that failed; raised after all phases
        sizes = REHEARSE if rehearse else {}
        self.prompt_lens = sizes.get("prompt_lens", PROMPT_LENS)
        self.max_new = sizes.get("max_new", MAX_NEW)
        self.page = sizes.get("page", PAGE)
        rng = np.random.default_rng(SEED)
        self.prompts = [rng.integers(0, 256 if rehearse else 32000,
                                     (n,)).astype(np.int32)
                        for n in self.prompt_lens]
        self.cp = {k: sizes.get(k, globals()[k.upper()]) for k in (
            "cp_flash", "cp_attn", "cp_attn_keys", "cp_decode_keys",
            "cp_decode_lens", "cp_kv_heads")}

    def sync(self):
        import torch
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def gather(self, obj) -> list:
        import torch.distributed as dist
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def say(self, label: str, reading: dict) -> None:
        if self.rank == 0:
            print(f"{label}: " + json.dumps(dict(reading, card=self.card)),
                  flush=True)

    def peak(self) -> int:
        import torch
        return (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else 0)

    def reset_peak(self) -> None:
        import torch
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)


def fail(msg: str) -> None:
    raise RuntimeError(f"tp_probe: {msg}")


def family_steps(family: str):
    from metal_flash_attention_tpu_torch.models import serving
    if family == "gemma":
        return (serving.gemma_paged_chunk_step,
                serving.gemma_paged_decode_step)
    return serving.paged_chunk_step, serving.paged_decode_step


def expected_launches(cfg, calls: dict) -> dict:
    """Exact paged launch counts of a serve: per layer one `paged_prefill`
    a chunk step and one `paged_decode` a decode step, each on its Hopper
    kernel, with the soft cap and head_dim 256 counted where the family
    has them."""
    suffixes = ["", "_sm90"]
    if getattr(cfg, "attn_logit_softcap", None):
        suffixes.append("_softcap")
    if cfg.head_dim == 256:
        suffixes.append("_d256")
    return {f"{kernel}{s}": cfg.n_layers * calls[step]
            for kernel, step in (("paged_prefill", "chunk"),
                                 ("paged_decode", "decode"))
            for s in suffixes if calls[step]}


def engine(run: Run, params, cfg, family, mesh, calls=None):
    """A `ServingEngine` for the family's steps (partial on ``mesh`` with
    ``kv_sharding`` when given), counting the step calls into
    ``calls``."""
    from metal_flash_attention_tpu_torch import ServingEngine
    from metal_flash_attention_tpu_torch.parallel import (
        HEAD_AXIS,
        NamedSharding,
        P,
    )

    def counted(fn, key):
        def step(*args, **kwargs):
            if calls is not None:
                calls[key] += 1
            if mesh is not None:
                kwargs["mesh"] = mesh
            return fn(*args, **kwargs)
        return step
    chunk, decode = family_steps(family)
    max_seq = max(run.prompt_lens) + run.max_new + 1
    kv = (None if mesh is None
          else NamedSharding(mesh, P(None, HEAD_AXIS, None, None)))
    return ServingEngine(
        params, cfg, max_batch=MAX_BATCH,
        num_pages=MAX_BATCH * -(-max_seq // run.page) + 1,
        page_size=run.page, max_seq=max_seq, kv_sharding=kv,
        chunk_step=counted(chunk, "chunk"),
        decode_step=counted(decode, "decode"))


def serve(run: Run, params, cfg, family, mesh, routes=None,
          picks=None) -> dict:
    """The requests through the engine (after a one-request warm-up):
    streams, per-call emitted tokens, seconds, launch counts held exact,
    peak memory.  ``routes``: `chip_smoke.moe_routes` keywords (then also
    the number of routing calls after each engine call, "route_calls").
    ``picks``: a dict that gets the float32 logits row [vocab] from which
    each token was chosen, keyed (request id, token index), on the host
    (a copy a step, inside the timed loop)."""
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    warm = engine(run, params, cfg, family, mesh)
    warm.submit(run.prompts[1][:2 * run.page], 2)
    while not warm.idle:
        warm.step()
    del warm
    calls = {"chunk": 0, "decode": 0}
    eng = engine(run, params, cfg, family, mesh, calls)
    num_pages = eng.alloc.free_pages + 1
    rids = [eng.submit(p, run.max_new) for p in run.prompts]
    watch = (cs.moe_routes(**routes) if routes is not None
             else contextlib.nullcontext())
    if picks is not None:
        eng._pick = recorded(eng._pick, picks)
    emitted, route_calls = [], []
    pa.reset_launch_counts()
    run.reset_peak()
    run.sync()
    t0 = time.perf_counter()
    with watch:
        while not eng.idle:
            emitted.append(eng.step())
            if routes is not None:
                route_calls.append(len(routes.get("record",
                                                  routes.get("margins"))))
            if len(emitted) > 10_000:
                fail("engine did not drain")
    run.sync()
    secs = time.perf_counter() - t0
    launches = {k: n for k, n in pa.LAUNCH_COUNTS.items() if n}
    if run.dev.type == "cuda":
        wrong = cs.launch_errors(launches, expected_launches(cfg, calls))
        if wrong:
            fail(f"{family} launched (count, expected) {wrong}")
    streams = [eng.result(r).tolist() for r in rids]
    if eng.alloc.free_pages != num_pages - 1:
        fail(f"{family}: pages leaked")
    # The recorder refers back to the engine: drop it, so that the engine,
    # its pools and its parameters go when the call returns.
    eng.__dict__.pop("_pick", None)
    tokens = run.max_new * len(run.prompts)
    return {"streams": streams, "emitted": emitted, "seconds": secs,
            "new_tokens_per_s": tokens / secs, "calls": calls,
            "launches": launches, "max_memory_allocated": run.peak(),
            "route_calls": route_calls}


def recorded(pick, picks: dict):
    """The engine's `_pick` keeping each chosen row's logits in
    ``picks``."""
    def run(logits, bias, reqs, idxs):
        rows = logits.float().cpu()
        for j, r in enumerate(reqs):
            if r is not None:
                picks[r.rid, int(idxs[j])] = rows[j]
        return pick(logits, bias, reqs, idxs)
    return run


def stream_check(run: Run, ref: dict, got: dict, ref_picks: dict,
                 got_picks: dict) -> dict:
    """``got``'s streams against the 1-card run's, on rank 0: the tie
    gate on the 1-card engine's own logits (where a row first departs,
    both tokens within SPEC_TIE of that row's top in the same batched
    step, so the rows a step couples, as MoE capacity does, are taken as
    they were), and the relative rms error of each row's logits against
    the 1-card ones up to that point (a reading)."""
    plain = generated(ref["streams"], run.prompts)
    other = generated(got["streams"], run.prompts)
    gate = cs.tie_gate(plain, other, list(range(len(plain))),
                       lambda r, prefix: ref_picks[r, len(prefix)])
    worst = 0.0
    for r, (a, b) in enumerate(zip(plain, other)):
        diff = [j for j, (x, y) in enumerate(zip(a, b)) if x != y]
        for j in range(diff[0] + 1 if diff else len(a)):
            worst = max(worst, cs.rel_rms(got_picks[r, j], ref_picks[r, j]))
    gate["logits_rel_rms_until_departure"] = worst
    return gate


def decode_profile(run: Run, label, params, cfg, family, mesh,
                   spans=()) -> dict:
    """One engine decode step of MAX_BATCH live rows under the profiler,
    on every rank: the card's ms by family (NCCL kernels apart)."""
    import torch.distributed
    eng = engine(run, params, cfg, family, mesh)
    for p in run.prompts[:MAX_BATCH]:
        eng.submit(p, run.max_new)
    while eng._queue or any(r is not None and r.next_token is None
                            for r in eng._slots):
        eng.step()
    families = dict(NCCL, attention=("paged_", "merge_splits"))
    if run.dev.type != "cuda":
        eng.step()
        return {}
    # Start the ranks together: an NCCL kernel also holds the card while
    # it waits for the other ranks to reach the collective.
    run.sync()
    torch.distributed.barrier()
    with cs.moe_annotated() if spans else contextlib.nullcontext():
        reading = cs.profile_step(f"{label}_rank{run.rank}", eng.step,
                                  families, run.dev, spans=spans)
    by = reading["device_ms_by_family"]
    reading["nccl_share"] = by.get("nccl", 0.0) / max(
        reading["device_ms"], 1e-9)
    return reading


def generated(streams, prompts):
    return [s[len(p):] for s, p in zip(streams, prompts)]


def check_ranks_agree(run: Run, what: str, value) -> None:
    """Every rank holds the same ``value`` (emitted tokens, a weight
    checksum), else the run fails on every rank."""
    if any(v != value for v in run.gather(value)):
        fail(f"ranks differ in {what}")


def weight_checksum(params) -> float:
    return float(sum(params["layers"][0][k].double().sum().item()
                     for k in ("wq", "wo")) + params["embed"][:64]
                 .double().sum().item())


def tp_family(run: Run, label, family, cfg, init, specs, spans=(),
              routes=False) -> dict:
    """Draw the model whole on every rank, serve it on rank 0 alone (the
    1-card engine), cut every rank's blocks and serve at tp; hold the
    streams by the tie gate (and, for routed models, the route replay)."""
    import torch
    import torch.distributed as dist
    from metal_flash_attention_tpu_torch.parallel import make_mesh, shard

    full = init(cfg, torch.Generator(device=run.dev).manual_seed(SEED),
                device=run.dev)
    check_ranks_agree(run, f"{label} weights", weight_checksum(full))
    ref, record, ref_picks, tp_picks = None, [], {}, {}
    if run.rank == 0:
        ref = serve(run, full, cfg, family, None,
                    routes={"record": record} if routes else None,
                    picks=ref_picks)
    dist.barrier()
    mesh = make_mesh(heads=run.world, devices=run.dev.type)
    local = shard(full, specs(cfg, mesh), mesh)
    if run.rank != 0:
        del full
    tp = serve(run, local, cfg, family, mesh,
               picks=tp_picks if run.rank == 0 else None)
    check_ranks_agree(run, f"{label} emitted tokens", tp["emitted"])
    prof = decode_profile(run, f"{label}_decode_profile", local, cfg,
                          family, mesh, spans)
    per_rank = run.gather({k: tp[k] for k in (
        "launches", "max_memory_allocated", "seconds", "calls")}
        | {"nccl_share": prof.get("nccl_share"),
           "decode_device_ms": prof.get("device_ms")})
    gate = replay = None
    if run.rank == 0:
        gate = stream_check(run, ref, tp, ref_picks, tp_picks)
    ok = run.gather(None if gate is None else gate["ok"])[0]
    if routes and not ok:
        replay = route_replay(run, local, cfg, family, mesh, record, ref,
                              ref_picks)
        ok = replay["ok"]
    reading = {
        "world_size": run.world, "mesh": {"data": 1, "heads": run.world,
                                          "context": 1},
        "config": cfg_line(cfg), "requests": len(run.prompts),
        "new_tokens": run.max_new * len(run.prompts),
        "tp": {k: tp[k] for k in ("seconds", "new_tokens_per_s")},
        "one_card": None if ref is None else {
            k: ref[k] for k in ("seconds", "new_tokens_per_s",
                                "max_memory_allocated")},
        "streams_equal": None if ref is None else ref["streams"]
        == tp["streams"],
        "tie_gate": gate, "route_replay": replay, "per_rank": per_rank,
        "ok": ok}
    run.say(label, reading)
    if not ok:
        run.failures.append(f"{label}: the tp streams leave the 1-card ones "
                            f"past the tie gate")
    del local
    if run.rank == 0:
        del full
    run.reset_peak()
    return reading


def route_replay(run: Run, local, cfg, family, mesh, record, ref,
                 ref_picks) -> dict:
    """The tp serve again with the 1-card run's routes taken (from rank
    0, on every rank), so that capacity couples the rows of a step as it
    did there: the streams must pass the tie gate, and each route of the
    tp run's own that differs from the one taken must lie within MOE_TIE
    of it in gate probability, in the first chip_smoke.MOE_REF_LAYERS
    layers (the depth at which MOE_TIE was read; rounding noise grows
    with depth, so deeper layers' worst margins are only printed) and in
    the engine calls before the first one that emitted another token
    (from that call on, a row decodes a token of its own)."""
    taken = [t.cpu() for t in record] if run.rank == 0 else None
    taken = run.gather(taken)[0]
    margins, picks = [], {}
    tp = serve(run, local, cfg, family, mesh,
               routes={"taken": [t.to(run.dev) for t in taken],
                       "margins": margins},
               picks=picks if run.rank == 0 else None)
    gate = worst = None
    if run.rank == 0:
        gate = stream_check(run, ref, tp, ref_picks, picks)
        # The routing calls of the engine calls before the first one that
        # emitted another token: within that call a row whose prefill
        # ended already decodes its own first token.
        same = [a == b for a, b in zip(ref["emitted"], tp["emitted"])]
        first = same.index(False) if False in same else len(same)
        until = tp["route_calls"][first - 1] if first else 0
        by_layer = [0.0] * cfg.n_layers
        for i, m in enumerate(margins[:until]):
            if m.numel():
                by_layer[i % cfg.n_layers] = max(by_layer[i % cfg.n_layers],
                                                 float(m.max()))
        worst = {"by_layer": by_layer, "calls": until,
                 "gated_layers": cs.MOE_REF_LAYERS,
                 "gated": max(by_layer[:cs.MOE_REF_LAYERS])}
    gate, worst = run.gather((gate, worst))[0]
    return {"worst_route_margin": worst, "moe_tie": cs.MOE_TIE,
            "tie_gate": gate,
            "ok": gate["ok"] and worst["gated"] <= cs.MOE_TIE}


def cfg_line(cfg) -> dict:
    return {k: getattr(cfg, k) for k in (
        "dim", "n_layers", "n_heads", "n_kv_heads", "head_dim",
        "hidden_dim", "vocab_size") if hasattr(cfg, k)} | (
        {"n_experts": cfg.n_experts, "top_k": cfg.top_k}
        if hasattr(cfg, "n_experts") else {})


def tp_serve(run: Run) -> None:
    from metal_flash_attention_tpu_torch.models import llama
    cfg = (llama.LlamaConfig.tiny(n_heads=8, n_kv_heads=4)
           if run.rehearse else llama.LlamaConfig.llama3_8b())
    tp_family(run, "tp_serve", "llama", cfg, llama.init_params,
              llama.param_shardings)


def gemma_tp_serve(run: Run) -> None:
    from metal_flash_attention_tpu_torch.models import gemma
    cfg = (gemma.GemmaConfig.tiny(n_heads=8, n_kv_heads=4, sliding_window=24)
           if run.rehearse else gemma.GemmaConfig.gemma2_2b())
    tp_family(run, "gemma_tp_serve", "gemma", cfg, gemma.init_params,
              gemma.param_shardings)


def moe_tp_serve(run: Run) -> None:
    """16 layers against the 1-card engine, then all 32 at tp only."""
    import torch
    from metal_flash_attention_tpu_torch.models import moe
    from metal_flash_attention_tpu_torch.parallel import make_mesh, shard

    base = (moe.MoEConfig.tiny(n_heads=8, n_kv_heads=4, n_experts=8)
            if run.rehearse else moe.MoEConfig())
    spans = ("moe_experts",)
    cut = dataclasses.replace(base, n_layers=2 if run.rehearse
                              else MOE_CUT_LAYERS)
    tp_family(run, "moe_tp_serve", "llama", cut, moe.init_params,
              moe.param_shardings, spans=spans, routes=True)

    cfg = dataclasses.replace(base, n_layers=4 if run.rehearse
                              else MOE_FULL_LAYERS)
    if run.world == 1 and not run.rehearse:
        run.say("moe_full_tp_serve", {"skipped": "the full depth needs more "
                                      "than one card"})
        return
    mesh = make_mesh(heads=run.world, devices=run.dev.type)
    gen = torch.Generator(device=run.dev).manual_seed(SEED)
    run.reset_peak()
    t0 = time.perf_counter()
    # One layer drawn whole at a time, cut to this rank's block and freed:
    # the whole model (93 GB) fits on no card.
    one = dataclasses.replace(cfg, n_layers=1)
    layers, head = [], None
    for _ in range(cfg.n_layers):
        whole = moe.init_params(one, gen, device=run.dev)
        part = shard(whole, moe.param_shardings(one, mesh), mesh)
        layers += part["layers"]
        head = part
        del whole
    params = dict(head, layers=layers)
    run.sync()
    build_s = time.perf_counter() - t0
    weights = run.peak()
    tp = serve(run, params, cfg, "llama", mesh)
    check_ranks_agree(run, "moe_full emitted tokens", tp["emitted"])
    for s, p in zip(tp["streams"], run.prompts):
        if len(s) != len(p) + run.max_new or not all(
                0 <= t < cfg.vocab_size for t in s):
            fail("moe_full: a stream is short or leaves the vocabulary")
    prof = decode_profile(run, "moe_full_decode_profile", params, cfg,
                          "llama", mesh, spans)
    per_rank = run.gather({
        "params_bytes_peak": weights,
        "max_memory_allocated": tp["max_memory_allocated"],
        "launches": tp["launches"],
        "decode_device_ms": prof.get("device_ms"),
        "device_ms_by_family": prof.get("device_ms_by_family"),
        "nccl_share": prof.get("nccl_share")})
    run.say("moe_full_tp_serve", {
        "world_size": run.world, "config": cfg_line(cfg),
        "note": "full depth; the layers were drawn one at a time (the "
                "1-card run at this depth does not fit a card), so their "
                "weights are not the 16-layer run's",
        "weights_built_s": build_s, "seconds": tp["seconds"],
        "new_tokens_per_s": tp["new_tokens_per_s"],
        "new_tokens": run.max_new * len(run.prompts),
        "per_rank": per_rank})
    del params, layers, head
    run.reset_peak()


def cp_checks(run: Run) -> None:
    """The four sharded-attention functions over the ranks against the
    single-card kernel on rank 0's card, each with its ms."""
    import torch
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
    from metal_flash_attention_tpu_torch.parallel import (
        sharded_attention as sa,
    )
    from metal_flash_attention_tpu_torch.utils.tolerances import MIXED_TOL

    dev, cp = run.dev, run.cp
    bf16 = torch.bfloat16
    heads = make_mesh(heads=run.world, devices=dev.type)
    ctx = make_mesh(context=run.world, devices=dev.type)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def ms(fn):
        if dev.type != "cuda":
            fn()
            return None
        fn()
        return max(run.gather(cs.event_ms(fn, CP_ITERS)))

    def one_card(fn):
        """The single-card kernel's output and ms, on rank 0."""
        if run.rank != 0:
            return None, None
        out = fn()
        return out, (cs.event_ms(fn, CP_ITERS) if dev.type == "cuda"
                     else None)

    readings, faults = {}, {}

    def host(x, rows=False):
        """x on the host (None stays None); ``rows``: [b, h, d] as [b, h,
        1, d], so that each (row, head) is a tile of its own."""
        if x is None:
            return None
        return x.cpu()[:, :, None] if rows else x.cpu()

    def judge(name, got, ref, ref_ms, tp_ms, lse=None, fault=None):
        r = None
        if run.rank == 0:
            r = cs.closeness(got, ref)
            if lse is not None:
                r["lse_max_abs_err"] = max(lse)
                r["lse_ok"] = max(lse) <= MIXED_TOL.lse
            r["ok"] = cs.within_limits(r) and r.get("lse_ok", True)
            r.update(ms=tp_ms, one_card_ms=ref_ms)
            if fault is not None:
                faults[name] = cs.closeness(fault, ref)
                r["fault_seen"] = not cs.within_limits(faults[name])
        readings[name] = r

    # 1. Head-parallel causal forward: each rank's 8 q heads, 2 kv heads.
    b, h, n, d = cp["cp_flash"]
    kvh = cp["cp_kv_heads"]
    q, k, v = randn(b, h, n, d), randn(b, kvh, n, d), randn(b, kvh, n, d)
    spec = P(None, HEAD_AXIS)
    ql, kl, vl = (shard(x, spec, heads) for x in (q, k, v))
    fn = sharded_flash_attention(heads, causal=True)
    o_l = fn(ql, kl, vl)
    _, lse_l = flash_attention_forward(ql, kl, vl, causal=True)
    tp_ms = ms(lambda: fn(ql, kl, vl))
    o_g = torch.cat(run.gather(o_l.cpu()), dim=1)
    lse_g = torch.cat(run.gather(lse_l.cpu()), dim=1)
    ref, ref_ms = one_card(lambda: flash_attention_forward(
        q, k, v, causal=True))
    lse_err = None
    if run.rank == 0:
        lse_err = [float((lse_g - ref[1].cpu()).abs().max())]
        ref = ref[0].cpu()
    judge("sharded_flash_attention", o_g, ref, ref_ms, tp_ms, lse=lse_err)
    del q, k, v, ql, kl, vl, o_l

    # 2. Context-parallel attention: queries whole, keys in 4 slices.
    b, h, n, d = cp["cp_attn"]
    keys = cp["cp_attn_keys"]
    q, k, v = randn(b, h, n, d), randn(b, kvh, keys, d), randn(b, kvh,
                                                              keys, d)
    kl, vl = (shard(x, P(None, None, CONTEXT_AXIS), ctx) for x in (k, v))
    fn = context_parallel_attention(ctx)
    o = fn(q, kl, vl)
    tp_ms = ms(lambda: fn(q, kl, vl))
    fault = dropped_rank(sa, lambda: fn(q, kl, vl))
    ref, ref_ms = one_card(lambda: flash_attention_forward(q, k, v)[0])
    judge("context_parallel_attention", host(o), host(ref), ref_ms, tp_ms,
          fault=host(fault))
    del q, k, v, kl, vl

    # 3. Context-parallel dense decode over ragged lengths.
    lens = torch.tensor(cp["cp_decode_lens"], dtype=torch.int32, device=dev)
    bsz, s_all = len(cp["cp_decode_lens"]), cp["cp_decode_keys"]
    h, d = cp["cp_attn"][1], cp["cp_attn"][3]
    q = randn(bsz, h, d)
    k, v = randn(bsz, kvh, s_all, d), randn(bsz, kvh, s_all, d)
    kl, vl = (shard(x, P(None, None, CONTEXT_AXIS), ctx) for x in (k, v))
    fn = context_parallel_decode(ctx)
    o = fn(q, kl, vl, lens)
    tp_ms = ms(lambda: fn(q, kl, vl, lens))
    fault = dropped_rank(sa, lambda: fn(q, kl, vl, lens))
    s_local = kl.shape[2]
    local_lens = (lens - run.rank * s_local).clamp(0, s_local).to(torch.int32)
    o_i, lse_i = flash_decode(q, kl, vl, kv_lens=local_lens,
                              return_residuals=True)
    empty = {"decode": empty_rows(o_i, lse_i, local_lens)}
    ref, ref_ms = one_card(lambda: flash_decode(q, k, v, kv_lens=lens))
    judge("context_parallel_decode", host(o, True), host(ref, True), ref_ms,
          tp_ms, fault=host(fault, True))
    del kl, vl

    # 4. Context-parallel paged decode: the same K/V in pages, row i's
    # page j at 1 + i * per_row + j (page 0 the null page).
    page = run.page
    per_row = s_all // page

    def pages(x):
        out = x.new_zeros((bsz * per_row + 1, kvh, page, d))
        out[1:] = x.view(bsz, kvh, per_row, page, d).transpose(1, 2).reshape(
            -1, kvh, page, d)
        return out
    table = (1 + torch.arange(bsz * per_row, device=dev)).view(
        bsz, per_row).to(torch.int32)
    cache = pa.PagedKVCache(pages(k), pages(v), table, lens)
    del k, v
    kst, vst, tbl, ln = shard_paged_cache_pages(cache, run.world)
    cp_spec = P(CONTEXT_AXIS)
    blocks = [shard(kst, cp_spec, ctx).to(dev), shard(vst, cp_spec, ctx)
              .to(dev), shard(torch.as_tensor(tbl), cp_spec, ctx).to(dev),
              shard(torch.as_tensor(ln), cp_spec, ctx).to(dev)]
    del kst, vst
    fn = context_parallel_paged_decode(ctx)
    o = fn(q, *blocks)
    tp_ms = ms(lambda: fn(q, *blocks))
    fault = dropped_rank(sa, lambda: fn(q, *blocks))
    o_i, lse_i = pa.paged_decode(q, pa.PagedKVCache(
        blocks[0][0], blocks[1][0], blocks[2][0], blocks[3][0]),
        return_residuals=True)
    empty["paged_decode"] = empty_rows(o_i, lse_i, blocks[3][0])
    ref, ref_ms = one_card(lambda: pa.paged_decode(q, cache))
    judge("context_parallel_paged_decode", host(o, True), host(ref, True),
          ref_ms, tp_ms, fault=host(fault, True))
    del cache, blocks

    empty_all = run.gather(empty)
    ok = (run.rank != 0 or all(r["ok"] and r.get("fault_seen", True)
                               for r in readings.values()))
    zero_rows = sum(e[k]["rows"] for e in empty_all for k in e)
    empty_ok = all(e[k]["ok"] for e in empty_all for k in e) and (
        zero_rows or run.world == 1)
    run.say("cp_checks", {
        "world_size": run.world, "limits": {
            "tile_rel_rms": cs.KERNEL_TILE_REL_RMS, "lse_abs": MIXED_TOL.lse},
        "shapes": {"sharded_flash_attention": f"q {list(cp['cp_flash'])} "
                   f"causal, k/v {kvh} heads, heads over {run.world} ranks",
                   "context_parallel_attention": f"q {list(cp['cp_attn'])}"
                   f" against {cp['cp_attn_keys']} keys ({kvh} heads), "
                   f"keys over {run.world} ranks",
                   "context_parallel_decode": f"q [{bsz}, {h}, {d}] over "
                   f"{s_all} positions, lengths {list(cp['cp_decode_lens'])}",
                   "context_parallel_paged_decode": f"the same in "
                   f"{page}-token pages, pages dealt over {run.world} ranks"},
        "readings": readings, "faults": faults,
        "empty_rows_by_rank": empty_all, "ok": bool(ok and empty_ok)})
    if not run.gather(bool(ok and empty_ok))[0]:
        run.failures.append(
            "cp_checks: a sharded-attention function disagrees with the "
            "single-card kernel, a fault went unseen, or a row of local "
            "length 0 is not (o 0, lse -inf)")


# Data-, head- and expert-parallel training (slice 20).
TRAIN_MESH = {"data": 2, "heads": 2}
TRAIN_TOKENS = 8192          # a data rank's row: 8,193 tokens
TRAIN_STEPS = 4
TRAIN_LR = 1.0               # chip_smoke's SGD rate: smaller vanish in bf16
TRAIN_REF_LAYERS = 2
MOE_TRAIN_LAYERS = 24        # Mixtral widths, experts 2 a rank (tp 4)
TRAIN_FAULTS = ("data_average_dropped", "heads_input_sum_dropped")


@contextlib.contextmanager
def planted_fault(name: str):
    """A fault in the training mesh's collectives, planted on every rank
    inside the block: the data axis's gradient average dropped (each rank
    keeps its own rows' gradient), the column-parallel inputs' gradient
    sum over the heads axis dropped (each rank keeps its own heads'
    share), or the ring's closing dK/dV hop skipped (each rank keeps the
    next chunk's sums: `chip_smoke.held_rotate`)."""
    from metal_flash_attention_tpu_torch.parallel import mesh as pm

    if name == "ring_closing_hop_skipped":
        ra = cs.ring_modules()[0]
        real_rotate = ra.ring_rotate

        def rotate(mesh):
            # A layer's callable rotates n - 1 times forward, then K/V and
            # the sums each step backward: the closing hop is call 3(n-1).
            n = pm.axis_size(mesh, pm.CONTEXT_AXIS)
            return cs.held_rotate(real_rotate(mesh), 3 * (n - 1))
        ra.ring_rotate = rotate
        try:
            yield
        finally:
            ra.ring_rotate = real_rotate
        return
    axis = {"data_average_dropped": pm.DATA_AXIS,
            "heads_input_sum_dropped": pm.HEAD_AXIS}[name]
    real = pm._Replicated.__dict__["backward"]

    def backward(ctx, g):
        # A gradient average runs over one axis (a name) or several.
        if axis in ((ctx.axis,) if isinstance(ctx.axis, str) else ctx.axis):
            return g, None, None, None
        return real.__func__(ctx, g)
    pm._Replicated.backward = staticmethod(backward)
    try:
        yield
    finally:
        pm._Replicated.backward = real


def value_and_grads(loss_fn, params):
    """(loss, gradients in `flatten` order) of ``loss_fn(params)``."""
    import torch
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    leaves, rebuild = flatten(params)
    work = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(rebuild(work))
    return float(loss.detach()), list(torch.autograd.grad(loss, work))


def spec_leaves(tree, specs) -> list:
    """The leaves of ``specs`` in `flatten`'s order of ``tree`` (its
    keys' order, which `shard` keeps)."""
    if isinstance(tree, dict):
        return [x for k in tree for x in spec_leaves(tree[k], specs[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t, s in zip(tree, specs) for x in spec_leaves(t, s)]
    return [specs]


def gathered(grads, params, specs, mesh) -> list:
    """Each rank's gradient blocks (in `flatten` order of ``params``) made
    whole by `unshard` under their specs."""
    from metal_flash_attention_tpu_torch.parallel import unshard

    return [unshard(g, s, mesh)
            for g, s in zip(grads, spec_leaves(params, specs))]


def gate_reading(loss, grads, ref_loss, ref_grads) -> dict:
    """The mesh's loss and whole gradients against one card's: the
    training gates' readings (chip_smoke's TRAIN_LOSS_ABS and
    TRAIN_GRAD_REL_RMS)."""
    rel = [cs.rel_rms(g, r) for g, r in zip(grads, ref_grads)]
    reading = {"loss": loss, "ref_loss": ref_loss,
               "loss_abs_err": abs(loss - ref_loss),
               "grad_rel_rms_max": max(rel),
               "grad_rel_rms_median": float(np.median(rel))}
    reading["within_gates"] = (reading["loss_abs_err"] <= cs.TRAIN_LOSS_ABS
                               and max(rel) <= cs.TRAIN_GRAD_REL_RMS)
    return reading


def train_tokens(run: Run, cfg, rows: int, seq: int):
    """Global tokens [rows, seq + 1] from SEED + 81 (the same on every
    rank), on the rank's device."""
    import torch
    rng = np.random.default_rng(SEED + 81)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (rows, seq + 1)),
                           device=run.dev)


def train_family(run: Run, label, module, cfg, mesh_shape, seq, draw,
                 kernel_suffixes=("", "_sm90"), replay_routes=False,
                 faults=TRAIN_FAULTS, ref_seq=None, remat=False) -> None:
    """One family's training at ``mesh_shape`` (data x heads, and
    context): the 2-layer cut's loss and gradients on the mesh (gathered)
    against one card's (rank 0, the same weights and the global rows, at
    ``ref_seq`` tokens a row, default ``seq``), the same with each of
    ``faults`` planted (the gates must see them), then TRAIN_STEPS SGD
    steps of the whole cut on rows of ``seq`` tokens (``remat``: each
    layer checkpointed): losses, seconds a step, tokens/s, each rank's
    peak memory and exact flash counts, and one more step under the
    profiler, behind a barrier that lines the ranks up (NCCL's share of
    the card's time in the step).  ``draw(mesh) -> (this rank's blocks,
    rank 0's whole 2-layer cut or None)``; ``replay_routes``: the mesh's
    reference run takes rank 0's one-card expert choices (MoE capacity
    couples the rows)."""
    import torch
    import torch.distributed as dist
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.parallel import (
        CONTEXT_AXIS,
        DATA_AXIS,
        P,
        make_mesh,
        shard,
    )
    from metal_flash_attention_tpu_torch.parallel.mesh import axis_index
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    mesh = make_mesh(**mesh_shape, devices=run.dev.type)
    data = mesh_shape["data"]
    run.reset_peak()
    t0 = time.perf_counter()
    local, whole_cut = draw(mesh)
    run.sync()
    draw_s = time.perf_counter() - t0
    draw_peak = run.peak()
    blocks = sum(t.numel() * t.element_size() for t in flatten(local)[0])
    tokens = train_tokens(run, cfg, data, ref_seq or seq)
    rows = shard(tokens, P(DATA_AXIS, None), mesh)
    cut_cfg = dataclasses.replace(cfg, n_layers=TRAIN_REF_LAYERS)
    specs = module.param_shardings(cut_cfg, mesh)

    # The 2-layer cut: one card (rank 0) against the mesh, then faults.
    record = []
    ref = None
    if run.rank == 0:
        with (cs.moe_routes(record=record) if replay_routes
              else contextlib.nullcontext()):
            ref = value_and_grads(
                lambda p: module.loss_fn(p, tokens, cut_cfg), whole_cut)
        ref = (ref[0], [g.float() for g in ref[1]])
    del whole_cut
    taken = run.gather([r.cpu() for r in record] if run.rank == 0
                       else None)[0] if replay_routes else None
    cut = dict(local, layers=local["layers"][:TRAIN_REF_LAYERS])

    def mesh_reading(fault=None):
        margins = []
        routes = (cs.moe_routes(taken=[t.to(run.dev) for t in taken],
                                margins=margins) if replay_routes
                  else contextlib.nullcontext())
        with routes, (planted_fault(fault) if fault
                      else contextlib.nullcontext()):
            loss, grads = value_and_grads(
                lambda p: module.loss_fn(p, rows, cut_cfg, mesh=mesh), cut)
        whole = gathered(grads, cut, specs, mesh)
        del grads
        out = None
        if run.rank == 0:
            out = gate_reading(loss, [g.float() for g in whole], *ref)
            if replay_routes:
                out["route_margin_max"] = max(
                    (float(m.max()) for m in margins if m.numel()),
                    default=0.0)
        return out
    reading = mesh_reading()
    # A data axis of one rank has no average to drop.
    faults = {f: mesh_reading(f) for f in faults
              if data > 1 or f != "data_average_dropped"}
    del cut, ref
    if ref_seq is not None:
        tokens = train_tokens(run, cfg, data, seq)
        rows = shard(tokens, P(DATA_AXIS, None), mesh)
    step_kw = {"remat": True} if remat else {}
    run.reset_peak()

    # TRAIN_STEPS steps of the whole cut.
    dist.barrier()
    losses, seconds = [], []
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        run.sync()
        dist.barrier()
        t0 = time.perf_counter()
        local, loss = module.train_step(local, rows, cfg, lr=TRAIN_LR,
                                        mesh=mesh, **step_kw)
        losses.append(float(loss))
        run.sync()
        seconds.append(time.perf_counter() - t0)
    launches = {k: n for k, n in {**fa.LAUNCH_COUNTS,
                                  **fb.LAUNCH_COUNTS}.items() if n}
    # A context axis of n ranks: rank c runs c + 1 forward calls and
    # backward pairs a layer (the causal ring); remat runs the forward
    # twice.
    ctx_calls = axis_index(mesh, CONTEXT_AXIS) + 1
    want = {f"{op}{s}": cfg.n_layers * TRAIN_STEPS * ctx_calls
            * (2 if remat and op == "flash_fwd" else 1)
            for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
            for s in kernel_suffixes}
    peak = run.peak()
    prof = {}
    if run.dev.type == "cuda":
        run.sync()
        dist.barrier()
        step_wall = []

        def aligned_step():
            # Each rank leaves the profiler's start at its own time, and
            # an NCCL kernel holds its card while it waits for the late
            # ranks: a barrier inside the profile lines the ranks up, and
            # its kernel stays out of the step's (the "align" span).
            with torch.profiler.record_function("align"):
                dist.barrier()
            t0 = time.perf_counter()
            module.train_step(local, rows, cfg, lr=TRAIN_LR, mesh=mesh,
                              **step_kw)
            run.sync()
            step_wall.append(time.perf_counter() - t0)
        prof = cs.profile_step(
            f"{label}_profile_rank{run.rank}", aligned_step,
            dict(NCCL, flash_fwd="flash_fwd90_kernel",
                 flash_bwd_dq="flash_bwd_dq90_kernel",
                 flash_bwd_dkv="flash_bwd_dkv90_kernel"), run.dev,
            spans=("align",))
        by = prof["device_ms_by_family"]
        prof["device_ms"] -= by.get("align", 0.0)
        prof["wall_ms"] = step_wall[0] * 1e3
        prof["nccl_share"] = by.get("nccl", 0.0) / max(prof["device_ms"],
                                                       1e-9)
    per_rank = run.gather({
        "losses": losses, "seconds_per_step": seconds,
        "blocks_bytes": blocks, "draw_peak_bytes": draw_peak,
        "max_memory_allocated": peak,
        "launches": launches, "launches_exact": run.dev.type != "cuda"
        or launches == want, "nccl_share": prof.get("nccl_share"),
        "step_device_ms": prof.get("device_ms"),
        "step_wall_ms": prof.get("wall_ms")})
    steady = [max(r["seconds_per_step"][i] for r in per_rank)
              for i in range(1, TRAIN_STEPS)]
    global_tokens = data * seq
    context = mesh_shape.get("context", 1)
    ok = (reading is None or reading["within_gates"]) and all(
        r is None or not r["within_gates"] for r in faults.values())
    ok = run.gather(ok)[0]
    same_losses = all(r["losses"] == per_rank[0]["losses"] for r in per_rank)
    good = np.isfinite(losses).all() and losses[-1] < losses[0]
    run.say(label, {
        "world_size": run.world, "mesh": dict(mesh_shape, context=context),
        "config": cfg_line(cfg), "tokens_per_step": global_tokens,
        "rows": [data, seq + 1], "reference_rows": [data, (ref_seq or seq)
                                                    + 1],
        "remat": remat, "lr": TRAIN_LR, "steps": TRAIN_STEPS,
        "weights_drawn_s": draw_s, "losses": losses,
        "tokens_per_s": global_tokens * len(steady) / sum(steady),
        "seconds_per_step": [max(r["seconds_per_step"][i] for r in per_rank)
                             for i in range(TRAIN_STEPS)],
        "reference": {"layers": TRAIN_REF_LAYERS, **(reading or {})},
        "planted_faults": faults,
        "gates": {"loss_abs": cs.TRAIN_LOSS_ABS,
                  "grad_rel_rms": cs.TRAIN_GRAD_REL_RMS},
        "per_rank": per_rank, "ok": ok})
    if not ok:
        run.failures.append(f"{label}: the mesh's 2-layer loss or gradients "
                            "leave one card's, or a planted fault passes")
    if not same_losses:
        run.failures.append(f"{label}: the ranks' losses differ")
    if not good:
        run.failures.append(f"{label}: the loss is not finite or did not "
                            f"fall: {losses}")
    if not all(r["launches_exact"] for r in per_rank):
        run.failures.append(f"{label}: flash launches {launches}, expected "
                            f"{want}")
    del local
    run.reset_peak()


def whole_then_cut(run: Run, module, cfg):
    """draw(mesh) for a model that fits a card whole: every rank draws it
    from SEED on its card, keeps its blocks, and rank 0 keeps the whole
    2-layer cut for the one-card reference."""
    import torch
    from metal_flash_attention_tpu_torch.parallel import shard

    def draw(mesh):
        full = module.init_params(
            cfg, torch.Generator(device=run.dev).manual_seed(SEED),
            device=run.dev)
        check_ranks_agree(run, "training weights", weight_checksum(full))
        local = shard(full, module.param_shardings(cfg, mesh), mesh)
        cut = (dict(full, layers=full["layers"][:TRAIN_REF_LAYERS])
               if run.rank == 0 else None)
        del full
        return local, cut
    return draw


def tp_train(run: Run) -> None:
    """Llama-3-8B at full depth (32 layers), data 2 x heads 2, one
    8,193-token row a data rank."""
    from metal_flash_attention_tpu_torch.models import llama
    cfg = (llama.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, n_layers=3)
           if run.rehearse else llama.LlamaConfig.llama3_8b())
    seq = 64 if run.rehearse else TRAIN_TOKENS
    train_family(run, "tp_train", llama, cfg, TRAIN_MESH, seq,
                 whole_then_cut(run, llama, cfg))


def gemma_tp_train(run: Run) -> None:
    """gemma2_2b (26 layers), data 2 x heads 2 (4 q heads and 2 kv heads
    a rank, head_dim 256, both soft caps)."""
    from metal_flash_attention_tpu_torch.models import gemma
    cfg = (gemma.GemmaConfig.tiny(n_heads=8, n_kv_heads=4, n_layers=3,
                                  sliding_window=24)
           if run.rehearse else gemma.GemmaConfig.gemma2_2b())
    seq = 64 if run.rehearse else TRAIN_TOKENS
    suffixes = ("", "_sm90", "_softcap") + (
        () if run.rehearse else ("_d256",))
    train_family(run, "gemma_tp_train", gemma, cfg, TRAIN_MESH, seq,
                 whole_then_cut(run, gemma, cfg), kernel_suffixes=suffixes)


def moe_tp_train(run: Run) -> None:
    """Mixtral-8x7B widths at MOE_TRAIN_LAYERS layers, heads 4 (experts 2
    a rank), one 8,193-token row.  The layers are drawn whole one at a
    time, cut to this rank's blocks and freed; rank 0 keeps the first
    two whole for the one-card reference, which replays its routes into
    the mesh's reference run."""
    import torch
    from metal_flash_attention_tpu_torch.models import moe
    from metal_flash_attention_tpu_torch.parallel import shard

    base = (moe.MoEConfig.tiny(n_heads=8, n_kv_heads=4, n_experts=8)
            if run.rehearse else moe.MoEConfig())
    cfg = dataclasses.replace(base, n_layers=3 if run.rehearse
                              else MOE_TRAIN_LAYERS)
    seq = 64 if run.rehearse else TRAIN_TOKENS

    def draw(mesh):
        gen = torch.Generator(device=run.dev).manual_seed(SEED)
        one = dataclasses.replace(cfg, n_layers=1)
        layers, whole_layers, head = [], [], None
        for i in range(cfg.n_layers):
            whole = moe.init_params(one, gen, device=run.dev)
            if i == 0:
                check_ranks_agree(run, "moe training weights",
                                  weight_checksum(whole))
            part = shard(whole, moe.param_shardings(one, mesh), mesh)
            layers += part["layers"]
            if i < TRAIN_REF_LAYERS and run.rank == 0:
                whole_layers += whole["layers"]
            if i == 0:
                head, first = part, whole
            del whole
        cut = (dict(first, layers=whole_layers) if run.rank == 0
               else None)
        return dict(head, layers=layers), cut
    train_family(run, "moe_tp_train", moe, cfg,
                 {"data": 1, "heads": run.world}, seq, draw,
                 replay_routes=True)


# Ring and zigzag attention, the context axis in training and the
# pipeline (slice 21).
RING_TRAIN = dict(batch=1, heads=(32, 8), head_dim=128, seq=131072)
RING_ITERS = 5
CP_TRAIN_MESH = {"data": 1, "heads": 2, "context": 2}
CP_TRAIN_TOKENS = 131072     # the row of the steps: the 128K tier, remat
CP_REF_TOKENS = 8192         # the 2-layer gate's row
PP_TRAIN = dict(layers=32, micro=8, tokens=2048, ref_layers=4)
PP_TRAIN_LR = 1e-2           # mean(out^2) grows its hidden states at 1.0
REHEARSE_RING = dict(batch=1, heads=(8, 4), head_dim=64, seq=512)


def ring_train_checks(run: Run) -> None:
    """`ring_attention` (causal) and `zigzag_ring_attention` over a
    context axis of every rank at Llama-3-8B's attention widths on a
    RING_TRAIN["seq"]-token sequence: the gathered o, lse and gradients
    of sum(o * dO) against the one-card kernels on rank 0's card (the
    worst 64-row tile, KERNEL_TILE_REL_RMS; lse at MIXED_TOL), a planted
    fault (the causal ring's closing dK/dV hop skipped), and each call's
    ms (CUDA events, the slowest rank) beside one card's."""
    import torch
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.parallel import (
        CONTEXT_AXIS,
        P,
        make_mesh,
        shard,
        unshard,
        zigzag_shard,
        zigzag_unshard,
    )
    from metal_flash_attention_tpu_torch.utils.tolerances import MIXED_TOL

    ra, zz = cs.ring_modules()
    shape = REHEARSE_RING if run.rehearse else RING_TRAIN
    b, (hq, hkv), d, seq = (shape["batch"], shape["heads"],
                            shape["head_dim"], shape["seq"])
    dev, n = run.dev, run.world
    dt = torch.float32 if run.rehearse else torch.bfloat16
    ctx = make_mesh(context=n, devices=dev.type)
    gen = torch.Generator(device=dev).manual_seed(SEED + 121)

    def randn(heads):
        return torch.randn((b, heads, seq, d), generator=gen,
                           device=dev).to(dt)
    q, k, v, do = randn(hq), randn(hkv), randn(hkv), randn(hq)
    spec = P(None, None, CONTEXT_AXIS)
    lse_spec = P(None, None, CONTEXT_AXIS)

    def ms(fn):
        if dev.type != "cuda":
            fn()
            return None
        fn()
        return max(run.gather(cs.event_ms(fn, RING_ITERS)))

    ref, ref_ms = None, {}
    if run.rank == 0:
        o, lse = fa.flash_attention_forward(q, k, v, causal=True)
        ref = (o, lse, *fb.flash_attention_backward(q, k, v, do, o, lse,
                                                    causal=True))
        if dev.type == "cuda":
            ref_ms = {"forward": cs.event_ms(
                lambda: fa.flash_attention_forward(q, k, v, causal=True),
                RING_ITERS), "backward": cs.event_ms(
                lambda: fb.flash_attention_backward(q, k, v, do, o, lse,
                                                    causal=True),
                RING_ITERS)}
        del o, lse
    readings, timings, faults, launches = {}, {}, {}, {}
    for kind in ("ring", "zigzag"):
        order, undo = ((lambda x: x, lambda x: x) if kind == "ring" else
                       (lambda x: zigzag_shard(x, n),
                        lambda x: zigzag_unshard(x, n)))
        ql, kl, vl, dol = (shard(order(x), spec, ctx) for x in (q, k, v, do))
        fwd, bwd, extra = ((ra.ring_attention_local,
                            ra.ring_attention_bwd_local, {"causal": True})
                           if kind == "ring" else
                           (zz.zigzag_fwd_local, zz.zigzag_bwd_local, {}))
        kw = dict(index=ctx.get_local_rank(CONTEXT_AXIS), n=n,
                  rotate=ra.ring_rotate(ctx), **extra)
        # Through the entry point, under autograd.
        fn = (ra.ring_attention(ctx, causal=True, return_residuals=True)
              if kind == "ring" else
              zz.zigzag_ring_attention(ctx, return_residuals=True))
        leaves = [x.detach().requires_grad_(True) for x in (ql, kl, vl)]
        fa.reset_launch_counts()
        fb.reset_launch_counts()
        o, lse = fn(*leaves)
        grads = torch.autograd.grad(o, leaves, dol)
        run.sync()
        launches[kind] = run.gather({c: x for c, x in {
            **fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}.items() if x})
        o, lse = o.detach(), lse.detach()
        got = [undo(unshard(x, spec, ctx)) for x in (o, *grads)]
        got.insert(1, undo(unshard(lse, lse_spec, ctx)))
        # The bodies alone, each call timed.
        timings[kind] = {
            "forward": ms(lambda: fwd(ql, kl, vl, **kw)),
            "backward": ms(lambda: bwd(ql, kl, vl, dol, o, lse, **kw))}
        fault = None
        if kind == "ring":
            held = dict(kw, rotate=cs.held_rotate(kw["rotate"],
                                                  2 * (n - 1)))
            fault = undo(unshard(bwd(ql, kl, vl, dol, o, lse, **held)[1],
                                 spec, ctx))
        if run.rank == 0:
            for i, name in enumerate(("o", "lse", "dq", "dk", "dv")):
                if name == "lse":
                    err = float((got[i] - ref[i]).abs().max())
                    r = {"max_abs_err": err, "ok": err <= MIXED_TOL.lse}
                else:
                    r = cs.closeness(got[i], ref[i])
                    r["ok"] = cs.within_limits(r)
                readings[f"{kind}.{name}"] = r
            if fault is not None:
                faults[f"{kind}.dk"] = cs.closeness(fault, ref[3])
        del ql, kl, vl, dol, leaves, o, lse, grads, got, fault
        run.reset_peak()
    calls = {"ring": [c + 1 for c in range(n)], "zigzag": [n + 2] * n}
    exact = dev.type != "cuda" or all(
        launches[kind][r].get(f"{op}{s}", 0) == calls[kind][r]
        for kind in launches for r in range(n)
        for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
        for s in ("", "_sm90"))
    ok = run.rank != 0 or (all(r["ok"] for r in readings.values()) and all(
        not cs.within_limits(f) for f in faults.values()))
    ok = run.gather(bool(ok))[0] and exact
    run.say("ring_train_checks", {
        "world_size": n, "shape": f"q [{b}, {hq}, {seq}, {d}], k/v [{b}, "
        f"{hkv}, {seq}, {d}] causal, {dt}, context {n}",
        "readings": readings, "planted_faults": faults,
        "ms_slowest_rank": timings, "one_card_ms": ref_ms,
        "launches_by_rank": launches, "launches_exact": exact,
        "limits": {"tile_rel_rms": cs.KERNEL_TILE_REL_RMS,
                   "lse_abs": MIXED_TOL.lse}, "ok": ok})
    if not ok:
        run.failures.append("ring_train_checks: the ring or zigzag disagrees "
                            "with one card, a fault went unseen, or a "
                            "launch count is off")


def cp_train(run: Run) -> None:
    """Llama-3-8B at full depth, data 1 x heads 2 x context 2 (the dry
    run's dp x tp x cp leg at 4 cards): the 2-layer gate at CP_REF_TOKENS
    with the ring's closing hop skipped as the planted fault, then steps
    on a CP_TRAIN_TOKENS-token row with remat."""
    from metal_flash_attention_tpu_torch.models import llama
    cfg = (llama.LlamaConfig.tiny(n_heads=8, n_kv_heads=4, n_layers=3)
           if run.rehearse else llama.LlamaConfig.llama3_8b())
    seq, ref_seq = (128, 64) if run.rehearse else (CP_TRAIN_TOKENS,
                                                   CP_REF_TOKENS)
    train_family(run, "cp_train", llama, cfg, CP_TRAIN_MESH, seq,
                 whole_then_cut(run, llama, cfg),
                 faults=("heads_input_sum_dropped",
                         "ring_closing_hop_skipped"),
                 ref_seq=ref_seq, remat=True)


def pp_train(run: Run) -> None:
    """Llama-3-8B's 32 layers over `world` stages (8 a stage at 4), bf16,
    PP_TRAIN["micro"] microbatches of one PP_TRAIN["tokens"]-token row of
    hidden states, one loss mean(out^2) of the last stage's output (as
    the JAX dry run's PP leg), SGD at PP_TRAIN_LR: first the same on a
    PP_TRAIN["ref_layers"]-layer cut (one layer a stage) against rank 0's
    sequential chain on one card, by the training gates; then the steps:
    seconds a step, each rank's peak memory and flash counts, and one
    step profiled on every rank (busy share beside the GPipe bubble (S -
    1) / (M + S - 1))."""
    import torch
    import torch.distributed as dist
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.parallel import (
        make_pipeline_mesh,
        pipeline,
        shard,
        stack_stage_params,
        stage_param_sharding,
        unshard,
    )
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    dev, n = run.dev, run.world
    cfg = (llama.LlamaConfig.tiny(n_layers=2 * n, dtype=torch.float32)
           if run.rehearse else llama.LlamaConfig.llama3_8b())
    tokens = 64 if run.rehearse else PP_TRAIN["tokens"]
    micro, ref_layers = PP_TRAIN["micro"], n
    mesh = make_pipeline_mesh(n, devices=dev.type)
    run.reset_peak()
    gen = torch.Generator(device=dev).manual_seed(SEED + 131)
    drawn = llama.init_params(cfg, gen, device=dev)
    check_ranks_agree(run, "pipeline weights", weight_checksum(drawn))
    full = drawn.pop("layers")
    del drawn
    x = torch.randn((micro, 1, tokens, cfg.dim), generator=gen,
                    device=dev).to(cfg.dtype)
    pos = torch.arange(tokens, device=dev)[None]
    cos, sin = llama.rope_frequencies(cfg, pos)

    def stage_fn(p, h):
        for layer in p:               # the stage's layers, a dict each
            h, _ = llama.attention_block(layer, h, cfg, cos, sin)
            h = llama.mlp_block(layer, h, cfg)
        return h

    def stage_block(layers, per_stage):
        """This rank's stage of ``layers``: its ``per_stage`` layers, each
        leaf with the leading stage dim.  A list of layers, not layers
        stacked: indexing a stacked leaf at every pipeline step would
        make its backward fill a whole stacked gradient each time."""
        stacked = stack_stage_params([layers[s * per_stage:
                                             (s + 1) * per_stage]
                                      for s in range(n)])
        return shard(stacked, stage_param_sharding(stacked, mesh), mesh)

    def loss_and_grads(tree, run_fn):
        leaves, rebuild = flatten(tree)
        work = [t.detach().requires_grad_(True) for t in leaves]
        loss = run_fn(rebuild(work)).float().pow(2).mean()
        return loss, list(torch.autograd.grad(loss, work))

    def piped(p):
        return pipeline(stage_fn, p, x, mesh=mesh)

    # The cut, one layer a stage, against one card's chain (rank 0).
    cut = stage_block(full[:ref_layers], 1)
    loss, grads = loss_and_grads(cut, piped)
    specs = spec_leaves(cut, stage_param_sharding(cut, mesh))
    # Each leaf [n, ...] over the stages: layer l's in row l.
    whole = [unshard(g, sp, mesh) for g, sp in zip(grads, specs)]
    reading = None
    if run.rank == 0:
        ref_loss, ref_grads = loss_and_grads(
            full[:ref_layers], lambda p: torch.stack([
                stage_fn(p, x[i]) for i in range(micro)]))
        got = [w[layer].float() for layer in range(ref_layers)
               for w in whole]
        reading = gate_reading(loss.item(), got, ref_loss.item(),
                               [g.float() for g in ref_grads])
        del ref_grads, got
    del cut, grads, whole
    local = stage_block(full, cfg.n_layers // n)
    del full
    blocks = sum(t.numel() * t.element_size() for t in flatten(local)[0])
    run.reset_peak()

    def step():
        nonlocal local
        loss, grads = loss_and_grads(local, piped)
        leaves, rebuild = flatten(local)
        with torch.no_grad():
            local = rebuild([(t.float() - PP_TRAIN_LR * g.float()).to(
                t.dtype) for t, g in zip(leaves, grads)])
        return loss.item()
    n_steps = micro + n - 1
    losses, seconds = [], []
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        run.sync()
        dist.barrier()
        t0 = time.perf_counter()
        losses.append(step())
        run.sync()
        seconds.append(time.perf_counter() - t0)
    launches = {k: c for k, c in {**fa.LAUNCH_COUNTS,
                                  **fb.LAUNCH_COUNTS}.items() if c}
    per_stage = cfg.n_layers // n
    want = {f"{op}{s}": n_steps * per_stage * TRAIN_STEPS
            for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
            for s in ("", "_sm90")}
    peak = run.peak()
    prof = {}
    if dev.type == "cuda":
        run.sync()
        dist.barrier()
        step_wall = []

        def aligned_step():
            with torch.profiler.record_function("align"):
                dist.barrier()
            t0 = time.perf_counter()
            step()
            run.sync()
            step_wall.append(time.perf_counter() - t0)
        prof = cs.profile_step(
            f"pp_train_profile_rank{run.rank}", aligned_step,
            dict(NCCL, flash_fwd="flash_fwd90_kernel",
                 flash_bwd_dq="flash_bwd_dq90_kernel",
                 flash_bwd_dkv="flash_bwd_dkv90_kernel"), dev,
            spans=("align",))
        by = prof["device_ms_by_family"]
        prof["device_ms"] -= by.get("align", 0.0)
        prof["wall_ms"] = step_wall[0] * 1e3
        prof["busy_share"] = prof["device_ms"] / max(prof["wall_ms"], 1e-9)
        prof["nccl_share"] = by.get("nccl", 0.0) / max(prof["device_ms"],
                                                       1e-9)
    per_rank = run.gather({
        "stage": run.rank, "losses": losses, "seconds_per_step": seconds,
        "blocks_bytes": blocks, "max_memory_allocated": peak,
        "launches": launches,
        "launches_exact": dev.type != "cuda" or launches == want,
        "step_device_ms": prof.get("device_ms"),
        "step_wall_ms": prof.get("wall_ms"),
        "busy_share": prof.get("busy_share"),
        "nccl_share": prof.get("nccl_share")})
    ok = run.gather(reading is None or reading["within_gates"])[0]
    # mean(out^2) of hidden states is no training objective: the steps
    # time the schedule, and their losses need only be finite.
    good = bool(np.isfinite(losses).all())
    run.say("pp_train", {
        "world_size": n, "stages": n, "layers_per_stage": per_stage,
        "config": cfg_line(cfg), "microbatches": micro,
        "microbatch": [1, tokens, cfg.dim], "lr": PP_TRAIN_LR,
        "pipeline_steps": n_steps, "bubble": (n - 1) / n_steps,
        "losses": losses,
        "seconds_per_step": [max(r["seconds_per_step"][i] for r in per_rank)
                             for i in range(TRAIN_STEPS)],
        "reference": {"layers": ref_layers, **(reading or {})},
        "gates": {"loss_abs": cs.TRAIN_LOSS_ABS,
                  "grad_rel_rms": cs.TRAIN_GRAD_REL_RMS},
        "note": "every stage computes in the bubble steps too (on zeros or "
                "a repeated microbatch, as the JAX pipeline does), so the "
                "bubble shows as wasted work, not as idle time",
        "per_rank": per_rank, "ok": ok})
    if not ok:
        run.failures.append("pp_train: the pipeline's cut leaves the "
                            "sequential chain past the training gates")
    if not good:
        run.failures.append(f"pp_train: a loss is not finite: {losses}")
    if not all(r["launches_exact"] for r in per_rank):
        run.failures.append(f"pp_train: flash launches {launches}, expected "
                            f"{want}")
    del local
    run.reset_peak()


def dryrun_f32(world: int, rank: int) -> int:
    """Each true-fp32 kernel's launches on a rank of the dry run's
    pipeline leg: every stage runs each of M + S - 1 steps, then the
    chain runs M microbatches through S stages (M = entry.PP_MICRO, S =
    min(4, world)); ranks from S on sit the leg out."""
    from metal_flash_attention_tpu_torch import entry

    m, s = entry.PP_MICRO, min(4, world)
    return m + s - 1 + m * s if rank < s else 0


def dryrun(run: Run) -> None:
    from metal_flash_attention_tpu_torch import entry
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    fa.reset_launch_counts()
    fb.reset_launch_counts()
    t0 = time.perf_counter()
    entry.dryrun_multichip(run.world,
                           device="cpu" if run.rehearse else None)
    run.sync()
    seconds = time.perf_counter() - t0
    launches = {k: c for k, c in {**fa.LAUNCH_COUNTS,
                                  **fb.LAUNCH_COUNTS}.items() if c}
    want = {f"{op}_f32": dryrun_f32(run.world, run.rank)
            for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
    # The plain versions run on the CPU: only the card counts launches.
    exact = run.rehearse or all(launches.get(k, 0) == n
                                for k, n in want.items())
    per_rank = run.gather({"launches": launches, "seconds": seconds,
                           "f32_expected": want, "f32_exact": exact})
    run.say("dryrun", {"world": run.world,
                       "mesh_dp_tp_cp": entry.mesh_split(run.world),
                       "ranks": per_rank})
    if not all(r["f32_exact"] for r in per_rank):
        run.failures.append(f"dryrun: float32 launches by rank "
                            f"{[r['launches'] for r in per_rank]}, "
                            f"expected {[r['f32_expected'] for r in per_rank]}")


def dropped_rank(sa, call):
    """``call()`` with rank 1's partial dropped from `_merge_partials`: a
    fault the limits must see (None with one rank)."""
    import torch.distributed as dist

    if dist.get_world_size() == 1:
        return None

    def make(merge):
        def run(o, lse, mesh, axis=sa.CONTEXT_AXIS):
            if dist.get_rank() == 1:
                lse = lse.new_full(lse.shape, float("-inf"))
                o = o.new_zeros(o.shape)
            return merge(o, lse, mesh, axis)
        return run
    with cs.planted(sa, "_merge_partials", make):
        return call()


def empty_rows(o, lse, local_lens) -> dict:
    """The rows of local length 0 must give o = 0 and lse = -inf."""
    import torch
    rows = (local_lens == 0).nonzero().flatten().tolist()
    good = all(bool((o[r] == 0).all()) and bool(torch.isneginf(lse[r]).all())
               for r in rows)
    return {"rows": len(rows), "ok": good}


def rank_main(rank, world, store, phases, card, rehearse) -> None:
    import torch
    import torch.distributed as dist

    if rehearse:
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank)
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "gloo" if rehearse else "nccl",
        init_method="file://" + os.path.join(store, "pg"), rank=rank,
        world_size=world, timeout=datetime.timedelta(minutes=10))
    try:
        run = Run(rank, world, dev, card, rehearse)
        for name in phases:
            t0 = time.perf_counter()
            with (contextlib.nullcontext() if name in TRAINING
                  else torch.inference_mode()):
                globals()[name](run)
            dist.barrier()
            if rank == 0:
                print(f"phase {name}: {time.perf_counter() - t0:.2f} s",
                      flush=True)
        failed = sum(run.gather(run.failures), [])
        if failed:
            fail("; ".join(failed))
    finally:
        dist.destroy_process_group()


def cards() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(out.stdout.strip().splitlines())


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    if any(p not in PHASES for p in phases):
        print(f"tp_probe: phases are {PHASES}", file=sys.stderr)
        return 2
    if args.rehearse:
        card = "cpu rehearsal (no card)"
    else:
        if not torch.cuda.is_available() or \
                torch.cuda.device_count() < args.world:
            print(f"tp_probe: needs {args.world} CUDA cards", file=sys.stderr)
            return 1
        from metal_flash_attention_tpu_torch.native.build import (
            build_all,
            build_native,
        )
        t0 = time.perf_counter()
        build_all()
        build_native()
        print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
        card = cards()
    print(f"cards: {card}", flush=True)
    store = tempfile.mkdtemp(prefix="mfa_tp_probe_")
    cache = tempfile.mkdtemp(prefix="mfa_tp_cache_")
    os.environ["MFA_TORCH_CACHE_DIR"] = cache
    t0 = time.perf_counter()
    try:
        mp.spawn(rank_main, args=(args.world, store, phases, card,
                                  args.rehearse),
                 nprocs=args.world, join=True)
    finally:
        shutil.rmtree(store, ignore_errors=True)
        shutil.rmtree(cache, ignore_errors=True)
    print(json.dumps({"ok": True, "phases": phases, "world": args.world,
                      "seconds": time.perf_counter() - t0, "cards": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
