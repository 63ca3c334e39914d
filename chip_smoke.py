#!/usr/bin/env python3
"""Drive the PyTorch port's paged serving path on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build every kernel of `metal_flash_attention_tpu_torch/csrc/` with
   nvcc for sm_90a (one nvcc per source, started together);
2. make Llama-3-8B parameters at full width and depth (dim 4096, 32
   heads, 8 KV heads, head_dim 128, hidden 14336, vocab 32000, 32
   layers) in bf16 on the card, from a torch.Generator seeded with 0;
3. serve 6 requests (prompts of 200 to 1100 tokens, 32 new tokens each)
   through the port's `ServingEngine` (max_batch 4, page_size 128),
   with every kernel's launch count set to 0 just before and read just
   after; each kernel must have been launched;
4. check what came out: every request got its 32 tokens, all pages came
   back, and on a 2-layer cut of the same weights the paged path's
   logits agree with a dense reference (`ops.reference`) within bf16
   tolerance (relative rms error and max abs error, REF_*);
5. hold each kernel against its plain PyTorch version at the shapes the
   engine ran (decode at batch 4 with lengths up to ~1.1k, prefill with
   q_chunk 128 and the last partial chunk) at the bf16 tier, MIXED_TOL,
   and time both: device time per call from torch.profiler, wall time
   per call from CUDA events.

Output: a `serve` line, the card's name and power limit as nvidia-smi
gives them, a `kernels` JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np

PROMPT_LENS = (1100, 200, 645, 930, 415, 780)
MAX_NEW = 32
MAX_BATCH = 4
PAGE = 128
SEED = 0
REFERENCE_LAYERS = 2
REFERENCE_PROMPT = 300
# bf16 logits of random weights move ~1% (rms) for one-ulp changes of
# an attention output: the dense reference's own fp32-then-bf16
# attention and the plain paged version already differ by 0.6% rms and
# 0.033 max on the card, the kernel (P rounded to bf16 before PV) by
# 0.9% and 0.047.
REF_REL_RMS = 2e-2
REF_MAX_ABS = 1e-1


def fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed(fn, iters: int) -> tuple[float, float]:
    """(device ms, wall ms) per call.  Device time is the sum of the
    card's kernel durations under torch.profiler; wall time is CUDA
    events around back-to-back calls, launch gaps included."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    device_us = sum(e.device_time_total for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    if device_us <= 0:
        fail("the profiler saw no device time")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_us / 1e3 / iters, start.elapsed_time(end) / iters


def serve(params, cfg, prompts, dev):
    """The main path: the port's engine over every request; returns the
    engine, request ids, seconds and steps."""
    import torch
    from metal_flash_attention_tpu_torch import ServingEngine

    max_seq = max(map(len, prompts)) + MAX_NEW + 1
    num_pages = MAX_BATCH * -(-max_seq // PAGE) + 1
    eng = ServingEngine(params, cfg, max_batch=MAX_BATCH,
                        num_pages=num_pages, page_size=PAGE,
                        max_seq=max_seq)
    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    steps = 0
    while not eng.idle:
        eng.step()
        steps += 1
        if steps > 10_000:
            fail("engine did not drain")
    torch.cuda.synchronize(dev)
    return eng, rids, time.perf_counter() - t0, steps, num_pages


def reference_check(params, cfg, dev) -> tuple[float, float]:
    """Logits of the paged path (kernels) against a dense forward with
    `attention_reference`, on a 2-layer cut of the weights; returns the
    relative rms error and the max abs error."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama, serving
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )

    cut = dict(params, layers=params["layers"][:REFERENCE_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=REFERENCE_LAYERS)
    rng = np.random.default_rng(SEED + 1)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, REFERENCE_PROMPT)),
        device=dev)
    cache = serving.init_paged_model_cache(ccfg, 1, REFERENCE_PROMPT,
                                           page_size=PAGE, device=dev)
    for i in range(0, REFERENCE_PROMPT, PAGE):
        logits, cache = serving.paged_chunk_step(
            cut, tokens[:, i:i + PAGE], ccfg, cache)

    pos = torch.arange(REFERENCE_PROMPT, device=dev)[None]
    cos, sin = llama.rope_frequencies(ccfg, pos)
    x = cut["embed"][tokens].to(ccfg.dtype)
    for layer in cut["layers"]:
        q, k, v = serving._layer_qkv(layer, x, ccfg, cos, sin)
        o = attention_reference(q, k, v, causal=True).to(ccfg.dtype)
        x = x + (o.transpose(1, 2).reshape(1, REFERENCE_PROMPT, -1)
                 @ layer["wo"]).to(x.dtype)
        x = llama.mlp_block(layer, x, ccfg)
    x = llama.rms_norm(x, cut["final_norm"], ccfg.norm_eps)
    ref = (x @ cut["lm_head"]).float()[:, -logits.shape[1]:]
    if not torch.isfinite(logits).all():
        fail("paged path gave non-finite logits")
    err = logits - ref
    return (float(err.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()),
            float(err.abs().max()))


def kernel_checks(dev, launches) -> list[dict]:
    """Each kernel against its plain version at the engine's shapes."""
    import torch
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    kvh, qh, d = 8, 32, 128

    def pools(lengths):
        max_pages = -(-max(lengths) // PAGE)
        num_pages = len(lengths) * max_pages + 1
        shape = (num_pages, kvh, PAGE, d)
        k = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        v = torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)
        perm = torch.randperm(num_pages - 1, generator=gen,
                              device=dev).to(torch.int32) + 1
        table = perm.reshape(len(lengths), max_pages)
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        return pa.PagedKVCache(k, v, table, lens)

    def compare(fn, q, cache):
        o, lse = fn(q, cache, return_residuals=True)
        q4 = q if q.dim() == 4 else q[:, :, None]
        po, plse = pa._paged_attention_plain(q4, cache, scale=d ** -0.5,
                                             window_size=None)
        return (max_abs_err(o, po.reshape(o.shape)),
                max_abs_err(lse, plse.reshape(lse.shape)))

    results = []
    # Decode: batch 4 at the lengths the engine's longest requests reach.
    dec = pools([n + MAX_NEW for n in PROMPT_LENS[:MAX_BATCH]])
    qd = torch.randn((MAX_BATCH, qh, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    # Prefill: one sequence, a full 128-token chunk at 1024 tokens and
    # the final 76-token chunk at 1100.
    pre = pools([1024])
    qp = torch.randn((1, qh, PAGE, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    pre_tail = pools([1100])
    qt = torch.randn((1, qh, 1100 - 1024, d), generator=gen,
                     device=dev).to(torch.bfloat16)
    shapes = {
        "paged_decode": (pa.paged_decode, [(qd, dec)],
                         "q [4, 32, 128], lengths %s" % (
                             dec.lengths.tolist(),)),
        "paged_prefill": (pa.paged_prefill, [(qp, pre), (qt, pre_tail)],
                          "q [1, 32, 128, 128] at length 1024; "
                          "q [1, 32, 76, 128] at length 1100"),
    }
    for name, (fn, cases, shape) in shapes.items():
        errs = [compare(fn, q, c) for q, c in cases]
        o_err = max(e[0] for e in errs)
        lse_err = max(e[1] for e in errs)
        q, c = cases[0]
        q4 = q if q.dim() == 4 else q[:, :, None]
        ms, wall_ms = timed(lambda: fn(q, c), 50)
        plain_ms, plain_wall_ms = timed(lambda: pa._paged_attention_plain(
            q4, c, scale=d ** -0.5, window_size=None), 20)
        if o_err > MIXED_TOL.o or lse_err > MIXED_TOL.lse:
            fail(f"{name} disagrees with its plain version: o {o_err}, "
                 f"lse {lse_err}")
        results.append({
            "name": name, "route": "cuda",
            "source": "metal_flash_attention_tpu_torch/csrc/"
                      "paged_attention.cu",
            "replaces": "metal_flash_attention_tpu/ops/"
                        "paged_attention.py:183",
            "launches": launches[name], "max_abs_err": o_err,
            "lse_max_abs_err": lse_err,
            "tol": {"o": MIXED_TOL.o, "lse": MIXED_TOL.lse},
            "ms": ms, "plain_ms": plain_ms, "wall_ms": wall_ms,
            "plain_wall_ms": plain_wall_ms, "shape": shape})
    return results


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.native.build import build_all
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    libs = build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s",
          flush=True)

    cfg = llama.LlamaConfig.llama3_8b()
    t0 = time.perf_counter()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize(dev)
    print(f"params: llama3_8b, {cfg.n_layers} layers (full depth), bf16, "
          f"{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in PROMPT_LENS]
    # Warm-up request (library load, cuBLAS handles); not counted.
    serve(params, cfg, [prompts[1][:64]], dev)

    pa.reset_launch_counts()
    eng, rids, secs, steps, num_pages = serve(params, cfg, prompts, dev)
    launches = dict(pa.LAUNCH_COUNTS)
    for name, n in launches.items():
        if n == 0:
            fail(f"kernel {name} was not launched on the main path")
    for rid, p in zip(rids, prompts):
        out = eng.result(rid)
        if len(out) != len(p) + MAX_NEW:
            fail(f"request {rid} returned {len(out)} tokens")
        if not ((out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"request {rid} emitted a token outside the vocabulary")
    if eng.alloc.free_pages != num_pages - 1:
        fail(f"pages leaked: {eng.alloc.free_pages} of {num_pages - 1} free")
    card = card_line()
    tokens = MAX_NEW * len(prompts)
    print("serve: " + json.dumps({
        "requests": len(prompts), "prompt_tokens": int(sum(PROMPT_LENS)),
        "new_tokens": tokens, "seconds": secs, "steps": steps,
        "new_tokens_per_s": tokens / secs, "launches": launches,
        "card": card}), flush=True)

    rel_rms, max_err = reference_check(params, cfg, dev)
    print(f"reference: {REFERENCE_LAYERS}-layer cut, {REFERENCE_PROMPT}-token "
          f"prompt, paged logits vs dense attention_reference: relative "
          f"rms err {rel_rms:.5f} (tol {REF_REL_RMS}), max abs err "
          f"{max_err:.5f} (tol {REF_MAX_ABS})", flush=True)
    if not (rel_rms <= REF_REL_RMS and max_err <= REF_MAX_ABS):
        fail("paged path disagrees with the dense reference")

    kernels = kernel_checks(dev, launches)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
