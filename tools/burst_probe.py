#!/usr/bin/env python3
"""The engine's decode by `step()` and by `step_burst(k)` on one NVIDIA
GPU, with the batch held fixed: what a decode step costs the host in each
mode, with no prefill, admission or retirement in the way.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 tools/burst_probe.py [--k 16] [--rounds 6]

Llama-3-8B at full width and depth (random bf16 weights from seed 0, as
in `chip_smoke.py`), the paged serve's first four prompts in the four
slots, prefilled by `step()`; then, for bf16 and then INT8 pools, each
round runs three modes back to back, in an order that turns each round:

- `step`: k `step()` calls (each reads its tokens back);
- `burst`: one `step_burst(k)`;
- `burst_sync_check`: one `step_burst(k)` whose device steps run under
  `torch.cuda.set_sync_debug_mode("error")`, as `chip_smoke.py` runs
  them.

Every mode emits k tokens a slot (budgets are far from spent and no stop
id is set), and the streams of the three modes continue one another, so
each round's decode steps run at the same lengths give or take 3k.  For
each mode: the host's wall ms a decode step (the mode's wall over k,
medians and spread over the rounds), and for `step` its enqueue ms (the
model step alone, without the read of the tokens).  Prints the card's
name and power limit and one JSON line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 0
SLOTS = 4
PAGE = 128


@contextlib.contextmanager
def sync_checked(serving):
    """`serving.paged_decode_burst` / `_q` run under sync debug mode
    "error" inside the block."""
    import torch

    names = ("paged_decode_burst", "paged_decode_burst_q")
    originals = {n: getattr(serving, n) for n in names}

    def wrap(fn):
        def run(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return run
    for n, fn in originals.items():
        setattr(serving, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(serving, n, fn)


@contextlib.contextmanager
def enqueue_timed(serving, spans: list):
    """Each call of `serving.paged_decode_step` / `_q` inside the block
    appends its host seconds to ``spans``."""
    names = ("paged_decode_step", "paged_decode_step_q")
    originals = {n: getattr(serving, n) for n in names}

    def wrap(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            spans.append(time.perf_counter() - t0)
            return out
        return run
    for n, fn in originals.items():
        setattr(serving, n, wrap(fn))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(serving, n, fn)


def spread(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs)), "n": len(xs)}


def probe(params, cfg, prompts, dev, kv_precision, k, rounds) -> dict:
    import torch
    from metal_flash_attention_tpu_torch import ServingEngine
    from metal_flash_attention_tpu_torch.models import serving

    budget = 3 * k * (rounds + 1) + 1
    max_seq = max(map(len, prompts)) + budget + 1
    eng = ServingEngine(params, cfg, max_batch=SLOTS,
                        num_pages=SLOTS * -(-max_seq // PAGE) + 1,
                        page_size=PAGE, max_seq=max_seq,
                        kv_precision=kv_precision)
    for p in prompts:
        eng.submit(p, budget)
    while any(r is None or r.next_token is None for r in eng._slots):
        eng.step()
    modes = ("step", "burst", "burst_sync_check")
    per_step = {m: [] for m in modes}
    enqueue = []

    def run(mode):
        before = [len(r.out) for r in eng._slots]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if mode == "step":
            with enqueue_timed(serving, enqueue):
                for _ in range(k):
                    eng.step()
        elif mode == "burst":
            eng.step_burst(k)
        else:
            with sync_checked(serving):
                eng.step_burst(k)
        torch.cuda.synchronize(dev)
        per_step[mode].append(1e3 * (time.perf_counter() - t0) / k)
        if [len(r.out) - n for r, n in zip(eng._slots, before)] != \
                [k] * len(before):
            raise RuntimeError(f"{mode} did not emit {k} tokens a slot")

    run("burst")                        # warm-up, not counted
    per_step["burst"].clear()
    for r in range(rounds):
        for mode in modes[r % 3:] + modes[:r % 3]:
            run(mode)
    out = {m: spread(v) for m, v in per_step.items()}
    out["step_enqueue"] = spread([1e3 * s for s in enqueue])
    out["burst_over_step_ms"] = (out["burst"]["median"]
                                 / out["step"]["median"])
    del eng
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("burst_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke
    from metal_flash_attention_tpu_torch.models import llama

    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=6)
    args = ap.parse_args()
    dev = torch.device("cuda", 0)
    cfg = llama.LlamaConfig.llama3_8b()
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in chip_smoke.PROMPT_LENS[:SLOTS]]
    result = {"config": f"llama3_8b, {cfg.n_layers} layers, bf16, "
                        f"{SLOTS} slots", "k": args.k,
              "rounds": args.rounds}
    for prec in (None, "int8"):
        result[prec or "bf16"] = probe(params, cfg, prompts, dev, prec,
                                       args.k, args.rounds)
    print(chip_smoke.card_line())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
