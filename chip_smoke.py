#!/usr/bin/env python3
"""Drive the PyTorch port's paged serving (bf16 and quantized KV, by
step and by burst, greedy and sampled), dense serving and training
paths, and its standalone ops (quantized GEMM, softmax), on one NVIDIA
GPU.

Run from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build every kernel of `metal_flash_attention_tpu_torch/csrc/` with
   nvcc for sm_90a (one nvcc per source, started together);
2. serve: make Llama-3-8B parameters at full width and depth (dim 4096,
   32 heads, 8 KV heads, head_dim 128, hidden 14336, vocab 32000, 32
   layers) in bf16 on the card, from a torch.Generator seeded with 0,
   and serve 6 requests (prompts of 200 to 1100 tokens, 32 new tokens
   each) through the port's `ServingEngine` (max_batch 4, page_size
   128), with the paged kernels' launch counts set to 0 just before and
   read just after; each must have been launched, every launch on its
   Hopper kernel (`paged_decode_sm90`, `paged_prefill_sm90` equal to
   `paged_decode`, `paged_prefill`);
3. check the serve: every request got its 32 tokens, all pages came
   back, and on a 2-layer cut of the same weights the paged path's
   logits agree with a dense reference (`ops.reference`) within bf16
   tolerance (REF_*);
4. hold both paged kernels against their plain version at the shapes the
   engine ran (by the worst relative rms error of any 64-row tile,
   KERNEL_TILE_REL_RMS; lse at MIXED_TOL), each with a planted fault that
   the limit must see (decode: one sequence without its last 64-key
   tile; prefill: the last 64 queries of the last head without their
   diagonal key tile); time each (median and min-max of GEMM_REPEATS
   profiled loops) cold, over a rotation of distinct pools whose reads
   add up to PAGED_COLD_L2_MULTIPLE times the 50 MB L2 (a serve's 32
   layers each have their own pools), and warm, on one pool; then free
   the engine;
4b. quant_serve: the same 6 requests through the engine with INT8 pools
   (`kv_precision`, QUANT_SERVE_PRECISION) at full width and depth, every
   paged, decode and forward launch count set to 0 just before and read
   just after and held to exact counts, all on the Hopper kernels: per
   layer, a chunk step is one wide paged decode over the quantized prefix
   (the chunk folded into the heads, more rows than one decode fragment:
   the prefill kernel with q_chunk 1) and one `flash_fwd`, a decode step
   one quantized paged decode and one bf16 tail `flash_decode`; its new
   tokens/s, peak memory and pool bytes beside the bf16 serve's, from
   this run; quant_reference: on a 2-layer cut, the quantized chunk and
   decode steps' logits in INT8, FP8-E4M3 and NF4 (a page flushed while
   decoding) against plain float32 attention over the dequantized pages
   and the tail (QUANT_REF_LIMITS, between the sound readings and those
   of a planted fault: each row's first page lost);
4c. burst_serve: the same 6 requests drained by the engine's `step()` and
   by `step_burst(BURST_K)` (16 decode steps between two host reads),
   over bf16 and then INT8 pools, at full width and depth, greedy; every
   launch count set to 0 just before each run and read just after, and
   held exact (each burst step a decode step: per layer one
   `paged_decode`, or one quantized `paged_decode` and one tail
   `flash_decode`, all on the Hopper kernels; the steps that fell back to
   `step()` as before); each burst's device steps (16, or the largest
   budget left if fewer) under `torch.cuda.set_sync_debug_mode("error")`,
   so any synchronising call inside fails the run (the burst's uploads
   at entry and its one read after lie outside); the runs go step, burst,
   burst, step, and the burst streams must equal the step streams.
   Then a sampled serve (temperature 0.8, top_k 50, top_p 0.95, engine
   seed SAMPLE_SEED) through both, streams equal, the first request's
   stream the same when it runs alone, at least one stream unlike the
   greedy one, every token in the vocabulary.  Printed: each run's new
   tokens/s, bursts and steps that fell back, the card's ms (CUDA events)
   against the host's enqueue ms per burst, and each `step()` decode
   step's wall ms (its read of the tokens included) against the host's
   ms to enqueue it;
5. dense_serve: greedy `models.serving.generate` on the same full-depth
   weights, a batch of 8 random prompts of 8,160 tokens (seed 0), 32 new
   tokens each, a cache of 8,192 positions (Llama-3's context): one
   prefill through the fused forward, then 31 decode steps through
   `flash_decode`.  The two kernels' launch counts are set to 0 just
   before and read just after: `flash_fwd` must run 32 times (once per
   layer), every one on the sm90 kernel (`flash_fwd_sm90` 32 too), and
   `flash_decode` 32 x 31 = 992 times, every one on the Hopper kernel
   (`flash_decode_sm90` 992 too); every new token must
   lie in the vocabulary.  That run is the bare `generate`: its
   seconds, new tokens per second, peak memory and nvidia-smi's clock
   and power samples.  A second run of the same call, with CUDA events
   recorded around `prefill` and each `decode_step` and no synchronise
   inside, splits the time: the card's milliseconds for the prefill and
   for each decode step, and the host's milliseconds to enqueue each; one
   more decode step at the end of the context runs under torch.profiler
   (`dense_profile:`);
6. decode_reference: on a 2-layer cut of the same weights, batch 2, a
   300-token prompt and 4 decode steps: the logits of `prefill` and
   each `decode_step` against a full recompute through the port's
   blocks with `ops.reference.attention_reference` (REF_*);
   quant_gemm: layer 0's MLP weights (w_gate, w_up [4096, 14336],
   w_down [14336, 4096]) quantized per channel (`quantize_matrix`,
   contract_axis 0) in INT8, FP8-E4M3, FP8-E5M2 and NF4, and the SwiGLU
   block run through `gemm` on bf16 activations at 8,192 tokens (a
   prefill) and at 8 (the dense serve's decode batch), with the `gemm`
   launch count set to 0 just before and read just after (exactly
   4 x 3 x 2 = 24, every one on the sm90 route: `gemm_sm90` also 24);
   each block's relative error against the unquantized bf16 block
   (reported, not limited); each product's time (median, min and max of
   GEMM_REPEATS profiled loops), bound and the library time
   (torch.matmul on the bf16 weight); gemm_checks: the kernel against
   `_gemm_plain` on every precision at T = 8192 on w_gate and at T = 8
   on w_down, and dense bf16 4096^3 with backend="pallas" (each launch
   on the sm90 route), by the worst relative rms error of any 64 x 128
   output tile (KERNEL_TILE_REL_RMS), each with a planted fault (one
   tile without one GEMM_K_STEP-deep K step) that the limit must see;
   then free the weights;
7. decode_checks: the decode kernel against its plain version at the
   generate shape (q [8, 32, 128], k/v [8, 8, 8192, 128], ragged
   lengths DECODE_LENS), each (sequence, head) row a tile of its own
   (KERNEL_TILE_REL_RMS, lse at MIXED_TOL), with a planted fault (one
   row run 64 keys short: its last key tile dropped) that the limit
   must see; and at the sink shape of the JAX package's sink benchmark
   (window 1024, sink 4, full lengths): both partials of `sink_decode`
   (the strided slice of the first rows; kv_starts with max_span) and
   the merged output.  Then time the kernel and SDPA with a length mask
   (a yardstick that the port never calls) at ragged and full lengths
   (median and min-max of GEMM_REPEATS profiled loops), `sink_decode`
   and the plain version; quant_kernel_checks: every quantized kernel
   variant (the paged decode at the serve's decode shape, the wide decode
   of a folded 128-token chunk against 1,024 tokens, the paged prefill at
   q [1, 32, 128, 128], each at page 128 and page 8, and `flash_decode`
   at the generate shape) in INT8, FP8-E4M3, FP8-E5M2 and NF4 against
   its plain version by the worst tile, with planted faults the limit
   must see (one page's K scale replaced by its neighbour's, one (sequence,
   head)'s for the dense cache; for NF4, K's nibble planes swapped); each
   variant timed (median and min-max of 5 loops, the paged ones cold),
   beside its bytes bound (payload, scales, q, o and lse) and the bf16
   kernel's time at the same shape;
8. train: Llama-3-8B widths cut to 4 layers (at full depth the bf16
   weights, their float32 shadow and AdamW's two float32 moments come
   to about 101 GB, more than the card's 80 GB; 4 layers need about
   30 GB plus activations), one sequence of 8,193 tokens (the model
   sees 8,192, Llama-3's context), 4 AdamW steps on the same batch
   through `models.optim.make_train_step` with its defaults (optax's:
   lr 1e-4, weight decay 1e-4) over `models.llama.loss_fn` (fused
   cross-entropy) with the flash-attention launch counts set to 0 just
   before and read just after: each of the three kernels must run 4
   times a step (once per layer), every one on the sm90 kernels
   (`flash_fwd_sm90`, `flash_bwd_dq_sm90`, `flash_bwd_dkv_sm90` 4 times
   a step too), every loss must be finite and the
   last below the first.  nvidia-smi samples the card's clock and power
   during the steps, and one more step runs under torch.profiler
   (`train_profile:`: device time by kernel family, busy share);
9. train_reference: on a 2-layer cut of the trained weights at 2,048
   tokens, the loss and every parameter gradient of `llama.loss_fn`
   (the kernels) against a loss built here from the port's blocks with
   the plain attention (`ops.reference.attention_reference`) under
   torch autograd (TRAIN_*); then the same reading twice more with a
   fault planted in the kernel path (dK/dV losing one q head of each
   group; the forward's scale 1/d), each of which the limits must see;
10. hold the three flash-attention kernels against their plain versions
   at the training shape (q [1, 32, 8192, 128], k/v [1, 8, 8192, 128],
   causal; the forward also at the dense prefill's shape, q [8, 32,
   8160, 128] causal, on its first and last sequence, and at q_len 1000
   against kv_len 1536 with a window of 512) by the worst relative rms
   error of any 64-row tile of one head (KERNEL_TILE_REL_RMS), with a
   planted one-tile fault for each output that the tile limit must see
   (at the prefill shape in the half-full last query tile); the plain
   versions run one kv head at a time where their float32 scores would
   not fit otherwise.  Then time each kernel, its plain
   version and, where one PyTorch call computes the same function, that
   call (`scaled_dot_product_attention`; a yardstick that the port
   never calls); the forward and SDPA at the training and the prefill
   shapes, the backward pair and SDPA's backward at the training shape,
   as the median and min-max of GEMM_REPEATS profiled loops, with
   nvidia-smi's clock and power samples around the kernels' loops;
11. softmax_checks: `scaled_softmax` (default scale) and
   `derivative_softmax` (scale 0.5, on P from it and a random dP) on
   scores [1, 32, 8192, 8192] bf16 (Llama-3-8B's heads at the training
   path's 8,192 tokens), launch counts set to 0 just before and read
   just after; each against its plain version one head at a time by the
   worst relative rms error of any 64-row tile (KERNEL_TILE_REL_RMS),
   with a planted fault (one tile's rows without their last 64 columns,
   in the sums as in the output); then their times, bounds, the plain
   versions' (one head at a time) and the library calls'
   (`torch.softmax`, `torch._softmax_backward_data`, at scale 1.0).

Every kernel's `bound_ms` is the least time the card could take for the
same work: the larger of the bytes it must move (each input read once,
each output written once; a quantized weight's payload and scales) over
3.35 TB/s and the operations this run's data needs (visible query-key
pairs only) over 989 TFLOP/s in bf16.

Output: `serve`, `reference`, `quant_serve`, `burst_serve`,
`quant_reference`,
`dense_serve`, `dense_profile`, `decode_reference`, `quant_gemm`,
`gemm_checks`, `decode_checks`, `quant_kernel_checks`, `train`,
`train_profile`, `train_reference`, `flash_checks` and `softmax_checks`
lines, a `phases` line (each phase's seconds), the card's name and power
limit as nvidia-smi gives them, a `kernels` JSON line, and as the last
line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import itertools
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

# Dense serving: `serving.generate` at full width and depth, batch 8,
# prompts of 8,160 tokens, 32 new tokens, a cache of 8,192 positions
# (Llama-3's context).
DENSE_BATCH = 8
DENSE_PROMPT = 8160
DENSE_NEW = 32
DENSE_MAX_SEQ = 8192
DECODE_REF_BATCH = 2
DECODE_REF_STEPS = 4
# The decode kernel's check shape: the generate shape with ragged
# lengths (an empty-ish row, rows off the 64-key tile, full rows), and
# the sink shape of the JAX package's sink benchmark (window, sink).
DECODE_LENS = (8192, 8191, 7000, 4097, 2048, 129, 64, 1)
SINK_WINDOW, SINK = 1024, 4

TRAIN_LAYERS = 4
TRAIN_TOKENS = 8192
TRAIN_STEPS = 4
TRAIN_REF_LAYERS = 2
TRAIN_REF_TOKENS = 2048
# The forward's second check shape: q_len != kv_len with a window
# (q_len, kv_len, window).
WINDOW_CASE = (1000, 1536, 512)
# The kernel loss against the hand-built plain-attention loss, and the
# worst relative rms error over every parameter gradient.  The two paths
# round bf16 activations and gradients at other places (the kernels
# round P and dS to bf16 before their products); on an H100 they differ
# by 3.5e-4 in the loss and by 1.6% (worst tensor) in the gradients.
# Each run also plants two faults in the kernel path (`train_reference`)
# and fails unless these limits see both: dK/dV losing one q head of
# each group reads 56% in the worst gradient (the loss, a forward
# quantity, does not move); the forward's scale at 1/d reads 1.1e-2 in
# the loss and 358% in a gradient.
TRAIN_LOSS_ABS = 2e-3
TRAIN_GRAD_REL_RMS = 4e-2
# Each kernel's outputs (o; dq, dk, dv) against its plain version, on the
# reference's own scale (`closeness`): the worst relative rms error of
# any TILE_ROWS-row tile of one head, which also bounds the error over
# the whole tensor.  Sound kernels read 0.23-0.29% on an H100 (bf16
# rounding of P, dS and the outputs); each flash check also plants a
# one-tile fault in the kernel's output, read at 6.2-9.0%, and fails
# unless the limit sees it.
TILE_ROWS = 64
KERNEL_TILE_REL_RMS = 1.5e-2

# The standalone ops (slice 4).  A weight-quantized Llama-3-8B MLP at a
# prefill's 8,192 tokens and at the dense serve's decode batch of 8; each
# weight of layer 0 quantized per channel in each precision.  The GEMM
# kernel is held against its plain version by the worst relative rms
# error of any GEMM_TILE output tile (64 rows x 128 columns, fewer rows
# where T < 64), the softmax kernels by that of any TILE_ROWS-row tile of
# one head; the limit is KERNEL_TILE_REL_RMS, with a planted fault in
# every check (a GEMM tile without one K step of the sm90 route, 64
# deep, about sqrt(64 / K); a softmax tile whose rows lose their last 64
# columns, about sqrt(64 / 8192)).  The GEMM's times are the median and
# spread of GEMM_REPEATS profiled loops.
QUANT_PRECISIONS = ("int8", "fp8_e4m3", "fp8_e5m2", "nf4")
MLP_TOKENS = (8192, 8)
MLP_WEIGHTS = ("w_gate", "w_up", "w_down")
GEMM_TILE = (64, 128)
GEMM_K_STEP = 64
GEMM_REPEATS = 5
# Idle time between two of them on the card, and the kernel that marks
# each one's end (`torch.cuda._sleep`'s, a few hundred nanoseconds).
LOOP_GAP_S = 0.01
LOOP_MARK, LOOP_MARK_CYCLES = "spin_kernel", 1000
# Profiler sessions `timed` runs before it gives up on one that recorded
# no kernel (a session can lose its events).
PROFILE_ATTEMPTS = 3
DENSE_GEMM = 4096
SOFTMAX_SCALE_DERIVATIVE = 0.5
# The paged kernels are timed cold, as a serve finds them (each of its 32
# layers has its own pools, together far more than the L2): over a
# rotation of distinct pools whose reads add up to this many times the
# H100's 50 MB L2.
L2_BYTES = 50 * 2**20
PAGED_COLD_L2_MULTIPLE = 2

# Quantized-KV serving (slice 9).  quant_serve: the paged serve's
# requests through the engine with QUANT_SERVE_PRECISION pools, full width
# and depth.  quant_reference: a 2-layer cut, QUANT_REF_BATCH sequences of
# QUANT_REF_PROMPT tokens in page-sized chunks (the second leaves a tail
# two tokens short of a page) and QUANT_REF_STEPS decode steps (the tail
# fills and flushes), logits against plain float32 attention over the
# dequantized pages and the tail, with a limit per precision between the
# sound readings and a planted fault's (each row's first page lost);
# quant_kernel_checks: every quantized kernel variant in every precision.
QUANT_SERVE_PRECISION = "int8"
QUANT_REF_PRECISIONS = ("int8", "fp8_e4m3", "nf4")
QUANT_REF_BATCH = 2
QUANT_REF_PROMPT = 254
QUANT_REF_STEPS = 4
QUANT_REF_LIMITS = {p: {"rel_rms": REF_REL_RMS, "max_abs": REF_MAX_ABS}
                    for p in QUANT_REF_PRECISIONS}

# Burst serving (slice 10).  burst_serve: the paged serve's requests
# drained by `step()` and by `step_burst(BURST_K)` over bf16 and
# QUANT_SERVE_PRECISION pools, then sampled with SAMPLING (the engine
# seeded with SAMPLE_SEED).
BURST_K = 16
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
SAMPLE_SEED = 0

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
KV_HEADS, Q_HEADS, HEAD_DIM = 8, 32, 128


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
    events around back-to-back calls, launch gaps included.  A profiler
    session can lose all of its events: one that records no kernel is
    run again, PROFILE_ATTEMPTS sessions at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        device_us = sum(e.device_time_total for e in device_kernels(prof))
        if device_us > 0:
            break
    else:
        fail(f"the profiler saw no device time in {PROFILE_ATTEMPTS} "
             "sessions")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return device_us / 1e3 / iters, start.elapsed_time(end) / iters


def timed_spread(fn, iters: int, repeats: int = GEMM_REPEATS) -> dict:
    """`timed` over `repeats` loops of `iters` calls in one profiler
    session (many sessions in one process lose the card's events), after
    one lead-in loop that is not counted (a session may lose its first
    events), the loops kept apart on the card by LOOP_GAP_S of idle time
    and told apart by a marker kernel launched after each (a gap in time
    also opens where the host stalls, and the profiler may drop a
    kernel's event), or, where the profiler dropped a marker's event, by
    those gaps: the median device ms a call and its min and max over the
    loops, and the wall ms a call over all of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats + 1):
            for _ in range(iters):
                fn()
            torch.cuda._sleep(LOOP_MARK_CYCLES)
            torch.cuda.synchronize()
            time.sleep(LOOP_GAP_S)
    events = sorted(device_kernels(prof), key=lambda e: e.time_range.start)

    def last_loops(loops, trailing):
        """The last `repeats` loops, or None unless the split found them
        all (the lead-in may be lost), nothing after the last, and no two
        loops run together (each holds about as many kernels as the
        others)."""
        if loops and not loops[0]:
            loops = loops[1:]
        if trailing or len(loops) not in (repeats, repeats + 1):
            return None
        loops = loops[-repeats:]
        median = float(np.median([len(x) for x in loops]))
        if not all(0.5 * median < len(x) < 1.5 * median for x in loops):
            return None
        return loops

    loops, loop = [], []
    for e in events:
        if LOOP_MARK in e.name:
            loops.append(loop)
            loop = []
        else:
            loop.append(e)
    marked = len(loops)
    loops = last_loops(loops, loop)
    if loops is None:
        # The profiler dropped a marker's event: split by the idle gaps
        # between the loops instead.
        loops, loop, last_end = [], [], None
        for e in events:
            if LOOP_MARK in e.name:
                continue
            if last_end is not None and \
                    e.time_range.start - last_end > LOOP_GAP_S * 1e6 / 2:
                loops.append(loop)
                loop = []
            loop.append(e)
            last_end = e.time_range.end
        loops.append(loop)
        gaps = len(loops)
        loops = last_loops(loops, [])
        if loops is None:
            fail(f"the profiler's kernels fall into {marked} marked loops "
                 f"and {gaps} loops by their gaps, not {repeats} (+ 1)")
    device = [sum(e.device_time_total for e in loop) / 1e3 / iters
              for loop in loops]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters * repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return {"ms": float(np.median(device)), "ms_min": min(device),
            "ms_max": max(device), "repeats": repeats,
            "wall_ms": start.elapsed_time(end) / (iters * repeats)}


class CardSampler:
    """nvidia-smi sampling the card's SM clock, power draw and
    temperature every 100 ms, from construction to `stop()`.  Used as a
    context manager, so that a phase that fails leaves no nvidia-smi
    running."""

    FIELDS = ("clocks.sm", "power.draw", "temperature.gpu")

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=" + ",".join(self.FIELDS),
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.communicate(timeout=30)

    def stop(self) -> dict:
        """{field: [min, median, max]} over the samples taken."""
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(x) for x in line.split(",")])
            except ValueError:
                continue
        if not rows:
            return {"samples": 0}
        cols = np.array(rows)
        return {"samples": len(rows), **{
            f: [float(cols[:, i].min()), float(np.median(cols[:, i])),
                float(cols[:, i].max())]
            for i, f in enumerate(self.FIELDS)}}


def device_kernels(prof) -> list:
    """The card's kernels in a profile, without the ranges that
    `record_function` annotations (such as the optimizer's step) also
    put on the device's timeline."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def closeness(got, ref, tile_rows: int = TILE_ROWS,
              tile_cols=None) -> dict:
    """A kernel's output against its plain version, on the reference's
    own scale: the relative rms error ||got - ref|| / ||ref|| over the
    tensor; the worst such ratio over its tiles of `tile_rows` rows (the
    second axis from the end: one head's rows) by `tile_cols` columns
    (None: whole rows), so that a fault confined to one tile cannot hide
    among the rest; and the max abs error."""
    import torch.nn.functional as F

    ref = ref.float()
    err = got.float() - ref

    def per_tile(x):
        x = x.pow(2)
        cols = tile_cols or x.shape[-1]
        x = F.pad(x, (0, -x.shape[-1] % cols, 0, -x.shape[-2] % tile_rows))
        return x.unflatten(-1, (-1, cols)).unflatten(
            -3, (-1, tile_rows)).sum(dim=(-1, -3))

    e2, r2 = per_tile(err), per_tile(ref)
    floor = 1e-12 * float(r2.mean()) + 1e-30
    return {"rel_rms": float((e2.sum() / r2.sum()).sqrt()),
            "tile_rel_rms": float((e2 / r2.clamp_min(floor)).sqrt().max()),
            "max_abs_err": float(err.abs().max())}


def within_limits(reading: dict) -> bool:
    return reading["tile_rel_rms"] <= KERNEL_TILE_REL_RMS


@contextlib.contextmanager
def planted(module, name: str, make):
    """`module.name` replaced by `make(original)` inside the block: a
    fault planted in the kernel path, to show that a check sees it."""
    original = getattr(module, name)
    setattr(module, name, make(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def lost_group_head(dkv):
    """flash_bwd_dkv summing 3 of each group's 4 q heads: a group loop
    that stops one head early."""
    def run(q, k, v, do, lse, d_term, **kw):
        g = q.shape[1] // k.shape[1]
        do, d_term = do.clone(), d_term.clone()
        do[:, g - 1::g] = 0
        d_term[:, g - 1::g] = 0
        return dkv(q, k, v, do, lse, d_term, **kw)
    return run


def unrooted_scale(fwd):
    """flash_fwd with the softmax scale 1/d instead of 1/sqrt(d); the
    backward keeps the right one."""
    def run(q, k, v, *, scale, **kw):
        return fwd(q, k, v, scale=scale ** 2, **kw)
    return run


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the two least times."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = n_bytes / PEAK_HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def visible_pairs(q_len: int, kv_len: int, causal: bool,
                  window) -> int:
    """Query-key pairs that attention with the port's rule (bottom-right
    causal, window of the last `window` keys) computes."""
    qpos = np.arange(q_len, dtype=np.int64) + (kv_len - q_len)
    hi = np.minimum(kv_len - 1, qpos) if causal else np.full_like(
        qpos, kv_len - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(qpos)
    return int(np.maximum(0, hi - lo + 1).sum())


def serve(params, cfg, prompts, dev, kv_precision=None, burst=0,
          sampling=None):
    """The serving path: the port's engine over every request (with
    ``kv_precision``, over quantized pools; ``sampling``: the requests'
    submit keywords, the engine seeded with SAMPLE_SEED), drained by
    `step()` or, with ``burst`` k, by `step_burst(k)`; returns the
    engine, request ids, seconds, steps (calls of step or step_burst)
    and pages."""
    import torch
    from metal_flash_attention_tpu_torch import ServingEngine

    max_seq = max(map(len, prompts)) + MAX_NEW + 1
    num_pages = MAX_BATCH * -(-max_seq // PAGE) + 1
    eng = ServingEngine(params, cfg, max_batch=MAX_BATCH,
                        num_pages=num_pages, page_size=PAGE,
                        max_seq=max_seq, kv_precision=kv_precision,
                        seed=SAMPLE_SEED)
    rids = [eng.submit(p, MAX_NEW, **(sampling or {})) for p in prompts]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    steps = 0
    while not eng.idle:
        eng.step_burst(burst) if burst else eng.step()
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

    ref = (plain_hidden(cut, tokens, ccfg) @ cut["lm_head"]).float()
    ref = ref[:, -logits.shape[1]:]
    if not torch.isfinite(logits).all():
        fail("paged path gave non-finite logits")
    err = logits - ref
    return (float(err.pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()),
            float(err.abs().max()))


def plain_hidden(params, tokens, cfg):
    """A dense forward built from the port's blocks with the plain
    attention (`attention_reference`, float32 softmax, differentiable):
    final-norm hidden states [batch, seq, dim]."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )

    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = llama.rope_frequencies(cfg, pos)
    x = params["embed"][tokens].to(cfg.dtype)
    for layer in params["layers"]:
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin)
        o = attention_reference(q, k, v, causal=True).to(cfg.dtype)
        x = x + (o.transpose(1, 2).reshape(b, s, -1)
                 @ layer["wo"]).to(x.dtype)
        x = llama.mlp_block(layer, x, cfg)
    return llama.rms_norm(x, params["final_norm"], cfg.norm_eps)


def paged_kernel_checks(dev, launches) -> list[dict]:
    """Each paged kernel against its plain version at the engine's
    shapes, with a planted fault for each mode that the tile limit must
    see; then each kernel's time, cold (over a rotation of distinct pools
    that together exceed the L2, as a serve's 32 layers of pools do) and
    warm (one pool), its plain version's, and its bound."""
    import torch
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    kvh, qh, d = KV_HEADS, Q_HEADS, HEAD_DIM
    scale = d ** -0.5

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

    def as4(q):
        return q if q.dim() == 4 else q[:, :, None]

    def plain(q, cache):
        po, plse = pa._paged_attention_plain(as4(q), cache, scale=scale,
                                             window_size=None)
        return po.reshape(q.shape), plse.reshape(q.shape[:-1])

    def work(q, cache):
        """(FLOPs, bytes) of one call: K/V of each sequence read once,
        q read and o (and lse) written once."""
        q4 = as4(q)
        chunk = q4.shape[2]
        lengths = cache.lengths.tolist()
        pairs = sum(visible_pairs(chunk, n, True, None) for n in lengths)
        kv_bytes = sum(lengths) * kvh * d * 2 * 2
        io_bytes = 2 * q4.numel() * 2 + q4[..., 0].numel() * 4
        return 4 * d * qh * pairs, kv_bytes + io_bytes

    def rotation(lengths, first):
        """`first` and more pools of the same lengths, until the bytes the
        calls read exceed PAGED_COLD_L2_MULTIPLE times the L2."""
        per_call = sum(lengths) * kvh * d * 2 * 2
        count = -(-PAGED_COLD_L2_MULTIPLE * L2_BYTES // per_call)
        return [first] + [pools(lengths) for _ in range(count - 1)]

    def cycling(fn, q, caches):
        turn = itertools.cycle(caches)
        return lambda: fn(q, next(turn))

    # Decode: batch 4 at the lengths the engine's longest requests reach.
    dec_lens = [n + MAX_NEW for n in PROMPT_LENS[:MAX_BATCH]]
    dec = pools(dec_lens)
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

    # Planted faults.  Decode: sequence 0 without its last 64-key tile (a
    # chunk that stops one tile early), through the kernel.  Prefill: the
    # last 64 queries of the last q head without their diagonal key tile
    # (keys 960 .. 1023).
    short = dec.lengths.clone()
    short[0] -= 64
    dec_fault = pa.paged_decode(qd, dec._replace(lengths=short))
    o_pre = pa.paged_prefill(qp, pre)
    pre_fault = o_pre.clone()
    k_seq, v_seq = (x[pre.page_table[0].long()].transpose(0, 1).reshape(
        1, kvh, -1, d) for x in (pre.k_pages, pre.v_pages))
    pre_fault[:, qh - 1:, PAGE - 64:] = attention_reference(
        qp[:, qh - 1:, PAGE - 64:], k_seq[:, kvh - 1:, :1024 - 64],
        v_seq[:, kvh - 1:, :1024 - 64], scale=scale).to(o_pre.dtype)
    del k_seq, v_seq

    results = []
    cases = {
        "paged_decode": (pa.paged_decode, [(qd, dec)], dec_fault,
                         "q [4, 32, 128], lengths %s" % dec_lens),
        "paged_prefill": (pa.paged_prefill, [(qp, pre), (qt, pre_tail)],
                          pre_fault, "q [1, 32, 128, 128] at length 1024 "
                          "(timed); q [1, 32, 76, 128] at length 1100"),
    }
    for name, (fn, calls, fault, shape) in cases.items():
        o_read, lse_err = None, 0.0
        for q, c in calls:
            o, lse = fn(q, c, return_residuals=True)
            po, plse = plain(q, c)
            r = closeness(o, po)
            if o_read is None:
                r["planted_fault"] = closeness(fault, po)
                o_read = r
            else:
                o_read[f"at_length_{int(c.lengths[0])}"] = r
                for key in ("rel_rms", "tile_rel_rms", "max_abs_err"):
                    o_read[key] = max(o_read[key], r[key])
            lse_err = max(lse_err, max_abs_err(lse, plse))
        if not within_limits(o_read) or lse_err > MIXED_TOL.lse:
            fail(f"{name} disagrees with its plain version: o {o_read}, "
                 f"lse {lse_err}")
        if within_limits(o_read["planted_fault"]):
            fail(f"the {name} check does not see a dropped key tile")
        q, c = calls[0]
        lengths = c.lengths.tolist()
        caches = rotation(lengths, c)
        cold = timed_spread(cycling(fn, q, caches), 4 * len(caches))
        warm = timed_spread(lambda: fn(q, c), 50)
        plain_ms, plain_wall_ms = timed(lambda: plain(q, c), 20)
        bound_ms, bound_by = bound(*work(q, c))
        results.append({
            "name": name, "route": "cuda",
            "source": "metal_flash_attention_tpu_torch/csrc/"
                      "paged_attention.cu",
            "core": "metal_flash_attention_tpu_torch/csrc/"
                    "decode_common.cuh",
            "replaces": "metal_flash_attention_tpu/ops/"
                        "paged_attention.py:183",
            "launches": launches[name],
            "launches_sm90": launches[f"{name}_sm90"],
            "max_abs_err": o_read["max_abs_err"],
            "o": o_read, "lse_max_abs_err": lse_err,
            "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                       "lse_abs": MIXED_TOL.lse},
            "ms": cold["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "share_of_bound": bound_ms / cold["ms"],
            "wall_ms": cold["wall_ms"], "spread": cold,
            "cold": {"pools": len(caches),
                     "bytes_read": len(caches) * work(q, c)[1],
                     "l2_bytes": L2_BYTES},
            "ms_warm": warm["ms"], "spread_warm": warm,
            "plain_wall_ms": plain_wall_ms, "shape": shape})
        del caches
    return results


def pool_bytes(*groups) -> int:
    return sum(nbytes(*g) for g in groups)


@contextlib.contextmanager
def counted_calls(module, names, counts: dict):
    """`module.<name>` for each name wrapped, inside the block, to append
    its first tokens argument's width (a chunk's positions; 1 for a
    decode step's [batch] tokens) to counts[name]."""
    originals = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def run(params, tokens, *args, **kwargs):
            counts[name].append(tokens.shape[1] if tokens.dim() == 2 else 1)
            return fn(params, tokens, *args, **kwargs)
        return run
    for n in names:
        counts[n] = []
        setattr(module, n, wrap(n, originals[n]))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(module, n, fn)


SERVE_STEPS = ("paged_chunk_step", "paged_decode_step",
               "paged_chunk_step_q", "paged_decode_step_q")


def expected_serve_launches(cfg, calls, prec) -> dict:
    """A serve's exact launch counts from its step calls (``calls``, as
    `counted_calls` keeps them), all on the Hopper kernels.  bf16 pools:
    a layer's chunk step is one `paged_prefill`, its decode step one
    `paged_decode`.  Quantized pools (``prec``): a layer's chunk step is
    one paged decode over the quantized prefix (`paged_decode_wide` when
    the chunk folded into the heads has more rows than one decode
    fragment) and one `flash_fwd`, its decode step one quantized
    `paged_decode` and one bf16 tail `flash_decode`."""
    from metal_flash_attention_tpu_torch.native.build import tile_defines

    layers, group = cfg.n_layers, cfg.n_heads // cfg.n_kv_heads
    if prec is None:
        return {f"{kernel}{s}": layers * len(calls[step])
                for kernel, step in (("paged_prefill", "paged_chunk_step"),
                                     ("paged_decode", "paged_decode_step"))
                for s in ("", "_sm90")}
    chunks = calls["paged_chunk_step_q"]
    wide = sum(group * kc > tile_defines()["MFA_DECODE_MAX_GROUP"]
               for kc in chunks)
    decode = layers * (len(calls["paged_decode_step_q"]) + len(chunks)
                       - wide)
    expected = {f"paged_decode{s}": decode for s in ("", "_sm90",
                                                     f"_{prec}")}
    expected.update({f"paged_decode_wide{s}": layers * wide
                     for s in ("", "_sm90", f"_{prec}")})
    expected.update({"flash_decode": layers * len(
        calls["paged_decode_step_q"]), "flash_fwd": layers * len(chunks)})
    expected["flash_decode_sm90"] = expected["flash_decode"]
    expected["flash_fwd_sm90"] = expected["flash_fwd"]
    return expected


def launch_errors(launches, expected) -> dict:
    """{kernel: (count, expected)} for every count that is not exact."""
    return {k: (n, expected.get(k, 0)) for k, n in launches.items()
            if n != expected.get(k, 0)}


def quant_serve(params, cfg, prompts, dev, card, bf16) -> dict:
    """The quantized-KV serving path: the paged serve's requests through
    the engine with QUANT_SERVE_PRECISION pools (full width and depth),
    every launch count of the paged, decode and forward kernels set to 0
    just before and read just after, and held to exact counts
    (`expected_serve_launches`).  Returns the launch counts."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    prec = QUANT_SERVE_PRECISION
    # Warm-up request (library load, cuBLAS handles); not counted.
    serve(params, cfg, [prompts[1][:64]], dev, kv_precision=prec)
    calls: dict = {}
    torch.cuda.reset_peak_memory_stats(dev)
    with counted_calls(serving, SERVE_STEPS, calls):
        for m in (pa, fd, fa):
            m.reset_launch_counts()
        eng, rids, secs, steps, num_pages = serve(params, cfg, prompts, dev,
                                                  kv_precision=prec)
        launches = {**pa.LAUNCH_COUNTS, **fd.LAUNCH_COUNTS,
                    **fa.LAUNCH_COUNTS}
    peak = torch.cuda.max_memory_allocated(dev)
    chunks = calls["paged_chunk_step_q"]
    expected = expected_serve_launches(cfg, calls, prec)
    wrong = launch_errors(launches, expected)
    if wrong or not expected["paged_decode"] or \
            not expected["paged_decode_wide"]:
        fail(f"quant_serve launched (count, expected) {wrong}")
    wide = expected["paged_decode_wide"] // cfg.n_layers
    for rid, p in zip(rids, prompts):
        out = eng.result(rid)
        if len(out) != len(p) + MAX_NEW:
            fail(f"quantized request {rid} returned {len(out)} tokens")
        if not ((out >= 0) & (out < cfg.vocab_size)).all():
            fail(f"quantized request {rid} emitted a token outside the "
                 "vocabulary")
    if eng.alloc.free_pages != num_pages - 1:
        fail(f"quantized serve leaked pages: {eng.alloc.free_pages} of "
             f"{num_pages - 1} free")
    qbytes = pool_bytes(eng._qk, eng._qv, eng._ks, eng._vs)
    tbytes = pool_bytes(eng._tail_k, eng._tail_v)
    tokens = MAX_NEW * len(prompts)
    print("quant_serve: " + json.dumps({
        "config": f"llama3_8b, {cfg.n_layers} layers (full depth), bf16, "
                  f"kv_precision {prec}",
        "requests": len(prompts), "prompt_tokens": int(sum(PROMPT_LENS)),
        "new_tokens": tokens, "seconds": secs, "steps": steps,
        "new_tokens_per_s": tokens / secs, "max_memory_allocated": peak,
        "pool_bytes": qbytes, "tail_bytes": tbytes,
        "chunk_steps": len(chunks), "wide_chunk_steps": wide,
        "decode_steps": len(calls["paged_decode_step_q"]),
        "launches": {k: n for k, n in launches.items() if n},
        "bf16_serve": bf16, "pool_bytes_over_bf16":
            (qbytes + tbytes) / bf16["pool_bytes"],
        "card": card}), flush=True)
    return launches


@contextlib.contextmanager
def watched_serve(serving, calls: dict, bursts: list, steps: list):
    """Inside the block, the engine's decode is watched:

    - each burst (`serving.paged_decode_burst` / `_q`) runs its device
      steps under `torch.cuda.set_sync_debug_mode("error")` (a
      synchronising call inside raises; the engine's uploads at entry and
      its one read after lie outside), between two CUDA events, with the
      host's seconds to enqueue them; ``bursts`` gets a dict a burst:
      n_steps, the decode step calls it made (from ``calls``, as
      `counted_calls` keeps them), the events, the host seconds, and the
      wall seconds of its `step_burst` call (uploads and read included);
    - each decode step of `step()` (`ServingEngine._decode_active`):
      ``steps`` gets its wall seconds (its read of the tokens included)
      and the host's seconds to enqueue its model step."""
    import torch
    from metal_flash_attention_tpu_torch.models import engine

    cls = engine.ServingEngine
    patched = {(serving, n): getattr(serving, n)
               for n in ("paged_decode_burst", "paged_decode_burst_q",
                         "paged_decode_step", "paged_decode_step_q")}
    patched.update({(cls, n): getattr(cls, n)
                    for n in ("step_burst", "_decode_active")})
    enqueue = []

    def decode_calls():
        return sum(len(calls.get(n, ())) for n in ("paged_decode_step",
                                                    "paged_decode_step_q"))

    def burst(fn):
        def run(*args, **kwargs):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            before = decode_calls()
            start.record()
            t0 = time.perf_counter()
            torch.cuda.set_sync_debug_mode("error")
            try:
                out = fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            host_s = time.perf_counter() - t0
            end.record()
            bursts.append({"n_steps": kwargs["n_steps"],
                           "decode_calls": decode_calls() - before,
                           "events": (start, end), "host_s": host_s})
            return out
        return run

    def step_burst(fn):
        def run(self, k):
            n, t0 = len(bursts), time.perf_counter()
            out = fn(self, k)
            if len(bursts) > n:
                bursts[-1]["wall_s"] = time.perf_counter() - t0
            return out
        return run

    def model_step(fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            enqueue.append(time.perf_counter() - t0)
            return out
        return run

    def decode_active(fn):
        def run(self, emitted):
            enqueue.clear()
            t0 = time.perf_counter()
            fn(self, emitted)
            steps.append({"wall_s": time.perf_counter() - t0,
                          "enqueue_s": sum(enqueue)})
        return run

    wrappers = {"paged_decode_burst": burst, "paged_decode_burst_q": burst,
                "paged_decode_step": model_step,
                "paged_decode_step_q": model_step,
                "step_burst": step_burst, "_decode_active": decode_active}
    for (owner, n), fn in patched.items():
        setattr(owner, n, wrappers[n](fn))
    try:
        yield
    finally:
        for (owner, n), fn in patched.items():
            setattr(owner, n, fn)


def burst_serve(params, cfg, prompts, dev, card) -> dict:
    """The engine's `step_burst`: the paged serve's requests drained by
    `step()` and by `step_burst(BURST_K)` in the order step, burst,
    burst, step (the host's speed drifts within a call), over bf16 and
    then QUANT_SERVE_PRECISION pools, at full width and depth, greedy
    streams required equal; every launch count set to 0 just before each
    run and read just after, held exact (`expected_serve_launches`: each
    burst step is a decode step), every burst at most BURST_K steps, all
    of them run, with no synchronising call inside (`watched_serve`).
    Then a sampled serve (SAMPLING) through both: streams equal, the
    first request's stream the same alone, every token in the
    vocabulary.  Returns the launch counts of the greedy burst runs by
    pool."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    # Warm-up (the sampler's and the burst's first calls); not counted.
    for prec in (None, QUANT_SERVE_PRECISION):
        serve(params, cfg, [prompts[1][:64]], dev, kv_precision=prec,
              burst=BURST_K, sampling=SAMPLING)

    def run(prompts, prec=None, burst=0, sampling=None, name=None):
        calls, bursts, steps = {}, [], []
        with counted_calls(serving, SERVE_STEPS, calls), \
                watched_serve(serving, calls, bursts, steps):
            for m in (pa, fd, fa):
                m.reset_launch_counts()
            eng, rids, secs, n_calls, num_pages = serve(
                params, cfg, prompts, dev, kv_precision=prec, burst=burst,
                sampling=sampling)
            launches = {**pa.LAUNCH_COUNTS, **fd.LAUNCH_COUNTS,
                        **fa.LAUNCH_COUNTS}
        wrong = launch_errors(launches,
                              expected_serve_launches(cfg, calls, prec))
        if wrong:
            fail(f"burst_serve {name} launched (count, expected) {wrong}")
        short = [{k: b[k] for k in ("n_steps", "decode_calls")}
                 for b in bursts if b["decode_calls"] != b["n_steps"]
                 or not 0 < b["n_steps"] <= burst]
        if short or bool(bursts) != bool(burst):
            fail(f"burst_serve {name}: bursts that did not run their "
                 f"steps, or ran more than {burst}: {short}")
        streams = [eng.result(r).tolist() for r in rids]
        for out, p in zip(streams, prompts):
            if len(out) != len(p) + MAX_NEW or not all(
                    0 <= t < cfg.vocab_size for t in out):
                fail(f"burst_serve {name}: a request returned {len(out)} "
                     "tokens or a token outside the vocabulary")
        if eng.alloc.free_pages != num_pages - 1:
            fail(f"burst_serve {name} leaked pages")
        new = MAX_NEW * len(prompts)
        reading = {
            "seconds": secs, "new_tokens_per_s": new / secs,
            "calls": n_calls, "bursts": len(bursts),
            "fallback_steps": n_calls - len(bursts),
            "decode_steps": len(calls["paged_decode_step"])
            + len(calls["paged_decode_step_q"]),
            "chunk_steps": len(calls["paged_chunk_step"])
            + len(calls["paged_chunk_step_q"]),
            "launches": {k: n for k, n in launches.items() if n}}
        if steps:
            reading["step_decode_wall_ms"] = stats(
                [1e3 * s["wall_s"] for s in steps])
            reading["step_decode_enqueue_ms"] = stats(
                [1e3 * s["enqueue_s"] for s in steps])
        if bursts:
            card_ms = [b["events"][0].elapsed_time(b["events"][1])
                       for b in bursts]
            host_ms = [1e3 * b["host_s"] for b in bursts]
            reading.update({
                "burst_steps": [b["n_steps"] for b in bursts],
                "burst_card_ms": stats(card_ms),
                "burst_host_enqueue_ms": stats(host_ms),
                "burst_wall_ms": stats([1e3 * b["wall_s"] for b in bursts]),
                "burst_step_enqueue_ms": stats(
                    [h / b["n_steps"] for h, b in zip(host_ms, bursts)]),
                "card_over_host": sum(card_ms) / sum(host_ms)})
        del eng
        torch.cuda.empty_cache()
        return streams, reading, launches

    runs, burst_launches, greedy, ratio = {}, {}, {}, {}
    for prec in (None, QUANT_SERVE_PRECISION):
        pool = prec or "bf16"
        tps = {0: [], BURST_K: []}
        for i, burst in enumerate((0, BURST_K, BURST_K, 0)):
            name = f"{pool}_{'burst' if burst else 'step'}_{i}"
            streams, runs[name], launches = run(prompts, prec, burst,
                                                name=name)
            greedy.setdefault(pool, streams)
            if streams != greedy[pool]:
                fail(f"burst_serve: {name} streams differ from step()'s")
            tps[burst].append(runs[name]["new_tokens_per_s"])
            if burst:
                burst_launches[pool] = launches
        ratio[pool] = float(np.mean(tps[BURST_K]) / np.mean(tps[0]))
    sampled = {}
    for burst in (0, BURST_K):
        name = f"sampled_{'burst' if burst else 'step'}"
        sampled[burst], runs[name], _ = run(prompts, None, burst, SAMPLING,
                                            name)
    alone, runs["sampled_alone"], _ = run(prompts[:1], None, 0, SAMPLING,
                                          "sampled_alone")
    if sampled[0] != sampled[BURST_K]:
        fail("burst_serve: sampled step_burst streams differ from step()'s")
    if alone[0] != sampled[0][0]:
        fail("burst_serve: a sampled stream changed with the batch")
    differ = sum(a != b for a, b in zip(sampled[0], greedy["bf16"]))
    if not differ:
        fail("burst_serve: every sampled stream is the greedy one")
    print("burst_serve: " + json.dumps({
        "config": f"llama3_8b, {cfg.n_layers} layers (full depth), bf16",
        "burst_k": BURST_K, "requests": len(prompts),
        "new_tokens": MAX_NEW * len(prompts), "sampling": SAMPLING,
        "seed": SAMPLE_SEED, "runs": runs,
        "burst_over_step_new_tokens_per_s": ratio,
        "sampled_streams_unlike_greedy": differ, "card": card}),
        flush=True)
    return burst_launches


def quant_reference_step(params, tokens, cfg, cache):
    """The logits of one quantized serving step (tokens [batch, k], k
    positions at each row's length) with plain float32 attention over
    the row's quantized pages dequantized, then its tail, then the new
    tokens, causal at the end: what `paged_chunk_step_q` /
    `paged_decode_step_q` compute, without the merge of partials and
    without touching the cache."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )

    b, kc = tokens.shape
    page = cache.page_size
    full, tail = cache.full_len.tolist(), cache.tail_len.tolist()
    pos = cache.lengths.long()[:, None] + torch.arange(
        kc, device=tokens.device)[None, :]
    cos, sin = llama.rope_frequencies(cfg, pos)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin)
        rows = []
        for i in range(b):
            pages = cache.page_table[i, :full[i] // page].long()

            def seq(pool, scales, tails, new):
                deq = pa.dequantize_pages(pool[pages], scales[pages],
                                          cache.precision, cfg.dtype)
                deq = deq.permute(1, 0, 2, 3).reshape(
                    deq.shape[1], -1, deq.shape[-1])
                return torch.cat([deq, tails[i, :, :tail[i]].float(),
                                  new[i].float()], dim=1)[None]
            rows.append(attention_reference(
                q[i:i + 1].float(),
                seq(cache.qk[li], cache.k_scales[li], cache.tail_k[li], k),
                seq(cache.qv[li], cache.v_scales[li], cache.tail_v[li], v),
                causal=True))
        o = torch.cat(rows).to(cfg.dtype).transpose(1, 2).reshape(b, kc, -1)
        x = x + (o @ layer["wo"]).to(x.dtype)
        x = llama.mlp_block(layer, x, cfg)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"]).float()


def lost_first_page(cache):
    """A copy of a quantized paged cache whose rows' first pages are
    lost: payload the code of 0.0, scales 1 (as a flush that wrote its
    page elsewhere leaves them)."""
    import torch
    first = cache.page_table[:, 0].long()
    zero = 0x77 if cache.precision.value == "nf4" else 0

    def lose(tensors, fill, as_bytes):
        out = []
        for t in tensors:
            t = t.clone()
            (t.view(torch.uint8) if as_bytes else t)[first] = fill
            out.append(t)
        return tuple(out)
    return cache._replace(
        qk=lose(cache.qk, zero, True), qv=lose(cache.qv, zero, True),
        k_scales=lose(cache.k_scales, 1.0, False),
        v_scales=lose(cache.v_scales, 1.0, False),
        tail_k=tuple(t.clone() for t in cache.tail_k),
        tail_v=tuple(t.clone() for t in cache.tail_v))


def quant_reference(params, cfg, dev) -> dict:
    """On a 2-layer cut of the weights, the quantized serving steps'
    logits (QUANT_REF_PROMPT tokens in page-sized chunks, then
    QUANT_REF_STEPS decode steps whose tail fills and flushes a page)
    against `quant_reference_step`, in each of QUANT_REF_PRECISIONS; and
    one more decode step with each row's first page lost, a planted
    fault that the limits must see."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    cut = dict(params, layers=params["layers"][:REFERENCE_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=REFERENCE_LAYERS)
    rng = np.random.default_rng(SEED + 8)
    n = QUANT_REF_PROMPT + QUANT_REF_STEPS + 1
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (QUANT_REF_BATCH, n)), device=dev)
    out, problems = {}, []
    with torch.inference_mode():
        for prec in QUANT_REF_PRECISIONS:
            cache = serving.init_quantized_paged_model_cache(
                ccfg, QUANT_REF_BATCH, n, precision=prec, page_size=PAGE,
                device=dev)
            got, ref = [], []
            for i in range(0, QUANT_REF_PROMPT, PAGE):
                chunk = tokens[:, i:min(i + PAGE, QUANT_REF_PROMPT)]
                ref.append(quant_reference_step(cut, chunk, ccfg,
                                                cache)[:, -1])
                logits, cache = serving.paged_chunk_step_q(cut, chunk, ccfg,
                                                           cache)
                got.append(logits[:, -1])
            full_before = cache.full_len.clone()
            for s in range(QUANT_REF_STEPS):
                tok = tokens[:, QUANT_REF_PROMPT + s]
                ref.append(quant_reference_step(cut, tok[:, None], ccfg,
                                                cache)[:, 0])
                logits, cache = serving.paged_decode_step_q(cut, tok, ccfg,
                                                            cache)
                got.append(logits)
            if torch.equal(cache.full_len, full_before):
                fail("quant_reference's decode steps flushed no page")
            tok = tokens[:, -1]
            fault_ref = quant_reference_step(cut, tok[:, None], ccfg,
                                             cache)[:, 0]
            fault, _ = serving.paged_decode_step_q(cut, tok, ccfg,
                                                   lost_first_page(cache))
            got, ref = torch.stack(got, 1), torch.stack(ref, 1)
            if not torch.isfinite(got).all():
                fail(f"quantized path ({prec}) gave non-finite logits")

            def reading(a, r):
                e = a - r
                return {"rel_rms_err": float(e.pow(2).mean().sqrt()
                                             / r.pow(2).mean().sqrt()),
                        "max_abs_err": float(e.abs().max())}
            limit = QUANT_REF_LIMITS[prec]
            r = reading(got, ref)
            r["planted_fault"] = reading(fault, fault_ref)
            r["limits"] = limit
            out[prec] = r

            def within(x):
                return (x["rel_rms_err"] <= limit["rel_rms"]
                        and x["max_abs_err"] <= limit["max_abs"])
            if not within(r):
                problems.append(f"{prec} logits disagree with the plain "
                                "attention over the dequantized pools")
            if within(r["planted_fault"]):
                problems.append(f"the {prec} limits do not see a lost page")
    print("quant_reference: " + json.dumps({
        "layers": REFERENCE_LAYERS, "batch": QUANT_REF_BATCH,
        "prompt": QUANT_REF_PROMPT, "decode_steps": QUANT_REF_STEPS,
        "page": PAGE, "readings": out}), flush=True)
    if problems:
        fail("; ".join(problems))
    return out


def quant_kernel_checks(dev, launches) -> list[dict]:
    """Each quantized kernel variant against its plain version, in every
    precision of QUANT_PRECISIONS, by the worst tile (KERNEL_TILE_REL_RMS;
    lse at MIXED_TOL): the paged decode at the serve's decode shape, a
    serving chunk's prefix folded into the heads (the wide decode), the
    paged prefill at the serve's chunk, each at page 128 and page 8 (a
    64-key tile then spans eight pages' scales), and `flash_decode` at the
    generate shape.  K and V carry a magnitude per (page or sequence, kv
    head), so that their scales differ.  Planted faults, each of which
    the limit must see: one page's K scale replaced by its neighbour's
    (the dense cache: one (sequence, head)'s by its neighbour's); for
    NF4, K's two nibble planes swapped.  Then each variant's time (median
    and min-max of GEMM_REPEATS loops; the paged ones cold, over a
    rotation of pools whose reads exceed PAGED_COLD_L2_MULTIPLE times the
    L2), its bytes bound, its plain version's time and the bf16 kernel's
    at the same shape, in the same call."""
    import torch
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.ops.quantization import quantize
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    kvh, qh, d = KV_HEADS, Q_HEADS, HEAD_DIM
    scale = d ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    def pools(lengths, page):
        """bf16 pools with a magnitude per (page, kv head), a shuffled
        table."""
        max_pages = -(-max(lengths) // page)
        num_pages = len(lengths) * max_pages + 1
        mag = torch.exp(2 * torch.rand((num_pages, kvh, 1, 1),
                                       generator=gen, device=dev) - 1)
        k = (randn(num_pages, kvh, page, d) * mag).to(torch.bfloat16)
        v = (randn(num_pages, kvh, page, d) * mag).to(torch.bfloat16)
        perm = torch.randperm(num_pages - 1, generator=gen,
                              device=dev).to(torch.int32) + 1
        return pa.PagedKVCache(k, v, perm.reshape(len(lengths), max_pages),
                               torch.tensor(lengths, dtype=torch.int32,
                                            device=dev))

    def as4(q):
        return q if q.dim() == 4 else q[:, :, None]

    def paged_plain(q, cache):
        po, plse = pa._paged_attention_plain(as4(q), cache, scale=scale,
                                             window_size=None)
        return po.reshape(q.shape), plse.reshape(q.shape[:-1])

    def rows_of(o):
        """Decode outputs [b, heads, d]: each (sequence, head) a tile."""
        return o[:, :, None] if o.dim() == 3 else o

    def scale_fault(cache):
        """One of sequence 0's pages takes its neighbour's K scales: the
        adjacent pair whose scales differ most."""
        ks = cache.k_scales.clone()
        live = -(-int(cache.lengths[0]) // cache.page_size)
        table = cache.page_table[0, :live].long()
        ratio = (ks[table[1:]].log() - ks[table[:-1]].log()).abs()
        j = int(ratio.amax(dim=1).argmax())
        ks[table[j]] = ks[table[j + 1]]
        return cache._replace(k_scales=ks)

    def swap_planes(payload):
        x = payload.view(torch.uint8)
        return ((x << 4) | (x >> 4)).view(payload.dtype)

    dec_lens = [n + MAX_NEW for n in PROMPT_LENS[:MAX_BATCH]]
    qd = randn(MAX_BATCH, qh, d).to(torch.bfloat16)
    qw = randn(1, qh * PAGE, d).to(torch.bfloat16)
    qp = randn(1, qh, PAGE, d).to(torch.bfloat16)
    # (name, fn, q, lengths): the paged variants.
    paged_cases = [("paged_decode", pa.paged_decode, qd, dec_lens),
                   ("paged_decode_wide", pa.paged_decode, qw, [1024]),
                   ("paged_prefill", pa.paged_prefill, qp, [1024])]
    bf16 = {(name, page): pools(lens, page)
            for name, _, _, lens in paged_cases for page in (PAGE, 8)}
    b, n = DENSE_BATCH, DENSE_MAX_SEQ
    mag = torch.exp(2 * torch.rand((b, kvh, 1, 1), generator=gen,
                                   device=dev) - 1)
    kd = (randn(b, kvh, n, d) * mag).to(torch.bfloat16)
    vd = (randn(b, kvh, n, d) * mag).to(torch.bfloat16)
    qg = randn(b, qh, d).to(torch.bfloat16)
    dlens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)

    readings, results, problems = {}, [], []

    def check(key, o, lse, po, plse, faults):
        r = closeness(rows_of(o), rows_of(po))
        r["lse_max_abs_err"] = max_abs_err(lse, plse)
        for fname, fo in faults.items():
            r[fname] = closeness(rows_of(fo), rows_of(po))
            if within_limits(r[fname]):
                problems.append(f"the {key} check does not see {fname}")
        if not within_limits(r) or r["lse_max_abs_err"] > MIXED_TOL.lse:
            problems.append(f"{key} disagrees with its plain version")
        readings[key] = r
        return r

    def rotation(make, first, bytes_read):
        count = -(-PAGED_COLD_L2_MULTIPLE * L2_BYTES // max(bytes_read, 1))
        return [first] + [make() for _ in range(count - 1)]

    def cycling(fn, q, caches):
        turn = itertools.cycle(caches)
        return lambda: fn(q, next(turn))

    def paged_work(q, cache, value_bytes):
        """(FLOPs, bytes): each live K and V value and each touched
        page's two scales read once, q read, o and lse written."""
        q4 = as4(q)
        lengths = cache.lengths.tolist()
        page = cache.page_size
        pairs = sum(visible_pairs(q4.shape[2], x, True, None)
                    for x in lengths)
        kv = int(sum(lengths) * kvh * d * 2 * value_bytes)
        scales = 0 if value_bytes == 2 else \
            sum(-(-x // page) for x in lengths) * kvh * 2 * 4
        return (4 * d * q4.shape[1] * pairs,
                kv + scales + 2 * q4.numel() * 2 + q4[..., 0].numel() * 4)

    bf16_ms = {}
    for name, fn, q, lens in paged_cases:
        c = bf16[(name, PAGE)]
        caches = rotation(lambda: pools(lens, PAGE), c,
                          paged_work(q, c, 2)[1])
        bf16_ms[name] = timed_spread(cycling(fn, q, caches),
                                     4 * len(caches))
        del caches
    bf16_ms["flash_decode"] = timed_spread(
        lambda: fd.flash_decode(qg, kd, vd, kv_lens=dlens), 50)

    for prec in QUANT_PRECISIONS:
        p = OperandPrecision(prec)
        nf4 = p is OperandPrecision.NF4
        value_bytes = 0.5 if nf4 else 1
        for name, fn, q, lens in paged_cases:
            key = f"{name}_{prec}"
            page_readings = {}
            for page in (PAGE, 8):
                c = pa.quantize_paged(bf16[(name, page)], p)
                o, lse = fn(q, c, return_residuals=True)
                po, plse = paged_plain(q, c)
                faults = {"k_scale_of_neighbour_page":
                          fn(q, scale_fault(c))}
                if nf4:
                    faults["nibble_planes_swapped"] = fn(
                        q, c._replace(k_pages=swap_planes(c.k_pages)))
                page_readings[page] = check(f"{key}.page{page}", o, lse, po,
                                            plse, faults)
            c = pa.quantize_paged(bf16[(name, PAGE)], p)
            work = paged_work(q, c, value_bytes)
            caches = rotation(
                lambda: pa.quantize_paged(pools(lens, PAGE), p), c, work[1])
            cold = timed_spread(cycling(fn, q, caches), 4 * len(caches))
            del caches
            plain_ms, _ = timed(lambda: paged_plain(q, c), 10)
            bound_ms, bound_by = bound(*work)
            results.append({
                "name": key, "route": "cuda",
                "source": "metal_flash_attention_tpu_torch/csrc/"
                          "paged_attention.cu",
                "core": "metal_flash_attention_tpu_torch/csrc/"
                        "decode_common.cuh",
                "replaces": "metal_flash_attention_tpu/ops/"
                            "paged_attention.py:183 (kv_precision "
                            f"{prec})",
                "kernel": "paged_prefill90_kernel" if name != "paged_decode"
                          else "flash_decode90_kernel (paged)",
                "launches": launches.get(key, 0),
                "max_abs_err": max(r["max_abs_err"]
                                   for r in page_readings.values()),
                "o": page_readings[PAGE], "o_page8": page_readings[8],
                "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                           "lse_abs": MIXED_TOL.lse},
                "ms": cold["ms"], "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": None,
                "library": "none: no one PyTorch call dequantizes pages "
                           "and attends",
                "share_of_bound": bound_ms / cold["ms"],
                "spread": cold, "bf16_ms": bf16_ms[name]["ms"],
                "bf16_spread": bf16_ms[name],
                "cold": {"pools": -(-PAGED_COLD_L2_MULTIPLE * L2_BYTES
                                    // work[1])},
                "shape": f"q {list(q.shape)}, lengths {lens}, page "
                         f"{PAGE} (timed) and 8"})
        key = f"flash_decode_{prec}"
        kq, vq = quantize(kd, p), quantize(vd, p)
        o, lse = fd.flash_decode(qg, kq, vq, kv_lens=dlens,
                                 return_residuals=True)
        po, plse = fd._flash_decode_plain(qg, kq, vq, kv_lens=dlens,
                                          kv_starts=None, max_span=None,
                                          scale=scale)
        ks = kq.scales.clone()
        j = int((ks[0, 1:].log() - ks[0, :-1].log()).abs().argmax())
        ks[0, j] = ks[0, j + 1]
        faults = {"k_scale_of_neighbour_head": fd.flash_decode(
            qg, kq._replace(scales=ks), vq, kv_lens=dlens)}
        if nf4:
            faults["nibble_planes_swapped"] = fd.flash_decode(
                qg, kq._replace(values=swap_planes(kq.values)), vq,
                kv_lens=dlens)
        r = check(key, o, lse, po, plse, faults)
        t = timed_spread(lambda: fd.flash_decode(qg, kq, vq, kv_lens=dlens),
                         50)
        plain_ms, _ = timed(lambda: fd._flash_decode_plain(
            qg, kq, vq, kv_lens=dlens, kv_starts=None, max_span=None,
            scale=scale), 5)
        keys = int(sum(DECODE_LENS))
        io = 2 * qg.numel() * 2 + qg[..., 0].numel() * 4
        bound_ms, bound_by = bound(
            4 * d * qh * keys,
            int(keys * kvh * d * 2 * value_bytes)
            + 2 * kq.scales.numel() * 4 + io)
        results.append({
            "name": key, "route": "cuda",
            "source": "metal_flash_attention_tpu_torch/csrc/flash_decode.cu",
            "core": "metal_flash_attention_tpu_torch/csrc/decode_common.cuh",
            "replaces": "metal_flash_attention_tpu/ops/flash_decode.py:82 "
                        f"(QuantizedTensor K/V, {prec})",
            "launches": launches.get(key, 0),
            "max_abs_err": r["max_abs_err"], "o": r,
            "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                       "lse_abs": MIXED_TOL.lse},
            "ms": t["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
            "library": "none: a dequantize then SDPA is two calls",
            "share_of_bound": bound_ms / t["ms"], "spread": t,
            "bf16_ms": bf16_ms["flash_decode"]["ms"],
            "bf16_spread": bf16_ms["flash_decode"],
            "shape": "q [8, 32, 128], k/v [8, 8, 8192, 128], lengths "
                     f"{list(DECODE_LENS)}"})
        del kq, vq
    print("quant_kernel_checks: " + json.dumps({
        "readings": readings,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                   "lse_abs": MIXED_TOL.lse}}), flush=True)
    if problems:
        fail("; ".join(problems))
    return results


@contextlib.contextmanager
def event_timed(module, name: str, spans: list):
    """`module.name` wrapped, inside the block, to record a CUDA event
    just before and just after each call, and to append (start, end,
    host seconds the call took to return) to `spans`.  It adds no
    synchronise: the host runs ahead of the card as in the bare loop."""
    import torch
    original = getattr(module, name)

    def run(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = original(*args, **kwargs)
        end.record()
        spans.append((start, end, time.perf_counter() - t0))
        return out
    setattr(module, name, run)
    try:
        yield
    finally:
        setattr(module, name, original)


def stats(xs) -> dict:
    return {"mean": float(np.mean(xs)), "median": float(np.median(xs)),
            "min": float(min(xs)), "max": float(max(xs)), "n": len(xs)}


def dense_serve(params, cfg, dev, card) -> dict:
    """The dense serving path: greedy `serving.generate` over a batch of
    DENSE_BATCH random prompts (prefill through the fused forward, then
    decode steps through `flash_decode`).  The timed run is the bare
    `generate`, with both kernels' launch counts set to 0 just before
    and read just after; returns them.  A second, instrumented run of
    the same call splits its time: CUDA events around `prefill` and each
    `decode_step` (the card's time from a call's first kernel to its
    last, idle gaps included) and the host's seconds to enqueue each."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd

    rng = np.random.default_rng(SEED)
    prompt = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT)),
        dtype=torch.int32, device=dev)

    def generate():
        return serving.generate(params, prompt, cfg,
                                max_new_tokens=DENSE_NEW,
                                max_seq=DENSE_MAX_SEQ)
    # Warm-up (library load, cuBLAS handles); not counted.
    serving.generate(params, prompt[:, :64], cfg, max_new_tokens=2)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with CardSampler() as sampler:
        fa.reset_launch_counts()
        fd.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate()
        torch.cuda.synchronize(dev)
        total = time.perf_counter() - t0
        launches = {"flash_fwd": fa.LAUNCH_COUNTS["flash_fwd"],
                    "flash_fwd_sm90": fa.LAUNCH_COUNTS["flash_fwd_sm90"],
                    "flash_decode": fd.LAUNCH_COUNTS["flash_decode"],
                    "flash_decode_sm90":
                        fd.LAUNCH_COUNTS["flash_decode_sm90"]}
        clocks = sampler.stop()
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {"flash_fwd": cfg.n_layers, "flash_fwd_sm90": cfg.n_layers,
                "flash_decode": cfg.n_layers * (DENSE_NEW - 1),
                "flash_decode_sm90": cfg.n_layers * (DENSE_NEW - 1)}
    if launches != expected:
        fail(f"dense serve launched {launches}, expected {expected}")
    if tuple(out.shape) != (DENSE_BATCH, DENSE_PROMPT + DENSE_NEW):
        fail(f"generate returned shape {tuple(out.shape)}")
    if not torch.equal(out[:, :DENSE_PROMPT], prompt):
        fail("generate changed the prompt")
    new = out[:, DENSE_PROMPT:]
    if not ((new >= 0) & (new < cfg.vocab_size)).all():
        fail("generate emitted a token outside the vocabulary")

    prefill_spans, step_spans = [], []
    with event_timed(serving, "prefill", prefill_spans), \
            event_timed(serving, "decode_step", step_spans):
        t0 = time.perf_counter()
        out2 = generate()
        torch.cuda.synchronize(dev)
        total2 = time.perf_counter() - t0
    (p_start, p_end, p_host), = prefill_spans
    step_ms = [a.elapsed_time(b) for a, b, _ in step_spans]
    new_tokens = DENSE_BATCH * DENSE_NEW
    print("dense_serve: " + json.dumps({
        "config": f"llama3_8b, {cfg.n_layers} layers (full depth), bf16",
        "batch": DENSE_BATCH, "prompt_tokens": DENSE_PROMPT,
        "new_tokens_per_sequence": DENSE_NEW, "max_seq": DENSE_MAX_SEQ,
        "timed_run": {
            "what": "the bare generate, synchronised before and after",
            "seconds": total, "new_tokens_per_s": new_tokens / total,
            "max_memory_allocated": peak, "launches": launches,
            "card_during_generate": clocks},
        "instrumented_run": {
            "what": "the same generate with CUDA events around prefill "
                    "and each decode step, no synchronise inside",
            "seconds": total2, "same_tokens": bool(torch.equal(out, out2)),
            "prefill_ms": p_start.elapsed_time(p_end),
            "prefill_host_ms": p_host * 1e3,
            "prefill_tokens_per_s": DENSE_BATCH * DENSE_PROMPT
            / p_start.elapsed_time(p_end) * 1e3,
            "decode_step_ms": stats(step_ms),
            "decode_step_host_ms": stats([h * 1e3 for *_, h in step_spans]),
            "decode_tokens_per_s": DENSE_BATCH * len(step_ms)
            / sum(step_ms) * 1e3},
        "card": card}), flush=True)
    profile_decode_step(params, cfg, dev)
    return launches


def profile_decode_step(params, cfg, dev) -> None:
    """One dense decode step at the end of the generate's context under
    torch.profiler (`dense_profile:`)."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    cache = serving.init_cache(cfg, DENSE_BATCH, DENSE_MAX_SEQ, device=dev)
    cache = cache._replace(lengths=torch.full(
        (DENSE_BATCH,), DENSE_PROMPT + DENSE_NEW - 2, dtype=torch.int32,
        device=dev))
    token = torch.zeros((DENSE_BATCH,), dtype=torch.int32, device=dev)
    with torch.inference_mode():
        serving.decode_step(params, token, cfg, cache)
        profile_step("dense_profile",
                     lambda: serving.decode_step(params, token, cfg, cache),
                     {"flash_decode": ("flash_decode90_kernel",
                                       "merge_splits")},
                     dev)


def decode_reference(params, cfg, dev) -> dict:
    """The dense path's logits (prefill, then DECODE_REF_STEPS decode
    steps) against a full recompute with `attention_reference`, on a
    2-layer cut of the weights."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    cut = dict(params, layers=params["layers"][:REFERENCE_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=REFERENCE_LAYERS)
    rng = np.random.default_rng(SEED + 6)
    n = REFERENCE_PROMPT + DECODE_REF_STEPS
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (DECODE_REF_BATCH, n)), device=dev)
    with torch.inference_mode():
        cache = serving.init_cache(ccfg, DECODE_REF_BATCH, n, device=dev)
        logits, cache = serving.prefill(cut, tokens[:, :REFERENCE_PROMPT],
                                        ccfg, cache)
        got = [logits]
        for i in range(DECODE_REF_STEPS):
            logits, cache = serving.decode_step(
                cut, tokens[:, REFERENCE_PROMPT + i], ccfg, cache)
            got.append(logits)
        got = torch.stack(got, dim=1)
        ref = (plain_hidden(cut, tokens, ccfg) @ cut["lm_head"]).float()
        ref = ref[:, REFERENCE_PROMPT - 1:]
    if not torch.isfinite(got).all():
        fail("dense path gave non-finite logits")
    err = got - ref
    out = {"layers": REFERENCE_LAYERS, "batch": DECODE_REF_BATCH,
           "prompt": REFERENCE_PROMPT, "decode_steps": DECODE_REF_STEPS,
           "rel_rms_err": float(err.pow(2).mean().sqrt()
                                / ref.pow(2).mean().sqrt()),
           "max_abs_err": float(err.abs().max()),
           "per_position_rel_rms": [
               float(err[:, i].pow(2).mean().sqrt()
                     / ref[:, i].pow(2).mean().sqrt())
               for i in range(err.shape[1])],
           "tol": {"rel_rms": REF_REL_RMS, "max_abs": REF_MAX_ABS}}
    print("decode_reference: " + json.dumps(out), flush=True)
    if not (out["rel_rms_err"] <= REF_REL_RMS
            and out["max_abs_err"] <= REF_MAX_ABS):
        fail("dense path disagrees with the attention_reference recompute")
    return out


def decode_kernel_checks(dev, launches) -> dict:
    """The decode kernel against its plain version at the generate shape
    with ragged lengths, with a planted fault (one row a 64-key tile
    short) that the tile limit must see, and at the sink shape (both
    partials of `sink_decode`: the strided sink slice, and kv_starts
    with max_span); then its time, its plain version's and SDPA's."""
    import torch
    import torch.nn.functional as F
    from metal_flash_attention_tpu_torch.models import serving
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    b, n, d = DENSE_BATCH, DENSE_MAX_SEQ, HEAD_DIM
    scale = d ** -0.5

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)
    q, k, v = randn(b, Q_HEADS, d), randn(b, KV_HEADS, n, d), \
        randn(b, KV_HEADS, n, d)
    lens = torch.tensor(DECODE_LENS, dtype=torch.int32, device=dev)
    full = torch.full((b,), n, dtype=torch.int32, device=dev)
    readings, lse_errs, problems = {}, {}, []

    def rows(o):
        """o [b, q_heads, d] as [b, q_heads, 1, d]: each (sequence,
        head) row is a tile of its own for `closeness`."""
        return o[:, :, None]

    def check(name, kernel, plain, fault=None):
        (o, lse), (po, plse) = kernel, plain
        r = closeness(rows(o), rows(po))
        if fault is not None:
            r["planted_fault"] = closeness(rows(fault), rows(po))
        readings[name] = r
        lse_errs[name] = max_abs_err(lse, plse)
        if not within_limits(r) or lse_errs[name] > MIXED_TOL.lse:
            problems.append(f"{name} disagrees with its plain version")
        if fault is not None and within_limits(r["planted_fault"]):
            problems.append(f"the {name} check does not see a dropped "
                            "key tile")

    def both(**kw):
        return (fd.flash_decode(q, k_, v_, return_residuals=True, **kw),
                fd._flash_decode_plain(q, k_, v_, scale=scale, **{
                    "kv_starts": None, "max_span": None, **kw}))

    # (a) The generate shape, ragged.  Fault: row 0 (8,192 keys) without
    # its last 64-key tile.
    k_, v_ = k, v
    kernel, plain = both(kv_lens=lens)
    short = lens.clone()
    short[0] -= 64
    fault, _ = fd.flash_decode(q, k, v, kv_lens=short, return_residuals=True)
    check("flash_decode.o", kernel, plain, fault)
    # (b) The sink shape at full lengths: the sink partial on the strided
    # slice of the first SINK rows, the window partial from
    # max(len - window, sink) with max_span; then the merged output.
    k_, v_ = k[:, :, :SINK], v[:, :, :SINK]
    sink_parts = both(kv_lens=full.clamp_max(SINK))
    check("flash_decode.o_sink_part", *sink_parts)
    k_, v_ = k, v
    starts = (full - SINK_WINDOW).clamp_min(SINK)
    win_parts = both(kv_lens=full, kv_starts=starts, max_span=SINK_WINDOW)
    check("flash_decode.o_window_part", *win_parts)
    so = serving.sink_decode(q, k, v, full, window=SINK_WINDOW, sink=SINK)
    plain_so = serving._merge_partials(
        sink_parts[1][0].float(), sink_parts[1][1],
        win_parts[1][0].float(), win_parts[1][1])
    readings["sink_decode.o"] = closeness(rows(so), rows(plain_so))
    if not within_limits(readings["sink_decode.o"]):
        problems.append("sink_decode disagrees with its plain version")
    print("decode_checks: " + json.dumps({
        "readings": readings, "lse_max_abs_err": lse_errs,
        "lengths": list(DECODE_LENS),
        "sink": {"window": SINK_WINDOW, "sink": SINK, "lengths": n},
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                   "lse_abs": MIXED_TOL.lse}}), flush=True)
    if problems:
        fail("; ".join(problems))

    ragged = timed_spread(lambda: fd.flash_decode(q, k, v, kv_lens=lens),
                          50)
    full_t = timed_spread(lambda: fd.flash_decode(q, k, v, kv_lens=full),
                          50)
    sink_ms, _ = timed(lambda: serving.sink_decode(
        q, k, v, full, window=SINK_WINDOW, sink=SINK), 50)
    plain_ms, _ = timed(lambda: fd._flash_decode_plain(
        q, k, v, kv_lens=lens, kv_starts=None, max_span=None, scale=scale),
        10)
    mask = (torch.arange(n, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    lib = timed_spread(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=True), 20)
    full_mask = torch.ones_like(mask)
    lib_full = timed_spread(lambda: F.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=full_mask, enable_gqa=True), 20)

    def work(lengths):
        """(FLOPs, bytes): each live K and V row read once, q read and o
        and lse written once."""
        keys = int(sum(lengths))
        io = 2 * q.numel() * 2 + q[..., 0].numel() * 4
        return 4 * d * Q_HEADS * keys, keys * KV_HEADS * d * 2 * 2 + io
    bound_ms, bound_by = bound(*work(DECODE_LENS))
    full_bound_ms, _ = bound(*work([n] * b))
    return {
        "name": "flash_decode", "route": "cuda",
        "source": "metal_flash_attention_tpu_torch/csrc/flash_decode.cu",
        "core": "metal_flash_attention_tpu_torch/csrc/decode_common.cuh",
        "replaces": "metal_flash_attention_tpu/ops/flash_decode.py:82",
        "launches": launches["flash_decode"],
        "launches_sm90": launches["flash_decode_sm90"],
        "max_abs_err": max(readings[key]["max_abs_err"]
                           for key in readings),
        "o": readings["flash_decode.o"],
        "o_sink_part": readings["flash_decode.o_sink_part"],
        "o_window_part": readings["flash_decode.o_window_part"],
        "sink_decode_o": readings["sink_decode.o"],
        "lse_max_abs_err": max(lse_errs.values()),
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                   "lse_abs": MIXED_TOL.lse},
        "ms": ragged["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib["ms"],
        "share_of_bound": bound_ms / ragged["ms"],
        "wall_ms": ragged["wall_ms"], "spread": ragged,
        "library_spread": lib,
        "library": "F.scaled_dot_product_attention(q[:, :, None], k, v, "
                   "attn_mask=<length mask>, enable_gqa=True)",
        "ms_full_lengths": full_t["ms"], "spread_full_lengths": full_t,
        "bound_ms_full_lengths": full_bound_ms,
        "share_of_bound_full_lengths": full_bound_ms / full_t["ms"],
        "library_ms_full_lengths": lib_full["ms"],
        "library_spread_full_lengths": lib_full,
        "sink_decode_ms": sink_ms,
        "shape": "q [8, 32, 128], k/v [8, 8, 8192, 128] bf16, lengths "
                 f"{list(DECODE_LENS)} (timed; also at full lengths); "
                 f"sink_decode window {SINK_WINDOW}, sink {SINK}"}


def train(dev, card):
    """The training path at the slice's configuration; returns the
    trained parameters, the config and the flash launch counts."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama, optim
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    cfg = llama.LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    rng = np.random.default_rng(SEED + 3)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, TRAIN_TOKENS + 1)),
        device=dev)
    init_fn, step_fn = optim.make_train_step(
        lambda p, batch: llama.loss_fn(p, batch, cfg))
    state = init_fn(params)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    fa.reset_launch_counts()
    fb.reset_launch_counts()
    losses, seconds = [], []
    with CardSampler() as sampler:
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            params, state, loss = step_fn(params, state, tokens)
            losses.append(float(loss))
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
        clocks = sampler.stop()
    launches = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
    peak = torch.cuda.max_memory_allocated(dev)

    per_step = TRAIN_LAYERS
    for name, n in launches.items():
        if n != per_step * TRAIN_STEPS:
            fail(f"kernel {name} launched {n} times in {TRAIN_STEPS} "
                 f"steps, expected {per_step} a step")
    if not all(np.isfinite(losses)):
        fail(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training loss did not fall: {losses}")
    steady = seconds[1:]
    print("train: " + json.dumps({
        "config": f"llama3_8b widths, {TRAIN_LAYERS} layers, bf16",
        "tokens_per_step": TRAIN_TOKENS, "steps": TRAIN_STEPS,
        "losses": losses, "seconds_per_step": seconds,
        "tokens_per_s": TRAIN_TOKENS * len(steady) / sum(steady),
        "launches": launches, "max_memory_allocated": peak,
        "card": card, "card_during_steps": clocks}), flush=True)
    profile_train_step(step_fn, params, state, tokens, dev)
    del state
    return params, cfg, launches


def profile_train_step(step_fn, params, state, tokens, dev) -> None:
    """One more train step under torch.profiler: device time by kernel
    family and the card's busy share of the step's wall time."""
    profile_step("train_profile", lambda: step_fn(params, state, tokens),
                 {"flash_fwd": "flash_fwd90_kernel",
                  "flash_bwd_dq": "flash_bwd_dq90_kernel",
                  "flash_bwd_dkv": "flash_bwd_dkv90_kernel",
                  "optimizer": "multi_tensor"}, dev)


def profile_step(label, run, families, dev) -> dict:
    """`run()` once under torch.profiler: device time by kernel family
    (`families`: name -> a substring of the kernel's name, or a tuple of
    them; cuBLAS products and the rest besides), the card's busy share
    of the wall time, and the top kernels.  Prints and returns the
    reading."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    kernels = device_kernels(prof)
    by_family: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        family = next((f for f, keys in families.items() if any(
            key in e.name for key in (
                (keys,) if isinstance(keys, str) else keys))), None)
        if family is None:
            family = ("gemm" if any(key in e.name.lower() for key in (
                "gemm", "gemv", "xmma", "nvjet", "cutlass", "sm90"))
                else "other")
        by_family[family] = by_family.get(family, 0.0) + e.device_time_total
        slot = by_name.setdefault(e.name[:90], [0, 0.0])
        slot[0] += 1
        slot[1] += e.device_time_total
    busy_us = sum(by_family.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    reading = {
        "wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
        "busy_share": busy_us / 1e3 / (wall * 1e3),
        "kernels_launched": len(kernels),
        "device_ms_by_family": {k: v / 1e3 for k, v in sorted(
            by_family.items(), key=lambda kv: -kv[1])},
        "top_kernels": [{"name": n, "calls": c, "ms": t / 1e3}
                        for n, (c, t) in top]}
    print(f"{label}: " + json.dumps(reading), flush=True)
    return reading


def train_reference(params, cfg, dev) -> dict:
    """The kernel loss and gradients against the plain-attention loss on
    a 2-layer cut at 2,048 tokens."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    cut = dict(params, layers=params["layers"][:TRAIN_REF_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=TRAIN_REF_LAYERS)
    rng = np.random.default_rng(SEED + 4)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, TRAIN_REF_TOKENS + 1)),
        device=dev)

    def plain_loss(p):
        x = plain_hidden(p, tokens[:, :-1], ccfg)
        logp = torch.log_softmax((x @ p["lm_head"]).float(), dim=-1)
        return -logp.gather(-1, tokens[:, 1:, None]).mean()

    def value_and_grads(loss_fn):
        leaves, rebuild = flatten(cut)
        work = [t.detach().requires_grad_(True) for t in leaves]
        value = loss_fn(rebuild(work))
        grads = torch.autograd.grad(value, work)
        return float(value.detach()), grads

    ref_loss, ref_grads = value_and_grads(plain_loss)

    def reading(loss_fn) -> dict:
        loss, grads = value_and_grads(loss_fn)
        rel = []
        for g, r in zip(grads, ref_grads):
            if not torch.isfinite(g).all():
                fail("non-finite gradient on the kernel path")
            g, r = g.float(), r.float()
            rel.append(float((g - r).pow(2).mean().sqrt()
                             / r.pow(2).mean().sqrt().clamp_min(1e-30)))
        return {"loss": loss, "loss_abs_err": abs(loss - ref_loss),
                "grad_rel_rms_max": max(rel),
                "grad_rel_rms_median": float(np.median(rel))}

    def seen(r: dict) -> bool:
        return (r["loss_abs_err"] > TRAIN_LOSS_ABS
                or r["grad_rel_rms_max"] > TRAIN_GRAD_REL_RMS)

    def kernel_loss(p):
        return llama.loss_fn(p, tokens, ccfg)

    out = {"layers": TRAIN_REF_LAYERS, "tokens": TRAIN_REF_TOKENS,
           "plain_loss": ref_loss, **reading(kernel_loss),
           "tol": {"loss_abs": TRAIN_LOSS_ABS,
                   "grad_rel_rms": TRAIN_GRAD_REL_RMS}}
    # Controls: the same reading with a fault planted in the kernel path.
    faults = {"dkv_lost_group_head": (fb, "_dkv_cuda", lost_group_head),
              "fwd_scale_1_over_d": (fa, "_forward_cuda", unrooted_scale)}
    out["planted_faults"] = {}
    for name, (module, attr, make) in faults.items():
        with planted(module, attr, make):
            out["planted_faults"][name] = reading(kernel_loss)
    print("train_reference: " + json.dumps(out), flush=True)
    if seen(out):
        fail("the kernel path's loss or gradients disagree with the "
             "plain-attention reference")
    for name, r in out["planted_faults"].items():
        if not seen(r):
            fail(f"the train_reference limits do not see the planted "
                 f"fault {name}")
    return out


def flash_kernel_checks(dev, launches) -> list[dict]:
    """The three flash-attention kernels against their plain versions at
    the training shape (and the forward at the window shape), with their
    times, bounds and the SDPA yardstick.  Each check also reads a
    planted one-tile fault, which its tile limit must see."""
    import torch
    import torch.nn.functional as F
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
        attention_reference_grads,
    )
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    d = HEAD_DIM
    scale = d ** -0.5
    group = Q_HEADS // KV_HEADS
    n = TRAIN_TOKENS
    # Where the faults go: the last query tile of the last q head, whose
    # diagonal key tile ends at n - TILE_ROWS; the group of q heads of
    # the last kv head; a key tile in the middle.
    last = slice(n - TILE_ROWS, n)
    h, kvh = Q_HEADS - 1, KV_HEADS - 1
    grp = slice(kvh * group, (kvh + 1) * group)
    mid = slice(n // 2, n // 2 + TILE_ROWS)
    readings, problems = {}, []

    def qkv(rows, cols):
        def t(heads, length):
            return torch.randn((1, heads, length, d), generator=gen,
                               device=dev).to(torch.bfloat16)
        return (t(Q_HEADS, rows), t(KV_HEADS, cols), t(KV_HEADS, cols),
                t(Q_HEADS, rows))

    def check(name, got, ref, fault=None):
        r = closeness(got, ref)
        if fault is not None:
            r["planted_fault"] = closeness(fault, ref)
        readings[name] = r
        if not within_limits(r):
            problems.append(f"{name} disagrees with its plain version")
        if fault is not None and within_limits(r["planted_fault"]):
            problems.append(f"the {name} check does not see a one-tile "
                            "fault")

    def by_kv_head(fn, q, k, v, do):
        """fn (a plain backward) over one kv head and its group of q
        heads at a time, which keeps its float32 [group, n, n]
        intermediates near 1 GB each."""
        out = [torch.empty(t.shape, dtype=torch.float32, device=dev)
               for t in (q, k, v)]
        for j in range(KV_HEADS):
            g = slice(j * group, (j + 1) * group)
            one = slice(j, j + 1)
            for o_, part in zip(out, fn(q[:, g], k[:, one], v[:, one],
                                        do[:, g])):
                o_[:, g if o_.shape[1] == Q_HEADS else one] = part
        return out

    src = "metal_flash_attention_tpu_torch/csrc/"
    jax_src = "metal_flash_attention_tpu/ops/"
    results = []

    # flash_fwd at the training shape.  Fault: the last query tile of the
    # last head without its diagonal key tile (a key loop that stops one
    # tile early).
    q, k, v, do = qkv(n, n)
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    po, plse = fa._forward_plain(q, k, v, causal=True, window_size=None,
                                 scale=scale, out_dtype=torch.float32)
    fault = o.clone()
    fault[:, h:h + 1, last] = attention_reference(
        q[:, h:h + 1, last], k[:, kvh:kvh + 1, :n - TILE_ROWS],
        v[:, kvh:kvh + 1, :n - TILE_ROWS], scale=scale).to(o.dtype)
    check("flash_fwd.o", o, po, fault)
    lse_errs = [max_abs_err(lse, plse)]
    del po, plse, fault

    # flash_fwd at the dense prefill's shape: the whole batch of
    # DENSE_BATCH x DENSE_PROMPT through the kernel once (the batch
    # offsets; the half-full last query tile on the causal diagonal,
    # 8,160 = 127.5 x 64), the first and the last sequence held against
    # the plain version one kv head at a time.  Fault: the last (partial)
    # query tile of the last head of the last sequence without its
    # diagonal key tile.
    m = DENSE_PROMPT
    tail = slice((m - 1) // TILE_ROWS * TILE_ROWS, m)

    def dense(heads):
        return torch.randn((DENSE_BATCH, heads, m, d), generator=gen,
                           device=dev).to(torch.bfloat16)
    pq, pk, pv = dense(Q_HEADS), dense(KV_HEADS), dense(KV_HEADS)
    p_o, p_lse = fa.flash_attention_forward(pq, pk, pv, causal=True)
    for s in (0, DENSE_BATCH - 1):
        one = slice(s, s + 1)
        po = torch.empty((1, Q_HEADS, m, d), dtype=torch.float32,
                         device=dev)
        plse = torch.empty((1, Q_HEADS, m), dtype=torch.float32, device=dev)
        for j in range(KV_HEADS):
            g = slice(j * group, (j + 1) * group)
            po[:, g], plse[:, g] = fa._forward_plain(
                pq[one, g], pk[one, j:j + 1], pv[one, j:j + 1], causal=True,
                window_size=None, scale=scale, out_dtype=torch.float32)
        fault = None
        if s == DENSE_BATCH - 1:
            fault = p_o[one].clone()
            fault[:, h:h + 1, tail] = attention_reference(
                pq[one, h:h + 1, tail], pk[one, kvh:kvh + 1, :tail.start],
                pv[one, kvh:kvh + 1, :tail.start], scale=scale).to(o.dtype)
        check(f"flash_fwd.o_prefill_seq{s}", p_o[one], po, fault)
        lse_errs.append(max_abs_err(p_lse[one], plse))
        del po, plse, fault
    with CardSampler() as sampler:
        prefill = timed_spread(lambda: fa.flash_attention_forward(
            pq, pk, pv, causal=True), 5)
        prefill_card = sampler.stop()
    prefill_lib = timed_spread(lambda: F.scaled_dot_product_attention(
        pq, pk, pv, is_causal=True, enable_gqa=True), 5)
    prefill_bound = bound(
        4 * d * DENSE_BATCH * Q_HEADS * visible_pairs(m, m, True, None),
        nbytes(pq, pk, pv, p_o, p_lse))
    del pq, pk, pv, p_o, p_lse
    torch.cuda.empty_cache()

    rows, cols, window = WINDOW_CASE
    wq, wk, wv, _ = qkv(rows, cols)
    wo, wlse = fa.flash_attention_forward(wq, wk, wv, causal=True,
                                          window_size=window)
    wpo, wplse = fa._forward_plain(wq, wk, wv, causal=True,
                                   window_size=window, scale=scale,
                                   out_dtype=torch.float32)
    check("flash_fwd.o_window", wo, wpo)
    lse_errs.append(max_abs_err(wlse, wplse))
    if max(lse_errs) > MIXED_TOL.lse:
        problems.append(f"flash_fwd's lse disagrees: {lse_errs}")
    del wq, wk, wv, wo, wlse, wpo, wplse
    torch.cuda.empty_cache()

    # flash_bwd_dq and flash_bwd_dkv on the same inputs.  Faults: dQ of
    # the forward's faulty tile; dK/dV of the middle key tile of the last
    # kv head without the group's last query tile (a query-tile loop
    # that stops one tile early).
    dq, dk, dv = fb.flash_attention_backward(q, k, v, do, o, lse,
                                             causal=True)
    for name, t in (("dq", dq), ("dk", dk), ("dv", dv)):
        if not torch.isfinite(t).all():
            problems.append(f"non-finite {name} from the backward kernels")
    rdq, rdk, rdv = by_kv_head(
        lambda *a: attention_reference_grads(*a, causal=True,
                                             scale=scale)[:3], q, k, v, do)
    fdq = dq.clone()
    fdq[:, h:h + 1, last] = attention_reference_grads(
        q[:, h:h + 1, last], k[:, kvh:kvh + 1, :n - TILE_ROWS],
        v[:, kvh:kvh + 1, :n - TILE_ROWS], do[:, h:h + 1, last],
        scale=scale)[0].to(dq.dtype)
    _, cdk, cdv, *_ = attention_reference_grads(
        q[:, grp, last], k[:, kvh:kvh + 1], v[:, kvh:kvh + 1],
        do[:, grp, last], causal=True, scale=scale)
    fdk, fdv = dk.clone(), dv.clone()
    fdk[:, kvh, mid] -= cdk[:, 0, mid].to(dk.dtype)
    fdv[:, kvh, mid] -= cdv[:, 0, mid].to(dv.dtype)
    check("flash_bwd_dq.dq", dq, rdq, fdq)
    check("flash_bwd_dkv.dk", dk, rdk, fdk)
    check("flash_bwd_dkv.dv", dv, rdv, fdv)
    del rdq, rdk, rdv, fdq, fdk, fdv, cdk, cdv
    torch.cuda.empty_cache()
    print("flash_checks: " + json.dumps({
        "readings": readings, "lse_max_abs_err": lse_errs,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                   "lse_abs": MIXED_TOL.lse}}), flush=True)
    if problems:
        fail("; ".join(problems))

    with CardSampler() as sampler:
        fwd = timed_spread(lambda: fa.flash_attention_forward(
            q, k, v, causal=True), 20)
        fwd_card = sampler.stop()
    plain_ms, _ = timed(lambda: fa._forward_plain(
        q, k, v, causal=True, window_size=None, scale=scale,
        out_dtype=torch.bfloat16), 3)
    lib = timed_spread(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    pairs = visible_pairs(n, n, True, None) * Q_HEADS
    bound_ms, bound_by = bound(4 * d * pairs, nbytes(q, k, v, o, lse))
    limits = {"tile_rel_rms": KERNEL_TILE_REL_RMS}
    shape = "q [1, 32, 8192, 128], k/v [1, 8, 8192, 128] causal"
    results.append({
        "name": "flash_fwd", "route": "cuda",
        "source": src + "flash_attention.cu",
        "replaces": jax_src + "flash_attention.py:223 (and :552, the "
                    "visible-blocks-only variant)",
        "launches": launches["flash_fwd"],
        "launches_sm90": launches["flash_fwd_sm90"],
        "max_abs_err": max(readings[key]["max_abs_err"] for key in readings
                           if key.startswith("flash_fwd.")),
        **{key[len("flash_fwd."):]: r for key, r in readings.items()
           if key.startswith("flash_fwd.")},
        "lse_max_abs_err": max(lse_errs),
        "limits": dict(limits, lse_abs=MIXED_TOL.lse),
        "ms": fwd["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib["ms"],
        "wall_ms": fwd["wall_ms"], "spread": fwd, "library_spread": lib,
        "library": "F.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True)",
        "card_during_loops": fwd_card,
        "ms_prefill_shape": prefill["ms"],
        "bound_ms_prefill_shape": prefill_bound[0],
        "library_ms_prefill_shape": prefill_lib["ms"],
        "spread_prefill_shape": prefill,
        "library_spread_prefill_shape": prefill_lib,
        "card_during_loops_prefill_shape": prefill_card,
        "shape": shape + " (timed); q_len 1000 vs kv_len 1536, "
                 f"window 512; the dense prefill's q [{DENSE_BATCH}, 32, "
                 f"{DENSE_PROMPT}, 128] causal (checked on sequences 0 "
                 f"and {DENSE_BATCH - 1}, timed as *_prefill_shape)"})

    lse_c = lse.contiguous()
    d_term = (do.float() * o.float()).sum(dim=-1)
    kw = dict(causal=True, window_size=None, scale=scale)
    with CardSampler() as sampler:
        dq_t = timed_spread(lambda: fb._dq_cuda(
            q, k, v, do, lse_c, d_term, **kw), 10)
        dkv_t = timed_spread(lambda: fb._dkv_cuda(
            q, k, v, do, lse_c, d_term, **kw), 10)
        bwd_card = sampler.stop()
    plain_bwd_ms, _ = timed(lambda: by_kv_head(
        lambda *a: fb._backward_plain(*a, **kw), q, k, v, do), 2)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                            enable_gqa=True)
    lib_bwd = timed_spread(lambda: torch.autograd.grad(
        sdpa_o, leaves, do, retain_graph=True), 10)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                             enable_gqa=True)
        torch.autograd.grad(out, leaves, do)
    lib_fwd_bwd_ms, _ = timed(sdpa_fwd_bwd, 10)

    io = nbytes(q, k, v, do, lse_c, d_term)
    pair_ms = dq_t["ms"] + dkv_t["ms"]
    common = {"route": "cuda", "source": src + "flash_attention_bwd.cu",
              "limits": limits, "plain_ms": plain_bwd_ms,
              "plain_computes": "dq, dk and dv together, one kv head at "
                                "a time",
              "library_ms": lib_bwd["ms"], "library_spread": lib_bwd,
              "library": "backward of F.scaled_dot_product_attention("
                         "is_causal=True, enable_gqa=True): dq, dk, dv",
              "library_fwd_bwd_ms": lib_fwd_bwd_ms,
              "pair_ms": pair_ms, "pair_over_library": pair_ms
              / lib_bwd["ms"],
              "card_during_loops": bwd_card, "shape": shape}
    bound_ms, bound_by = bound(2 * d * 3 * pairs, io + nbytes(dq))
    results.append(dict(
        common, name="flash_bwd_dq",
        replaces=jax_src + "flash_attention_bwd.py:73",
        launches=launches["flash_bwd_dq"],
        launches_sm90=launches["flash_bwd_dq_sm90"],
        max_abs_err=readings["flash_bwd_dq.dq"]["max_abs_err"],
        dq=readings["flash_bwd_dq.dq"], ms=dq_t["ms"],
        wall_ms=dq_t["wall_ms"], spread=dq_t, bound_ms=bound_ms,
        bound_by=bound_by, share_of_bound=bound_ms / dq_t["ms"]))
    bound_ms, bound_by = bound(2 * d * 4 * pairs, io + nbytes(dk, dv))
    results.append(dict(
        common, name="flash_bwd_dkv",
        replaces=jax_src + "flash_attention_bwd.py:226",
        launches=launches["flash_bwd_dkv"],
        launches_sm90=launches["flash_bwd_dkv_sm90"],
        max_abs_err=max(readings["flash_bwd_dkv.dk"]["max_abs_err"],
                        readings["flash_bwd_dkv.dv"]["max_abs_err"]),
        dk=readings["flash_bwd_dkv.dk"], dv=readings["flash_bwd_dkv.dv"],
        ms=dkv_t["ms"], wall_ms=dkv_t["wall_ms"], spread=dkv_t,
        bound_ms=bound_ms, bound_by=bound_by,
        share_of_bound=bound_ms / dkv_t["ms"]))
    return results


def gemm_module():
    """`ops.gemm` the module (the package's `ops` exports the function
    `gemm` under the same name)."""
    return importlib.import_module("metal_flash_attention_tpu_torch.ops.gemm")


def swiglu(h, weights, product):
    """`llama.mlp_block`'s SwiGLU between its norm and its residual, with
    its three products through `product(x, w)`: silu(h Wg) * (h Wu),
    rounded to h's type, times Wd."""
    import torch.nn.functional as F
    gate = F.silu(product(h, weights["w_gate"]).float())
    up = product(h, weights["w_up"]).float()
    return product((gate * up).to(h.dtype), weights["w_down"])


def quant_gemm(params, cfg, dev, card):
    """The weight-quantized MLP of layer 0 at full width: each weight
    quantized per channel in each precision, the SwiGLU block run at each
    of MLP_TOKENS through `gemm` with the launch counts set to 0 just
    before and read just after (4 x 3 x 2 = 24 launches, all on the sm90
    route); the block's output against the unquantized bf16 block; then
    each product's time (median and spread of GEMM_REPEATS loops), bound
    and the library time (torch.matmul on the bf16 weight)."""
    import torch
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops.quantization import (
        quantize_matrix,
    )

    tg = gemm_module()
    layer = params["layers"][0]
    t0 = time.perf_counter()
    qweights = {prec: {name: quantize_matrix(
        layer[name], OperandPrecision(prec), contract_axis=0,
        per_channel=True) for name in MLP_WEIGHTS}
        for prec in QUANT_PRECISIONS}
    torch.cuda.synchronize(dev)
    quantize_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 8)
    hs = {}
    for t in MLP_TOKENS:
        x = torch.as_tensor(rng.standard_normal((t, cfg.dim),
                                                dtype=np.float32),
                            device=dev).to(cfg.dtype)
        hs[t] = llama.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)

    tg.reset_launch_counts()
    outs = {(prec, t): swiglu(hs[t], qweights[prec], tg.gemm)
            for prec in QUANT_PRECISIONS for t in MLP_TOKENS}
    torch.cuda.synchronize(dev)
    launches = dict(tg.LAUNCH_COUNTS)
    expected = len(QUANT_PRECISIONS) * len(MLP_WEIGHTS) * len(MLP_TOKENS)
    if launches["gemm"] != expected or launches["gemm_sm90"] != expected:
        fail(f"quant_gemm launched gemm {launches['gemm']} times, "
             f"{launches['gemm_sm90']} of them on the sm90 route; expected "
             f"{expected} and {expected}")

    # The unquantized block and each product's input at each T.
    inputs, errors = {}, {}
    for t in MLP_TOKENS:
        h = hs[t]
        ref = swiglu(h, layer, torch.matmul).float()
        gate = torch.nn.functional.silu((h @ layer["w_gate"]).float())
        mid = (gate * (h @ layer["w_up"]).float()).to(h.dtype)
        inputs[t] = {"w_gate": h, "w_up": h, "w_down": mid}
        for prec in QUANT_PRECISIONS:
            out = outs[(prec, t)]
            if tuple(out.shape) != (t, cfg.dim) or \
                    not torch.isfinite(out).all():
                fail(f"quant_gemm {prec} at T={t} gave shape "
                     f"{tuple(out.shape)} or non-finite values")
            err = out.float() - ref
            errors[f"{prec}_T{t}"] = float(err.pow(2).sum().sqrt()
                                           / ref.pow(2).sum().sqrt())

    cases = []
    for t in MLP_TOKENS:
        iters = 5 if t >= 1024 else 50
        for name in MLP_WEIGHTS:
            x = inputs[t][name]
            w_bf16 = layer[name]
            lib = timed_spread(lambda: torch.matmul(x, w_bf16), iters)
            flops = 2 * t * w_bf16.shape[0] * w_bf16.shape[1]
            out_bytes = t * w_bf16.shape[1] * 2
            for prec in QUANT_PRECISIONS:
                w = qweights[prec][name]
                spread = timed_spread(lambda: tg.gemm(x, w), iters)
                bound_ms, bound_by = bound(
                    flops, nbytes(x, w.values, w.scale) + out_bytes)
                cases.append({
                    "precision": prec, "tokens": t, "weight": name,
                    "shape": [t, *w.shape], **spread,
                    "bound_ms": bound_ms, "bound_by": bound_by,
                    "library_ms": lib["ms"],
                    "library_ms_min": lib["ms_min"],
                    "library_ms_max": lib["ms_max"],
                    "weight_bytes": nbytes(w.values, w.scale)})
    print("quant_gemm: " + json.dumps({
        "config": "llama3_8b layer 0 MLP (dim 4096, hidden 14336), weights "
                  "quantized per channel, bf16 activations",
        "tokens": list(MLP_TOKENS), "launches": launches,
        "quantize_seconds": quantize_s,
        "block_rel_err_vs_bf16": errors, "cases": cases,
        "library": "torch.matmul(x, the layer's bf16 weight)",
        "card": card}), flush=True)
    return qweights, inputs, launches, cases


def gemm_kernel_checks(dev, qweights, inputs, launches, cases) -> dict:
    """The GEMM kernel against `_gemm_plain` on the same inputs: each
    precision at T = 8192 on w_gate and at T = 8 on w_down, and dense
    bf16 4096^3 with backend="pallas", each launch on the sm90 route;
    each with a planted fault (one output tile without one GEMM_K_STEP
    K step) that the tile limit must see.  Returns the `kernels` entry."""
    import torch
    from metal_flash_attention_tpu_torch.ops.quantization import (
        dequantize_matrix,
    )

    tg = gemm_module()
    gen = torch.Generator(device=dev).manual_seed(SEED + 10)
    da, db = (torch.randn((DENSE_GEMM, DENSE_GEMM), generator=gen,
                          device=dev).to(torch.bfloat16) for _ in range(2))
    big, small = MLP_TOKENS
    checks = [(f"{prec}_w_gate_T{big}", inputs[big]["w_gate"],
               qweights[prec]["w_gate"]) for prec in QUANT_PRECISIONS]
    checks += [(f"{prec}_w_down_T{small}", inputs[small]["w_down"],
                qweights[prec]["w_down"]) for prec in QUANT_PRECISIONS]
    checks.append((f"bf16_dense_{DENSE_GEMM}", da, db))
    readings, problems = {}, []
    for name, x, w in checks:
        kw = {"backend": "pallas"} if isinstance(w, torch.Tensor) else {}
        before = tg.LAUNCH_COUNTS["gemm_sm90"]
        got = tg.gemm(x, w, **kw)
        if tg.LAUNCH_COUNTS["gemm_sm90"] != before + 1:
            problems.append(f"gemm {name} did not take the sm90 route")
        ref = tg._gemm_plain(x, w, **kw)
        rows = min(GEMM_TILE[0], x.shape[0])
        r = closeness(got, ref, rows, GEMM_TILE[1])
        # Fault: the last full output tile without the K step in the
        # middle of K.
        k = x.shape[1]
        ks = slice(k // 2, k // 2 + GEMM_K_STEP)
        rs = slice(x.shape[0] - rows, x.shape[0])
        cs = slice(0, GEMM_TILE[1])
        wv = (w.float() if isinstance(w, torch.Tensor)
              else dequantize_matrix(w, contract_axis=0))
        fault = got.float()
        fault[rs, cs] -= x[rs, ks].float() @ wv[ks, cs]
        r["planted_fault"] = closeness(fault, ref, rows, GEMM_TILE[1])
        readings[name] = r
        if not within_limits(r):
            problems.append(f"gemm {name} disagrees with its plain version")
        if within_limits(r["planted_fault"]):
            problems.append(f"the gemm {name} check does not see a dropped "
                            "K step")
        del got, ref, wv, fault
    print("gemm_checks: " + json.dumps({
        "readings": readings, "tile": list(GEMM_TILE),
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS}}), flush=True)
    if problems:
        fail("; ".join(problems))

    dense = timed_spread(lambda: tg.gemm(da, db, backend="pallas"), 10)
    dense_lib = timed_spread(lambda: torch.matmul(da, db), 10)
    dense_bound = bound(2 * DENSE_GEMM ** 3, nbytes(da, db, da))
    x, w = inputs[big]["w_gate"], qweights["int8"]["w_gate"]
    plain_ms, _ = timed(lambda: tg._gemm_plain(x, w), 3)
    main = next(c for c in cases if c["precision"] == "int8"
                and c["tokens"] == big and c["weight"] == "w_gate")
    return {
        "name": "gemm", "route": "cuda",
        "source": "metal_flash_attention_tpu_torch/csrc/gemm.cu",
        "headers": ["metal_flash_attention_tpu_torch/csrc/hopper_common.cuh",
                    "metal_flash_attention_tpu_torch/csrc/quant_common.cuh"],
        "replaces": "metal_flash_attention_tpu/ops/gemm.py:112",
        "launches": launches["gemm"],
        "launches_by_route": {
            "sm90 (gemm90_kernel: TMA ring, wgmma)": launches["gemm_sm90"],
            "mma (gemm_kernel: mma.sync)":
                launches["gemm"] - launches["gemm_sm90"]},
        "max_abs_err": max(r["max_abs_err"] for r in readings.values()),
        "checks": readings,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS},
        "ms": main["ms"], "ms_min": main["ms_min"], "ms_max": main["ms_max"],
        "plain_ms": plain_ms, "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"], "library_ms": main["library_ms"],
        "wall_ms": main["wall_ms"],
        "library": "torch.matmul(x, the bf16 weight)",
        "shape": f"x [{big}, 4096] bf16 x w_gate [4096, 14336] INT8 per "
                 "channel (timed; every precision, weight and T in "
                 "quant_gemm's cases)",
        "dense_4096_pallas_ms": dense["ms"],
        "dense_4096_pallas_ms_min": dense["ms_min"],
        "dense_4096_pallas_ms_max": dense["ms_max"],
        "dense_4096_wall_ms": dense["wall_ms"],
        "dense_4096_bound_ms": dense_bound[0],
        "dense_4096_library_ms": dense_lib["ms"]}


def softmax_kernel_checks(dev, card) -> list[dict]:
    """Both softmax kernels on scores [1, 32, 8192, 8192] bf16 (Llama-3-8B's
    heads at the training path's 8,192 tokens), launch counts set to 0
    just before and read just after; each held against its plain version
    one head at a time, with a planted fault; then their times, bounds,
    the plain versions' (one head at a time) and the library calls'."""
    import torch
    from metal_flash_attention_tpu_torch.ops import softmax as ts

    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    shape = (1, Q_HEADS, TRAIN_TOKENS, TRAIN_TOKENS)
    s = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    dp = torch.randn(shape, generator=gen, device=dev, dtype=torch.bfloat16)
    scale = TRAIN_TOKENS ** -0.5
    dscale = SOFTMAX_SCALE_DERIVATIVE
    ts.reset_launch_counts()
    p = ts.scaled_softmax(s)
    ds = ts.derivative_softmax(p, dp, scale=dscale)
    torch.cuda.synchronize(dev)
    launches = dict(ts.LAUNCH_COUNTS)
    if any(n != 1 for n in launches.values()):
        fail(f"softmax kernels launched {launches}, expected once each")
    for name, t in (("p", p), ("ds", ds)):
        if t.shape != s.shape or t.dtype != s.dtype or \
                not torch.isfinite(t).all():
            fail(f"softmax output {name} has the wrong shape, type or "
                 "non-finite values")

    worst = {"scaled_softmax": None, "derivative_softmax": None}

    def keep(name, r):
        if worst[name] is None or r["tile_rel_rms"] > \
                worst[name]["tile_rel_rms"]:
            worst[name] = dict(r)
    rows = slice(TRAIN_TOKENS // 2, TRAIN_TOKENS // 2 + TILE_ROWS)
    last = Q_HEADS - 1
    faults = {}
    for h in range(Q_HEADS):
        ref_p = ts._scaled_softmax_plain(s[0, h], scale)
        ref_ds = ts._derivative_softmax_plain(p[0, h], dp[0, h], dscale)
        keep("scaled_softmax", closeness(p[0, h], ref_p))
        keep("derivative_softmax", closeness(ds[0, h], ref_ds))
        if h == last:
            # Fault: the tile's rows without their last 64 columns, in
            # the sums as in the output.
            fp = p[0, h].float()
            tile = fp[rows]
            tile[:, :-64] /= 1.0 - tile[:, -64:].sum(dim=-1, keepdim=True)
            tile[:, -64:] = 0
            fp[rows] = tile
            faults["scaled_softmax"] = closeness(fp, ref_p)
            pv, dv = p[0, h, rows].float(), dp[0, h, rows].float()
            d = (pv[:, :-64] * dv[:, :-64]).sum(dim=-1, keepdim=True)
            fds = ds[0, h].float()
            fds[rows] = torch.cat([pv[:, :-64] * (dv[:, :-64] - d) * dscale,
                                   torch.zeros_like(pv[:, -64:])], dim=-1)
            faults["derivative_softmax"] = closeness(fds, ref_ds)
        del ref_p, ref_ds
    problems = []
    for name in worst:
        worst[name]["planted_fault"] = faults[name]
        if not within_limits(worst[name]):
            problems.append(f"{name} disagrees with its plain version")
        if within_limits(faults[name]):
            problems.append(f"the {name} check does not see 64 lost columns")
    print("softmax_checks: " + json.dumps({
        "shape": list(shape), "dtype": "bf16", "launches": launches,
        "readings": worst, "scale": scale, "derivative_scale": dscale,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS}, "card": card}),
        flush=True)
    if problems:
        fail("; ".join(problems))

    sm_ms, sm_wall = timed(lambda: ts.scaled_softmax(s), 5)
    sm_lib, _ = timed(lambda: torch.softmax(s, -1), 5)
    sm_plain, _ = timed(lambda: [ts._scaled_softmax_plain(s[0, h], scale)
                                 for h in range(Q_HEADS)], 2)
    d_ms, d_wall = timed(lambda: ts.derivative_softmax(p, dp, scale=dscale),
                         5)
    d_lib, _ = timed(lambda: torch._softmax_backward_data(
        dp, p, -1, p.dtype), 5)
    d_plain, _ = timed(lambda: [ts._derivative_softmax_plain(
        p[0, h], dp[0, h], dscale) for h in range(Q_HEADS)], 2)
    n = s.numel()
    src = "metal_flash_attention_tpu_torch/csrc/softmax.cu"
    common = {"route": "cuda", "source": src,
              "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS},
              "shape": "[1, 32, 8192, 8192] bf16",
              "plain_computes": "one head at a time, float32"}
    sm_bound = bound(6 * n, 2 * 2 * n)
    d_bound = bound(5 * n, 3 * 2 * n)
    return [
        dict(common, name="scaled_softmax",
             replaces="metal_flash_attention_tpu/ops/softmax.py:60",
             launches=launches["scaled_softmax"],
             max_abs_err=worst["scaled_softmax"]["max_abs_err"],
             p=worst["scaled_softmax"], ms=sm_ms, wall_ms=sm_wall,
             plain_ms=sm_plain, bound_ms=sm_bound[0],
             bound_by=sm_bound[1], library_ms=sm_lib,
             library="torch.softmax(s, -1) (scale 1.0, the same work)"),
        dict(common, name="derivative_softmax",
             replaces="metal_flash_attention_tpu/ops/softmax.py:115",
             launches=launches["derivative_softmax"],
             max_abs_err=worst["derivative_softmax"]["max_abs_err"],
             ds=worst["derivative_softmax"], ms=d_ms, wall_ms=d_wall,
             plain_ms=d_plain, bound_ms=d_bound[0], bound_by=d_bound[1],
             library_ms=d_lib,
             library="torch._softmax_backward_data(dp, p, -1, bf16) "
                     "(scale 1.0, the same work)")]


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
    phases = {}

    def phase(name, fn, *args):
        """fn(*args), its wall seconds kept under `name`."""
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        return out

    t0 = time.perf_counter()
    libs = phase("build", build_all)
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
    torch.cuda.reset_peak_memory_stats(dev)
    eng, rids, secs, steps, num_pages = phase("serve", serve, params, cfg,
                                              prompts, dev)
    paged_launches = dict(pa.LAUNCH_COUNTS)
    peak = torch.cuda.max_memory_allocated(dev)
    for name in ("paged_decode", "paged_prefill"):
        if paged_launches[name] == 0:
            fail(f"kernel {name} was not launched on the serving path")
        if paged_launches[f"{name}_sm90"] != paged_launches[name]:
            fail(f"{name} launched {paged_launches[name]} times, its "
                 f"Hopper kernel {paged_launches[f'{name}_sm90']}")
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
    bf16_serve = {"seconds": secs, "new_tokens_per_s": tokens / secs,
                  "max_memory_allocated": peak,
                  "pool_bytes": pool_bytes(eng._k, eng._v)}
    print("serve: " + json.dumps({
        "requests": len(prompts), "prompt_tokens": int(sum(PROMPT_LENS)),
        "new_tokens": tokens, "seconds": secs, "steps": steps,
        "new_tokens_per_s": tokens / secs, "max_memory_allocated": peak,
        "pool_bytes": bf16_serve["pool_bytes"], "launches": {
            k: n for k, n in paged_launches.items() if n},
        "card": card}), flush=True)

    rel_rms, max_err = phase("reference", reference_check, params, cfg, dev)
    print(f"reference: {REFERENCE_LAYERS}-layer cut, {REFERENCE_PROMPT}-token "
          f"prompt, paged logits vs dense attention_reference: relative "
          f"rms err {rel_rms:.5f} (tol {REF_REL_RMS}), max abs err "
          f"{max_err:.5f} (tol {REF_MAX_ABS})", flush=True)
    if not (rel_rms <= REF_REL_RMS and max_err <= REF_MAX_ABS):
        fail("paged path disagrees with the dense reference")
    kernels = phase("paged_checks", paged_kernel_checks, dev,
                    paged_launches)

    # The quantized serve and the dense path run on the same full-depth
    # weights; the engine's pools go first.
    del eng
    torch.cuda.empty_cache()
    quant_launches = phase("quant_serve", quant_serve, params, cfg, prompts,
                           dev, card, bf16_serve)
    torch.cuda.empty_cache()
    burst_launches = phase("burst_serve", burst_serve, params, cfg, prompts,
                           dev, card)
    torch.cuda.empty_cache()
    phase("quant_reference", quant_reference, params, cfg, dev)
    dense_launches = phase("dense_serve", dense_serve, params, cfg, dev,
                           card)
    phase("decode_reference", decode_reference, params, cfg, dev)
    qweights, mlp_inputs, gemm_launches, gemm_cases = phase(
        "quant_gemm", quant_gemm, params, cfg, dev, card)
    gemm_kernel = phase("gemm_checks", gemm_kernel_checks, dev, qweights,
                        mlp_inputs, gemm_launches, gemm_cases)
    del qweights, mlp_inputs
    # Free the 14.5 GB of weights before training (generate's 8.6 GB
    # cache went with its call).
    del params
    torch.cuda.empty_cache()
    decode_kernel = phase("decode_checks", decode_kernel_checks, dev,
                          dense_launches)
    torch.cuda.empty_cache()
    quant_kernels = phase("quant_kernel_checks", quant_kernel_checks, dev,
                          quant_launches)
    torch.cuda.empty_cache()

    tparams, tcfg, flash_launches = phase("train", train, dev, card)
    phase("train_reference", train_reference, tparams, tcfg, dev)
    del tparams
    torch.cuda.empty_cache()
    kernels += phase("flash_checks", flash_kernel_checks, dev,
                     flash_launches)
    torch.cuda.empty_cache()
    softmax_kernels = phase("softmax_checks", softmax_kernel_checks, dev,
                            card)
    torch.cuda.empty_cache()
    for entry in kernels:
        if entry["name"] == "flash_fwd":
            burst = burst_launches[QUANT_SERVE_PRECISION]
            entry["launches_by_path"] = {
                "train": flash_launches["flash_fwd"],
                "dense_serve": dense_launches["flash_fwd"],
                "quant_serve": quant_launches["flash_fwd"],
                "burst_serve": burst["flash_fwd"]}
            entry["launches_sm90_by_path"] = {
                "train": flash_launches["flash_fwd_sm90"],
                "dense_serve": dense_launches["flash_fwd_sm90"],
                "quant_serve": quant_launches["flash_fwd_sm90"],
                "burst_serve": burst["flash_fwd_sm90"]}
        if entry["name"] in ("paged_decode", "paged_prefill"):
            entry["launches_by_path"] = {
                "serve": entry["launches"],
                "burst_serve": burst_launches["bf16"][entry["name"]]}
    decode_kernel["launches_by_path"] = {
        "dense_serve": dense_launches["flash_decode"],
        "quant_serve": quant_launches["flash_decode"],
        "burst_serve": burst_launches[QUANT_SERVE_PRECISION]["flash_decode"]}
    for entry in quant_kernels:
        entry["launches_by_path"] = {
            "quant_serve": entry["launches"],
            "burst_serve": burst_launches[QUANT_SERVE_PRECISION].get(
                entry["name"], 0)}
    kernels.append(decode_kernel)
    kernels.append(gemm_kernel)
    kernels += softmax_kernels
    kernels += quant_kernels

    print("phases: " + json.dumps(phases))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
