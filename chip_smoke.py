#!/usr/bin/env python3
"""Drive the PyTorch port's paged serving (bf16 and quantized KV, by
step and by burst, greedy and sampled, with and without the prefix
cache, speculative), beam search, dense serving and training paths, the fused forward over
quantized K/V, its standalone ops (quantized GEMM, softmax), Gemma-2
serving (paged and dense) and training (the soft cap and head_dim 256 in
the kernels, forward and backward), and the flash-attention options
(masks, bias with its gradient, segment ids, `compat`), the runtime
(tile sweeps over variant libraries, dispatch by the config cache, the
autotune CLI), weights in and out with LoRA (HF conversion, token
shards, checkpoint and resume, multi-adapter fine-tuning on a frozen
base and serving), Mixtral-style MoE serving and training, ring and
zigzag attention with the GPipe pipeline, float32 training and the
multi-chip dry run at world size 1, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result):

1. build every kernel of `metal_flash_attention_tpu_torch/csrc/` with
   nvcc for sm_90a, and the runtime phase's tile variants (one nvcc per
   library, all started together);
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
4a. tp_serve: tensor-parallel serving at world size 1 on this card: a
   one-rank NCCL process group (over a `FileStore` in a temporary
   directory) and `make_mesh(heads=1)`, the serve phase's weights cut to
   the rank's blocks (`parallel.mesh.shard` under `llama.param_shardings`,
   whole at tp 1), and the same 6 requests through `ServingEngine` with
   ``kv_sharding`` and the steps partial on the mesh.  Every paged launch
   count set to 0 just before and read just after: equal to the serve
   phase's, all on the Hopper kernels; the streams must equal the serve
   phase's token for token.  At world size 1 every collective is over an
   axis of one rank and skips its all-reduce or all-gather; the line
   counts, by axis, the collective points the mesh steps reached, and
   the phase fails if they reached none; the 4-card run is
   `tools/tp_probe.py`;
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
   over bf16 and then INT8 pools, at full width on the first
   ENGINE_PHASE_LAYERS layers (host-bound, its steps repeat a layer's
   work, and the script must stay within its limit), greedy; every
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
4d. prefix_serve: the engine with ``prefix_cache=True`` (its allocator
   the C++ one, `NativePageAllocator`) over bf16 and then INT8 pools, at
   full width on the first ENGINE_PHASE_LAYERS layers (as burst_serve),
   page 128: (a) the time to first token of a
   2,048-token prompt cold (the cache flushed) and warm (15 of its 16
   pages borrowed), best of 2 each, after the JAX package's
   bench.py:283-330; (b) request 0 alone (a 1,536-token shared prefix, 12
   pages, and its own suffix), then 5 more of the same prefix and a
   distinct 200-600-token suffix, 32 new tokens each, max_batch 4, on an
   engine with the cache and on one without: every launch count set to 0
   just before each run and read just after and held exact (the chunk
   steps those of each prompt's unshared part: the paged prefill from a
   nonzero start over borrowed pages), greedy streams equal token for
   token, 5 x 1,536 = 7,680 hit tokens, every page back after the cache's
   flush; new tokens/s and each request's time to first token, both
   engines;
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
6b. weights in and out, and LoRA, on the same full-depth weights:
   convert: the weights written out as an HF checkpoint (HF's names,
   projections [out, in], bf16, in host memory as a loaded checkpoint
   is) with a plain config object carrying HF's field names and
   Llama-3.1's rope_scaling, converted onto the card by
   `models.convert.params_from_hf_llama` and held to the source bit for
   bit (seconds and peak device memory printed), with a planted fault
   (one layer's wk and wv swapped) that must show as exactly those two
   leaves; gemma2_2b the same way in phase 12 (`convert:` lines);
   lora_train: LORA_ADAPTERS adapters of rank LORA_RANK on wq/wk/wv/wo
   (`models.lora`, b_scale 0) trained on the frozen 32-layer base by
   `make_lora_train_step` (AdamW, LORA_LR) on rows of adapters
   LORA_IDS, LORA_BATCH x LORA_SEQ tokens a step from a `TokenLoader`
   over two shards (`write_shard`: a repeated 512-token random phrase,
   uint16 and int32), LORA_STEPS steps: the forward, dQ and dK/dV
   kernels launched exactly once a layer a step (all `_sm90`), no
   gradient on a base tensor, Adam's first moment exactly zero in the
   rows of adapters 0 and 3 and not in 1 and 2, the loss finite and
   falling; `utils.checkpoint.save` after step LORA_SAVE_AFTER
   (adapters, optimizer state, the loader's position), then fresh
   adapters and optimizer restored from `latest(...)` and the loader
   resumed by `from_state` run the remaining steps again, which must
   be bit-identical (losses and adapters); one more step under
   torch.profiler (`lora_train_profile:`, the forward deltas in
   `lora_delta` ranges) and the delta products timed alone;
   lora_train_reference: on a 2-layer cut, the LoRA loss and every
   adapter gradient against the plain-attention path (`plain_hidden`),
   TRAIN_LOSS_ABS and TRAIN_GRAD_REL_RMS, with two planted faults (the
   wo delta dropped; each row given its neighbour's adapter) that must
   read above them; lora_serve: the engine with ``lora=`` the trained
   stack (adapter 3 drawn at LORA_B_SCALE), 6 requests, lora ids
   LORA_SERVE_IDS, the paged launch counts exact (all `_sm90`), each
   request's logits at every step against its own single-request run
   (teacher-forced on the batched run's tokens) within REF_REL_RMS,
   adapter-0 rows against the engine without LoRA the same way, a
   planted fault (the adapter-3 slot given its neighbour's adapter)
   that must read above it, the share of equal greedy tokens, and new
   tokens/s beside the same serve without LoRA;
6c. speculative decoding and beam search, on the same full-depth weights
   (each phase's launch counts set to 0 just before its run and read just
   after, held exact, all on the `_sm90` kernels).  A speculative stream
   is held to the plain greedy stream of its phase up to its first
   difference, where both tokens' logits on the plain path (recomputed
   for that row alone) must lie within SPEC_TIE of its top logit (the
   tie gate); every phase prints how many rows diverged.
   speculative_model: `speculative_generate_model` with the target as
   its own drafter, SPEC_BATCH random SPEC_PROMPT-token prompts, SPEC_NEW
   new tokens, draft_len SPEC_DRAFT, SPEC_ROUNDS rounds a dispatch, every
   dispatch under `torch.cuda.set_sync_debug_mode("error")`
   (`paged_prefill` 4 chunks x 2 models x 32 + rounds x 2 x 32,
   `paged_decode` rounds x 3 x 32), beside `paged_generate` on the same
   prompts: new tokens/s, seconds, rounds, tokens a live row a round,
   peak memory; speculative_weak: the drafter the same weights cut to
   their first SPEC_WEAK_LAYERS layers (the target's final norm and
   head) through `make_model_draft_fn` and `speculative_generate`,
   acceptance a round, whether it agrees with speculative_model token for
   token, and a planted fault (`_accepted` counting one draft more than
   matched) that the tie gate must fail; speculative_engine: the engine
   with a prompt-lookup drafter (`prompt_lookup`, a SPEC_LOOKUP_NGRAM-gram
   over the whole history, on the device) beside the plain engine, the 6
   PROMPT_LENS requests, MAX_NEW new tokens each: each speculative step
   one `paged_prefill` a layer and no decode kernel, every page back, new
   tokens/s and steps of both; verify_checks: the paged prefill kernel at
   the verify shape, q [4, 32, 5, 128] over the target's layer-0 pools
   and a round's ragged lengths from speculative_model (rows live and
   not), one chunk across the page boundary at VERIFY_CROSS, against its
   plain version by the worst tile with a planted fault (the last query
   row without its diagonal key), timed (median, min-max of 5 loops)
   beside its bound, its plain version and the decode kernel over the
   same rows as 5 single-token calls; beam: `beam_generate` (BEAM_BATCH x
   BEAM_K beams, BEAM_PROMPT-token prompts, BEAM_NEW new tokens; one
   `flash_fwd` and 31 `flash_decode` a layer), its steps under sync debug
   mode "error", beside greedy `generate` over the same 8 rows (rows x
   tokens/s of both), the cache gather's share of a step (CUDA events),
   one beam against greedy by the tie gate, the beams distinct and best
   first, and each score against a rescoring of its sequence by
   `llama.forward` within BEAM_SCORE_ABS, which a planted fault (step
   BEAM_FAULT_STEP's gather skipped) must exceed;
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
   kernel's time at the same shape; quant_fwd_checks: K/V quantized per
   (batch, kv head) in INT8, FP8-E4M3, FP8-E5M2 and NF4 through
   `dispatch.attention` at q [1, 32, 8192, 128] causal and at q [1, 32,
   1000, 128] causal from the bottom right, both against 8,192 keys, the
   forward's launch counts set to 0 just before and read just after
   (each call one `flash_fwd`, `flash_fwd_sm90` and
   `flash_fwd_<precision>`); each output against its plain version by the
   worst 64-row tile, with a planted fault (one kv head's K scale taken
   from its neighbour) the limit must see; each timed (median and min-max
   of 5 loops) beside its bound, its plain version, the bf16 kernel at the
   same shape and, as a note, dequantize-then-SDPA;
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
10a. entry: the port's `entry()` on its default device, the card
   (`LlamaConfig.tiny(n_layers=2)`, head_dim 32) on its tokens [2, 256]
   and on random ones: launch counts set to 0 just before and read just
   after (one D 32 forward a layer and call, `flash_fwd_d32`, and nothing
   else), the logits against the same weights' plain path within REF_*; tp_train: `llama.train_step(mesh=)`
   at world size 1 (a one-rank NCCL group, mesh data 1 x heads 1), SGD at
   TP_TRAIN_LR, against the plain `train_step` of the same weights and
   rows, at Llama-3-8B widths on TRAIN_LAYERS layers and 8,193 tokens and
   at the JAX dry run's `LlamaConfig.tiny(n_layers=2, n_heads=4,
   n_kv_heads=1)` (head_dim 32) on [2, 129]: equal, or within the
   training gates (TRAIN_LOSS_ABS, the update's relative rms
   TRAIN_GRAD_REL_RMS), flash counts exact and all on the sm90 kernels
   (at D 32 on `_d32` too), the collective points of both axes
   reached; d32_checks: the forward, dQ and dK/dV
   kernels at head_dim 32 (q D32_SHAPE causal) against their plain
   versions by the worst 64-row tile and lse, each with a planted
   one-tile fault, timed beside their bounds, the plain versions and
   SDPA (forward and backward), as `flash_fwd_d32`, `flash_bwd_dq_d32`
   and `flash_bwd_dkv_d32` in the kernels line;
10b. ring_checks: the per-rank bodies of ring attention and zigzag
   (`parallel.ring_attention`, `parallel.zigzag`), forward then
   backward, on RING_RANKS threads of this card that take turns and hand
   each other K/V and the dK/dV sums (`ThreadRing`; autograd's one
   device thread would deadlock ranks that wait on each other inside a
   backward, so the bodies run directly), at Llama-3-8B's attention
   widths (32 q heads, 8 kv heads, D 128, 4 ranks of 4,096 tokens) and
   at the tiny configs' (D 32): the gathered o, lse, dq, dk and dv
   against the one-card flash forward and backward over the whole
   sequence (the worst 64-row tile, KERNEL_TILE_REL_RMS; lse at
   MIXED_TOL), exact launch counts on the sm90 kernels (the causal ring
   1 + 2 + 3 + 4 calls of each kernel, zigzag 6 a rank), a planted fault
   (the closing dK/dV hop skipped), the ring's call shapes (a full chunk
   pair, zigzag's two chunks against one and one against two, the
   backward with the whole sequence's residuals) against the kernels'
   plain versions, and each rank's kernel ms (its calls replayed under
   the profiler: the load balance zigzag is for); pp_check:
   `parallel.pipeline` at world size 1 (a one-rank NCCL group) over
   PP_MICRO microbatches, the stage PP_LAYERS Llama-3-8B layers in bf16:
   loss and gradients against the sequential chain by the training
   gates, exact flash counts;
10c. tiny_serve: `LlamaConfig.tiny()` and `GemmaConfig.tiny()` (head_dim
   32, bf16, seeded weights) through the engine (Llama over bf16, INT8
   and NF4 pools; both by `step()`, `step_burst(TINY_BURST)` and with the
   prefix cache) and dense `generate`, each run's counts set to 0 just
   before and read just after: every launch at D 32 (`_d32`), rows 1 and
   6 launched, exact counts for Llama's `step()` runs, no plain attention
   called (`plain_watch`), the burst and prefix streams equal `step()`'s
   up to a near tie; then every path's teacher-forced logits, each step
   on the same state, against the plain versions on the card
   (`plain_on_card`) at REF_*; new tokens/s a run; docs_examples: the
   docs' single-device examples (tests/test_docs_examples.py's cases but
   the two that need 8 devices) through the port's public API, each
   against itself under `plain_on_card` (attention by the worst 64-row
   tile, the GEMM, the training guide's losses and master weights, the
   decode loop's logits), the decode loop on `flash_decode_d32`; then
   d32_checks, and d32_decode_checks: rows 1 (decode, prefill, the wide
   decode) and 6 at D 32 over bf16 and each quantized pool or cache and
   with Gemma's cap and window, each against its plain version by the
   worst tile and lse with a planted one-tile fault, timed beside its
   bound, its plain version and (row 6) SDPA with a length mask;
11. softmax_checks: `scaled_softmax` (default scale) and
   `derivative_softmax` (scale 0.5, on P from it and a random dP) on
   scores [1, 32, 8192, 8192] bf16 (Llama-3-8B's heads at the training
   path's 8,192 tokens), launch counts set to 0 just before and read
   just after; each against its plain version one head at a time by the
   worst relative rms error of any 64-row tile (KERNEL_TILE_REL_RMS),
   with a planted fault (one tile's rows without their last 64 columns,
   in the sums as in the output); then their times, bounds, the plain
   versions' (one head at a time) and the library calls'
   (`torch.softmax`, `torch._softmax_backward_data`, at scale 1.0);
11a. float32 on the true-fp32 kernels (`csrc/flash_attention_f32.cu`):
   fp32_train: Llama-3-8B widths in float32 on TRAIN_LAYERS layers,
   TRAIN_TOKENS + 1 tokens, F32_TRAIN_STEPS AdamW steps, every attention
   launch counted on `_f32` (exact), seconds a step, tokens/s, peak
   memory, device ms by family; fp32_train_reference: a 2-layer cut's
   loss and every gradient against plain attention (F32_TRAIN_*), with
   two planted faults; dryrun: the port's `dryrun_multichip(1)` in a
   one-rank NCCL group (JAX's three lines, exact counts); fp32_checks:
   the three kernels at each of F32_CASES (Llama-3-8B's training shape, a
   ragged chunk, Gemma-2's global and local layers, the tiny heads)
   against their plain versions with TF32 off, by F32_TILE_REL_RMS and
   FP32_TOL.lse, with a dropped key tile and TF32-rounded inputs as
   planted faults; times beside bounds at F32_PEAK_FLOPS, the plain
   versions and SDPA's float32 call, and `utils.profiling`'s roofline
   report;
12. Gemma-2 at `gemma2_2b` width and depth (26 layers, dim 2304, 8 heads,
   4 KV heads, head_dim 256, hidden 9216, vocab 256128; a 4,096-token
   window on the even layers; attention softcap 50, final softcap 30),
   bf16, seeded random weights (the Llama weights freed first):
   gemma_serve: the engine with the Gemma hooks
   (``chunk_step=serving.gemma_paged_chunk_step``,
   ``decode_step=serving.gemma_paged_decode_step``), max_batch 4, page
   128, max_seq 8,192, 6 greedy requests of GEMMA_PROMPT_LENS tokens (two
   longer than the window, so the local layers cut) and 32 new tokens
   each, by `step()` and then by `step_burst(16)` (streams equal), then a
   shared 1,536-token prefix and 6 suffixes on an engine with the prefix
   cache and one without (streams equal, 7,680 hit tokens); every run's
   attention launch counts set to 0 just before and read just after and
   held exact (a layer's chunk step one `paged_prefill`, its decode step
   one `paged_decode`, each also counted on its `_sm90`, `_softcap` and
   `_d256` entries, and nothing else launched), every request's tokens,
   every page back; new tokens/s and each request's time to first token;
   gemma_dense: `serving.gemma_generate` on 4 prompts of 5,000 tokens, 32
   new tokens (26 `flash_fwd` and 26 x 31 `flash_decode`, all on the
   capped D 256 kernels, a local layer's window as kv_starts);
   gemma_reference: on a 2-layer cut (one local layer, one global) with a
   5,000-token prompt, the paged (chunks, 2 decode steps) and dense
   (prefill, 2 decode steps) logits against `gemma.forward_hidden` over
   `attention_reference` (REF_*); gemma_kernel_checks: the paged decode,
   the paged prefill, `flash_decode` and `flash_fwd` at the shapes those
   phases ran, against their plain versions by the worst tile at the
   model's cap and at a saturating one (GEMMA_SAT_CAP over queries scaled
   by GEMMA_SAT_GAIN), on a local and a global layer, with two planted
   faults the limit must see (the kernel without its cap; a local layer's
   window dropped); each timed (median, min-max of 5 loops) beside its
   plain version, its bound and, for the dense kernels, `flex_attention`
   with a tanh score_mod and a causal block mask where it compiles (a
   yardstick the port never calls);
13. gemma_train: GEMMA_TRAIN_STEPS `gemma.train_step`s (plain SGD at
   GEMMA_TRAIN_LR over `gemma.loss_fn`: the fused chunked cross-entropy
   over the tied head with the final cap) of `gemma2_2b` at full width
   and depth, bf16, seeded random weights of its own, on one sequence of
   8,193 tokens (8,192 is Gemma-2's context: the local layers' 4,096
   window cuts), no remat (the saved activations, 51 GB, fit beside the
   parameters, gradients and new parameters); the flash launch counts
   set to 0 just before and read just after and held exact (a layer's
   forward one `flash_fwd`, its backward one `flash_bwd_dq` and one
   `flash_bwd_dkv`, each also on `_sm90`, `_softcap` and `_d256`); the
   loss finite and falling; tokens/s over steps 2 on, each step's
   seconds, peak memory, nvidia-smi's samples, and one more step under
   torch.profiler (`gemma_train_profile:`, the fused cross-entropy a
   family of its own); gemma_train_reference: on a 2-layer cut (local,
   global) of the trained weights at 5,000 tokens, the loss and every
   gradient against `loss_fn(fused_ce=False)` over `attention_reference`
   under autograd (TRAIN_*), at the model's cap and at the saturating
   one, with two faults planted in the kernel path that the limits must
   see (dQ without the cap's 1 - t^2, at the saturating cap; dK/dV
   without the local layer's window); gemma_bwd_checks: rows 4g and 5g,
   `flash_bwd_dq` and `flash_bwd_dkv` at q [1, 8, 8192, 256], k/v [1, 4,
   8192, 256] causal, a global and a local layer at cap 50 and a global
   one at the saturating cap, against `_backward_plain` by the worst
   64-row tile (KERNEL_TILE_REL_RMS), with a planted fault each (the
   same two); then each kernel's time on both layers beside its bound,
   its plain version's and `flex_attention`'s backward (tanh score_mod,
   block mask, compiled; a yardstick the port never calls);
14. the flash-attention options at Llama-3-8B's attention widths (32 q
   heads, 8 kv heads, head_dim 128), bf16, seeded numpy inputs:
   options_attention: through the entry points a user calls, each
   forward and backward under autograd with every launch count set to 0
   just before and read just after and held exact (one `flash_fwd`,
   `flash_bwd_dq` and `flash_bwd_dkv`, each also on `_sm90` and `_aux`):
   `flash_attention` over OPT_DOCS packed by segment ids, causal;
   `compat.dot_product_attention` over a padded batch (BTNH, is_causal,
   OPT_PAD_LENS); `flash_attention` with an ALiBi bias over batch
   OPT_BIAS_BATCH and its gradient; `compat.dot_product_attention`
   rectangular causal cross-attention beside a user mask (the mask and
   mask2 path); the first again with ``low_precision_intermediates``;
   options_checks: the three `_aux` kernels at those shapes (and a mask
   repeated over the batch) against their plain versions by the worst
   64-row tile (KERNEL_TILE_REL_RMS): o, lse, dq, dk, dv and dbias, with
   three planted faults the limit must see (the repeated mask read at
   b // R, dK/dV without the segments, dQ's P without the bias); each
   kernel timed (median, min-max of 5 loops) at the packed, ALiBi and
   cross cases beside its bound (the options' bytes and the live pairs
   only), the same kernel without the options, its plain version and
   `flex_attention` with a document mask_mod (packed) or SDPA with the
   same attn_mask (ALiBi, cross), yardsticks the port never calls.
15. runtime: `DeviceContext`'s readings (`runtime_context:`); the
   whole run reads and writes one private config cache, in a temporary
   directory made at the start (no winner in ~/.cache or of an earlier
   run changes what a run launches); `autotune_attention` over the
   forward, the causal forward (RT_FWD_TILES) and the backward pair (dQ
   RT_DQ_TILES beside dK/dV's one legal tile) at q/k/v [1, 32, 8192,
   128] bf16, `autotune_gemm` on layer 0's w_gate product (T = 8,192)
   and `autotune_gemm_descriptor` with an INT8 weight (RT_GEMM_TILES),
   every candidate a tile variant built in phase 1 and held to its plain
   version by `closeness` before its time counts, each sweep's
   candidates printed in ms beside `bound()` (`runtime_sweep` lines);
   three planted faults (the forward's and dQ's last 64 rows of one head
   dropped, one GEMM output tile lost) that a sweep's check must fail
   (`runtime_faults:`); `autotune_decode` and `autotune_paged` over
   bf16 and INT8 caches at the JAX package's defaults (chunk caps, no
   rebuild); then dispatch, each shown by the launch counters' tiles
   (`runtime_dispatch:`): a forward winner inserted in the cache at the
   dense prefill's shape (one sequence), an explicit block_q / block_kv,
   a GEMM block_m / block_n, and illegal requests clamped, each within
   the limit of its plain version; last, `python -m
   metal_flash_attention_tpu_torch.runtime autotune --kernel forward
   --head-dims 128 --seq 4096` as a subprocess on a cache of its own,
   which must exit 0 and store its winner (`runtime_cli:`).  Each tile
   variant launched gets an entry in the `kernels` line.

16. Mixtral-style MoE at Mixtral-8x7B widths (`MoEConfig`'s defaults:
   dim 4096, 32 heads, 8 kv heads, head_dim 128, hidden 14336, 8
   experts, top-2, capacity factor 1.25, vocab 32000), bf16 with the
   router in float32, seeded random weights built on the card:
   moe_params: MOE_LAYERS of the 32 layers (2.90 GB a layer: the full 93
   GB do not fit in 80 GB), with the cut, the bytes and the peak memory;
   moe_serve: the paged serve's requests through `ServingEngine` by
   `step()` (new tokens/s) and by `step_burst(BURST_K)` under
   `watched_serve`, streams equal, every paged launch count exact and on
   the Hopper kernels, the share of routed choices that capacity dropped
   in decode and in prefill, and one decode step and one chunk step under
   torch.profiler with device ms by family (attention, the experts'
   products and the rest of the routed FFN as `record_function` ranges,
   elementwise; `moe_decode_profile:`, `moe_chunk_profile:`);
   moe_reference: on a MOE_REF_LAYERS-layer cut, the paged path's logits
   (4 prompts prefilled by chunks, then teacher-forced decode steps of
   all rows together) against the same calls on the plain attention path
   (`attention_reference`, REF_*), which takes the kernel path's expert
   choices (a bf16 near-tie may route a token otherwise on each path);
   the choices where the plain path's own routes differ, with their gate
   margins, within MOE_TIE; two planted faults read in every run and seen
   by the gates (one expert's output lost; the capacity one short);
   moe_train: MOE_TRAIN_STEPS `moe.train_step`s (SGD at MOE_TRAIN_LR) of
   MOE_TRAIN_LAYERS layers on MOE_TRAIN_TOKENS + 1 tokens, exact flash
   counts, the loss falling, tokens/s, seconds a step, peak memory and a
   profiled step (`moe_train_profile:`); moe_train_reference: a
   MOE_REF_LAYERS-layer cut's loss and every gradient, the router's
   included, against the plain attention path under autograd (TRAIN_*)
   on the kernel path's choices, at MOE_TRAIN_REF_TOKENS and at
   MOE_CAP_TOKENS tokens (where capacity binds), with the same faults.

Every kernel's `bound_ms` is the least time the card could take for the
same work: the larger of the bytes it must move (each input read once,
each output written once; a quantized weight's payload and scales) over
the card's memory rate and the operations this run's data needs
(visible query-key pairs only) over its peak bf16 rate, both from
`runtime.DeviceContext` (3.35 TB/s and 989 TFLOP/s on an H100 SXM).

Output: `serve`, `tp_serve`, `reference`, `quant_serve`, `burst_serve`,
`prefix_serve`, `quant_reference`,
`dense_serve`, `dense_profile`, `decode_reference`, `quant_gemm`,
`gemm_checks`, `convert`, `lora_train`, `lora_train_profile`,
`lora_train_reference`, `lora_serve`, `speculative_model`,
`speculative_weak`, `speculative_engine`, `verify_checks`, `beam`,
`decode_checks`,
`quant_kernel_checks`,
`quant_fwd_checks`, `train`,
`train_profile`, `train_reference`, `flash_checks`, `entry`,
`tp_train`, `ring_checks`, `pp_check`, `tiny_serve`, `docs_examples`,
`d32_checks`, `d32_decode_checks`, `softmax_checks`,
`gemma_params`, `gemma_serve`, `gemma_dense`, `gemma_reference`,
`gemma_checks`, `gemma_train`, `gemma_train_profile`,
`gemma_train_reference`, `gemma_bwd_checks`, `options_attention`,
`options_checks`, `moe_params`, `moe_decode_profile`,
`moe_chunk_profile`, `moe_serve`, `moe_reference`, `moe_train`,
`moe_train_profile`, `moe_train_reference`, `runtime_context`,
`runtime_sweep`, `runtime_faults`, `runtime_launches`,
`runtime_dispatch`, `runtime_cli` and `runtime` lines, a `phases` line
(each phase's seconds), a `profiler_lost` line (the timings that the
profiler lost in every session and that CUDA events took instead; empty
in a run where it lost none), the card's name and power limit as nvidia-smi
gives them, a `kernels` JSON line, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import importlib
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
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
# Loops run before the counted ones in a profiled session, whose first
# events the profiler may lose (on the H100, as many as a loop and a half
# of 5 quantized products at 8,192 tokens).
LEAD_IN_LOOPS = 3
# Profiler sessions `timed` and `timed_spread` run before they give up
# on the profiler (a session can lose its events, and once it has, the
# next sessions of the process often lose theirs too).  They then read
# the card's time from CUDA events around the same loops, and name the
# caller in PROFILER_LOST, which the run prints.
PROFILE_ATTEMPTS = 3
PROFILER_LOST: list[str] = []
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
# burst_serve and prefix_serve run on this many of the 32 layers.
ENGINE_PHASE_LAYERS = 16
SAMPLING = {"temperature": 0.8, "top_k": 50, "top_p": 0.95}
SAMPLE_SEED = 0

# The forward over quantized K/V (slice 11).  quant_fwd_checks: K/V in
# every precision of QUANT_PRECISIONS through `dispatch.attention` at the
# training shape (q [1, 32, 8192, 128] causal against 8,192 keys) and at a
# chunk over a long quantized prefix (QUANT_FWD_CHUNK queries causal from
# the bottom right against 8,192 keys: ragged tiles).
QUANT_FWD_CHUNK = 1000
QUANT_FWD_KEYS = 8192

# Prefix caching (slice 11).  prefix_serve, over bf16 then
# QUANT_SERVE_PRECISION pools, full width, page PAGE: (a) the
# time to first token of a PREFIX_TTFT_PROMPT-token prompt cold (the cache
# flushed) and warm (all its complete pages but the last token's
# borrowed), best of 2 each, after the JAX package's bench.py:283-330;
# (b) request 0 alone, PREFIX_SHARED shared tokens plus its own suffix,
# then PREFIX_FOLLOWERS more requests of the same prefix and a distinct
# suffix of PREFIX_SUFFIXES tokens, MAX_NEW new tokens each, max_batch
# MAX_BATCH, on an engine with the cache and on one without.
PREFIX_TTFT_PROMPT = 2048
PREFIX_TTFT_NEW = 4
PREFIX_SHARED = 1536
PREFIX_SUFFIXES = (300, 200, 600, 417, 350, 512)
PREFIX_FOLLOWERS = 5

# Gemma-2 (gemma2_2b, the JAX package's `GemmaConfig()`: 26 layers, dim
# 2304, 8 heads, 4 KV heads, head_dim 256, hidden 9216, vocab 256128,
# window 4096 on even layers, attention softcap 50, final softcap 30):
# the engine's requests (two longer than the window), its context, the
# shared prefix and its followers' suffixes, the dense batch, the
# reference cut, and the saturating cap the kernel checks add to the
# model's (over queries scaled up, since |s * scale| of seeded random
# weights stays far below 50).
GEMMA_PROMPT_LENS = (200, 450, 700, 1100, 5000, 6000)
GEMMA_MAX_SEQ = 8192
GEMMA_SHARED = 1536
GEMMA_SUFFIXES_LENS = (300, 200, 600, 417, 350, 512)
GEMMA_DENSE_BATCH = 4
GEMMA_DENSE_PROMPT = 5000
GEMMA_REF_LAYERS = 2
GEMMA_REF_PROMPT = 5000
GEMMA_SAT_CAP = 2.0
GEMMA_SAT_GAIN = 4.0
# Gemma-2 training (slice 13): gemma_train's SGD steps of gemma2_2b at
# full width and depth on one sequence of GEMMA_TRAIN_TOKENS + 1 tokens
# (8,192 is Gemma-2's context, twice the local layers' window), also the
# rows 4g / 5g checks' length.  SGD rounds each update to the bf16
# parameter: at 8,192 tokens the gradients' rms are 1e-5 to 5e-5
# (measured at full width on the CPU at 512 and 2,048 tokens, falling as
# 1 / sqrt(T)), below half a bf16 ulp of every weight at the JAX
# package's default lr 1e-4; at GEMMA_TRAIN_LR the tied embedding
# (entries ~2e-3, ulp ~1.5e-5) moves, and the loss falls.
GEMMA_TRAIN_TOKENS = 8192
GEMMA_TRAIN_STEPS = 4
GEMMA_TRAIN_LR = 1.0
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
    run again, PROFILE_ATTEMPTS sessions at most; where all of them lose
    their events, the device time is the CUDA events' (`profiler_lost`)."""
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
        device_us = None
    wall = event_ms(fn, iters)
    if device_us is None:
        profiler_lost("timed")
        return wall, wall
    return device_us / 1e3 / iters, wall


def event_ms(fn, iters: int) -> float:
    """Ms a call by CUDA events around `iters` back-to-back calls."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profiler_lost(how: str) -> None:
    """Note that `how`'s caller was timed by CUDA events: the profiler lost
    the events of PROFILE_ATTEMPTS sessions."""
    caller = sys._getframe(2)
    PROFILER_LOST.append(f"{how} in {caller.f_code.co_name}:"
                         f"{caller.f_lineno}")


def timed_spread(fn, iters: int, repeats: int = GEMM_REPEATS) -> dict:
    """`timed` over `repeats` loops of `iters` calls in one profiler
    session (many sessions in one process lose the card's events), after
    LEAD_IN_LOOPS lead-in loops that are not counted (a session may lose
    its first events), the loops kept apart on the card by LOOP_GAP_S of
    idle time and told apart by a marker kernel launched after each (a
    gap in time also opens where the host stalls, and the profiler may
    drop a kernel's event), or, where the profiler dropped a marker's
    event, by those gaps, or by either (a dropped marker beside a gap the
    profiler's clock lost): the median device ms a call and its min and
    max over the loops, and the wall ms a call over all of them.  A
    session whose loops no split finds is run again, PROFILE_ATTEMPTS
    sessions at most."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()

    def last_loops(loops, trailing):
        """The last `repeats` loops, or None unless the split found them
        all (the lead-in loops may be lost, whole or in part), nothing
        after the last, and no two loops run together (each holds about
        as many kernels as the others)."""
        if trailing or not repeats <= len(loops) <= repeats + LEAD_IN_LOOPS:
            return None
        loops = loops[-repeats:]
        median = float(np.median([len(x) for x in loops]))
        if not all(0.5 * median < len(x) < 1.5 * median for x in loops):
            return None
        return loops

    def session():
        """One profiled session: its loops, or None, and what each split
        found."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats + LEAD_IN_LOOPS):
                for _ in range(iters):
                    fn()
                torch.cuda._sleep(LOOP_MARK_CYCLES)
                torch.cuda.synchronize()
                time.sleep(LOOP_GAP_S)
        events = sorted(device_kernels(prof),
                        key=lambda e: e.time_range.start)
        loops, loop = [], []
        for e in events:
            if LOOP_MARK in e.name:
                loops.append(loop)
                loop = []
            else:
                loop.append(e)
        marked = len(loops)
        found = last_loops(loops, loop)
        if found is not None:
            return found, marked, None
        # The profiler dropped a marker's event: split by the idle gaps
        # between the loops instead, then by markers and gaps both.
        def split(at_marks):
            loops, loop, last_end = [], [], None
            for e in events:
                if LOOP_MARK in e.name:
                    if at_marks and loop:
                        loops.append(loop)
                        loop = []
                    continue
                if loop and last_end is not None and \
                        e.time_range.start - last_end > LOOP_GAP_S * 1e6 / 2:
                    loops.append(loop)
                    loop = []
                loop.append(e)
                last_end = e.time_range.end
            return loops + [loop] if loop else loops
        gapped = split(False)
        found = last_loops(gapped, []) or last_loops(split(True), [])
        return found, marked, [len(x) for x in gapped]

    for _ in range(PROFILE_ATTEMPTS):
        loops, marked, gaps = session()
        if loops is not None:
            device = [sum(e.device_time_total for e in loop) / 1e3 / iters
                      for loop in loops]
            timed_by = "profiler"
            break
    else:
        # No session's loops were found (the last one's kernels fell into
        # `marked` loops by markers and `gaps` by idle gaps): each loop is
        # timed by CUDA events instead.
        profiler_lost(f"timed_spread ({marked} marked loops, {gaps} by "
                      "gaps)")
        device = [event_ms(fn, iters) for _ in range(repeats)]
        timed_by = "cuda_events"
    wall = event_ms(fn, iters * repeats)
    return {"ms": float(np.median(device)), "ms_min": min(device),
            "ms_max": max(device), "repeats": repeats, "wall_ms": wall,
            "timed_by": timed_by}


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


def tf32_operands(kernel):
    """A float32 attention kernel reading its q, k, v (and dO) rounded
    to TF32: what a kernel that multiplied in TF32 would compute."""
    def run(q, k, v, *rest, **kw):
        q, k, v = (tf32_rounded(x) for x in (q, k, v))
        if rest:
            rest = (tf32_rounded(rest[0]), *rest[1:])
        return kernel(q, k, v, *rest, **kw)
    return run


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of the two least times, at the
    card's peak bf16 rate and memory rate (`DeviceContext`)."""
    from metal_flash_attention_tpu_torch.runtime.context import DeviceContext
    info = DeviceContext.get().info
    t_ops = flops / info.peak_bf16_flops * 1e3
    t_bytes = n_bytes / info.hbm_bandwidth * 1e3
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


def per_kv_head(fn, q, k, v, *rest):
    """fn over one kv head and its group of q heads at a time (its float32
    [group, n, m] intermediates stay near 1 GB), each of its outputs put
    back in place by its heads (a group's for q-like ones, one for
    k-like)."""
    import torch
    kvh_n = k.shape[1]
    group = q.shape[1] // kvh_n
    outs = None
    for j in range(kvh_n):
        g = slice(j * group, (j + 1) * group)
        parts = fn(q[:, g], k[:, j:j + 1], v[:, j:j + 1],
                   *(t[:, g] for t in rest))
        if outs is None:
            outs = [torch.empty((p.shape[0], p.shape[1] * kvh_n,
                                 *p.shape[2:]), dtype=p.dtype,
                                device=p.device) for p in parts]
        for o_, p in zip(outs, parts):
            o_[:, j * p.shape[1]:(j + 1) * p.shape[1]] = p
    return outs


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


@contextlib.contextmanager
def counted_collectives(counts: dict):
    """Inside the block, count into ``counts`` the calls of
    `torch.distributed.all_reduce` and `all_gather`, and by axis
    ("points_heads", "points_data") the collective points the mesh path
    reached: every collective of `parallel.mesh` first asks `_whole`
    whether its axis has one rank, and then skips its call, so at world
    size 1 only the points count."""
    import torch.distributed as dist
    from metal_flash_attention_tpu_torch.parallel import mesh as pm

    def count(key):
        counts[key] = counts.get(key, 0) + 1

    originals = {n: getattr(dist, n) for n in ("all_reduce", "all_gather")}
    whole = pm._whole

    def wrap(name, fn):
        def run(*args, **kwargs):
            count(name)
            return fn(*args, **kwargs)
        return run

    def point(mesh, axis):
        if mesh is not None:
            count(f"points_{axis}")
        return whole(mesh, axis)
    for n, fn in originals.items():
        setattr(dist, n, wrap(n, fn))
    pm._whole = point
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(dist, n, fn)
        pm._whole = whole


def tp_serve(params, cfg, prompts, dev, card, streams, launches) -> dict:
    """tp_serve: the serve phase's requests through the tensor-parallel
    path at world size 1 (a one-rank NCCL group in this process, the mesh
    steps, ``kv_sharding``); its streams must equal the serve phase's
    (``streams``) and its paged launch counts ``launches``, all on the
    Hopper kernels.  Returns its launch counts."""
    import functools

    import torch
    import torch.distributed as dist
    from metal_flash_attention_tpu_torch import ServingEngine
    from metal_flash_attention_tpu_torch.models import llama, serving
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.parallel import (
        HEAD_AXIS,
        NamedSharding,
        P,
        make_mesh,
        shard,
    )

    store = tempfile.mkdtemp(prefix="mfa_tp_store_")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        store, "store"), rank=0, world_size=1)
    try:
        mesh = make_mesh(heads=1)
        local = shard(params, llama.param_shardings(cfg, mesh), mesh)
        if any(a is not b for a, b in zip(local["layers"][0].values(),
                                          params["layers"][0].values())):
            fail("tp_serve: a block at tp 1 is not the whole tensor")
        max_seq = max(map(len, prompts)) + MAX_NEW + 1
        num_pages = MAX_BATCH * -(-max_seq // PAGE) + 1

        def engine():
            return ServingEngine(
                local, cfg, max_batch=MAX_BATCH, num_pages=num_pages,
                page_size=PAGE, max_seq=max_seq,
                chunk_step=functools.partial(serving.paged_chunk_step,
                                             mesh=mesh),
                decode_step=functools.partial(serving.paged_decode_step,
                                              mesh=mesh),
                kv_sharding=NamedSharding(mesh, P(None, HEAD_AXIS, None,
                                                  None)))
        warm = engine()                    # NCCL's communicator, not counted
        warm.submit(prompts[1][:64], 2)
        while not warm.idle:
            warm.step()
        del warm
        eng = engine()
        rids = [eng.submit(p, MAX_NEW) for p in prompts]
        collectives = {}
        pa.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        steps = 0
        with counted_collectives(collectives):
            while not eng.idle:
                eng.step()
                steps += 1
                if steps > 10_000:
                    fail("tp_serve: engine did not drain")
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        got = {k: n for k, n in pa.LAUNCH_COUNTS.items() if n}
        tp_streams = [eng.result(r).tolist() for r in rids]
        free = eng.alloc.free_pages
        del eng, local
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    want = {k: n for k, n in launches.items() if n}
    equal = tp_streams == streams
    tokens = MAX_NEW * len(prompts)
    print("tp_serve: " + json.dumps({
        "world_size": 1, "mesh": {"data": 1, "heads": 1, "context": 1},
        "requests": len(prompts), "new_tokens": tokens, "seconds": secs,
        "steps": steps, "new_tokens_per_s": tokens / secs,
        "streams_equal_serve": equal, "launches": got,
        "launches_equal_serve": got == want, "collectives": collectives,
        "note": "world size 1: every collective is over an axis of one "
                "rank and skips its call (points_*: the collective points "
                "reached); tools/tp_probe.py "
                "runs tp 4 on four cards",
        "card": card}), flush=True)
    if not equal:
        fail("tp_serve: the tensor-parallel streams differ from the serve "
             "phase's")
    if got != want:
        fail(f"tp_serve: launches {got}, the serve phase's {want}")
    if not collectives.get(f"points_{HEAD_AXIS}"):
        fail("tp_serve: the mesh steps reached no collective")
    if free != num_pages - 1:
        fail("tp_serve: pages leaked")
    return got


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


def plain_hidden(params, tokens, cfg, lora=None, lora_ids=None):
    """A dense forward built from the port's blocks with the plain
    attention (`attention_reference`, float32 softmax, differentiable):
    final-norm hidden states [batch, seq, dim].  ``lora`` / ``lora_ids``:
    adapters on the attention projections, as `llama.forward_hidden`
    takes them."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )

    b, s = tokens.shape
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = llama.rope_frequencies(cfg, pos)
    x = params["embed"][tokens].to(cfg.dtype)
    for i, layer in enumerate(params["layers"]):
        ll = None if lora is None else lora["layers"][i]
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin, ll, lora_ids)
        o = attention_reference(q, k, v, causal=True).to(cfg.dtype)
        x = x + llama.wo_proj(o.transpose(1, 2).reshape(b, s, -1), layer,
                              ll, lora_ids).to(x.dtype)
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
    then QUANT_SERVE_PRECISION pools, at the depth of ``cfg``, greedy
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
        "config": f"llama3_8b widths, {cfg.n_layers} layers, bf16",
        "burst_k": BURST_K, "requests": len(prompts),
        "new_tokens": MAX_NEW * len(prompts), "sampling": SAMPLING,
        "seed": SAMPLE_SEED, "runs": runs,
        "burst_over_step_new_tokens_per_s": ratio,
        "sampled_streams_unlike_greedy": differ, "card": card}),
        flush=True)
    return burst_launches


def prefix_serve(params, cfg, dev, card) -> dict:
    """The prefix-cache serving path, over bf16 then QUANT_SERVE_PRECISION
    pools, at the depth of ``cfg``: (a) the time to first token of a
    PREFIX_TTFT_PROMPT-token prompt cold (cache flushed) and warm (its
    pages borrowed), best of 2 each; (b) the shared-prefix serve (request
    0 alone, then PREFIX_FOLLOWERS more of the same prefix) on an engine
    with the cache and on one without, every launch count of the paged,
    decode and forward kernels set to 0 just before each run and read just
    after, held exact (`expected_serve_launches`, and the chunk steps to
    what each prompt's unshared part needs); the greedy streams of both
    engines equal, the hit tokens PREFIX_FOLLOWERS x PREFIX_SHARED, every
    page back after a flush, and the allocator the C++ one.  Returns each
    pool type's launch counts of the cached run."""
    import torch
    from metal_flash_attention_tpu_torch import ServingEngine
    from metal_flash_attention_tpu_torch.models import serving
    from metal_flash_attention_tpu_torch.native.page_allocator import (
        NativePageAllocator,
    )
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    rng = np.random.default_rng(SEED + 12)
    vocab = cfg.vocab_size
    shared = rng.integers(0, vocab, (PREFIX_SHARED,))
    prompts = [np.concatenate([shared, rng.integers(0, vocab, (n,))])
               .astype(np.int32) for n in PREFIX_SUFFIXES]
    ttft_prompt = rng.integers(1, vocab, (PREFIX_TTFT_PROMPT,)).astype(
        np.int32)
    max_seq = PREFIX_SHARED + max(PREFIX_SUFFIXES) + MAX_NEW + 1
    seq_pages = -(-max_seq // PAGE)
    # Room for every slot's span and every request's cached pages.
    num_pages = (MAX_BATCH + len(prompts)) * seq_pages + 1

    def first_token_s(eng, prompt):
        """Wall seconds from submit to the request's first token (its
        token read back to the host), then drained."""
        rid = eng.submit(prompt, PREFIX_TTFT_NEW)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        while not any(r == rid for r, _ in eng.step()):
            pass
        dt = time.perf_counter() - t0
        while not eng.idle:
            eng.step()
        return dt

    def drive(eng, batches):
        """Each batch submitted at once and drained: the requests' new
        tokens, seconds to first token, wall seconds and engine steps."""
        streams, ttft, steps, secs = {}, {}, 0, 0.0
        for batch in batches:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for p in batch:
                eng.submit(p, MAX_NEW)
            while not eng.idle:
                for rid, tok in eng.step():
                    if rid not in streams:
                        ttft[rid] = time.perf_counter() - t0
                    streams.setdefault(rid, []).append(tok)
                steps += 1
                if steps > 10_000:
                    fail("prefix serve did not drain")
            torch.cuda.synchronize(dev)
            secs += time.perf_counter() - t0
        return ([streams[r] for r in sorted(streams)],
                [ttft[r] for r in sorted(ttft)], secs, steps)

    report, launches_by_pool = {}, {}
    for prec in (None, QUANT_SERVE_PRECISION):
        label = prec or "bf16"
        eng = ServingEngine(params, cfg, max_batch=1, num_pages=64,
                            page_size=PAGE, max_seq=2 * PREFIX_TTFT_PROMPT,
                            prefix_cache=True, kv_precision=prec)
        first_token_s(eng, ttft_prompt)     # libraries and handles
        first_token_s(eng, ttft_prompt)
        eng.prefix_cache.flush()
        cold = first_token_s(eng, ttft_prompt)
        eng.prefix_cache.flush()
        cold = min(cold, first_token_s(eng, ttft_prompt))
        warm = min(first_token_s(eng, ttft_prompt),
                   first_token_s(eng, ttft_prompt))
        hit = (PREFIX_TTFT_PROMPT - 1) // PAGE * PAGE
        if eng.prefix_cache.hit_tokens != 3 * hit:
            fail(f"prefix TTFT ({label}) hit "
                 f"{eng.prefix_cache.hit_tokens} tokens, not {3 * hit}")
        del eng
        torch.cuda.empty_cache()

        runs = {}
        for cached in (True, False):
            eng = ServingEngine(params, cfg, max_batch=MAX_BATCH,
                                num_pages=num_pages, page_size=PAGE,
                                max_seq=max_seq, prefix_cache=cached,
                                kv_precision=prec)
            if type(eng.alloc) is not NativePageAllocator:
                fail(f"the engine's allocator is {type(eng.alloc)}")
            calls: dict = {}
            with counted_calls(serving, SERVE_STEPS, calls):
                for mod in (pa, fd, fa):
                    mod.reset_launch_counts()
                streams, ttft, secs, steps = drive(
                    eng, [prompts[:1], prompts[1:]])
                launches = {**pa.LAUNCH_COUNTS, **fd.LAUNCH_COUNTS,
                            **fa.LAUNCH_COUNTS}
            wrong = launch_errors(launches,
                                  expected_serve_launches(cfg, calls, prec))
            hits = [0] + [PREFIX_SHARED * cached] * PREFIX_FOLLOWERS
            chunks = sum(-(-(len(p) - h) // PAGE)
                         for p, h in zip(prompts, hits))
            step_name = "paged_chunk_step" if prec is None else \
                "paged_chunk_step_q"
            if wrong or len(calls[step_name]) != chunks:
                fail(f"prefix serve ({label}, cache {cached}) launched "
                     f"(count, expected) {wrong}, "
                     f"{len(calls[step_name])} chunk steps for {chunks}")
            stats = eng.stats
            if cached:
                if stats["prefix_hit_tokens"] != sum(hits):
                    fail(f"prefix serve ({label}) hit "
                         f"{stats['prefix_hit_tokens']} tokens, not "
                         f"{sum(hits)}")
                eng.prefix_cache.flush()
            if eng.alloc.free_pages != num_pages - 1:
                fail(f"prefix serve ({label}, cache {cached}) left "
                     f"{eng.alloc.free_pages} of {num_pages - 1} pages free")
            if any(len(s) != MAX_NEW or not all(0 <= t < vocab for t in s)
                   for s in streams):
                fail(f"prefix serve ({label}) emitted a short stream or a "
                     "token outside the vocabulary")
            tokens = MAX_NEW * len(prompts)
            runs[cached] = {
                "streams": streams, "seconds": secs, "steps": steps,
                "new_tokens_per_s": tokens / secs, "ttft_s": ttft,
                "chunk_steps": len(calls[step_name]),
                "decode_steps": len(calls[step_name.replace("chunk",
                                                            "decode")]),
                "prefix_hit_tokens": stats.get("prefix_hit_tokens"),
                "prefix_cached_pages": stats.get("prefix_cached_pages"),
                "launches": {k: n for k, n in launches.items() if n}}
            if cached:
                launches_by_pool[label] = launches
            del eng
            torch.cuda.empty_cache()
        if runs[True]["streams"] != runs[False]["streams"]:
            fail(f"prefix serve ({label}): the cached engine's greedy "
                 "streams differ from the uncached engine's")
        report[label] = {
            "ttft": {"prompt_tokens": PREFIX_TTFT_PROMPT,
                     "borrowed_tokens": hit, "cold_s": cold,
                     "warm_s": warm, "cold_over_warm": cold / warm},
            "serve": {("cached" if c else "uncached"): {
                k: v for k, v in r.items() if k != "streams"}
                for c, r in runs.items()},
            "streams_equal": True}
    print("prefix_serve: " + json.dumps({
        "config": f"llama3_8b widths, {cfg.n_layers} layers, bf16, "
                  f"page {PAGE}, max_batch {MAX_BATCH}",
        "requests": len(prompts), "shared_tokens": PREFIX_SHARED,
        "suffix_tokens": list(PREFIX_SUFFIXES), "new_tokens": MAX_NEW,
        "allocator": "NativePageAllocator", **report, "card": card}),
        flush=True)
    return launches_by_pool


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


def quant_fwd_checks(dev) -> list[dict]:
    """The forward over quantized K/V: K/V in every precision of
    QUANT_PRECISIONS (quantized per (batch, kv head) from bf16 heads of
    magnitudes apart, so that their scales differ) through
    `dispatch.attention` at the training shape and at a chunk over a long
    prefix.  Every launch count of the forward is set to 0 just before
    those calls and read just after: each is one `flash_fwd`, one
    `flash_fwd_sm90` and one `flash_fwd_<precision>`.  Then each output is
    held against the plain version by the worst 64-row tile
    (KERNEL_TILE_REL_RMS; lse at MIXED_TOL), with a planted fault that the
    limit must see (one kv head's K scale replaced by its neighbour's),
    and each is timed (median and min-max of GEMM_REPEATS loops) beside
    its bound (visible pairs' operations; payload, scales, q, o and lse
    bytes), its plain version and the bf16 kernel at the same shape;
    dequantize-then-SDPA (two calls) is timed as a note."""
    import torch
    import torch.nn.functional as F
    from metal_flash_attention_tpu_torch import dispatch
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops.quantization import (
        dequantize,
        quantize,
    )
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    d, m = HEAD_DIM, QUANT_FWD_KEYS
    scale = d ** -0.5
    mag = torch.exp(2 * torch.rand((1, KV_HEADS, 1, 1), generator=gen,
                                   device=dev) - 1)
    k16, v16 = ((torch.randn((1, KV_HEADS, m, d), generator=gen, device=dev)
                 * mag).to(torch.bfloat16) for _ in range(2))
    shapes = {"train": TRAIN_TOKENS, "chunk": QUANT_FWD_CHUNK}
    qs = {name: torch.randn((1, Q_HEADS, n, d), generator=gen,
                            device=dev).to(torch.bfloat16)
          for name, n in shapes.items()}
    kv = {prec: tuple(quantize(t, OperandPrecision(prec))
                      for t in (k16, v16)) for prec in QUANT_PRECISIONS}

    def run(q, k, v):
        return dispatch.attention(q, k, v, causal=True,
                                  return_residuals=True)

    # The main path: every launch counted.
    fa.reset_launch_counts()
    outs = {(prec, name): run(qs[name], *kv[prec])
            for prec in QUANT_PRECISIONS for name in shapes}
    torch.cuda.synchronize(dev)
    launches = dict(fa.LAUNCH_COUNTS)
    calls = len(outs)
    expected = {"flash_fwd": calls, "flash_fwd_sm90": calls, **{
        f"flash_fwd_{prec}": len(shapes) for prec in QUANT_PRECISIONS}}
    wrong = launch_errors(launches, expected)
    if wrong:
        fail(f"quant_fwd_checks launched (count, expected) {wrong}")

    # The K scale fault: the kv head whose scale differs most from its
    # neighbour's takes the neighbour's.
    def scale_fault(k):
        ks = k.scales.clone()
        j = int((ks[0, 1:].log() - ks[0, :-1].log()).abs().argmax())
        ks[0, j] = ks[0, j + 1]
        return k._replace(scales=ks)

    readings, results, problems = {}, [], []
    bf16_ms = {name: timed_spread(lambda q=q: fa.flash_attention_forward(
        q, k16, v16, causal=True), 20 if name == "train" else 50)
        for name, q in qs.items()}
    for prec in QUANT_PRECISIONS:
        k, v = kv[prec]
        r_prec = {}
        for name, q in qs.items():
            key = f"{prec}.{name}"
            o, lse = outs[(prec, name)]
            po, plse = fa._forward_plain_quantized(
                q, k, v, causal=True, window_size=None, scale=scale,
                out_dtype=torch.float32)
            r = closeness(o, po)
            r["lse_max_abs_err"] = max_abs_err(lse, plse)
            r["k_scale_of_neighbour_head"] = closeness(
                run(q, scale_fault(k), v)[0], po)
            if not within_limits(r) or r["lse_max_abs_err"] > MIXED_TOL.lse:
                problems.append(f"flash_fwd_{key} disagrees with its plain "
                                "version")
            if within_limits(r["k_scale_of_neighbour_head"]):
                problems.append(f"the flash_fwd_{key} check does not see a "
                                "K scale taken from the neighbouring head")
            readings[key] = r_prec[name] = r
            del po, plse
        timings = {}
        for name, q in qs.items():
            n = shapes[name]
            t = timed_spread(lambda q=q: dispatch.attention(
                q, k, v, causal=True), 20 if name == "train" else 50)
            plain_ms, _ = timed(lambda q=q: fa._forward_plain_quantized(
                q, k, v, causal=True, window_size=None, scale=scale,
                out_dtype=torch.bfloat16), 3)
            # SDPA's causal mask is aligned top-left: the note is taken
            # where q_len = kv_len only.
            note_ms = None if n != m else timed(
                lambda q=q: F.scaled_dot_product_attention(
                    q, dequantize(k, q.dtype).to(q.dtype),
                    dequantize(v, q.dtype).to(q.dtype), is_causal=True,
                    enable_gqa=True), 3)[0]
            o, lse = outs[(prec, name)]
            bound_ms, bound_by = bound(
                4 * d * Q_HEADS * visible_pairs(n, m, True, None),
                nbytes(k.values, v.values, k.scales, v.scales, q, o, lse))
            timings[name] = {
                "ms": t["ms"], "spread": t, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / t["ms"],
                "bf16_ms": bf16_ms[name]["ms"],
                "bf16_spread": bf16_ms[name],
                "dequantize_then_sdpa_ms": note_ms}
        train = timings["train"]
        results.append({
            "name": f"flash_fwd_{prec}", "route": "cuda",
            "source": "metal_flash_attention_tpu_torch/csrc/"
                      "flash_attention.cu",
            "replaces": "metal_flash_attention_tpu/ops/flash_attention.py:"
                        f"223 and :552 (QuantizedTensor K/V, {prec})",
            "kernel": f"flash_fwd90_kernel<bf16, 128, {prec}>",
            "launches": launches[f"flash_fwd_{prec}"],
            "max_abs_err": max(r["max_abs_err"] for r in r_prec.values()),
            "o": r_prec,
            "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                       "lse_abs": MIXED_TOL.lse},
            "ms": train["ms"], "plain_ms": train["plain_ms"],
            "bound_ms": train["bound_ms"], "bound_by": train["bound_by"],
            "library_ms": None,
            "library": "none: dequantize then SDPA is two calls "
                       "(dequantize_then_sdpa_ms, a note)",
            "share_of_bound": train["share_of_bound"],
            "spread": train["spread"], "bf16_ms": train["bf16_ms"],
            "timings": timings,
            "shape": f"q [1, 32, {TRAIN_TOKENS}, 128] (timed) and [1, 32, "
                     f"{QUANT_FWD_CHUNK}, 128], causal from the bottom "
                     f"right, k/v [1, 8, {m}, 128] {prec}"})
    print("quant_fwd_checks: " + json.dumps({
        "readings": readings, "launches": {
            k_: n_ for k_, n_ in launches.items() if n_},
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

    # The forward's quantized, capped, D 256 and option variants, and the
    # backward's capped, D 256 and option ones, take no part in Llama
    # training.
    unused = {f"flash_fwd_{p}" for p in (*QUANT_PRECISIONS, "softcap",
                                          "d256", "d32", "aux", "f32")} | {
        f"flash_bwd_{op}_{p}" for op in ("dq", "dkv")
        for p in ("softcap", "d256", "d32", "aux", "f32")}
    for name, n in launches.items():
        per_step = 0 if name in unused else TRAIN_LAYERS
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


def profile_step(label, run, families, dev, spans=()) -> dict:
    """`run()` once under torch.profiler: device time by kernel family
    (`spans`: `record_function` names whose ranges on the card's timeline
    make a family of the kernels inside them; then `families`: name -> a
    substring of the kernel's name, or a tuple of them; cuBLAS products
    and the rest besides), the card's busy share of the wall time, and
    the top kernels.  Prints and returns the reading."""
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
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and getattr(e, "is_user_annotation", False)
              and e.name in spans]
    by_family: dict[str, float] = {}
    by_name: dict[str, list] = {}
    for e in kernels:
        # The innermost range that holds the kernel names its family.
        family = min(((hi - lo, name) for name, lo, hi in ranges
                      if lo <= e.time_range.start
                      and e.time_range.end <= hi), default=(0, None))[1]
        family = family or next((f for f, keys in families.items() if any(
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
        **({"span_ranges": {n: sum(r[0] == n for r in ranges)
                            for n in spans}} if spans else {}),
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
    rdq, rdk, rdv = per_kv_head(
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
    plain_bwd_ms, _ = timed(lambda: per_kv_head(
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


# Head dim 32 (slice 20): entry() on the card, the three kernels at D 32,
# and the training mesh at world size 1.
D32_SHAPE = (2, 4, 2, 4096, 32)      # b, q heads, kv heads, n, d: causal
# A power of two so large that rounding a new bf16 parameter costs 2^-9 of
# its update: the update reads the gradient (tests/test_torch_flash_cuda
# .py's TRAIN_LR).
TP_TRAIN_LR = 1024.0


def entry_check(dev, card) -> dict:
    """entry: the port's `entry()` on its default device (the card,
    `LlamaConfig.tiny(n_layers=2)`, head_dim 32): its logits against the
    same weights' plain path (`plain_hidden`, the 2-layer cut's logits
    gate) on entry()'s tokens and on random ones, with the D 32 forward
    launched once a layer and call and nothing else.  Returns the launch
    counts."""
    import torch
    from metal_flash_attention_tpu_torch.entry import entry
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    fn, (params, tokens) = entry()
    if params["embed"].device != dev or tokens.device != dev:
        fail(f"entry() built on {params['embed'].device}, not the card")
    cfg = llama.LlamaConfig.tiny(n_layers=2)
    # entry()'s own tokens (all 0: V is the same at every position, so
    # any attention gives it back) and random ones of the same shape.
    inputs = {"entry_tokens": tokens, "random_tokens": torch.as_tensor(
        np.random.default_rng(SEED + 91).integers(
            0, cfg.vocab_size, tuple(tokens.shape)), device=dev)}
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    logits = {k: fn(params, t) for k, t in inputs.items()}
    torch.cuda.synchronize(dev)
    launches = {k: n for k, n in {**fa.LAUNCH_COUNTS,
                                  **fb.LAUNCH_COUNTS}.items() if n}
    calls = len(inputs) * cfg.n_layers
    want = {"flash_fwd": calls, "flash_fwd_sm90": calls,
            "flash_fwd_d32": calls}
    readings = {}
    for k, t in inputs.items():
        with torch.no_grad():
            ref = (plain_hidden(params, t, cfg) @ params["lm_head"]).float()
        err = logits[k].float() - ref
        readings[k] = {
            "rel_rms_err": float(err.pow(2).mean().sqrt()
                                 / ref.pow(2).mean().sqrt()),
            "max_abs_err": float(err.abs().max()),
            "finite": bool(torch.isfinite(logits[k]).all()),
            "shape": list(logits[k].shape)}
    ms, _ = timed(lambda: fn(params, tokens), 10)
    print("entry: " + json.dumps({
        "config": "LlamaConfig.tiny(n_layers=2), head_dim 32, bf16, tokens "
                  "[2, 256], on the default device",
        "device": str(params["embed"].device), "readings": readings,
        "tol": {"rel_rms": REF_REL_RMS, "max_abs": REF_MAX_ABS},
        "launches": launches, "ms": ms, "card": card}), flush=True)
    if launches != want:
        fail(f"entry launched {launches}, expected {want}")
    for k, r in readings.items():
        if not r["finite"] or r["shape"] != [2, 256, cfg.vocab_size]:
            fail(f"entry's logits ({k}) are not finite [2, 256, vocab]")
        if not (r["rel_rms_err"] <= REF_REL_RMS
                and r["max_abs_err"] <= REF_MAX_ABS):
            fail(f"entry's logits ({k}) disagree with the plain path")
    return launches


def d32_checks(dev, card, launches_by_path) -> list[dict]:
    """d32_checks: the forward, dQ and dK/dV kernels at head dim 32 (the
    D 64 kernels over 32-column rows) against their plain versions at
    q D32_SHAPE causal, by the worst 64-row tile (KERNEL_TILE_REL_RMS)
    and lse (MIXED_TOL.lse), each with a planted one-tile fault the limit
    must see; their times beside the bound, the plain versions' and
    SDPA's (the library yardstick, never called by the port).
    ``launches_by_path``: {path: launch counts} of the main paths that ran
    them (entry, tp_train, ring_checks, tiny_serve, docs_examples).  Then
    rows 1 and 6 at D 32 (`d32_decode_checks`)."""
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

    b, qh, kvh, n, d = D32_SHAPE
    group, scale = qh // kvh, d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)

    def t(heads):
        return torch.randn((b, heads, n, d), generator=gen,
                           device=dev).to(torch.bfloat16)
    q, k, v, do = t(qh), t(kvh), t(kvh), t(qh)
    last = slice(n - TILE_ROWS, n)
    h, kh = qh - 1, kvh - 1
    grp = slice(kh * group, (kh + 1) * group)
    mid = slice(n // 2, n // 2 + TILE_ROWS)
    readings, problems = {}, []

    def check(name, got, ref, fault):
        r = closeness(got, ref)
        r["planted_fault"] = closeness(fault, ref)
        readings[name] = r
        if not within_limits(r):
            problems.append(f"{name} disagrees with its plain version")
        if within_limits(r["planted_fault"]):
            problems.append(f"the {name} check does not see a one-tile "
                            "fault")

    fa.reset_launch_counts()
    fb.reset_launch_counts()
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    dq, dk, dv = fb.flash_attention_backward(q, k, v, do, o, lse,
                                             causal=True)
    torch.cuda.synchronize(dev)
    counted = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for s in ("", "_sm90", "_d32"):
            if counted[name + s] != 1:
                problems.append(f"{name}{s} launched {counted[name + s]} "
                                "times for one call")
    po, plse = fa._forward_plain(q, k, v, causal=True, window_size=None,
                                 scale=scale, out_dtype=torch.float32)
    # Faults: the last query tile of the last head without its diagonal
    # key tile; dK/dV of the last kv head's middle key tile without the
    # group's last query tile.
    fo = o.clone()
    fo[:, h:h + 1, last] = attention_reference(
        q[:, h:h + 1, last], k[:, kh:kh + 1, :n - TILE_ROWS],
        v[:, kh:kh + 1, :n - TILE_ROWS], scale=scale).to(o.dtype)
    check("flash_fwd_d32.o", o, po, fo)
    lse_err = max_abs_err(lse, plse)
    if lse_err > MIXED_TOL.lse:
        problems.append(f"flash_fwd_d32's lse is {lse_err} off")
    rdq, rdk, rdv = attention_reference_grads(q, k, v, do, causal=True,
                                              scale=scale)[:3]
    fdq = dq.clone()
    fdq[:, h:h + 1, last] = attention_reference_grads(
        q[:, h:h + 1, last], k[:, kh:kh + 1, :n - TILE_ROWS],
        v[:, kh:kh + 1, :n - TILE_ROWS], do[:, h:h + 1, last],
        scale=scale)[0].to(dq.dtype)
    _, cdk, cdv, *_ = attention_reference_grads(
        q[:, grp, last], k[:, kh:kh + 1], v[:, kh:kh + 1], do[:, grp, last],
        causal=True, scale=scale)
    fdk, fdv = dk.clone(), dv.clone()
    fdk[:, kh, mid] -= cdk[:, 0, mid].to(dk.dtype)
    fdv[:, kh, mid] -= cdv[:, 0, mid].to(dv.dtype)
    check("flash_bwd_dq_d32.dq", dq, rdq, fdq)
    check("flash_bwd_dkv_d32.dk", dk, rdk, fdk)
    check("flash_bwd_dkv_d32.dv", dv, rdv, fdv)
    del po, plse, fo, rdq, rdk, rdv, fdq, fdk, fdv, cdk, cdv
    print("d32_checks: " + json.dumps({
        "shape": f"q [{b}, {qh}, {n}, {d}], k/v [{b}, {kvh}, {n}, {d}] "
                 "causal, bf16",
        "readings": readings, "lse_max_abs_err": lse_err,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                   "lse_abs": MIXED_TOL.lse}}), flush=True)
    if problems:
        fail("; ".join(problems))

    lse_c = lse.contiguous()
    d_term = (do.float() * o.float()).sum(dim=-1)
    kw = dict(causal=True, window_size=None, scale=scale)
    fwd = timed_spread(lambda: fa.flash_attention_forward(
        q, k, v, causal=True), 20)
    dq_t = timed_spread(lambda: fb._dq_cuda(q, k, v, do, lse_c, d_term,
                                            **kw), 20)
    dkv_t = timed_spread(lambda: fb._dkv_cuda(q, k, v, do, lse_c, d_term,
                                              **kw), 20)
    plain_fwd, _ = timed(lambda: fa._forward_plain(
        q, k, v, out_dtype=torch.bfloat16, **kw), 3)
    plain_bwd, _ = timed(lambda: fb._backward_plain(q, k, v, do, **kw), 3)
    lib_fwd = timed_spread(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), 20)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                            enable_gqa=True)
    lib_bwd = timed_spread(lambda: torch.autograd.grad(
        sdpa_o, leaves, do, retain_graph=True), 20)
    pairs = visible_pairs(n, n, True, None) * b * qh
    io = nbytes(q, k, v, do, lse_c, d_term)
    bounds = {"flash_fwd_d32": bound(4 * d * pairs, nbytes(q, k, v, o, lse)),
              "flash_bwd_dq_d32": bound(2 * d * 3 * pairs, io + nbytes(dq)),
              "flash_bwd_dkv_d32": bound(2 * d * 4 * pairs,
                                         io + nbytes(dk, dv))}
    src = "metal_flash_attention_tpu_torch/csrc/"
    jax_src = "metal_flash_attention_tpu/ops/"
    shape = f"q [{b}, {qh}, {n}, {d}], k/v [{b}, {kvh}, {n}, {d}] causal"
    note = ("the D 64 kernel over 32-column rows (TMA zero-fills the "
            "boxes' other 32 columns and clips the stores)")
    out = []
    for name, op, t_, plain_ms, lib, err_keys, replaces, library in (
            ("flash_fwd_d32", "flash_fwd", fwd, plain_fwd, lib_fwd,
             ("flash_fwd_d32.o",), "flash_attention.py:223 (and :552)",
             "F.scaled_dot_product_attention(is_causal=True, "
             "enable_gqa=True)"),
            ("flash_bwd_dq_d32", "flash_bwd_dq", dq_t, plain_bwd, lib_bwd,
             ("flash_bwd_dq_d32.dq",), "flash_attention_bwd.py:73",
             "backward of SDPA: dq, dk, dv"),
            ("flash_bwd_dkv_d32", "flash_bwd_dkv", dkv_t, plain_bwd,
             lib_bwd, ("flash_bwd_dkv_d32.dk", "flash_bwd_dkv_d32.dv"),
             "flash_attention_bwd.py:226", "backward of SDPA: dq, dk, dv")):
        by_path = {p: c.get(f"{op}_d32", 0)
                   for p, c in launches_by_path.items()}
        bound_ms, bound_by = bounds[name]
        out.append({
            "name": name, "route": "cuda",
            "source": src + ("flash_attention.cu" if op == "flash_fwd"
                             else "flash_attention_bwd.cu"),
            "replaces": jax_src + replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(readings[k]["max_abs_err"]
                               for k in err_keys),
            **{k.split(".")[1]: readings[k] for k in err_keys},
            "ms": t_["ms"], "spread": t_, "plain_ms": plain_ms,
            "plain_computes": ("o and lse" if op == "flash_fwd" else
                               "dq, dk and dv together"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / t_["ms"],
            "library_ms": lib["ms"], "library_spread": lib,
            "library": library, "shape": shape, "kernel": note,
            "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                       "lse_abs": MIXED_TOL.lse}, "card": card})
    return out + d32_decode_checks(dev, card, launches_by_path)


# Head dim 32 in the paged and dense decode kernels (slice 23): the tiny
# Llama and Gemma-2 configs served on the card, the docs' single-device
# examples through the port, and rows 1 and 6 at D 32 against their plain
# versions.
TINY_SHARED = 32                       # tokens every prompt shares: 2 pages
TINY_SUFFIXES = (9, 45, 98, 20)
TINY_NEW = 24
TINY_PAGE = 16
TINY_BURST = 4
TINY_DENSE = (4, 48)                   # dense batch, prompt tokens
TINY_PRECISIONS = (None, "int8", "nf4")
# Rows 1 and 6 at D 32: the tiny configs' heads (4 q, 2 kv) and pages,
# at contexts long enough that a launch is not all overhead.
D32_DECODE_LENS = (4096, 3000, 1777, 513, 2048, 64, 1, 4000)
D32_PREFILL = (2, 64, (2048, 1100))    # batch, q_chunk, lengths
D32_WIDE_CHUNK = 64                    # chunk positions folded into heads
D32_CAP, D32_WINDOW = 50.0, 64         # GemmaConfig.tiny's cap and window
D32_HEADS = (4, 2)
# The training guide on the card: the share of float32 master weights
# whose two-step update may differ from the plain path's by more than the
# rate (AdamW moves a weight by about the rate whatever its gradient's
# size, so one whose bf16 gradient is near 0 may step either way), and
# the INT8 GEMM's largest error over the output's largest value.
DOCS_ADAM_LR = 3e-4
DOCS_ADAM_FLIP_SHARE = 1e-2
DOCS_GEMM_REL = 1e-2


def attention_modules() -> tuple:
    """(flash_attention, flash_attention_bwd, flash_decode,
    paged_attention, gemm) op modules of the port."""
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    return fa, fb, fd, pa, gemm_module()


@contextlib.contextmanager
def plain_on_card():
    """Every kernel entry of the port's attention and GEMM ops replaced,
    inside the block, by its plain version on the same (CUDA) tensors:
    the reference a path's kernels are held against on the card.  No
    kernel launches and no count moves inside it."""
    from metal_flash_attention_tpu_torch.ops.quantization import (
        QuantizedTensor,
    )
    fa, fb, fd, pa, tg = attention_modules()

    def forward(q, k, v, *, tiles=None, **kw):
        plain = (fa._forward_plain_quantized
                 if isinstance(k, QuantizedTensor) else fa._forward_plain)
        return plain(q, k, v, **kw)

    def grads(q, k, v, do, lse, d_term, *, tiles=None, dbias=None, **kw):
        return fb._backward_plain(q, k, v, do, lse=lse, d_term=d_term, **kw)
    patches = [
        (fa, "_forward_cuda", forward),
        (fb, "_dq_cuda", lambda *a, **kw: grads(*a, **kw)[0]),
        (fb, "_dkv_cuda", lambda *a, **kw: grads(*a, **kw)[1:]),
        (pa, "_paged_attention_cuda",
         lambda q, cache, *, decode, pages_per_chunk=None, **kw:
         pa._paged_attention_plain(q, cache, **kw)),
        (fd, "_flash_decode_cuda",
         lambda q, k, v, *, block_kv=None, **kw:
         fd._flash_decode_plain(q, k, v, **kw)),
        (tg, "_gemm_cuda",
         lambda ops, c, register_dtype, out_dtype, *_:
         tg._plain_product(ops, c, register_dtype, out_dtype))]
    with contextlib.ExitStack() as stack:
        for m, n, fn in patches:
            stack.enter_context(planted(m, n, lambda _, fn=fn: fn))
        yield


@contextlib.contextmanager
def plain_watch(counts: dict):
    """The plain attention versions wrapped, inside the block, to count
    their calls into ``counts``: a path on the card that reaches one has
    left its kernels."""
    fa, _, fd, pa, _ = attention_modules()
    owners = {"_forward_plain": fa, "_forward_plain_quantized": fa,
              "_paged_attention_plain": pa, "_flash_decode_plain": fd}

    def counted(name):
        def wrap(fn):
            def run(*args, **kwargs):
                counts[name] = counts.get(name, 0) + 1
                return fn(*args, **kwargs)
            return run
        return wrap
    with contextlib.ExitStack() as stack:
        for n, m in owners.items():
            stack.enter_context(planted(m, n, counted(n)))
        yield


def d32_count_errors(counts: dict, needed) -> list:
    """A D 32 path's launch problems: a kernel launched off its `_d32`
    count (every launch of a tiny config is at head dim 32), or one of
    ``needed`` never launched."""
    bad = [f"{k} {n} but {k}_d32 {counts.get(k + '_d32', 0)}"
           for k, n in counts.items()
           if k in ("flash_fwd", "flash_decode", "paged_decode",
                    "paged_decode_wide", "paged_prefill")
           and counts.get(k + "_d32", 0) != n]
    bad += [f"{k} never launched" for k in needed if not counts.get(k)]
    return bad


# A tiny config (head_dim 32, bf16), the module whose init_params makes
# its weights, and the port's functions that serve it: the paged chunk and
# decode steps, the dense prefill and decode step, and generate.
TinyConfig = collections.namedtuple(
    "TinyConfig", "cfg module chunk decode prefill dense_step generate")


def tiny_configs() -> dict:
    """{name: TinyConfig} of the two tiny configs."""
    from metal_flash_attention_tpu_torch.models import gemma, llama, serving
    return {
        "llama_tiny": TinyConfig(
            llama.LlamaConfig.tiny(), llama, serving.paged_chunk_step,
            serving.paged_decode_step, serving.prefill, serving.decode_step,
            serving.generate),
        "gemma_tiny": TinyConfig(
            gemma.GemmaConfig.tiny(), gemma, serving.gemma_paged_chunk_step,
            serving.gemma_paged_decode_step, serving.gemma_prefill,
            serving.gemma_decode_step, serving.gemma_generate)}


def tiny_engine(params, cfg, name, kv_precision=None, prefix=False):
    from metal_flash_attention_tpu_torch import ServingEngine
    tiny = tiny_configs()[name]
    hooks = ({} if name == "llama_tiny"
             else {"chunk_step": tiny.chunk, "decode_step": tiny.decode})
    max_seq = TINY_SHARED + max(TINY_SUFFIXES) + TINY_NEW + 1
    return ServingEngine(
        params, cfg, max_batch=len(TINY_SUFFIXES),
        num_pages=len(TINY_SUFFIXES) * -(-max_seq // TINY_PAGE) + 1,
        page_size=TINY_PAGE, max_seq=max_seq, kv_precision=kv_precision,
        prefix_cache=prefix, seed=SAMPLE_SEED, **hooks)


def tiny_drain(eng, prompts, dev, burst=0) -> dict:
    """Request 0 alone, then the others (so a prefix cache hits): the
    streams, seconds and engine calls."""
    import torch
    stages = [prompts[:1], prompts[1:]]
    streams, secs, calls = [], 0.0, 0
    for stage in stages:
        rids = [eng.submit(p, TINY_NEW) for p in stage]
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        while not eng.idle:
            eng.step_burst(burst) if burst else eng.step()
            calls += 1
            if calls > 10_000:
                fail("a tiny engine did not drain")
        torch.cuda.synchronize(dev)
        secs += time.perf_counter() - t0
        streams += [eng.result(r).tolist() for r in rids]
    return {"streams": streams, "seconds": secs, "calls": calls}


def cloned(tree):
    """A copy of a cache (NamedTuples, lists, tuples and dicts of tensors)
    whose tensors are new: a step run on it leaves the original as it
    was."""
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if hasattr(tree, "_fields"):
        return type(tree)(*(cloned(x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cloned(x) for x in tree)
    if isinstance(tree, dict):
        return {k: cloned(x) for k, x in tree.items()}
    return tree


def tiny_replay(params, cfg, name, tokens, prompt, dev, precision=None,
                dense=False) -> tuple[list, list]:
    """Teacher-forced logits of ``tokens`` [batch, n] (every row fed the
    same tokens, whatever the model would pick): the paged steps (chunks
    of TINY_PAGE over the first ``prompt`` tokens, then a decode step a
    token) over bf16 or ``precision`` pools, or with ``dense`` the dense
    prefill and decode steps.  Each step runs twice on the same state:
    first on a copy of the cache with the plain versions
    (`plain_on_card`), then with the kernels, whose cache the next step
    takes; so the two differ by that step's kernels alone, not by K/V
    that earlier steps wrote apart (NF4's 16 levels would turn a bf16
    difference upstream into a whole code step).  Returns (the kernels'
    float32 logits, the plain versions') a step."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving
    tiny = tiny_configs()[name]
    chunk, decode = tiny.chunk, tiny.decode
    b, n = tokens.shape
    got, want = [], []
    with torch.inference_mode():
        if dense:
            cache = serving.init_cache(cfg, b, n, device=dev)
            steps = [(tiny.prefill, tokens[:, :prompt])]
            step = tiny.dense_step
        else:
            if precision is None:
                cache = serving.init_paged_model_cache(
                    cfg, b, n, page_size=TINY_PAGE, device=dev)
            else:
                cache = serving.init_quantized_paged_model_cache(
                    cfg, b, n, precision=precision, page_size=TINY_PAGE,
                    device=dev)
                chunk, decode = serving.paged_chunk_step_q, \
                    serving.paged_decode_step_q
            steps = [(chunk, tokens[:, i:min(i + TINY_PAGE, prompt)])
                     for i in range(0, prompt, TINY_PAGE)]
            step = decode
        steps += [(step, tokens[:, i]) for i in range(prompt, n)]
        for fn, x in steps:
            with plain_on_card():
                ref, _ = fn(params, x, cfg, cloned(cache))
            logits, cache = fn(params, x, cfg, cache)
            got.append(logits.reshape(-1, logits.shape[-1]))
            want.append(ref.reshape(-1, ref.shape[-1]))
    return got, want


def tiny_logits_at(params, cfg, name, dev):
    """logits_at(prompt, prefix) for `tie_gate`: the float32 logits of
    the paged kernel path (chunks of TINY_PAGE, then decode steps) at the
    token after ``prompt`` and ``prefix``, one row."""
    import torch
    tiny = tiny_configs()[name]
    from metal_flash_attention_tpu_torch.models import serving

    def logits_at(prompt, prefix):
        with torch.inference_mode():
            n = len(prompt) + len(prefix) + 1
            cache = serving.init_paged_model_cache(
                cfg, 1, n, page_size=TINY_PAGE, device=dev)
            p = torch.as_tensor(prompt, dtype=torch.int32,
                                device=dev)[None]
            for i in range(0, p.shape[1], TINY_PAGE):
                logits, cache = tiny.chunk(params, p[:, i:i + TINY_PAGE],
                                           cfg, cache)
            logits = logits[:, -1]
            for t in prefix:
                logits, cache = tiny.decode(params, torch.tensor(
                    [int(t)], dtype=torch.int32, device=dev), cfg, cache)
            return logits[0].float()
    return logits_at


def logits_reading(got: list, want: list) -> dict:
    import torch
    g = torch.cat([x.float().reshape(-1) for x in got])
    w = torch.cat([x.float().reshape(-1) for x in want])
    err = g - w
    return {"rel_rms": float(err.pow(2).mean().sqrt()
                             / w.pow(2).mean().sqrt()),
            "max_abs_err": float(err.abs().max()),
            "finite": bool(torch.isfinite(g).all())}


def logits_ok(r: dict) -> bool:
    return (r["finite"] and r["rel_rms"] <= REF_REL_RMS
            and r["max_abs_err"] <= REF_MAX_ABS)


def tiny_serve(dev, card) -> dict:
    """tiny_serve: `LlamaConfig.tiny()` and `GemmaConfig.tiny()` (head_dim
    32, bf16, seeded weights) through the normal entry points on the
    card: the engine (Llama over bf16, INT8 and NF4 pools; both by
    `step()`, by `step_burst(TINY_BURST)` and with the prefix cache), and
    dense `generate`.  Each run's launch counts are set to 0 just before
    it and read just after: every attention launch at D 32, rows 1 and 6
    launched, and no plain attention called; the burst and prefix-cache
    streams equal step()'s up to a near tie (`tie_gate`).  Then each
    path is held against the plain versions on the card by teacher-forced
    logits (the engine's first stream's tokens for every row, so a near
    tie cannot fork them; each step on the same state, `tiny_replay`) at
    the logits gate (REF_REL_RMS, REF_MAX_ABS).  Returns {path: launch
    counts}."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    rng = np.random.default_rng(SEED + 101)
    paths, readings, problems, summary = {}, {}, [], {}
    for name, tiny in tiny_configs().items():
        cfg = tiny.cfg
        params = tiny.module.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 102),
            device=dev)
        shared = rng.integers(0, cfg.vocab_size, TINY_SHARED)
        prompts = [np.concatenate([shared, rng.integers(
            0, cfg.vocab_size, s)]).astype(np.int32) for s in TINY_SUFFIXES]
        runs = [("engine", None, False, 0), ("burst", None, False,
                                             TINY_BURST),
                ("prefix", None, True, 0)]
        if name == "llama_tiny":
            runs += [(f"engine_{p}", p, False, 0)
                     for p in TINY_PRECISIONS if p]
        streams = {}
        # A warm-up request (library loads, cuBLAS handles); not counted.
        tiny_drain(tiny_engine(params, cfg, name), prompts[:2], dev)
        for label, prec, prefix, burst in runs:
            path = f"{name}.{label}"
            plain_calls: dict = {}
            calls: dict = {}
            with plain_watch(plain_calls), counted_calls(
                    serving, SERVE_STEPS, calls):
                reset_attention_counts()
                eng = tiny_engine(params, cfg, name, prec, prefix)
                run = tiny_drain(eng, prompts, dev, burst)
                counts = attention_counts()
            paths[path] = counts
            streams[label] = run["streams"]
            needed = ["paged_decode", "paged_decode_d32"]
            needed += (["paged_prefill_d32"] if prec is None else
                       ["flash_decode_d32", "paged_decode_wide_d32",
                        "flash_fwd_d32"])
            bad = d32_count_errors(counts, needed)
            if name == "llama_tiny" and not burst and not prefix:
                exp = expected_serve_launches(cfg, calls, prec)
                exp.update({f"{k}_d32": n for k, n in exp.items()
                            if k in ("flash_fwd", "flash_decode",
                                     "paged_decode", "paged_decode_wide",
                                     "paged_prefill")})
                bad += [f"{k} {n}, expected {e}" for k, (n, e) in
                        launch_errors(counts, exp).items()]
            if name == "gemma_tiny":
                bad += [f"{k} {n} not capped" for k, n in counts.items()
                        if k in ("paged_decode", "paged_prefill")
                        and counts.get(k + "_softcap") != n]
            if plain_calls:
                bad.append(f"plain attention called {plain_calls}")
            if prefix:
                eng.prefix_cache.flush()
                if not eng.prefix_cache.hit_tokens:
                    bad.append("the prefix cache never hit")
            if eng.alloc.free_pages != eng.alloc.num_pages - 1:
                bad.append("pages leaked")
            for s, p in zip(run["streams"], prompts):
                out = np.asarray(s)
                if len(out) != len(p) + TINY_NEW or not (
                        (out >= 0) & (out < cfg.vocab_size)).all():
                    bad.append("a stream of the wrong length or vocabulary")
            problems += [f"{path}: {x}" for x in bad]
            new = TINY_NEW * len(prompts)
            summary[path] = {
                "new_tokens_per_s": new / run["seconds"],
                "seconds": run["seconds"], "engine_calls": run["calls"],
                "d32_launches": {k: n for k, n in counts.items()
                                 if k.endswith("_d32")},
                "plain_calls": plain_calls}
            if prefix:
                summary[path]["hit_tokens"] = eng.prefix_cache.hit_tokens
            del eng
        # The burst and prefix-cache streams against step()'s: equal, or
        # parting first at a near tie (SPEC_TIE) on the step path.
        logits_at = tiny_logits_at(params, cfg, name, dev)
        gen_tokens = {k: [s[len(p):] for s, p in zip(v, prompts)]
                      for k, v in streams.items()}
        for label in ("burst", "prefix"):
            tie = tie_gate(gen_tokens["engine"], gen_tokens[label], prompts,
                           logits_at)
            summary[f"{name}.{label}"]["streams_vs_step"] = tie
            if not tie["ok"]:
                problems.append(f"{name}: the {label} streams part from "
                                f"step()'s away from a tie: {tie}")
        # Dense generate.
        b, s = TINY_DENSE
        prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s)),
                                 device=dev)
        path = f"{name}.dense"
        plain_calls = {}
        with plain_watch(plain_calls):
            reset_attention_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = tiny.generate(params, prompt, cfg, max_new_tokens=TINY_NEW)
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            counts = attention_counts()
        paths[path] = counts
        want = {"flash_fwd": cfg.n_layers,
                "flash_decode": cfg.n_layers * (TINY_NEW - 1)}
        bad = d32_count_errors(counts, ["flash_fwd_d32",
                                        "flash_decode_d32"])
        bad += [f"{k} {counts.get(k)}, expected {n}"
                for k, n in want.items() if counts.get(k) != n]
        if plain_calls:
            bad.append(f"plain attention called {plain_calls}")
        if tuple(out.shape) != (b, s + TINY_NEW):
            bad.append(f"generate returned {tuple(out.shape)}")
        problems += [f"{path}: {x}" for x in bad]
        summary[path] = {"new_tokens_per_s": b * TINY_NEW / secs,
                         "seconds": secs,
                         "d32_launches": {k: n for k, n in counts.items()
                                          if k.endswith("_d32")},
                         "plain_calls": plain_calls}
        # Teacher-forced logits, kernels against the plain versions on the
        # card: the engine's first stream (every row fed it) through the
        # paged steps of each pool, then the dense steps.
        first = streams["engine"][0]
        tokens = torch.as_tensor(np.tile(first, (2, 1)), device=dev)
        prompt_n = TINY_SHARED + TINY_SUFFIXES[0]
        replays = [("paged", None, False), ("dense", None, True)]
        if name == "llama_tiny":
            replays += [(f"paged_{p}", p, False) for p in TINY_PRECISIONS
                        if p]
        for label, prec, dense in replays:
            got, want = tiny_replay(params, cfg, name, tokens, prompt_n,
                                    dev, prec, dense)
            r = logits_reading(got, want)
            readings[f"{name}.{label}"] = r
            if not logits_ok(r):
                problems.append(f"{name}.{label}: teacher-forced logits "
                                f"disagree with the plain path: {r}")
        del params
        torch.cuda.empty_cache()
    print("tiny_serve: " + json.dumps({
        "configs": "LlamaConfig.tiny(), GemmaConfig.tiny() (dim 128, 4 q / "
                   "2 kv heads, head_dim 32, 2 layers; Gemma: cap 50, "
                   "window 64), bf16, seeded weights",
        "requests": len(TINY_SUFFIXES), "shared_prefix": TINY_SHARED,
        "prompt_tokens": [TINY_SHARED + s for s in TINY_SUFFIXES],
        "new_tokens": TINY_NEW, "page": TINY_PAGE, "burst": TINY_BURST,
        "dense": {"batch": TINY_DENSE[0], "prompt": TINY_DENSE[1]},
        "runs": summary, "teacher_forced_logits": readings,
        "limits": {"rel_rms": REF_REL_RMS, "max_abs": REF_MAX_ABS},
        "card": card}), flush=True)
    if problems:
        fail("tiny_serve: " + "; ".join(problems))
    return paths


def docs_examples(dev, card) -> dict:
    """docs_examples: the docs' single-device examples (the cases of
    tests/test_docs_examples.py but the two eight-device ones, which need
    8 cards) through the port on the card, with seeded inputs; each held
    against the same example through the plain versions on the card
    (`plain_on_card`): attention by the worst 64-row tile, the GEMM by
    its largest error over the output's scale, the training guide's
    losses and master weights, the decode loop's teacher-forced logits.
    The decode loop (tiny Llama, head_dim 32) must launch
    `flash_decode_d32`.  Returns {example: launch counts}."""
    import torch
    import metal_flash_attention_tpu_torch as mfa
    from metal_flash_attention_tpu_torch.dispatch import build_attention
    from metal_flash_attention_tpu_torch.models import llama, serving
    from metal_flash_attention_tpu_torch.models.optim import make_train_step
    from metal_flash_attention_tpu_torch.ops.paged_attention import (
        init_paged_cache,
        paged_append,
        paged_decode,
        quantize_paged,
    )
    from metal_flash_attention_tpu_torch.utils import checkpoint, data

    OP = mfa.OperandPrecision
    _, fb, _, _, tg = attention_modules()
    gen = torch.Generator(device=dev).manual_seed(SEED + 111)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def quickstart():
        q, k, v = randn(2, 8, 256, 64), randn(2, 2, 256, 64), \
            randn(2, 2, 256, 64)
        mask = torch.rand((2, 8, 256, 256), generator=gen, device=dev) < 0.8
        bias = randn(2, 8, 256, 256, dtype=torch.float32)
        ids = torch.sort(torch.randint(0, 3, (2, 256), generator=gen,
                                       device=dev), dim=1).values.to(
            torch.int32)
        o32 = mfa.flash_attention(q, k, v, out_dtype=torch.float32)
        if o32.dtype != torch.float32:
            fail("docs_examples: out_dtype float32 not kept")
        return {"causal": mfa.flash_attention(q, k, v, causal=True),
                "mask_bias_window": mfa.flash_attention(
                    q, k, v, mask=mask, bias=bias, window_size=128),
                "segments": mfa.flash_attention(
                    q, k, v, q_segment_ids=ids, kv_segment_ids=ids,
                    causal=True),
                "low_precision": mfa.flash_attention(
                    q, k, v, low_precision_intermediates=True),
                "out_fp32": o32}

    def dispatch_facade():
        fn = build_attention(mfa.AttentionDescriptor(
            batch=2, q_heads=8, kv_heads=2, q_len=256, kv_len=256,
            head_dim=64, causal=True))
        return {"o": fn(randn(2, 8, 256, 64), randn(2, 2, 256, 64),
                        randn(2, 2, 256, 64))}

    def quantized_kv():
        q, k, v = randn(1, 4, 128, 64), randn(1, 2, 128, 64), \
            randn(1, 2, 128, 64)
        return {"o": mfa.flash_attention(q, mfa.quantize(k, OP.FP8_E4M3),
                                         mfa.quantize(v, OP.FP8_E4M3))}

    def gemm_per_operand():
        x, w = randn(96, 160), randn(160, 64, dtype=torch.float32)
        a = randn(64, 128, dtype=torch.float32)
        b = randn(128, 64, dtype=torch.float32)
        qb = mfa.quantize_matrix(w, OP.INT8, contract_axis=0,
                                 per_channel=True)
        return {"y": mfa.gemm(x, qb),
                "y16": mfa.gemm(a, b, register_precision="bf16")}

    def dense_decode():
        qt, k, v = randn(2, 8, 64), randn(2, 2, 256, 64), \
            randn(2, 2, 256, 64)
        lens = torch.tensor([256, 100], dtype=torch.int32, device=dev)
        return {"o": mfa.flash_decode(qt, k, v, kv_lens=lens),
                "o_int8": mfa.flash_decode(
                    qt, mfa.quantize(k, OP.INT8), mfa.quantize(v, OP.INT8),
                    kv_lens=lens)}

    def paged_pool():
        cache = init_paged_cache(num_pages=16, kv_heads=2, page_size=128,
                                 head_dim=64, batch=2, max_pages=4,
                                 device=dev)
        table = torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]],
                             dtype=torch.int32, device=dev)
        cache = cache._replace(
            k_pages=randn(*cache.k_pages.shape),
            v_pages=randn(*cache.v_pages.shape), page_table=table,
            lengths=torch.tensor([256, 129], dtype=torch.int32, device=dev))
        q = randn(2, 8, 64)
        out = {"o": paged_decode(q, cache),
               "o_int8": paged_decode(q, quantize_paged(cache, OP.INT8))}
        grown = paged_append(cache, q[:, :2, :], q[:, :2, :])
        if int(grown.lengths[0]) != 257:
            fail("docs_examples: paged_append did not grow the cache")
        return out

    def training_guide():
        cfg = llama.LlamaConfig.tiny(n_layers=1)
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 112),
            device=dev)
        shard = os.path.join(tempfile.mkdtemp(prefix="mfa_docs_"), "s.bin")
        data.write_shard(shard, np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, 4000).astype(np.uint16))
        loader = data.TokenLoader([shard], batch=2, seq_len=16, seed=0,
                                  device=dev)
        init, step = make_train_step(
            lambda p, b: llama.loss_fn(p, b, cfg),
            lambda t: torch.optim.AdamW(t, lr=DOCS_ADAM_LR,
                                        betas=(0.9, 0.999), eps=1e-8,
                                        weight_decay=1e-4))
        state = init(params)
        start = [s.clone() for s in state["shadow"]]
        losses = []
        for batch in loader.take(2):
            params, state, loss = step(params, state, batch)
            losses.append(loss.float().reshape(1))
        tree = {"params": params, "opt": state, "data": loader.state()}
        ck = os.path.dirname(shard)
        checkpoint.save(os.path.join(ck, "ck"), tree, step=2)
        fresh = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 112),
            device=dev)
        like = {"params": fresh, "opt": init(fresh), "data": (0, 0)}
        restored = checkpoint.restore(
            checkpoint.latest(os.path.join(ck, "ck")), like=like)
        same = restored["data"] == loader.state() and all(
            torch.equal(a, b) for a, b in zip(restored["opt"]["shadow"],
                                              state["shadow"]))
        shutil.rmtree(ck, ignore_errors=True)
        if not same:
            fail("docs_examples: the checkpoint round trip is not exact")
        moved = torch.cat([(s - s0).reshape(-1) for s, s0 in
                           zip(state["shadow"], start)])
        return {"loss": torch.cat(losses), "update": moved}

    def decode_loop():
        cfg = llama.LlamaConfig.tiny(n_layers=1)
        params = llama.init_params(
            cfg, torch.Generator(device=dev).manual_seed(SEED + 113),
            device=dev)
        prompt = torch.as_tensor(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (2, 8)), device=dev)
        cache = serving.init_cache(cfg, 2, 12, device=dev)
        logits, cache = serving.prefill(params, prompt, cfg, cache)
        tok = logits.argmax(-1).to(torch.int32)
        toks, out = [tok], [logits]
        for _ in range(3):
            logits, cache = serving.decode_step(params, tok, cfg, cache)
            tok = logits.argmax(-1).to(torch.int32)
            toks.append(tok)
            out.append(logits)
        ref = serving.generate(params, prompt, cfg, max_new_tokens=4)
        got = torch.stack(toks, dim=1)
        if got.tolist() != ref[:, prompt.shape[1]:].tolist():
            fail("docs_examples: the decode loop differs from generate")
        # Teacher forcing: the plain path is fed these tokens.
        return {"logits": torch.stack(out, 1), "tokens": got,
                "prompt": prompt, "params": params, "cfg": cfg}

    def decode_loop_plain(run):
        params, cfg, prompt = run["params"], run["cfg"], run["prompt"]
        cache = serving.init_cache(cfg, 2, 12, device=dev)
        logits, cache = serving.prefill(params, prompt, cfg, cache)
        out = [logits]
        for i in range(3):
            logits, cache = serving.decode_step(
                params, run["tokens"][:, i], cfg, cache)
            out.append(logits)
        return torch.stack(out, 1)

    examples = {"readme_quickstart": quickstart,
                "dispatch_facade": dispatch_facade,
                "quantized_kv": quantized_kv,
                "gemm_per_operand": gemm_per_operand,
                "dense_decode": dense_decode, "paged_pool": paged_pool,
                "training_guide": training_guide,
                "decode_loop": decode_loop}
    paths, readings, problems = {}, {}, []
    for name, example in examples.items():
        seed = SEED + 120 + len(paths)
        plain_calls: dict = {}
        gen.manual_seed(seed)
        with plain_watch(plain_calls):
            for m in (fb, tg):
                m.reset_launch_counts()
            reset_attention_counts()
            got = example()
            torch.cuda.synchronize(dev)
            counts = {**attention_counts(), **{
                k: n for m in (fb, tg) for k, n in m.LAUNCH_COUNTS.items()
                if n}}
        paths[name] = counts
        if plain_calls:
            problems.append(f"{name} called plain attention {plain_calls}")
        gen.manual_seed(seed)
        with plain_on_card():
            want = (decode_loop_plain(got) if name == "decode_loop"
                    else example())
            torch.cuda.synchronize(dev)
        if not counts:
            problems.append(f"{name} launched no kernel")
        if name == "decode_loop":
            r = {"logits": logits_reading([got["logits"]], [want])}
            ok = logits_ok(r["logits"])
            if not counts.get("flash_decode_d32"):
                problems.append("the decode loop launched no "
                                "flash_decode_d32")
        elif name == "training_guide":
            r = {"loss_abs_err": float((got["loss"] - want["loss"]).abs()
                                       .max()),
                 "update_off_share": float(
                     ((got["update"] - want["update"]).abs() > DOCS_ADAM_LR)
                     .float().mean())}
            ok = (r["loss_abs_err"] <= TRAIN_LOSS_ABS
                  and r["update_off_share"] <= DOCS_ADAM_FLIP_SHARE)
        elif name == "gemm_per_operand":
            r = {k: float((got[k].float() - want[k].float()).abs().max()
                          / want[k].float().abs().max()) for k in got}
            ok = all(x <= DOCS_GEMM_REL for x in r.values())
        else:
            r = {k: closeness(got[k] if got[k].dim() > 3 else
                              got[k][:, :, None],
                              want[k] if want[k].dim() > 3 else
                              want[k][:, :, None]) for k in got}
            ok = all(within_limits(x) for x in r.values())
        readings[name] = r
        if not ok:
            problems.append(f"{name} disagrees with the plain path: {r}")
    print("docs_examples: " + json.dumps({
        "examples": list(examples), "readings": readings,
        "launches": paths,
        "not_on_one_card": ["parallelism_guide_mesh_and_ring",
                            "parallelism_guide_pipeline (8 devices; "
                            "tests/test_torch_docs_examples.py on the CPU)"],
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                   "logits": {"rel_rms": REF_REL_RMS,
                              "max_abs": REF_MAX_ABS},
                   "train_loss_abs": TRAIN_LOSS_ABS,
                   "update_off_share": DOCS_ADAM_FLIP_SHARE,
                   "gemm_rel": DOCS_GEMM_REL},
        "card": card}), flush=True)
    if problems:
        fail("docs_examples: " + "; ".join(problems))
    return paths


def variant_launches(counts: dict, kernel: str, prec, cap) -> int:
    """A path's D 32 launches of ``kernel`` at precision ``prec`` (None:
    bf16) with or without the cap: its `_d32` count where every one of
    them was of that variant (each tiny run is one precision and one cap
    throughout), else 0."""
    n = counts.get(f"{kernel}_d32", 0)
    quant = {p: counts.get(f"{kernel}_{p}", 0) for p in QUANT_PRECISIONS}
    ok = quant[prec] == n if prec else not any(quant.values())
    ok = ok and counts.get(f"{kernel}_softcap", 0) == (n if cap else 0)
    return n if ok else 0


def d32_decode_checks(dev, card, launches_by_path) -> list[dict]:
    """Rows 1 and 6 at head dim 32 (the tiny configs' 4 q / 2 kv heads,
    TINY_PAGE pages, contexts up to 4,096 keys): `paged_decode`,
    `paged_prefill`, the wide decode (a D32_WIDE_CHUNK-position chunk
    folded into the heads) and `flash_decode`, over bf16 and each
    quantized precision, and with Gemma's cap and window (rows 1) or cap
    (row 6, K/V in the queries' type), each against its plain version by
    the worst 64-row tile (a decode's (sequence, head) rows are tiles of
    their own) and lse, with a planted one-tile fault (a decode's last
    head of sequence 0 a 64-key tile short; the prefill's last head of
    sequence 0 reading a neighbour page for its last) the limit must
    see; then each one's time (warm; median, min-max of GEMM_REPEATS
    profiled loops), its bound, its plain version's and, for row 6 over
    bf16 K/V, SDPA with a length mask, or with the cap `flex_attention`
    with a tanh score_mod and the start-to-length block mask.
    ``launches_by_path``: {path: launch counts} of the paths that ran
    them (tiny_serve's, docs_examples')."""
    import torch
    import torch.nn.functional as F
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.ops.quantization import (
        QuantizedTensor,
        quantize,
    )
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    qh, kvh = D32_HEADS
    d, page = 32, TINY_PAGE
    scale = d ** -0.5
    gen = torch.Generator(device=dev).manual_seed(SEED + 131)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def pools(lengths):
        """bf16 pools with a shuffled table and one spare page (the
        prefill fault's neighbour)."""
        max_pages = -(-max(lengths) // page)
        num_pages = len(lengths) * max_pages + 2
        shape = (num_pages, kvh, page, d)
        perm = torch.randperm(num_pages - 2, generator=gen,
                              device=dev).to(torch.int32) + 2
        return pa.PagedKVCache(
            randn(*shape), randn(*shape),
            perm.reshape(len(lengths), max_pages),
            torch.tensor(lengths, dtype=torch.int32, device=dev))

    def as_rows(o):
        return o if o.dim() == 4 else o[:, :, None]

    readings, problems, out = {}, [], []
    lengths = list(D32_DECODE_LENS)
    pb, pchunk, plens = D32_PREFILL
    caches = {"decode": pools(lengths), "prefill": pools(list(plens))}
    qs = {"paged_decode": randn(len(lengths), qh, d),
          "paged_prefill": randn(pb, qh, pchunk, d),
          "paged_decode_wide": randn(len(lengths), qh * D32_WIDE_CHUNK, d)}
    k_dense, v_dense = randn(len(lengths), kvh, max(lengths), d), \
        randn(len(lengths), kvh, max(lengths), d)
    dlens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    q_dense = randn(len(lengths), qh, d)
    src = "metal_flash_attention_tpu_torch/csrc/"
    # bf16 and each quantized precision; Gemma-2's cap (and window) over
    # bf16 K/V, as the tiny Gemma serves (the card tests hold the cap
    # over quantized pools too).
    variants = [(p, None, None) for p in (None, *QUANT_PRECISIONS)]
    variants += [(None, D32_CAP, D32_WINDOW)]
    for kernel in ("paged_decode", "paged_prefill", "paged_decode_wide",
                   "flash_decode"):
        for prec, cap, window in variants:
            tag = (f"{kernel}_d32" + (f"_{prec}" if prec else "")
                   + ("_softcap" if cap else ""))
            before = dict(pa.LAUNCH_COUNTS, **fd.LAUNCH_COUNTS)
            if kernel == "flash_decode":
                k_, v_ = k_dense, v_dense
                if prec:
                    k_ = quantize(k_dense, OperandPrecision(prec))
                    v_ = quantize(v_dense, OperandPrecision(prec))
                starts = (None if window is None else
                          (dlens - window).clamp_min(0))
                kw = dict(kv_lens=dlens, kv_starts=starts,
                          logit_softcap=cap)

                def run(lens=dlens, k_=k_, v_=v_, kw=kw):
                    return fd.flash_decode(q_dense, k_, v_,
                                           return_residuals=True,
                                           **dict(kw, kv_lens=lens))

                def plain(k_=k_, v_=v_, starts=starts, cap=cap):
                    return fd._flash_decode_plain(
                        q_dense, k_, v_, kv_lens=dlens, kv_starts=starts,
                        max_span=None, scale=scale, softcap=cap)
                short = dlens.clone()
                short[0] -= 64
                fault_o = run(short)[0]
                n_keys = [min(n, window or n) for n in lengths]
                store = (k_.values if isinstance(k_, QuantizedTensor)
                         else k_)
                row_bytes = store.shape[-1] * store.element_size()
                q_used = q_dense
            else:
                decode = kernel != "paged_prefill"
                cache = caches["decode" if decode else "prefill"]
                if prec:
                    cache = pa.quantize_paged(cache, prec)
                q = qs[kernel]
                fn = pa.paged_decode if decode else pa.paged_prefill
                kw = dict(window_size=window, logit_softcap=cap)

                def run(cache=cache, q=q, fn=fn, kw=kw):
                    return fn(q, cache, return_residuals=True, **kw)

                def plain(cache=cache, q=q, window=window, cap=cap):
                    po, plse = pa._paged_attention_plain(
                        as_rows(q), cache, scale=scale, window_size=window,
                        softcap=cap)
                    return po.reshape(q.shape), plse.reshape(q.shape[:-1])
                lens_now = cache.lengths.tolist()
                if decode:
                    bad = cache._replace(lengths=cache.lengths.clone())
                    bad.lengths[0] -= 64
                    n_keys = [min(n, window or n) for n in lens_now]
                else:
                    # Sequence 0's last page read from the spare one.
                    table = cache.page_table.clone()
                    table[0, (lens_now[0] - 1) // page] = 1
                    bad = cache._replace(page_table=table)
                    n_keys = [min(n, pchunk + window - 1 if window else n)
                              for n in lens_now]
                fault_o = run(bad)[0]
                row_bytes = cache.k_pages.shape[-1] * \
                    cache.k_pages.element_size()
                if prec == "nf4":
                    row_bytes //= 2        # two tokens a stored row
                q_used = q
            o, lse = run()
            torch.cuda.synchronize(dev)
            after = dict(pa.LAUNCH_COUNTS, **fd.LAUNCH_COUNTS)
            moved = {k: after[k] - before[k] for k in after
                     if after[k] != before[k]}
            want_keys = {kernel, f"{kernel}_sm90", f"{kernel}_d32"}
            if prec:
                want_keys.add(f"{kernel}_{prec}")
            if cap:
                want_keys.add(f"{kernel}_softcap")
            # run() above for the fault, then for the output: 2 each.
            if moved != {k: 2 for k in want_keys}:
                problems.append(f"{tag} launched {moved}")
            po, plse = plain()
            fault = o.clone()
            fault[0, -1] = fault_o[0, -1]
            r = closeness(as_rows(o), as_rows(po))
            r["planted_fault"] = closeness(as_rows(fault), as_rows(po))
            r["lse_max_abs_err"] = max_abs_err(lse, plse)
            readings[tag] = r
            if not within_limits(r) or r["lse_max_abs_err"] > MIXED_TOL.lse:
                problems.append(f"{tag} disagrees with its plain version")
            if within_limits(r["planted_fault"]):
                problems.append(f"the {tag} check does not see a one-tile "
                                "fault")
            spread = timed_spread(lambda: run(), 20)
            plain_ms, _ = timed(plain, 3)
            rows_a_key = q_used.shape[1] // kvh
            keys = sum(n_keys)
            scale_bytes = 0 if not prec else 2 * 4 * kvh * sum(
                -(-n // page) for n in n_keys)
            io = 2 * nbytes(q_used) + 4 * q_used[..., 0].numel()
            flops = 4 * d * kvh * rows_a_key * keys
            if kernel == "paged_prefill":
                flops = 4 * d * qh * sum(visible_pairs(
                    pchunk, n, True, window) for n in lens_now)
            bound_ms, bound_by = bound(
                flops, 2 * kvh * keys * row_bytes + scale_bytes + io)
            library_ms, library, library_spread = None, None, None
            if kernel == "flash_decode" and not prec and not cap:
                mask = (torch.arange(max(lengths), device=dev)[None, :]
                        < dlens[:, None].long())[:, None, None, :]
                library_spread = timed_spread(
                    lambda: F.scaled_dot_product_attention(
                        q_dense[:, :, None], k_dense, v_dense,
                        attn_mask=mask, enable_gqa=True), 20)
                library = ("F.scaled_dot_product_attention(q[:, :, None], "
                           "k, v, attn_mask=<length mask>, enable_gqa=True)")
            elif kernel == "flash_decode" and not prec:
                # The cap: flex_attention with a tanh score_mod and each
                # sequence's keys from its start to its length.
                flex, library = flex_yardstick(
                    q_dense[:, :, None], k_dense, v_dense, window=None,
                    cap=cap, scale=scale, keys=(starts, dlens))
                if flex is not None:
                    library_spread = timed_spread(flex, 20)
                    r["library_against_kernel"] = closeness(
                        flex(), as_rows(o))
                    library = ("flex_attention(q[:, :, None], k, v, "
                               f"score_mod=<tanh cap {cap}>, block_mask="
                               "<kv_starts <= key < kv_lens>, enable_gqa="
                               "True), compiled")
                del flex
                # Later phases' flex compiles start from none, below
                # dynamo's recompile limit (as after fp32_checks).
                import torch._dynamo
                torch._dynamo.reset()
            if library_spread is not None:
                library_ms = library_spread["ms"]
            by_path = {p: n for p, c in launches_by_path.items()
                       if (n := variant_launches(c, kernel, prec, cap))}
            shape = f"q {list(q_used.shape)}, " + (
                f"k/v {list(k_dense.shape)}, lengths {lengths}"
                if kernel == "flash_decode" else
                f"pages of {page}, lengths {lens_now}")
            if cap:
                shape += f", window {window}, cap {cap}"
            out.append({
                "name": tag, "route": "cuda",
                "source": src + ("flash_decode.cu" if kernel ==
                                 "flash_decode" else "paged_attention.cu"),
                "core": src + "decode_common.cuh",
                "replaces": ("metal_flash_attention_tpu/ops/flash_decode.py"
                             ":82" if kernel == "flash_decode" else
                             "metal_flash_attention_tpu/ops/"
                             "paged_attention.py:183"),
                "launches": sum(by_path.values()),
                "launches_by_path": by_path,
                "max_abs_err": r["max_abs_err"], "o": r,
                "ms": spread["ms"], "spread": spread, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "share_of_bound": bound_ms / spread["ms"],
                "library_ms": library_ms, "library": library,
                "library_spread": library_spread, "shape": shape,
                "timed": f"warm, median of {GEMM_REPEATS} loops of 20 calls",
                "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                           "lse_abs": MIXED_TOL.lse}, "card": card})
    print("d32_decode_checks: " + json.dumps({
        "heads": f"{qh} q / {kvh} kv, head_dim {d}, page {page}",
        "readings": readings,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                   "lse_abs": MIXED_TOL.lse}}), flush=True)
    if problems:
        fail("d32_decode_checks: " + "; ".join(problems))
    return out


# True-fp32 attention (slice 22): the three float32 kernels at the main
# paths' shapes, float32 training at Llama-3-8B widths, and the dry run.
# The float32 peak of an H100 SXM outside the tensor cores (data sheet),
# the bound of the true-fp32 kernels (FFMA, never TF32).
F32_PEAK_FLOPS = 67e12
# A float32 kernel against its float32 plain version by the worst 64-row
# tile: on an H100 the sound readings were 1.4e-6 to 4.3e-6, the same
# kernels on inputs rounded to TF32's 10-bit mantissa 3.9e-4 to 7.2e-4, a
# dropped key tile 5.4e-2 and above; the limit sits about 10x from each
# of the nearest two.
F32_TILE_REL_RMS = 4e-5
F32_CASES = {
    # name: b, q heads, kv heads, q_len, kv_len, head_dim, causal, window,
    # cap.  Llama-3-8B's training shape; a ragged chunk (row 3's
    # per-row key bounds); Gemma-2's global and local layers; the tiny
    # configs' heads.
    "llama_train": (1, 32, 8, 8192, 8192, 128, True, None, None),
    "ragged_chunk": (1, 32, 8, 1000, 8192, 128, True, None, None),
    "gemma_global": (1, 8, 4, 8192, 8192, 256, True, None, 50.0),
    "gemma_local": (1, 8, 4, 8192, 8192, 256, True, 4096, 50.0),
    "tiny_d32": (2, 4, 2, 4096, 4096, 32, True, None, None),
}
F32_ITERS = 2
F32_TRAIN_STEPS = 4
# The 2-layer cut of float32 training against plain attention: the loss
# and every gradient (relative rms).  On an H100 the sound reading was a
# loss 0 off and gradients 6.8e-6; the planted faults' 0.039 (the loss)
# and 0.56 to 3.6 (gradients); the kernels reading operands rounded to
# TF32 (the third) 9.9e-4 on the worst gradient and 9.5e-6 on the loss.
# The gradient limit sits about 10x from the sound and the TF32 readings,
# so attention that multiplied in TF32 fails it.
F32_TRAIN_LOSS_ABS = 1e-5
F32_TRAIN_GRAD_REL_RMS = 1e-4
F32_FAMILIES = {"flash_fwd_f32": "flash_fwd_f32_kernel",
                "flash_bwd_dq_f32": "flash_bwd_dq_f32_kernel",
                "flash_bwd_dkv_f32": "flash_bwd_dkv_f32_kernel",
                "optimizer": "multi_tensor"}


def f32_bound(flops: float, n_bytes: float) -> tuple[float, str]:
    """(bound_ms, bound_by) of a float32 kernel: the larger of the
    operations at F32_PEAK_FLOPS and the bytes at the card's memory
    rate."""
    from metal_flash_attention_tpu_torch.runtime.context import DeviceContext
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    t_bytes = n_bytes / DeviceContext.get().info.hbm_bandwidth * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def flex_precision() -> str:
    """The float32 precision inductor's flex_attention template compiles
    its dots at ("ieee" or "tf32"), under the current TF32 settings."""
    for path in ("torch._inductor.kernel.flex.flex_attention",
                 "torch._inductor.kernel.flex_attention"):
        try:
            mod = importlib.import_module(path)
            return mod.get_float32_precision().strip("'")
        except (ImportError, AttributeError):
            continue
    return "not read: no get_float32_precision in this torch"


def tf32_rounded(x):
    """x rounded to TF32's 10-bit mantissa (to nearest, ties to even), in
    float32: what a kernel that multiplies in TF32 would read."""
    import torch
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


def visible_mask(n, m, causal, window, device, drop_from=None):
    """[n, m] bool: key c visible to query t (the kernels' rule, bottom-
    right causal); keys >= ``drop_from`` hidden too."""
    import torch
    pos = torch.arange(n, device=device)[:, None] + (m - n)
    cols = torch.arange(m, device=device)[None]
    seen = cols <= pos if causal else torch.ones((n, m), dtype=torch.bool,
                                                 device=device)
    if window:
        seen = seen & (cols > pos - window)
    if drop_from is not None:
        seen = seen & (cols < drop_from)
    return seen


def masked_attention(q, k, v, mask, scale, cap):
    """float32 attention of q [..., r, d] over k/v [..., c, d] under a
    [r, c] mask, differentiable: the faults' stand-in for a kernel."""
    import torch
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return p @ v.float()


def fp32_checks(dev, card, launches_by_path) -> list[dict]:
    """fp32_checks: the true-fp32 forward, dQ and dK/dV kernels against
    their plain versions (TF32 off, set and printed) at each of
    F32_CASES, by the worst 64-row tile (F32_TILE_REL_RMS) and lse
    (FP32_TOL.lse), with two planted faults each output's limit must see
    (the last query tile of the last head without the key tile of its last
    visible key (dK/dV: a middle key tile of the last kv head without the
    group's last query tile); the kernel run on inputs rounded to TF32);
    each kernel's ms (median, min-max) beside its bound at F32_PEAK_FLOPS,
    the plain version's ms and the library call's float32 forward and
    forward plus backward (SDPA; with the cap, `flex_attention` with a
    tanh score_mod; never called by the port), and
    `profiling.attention_roofline`'s report of the forward.  ``launches_by_path``: {path: launch counts} of the
    main paths that ran the kernels (fp32_train, dryrun).  Returns the
    kernels line's three entries."""
    import torch
    import torch.nn.functional as F
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.utils import profiling
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        FP32_TOL,
        max_abs_err,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tf32 = {"cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
            "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32}
    print("fp32_checks_tf32: " + json.dumps(tf32), flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED + 71)
    cases, problems = {}, []

    def check(readings, name, got, ref, faults):
        r = closeness(got, ref)
        r["planted_faults"] = {f: closeness(x, ref)
                               for f, x in faults.items()}
        readings[name] = r
        if r["tile_rel_rms"] > F32_TILE_REL_RMS:
            problems.append(f"{name} disagrees with its plain version")
        for f, x in r["planted_faults"].items():
            if x["tile_rel_rms"] <= F32_TILE_REL_RMS:
                problems.append(f"the {name} check does not see the "
                                f"planted fault {f}")

    for label, (b, qh, kvh, n, m, d, causal, window, cap) in \
            F32_CASES.items():
        scale = d ** -0.5
        group = qh // kvh

        def t(heads, length):
            return torch.randn((b, heads, length, d), generator=gen,
                               device=dev)
        q, k, v, do = t(qh, n), t(kvh, m), t(kvh, m), t(qh, n)
        kw = dict(causal=causal, window_size=window, scale=scale,
                  softcap=cap)
        fa.reset_launch_counts()
        fb.reset_launch_counts()
        o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                            window_size=window,
                                            logit_softcap=cap)
        dq, dk, dv = fb.flash_attention_backward(
            q, k, v, do, o, lse, causal=causal, window_size=window,
            logit_softcap=cap)
        torch.cuda.synchronize(dev)
        counted = {k_: c for k_, c in {**fa.LAUNCH_COUNTS,
                                        **fb.LAUNCH_COUNTS}.items() if c}
        want = {f"{op}{s}": 1 for op in ("flash_fwd", "flash_bwd_dq",
                                         "flash_bwd_dkv")
                for s in ("", "_f32", *(("_softcap",) if cap else ()),
                          *((f"_d{d}",) if d in (32, 256) else ()))}
        if counted != want:
            problems.append(f"{label}: launched {counted}, expected {want}")

        def plain_fwd(q_, k_, v_):
            return fa._forward_plain(q_, k_, v_, out_dtype=torch.float32,
                                     **kw)
        po, plse = per_kv_head(plain_fwd, q, k, v)
        rdq, rdk, rdv = per_kv_head(
            lambda *a: fb._backward_plain(*a, **kw), q, k, v, do)
        # Fault 1: the last query tile of the last q head without the key
        # tile that holds its rows' last visible key.
        h, kh = qh - 1, kvh - 1
        last = slice(n - TILE_ROWS, n)
        top = min(m - 1, (n - 1) + (m - n)) if causal else m - 1
        drop = visible_mask(n, m, causal, window, dev,
                            drop_from=top // TILE_ROWS * TILE_ROWS)[last]
        qt = q[:, h, last].detach().requires_grad_(True)
        ot = masked_attention(qt, k[:, kh], v[:, kh], drop, scale, cap)
        dqt, = torch.autograd.grad(ot, qt, do[:, h, last])
        fo, fdq = o.clone(), dq.clone()
        fo[:, h, last] = ot.detach()
        fdq[:, h, last] = dqt
        # dK/dV: the middle key tile without the group's last query tile.
        grp = slice(kh * group, (kh + 1) * group)
        mid = slice(m // 2, m // 2 + TILE_ROWS)
        kk = k[:, kh:kh + 1].detach().requires_grad_(True)
        vv = v[:, kh:kh + 1].detach().requires_grad_(True)
        full = visible_mask(n, m, causal, window, dev)[last]
        og = masked_attention(q[:, grp, last], kk, vv, full, scale, cap)
        cdk, cdv = torch.autograd.grad(og, (kk, vv), do[:, grp, last])
        fdk, fdv = dk.clone(), dv.clone()
        fdk[:, kh, mid] -= cdk[:, 0, mid]
        fdv[:, kh, mid] -= cdv[:, 0, mid]
        # Fault 2: the kernels on inputs rounded to TF32.
        rq, rk, rv, rdo = (tf32_rounded(x) for x in (q, k, v, do))
        to, tlse = fa.flash_attention_forward(rq, rk, rv, causal=causal,
                                              window_size=window,
                                              logit_softcap=cap)
        tdq, tdk, tdv = fb.flash_attention_backward(
            rq, rk, rv, rdo, to, tlse, causal=causal, window_size=window,
            logit_softcap=cap)
        readings = {}
        for name, got, ref, dropped, rounded in (
                ("flash_fwd_f32.o", o, po, fo, to),
                ("flash_bwd_dq_f32.dq", dq, rdq, fdq, tdq),
                ("flash_bwd_dkv_f32.dk", dk, rdk, fdk, tdk),
                ("flash_bwd_dkv_f32.dv", dv, rdv, fdv, tdv)):
            check(readings, name, got, ref, {"dropped_key_tile": dropped,
                                             "tf32_inputs": rounded})
        lse_err = max_abs_err(lse, plse)
        readings["lse_max_abs_err"] = lse_err
        readings["lse_tf32_inputs_max_abs_err"] = max_abs_err(tlse, plse)
        if lse_err > FP32_TOL.lse:
            problems.append(f"{label}: flash_fwd_f32's lse is {lse_err} off")
        del po, plse, rdq, rdk, rdv, fo, fdq, fdk, fdv, to, tlse, tdq, tdk
        del tdv, rq, rk, rv, rdo
        torch.cuda.empty_cache()

        # Times: the kernels, the plain versions, the library call (SDPA;
        # flex_attention for the cap), and the roofline report.
        lse_c = lse.contiguous()
        d_term = (do * o).sum(dim=-1)
        fwd_t = timed_spread(lambda: fa.flash_attention_forward(
            q, k, v, causal=causal, window_size=window, logit_softcap=cap),
            F32_ITERS)
        dq_t = timed_spread(lambda: fb._dq_cuda(q, k, v, do, lse_c, d_term,
                                                **kw), F32_ITERS)
        dkv_t = timed_spread(lambda: fb._dkv_cuda(q, k, v, do, lse_c,
                                                  d_term, **kw), F32_ITERS)
        plain_fwd_ms = event_ms(lambda: per_kv_head(plain_fwd, q, k, v), 1)
        plain_bwd_ms = event_ms(lambda: per_kv_head(
            lambda *a: fb._backward_plain(*a, **kw), q, k, v, do), 1)
        lib = {"library": None, "library_ms": None,
               "library_fwd_bwd_ms": None}
        if cap is None:
            sdpa_kw = dict(is_causal=True) if causal and n == m and \
                not window else dict(attn_mask=visible_mask(
                    n, m, causal, window, dev))
            lib_fwd = timed_spread(lambda: F.scaled_dot_product_attention(
                q, k, v, enable_gqa=True, **sdpa_kw), F32_ITERS)
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]

            def sdpa_fwd_bwd():
                out = F.scaled_dot_product_attention(*leaves, enable_gqa=True,
                                                     **sdpa_kw)
                torch.autograd.grad(out, leaves, do)
            sdpa_fwd_bwd()
            lib = {"library": "F.scaled_dot_product_attention(enable_gqa="
                              "True, " + ("is_causal=True" if "is_causal"
                                          in sdpa_kw else "a bool mask")
                              + ") on the float32 tensors",
                   "library_ms": lib_fwd["ms"],
                   "library_spread": lib_fwd,
                   "library_fwd_bwd_ms": event_ms(sdpa_fwd_bwd, 2)}
            del leaves
        else:
            # The cap: flex_attention with a tanh score_mod, compiled with
            # TF32 off (IEEE float32 dots; its reading against the
            # kernel's o shows it), forward plus its backward.
            flex, note = flex_yardstick(q, k, v, window=window, cap=cap,
                                        scale=scale)
            flex_bwd, bwd_note = (None, None) if flex is None else \
                flex_yardstick(q, k, v, window=window, cap=cap,
                               scale=scale, do=do)
            lib["library"] = note or (
                "flex_attention (tanh score_mod, causal"
                + (" and window" if window else "") + " block mask), "
                "compiled, on the float32 tensors; fwd_bwd: its forward "
                "plus its backward, timed apart"
                + (f"; backward: {bwd_note}" if bwd_note else ""))
            if flex is not None:
                lib_fwd = timed_spread(flex, F32_ITERS)
                lib.update(library_ms=lib_fwd["ms"], library_spread=lib_fwd,
                           library_precision=flex_precision(),
                           library_against_kernel=closeness(flex(), o))
            if flex_bwd is not None:
                lib["library_fwd_bwd_ms"] = (
                    lib_fwd["ms"] + timed_spread(flex_bwd, F32_ITERS)["ms"])
            del flex, flex_bwd
            # These compiles count against dynamo's recompile limit for
            # flex_attention; past it, a later phase's yardstick would run
            # flex unfused.  Later phases start from no compile, as they
            # did before this one.
            import torch._dynamo
            torch._dynamo.reset()
        roofline = None
        if n == m:
            roofline = str(profiling.attention_roofline(
                lambda q_, k_, v_: fa.flash_attention_forward(
                    q_, k_, v_, causal=causal, window_size=window,
                    logit_softcap=cap)[0],
                (q, k, v), n=n, d=d, heads=qh, batch=b, causal=causal,
                iters=F32_ITERS, dispatch_floor=0.0))
        pairs = visible_pairs(n, m, causal, window) * b * qh
        io = nbytes(q, k, v, do, lse_c, d_term)
        cases[label] = {
            "shape": f"q [{b}, {qh}, {n}, {d}], k/v [{b}, {kvh}, {m}, {d}]"
                     f"{' causal' if causal else ''}"
                     f"{f', window {window}' if window else ''}"
                     f"{f', cap {cap}' if cap else ''}, float32",
            "readings": readings, "pairs": pairs,
            "flash_fwd_f32": {"ms": fwd_t["ms"], "spread": fwd_t,
                              "bound": f32_bound(4 * d * pairs,
                                                 nbytes(q, k, v, o, lse)),
                              "plain_ms": plain_fwd_ms,
                              "roofline": roofline},
            "flash_bwd_dq_f32": {"ms": dq_t["ms"], "spread": dq_t,
                                 "bound": f32_bound(6 * d * pairs,
                                                    io + nbytes(dq)),
                                 "plain_ms": plain_bwd_ms},
            "flash_bwd_dkv_f32": {"ms": dkv_t["ms"], "spread": dkv_t,
                                  "bound": f32_bound(8 * d * pairs,
                                                     io + nbytes(dk, dv)),
                                  "plain_ms": plain_bwd_ms},
            **lib, "card": card}
        print(f"fp32_checks[{label}]: " + json.dumps(cases[label]),
              flush=True)
        del q, k, v, do, o, lse, dq, dk, dv, lse_c, d_term
        torch.cuda.empty_cache()
    if problems:
        fail("; ".join(problems))

    src = "metal_flash_attention_tpu_torch/csrc/flash_attention_f32.cu"
    jax_src = "metal_flash_attention_tpu/ops/"
    main = cases["llama_train"]
    out = []
    for name, op, replaces, err_keys in (
            ("flash_fwd_f32", "flash_fwd",
             "flash_attention.py:223 (and :552), float32",
             ("flash_fwd_f32.o",)),
            ("flash_bwd_dq_f32", "flash_bwd_dq",
             "flash_attention_bwd.py:73, float32", ("flash_bwd_dq_f32.dq",)),
            ("flash_bwd_dkv_f32", "flash_bwd_dkv",
             "flash_attention_bwd.py:226, float32",
             ("flash_bwd_dkv_f32.dk", "flash_bwd_dkv_f32.dv"))):
        by_path = {p: c.get(f"{op}_f32", 0)
                   for p, c in launches_by_path.items()}
        bound_ms, bound_by = main[name]["bound"]
        out.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": jax_src + replaces,
            "launches": by_path.get("fp32_train", 0),
            "launches_by_path": by_path,
            "max_abs_err": max(c["readings"][k]["max_abs_err"]
                               for c in cases.values() for k in err_keys),
            "ms": main[name]["ms"], "spread": main[name]["spread"],
            "plain_ms": main[name]["plain_ms"],
            "plain_computes": ("o and lse, one kv head at a time"
                               if op == "flash_fwd" else
                               "dq, dk and dv together, one kv head at a "
                               "time"),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_peak": "67 TFLOP/s float32 (H100 SXM, CUDA cores)",
            "share_of_bound": bound_ms / main[name]["ms"],
            "library_ms": (main["library_ms"] if op == "flash_fwd"
                           else main["library_fwd_bwd_ms"]),
            "library": main["library"] + (
                "" if op == "flash_fwd" else ", forward and backward"),
            "shape": main["shape"],
            "by_case": {label: {"ms": c[name]["ms"],
                                "bound_ms": c[name]["bound"][0],
                                "plain_ms": c[name]["plain_ms"],
                                "library_ms": c["library_ms"],
                                "library_fwd_bwd_ms":
                                    c["library_fwd_bwd_ms"]}
                        for label, c in cases.items()},
            "limits": {"tile_rel_rms": F32_TILE_REL_RMS,
                       "lse_abs": FP32_TOL.lse},
            "card": card})
    return out


def fp32_train(dev, card):
    """fp32_train: Llama-3-8B widths in float32 on TRAIN_LAYERS layers,
    TRAIN_TOKENS + 1 tokens, F32_TRAIN_STEPS AdamW steps, every attention
    launch on the true-fp32 kernels (counts exact); seconds a step,
    tokens/s, peak memory and device ms by family (one more step under the
    profiler).  Returns the parameters, the config and the launch
    counts."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama, optim
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    cfg = llama.LlamaConfig.llama3_8b(n_layers=TRAIN_LAYERS,
                                      dtype=torch.float32)
    params = llama.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 72), device=dev)
    rng = np.random.default_rng(SEED + 73)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (1, TRAIN_TOKENS + 1)), device=dev)
    # The weights are float32 already: no float32 shadows.
    init_fn, step_fn = optim.make_train_step(
        lambda p, batch: llama.loss_fn(p, batch, cfg), master_weights=False)
    state = init_fn(params)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    losses, seconds = [], []
    with CardSampler() as sampler:
        for _ in range(F32_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, state, loss = step_fn(params, state, tokens)
            losses.append(float(loss))
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
        clocks = sampler.stop()
    launches = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {f"{op}{s}": TRAIN_LAYERS * F32_TRAIN_STEPS
                for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                for s in ("", "_f32")}
    wrong = launch_errors(launches, expected)
    if wrong:
        fail(f"fp32_train launched (count, expected) {wrong}")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        fail(f"fp32_train's loss did not fall: {losses}")
    steady = seconds[1:]
    print("fp32_train: " + json.dumps({
        "config": f"llama3_8b widths, {TRAIN_LAYERS} layers, float32, "
                  "AdamW", "tokens_per_step": TRAIN_TOKENS,
        "steps": F32_TRAIN_STEPS, "losses": losses,
        "seconds_per_step": seconds,
        "tokens_per_s": TRAIN_TOKENS * len(steady) / sum(steady),
        "launches": {k: n for k, n in launches.items() if n},
        "max_memory_allocated": peak, "card": card,
        "card_during_steps": clocks}), flush=True)
    profile_step("fp32_train_profile",
                 lambda: step_fn(params, state, tokens), F32_FAMILIES, dev)
    del state
    return params, cfg, launches


def fp32_train_reference(params, cfg, dev, card) -> dict:
    """fp32_train_reference: a 2-layer cut of the float32 weights at
    TRAIN_REF_TOKENS tokens, the loss and every gradient on the
    true-fp32 kernels against the plain-attention path on the card (TF32
    off), with train_reference's two planted faults and a third: the
    kernels reading their q, k, v and dO rounded to TF32."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cut = dict(params, layers=params["layers"][:TRAIN_REF_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=TRAIN_REF_LAYERS)
    rng = np.random.default_rng(SEED + 74)
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
        return float(value.detach()), torch.autograd.grad(value, work)

    ref_loss, ref_grads = value_and_grads(plain_loss)

    def reading(loss_fn) -> dict:
        loss, grads = value_and_grads(loss_fn)
        rel = [float((g - r).pow(2).mean().sqrt()
                     / r.pow(2).mean().sqrt().clamp_min(1e-30))
               for g, r in zip(grads, ref_grads)]
        if not all(np.isfinite(rel)):
            fail("non-finite gradient on the float32 kernel path")
        return {"loss": loss, "loss_abs_err": abs(loss - ref_loss),
                "grad_rel_rms_max": max(rel),
                "grad_rel_rms_median": float(np.median(rel))}

    def seen(r: dict) -> bool:
        return (r["loss_abs_err"] > F32_TRAIN_LOSS_ABS
                or r["grad_rel_rms_max"] > F32_TRAIN_GRAD_REL_RMS)

    def kernel_loss(p):
        return llama.loss_fn(p, tokens, ccfg)

    fa.reset_launch_counts()
    fb.reset_launch_counts()
    out = {"layers": TRAIN_REF_LAYERS, "tokens": TRAIN_REF_TOKENS,
           "plain_loss": ref_loss, **reading(kernel_loss),
           "tol": {"loss_abs": F32_TRAIN_LOSS_ABS,
                   "grad_rel_rms": F32_TRAIN_GRAD_REL_RMS}, "card": card}
    if fa.LAUNCH_COUNTS["flash_fwd_f32"] != TRAIN_REF_LAYERS or \
            fb.LAUNCH_COUNTS["flash_bwd_dkv_f32"] != TRAIN_REF_LAYERS:
        fail("fp32_train_reference did not run the float32 kernels once a "
             "layer")
    faults = {"dkv_lost_group_head": [(fb, "_dkv_cuda", lost_group_head)],
              "fwd_scale_1_over_d": [(fa, "_forward_cuda", unrooted_scale)],
              "tf32_operands": [(fa, "_forward_cuda", tf32_operands),
                                (fb, "_dq_cuda", tf32_operands),
                                (fb, "_dkv_cuda", tf32_operands)]}
    out["planted_faults"] = {}
    for name, sites in faults.items():
        with contextlib.ExitStack() as stack:
            for module, attr, make in sites:
                stack.enter_context(planted(module, attr, make))
            out["planted_faults"][name] = reading(kernel_loss)
    print("fp32_train_reference: " + json.dumps(out), flush=True)
    if seen(out):
        fail("the float32 kernel path's loss or gradients disagree with "
             "the plain-attention reference")
    for name, r in out["planted_faults"].items():
        if not seen(r):
            fail(f"the fp32_train_reference limits do not see the planted "
                 f"fault {name}")
    return out


# The dry run at n = 1: its legs' launches (`entry.py`): the dp x tp x cp
# leg's tiny Llama (bf16, head_dim 32) and the EP leg's MoE (bf16, head_dim
# 64), 2 layers each, one forward and backward a layer; the PP leg's one
# float32 stage (head_dim 32) over PP_MICRO microbatches, then its chain.
def dryrun_expected() -> dict:
    from metal_flash_attention_tpu_torch import entry
    f32 = 2 * entry.PP_MICRO
    out = {}
    for op in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        out.update({op: 2 + 2 + f32, f"{op}_sm90": 2 + 2, f"{op}_f32": f32,
                    f"{op}_d32": 2 + f32})
    return out


def dryrun_phase(dev, card) -> dict:
    """dryrun: the port's `dryrun_multichip(1)` on this card (a one-rank
    NCCL group it starts in this process): JAX's three lines, the launch
    counts exact (`dryrun_expected`), the pipeline leg on the true-fp32
    kernels at head_dim 32 and equal to its chain."""
    import contextlib
    import io

    import torch
    from metal_flash_attention_tpu_torch.entry import dryrun_multichip
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    torch.cuda.set_device(dev)
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    text = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        dryrun_multichip(1)
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    lines = text.getvalue().splitlines()
    for line in lines:
        print(line, flush=True)
    launches = {k: n for k, n in {**fa.LAUNCH_COUNTS,
                                  **fb.LAUNCH_COUNTS}.items() if n}
    wrong = launch_errors(launches, dryrun_expected())
    heads = ("dryrun_multichip(1): mesh dp=1 tp=1 cp=1, loss=",
             "  ep dryrun: mesh dp=1 ep=1, loss=",
             "  pp dryrun: 1 stages fwd+bwd, loss=")
    print("dryrun: " + json.dumps({"lines": lines, "seconds": seconds,
                                   "launches": launches, "card": card}),
          flush=True)
    if len(lines) != 3 or not all(line.startswith(head)
                                  for line, head in zip(lines, heads)):
        fail(f"dryrun printed {lines}")
    if wrong:
        fail(f"dryrun launched (count, expected) {wrong}")
    return launches


def step_reading(new, old, ref_new, loss, ref_loss) -> dict:
    """A training step's parameters and loss against a reference step's
    from the same ``old``: the update's (new - old) relative rms error
    against the reference's update, worst over the leaves, and how many
    leaves came out bit for bit equal."""
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    rel, equal = [], 0
    for a, r, p in zip(flatten(new)[0], flatten(ref_new)[0],
                       flatten(old)[0]):
        equal += bool((a == r).all())
        du, dr = a.float() - p.float(), r.float() - p.float()
        rel.append(float((du - dr).pow(2).mean().sqrt()
                         / dr.pow(2).mean().sqrt().clamp_min(1e-30)))
    return {"loss": float(loss), "ref_loss": float(ref_loss),
            "loss_abs_err": abs(float(loss) - float(ref_loss)),
            "update_rel_rms_max": max(rel), "leaves": len(rel),
            "leaves_bit_equal": equal}


def tp_train(dev, card) -> dict:
    """tp_train: `llama.train_step(mesh=)` at world size 1 (a one-rank
    NCCL group in this process, mesh data 1 x heads 1), SGD at
    TP_TRAIN_LR, held against the plain `train_step` of the same weights
    and rows: (a) Llama-3-8B widths on the train phase's TRAIN_LAYERS-layer
    cut at TRAIN_TOKENS + 1 tokens; (b) the JAX dry run's dp x tp config
    at tp 1 (`LlamaConfig.tiny(n_layers=2, n_heads=4, n_kv_heads=1)`,
    head_dim 32) on tokens [2, 129].  Equal, or within the training gates
    (TRAIN_LOSS_ABS; the update's relative rms TRAIN_GRAD_REL_RMS).  The
    flash counts of the mesh steps are exact and all on the sm90 kernels
    (the dry-run config's at D 32).  Returns the dry-run step's launch
    counts."""
    import torch
    import torch.distributed as dist
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.parallel import (
        DATA_AXIS,
        HEAD_AXIS,
        make_mesh,
        shard,
    )

    store = tempfile.mkdtemp(prefix="mfa_tp_train_store_")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        store, "store"), rank=0, world_size=1)
    readings, problems, dry_launches = {}, [], None
    try:
        mesh = make_mesh(data=1, heads=1)
        cases = (
            ("llama3_8b_cut", llama.LlamaConfig.llama3_8b(
                n_layers=TRAIN_LAYERS), (1, TRAIN_TOKENS + 1)),
            ("dryrun_tiny", llama.LlamaConfig.tiny(
                n_layers=2, n_heads=4, n_kv_heads=1), (2, 129)))
        for label, cfg, shape in cases:
            params = llama.init_params(
                cfg, torch.Generator(device=dev).manual_seed(SEED + 71),
                device=dev)
            tokens = torch.as_tensor(np.random.default_rng(SEED + 72)
                                     .integers(0, cfg.vocab_size, shape),
                                     device=dev)
            ref_new, ref_loss = llama.train_step(params, tokens, cfg,
                                                 lr=TP_TRAIN_LR)
            local = shard(params, llama.param_shardings(cfg, mesh), mesh)
            llama.train_step(local, tokens, cfg, lr=TP_TRAIN_LR,
                             mesh=mesh)          # NCCL's communicator
            collectives = {}
            fa.reset_launch_counts()
            fb.reset_launch_counts()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            with counted_collectives(collectives):
                new, loss = llama.train_step(local, tokens, cfg,
                                             lr=TP_TRAIN_LR, mesh=mesh)
            torch.cuda.synchronize(dev)
            secs = time.perf_counter() - t0
            launches = {k: n for k, n in {**fa.LAUNCH_COUNTS,
                                          **fb.LAUNCH_COUNTS}.items() if n}
            suffixes = ("", "_sm90") + (("_d32",) if cfg.head_dim == 32
                                        else ())
            want = {f"{op}{s}": cfg.n_layers for op in (
                "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                for s in suffixes}
            r = step_reading(new, params, ref_new, loss, ref_loss)
            r.update(layers=cfg.n_layers, head_dim=cfg.head_dim,
                     tokens=list(shape), seconds=secs, launches=launches,
                     collectives=collectives)
            readings[label] = r
            if launches != want:
                problems.append(f"{label} launched {launches}, expected "
                                f"{want}")
            if not all(collectives.get(f"points_{a}")
                       for a in (DATA_AXIS, HEAD_AXIS)):
                problems.append(f"{label}: the mesh step reached no "
                                f"collective of an axis: {collectives}")
            if r["loss_abs_err"] > TRAIN_LOSS_ABS or \
                    r["update_rel_rms_max"] > TRAIN_GRAD_REL_RMS:
                problems.append(f"{label}: the mesh step leaves the plain "
                                "one past the training gates")
            if cfg.head_dim == 32:
                dry_launches = launches
            del params, local, new, ref_new
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    print("tp_train: " + json.dumps({
        "world_size": 1, "mesh": {"data": 1, "heads": 1, "context": 1},
        "lr": TP_TRAIN_LR, "readings": readings,
        "gates": {"loss_abs": TRAIN_LOSS_ABS,
                  "update_rel_rms": TRAIN_GRAD_REL_RMS},
        "note": "world size 1: every collective skipped its call "
                "(points_*: the collective points reached); "
                "tools/tp_probe.py trains at dp 2 x tp 2 on four cards",
        "card": card}), flush=True)
    if problems:
        fail("; ".join(problems))
    return dry_launches


# Ring and zigzag attention and the pipeline (slice 21): the ring's
# per-rank bodies as threads on this card, and `pipeline` at world size 1.
RING_RANKS = 4
RING_CASES = {"d128": dict(batch=1, heads=(32, 8), head_dim=128,
                           chunk=4096),      # Llama-3-8B's attention
              "d32": dict(batch=2, heads=(4, 2), head_dim=32,
                          chunk=1024)}       # the tiny configs' heads
RING_WAIT_S = 300.0
PP_LAYERS = 2
PP_MICRO = 4
PP_TOKENS = 2048                             # a microbatch: 1 x 2,048


def held_rotate(rotate, hold_from: int):
    """``rotate`` whose calls from the ``hold_from``-th on keep their own
    tensors (a planted fault: a backward's closing dK/dV hop skipped);
    every rank skips the same hop, so none waits."""
    calls = itertools.count()

    def run(tensors):
        if next(calls) >= hold_from:
            tensors = [t.contiguous() for t in tensors]
            return lambda: tensors
        return rotate(tensors)
    return run


class ThreadRing:
    """RING_RANKS ranks of a ring as threads on one card.
    ``rotate_for(rank, tag)`` is a body's ``rotate``: a call's tensors go
    to the next rank, and its ``wait()`` returns the previous rank's
    tensors of the same call.  The threads take turns: each holds the
    ring's lock but while it waits, so the wrappers' launch counts stay
    exact and the launches reach the card's stream in turn."""

    def __init__(self, n: int):
        self.n = n
        self.cond = threading.Condition()
        self.slots, self.failed = {}, False
        self.local = threading.local()

    def rotate_for(self, rank: int, tag: str):
        calls = itertools.count()

        def rotate(tensors):
            i, tensors = next(calls), list(tensors)
            self.slots[(tag, rank, i)] = tensors
            self.cond.notify_all()

            def wait():
                key = (tag, (rank - 1) % self.n, i)
                if not self.cond.wait_for(
                        lambda: key in self.slots or self.failed,
                        timeout=RING_WAIT_S) or self.failed:
                    raise RuntimeError(f"ring rank {rank}: no tensors from "
                                       f"rank {key[1]} at call {i}")
                return self.slots.pop(key)
            return wait
        return rotate

    def run(self, body) -> list:
        """``body(rank, ring)`` on every rank's thread -> their results."""
        out, errors = [None] * self.n, []

        def main(rank):
            self.local.rank = rank
            with self.cond:
                try:
                    out[rank] = body(rank, self)
                except BaseException as e:    # re-raised below
                    errors.append(e)
                    self.failed = True
                finally:
                    self.cond.notify_all()
        threads = [threading.Thread(target=main, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return out


def ring_modules() -> tuple:
    """The modules `parallel.ring_attention` and `parallel.zigzag` (the
    package exports a function of the first name)."""
    return tuple(importlib.import_module(
        f"metal_flash_attention_tpu_torch.parallel.{m}")
        for m in ("ring_attention", "zigzag"))


@contextlib.contextmanager
def recorded_rank_calls(ring, calls: dict):
    """Each ring call to the flash forward and backward kept, with its
    arguments, under the calling thread's rank (`rank_kernel_ms` replays
    them)."""
    def make(fn):
        def run(*args, **kw):
            calls.setdefault(ring.local.rank, []).append((fn, args, kw))
            return fn(*args, **kw)
        return run
    with contextlib.ExitStack() as stack:
        for module in ring_modules():
            for name in ("flash_attention_forward",
                         "flash_attention_backward"):
                stack.enter_context(planted(module, name, make))
        yield


def rank_kernel_ms(calls: dict) -> list:
    """Each rank's kernel ms: the device time of its ring's attention
    calls replayed back to back (`timed`: the card's kernel durations
    under torch.profiler).  The threads' turns leave the card waiting on
    the host between calls, so the run itself times the host."""
    return [timed(lambda: [fn(*a, **kw) for fn, a, kw in calls[r]], 3)[0]
            for r in range(len(calls))]


def ring_run(kind, blocks, hold_from=None, calls=None) -> list:
    """The causal ring's or zigzag's forward then backward bodies on
    RING_RANKS threads over ``blocks`` (each rank's q, k, v, dO) ->
    each rank's (o, lse, dq, dk, dv); ``hold_from``: the backward's
    rotate `held_rotate`; ``calls``: each rank's attention calls are kept
    there (`recorded_rank_calls`)."""
    ra, zz = ring_modules()
    fwd, bwd = ((ra.ring_attention_local, ra.ring_attention_bwd_local)
                if kind == "ring" else
                (zz.zigzag_fwd_local, zz.zigzag_bwd_local))
    extra = {"causal": True} if kind == "ring" else {}
    ring = ThreadRing(RING_RANKS)

    def body(rank, ring):
        q, k, v, do = blocks[rank]
        kw = dict(index=rank, n=RING_RANKS, **extra)
        o, lse = fwd(q, k, v, rotate=ring.rotate_for(rank, "fwd"), **kw)
        rotate = ring.rotate_for(rank, "bwd")
        if hold_from is not None:
            rotate = held_rotate(rotate, hold_from)
        return (o, lse, *bwd(q, k, v, do, o, lse, rotate=rotate, **kw))
    with (recorded_rank_calls(ring, calls) if calls is not None
          else contextlib.nullcontext()):
        return ring.run(body)


def ring_case(label, case, dev) -> tuple[dict, dict]:
    """One head shape's ring_checks: (its reading, its launch counts by
    run)."""
    import torch
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.parallel import (
        zigzag_shard,
        zigzag_unshard,
    )
    from metal_flash_attention_tpu_torch.utils.tolerances import MIXED_TOL

    n, chunk, d = RING_RANKS, case["chunk"], case["head_dim"]
    (hq, hkv), b = case["heads"], case["batch"]
    scale, seq = d ** -0.5, RING_RANKS * chunk
    gen = torch.Generator(device=dev).manual_seed(SEED + 101 + d)

    def randn(heads):
        return torch.randn((b, heads, seq, d), generator=gen,
                           device=dev).to(torch.bfloat16)
    q, k, v, do = randn(hq), randn(hkv), randn(hkv), randn(hq)
    ref_o, ref_lse = fa.flash_attention_forward(q, k, v, causal=True)
    refs = (ref_o, ref_lse, *fb.flash_attention_backward(
        q, k, v, do, ref_o, ref_lse, causal=True))
    names = ("o", "lse", "dq", "dk", "dv")
    problems, readings, launches, rank_ms = [], {}, {}, {}
    ops = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
    suffixes = ("", "_sm90") + (("_d32",) if d == 32 else ())
    calls = {"ring": RING_RANKS * (RING_RANKS + 1) // 2,
             "zigzag": RING_RANKS * (RING_RANKS + 2)}

    def judge(name, got, ref, fault=None):
        if name.endswith(".lse"):
            r = {"max_abs_err": float((got - ref).abs().max())}
            r["ok"] = r["max_abs_err"] <= MIXED_TOL.lse
        else:
            r = closeness(got, ref)
            r["ok"] = within_limits(r)
        if fault is not None:
            r["planted_fault"] = closeness(fault, ref)
            if within_limits(r["planted_fault"]):
                problems.append(f"{label} {name}: the check does not see "
                                "the planted fault")
        readings[name] = r
        if not r["ok"]:
            problems.append(f"{label} {name} disagrees with one card")

    for kind in ("ring", "zigzag"):
        order, undo = ((lambda x: x, lambda x: x) if kind == "ring" else
                       (lambda x: zigzag_shard(x, n),
                        lambda x: zigzag_unshard(x, n)))
        laid = [order(x) for x in (q, k, v, do)]
        blocks = [[x[:, :, r * chunk:(r + 1) * chunk].contiguous()
                   for x in laid] for r in range(n)]
        fa.reset_launch_counts()
        fb.reset_launch_counts()
        rank_calls = {}
        ranks = ring_run(kind, blocks, calls=rank_calls)
        torch.cuda.synchronize(dev)
        counted = {k_: c for k_, c in {**fa.LAUNCH_COUNTS,
                                       **fb.LAUNCH_COUNTS}.items() if c}
        launches[kind] = counted
        want = {f"{op}{s}": calls[kind] for op in ops for s in suffixes}
        if counted != want:
            problems.append(f"{label} {kind} launched {counted}, expected "
                            f"{want}")
        rank_ms[kind] = rank_kernel_ms(rank_calls)
        del rank_calls
        got = [undo(torch.cat([r_[i] for r_ in ranks], dim=2))
               for i in range(len(names))]
        fault = None
        if kind == "ring":
            # The closing hop skipped: each rank keeps the dK/dV sums of
            # the next rank's chunk.
            faulty = ring_run(kind, blocks, hold_from=2 * (n - 1))
            fault = torch.cat([r_[3] for r_ in faulty], dim=2)
            del faulty
        for i, name in enumerate(names):
            judge(f"{kind}.{name}", got[i], refs[i],
                  fault if name == "dk" else None)
        del ranks, got, blocks, laid

    # The ring's call shapes, each kernel against its plain version: a
    # full chunk pair (the last chunk's queries, the first chunk's keys),
    # zigzag's two (a rank's two chunks against one; one against two),
    # and the backward of the first with the whole sequence's residuals.
    def rows(x, lo, hi):
        return x[:, :, lo:hi].contiguous()
    half = chunk // 2
    last, first = (seq - chunk, seq), (0, chunk)
    shapes = {"full_pair": (rows(q, *last), rows(k, *first),
                            rows(v, *first)),
              "zigzag_low": (rows(q, 0, chunk), rows(k, 0, half),
                             rows(v, 0, half)),
              "zigzag_high": (rows(q, 0, half), rows(k, 0, chunk),
                              rows(v, 0, chunk))}
    for name, (qs, ks, vs) in shapes.items():
        o, lse = fa.flash_attention_forward(qs, ks, vs)
        po, plse = fa._forward_plain(qs, ks, vs, causal=False,
                                     window_size=None, scale=scale,
                                     out_dtype=torch.float32)
        judge(f"{name}.o", o, po)
        judge(f"{name}.lse", lse, plse)
    qs, ks, vs = shapes["full_pair"]
    dos, os_, lses = rows(do, *last), rows(ref_o, *last), \
        ref_lse[:, :, last[0]:last[1]].contiguous()
    grads = fb.flash_attention_backward(qs, ks, vs, dos, os_, lses)
    d_term = (dos.float() * os_.float()).sum(dim=-1)
    plain = fb._backward_plain(qs, ks, vs, dos, causal=False,
                               window_size=None, scale=scale, lse=lses,
                               d_term=d_term)
    for name, g, p in zip(("dq", "dk", "dv"), grads, plain):
        judge(f"global_residuals.{name}", g, p)
    if problems:
        fail("; ".join(problems))
    return {"shape": f"q [{b}, {hq}, {seq}, {d}], k/v [{b}, {hkv}, {seq}, "
                     f"{d}] causal, bf16, {n} ranks of {chunk} tokens",
            "readings": readings, "launches": launches,
            "rank_kernel_ms": rank_ms}, launches


def ring_checks(dev, card) -> dict:
    """ring_checks: the causal ring's and zigzag's forward and backward
    bodies (`parallel.ring_attention`, `parallel.zigzag`) on RING_RANKS
    threads of this card at each RING_CASES head shape, gathered and held
    against the one-card flash forward and backward over the whole
    sequence (the worst 64-row tile, KERNEL_TILE_REL_RMS; lse at
    MIXED_TOL), with exact launch counts (the ring 1 + 2 + 3 + 4 calls,
    zigzag 6 a rank) on the sm90 kernels (and `_d32`), a planted fault
    (the closing dK/dV hop skipped), and each of the ring's call shapes
    against the kernels' plain versions.  Printed: each rank's kernel ms
    (`rank_kernel_ms`).  Returns {case: {run: launch counts}}."""
    out, launches = {}, {}
    for label, case in RING_CASES.items():
        out[label], launches[label] = ring_case(label, case, dev)
    print("ring_checks: " + json.dumps({
        "ranks": RING_RANKS, "cases": out,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS},
        "note": "the ranks are threads taking turns on one card: each "
                "rank's kernel ms is the device time of its attention "
                "calls replayed back to back (its share of the work), not "
                "a time on a card of its own (tools/tp_probe.py "
                "ring_train_checks runs the ring on 4 cards)",
        "card": card}), flush=True)
    return launches


def pp_check(dev, card) -> dict:
    """pp_check: `parallel.pipeline` at world size 1 (a one-rank NCCL
    group, `make_pipeline_mesh(1)`), the stage PP_LAYERS Llama-3-8B
    layers (attention and MLP) in bf16, over PP_MICRO microbatches of
    PP_TOKENS tokens: the loss mean(out^2) and every parameter gradient
    against the sequential chain of the same layers, by the training
    gates (TRAIN_LOSS_ABS, TRAIN_GRAD_REL_RMS), with exact flash launch
    counts on the sm90 kernels.  Returns the pipeline's counts."""
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
    )

    store = tempfile.mkdtemp(prefix="mfa_pp_check_store_")
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="file://" + os.path.join(
        store, "store"), rank=0, world_size=1)
    try:
        cfg = llama.LlamaConfig.llama3_8b(n_layers=PP_LAYERS)
        gen = torch.Generator(device=dev).manual_seed(SEED + 111)
        layers = llama.init_params(cfg, gen, device=dev)["layers"]
        mesh = make_pipeline_mesh(1)
        stacked = stack_stage_params([stack_stage_params(layers)])
        local = shard(stacked, stage_param_sharding(stacked, mesh), mesh)
        x = torch.randn((PP_MICRO, 1, PP_TOKENS, cfg.dim), generator=gen,
                        device=dev).to(cfg.dtype)
        pos = torch.arange(PP_TOKENS, device=dev)[None]
        cos, sin = llama.rope_frequencies(cfg, pos)

        def stage_fn(p, h):
            for i in range(PP_LAYERS):
                layer = {k: t[i] for k, t in p.items()}
                h, _ = llama.attention_block(layer, h, cfg, cos, sin)
                h = llama.mlp_block(layer, h, cfg)
            return h

        def loss_and_grads(run):
            leaves = {k: t.detach().requires_grad_(True)
                      for k, t in local.items()}
            loss = run(leaves).float().pow(2).mean()
            return float(loss), torch.autograd.grad(
                loss, list(leaves.values()))
        seq = loss_and_grads(lambda p: torch.stack([
            stage_fn({k: t[0] for k, t in p.items()}, x[i])
            for i in range(PP_MICRO)]))
        loss_and_grads(lambda p: pipeline(stage_fn, p, x, mesh=mesh))
        fa.reset_launch_counts()
        fb.reset_launch_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        loss, grads = loss_and_grads(
            lambda p: pipeline(stage_fn, p, x, mesh=mesh))
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        launches = {k: c for k, c in {**fa.LAUNCH_COUNTS,
                                      **fb.LAUNCH_COUNTS}.items() if c}
    finally:
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    rel = [rel_rms(g, r) for g, r in zip(grads, seq[1])]
    steps = PP_MICRO          # M + S - 1 pipeline steps, S = 1 stage
    want = {f"{op}{s}": steps * PP_LAYERS for op in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv") for s in ("", "_sm90")}
    reading = {"loss": loss, "ref_loss": seq[0],
               "loss_abs_err": abs(loss - seq[0]),
               "grad_rel_rms_max": max(rel), "seconds": secs,
               "launches": launches}
    print("pp_check: " + json.dumps({
        "world_size": 1, "stages": 1, "microbatches": PP_MICRO,
        "stage": f"{PP_LAYERS} Llama-3-8B layers (attention and MLP), "
                 f"bf16, microbatches [1, {PP_TOKENS}, {cfg.dim}]",
        "reading": reading,
        "gates": {"loss_abs": TRAIN_LOSS_ABS,
                  "grad_rel_rms": TRAIN_GRAD_REL_RMS},
        "note": "one stage: the pipeline's schedule, hops and output sum "
                "are the identity; tools/tp_probe.py pp_train runs 4 "
                "stages on 4 cards", "card": card}), flush=True)
    if launches != want:
        fail(f"pp_check launched {launches}, expected {want}")
    if reading["loss_abs_err"] > TRAIN_LOSS_ABS or \
            reading["grad_rel_rms_max"] > TRAIN_GRAD_REL_RMS:
        fail("pp_check: the pipeline leaves the sequential chain past the "
             "training gates")
    return launches


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


# ---------------------------------------------------------------------------
# Gemma-2 (gemma2_2b at full width and depth): serving by the engine's
# family hooks, dense generate, a reference cut and the kernels at D 256
# with the soft cap
# ---------------------------------------------------------------------------

GEMMA_STEPS = ("gemma_paged_chunk_step", "gemma_paged_decode_step")
GEMMA_KERNEL_SUFFIXES = ("", "_sm90", "_softcap", "_d256")


def gemma_engine(params, cfg, prefix_cache=False):
    """The engine with the Gemma hooks (looked up now, so that a
    `counted_calls` block around the construction counts them), max_batch
    MAX_BATCH, page PAGE, max_seq GEMMA_MAX_SEQ, every slot's worst case
    in the pool."""
    from metal_flash_attention_tpu_torch import ServingEngine
    from metal_flash_attention_tpu_torch.models import serving

    return ServingEngine(
        params, cfg, max_batch=MAX_BATCH,
        num_pages=MAX_BATCH * -(-GEMMA_MAX_SEQ // PAGE) + 1,
        page_size=PAGE, max_seq=GEMMA_MAX_SEQ,
        chunk_step=serving.gemma_paged_chunk_step,
        decode_step=serving.gemma_paged_decode_step,
        prefix_cache=prefix_cache, seed=SAMPLE_SEED)


def gemma_drain(eng, prompts, dev, burst=0) -> dict:
    """Submit ``prompts`` (MAX_NEW new tokens each) and drain by `step()`
    or `step_burst(burst)`: the streams, seconds, engine calls and each
    request's time to first token (host clock, the token read back)."""
    import torch

    rids = [eng.submit(p, MAX_NEW) for p in prompts]
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    first, calls = {}, 0
    while not eng.idle:
        out = eng.step_burst(burst) if burst else eng.step()
        now = time.perf_counter() - t0
        for rid, _ in out:
            first.setdefault(rid, now)
        calls += 1
        if calls > 10_000:
            fail("the Gemma engine did not drain")
    torch.cuda.synchronize(dev)
    return {"streams": [eng.result(r).tolist() for r in rids],
            "seconds": time.perf_counter() - t0, "calls": calls,
            "ttft_s": [first[r] for r in rids]}


def gemma_launches() -> dict:
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    return {**pa.LAUNCH_COUNTS, **fd.LAUNCH_COUNTS, **fa.LAUNCH_COUNTS}


def reset_attention_counts() -> None:
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    for m in (pa, fd, fa):
        m.reset_launch_counts()


def gemma_counted_drain(params, cfg, stages, dev, burst=0,
                        prefix_cache=False) -> tuple[dict, dict]:
    """One Gemma serve (``stages``: lists of prompts drained in turn on
    one engine) with every attention launch count set to 0 just before
    and read just after, held exact: a layer's chunk step is one
    `paged_prefill`, its decode step one `paged_decode` (Gemma's GQA
    group of 2 fits one decode fragment), every one on the Hopper kernels
    with the soft cap at head_dim 256 (`_sm90`, `_softcap`, `_d256`), and
    nothing else.  Returns (run, launches)."""
    from metal_flash_attention_tpu_torch.models import serving

    calls: dict = {}
    with counted_calls(serving, GEMMA_STEPS, calls):
        reset_attention_counts()
        eng = gemma_engine(params, cfg, prefix_cache=prefix_cache)
        runs = [gemma_drain(eng, s, dev, burst) for s in stages]
        run = {"streams": sum((r["streams"] for r in runs), []),
               "seconds": sum(r["seconds"] for r in runs),
               "calls": sum(r["calls"] for r in runs),
               "ttft_s": sum((r["ttft_s"] for r in runs), [])}
        if prefix_cache:
            run["hit_tokens"] = eng.prefix_cache.hit_tokens
        prompts = sum(stages, [])
        launches = gemma_launches()
    expected = {f"{kernel}{s}": cfg.n_layers * len(calls[step])
                for kernel, step in (("paged_prefill", GEMMA_STEPS[0]),
                                     ("paged_decode", GEMMA_STEPS[1]))
                for s in GEMMA_KERNEL_SUFFIXES}
    wrong = launch_errors(launches, expected)
    if wrong or not expected["paged_prefill"] or \
            not expected["paged_decode"]:
        fail(f"gemma serve launched (count, expected) {wrong}")
    for stream, p in zip(run["streams"], prompts):
        out = np.asarray(stream)
        if len(out) != len(p) + MAX_NEW:
            fail(f"a Gemma request returned {len(out)} tokens")
        if not ((out >= 0) & (out < cfg.vocab_size)).all():
            fail("a Gemma request emitted a token outside the vocabulary")
    if prefix_cache:
        eng.prefix_cache.flush()
    if eng.alloc.free_pages != eng.alloc.num_pages - 1:
        fail(f"the Gemma serve leaked pages: {eng.alloc.free_pages} of "
             f"{eng.alloc.num_pages - 1} free")
    run.update(chunk_steps=len(calls[GEMMA_STEPS[0]]),
               decode_steps=len(calls[GEMMA_STEPS[1]]))
    return run, launches


def gemma_serve(params, cfg, dev, card) -> dict:
    """gemma_serve: GEMMA_PROMPT_LENS (two beyond the 4,096-token window,
    so the local layers cut) by `step()`, then by `step_burst(BURST_K)`
    (streams equal), then a shared GEMMA_SHARED-token prefix on an engine
    with the prefix cache and one without (streams equal, the hits
    counted).  Returns the `step()` run's launch counts."""
    import torch

    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in GEMMA_PROMPT_LENS]
    # Warm-up request (library load, cuBLAS handles); not counted.
    gemma_drain(gemma_engine(params, cfg), [prompts[0][:64]], dev)
    torch.cuda.reset_peak_memory_stats(dev)
    step, launches = gemma_counted_drain(params, cfg, [prompts], dev)
    peak = torch.cuda.max_memory_allocated(dev)
    burst, burst_launches = gemma_counted_drain(params, cfg, [prompts], dev,
                                                burst=BURST_K)
    if burst["streams"] != step["streams"]:
        fail("the Gemma engine's step_burst streams differ from step()'s")
    shared = rng.integers(0, cfg.vocab_size,
                          (GEMMA_SHARED,)).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
             for n in GEMMA_SUFFIXES_LENS]
    reqs = [np.concatenate([shared, t]) for t in tails]
    stages = [reqs[:1], reqs[1:]]
    cached, cached_launches = gemma_counted_drain(
        params, cfg, stages, dev, prefix_cache=True)
    uncached, _ = gemma_counted_drain(params, cfg, stages, dev)
    if cached["streams"] != uncached["streams"]:
        fail("the cached Gemma engine's streams differ from the uncached "
             "one's")
    hits = (len(reqs) - 1) * (GEMMA_SHARED // PAGE * PAGE)
    if cached["hit_tokens"] != hits:
        fail(f"the Gemma prefix serve hit {cached['hit_tokens']} tokens, "
             f"not {hits}")

    def summary(run):
        tokens = MAX_NEW * len(run["streams"])
        return {"seconds": run["seconds"], "calls": run["calls"],
                "chunk_steps": run["chunk_steps"],
                "decode_steps": run["decode_steps"],
                "new_tokens_per_s": tokens / run["seconds"],
                "ttft_s": run["ttft_s"]}
    print("gemma_serve: " + json.dumps({
        "config": f"gemma2_2b, {cfg.n_layers} layers (full depth), bf16, "
                  f"head_dim {cfg.head_dim}, softcap "
                  f"{cfg.attn_logit_softcap}, window {cfg.sliding_window}",
        "requests": len(prompts),
        "prompt_tokens": int(sum(GEMMA_PROMPT_LENS)),
        "step": summary(step), "burst": dict(summary(burst), k=BURST_K),
        "streams_equal": True, "max_memory_allocated": peak,
        "launches": {k: n for k, n in launches.items() if n},
        "burst_launches": {k: n for k, n in burst_launches.items() if n},
        "prefix": {"shared_tokens": GEMMA_SHARED,
                   "suffixes": list(GEMMA_SUFFIXES_LENS),
                   "hit_tokens": cached["hit_tokens"],
                   "cached": summary(cached),
                   "uncached": summary(uncached),
                   "cached_launches": {k: n for k, n in
                                       cached_launches.items() if n},
                   "streams_equal": True},
        "card": card}), flush=True)
    return launches


def gemma_dense(params, cfg, dev, card) -> dict:
    """gemma_dense: greedy `serving.gemma_generate` on GEMMA_DENSE_BATCH
    prompts of GEMMA_DENSE_PROMPT tokens, MAX_NEW new tokens, the counts
    set to 0 just before and read just after and held exact: a layer's
    prefill one `flash_fwd`, a decode step one `flash_decode` (a local
    layer's window as kv_starts), every one on the Hopper kernels with
    the soft cap at head_dim 256.  Returns the launch counts."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    prompt = torch.randint(0, cfg.vocab_size,
                           (GEMMA_DENSE_BATCH, GEMMA_DENSE_PROMPT),
                           generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize(dev)
    reset_attention_counts()
    t0 = time.perf_counter()
    out = serving.gemma_generate(params, prompt, cfg,
                                 max_new_tokens=MAX_NEW)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = gemma_launches()
    decodes = cfg.n_layers * (MAX_NEW - 1)
    expected = {**{f"flash_fwd{s}": cfg.n_layers
                   for s in GEMMA_KERNEL_SUFFIXES},
                **{f"flash_decode{s}": decodes for s in GEMMA_KERNEL_SUFFIXES}}
    wrong = launch_errors(launches, expected)
    if wrong:
        fail(f"gemma_dense launched (count, expected) {wrong}")
    new = out[:, GEMMA_DENSE_PROMPT:]
    if out.shape != (GEMMA_DENSE_BATCH, GEMMA_DENSE_PROMPT + MAX_NEW) or \
            not ((new >= 0) & (new < cfg.vocab_size)).all():
        fail(f"gemma_generate returned {tuple(out.shape)} or a token "
             "outside the vocabulary")
    tokens = GEMMA_DENSE_BATCH * MAX_NEW
    print("gemma_dense: " + json.dumps({
        "config": f"gemma2_2b, {cfg.n_layers} layers (full depth), bf16",
        "batch": GEMMA_DENSE_BATCH, "prompt": GEMMA_DENSE_PROMPT,
        "new_tokens": tokens, "seconds": secs,
        "new_tokens_per_s": tokens / secs,
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "launches": {k: n for k, n in launches.items() if n},
        "card": card}), flush=True)
    return launches


def gemma_reference(params, cfg, dev) -> dict:
    """gemma_reference: on a GEMMA_REF_LAYERS-layer cut (one local layer,
    one global) with a GEMMA_REF_PROMPT-token prompt, the logits of the
    paged path (chunk steps, then 2 decode steps) and of the dense path
    (`gemma_prefill`, then 2 `gemma_decode_step`s) against
    `gemma.forward_hidden` with `dispatch.attention` replaced by
    `attention_reference` (float32 softmax, the same soft cap and
    window), at REF_REL_RMS and REF_MAX_ABS."""
    import torch
    from metal_flash_attention_tpu_torch import dispatch
    from metal_flash_attention_tpu_torch.models import gemma, serving
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )

    cut = dict(params, layers=params["layers"][:GEMMA_REF_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=GEMMA_REF_LAYERS)
    n, steps = GEMMA_REF_PROMPT, 2
    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    tokens = torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                           device=dev)
    # Paged: the prompt in PAGE-token chunks, then decode steps.
    cache = serving.init_paged_model_cache(ccfg, 1, n + steps,
                                           page_size=PAGE, device=dev)
    for i in range(0, n, PAGE):
        chunk_logits, cache = serving.gemma_paged_chunk_step(
            cut, tokens[:, i:i + PAGE], ccfg, cache)
    paged = [chunk_logits[0]]
    tok = chunk_logits[:, -1].argmax(-1).to(torch.int32)
    fed = [tok]
    for _ in range(steps):
        logits, cache = serving.gemma_paged_decode_step(cut, tok, ccfg,
                                                        cache)
        paged.append(logits)
        tok = logits.argmax(-1).to(torch.int32)
        fed.append(tok)
    # Dense: prefill, then the same tokens fed.
    dcache = serving.init_cache(ccfg, 1, n + steps, device=dev)
    logits, dcache = serving.gemma_prefill(cut, tokens, ccfg, dcache)
    dense = [logits]
    for t in fed[:steps]:
        logits, dcache = serving.gemma_decode_step(cut, t, ccfg, dcache)
        dense.append(logits)

    def reference_attention(q, k, v, *, causal, window_size, scale,
                            logit_softcap, **_):
        return attention_reference(q, k, v, causal=causal,
                                   window_size=window_size, scale=scale,
                                   logit_softcap=logit_softcap).to(q.dtype)
    everything = torch.cat([tokens, torch.stack(fed[:steps], dim=1)], dim=1)
    with planted(dispatch, "attention", lambda _: reference_attention):
        hidden, _ = gemma.forward_hidden(cut, everything, ccfg)
    chunk = chunk_logits.shape[1]
    ref = gemma.lm_head(cut, hidden[0, n - chunk:], ccfg)
    readings = {}
    for name, got, want in (
            ("paged_chunk", paged[0], ref[:chunk]),
            ("paged_decode", torch.stack(paged[1:])[:, 0], ref[chunk:]),
            ("dense_prefill", dense[0][0], ref[chunk - 1]),
            ("dense_decode", torch.stack(dense[1:])[:, 0], ref[chunk:])):
        if not torch.isfinite(got).all():
            fail(f"gemma_reference: {name} gave non-finite logits")
        err = got.float() - want.float()
        readings[name] = {
            "rel_rms": float(err.pow(2).mean().sqrt()
                             / want.float().pow(2).mean().sqrt()),
            "max_abs_err": float(err.abs().max())}
    bad = {k: r for k, r in readings.items()
           if r["rel_rms"] > REF_REL_RMS or r["max_abs_err"] > REF_MAX_ABS}
    print("gemma_reference: " + json.dumps({
        "cut": f"{GEMMA_REF_LAYERS} layers (local, global), {n}-token "
               f"prompt, {steps} decode steps", "readings": readings,
        "limits": {"rel_rms": REF_REL_RMS, "max_abs": REF_MAX_ABS}}),
        flush=True)
    if bad:
        fail(f"the Gemma paths disagree with the reference: {bad}")
    return readings


def flex_yardstick(q, k, v, *, window, cap, scale, do=None, keys=None):
    """`flex_attention` with a tanh score_mod and a causal (and window)
    mask_mod, compiled: one PyTorch call computing the kernels' function,
    timed as a yardstick and never called by the port; with ``keys``
    ((starts, lengths), int tensors [batch]), each sequence's keys from
    its start to its length instead, as a decode sees them; with ``do``,
    its backward instead (`torch.autograd.grad` of one graph, kept,
    against ``do``: dq, dk, dv; the forward outside the timed call).
    Returns (fn, None) or (None, the reason it is not timed)."""
    import torch

    try:
        from torch.nn.attention.flex_attention import (
            create_block_mask,
            flex_attention,
        )
        offset = k.shape[-2] - q.shape[-2]

        def score_mod(s, b, h, qi, ki):
            return cap * torch.tanh(s / cap)

        def mask_mod(b, h, qi, ki):
            if keys is not None:
                return (ki >= keys[0][b]) & (ki < keys[1][b])
            live = ki <= qi + offset
            if window is not None:
                live = live & (ki > qi + offset - window)
            return live
        mask = create_block_mask(
            mask_mod, None if keys is None else q.shape[0], None,
            q.shape[-2], k.shape[-2], device=q.device)
        flex = torch.compile(flex_attention, dynamic=False)
        if do is None:
            fn = lambda: flex(q, k, v, score_mod=score_mod,  # noqa: E731
                              block_mask=mask, scale=scale, enable_gqa=True)
        else:
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flex(*leaves, score_mod=score_mod, block_mask=mask,
                       scale=scale, enable_gqa=True)
            fn = lambda: torch.autograd.grad(  # noqa: E731
                out, leaves, do, retain_graph=True)
        fn()
        torch.cuda.synchronize()
        return fn, None
    except Exception as e:  # a yardstick only: its failure is reported
        return None, (f"flex_attention did not run here: "
                      f"{type(e).__name__}: {str(e)[:300]}")


def gemma_kernel_checks(cfg, dev, card, serve_launches, dense_launches
                        ) -> list[dict]:
    """gemma_kernel_checks: each kernel at the Gemma shapes the phases
    ran (the serve's decode and last chunk, the dense prefill and decode)
    against its plain version by the worst tile (KERNEL_TILE_REL_RMS; a
    decode row, or TILE_ROWS query rows of a head), lse at MIXED_TOL, at
    the model's cap (50) and at a saturating one (GEMMA_SAT_CAP over
    queries scaled by GEMMA_SAT_GAIN), on a local layer (the 4,096
    window) and a global one; two planted faults the limit must see (the
    kernel without its cap against the capped plain version at the
    saturating cap; a local layer's window dropped).  Then each kernel's
    time (median, min-max of GEMM_REPEATS profiled loops) on a global
    layer at the model's cap, its plain version's, its bound, and
    `flex_attention`'s where it compiles."""
    import torch
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    kvh, qh, d = cfg.n_kv_heads, cfg.n_heads, cfg.head_dim
    scale, cap, window = (cfg.attn_scale, cfg.attn_logit_softcap,
                          cfg.sliding_window)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def paged_pools(lengths):
        max_pages = -(-max(lengths) // PAGE)
        num_pages = len(lengths) * max_pages + 1
        perm = torch.randperm(num_pages - 1, generator=gen,
                              device=dev).to(torch.int32) + 1
        return pa.PagedKVCache(
            randn(num_pages, kvh, PAGE, d), randn(num_pages, kvh, PAGE, d),
            perm.reshape(len(lengths), max_pages),
            torch.tensor(lengths, dtype=torch.int32, device=dev))

    dec_lens = [n + MAX_NEW for n in GEMMA_PROMPT_LENS[-MAX_BATCH:]]
    dec_cache = paged_pools(dec_lens)
    qd = randn(MAX_BATCH, qh, d)
    pre_cache = paged_pools([GEMMA_PROMPT_LENS[-1]])
    qp = randn(1, qh, PAGE, d)
    dense_k = randn(GEMMA_DENSE_BATCH, kvh, GEMMA_DENSE_PROMPT + MAX_NEW, d)
    dense_v = randn(GEMMA_DENSE_BATCH, kvh, GEMMA_DENSE_PROMPT + MAX_NEW, d)
    dense_lens = torch.full((GEMMA_DENSE_BATCH,), GEMMA_DENSE_PROMPT + 1,
                            dtype=torch.int32, device=dev)
    qdd = randn(GEMMA_DENSE_BATCH, qh, d)
    qf = randn(GEMMA_DENSE_BATCH, qh, GEMMA_DENSE_PROMPT, d)
    kf, vf = (x[:, :, :GEMMA_DENSE_PROMPT].contiguous()
              for x in (dense_k, dense_v))

    def starts_for(lens, win):
        return None if win is None else (lens - win).clamp_min(0)

    # Each kernel: (kernel call, plain call), both (q, cap, window) ->
    # (o, lse), and how a tile of its output is cut.
    def paged_dec(q, c, w, kernel_cap=None, plain=False):
        if plain:
            o, lse = pa._paged_attention_plain(
                q[:, :, None], dec_cache, scale=scale, window_size=w,
                softcap=c)
            return o[:, :, 0], lse[:, :, 0]
        return pa.paged_decode(q, dec_cache, scale=scale, window_size=w,
                               logit_softcap=c, return_residuals=True)

    def paged_pre(q, c, w, plain=False):
        if plain:
            return pa._paged_attention_plain(q, pre_cache, scale=scale,
                                             window_size=w, softcap=c)
        return pa.paged_prefill(q, pre_cache, scale=scale, window_size=w,
                                logit_softcap=c, return_residuals=True)

    def dense_dec(q, c, w, plain=False):
        starts = starts_for(dense_lens, w)
        if plain:
            return fd._flash_decode_plain(
                q, dense_k, dense_v, kv_lens=dense_lens, kv_starts=starts,
                max_span=None, scale=scale, softcap=c)
        return fd.flash_decode(q, dense_k, dense_v, kv_lens=dense_lens,
                               kv_starts=starts, scale=scale,
                               logit_softcap=c, return_residuals=True)

    def fwd(q, c, w, plain=False):
        if plain:
            outs = [fa._forward_plain(q[b:b + 1], kf[b:b + 1], vf[b:b + 1],
                                      causal=True, window_size=w,
                                      scale=scale, out_dtype=torch.float32,
                                      softcap=c) for b in range(q.shape[0])]
            return (torch.cat([o for o, _ in outs]),
                    torch.cat([lse for _, lse in outs]))
        return fa.flash_attention_forward(q, kf, vf, causal=True,
                                          window_size=w, scale=scale,
                                          logit_softcap=c)

    cases = {
        "paged_decode": (paged_dec, qd, 1, "csrc/paged_attention.cu",
                         "metal_flash_attention_tpu/ops/paged_attention.py:"
                         "183", serve_launches,
                         f"q [{MAX_BATCH}, {qh}, {d}], lengths {dec_lens}"),
        "paged_prefill": (paged_pre, qp, TILE_ROWS,
                          "csrc/paged_attention.cu",
                          "metal_flash_attention_tpu/ops/"
                          "paged_attention.py:183", serve_launches,
                          f"q [1, {qh}, {PAGE}, {d}] at length "
                          f"{GEMMA_PROMPT_LENS[-1]}"),
        "flash_decode": (dense_dec, qdd, 1, "csrc/flash_decode.cu",
                         "metal_flash_attention_tpu/ops/flash_decode.py:82",
                         dense_launches,
                         f"q [{GEMMA_DENSE_BATCH}, {qh}, {d}], K/V "
                         f"[{GEMMA_DENSE_BATCH}, {kvh}, "
                         f"{GEMMA_DENSE_PROMPT + MAX_NEW}, {d}] at "
                         f"length {GEMMA_DENSE_PROMPT + 1}"),
        "flash_fwd": (fwd, qf, TILE_ROWS, "csrc/flash_attention.cu",
                      "metal_flash_attention_tpu/ops/flash_attention.py:223",
                      dense_launches,
                      f"q [{GEMMA_DENSE_BATCH}, {qh}, {GEMMA_DENSE_PROMPT}, "
                      f"{d}] causal"),
    }
    results = []
    for name, (fn, q, rows, source, replaces, launches, shape) in \
            cases.items():
        readings, lse_err = {}, 0.0
        sat_q = (q.float() * GEMMA_SAT_GAIN).to(q.dtype)
        for label, qq, c, w in (
                ("global_cap50", q, cap, None),
                ("local_cap50", q, cap, window),
                ("global_saturating", sat_q, GEMMA_SAT_CAP, None),
                ("local_saturating", sat_q, GEMMA_SAT_CAP, window)):
            o, lse = fn(qq, c, w)
            po, plse = fn(qq, c, w, plain=True)
            readings[label] = closeness(o, po, tile_rows=rows)
            lse_err = max(lse_err, max_abs_err(lse, plse))
            del o, po
        # Planted faults: the kernel without its cap at the saturating
        # cap; a local layer's window dropped.
        po, _ = fn(sat_q, GEMMA_SAT_CAP, None, plain=True)
        faults = {"no_softcap": closeness(fn(sat_q, None, None)[0], po,
                                          tile_rows=rows)}
        po, _ = fn(q, cap, window, plain=True)
        faults["no_window"] = closeness(fn(q, cap, None)[0], po,
                                        tile_rows=rows)
        del po
        worst = max(r["tile_rel_rms"] for r in readings.values())
        if worst > KERNEL_TILE_REL_RMS or lse_err > MIXED_TOL.lse:
            fail(f"gemma {name} disagrees with its plain version: "
                 f"{readings}, lse {lse_err}")
        seen = [k for k, r in faults.items() if within_limits(r)]
        if seen:
            fail(f"the gemma {name} check does not see {seen}")
        spread = timed_spread(lambda: fn(q, cap, None), 20)
        plain_ms, _ = timed(lambda: fn(q, cap, None, plain=True), 3)
        if name == "flash_fwd":
            pairs = GEMMA_DENSE_BATCH * visible_pairs(
                GEMMA_DENSE_PROMPT, GEMMA_DENSE_PROMPT, True, None)
            kv_bytes = nbytes(kf, vf)
            io = 2 * nbytes(q) + q[..., 0].numel() * 4
        elif name == "flash_decode":
            pairs = int(dense_lens.sum())
            kv_bytes = pairs * kvh * d * 2 * 2
            io = 2 * nbytes(q) + q[..., 0].numel() * 4
        else:
            c = dec_cache if name == "paged_decode" else pre_cache
            chunk = 1 if q.dim() == 3 else q.shape[2]
            lengths = c.lengths.tolist()
            pairs = sum(visible_pairs(chunk, m, True, None)
                        for m in lengths)
            kv_bytes = sum(lengths) * kvh * d * 2 * 2
            io = 2 * nbytes(q) + q[..., 0].numel() * 4
        bound_ms, bound_by = bound(4 * d * qh * pairs, kv_bytes + io)
        library_ms, library_note = None, None
        if name in ("flash_fwd", "flash_decode"):
            q4 = q if q.dim() == 4 else q[:, :, None]
            k4, v4 = (kf, vf) if name == "flash_fwd" else (
                dense_k[:, :, :GEMMA_DENSE_PROMPT + 1],
                dense_v[:, :, :GEMMA_DENSE_PROMPT + 1])
            flex, library_note = flex_yardstick(q4, k4, v4, window=None,
                                                cap=cap, scale=scale)
            if flex is not None:
                library_ms = timed_spread(flex, 20)["ms"]
        else:
            library_note = "none: no one PyTorch call gathers pages and " \
                           "attends"
        results.append({
            "name": f"{name}_gemma", "route": "cuda",
            "source": f"metal_flash_attention_tpu_torch/{source}",
            "replaces": replaces,
            "launches": launches[name],
            "launches_softcap_d256": launches[f"{name}_d256"],
            "max_abs_err": max(r["max_abs_err"] for r in readings.values()),
            "o": readings, "planted_faults": faults,
            "lse_max_abs_err": lse_err,
            "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                       "lse_abs": MIXED_TOL.lse},
            "ms": spread["ms"], "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library": library_note or "flex_attention (tanh score_mod, "
                                       "causal block mask), compiled",
            "share_of_bound": bound_ms / spread["ms"], "spread": spread,
            "timed": f"global layer, cap {cap}", "shape": shape,
            "card": card})
        print(f"gemma_checks: {name}: " + json.dumps(results[-1]),
              flush=True)
    return results


GEMMA_TRAIN_FAMILIES = {"flash_fwd": "flash_fwd90_kernel",
                        "flash_bwd_dq": "flash_bwd_dq90_kernel",
                        "flash_bwd_dkv": "flash_bwd_dkv90_kernel"}


@contextlib.contextmanager
def fused_ce_annotated():
    """The fused cross-entropy's forward and backward each inside a
    `record_function("fused_ce")` range, so that `profile_step` can count
    the card's kernels of the loss as a family of their own."""
    from torch.profiler import record_function
    from metal_flash_attention_tpu_torch.models import losses

    def annotated(fn):
        def run(*args):
            with record_function("fused_ce"):
                return fn(*args)
        return run
    ce = losses._FusedCrossEntropy
    with planted(ce, "forward", annotated), \
            planted(ce, "backward", annotated):
        yield


def gemma_train(dev, card):
    """gemma_train: GEMMA_TRAIN_STEPS `gemma.train_step`s (SGD at
    GEMMA_TRAIN_LR over `gemma.loss_fn`, the fused cross-entropy with the
    final cap) of gemma2_2b at full width and depth, bf16, on one sequence
    of GEMMA_TRAIN_TOKENS + 1 tokens, no remat (the activations fit: 240
    KB a token a layer, 51 GB), the flash launch counts set to 0 just
    before and read just after and held exact (a layer's forward one
    `flash_fwd`, its backward one `flash_bwd_dq` and one `flash_bwd_dkv`,
    every one also on `_sm90`, `_softcap` and `_d256`); the loss finite
    and falling.  Then one more step under torch.profiler.  Returns (the
    trained parameters, the config, the launch counts)."""
    import torch
    from metal_flash_attention_tpu_torch.models import gemma
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    cfg = gemma.GemmaConfig.gemma2_2b()
    params = gemma.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    tokens = torch.randint(0, cfg.vocab_size, (1, GEMMA_TRAIN_TOKENS + 1),
                           generator=gen, device=dev)
    torch.cuda.synchronize(dev)
    param_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)

    fa.reset_launch_counts()
    fb.reset_launch_counts()
    losses, seconds = [], []
    with CardSampler() as sampler:
        for _ in range(GEMMA_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, loss = gemma.train_step(params, tokens, cfg,
                                            lr=GEMMA_TRAIN_LR)
            losses.append(float(loss))
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
        clocks = sampler.stop()
    launches = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {f"{kernel}{s}": cfg.n_layers * GEMMA_TRAIN_STEPS
                for kernel in GEMMA_TRAIN_FAMILIES
                for s in GEMMA_KERNEL_SUFFIXES}
    wrong = launch_errors(launches, expected)
    if wrong:
        fail(f"gemma_train launched (count, expected) {wrong}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite Gemma training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the Gemma training loss did not fall: {losses}")
    steady = seconds[1:]
    print("gemma_train: " + json.dumps({
        "config": f"gemma2_2b, {cfg.n_layers} layers (full depth), bf16, "
                  f"SGD lr {GEMMA_TRAIN_LR}, no remat",
        "tokens_per_step": GEMMA_TRAIN_TOKENS, "steps": GEMMA_TRAIN_STEPS,
        "losses": losses, "seconds_per_step": seconds,
        "tokens_per_s": GEMMA_TRAIN_TOKENS * len(steady) / sum(steady),
        "launches": {k: n for k, n in launches.items() if n},
        "param_bytes": param_bytes, "max_memory_allocated": peak,
        "card": card, "card_during_steps": clocks}), flush=True)
    with fused_ce_annotated():
        profile_step("gemma_train_profile", lambda: gemma.train_step(
            params, tokens, cfg, lr=GEMMA_TRAIN_LR), GEMMA_TRAIN_FAMILIES,
            dev, spans=("fused_ce",))
    return params, cfg, launches


def dq_without_cap_factor(dq):
    """flash_bwd_dq with dS missing the cap's chain factor 1 - t^2 (a
    plain float32 dQ, one kv head at a time, in the kernel's place) where
    a cap is given."""
    import torch
    from metal_flash_attention_tpu_torch.ops.reference import _probabilities

    def run(q, k, v, do, lse, d_term, *, causal, window_size, scale,
            softcap=None, **kw):
        if softcap is None:
            return dq(q, k, v, do, lse, d_term, causal=causal,
                      window_size=window_size, scale=scale, softcap=None,
                      **kw)
        out = torch.empty_like(q)
        group = q.shape[1] // k.shape[1]
        for j in range(k.shape[1]):
            g = slice(j * group, (j + 1) * group)
            kj, vj = k[:, j:j + 1].float(), v[:, j:j + 1].float()
            p, _ = _probabilities(q[:, g], kj, causal=causal,
                                  window_size=window_size, scale=scale,
                                  logit_softcap=softcap)
            dp = do[:, g].float() @ vj.transpose(-1, -2)
            ds = p * (dp - d_term[:, g, :, None]) * scale
            out[:, g] = (ds @ kj).to(q.dtype)
        return out
    return run


def window_dropped(dkv):
    """flash_bwd_dkv without the local layers' window (the forward and
    dQ keep it)."""
    def run(q, k, v, do, lse, d_term, *, window_size, **kw):
        return dkv(q, k, v, do, lse, d_term, window_size=None, **kw)
    return run


def saturating(params, cfg):
    """The cut with queries GEMMA_SAT_GAIN times larger (wq scaled) and
    the attention cap at GEMMA_SAT_CAP, where the tanh saturates and
    1 - t^2 is far from 1."""
    layers = [dict(layer, wq=(layer["wq"].float() * GEMMA_SAT_GAIN).to(
        layer["wq"].dtype)) for layer in params["layers"]]
    return (dict(params, layers=layers),
            dataclasses.replace(cfg, attn_logit_softcap=GEMMA_SAT_CAP))


def gemma_train_reference(params, cfg, dev) -> dict:
    """gemma_train_reference: on a GEMMA_REF_LAYERS-layer cut of the
    trained weights (layer 0 local, layer 1 global) at GEMMA_REF_PROMPT
    tokens, the loss and every gradient of `gemma.loss_fn` (the kernels,
    the fused cross-entropy) against `gemma.loss_fn(fused_ce=False)` with
    `dispatch.attention` replaced by `attention_reference` (float32, the
    same cap and window) under autograd, at the model's cap and at a
    saturating one (GEMMA_SAT_CAP over queries x GEMMA_SAT_GAIN), within
    TRAIN_LOSS_ABS and TRAIN_GRAD_REL_RMS; and two faults planted in the
    kernel path, each of which the limits must see: dQ without the cap's
    1 - t^2 (read at both caps; at 50 the factor is near 1 for seeded
    weights, so only the saturating reading must see it) and dK/dV
    without the local layer's window."""
    import torch
    from metal_flash_attention_tpu_torch import dispatch
    from metal_flash_attention_tpu_torch.models import gemma
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    cut = dict(params, layers=params["layers"][:GEMMA_REF_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=GEMMA_REF_LAYERS)
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    tokens = torch.randint(0, cfg.vocab_size, (1, GEMMA_REF_PROMPT + 1),
                           generator=gen, device=dev)

    def reference_attention(q, k, v, *, causal, window_size, scale,
                            logit_softcap, **_):
        return attention_reference(q, k, v, causal=causal,
                                   window_size=window_size, scale=scale,
                                   logit_softcap=logit_softcap).to(q.dtype)

    def value_and_grads(p, c, plain=False):
        leaves, rebuild = flatten(p)
        work = [t.detach().requires_grad_(True) for t in leaves]
        if plain:
            with planted(dispatch, "attention",
                         lambda _: reference_attention):
                value = gemma.loss_fn(rebuild(work), tokens, c,
                                      fused_ce=False)
        else:
            value = gemma.loss_fn(rebuild(work), tokens, c)
        grads = torch.autograd.grad(value, work)
        return float(value.detach()), grads

    def reading(p, c, ref) -> dict:
        ref_loss, ref_grads = ref
        loss, grads = value_and_grads(p, c)
        rel = []
        for g, r in zip(grads, ref_grads):
            if not torch.isfinite(g).all():
                fail("non-finite gradient on the Gemma kernel path")
            g, r = g.float(), r.float()
            rel.append(float((g - r).pow(2).mean().sqrt()
                             / r.pow(2).mean().sqrt().clamp_min(1e-30)))
        return {"loss": loss, "loss_abs_err": abs(loss - ref_loss),
                "grad_rel_rms_max": max(rel),
                "grad_rel_rms_median": float(np.median(rel))}

    def seen(r: dict) -> bool:
        return (r["loss_abs_err"] > TRAIN_LOSS_ABS
                or r["grad_rel_rms_max"] > TRAIN_GRAD_REL_RMS)

    sat = saturating(cut, ccfg)
    out = {"cut": f"{GEMMA_REF_LAYERS} layers (local, global), "
                  f"{GEMMA_REF_PROMPT} tokens",
           "tol": {"loss_abs": TRAIN_LOSS_ABS,
                   "grad_rel_rms": TRAIN_GRAD_REL_RMS},
           "readings": {}, "planted_faults": {}}
    for label, (p, c) in (("cap50", (cut, ccfg)), ("saturating", sat)):
        ref = value_and_grads(p, c, plain=True)
        out["readings"][label] = dict(plain_loss=ref[0],
                                      **reading(p, c, ref))
        faults = [("dq_without_cap_factor", "_dq_cuda",
                   dq_without_cap_factor)]
        if label == "cap50":
            faults.append(("dkv_window_dropped", "_dkv_cuda",
                           window_dropped))
        for name, attr, make in faults:
            with planted(fb, attr, make):
                out["planted_faults"][f"{name}.{label}"] = reading(p, c, ref)
        del ref
        torch.cuda.empty_cache()
    print("gemma_train_reference: " + json.dumps(out), flush=True)
    bad = [k for k, r in out["readings"].items() if seen(r)]
    if bad:
        fail(f"the Gemma kernel path's loss or gradients disagree with the "
             f"plain-attention reference: {bad}")
    must_see = ("dq_without_cap_factor.saturating",
                "dkv_window_dropped.cap50")
    unseen = [k for k in must_see if not seen(out["planted_faults"][k])]
    if unseen:
        fail(f"the gemma_train_reference limits do not see the planted "
             f"faults {unseen}")
    return out


def gemma_bwd_checks(cfg, dev, card, train_launches) -> list[dict]:
    """Rows 4g and 5g: flash_bwd_dq and flash_bwd_dkv at the training
    shape (q [1, 8, GEMMA_TRAIN_TOKENS, 256], k/v [1, 4, .., 256],
    causal) against `_backward_plain` (one kv head at a time) by the worst
    TILE_ROWS-row tile (KERNEL_TILE_REL_RMS): a global layer and a local
    one (the 4,096 window) at the model's cap, and a global one at the
    saturating cap (GEMMA_SAT_CAP over queries x GEMMA_SAT_GAIN); a
    planted fault each that the limit must see (dQ without 1 - t^2 at the
    saturating cap; dK/dV without the window on the local layer).  Then
    each kernel's time on both layers at the model's cap (median, min-max
    of GEMM_REPEATS profiled loops), its bound, its plain version's time
    and `flex_attention`'s backward with the same tanh score_mod and
    block mask, compiled, where it runs."""
    import torch
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    gen = torch.Generator(device=dev).manual_seed(SEED + 26)
    qh, kvh, d, n = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, \
        GEMMA_TRAIN_TOKENS
    scale, cap, window = (cfg.attn_scale, cfg.attn_logit_softcap,
                          cfg.sliding_window)
    group = qh // kvh

    def randn(heads):
        return torch.randn((1, heads, n, d), generator=gen,
                           device=dev).to(torch.bfloat16)
    q, k, v, do = randn(qh), randn(kvh), randn(kvh), randn(qh)
    sat_q = (q.float() * GEMMA_SAT_GAIN).to(q.dtype)

    def operands(qq, c, w):
        o, lse = fa.flash_attention_forward(qq, k, v, causal=True,
                                            window_size=w, scale=scale,
                                            logit_softcap=c)
        return lse, (do.float() * o.float()).sum(dim=-1)

    def plain(qq, c, w):
        outs = [torch.empty(t.shape, dtype=torch.float32, device=dev)
                for t in (qq, k, v)]
        for j in range(kvh):
            g = slice(j * group, (j + 1) * group)
            parts = fb._backward_plain(
                qq[:, g], k[:, j:j + 1], v[:, j:j + 1], do[:, g],
                causal=True, window_size=w, scale=scale, softcap=c)
            outs[0][:, g] = parts[0]
            outs[1][:, j:j + 1], outs[2][:, j:j + 1] = parts[1:]
        return outs

    readings = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    faults = {}
    cases = (("global_cap50", q, cap, None), ("local_cap50", q, cap, window),
             ("global_saturating", sat_q, GEMMA_SAT_CAP, None))
    for label, qq, c, w in cases:
        lse, d_term = operands(qq, c, w)
        kw = dict(causal=True, window_size=w, scale=scale, softcap=c)
        dq = fb._dq_cuda(qq, k, v, do, lse, d_term, **kw)
        dk, dv = fb._dkv_cuda(qq, k, v, do, lse, d_term, **kw)
        rdq, rdk, rdv = plain(qq, c, w)
        readings["flash_bwd_dq"][label] = {"dq": closeness(dq, rdq)}
        readings["flash_bwd_dkv"][label] = {"dk": closeness(dk, rdk),
                                            "dv": closeness(dv, rdv)}
        if label == "global_saturating":
            faults["flash_bwd_dq"] = {"dq_without_cap_factor": closeness(
                dq_without_cap_factor(fb._dq_cuda)(
                    qq, k, v, do, lse, d_term, **kw), rdq)}
        if label == "local_cap50":
            fdk, fdv = window_dropped(fb._dkv_cuda)(qq, k, v, do, lse,
                                                    d_term, **kw)
            faults["flash_bwd_dkv"] = {"window_dropped": {
                "dk": closeness(fdk, rdk), "dv": closeness(fdv, rdv)}}
        del dq, dk, dv, rdq, rdk, rdv
        torch.cuda.empty_cache()
    problems = []
    for name, per_case in readings.items():
        for label, outs in per_case.items():
            for out, r in outs.items():
                if not within_limits(r):
                    problems.append(f"{name}.{out} ({label})")
    if within_limits(faults["flash_bwd_dq"]["dq_without_cap_factor"]):
        problems.append("unseen fault: dQ without 1 - t^2")
    if all(within_limits(r) for r in
           faults["flash_bwd_dkv"]["window_dropped"].values()):
        problems.append("unseen fault: dK/dV without the window")
    print("gemma_bwd_checks: " + json.dumps({
        "readings": readings, "planted_faults": faults,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS}}), flush=True)
    if problems:
        fail(f"gemma backward checks: {problems}")

    timings = {}
    for label, w in (("global", None), ("local", window)):
        lse, d_term = operands(q, cap, w)
        kw = dict(causal=True, window_size=w, scale=scale, softcap=cap)
        row = {
            "dq": timed_spread(lambda: fb._dq_cuda(
                q, k, v, do, lse, d_term, **kw), 10),
            "dkv": timed_spread(lambda: fb._dkv_cuda(
                q, k, v, do, lse, d_term, **kw), 10),
            "plain_ms": timed(lambda: plain(q, cap, w), 2)[0]}
        flex, note = flex_yardstick(q, k, v, window=w, cap=cap, scale=scale,
                                    do=do)
        row["library_ms"] = (timed_spread(flex, 10)["ms"]
                             if flex is not None else None)
        row["library_note"] = note
        pairs = qh * visible_pairs(n, n, True, w)
        io = nbytes(q, k, v, do, lse, d_term)
        row["dq_bound"] = bound(2 * d * 3 * pairs, io + nbytes(q))
        row["dkv_bound"] = bound(2 * d * 4 * pairs, io + nbytes(k, v))
        timings[label] = row
        del lse, d_term
    results = []
    src = "metal_flash_attention_tpu_torch/csrc/flash_attention_bwd.cu"
    jax_src = "metal_flash_attention_tpu/ops/flash_attention_bwd.py"
    for name, line, cap_lines in (
            ("flash_bwd_dq", 73, ":79, :156-159, :194-196"),
            ("flash_bwd_dkv", 226, ":232, :310-313, :359-360")):
        key = name[len("flash_bwd_"):]
        glob = timings["global"]
        bound_ms, bound_by = glob[f"{key}_bound"]
        results.append({
            "name": f"{name}_gemma", "route": "cuda", "source": src,
            "replaces": f"{jax_src}:{line} (logit_softcap {cap_lines}; "
                        "head_dim 256, :433)",
            "launches": train_launches[name],
            "launches_softcap_d256": train_launches[f"{name}_d256"],
            "max_abs_err": max(r["max_abs_err"]
                               for outs in readings[name].values()
                               for r in outs.values()),
            "readings": readings[name], "planted_faults": faults[name],
            "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS},
            "ms": glob[key]["ms"], "spread": glob[key],
            "plain_ms": glob["plain_ms"],
            "plain_computes": "dq, dk and dv together, one kv head at a "
                              "time",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / glob[key]["ms"],
            "library_ms": glob["library_ms"],
            "library": glob["library_note"] or
            "backward of flex_attention (tanh score_mod, causal block "
            "mask), compiled: dq, dk, dv",
            "local": {"ms": timings["local"][key]["ms"],
                      "spread": timings["local"][key],
                      "bound_ms": timings["local"][f"{key}_bound"][0],
                      "plain_ms": timings["local"]["plain_ms"],
                      "library_ms": timings["local"]["library_ms"]},
            "shape": f"q [1, {qh}, {n}, {d}], k/v [1, {kvh}, {n}, {d}] "
                     f"causal, cap {cap} (timed); local: window {window}",
            "card": card})
        print(f"gemma_bwd_checks: {name}: " + json.dumps(results[-1]),
              flush=True)
    return results


# The flash-attention options (slice 14) at Llama-3-8B's attention widths
# (32 q heads, 8 kv heads, head_dim 128, bf16): packed training documents
# by segment ids (OPT_DOCS, causal, one sequence), a padded batch through
# `compat.dot_product_attention` (OPT_PAD_LENS, causal), an ALiBi bias
# [1, 32, OPT_BIAS_N, OPT_BIAS_N] over batch OPT_BIAS_BATCH (causal, with
# dbias), and rectangular causal cross-attention (OPT_CROSS_T queries
# against OPT_CROSS_S keys, batch OPT_CROSS_BATCH) beside a user mask,
# through `compat` (the mask and mask2 path).  A repeated mask [2, 1, T, S]
# over that batch holds the b % R reading.
OPT_DOCS = (3072, 2048, 2048, 1024)
OPT_PAD_LENS = (4096, 3000, 2048, 517)
OPT_BIAS_N = 4096
OPT_BIAS_BATCH = 2
OPT_CROSS_T, OPT_CROSS_S, OPT_CROSS_BATCH = 1024, 4096, 4
OPT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def option_counts() -> dict:
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    return {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}


def reset_option_counts() -> None:
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    fa.reset_launch_counts()
    fb.reset_launch_counts()


def alibi_slopes(heads: int) -> np.ndarray:
    """ALiBi's head slopes, 2^(-8 (h + 1) / heads)."""
    return 2.0 ** (-8.0 * np.arange(1, heads + 1) / heads)


def option_cases(dev) -> dict:
    """The options' cases at Llama-3-8B's attention widths, seeded numpy
    inputs, each as the kernels take it: {name: dict(q, k, v, do,
    options (`check_options`'s), causal, and what `options_attention`
    calls)}."""
    import torch
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa

    rng = np.random.default_rng(SEED + 40)
    d = HEAD_DIM

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32), device=dev).to(torch.bfloat16)

    def qkv(b, n, m):
        return (t(b, Q_HEADS, n, d), t(b, KV_HEADS, m, d),
                t(b, KV_HEADS, m, d), t(b, Q_HEADS, n, d))

    cases = {}
    n = sum(OPT_DOCS)
    ids = np.repeat(np.arange(len(OPT_DOCS)), OPT_DOCS)[None].astype(
        np.int32)
    seg = torch.as_tensor(ids, device=dev)
    q, k, v, do = qkv(1, n, n)
    cases["packed"] = dict(q=q, k=k, v=v, do=do, causal=True, kw=dict(
        q_segment_ids=seg, kv_segment_ids=seg))

    b, n = len(OPT_PAD_LENS), max(OPT_PAD_LENS)
    lens = torch.as_tensor(OPT_PAD_LENS, dtype=torch.int32, device=dev)
    pos = torch.arange(n, device=dev)[None]
    pad = (pos >= lens[:, None]).to(torch.int32)
    q, k, v, do = qkv(b, n, n)
    cases["padded"] = dict(q=q, k=k, v=v, do=do, causal=True, lens=lens,
                           kw=dict(q_segment_ids=pad, kv_segment_ids=pad))

    n = OPT_BIAS_N
    i = torch.arange(n, device=dev, dtype=torch.float32)
    slopes = torch.as_tensor(alibi_slopes(Q_HEADS), dtype=torch.float32,
                             device=dev)
    bias = (-slopes[:, None, None] * (i[:, None] - i[None, :]).abs())[
        None].to(torch.bfloat16)
    q, k, v, do = qkv(OPT_BIAS_BATCH, n, n)
    cases["alibi"] = dict(q=q, k=k, v=v, do=do, causal=True,
                          kw=dict(bias=bias))

    tt, ss = OPT_CROSS_T, OPT_CROSS_S
    user = torch.as_tensor(rng.random((OPT_CROSS_BATCH, 1, tt, ss)) < 0.9,
                           device=dev)
    rows = torch.arange(tt, device=dev)[:, None]
    cols = torch.arange(ss, device=dev)[None, :]
    top_left = (cols <= rows)[None, None]
    q, k, v, do = qkv(OPT_CROSS_BATCH, tt, ss)
    cases["cross"] = dict(q=q, k=k, v=v, do=do, causal=False, user=user,
                          kw=dict(mask=user, mask2=top_left))
    # Two different masks repeated over the batch: b reads b % 2.
    rep = torch.as_tensor(rng.random((2, 1, tt, ss)) < 0.5, device=dev)
    cases["mask_repeat"] = dict(q=q, k=k, v=v, do=do, causal=False,
                                kw=dict(mask=rep))
    for case in cases.values():
        case["options"] = fa.check_options(case["q"], case["k"],
                                           **case["kw"])
    return cases


def options_attention(cases, dev, card) -> dict:
    """The options through the entry points a user calls, forward and
    backward under autograd, each call's launch counts set to 0 just
    before and read just after and held exact: one `flash_fwd`,
    `flash_bwd_dq` and `flash_bwd_dkv`, each also on `_sm90` and `_aux`,
    and nothing else.  (1) `flash_attention` over OPT_DOCS packed by
    segment ids, causal; (2) `compat.dot_product_attention` over a padded
    batch (BTNH, is_causal, lengths); (3) `flash_attention` with an ALiBi
    bias and its gradient; (4) `compat.dot_product_attention`, T against
    S, is_causal beside a user mask (the top-left mask in mask2); (5) (1)
    with ``low_precision_intermediates``.  Every output and gradient
    finite, of its shape.  Returns each call's launches."""
    import torch
    from metal_flash_attention_tpu_torch import compat
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa

    def grads_of(out, leaves, do):
        out.backward(do)
        return [x.grad for x in leaves]

    def packed(lpi=False):
        c = cases["packed"]
        leaves = [c[x].detach().requires_grad_(True) for x in "qkv"]
        o, lse = fa.flash_attention(*leaves, **c["kw"], causal=True,
                                    return_residuals=True,
                                    low_precision_intermediates=lpi)
        if lse.dtype != (torch.bfloat16 if lpi else torch.float32):
            fail(f"lse came back {lse.dtype}")
        return o, grads_of(o, leaves, c["do"])

    def padded():
        c = cases["padded"]
        leaves = [c[x].detach().transpose(1, 2).requires_grad_(True)
                  for x in "qkv"]
        o = compat.dot_product_attention(
            *leaves, is_causal=True, query_seq_lengths=c["lens"],
            key_value_seq_lengths=c["lens"])
        return o, grads_of(o, leaves, c["do"].transpose(1, 2))

    def alibi():
        c = cases["alibi"]
        leaves = [c[x].detach().requires_grad_(True) for x in "qkv"]
        bias = c["kw"]["bias"].detach().requires_grad_(True)
        o = fa.flash_attention(*leaves, bias=bias, causal=True)
        return o, grads_of(o, leaves + [bias], c["do"])

    def cross():
        c = cases["cross"]
        leaves = [c[x].detach().transpose(1, 2).requires_grad_(True)
                  for x in "qkv"]
        o = compat.dot_product_attention(*leaves, mask=c["user"],
                                         is_causal=True)
        return o, grads_of(o, leaves, c["do"].transpose(1, 2))

    calls = {"packed_segments": packed, "padded_compat": padded,
             "alibi_bias": alibi, "cross_compat": cross,
             "packed_low_precision": lambda: packed(True)}
    expected = {f"{k}{s}": 1 for k in OPT_KERNELS
                for s in ("", "_sm90", "_aux")}
    report, launches = {}, {}
    for name, call in calls.items():
        torch.cuda.synchronize(dev)
        reset_option_counts()
        t0 = time.perf_counter()
        o, grads = call()
        torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        launches[name] = option_counts()
        wrong = launch_errors(launches[name], expected)
        if wrong:
            fail(f"options_attention {name} launched (count, expected) "
                 f"{wrong}")
        if not torch.isfinite(o).all() or not all(
                g is not None and torch.isfinite(g).all() for g in grads):
            fail(f"options_attention {name}: a non-finite output or "
                 "gradient")
        report[name] = {"out_shape": list(o.shape),
                        "grad_shapes": [list(g.shape) for g in grads],
                        "seconds_fwd_bwd": secs,
                        "launches": {k: n for k, n in
                                     launches[name].items() if n}}
        del o, grads
        torch.cuda.empty_cache()
    print("options_attention: " + json.dumps({
        "config": "Llama-3-8B attention widths (32 q heads, 8 kv heads, "
                  "head_dim 128), bf16, seeded numpy inputs",
        "docs": OPT_DOCS, "padded_lengths": OPT_PAD_LENS,
        "alibi": f"bias [1, {Q_HEADS}, {OPT_BIAS_N}, {OPT_BIAS_N}] bf16 "
                 f"over batch {OPT_BIAS_BATCH}",
        "cross": f"T {OPT_CROSS_T} against S {OPT_CROSS_S}, batch "
                 f"{OPT_CROSS_BATCH}, user mask [{OPT_CROSS_BATCH}, 1, "
                 f"{OPT_CROSS_T}, {OPT_CROSS_S}]",
        "calls": report, "card": card}), flush=True)
    return launches


def option_heads(options, g, heads):
    """`options` for the q heads of slice g (mask and bias head dims
    tiled to `heads` first, as the kernels read them)."""
    from metal_flash_attention_tpu_torch.ops.reference import tile_heads

    def part(t):
        if t is None or t.shape[1] == 1:
            return t
        return tile_heads(t, t.shape[0], heads)[:, g]
    return dataclasses.replace(options, mask=part(options.mask),
                               mask2=part(options.mask2),
                               bias=part(options.bias))


def live_pairs(case) -> int:
    """The (batch, q head, query, key) pairs the case's masks, segment
    ids and causal rule leave: the work its data needs."""
    import torch
    from metal_flash_attention_tpu_torch.ops.reference import tile_heads

    q, k, opts = case["q"], case["k"], case["options"]
    b, heads, n = q.shape[:3]
    m = k.shape[2]
    rows = torch.arange(n, device=q.device)[:, None]
    cols = torch.arange(m, device=q.device)[None, :]
    total = 0
    for bi in range(b):
        live = torch.ones((1, 1, n, m), dtype=torch.bool, device=q.device)
        if case["causal"]:
            live = live & (cols <= rows + (m - n))
        if opts.q_segment_ids is not None:
            live = live & (opts.q_segment_ids[bi][:, None]
                           == opts.kv_segment_ids[bi][None, :])
        for mk in (opts.mask, opts.mask2):
            if mk is not None:
                live = live & (tile_heads(mk, b, heads)[bi:bi + 1] != 0)
        total += int(live.expand(1, heads, n, m).sum())
    return total


def options_checks(cases, dev, card, launches) -> list[dict]:
    """Each `_aux` kernel at the options' shapes against its plain
    version (one kv head at a time) by the worst TILE_ROWS-row tile
    (KERNEL_TILE_REL_RMS): o, lse (MIXED_TOL), dq, dk, dv and dbias; with
    three planted faults, one an operand family, that the limit must
    see: the repeated mask indexed by b // R instead of b % R, the
    segments dropped from dK/dV, the bias dropped from dQ's recomputed P.
    Then each kernel's time (median, min-max of GEMM_REPEATS profiled
    loops) at the packed, ALiBi and cross cases beside its bound (the
    options' bytes, the live pairs), the same kernel without the options,
    the plain version and one PyTorch call: `flex_attention` with a
    document mask_mod (packed), SDPA with the float (ALiBi) or bool
    (cross) attn_mask, each a yardstick that the port never calls."""
    import torch
    import torch.nn.functional as F
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    scale = HEAD_DIM ** -0.5
    group = Q_HEADS // KV_HEADS
    readings, faults, problems, lse_errs = {}, {}, [], {}

    def plain(case, options=None):
        """o, lse, dq, dk, dv and the full dbias (None without a bias)
        of the plain versions, one kv head at a time."""
        q, k, v, do = (case[x] for x in ("q", "k", "v", "do"))
        options = options or case["options"]
        out = [torch.empty(t.shape, dtype=torch.float32, device=dev)
               for t in (q, q[..., 0], q, k, v)]
        dbias = None
        if options.bias is not None:
            dbias = torch.empty((*q.shape[:3], k.shape[2]),
                                dtype=torch.float32, device=dev)
        kw = dict(causal=case["causal"], window_size=None, scale=scale,
                  softcap=None)
        for j in range(KV_HEADS):
            g, one = slice(j * group, (j + 1) * group), slice(j, j + 1)
            sub = option_heads(options, g, Q_HEADS)
            out[0][:, g], out[1][:, g] = fa._forward_plain(
                q[:, g], k[:, one], v[:, one], out_dtype=torch.float32,
                options=sub, **kw)
            dq, dk, dv, db = fb._backward_plain(
                q[:, g], k[:, one], v[:, one], do[:, g], options=sub,
                compute_dbias=True, **kw)
            out[2][:, g], out[3][:, one], out[4][:, one] = dq, dk, dv
            if dbias is not None:
                dbias[:, g] = db
        return (*out, dbias)

    def kernels(case, options=None, dbias=True):
        q, k, v, do = (case[x] for x in ("q", "k", "v", "do"))
        options = options or case["options"]
        kw = dict(causal=case["causal"], window_size=None, scale=scale,
                  options=options)
        o, lse = fa._forward_cuda(q, k, v, out_dtype=q.dtype, **kw)
        d_term = (do.float() * o.float()).sum(dim=-1)
        db = None
        if dbias and options.bias is not None:
            db = torch.zeros((*q.shape[:3], k.shape[2]),
                             dtype=torch.float32, device=dev)
        dq = fb._dq_cuda(q, k, v, do, lse, d_term, dbias=db, **kw)
        dk, dv = fb._dkv_cuda(q, k, v, do, lse, d_term, **kw)
        return o, lse, dq, dk, dv, db

    def read(name, got, ref):
        r = {key: closeness(a, b) for key, a, b in
             zip(("o", "dq", "dk", "dv", "dbias"),
                 (got[0], *got[2:]), (ref[0], *ref[2:]))
             if a is not None}
        readings[name] = r
        lse_errs[name] = max_abs_err(got[1], ref[1])
        for key, x in r.items():
            if not within_limits(x):
                problems.append(f"{name}.{key} disagrees with its plain "
                                "version")
        if lse_errs[name] > MIXED_TOL.lse or not torch.equal(
                torch.isinf(got[1]), torch.isinf(ref[1])):
            problems.append(f"{name}.lse disagrees: {lse_errs[name]}")

    for name in ("packed", "padded", "alibi", "cross", "mask_repeat"):
        case = cases[name]
        ref = plain(case)
        got = kernels(case)
        read(name, got, ref)
        if name == "mask_repeat":
            # Fault: the repeated mask read at b // R.
            blocked = case["options"].mask.repeat_interleave(
                case["q"].shape[0] // 2, dim=0)
            fo = fa._forward_cuda(
                case["q"], case["k"], case["v"], causal=False,
                window_size=None, scale=scale, out_dtype=torch.bfloat16,
                options=dataclasses.replace(case["options"], mask=blocked))
            faults["mask_b_div_r"] = {"o": closeness(fo[0], ref[0])}
        if name == "packed":
            # Fault: dK/dV without the segments.
            q, k, v, do = (case[x] for x in ("q", "k", "v", "do"))
            d_term = (do.float() * got[0].float()).sum(dim=-1)
            no_seg = dataclasses.replace(case["options"], q_segment_ids=None,
                                         kv_segment_ids=None)
            fk, fv = fb._dkv_cuda(q, k, v, do, got[1], d_term, causal=True,
                                  window_size=None, scale=scale,
                                  options=no_seg)
            faults["dkv_without_segments"] = {
                "dk": closeness(fk, ref[3]), "dv": closeness(fv, ref[4])}
        if name == "alibi":
            # Fault: dQ's recomputed P without the bias (the forward's lse
            # kept), and its dbias.
            q, k, v, do = (case[x] for x in ("q", "k", "v", "do"))
            d_term = (do.float() * got[0].float()).sum(dim=-1)
            fq = fb._dq_cuda(q, k, v, do, got[1], d_term, causal=True,
                             window_size=None, scale=scale, options=None)
            faults["dq_without_bias"] = {"dq": closeness(fq, ref[2])}
        del ref, got
        torch.cuda.empty_cache()
    for name, r in faults.items():
        if all(within_limits(x) for x in r.values()):
            problems.append(f"unseen fault: {name}")
    print("options_checks: " + json.dumps({
        "readings": readings, "lse_max_abs_err": lse_errs,
        "planted_faults": faults,
        "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                   "lse_abs": MIXED_TOL.lse}}), flush=True)
    if problems:
        fail("options checks: " + "; ".join(problems))

    def flex_documents(case):
        """`flex_attention` (compiled) with a causal document mask_mod:
        (forward fn, backward fn) or (None, None, the reason)."""
        try:
            from torch.nn.attention.flex_attention import (
                create_block_mask,
                flex_attention,
            )
            ids = case["options"].q_segment_ids[0]
            n = ids.shape[0]

            def mask_mod(b, h, qi, ki):
                return (ki <= qi) & (ids[qi] == ids[ki])
            block = create_block_mask(mask_mod, None, None, n, n,
                                      device=dev)
            flex = torch.compile(flex_attention, dynamic=False)
            q, k, v, do = (case[x] for x in ("q", "k", "v", "do"))
            fwd = lambda: flex(q, k, v, block_mask=block,  # noqa: E731
                               scale=scale, enable_gqa=True)
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            out = flex(*leaves, block_mask=block, scale=scale,
                       enable_gqa=True)
            bwd = lambda: torch.autograd.grad(  # noqa: E731
                out, leaves, do, retain_graph=True)
            fwd()
            bwd()
            torch.cuda.synchronize()
            return fwd, bwd, None
        except Exception as e:  # a yardstick only: its failure is reported
            return None, None, (f"flex_attention did not run here: "
                                f"{type(e).__name__}: {str(e)[:300]}")

    def sdpa(case):
        """SDPA with the case's attn_mask (ALiBi + causal as one float
        mask; the cross case's user AND top-left bool mask): (forward,
        backward of dq, dk, dv, note)."""
        q, k, v, do = (case[x] for x in ("q", "k", "v", "do"))
        opts = case["options"]
        if opts.bias is not None:
            n = q.shape[2]
            causal = torch.ones((n, n), dtype=torch.bool,
                                device=dev).tril()
            mask = opts.bias.masked_fill(~causal, float("-inf"))
            note = ("F.scaled_dot_product_attention with the ALiBi bias and "
                    "the causal mask as one float attn_mask [1, 32, N, N]")
        else:
            mask = (opts.mask != 0) & (opts.mask2 != 0)
            note = ("F.scaled_dot_product_attention with the user mask AND "
                    "the top-left causal mask as one bool attn_mask")
        fwd = lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, attn_mask=mask, scale=scale, enable_gqa=True)
        leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, attn_mask=mask,
                                             scale=scale, enable_gqa=True)
        bwd = lambda: torch.autograd.grad(  # noqa: E731
            out, leaves, do, retain_graph=True)
        return fwd, bwd, note

    timings = {}
    for name in ("packed", "alibi", "cross"):
        case = cases[name]
        q, k, v, do = (case[x] for x in ("q", "k", "v", "do"))
        opts = case["options"]
        kw = dict(causal=case["causal"], window_size=None, scale=scale)
        o, lse = fa._forward_cuda(q, k, v, out_dtype=q.dtype, options=opts,
                                  **kw)
        d_term = (do.float() * o.float()).sum(dim=-1)
        db = None
        if opts.bias is not None:
            db = torch.zeros((*q.shape[:3], k.shape[2]),
                             dtype=torch.float32, device=dev)
        row = {
            "fwd": timed_spread(lambda: fa._forward_cuda(
                q, k, v, out_dtype=q.dtype, options=opts, **kw), 10),
            "dq": timed_spread(lambda: fb._dq_cuda(
                q, k, v, do, lse, d_term, dbias=db, options=opts, **kw), 10),
            "dkv": timed_spread(lambda: fb._dkv_cuda(
                q, k, v, do, lse, d_term, options=opts, **kw), 10),
            # The same kernels without the options: causal, or (cross)
            # the full rectangle.
            "fwd_no_options": timed_spread(lambda: fa._forward_cuda(
                q, k, v, out_dtype=q.dtype, **kw), 10),
            "dq_no_options": timed_spread(lambda: fb._dq_cuda(
                q, k, v, do, lse, d_term, **kw), 10),
            "dkv_no_options": timed_spread(lambda: fb._dkv_cuda(
                q, k, v, do, lse, d_term, **kw), 10),
            "plain_ms": timed(lambda: plain(case), 1)[0]}
        if name == "packed":
            lib_fwd, lib_bwd, note = flex_documents(case)
            note = note or ("flex_attention with a causal document "
                            "mask_mod (block mask), compiled")
        else:
            try:
                lib_fwd, lib_bwd, note = sdpa(case)
            except Exception as e:  # a yardstick only: reported
                lib_fwd = lib_bwd = None
                note = (f"SDPA did not run here: {type(e).__name__}: "
                        f"{str(e)[:300]}")
        row["library_fwd_ms"] = (timed_spread(lib_fwd, 10)["ms"]
                                 if lib_fwd else None)
        row["library_bwd_ms"] = (timed_spread(lib_bwd, 10)["ms"]
                                 if lib_bwd else None)
        row["library"] = note
        pairs = live_pairs(case)
        aux_in = nbytes(*(t for t in (opts.mask, opts.mask2, opts.bias,
                                      opts.q_segment_ids,
                                      opts.kv_segment_ids)
                          if t is not None))
        io = nbytes(q, k, v, do, lse, d_term)
        row["live_pairs"] = pairs
        row["fwd_bound"] = bound(4 * HEAD_DIM * pairs,
                                 nbytes(q, k, v, o, lse) + aux_in)
        row["dq_bound"] = bound(2 * HEAD_DIM * 3 * pairs,
                                io + nbytes(q) + aux_in
                                + (nbytes(db) if db is not None else 0))
        row["dkv_bound"] = bound(2 * HEAD_DIM * 4 * pairs,
                                 io + nbytes(k, v) + aux_in)
        timings[name] = row
        del o, lse, d_term, db
        torch.cuda.empty_cache()

    src = "metal_flash_attention_tpu_torch/csrc/"
    jax_src = "metal_flash_attention_tpu/ops/"
    replaces = {
        "flash_fwd": jax_src + "flash_attention.py:223 (mask, mask2, bias "
                   ":274-278, :341-360, :447; segments :371-420; b % B "
                   "broadcast :1166-1215; the dynamic kernel's segments "
                   ":552, :619-620, :695-700)",
        "flash_bwd_dq": jax_src + "flash_attention_bwd.py:73 (options "
                      ":86-95, :125-135, :160-196; dbias :191-193, "
                      ":210-213, :562-611)",
        "flash_bwd_dkv": jax_src + "flash_attention_bwd.py:226 (options "
                       ":239-246, :282-290, :310-330)"}
    key_of = {"flash_fwd": "fwd", "flash_bwd_dq": "dq",
              "flash_bwd_dkv": "dkv"}
    results = []
    for kernel in OPT_KERNELS:
        key = key_of[kernel]
        head = timings["packed"]
        bound_ms, bound_by = head[f"{key}_bound"]
        lib_key = "library_fwd_ms" if key == "fwd" else "library_bwd_ms"
        outs = [r for case in readings.values() for out, r in case.items()
                if (out == "o") == (key == "fwd")
                and (key != "dq" or out in ("dq", "dbias"))
                and (key != "dkv" or out in ("dk", "dv"))]
        results.append({
            "name": f"{kernel}_aux", "route": "cuda",
            "source": src + ("flash_attention.cu" if key == "fwd"
                             else "flash_attention_bwd.cu"),
            "replaces": replaces[kernel],
            "launches": sum(c[f"{kernel}_aux"] for c in launches.values()),
            "launches_by_call": {name: c[f"{kernel}_aux"]
                                 for name, c in launches.items()},
            "max_abs_err": max(r["max_abs_err"] for r in outs),
            "worst_tile_rel_rms": max(r["tile_rel_rms"] for r in outs),
            "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS},
            "ms": head[key]["ms"], "spread": head[key],
            "no_options_ms": head[f"{key}_no_options"]["ms"],
            "plain_ms": head["plain_ms"],
            "plain_computes": "o, lse, dq, dk, dv (and dbias) together, "
                              "one kv head at a time",
            "bound_ms": bound_ms, "bound_by": bound_by,
            "share_of_bound": bound_ms / head[key]["ms"],
            "library_ms": head[lib_key],
            "library": head["library"] + (
                "" if key == "fwd" else ": its backward, dq, dk, dv"),
            "cases": {name: {
                "ms": row[key]["ms"], "spread": row[key],
                "no_options_ms": row[f"{key}_no_options"]["ms"],
                "bound_ms": row[f"{key}_bound"][0],
                "bound_by": row[f"{key}_bound"][1],
                "live_pairs": row["live_pairs"],
                "plain_ms": row["plain_ms"], "library_ms": row[lib_key],
                "library": row["library"]}
                for name, row in timings.items()},
            "shape": f"packed: q/k/v [1, 32 | 8, {sum(OPT_DOCS)}, 128] "
                     f"causal, documents {OPT_DOCS} (timed); alibi: "
                     f"[{OPT_BIAS_BATCH}, .., {OPT_BIAS_N}, 128] causal, "
                     f"bias [1, 32, {OPT_BIAS_N}, {OPT_BIAS_N}] bf16; "
                     f"cross: q [{OPT_CROSS_BATCH}, 32, {OPT_CROSS_T}, "
                     f"128], k/v [.., {OPT_CROSS_S}, 128], mask and mask2",
            "card": card})
        print(f"options_checks: {kernel}_aux: " + json.dumps(results[-1]),
              flush=True)
    return results


# The runtime (slice 15): sweeps of tile variants at Llama-3-8B's attention
# width (32 heads of 128, 8,192 tokens, bf16; q, k and v all 32 heads, as
# the JAX package's sweep makes them) and at layer 0's w_gate product
# (T = 8,192), the decode and paged chunk caps at the JAX package's
# defaults, and dispatch by the config cache.  Each sweep tries at most
# four candidates; every candidate's output is held to its plain version
# by `closeness` (KERNEL_TILE_REL_RMS; lse at MIXED_TOL) before its time
# counts, and a planted fault per family must fail that check.  Every
# variant library builds in the build phase, with the plain ones.
RT_HEADS, RT_TOKENS = 32, 8192
RT_FWD_TILES = ((128, 128), (64, 128), (128, 64), (64, 64))
RT_DQ_TILES = ((128, 128), (64, 128), (128, 64), (64, 64))
RT_DKV_TILE = (64, 128)
RT_GEMM = (8192, 14336, 4096)
RT_GEMM_TILES = {"bf16": ((128, 256), (256, 128), (128, 128)),
                 "int8": ((256, 128), (128, 256), (128, 128))}
RT_DECODE_CAPS = (512, 1024, 2048, 4096)
RT_PAGED_PAGES = (4, 8, 16, 32)
RT_ITERS = 10
# The tile a cached winner, an explicit request and an illegal request
# put on the card: a forward winner inserted at the dense prefill's
# shape (one sequence), then block_q / block_kv, then a GEMM tile, then
# requests the clamp moves.
RT_CACHED_TILE = (64, 128)
RT_REQUESTED_TILE = (64, 64)
RT_GEMM_REQUEST = (256, 128)
RT_ILLEGAL = {"flash_fwd": ((96, 300), (64, 128)),
              "gemm": ((512, 512), (128, 256))}


def runtime_variants() -> list:
    """(source, -D pairs) of every tile variant the runtime phase
    launches, built with the plain libraries."""
    from metal_flash_attention_tpu_torch.descriptors import parameters as P
    from metal_flash_attention_tpu_torch.descriptors.gemm_descriptor import (
        GEMMDescriptor,
    )
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )

    out = [("flash_attention", P.tile_library("forward", *t, HEAD_DIM))
           for t in RT_FWD_TILES]
    out += [("flash_attention_bwd",
             P.tile_library("backward_query", *t, HEAD_DIM))
            for t in RT_DQ_TILES]
    m, n, k = RT_GEMM
    for prec, tiles in RT_GEMM_TILES.items():
        desc = GEMMDescriptor(m=m, n=n, k=k,
                              precision_a=OperandPrecision.BF16,
                              precision_b=OperandPrecision(prec))
        out += [("gemm", desc.library("sm90", *t)) for t in tiles]
    return [v for v in dict.fromkeys(out) if v[1]]


def smoke_check(tile_cols=None):
    """The sweeps' check: `closeness` of every output (tile_rel_rms within
    KERNEL_TILE_REL_RMS; ``tile_cols`` columns a tile, None whole rows),
    lse by its max abs error within MIXED_TOL; the readings are kept."""
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )
    readings = []

    def check(got, ref):
        row = {}
        for name, t in got.items():
            if name == "lse":
                row[name] = {"max_abs_err": max_abs_err(t, ref[name])}
                ok = row[name]["max_abs_err"] <= MIXED_TOL.lse
            else:
                row[name] = closeness(t, ref[name], tile_cols=tile_cols)
                ok = within_limits(row[name])
            if not ok:
                readings.append(row)
                raise AssertionError(f"{name}: {row[name]}")
        readings.append(row)
        return row
    return check, readings


def dropped_rows(fn, pick):
    """``fn`` with the last TILE_ROWS rows of one head of the output that
    ``pick`` selects zeroed: a planted one-tile fault."""
    def run(*args, **kw):
        out = fn(*args, **kw)
        t = pick(out)
        t[..., -1, -TILE_ROWS:, :] = 0
        return out
    return run


def planted_sweep(label, sweep) -> dict:
    """Run ``sweep`` (a fault planted in it) and require its check to fail
    it; returns the reading."""
    try:
        sweep()
    except RuntimeError as e:
        if "failed its check" not in str(e):
            raise
        return {"fault": label, "seen": True,
                "message": str(e)[-300:]}
    fail(f"runtime: the sweep's check did not see the planted fault "
         f"({label})")


def runtime_phase(dev, card, cache_dir, build_seconds) -> list[dict]:
    """DeviceContext; the attention, GEMM, decode and paged sweeps with
    their planted faults; dispatch by a cached winner, an explicit tile
    and a clamped request, each shown by the launch counters' tiles; the
    CLI as a subprocess on a cache of its own.  Returns the kernels line's
    entries of the tile variants launched."""
    import torch
    import torch.nn.functional as F
    from metal_flash_attention_tpu_torch.descriptors import parameters as P
    from metal_flash_attention_tpu_torch.descriptors.gemm_descriptor import (
        GEMMDescriptor,
    )
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.ops.quantization import (
        quantize_matrix,
    )
    from metal_flash_attention_tpu_torch.runtime import autotune as at
    from metal_flash_attention_tpu_torch.runtime.cache import (
        KernelConfigCache,
    )
    from metal_flash_attention_tpu_torch.runtime.context import DeviceContext

    gm = gemm_module()
    t_phase = time.perf_counter()
    ctx = DeviceContext.get()
    info = ctx.info
    print("runtime_context: " + json.dumps({
        "kind": ctx.device_kind, "generation": ctx.generation,
        "sm_count": info.sm_count, "smem_per_block": info.smem_per_block,
        "l2_bytes": info.l2_bytes, "peak_bf16_flops": info.peak_bf16_flops,
        "hbm_bandwidth": info.hbm_bandwidth, "card": card}), flush=True)
    cache = KernelConfigCache.get()
    if os.path.dirname(cache.store_path) != cache_dir or \
            cache._native is not None:
        fail(f"runtime: the config cache is {cache.store_path}, not the "
             "run's private one")
    n, d, heads = RT_TOKENS, HEAD_DIM, RT_HEADS
    pairs = {causal: visible_pairs(n, n, causal, None) * heads
             for causal in (False, True)}
    io = 4 * heads * n * d * 2 + heads * n * 4
    src = "metal_flash_attention_tpu_torch/csrc/"
    jax_src = "metal_flash_attention_tpu/ops/"
    sweeps, entries, faults = {}, [], []
    # Launches by (kernel, tile) over the phase's sweeps and dispatches;
    # the planted sweeps' launches are dropped.
    modules = {"flash_fwd": fa, "flash_bwd_dq": fb, "flash_bwd_dkv": fb,
               "gemm": gm}
    counted = collections.Counter()

    def take(keep=True):
        for name, module in modules.items():
            if keep:
                for tile, count in module.LAUNCH_TILES[name].items():
                    counted[name, tuple(tile)] += count
        for module in set(modules.values()):
            module.reset_launch_counts()
    take(keep=False)

    # Attention: forward, forward causal, the backward pair.
    for label, kind, causal, cands in (
            ("forward", "forward", False, RT_FWD_TILES),
            ("forward_causal", "forward", True, RT_FWD_TILES),
            ("backward_query", "backward_query", False,
             tuple((t, RT_DKV_TILE) for t in RT_DQ_TILES))):
        check, readings = smoke_check()
        winner, results = at.autotune_attention(
            kernel_type=kind, n=n, head_dim=d, heads=heads,
            dtype=torch.bfloat16, causal=causal, candidates=cands,
            iters=RT_ITERS, repeats=3, check=check)
        p = pairs[causal]
        if kind == "forward":
            bound_ms, bound_by = bound(4 * d * p, io)
        else:
            # dQ's three products and dK/dV's four; q, k, v, dO, L and D
            # read once, dq, dk and dv written once.
            bound_ms, bound_by = bound(2 * d * 7 * p, io + heads * n * 4
                                       + 3 * heads * n * d * 2)
        rows = []
        for (c, secs), reading in zip(results.items(), readings):
            ms = secs * 1e3
            rows.append({"tile": c, "ms": ms, "share_of_bound":
                         bound_ms / ms, "reading": reading})
        sweeps[label] = {"winner": winner, "candidates": rows,
                         "default_ms": rows[0]["ms"], "bound_ms": bound_ms,
                         "bound_by": bound_by}
        print(f"runtime_sweep {label}: " + json.dumps(sweeps[label]),
              flush=True)

    take()
    # The planted faults the sweeps' checks must see.
    check, _ = smoke_check()
    with planted(fa, "_forward_cuda",
                 lambda f: dropped_rows(f, lambda out: out[0])):
        faults.append(planted_sweep("forward: last 64 rows of one head "
                                    "dropped", lambda: at.autotune_attention(
            kernel_type="forward", n=n, head_dim=d, heads=heads,
            candidates=(RT_FWD_TILES[1],), iters=1, repeats=1, check=check,
            cache=KernelConfigCache(os.path.join(cache_dir, "f.json")))))
    check, _ = smoke_check()
    with planted(fb, "_dq_cuda", lambda f: dropped_rows(f, lambda out: out)):
        faults.append(planted_sweep("backward: dQ's last 64 rows of one "
                                    "head dropped",
                                    lambda: at.autotune_attention(
            kernel_type="backward_query", n=n, head_dim=d, heads=heads,
            candidates=((RT_DQ_TILES[1], RT_DKV_TILE),), iters=1,
            repeats=1, check=check,
            cache=KernelConfigCache(os.path.join(cache_dir, "f.json")))))
    take(keep=False)

    # GEMM: layer 0's w_gate product, bf16 and an INT8 weight.
    m, gn, k = RT_GEMM
    gemm_flops = 2 * m * gn * k
    for prec, tiles in RT_GEMM_TILES.items():
        check, readings = smoke_check(tile_cols=GEMM_TILE[1])
        desc = GEMMDescriptor(m=m, n=gn, k=k,
                              precision_a=OperandPrecision.BF16,
                              precision_b=OperandPrecision(prec))
        if prec == "bf16":
            winner, results = at.autotune_gemm(
                m=m, n=gn, k=k, candidates=tiles, iters=RT_ITERS,
                repeats=3, check=check)
        else:
            winner, results = at.autotune_gemm_descriptor(
                desc, tiles, iters=RT_ITERS, repeats=3, check=check)
        b_bytes = k * gn * (2 if prec == "bf16" else 1) + 4 * gn
        bound_ms, bound_by = bound(gemm_flops, m * k * 2 + b_bytes
                                   + m * gn * 2)
        rows = [{"tile": c, "ms": s * 1e3, "share_of_bound":
                 bound_ms / (s * 1e3), "reading": r}
                for (c, s), r in zip(results.items(), readings)]
        sweeps[f"gemm_{prec}"] = {
            "winner": winner, "candidates": rows, "default_ms": rows[0]["ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "key":
            desc.cache_key()}
        print(f"runtime_sweep gemm_{prec}: "
              + json.dumps(sweeps[f"gemm_{prec}"]), flush=True)
    take()
    check, _ = smoke_check(tile_cols=GEMM_TILE[1])

    def lost_tile(f):
        def run(*args, **kw):
            out = f(*args, **kw)
            out[:, :TILE_ROWS, :GEMM_TILE[1]] = 0
            return out
        return run
    with planted(gm, "_gemm_cuda", lost_tile):
        faults.append(planted_sweep("gemm: one 64 x 128 output tile lost",
                                    lambda: at.autotune_gemm(
            m=m, n=gn, k=k, candidates=(RT_GEMM_TILES["bf16"][1],), iters=1,
            repeats=1, check=check,
            cache=KernelConfigCache(os.path.join(cache_dir, "f.json")))))
    take(keep=False)
    print("runtime_faults: " + json.dumps(faults), flush=True)

    # Decode and paged chunk caps (no rebuild), bf16 and INT8 caches.
    for prec in (None, OperandPrecision.INT8):
        tag = "bf16" if prec is None else prec.value
        for label, fn, cands in (("decode", at.autotune_decode,
                                  RT_DECODE_CAPS),
                                 ("paged", at.autotune_paged,
                                  RT_PAGED_PAGES)):
            check, readings = smoke_check()
            winner, results = fn(precision=prec, candidates=cands,
                                 iters=50, repeats=3, check=check)
            kv_bytes = 2 * 8 * 8 * 8192 * 128 * (2 if prec is None else 1)
            bound_ms, bound_by = bound(4 * 128 * 8192 * 8 * 32, kv_bytes)
            rows = [{"cap": c, "ms": s * 1e3, "share_of_bound":
                     bound_ms / (s * 1e3), "reading": r}
                    for (c, s), r in zip(results.items(), readings)]
            sweeps[f"{label}_{tag}"] = {"winner": winner, "candidates": rows,
                                        "bound_ms": bound_ms,
                                        "bound_by": bound_by}
            print(f"runtime_sweep {label}_{tag}: "
                  + json.dumps(sweeps[f"{label}_{tag}"]), flush=True)

    # Dispatch: a cached winner, an explicit tile, a GEMM tile, clamps.
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    q, k_, v = (torch.randn((1, h, DENSE_PROMPT, d), generator=gen,
                            device=dev).to(torch.bfloat16)
                for h in (Q_HEADS, KV_HEADS, KV_HEADS))
    ref_o, ref_lse = fa._forward_plain(q, k_, v, causal=True,
                                       window_size=None, scale=d ** -0.5,
                                       out_dtype=torch.bfloat16)
    cache.insert(cache.attention_key(
        "forward_causal", d, torch.bfloat16,
        q_len_bucket=1 << (DENSE_PROMPT - 1).bit_length()), RT_CACHED_TILE)
    dispatch = {}

    def launched(label, module, name, want, run):
        take()
        out = run()
        got = dict(module.LAUNCH_TILES[name])
        if got != {want: 1}:
            fail(f"runtime dispatch {label}: {name} launched {got}, not "
                 f"{want}")
        take()
        return out
    for label, kw, want in (
            ("cached winner", {}, RT_CACHED_TILE),
            ("block_q/block_kv", dict(zip(("block_q", "block_kv"),
                                          RT_REQUESTED_TILE)),
             RT_REQUESTED_TILE),
            ("illegal request", dict(zip(("block_q", "block_kv"),
                                         RT_ILLEGAL["flash_fwd"][0])),
             RT_ILLEGAL["flash_fwd"][1])):
        o, lse = launched(label, fa, "flash_fwd", want,
                          lambda kw=kw: fa.flash_attention(
                              q, k_, v, causal=True, return_residuals=True,
                              **kw))
        reading = closeness(o, ref_o)
        reading["lse_max_abs_err"] = float((lse - ref_lse).abs().max())
        dispatch[label] = {"tile": want, **reading}
        if not within_limits(reading):
            fail(f"runtime dispatch {label}: {reading}")
    del q, k_, v, ref_o, ref_lse
    a = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
    b = torch.randn((k, gn), generator=gen, device=dev).to(torch.bfloat16)
    ref = gm._gemm_plain(a, b)
    for label, req, want in (
            ("block_m/block_n", RT_GEMM_REQUEST, RT_GEMM_REQUEST),
            ("gemm illegal request", RT_ILLEGAL["gemm"][0],
             RT_ILLEGAL["gemm"][1])):
        out = launched(label, gm, "gemm", (*want, 64),
                       lambda req=req: gm.gemm(a, b, block_m=req[0],
                                               block_n=req[1]))
        reading = closeness(out, ref, tile_cols=GEMM_TILE[1])
        dispatch[label] = {"tile": want, **reading}
        if not within_limits(reading):
            fail(f"runtime dispatch {label}: {reading}")
    del a, b, ref
    print("runtime_dispatch: " + json.dumps(dispatch), flush=True)

    # The CLI, on a cache of its own.
    cli_dir = os.path.join(cache_dir, "cli")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "metal_flash_attention_tpu_torch.runtime",
         "autotune", "--kernel", "forward", "--head-dims", "128", "--seq",
         "4096"], capture_output=True, text=True, timeout=600,
        env=dict(os.environ, MFA_TORCH_CACHE_DIR=cli_dir))
    if proc.returncode != 0:
        fail(f"runtime CLI exited {proc.returncode}:\n{proc.stderr[-2000:]}")
    with open(os.path.join(cli_dir, "autotune.json")) as f:
        stored = json.load(f)
    key = KernelConfigCache.attention_key("forward", d, torch.bfloat16,
                                          q_len_bucket=4096)
    if key not in stored:
        fail(f"runtime CLI stored {sorted(stored)}, not {key}")
    print("runtime_cli: " + json.dumps({
        "seconds": time.perf_counter() - t0, "stored": stored,
        "winner_line": [x for x in proc.stdout.splitlines()
                        if "winner" in x]}), flush=True)

    # The kernels line: each tile variant the phase launched, with the
    # plain versions' times (one call between CUDA events).
    def event_ms(fn):
        fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    x = torch.randn((1, heads, n, d), device=dev).to(torch.bfloat16)
    plain = {
        "forward": event_ms(lambda: at._plain_attention(
            "forward", x, x, x, None, False)),
        "backward_query": event_ms(lambda: at._plain_attention(
            "backward", x, x, x, x, False)),
        "library_forward": timed_spread(
            lambda: F.scaled_dot_product_attention(x, x, x),
            RT_ITERS)["ms"]}
    leaves = [x.clone().requires_grad_(True) for _ in range(3)]
    sdpa_o = F.scaled_dot_product_attention(*leaves)
    plain["library_backward_query"] = timed_spread(
        lambda: torch.autograd.grad(sdpa_o, leaves, x, retain_graph=True),
        RT_ITERS)["ms"]
    del x, leaves, sdpa_o
    a = torch.randn((m, k), device=dev).to(torch.bfloat16)
    b = torch.randn((k, gn), device=dev)
    bq = quantize_matrix(b, OperandPrecision.INT8, contract_axis=0,
                         per_channel=True)
    b = b.to(torch.bfloat16)
    plain["gemm_bf16"] = event_ms(lambda: gm._gemm_plain(a, b))
    plain["gemm_int8"] = event_ms(lambda: gm._gemm_plain(a, bq))
    plain["library_gemm"] = timed_spread(lambda: a @ b, RT_ITERS)["ms"]
    del a, b, bq
    for label, name, kind, source, replaces in (
            ("forward", "flash_fwd", "forward", "flash_attention.cu",
             "flash_attention.py:223"),
            ("backward_query", "flash_bwd_dq", "backward_query",
             "flash_attention_bwd.cu", "flash_attention_bwd.py:73")):
        for row in sweeps[label]["candidates"][1:]:
            tile = tuple(row["tile"][0] if kind != "forward"
                         else row["tile"])
            entries.append({
                "name": f"{name}_tile_{tile[0]}x{tile[1]}", "route": "cuda",
                "source": src + source, "replaces": jax_src + replaces,
                "variant": P.tile_library(kind, *tile, d),
                "launches": counted[name, tile],
                "max_abs_err": max(r["max_abs_err"]
                                   for r in row["reading"].values()),
                "ms": row["ms"], "plain_ms": plain[kind],
                "bound_ms": sweeps[label]["bound_ms"],
                "bound_by": sweeps[label]["bound_by"],
                "library_ms": plain[f"library_{kind}"],
                "default_tile_ms": sweeps[label]["default_ms"],
                "shape": f"q/k/v [1, {heads}, {n}, {d}] bf16, not causal"
                         + ("" if kind == "forward" else
                            f"; the pair with dK/dV at {RT_DKV_TILE}, "
                            "beside SDPA's backward")})
    for prec in RT_GEMM_TILES:
        for row in sweeps[f"gemm_{prec}"]["candidates"][1:]:
            tile = tuple(row["tile"])
            entries.append({
                "name": f"gemm_{prec}_tile_{tile[0]}x{tile[1]}",
                "route": "cuda", "source": src + "gemm.cu",
                "replaces": jax_src + "gemm.py:112",
                "variant": GEMMDescriptor(
                    m=m, n=gn, k=k, precision_a=OperandPrecision.BF16,
                    precision_b=OperandPrecision(prec)).library("sm90",
                                                                *tile),
                "launches": counted["gemm", (*tile, GEMM_K_STEP)],
                "max_abs_err": max(r["max_abs_err"]
                                   for r in row["reading"].values()),
                "ms": row["ms"],
                "plain_ms": plain[f"gemm_{prec}"],
                "bound_ms": sweeps[f"gemm_{prec}"]["bound_ms"],
                "bound_by": sweeps[f"gemm_{prec}"]["bound_by"],
                "library_ms": plain["library_gemm"]
                if prec == "bf16" else None,
                "default_tile_ms": sweeps[f"gemm_{prec}"]["default_ms"],
                "shape": f"[{m}, {k}] x [{k}, {gn}], B {prec}"})
    for entry in entries:
        if entry["launches"] == 0:
            fail(f"runtime: {entry['name']} was never launched")
    print("runtime_launches: " + json.dumps(
        {f"{name} {tile}": c for (name, tile), c in counted.items()}),
        flush=True)
    print("runtime: " + json.dumps({
        "seconds": time.perf_counter() - t_phase,
        "build_seconds": build_seconds,
        "variants": len(runtime_variants()), "card": card}), flush=True)
    return entries


# ---------------------------------------------------------------------------
# Weights in and out, and LoRA: HF conversion, token shards, checkpoints,
# multi-adapter fine-tuning and serving
# ---------------------------------------------------------------------------

# Llama-3.1's rope scaling, as its HF config gives it.
LLAMA31_ROPE = {"rope_type": "llama3", "factor": 8.0,
                "low_freq_factor": 1.0, "high_freq_factor": 4.0,
                "original_max_position_embeddings": 8192}
CONVERT_FAULT_LAYER = 17
HF_PROJECTIONS = {"wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
                  "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
                  "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
                  "w_down": "mlp.down_proj"}
HF_NORMS = {"attn_norm": "input_layernorm",
            "mlp_norm": "post_attention_layernorm",
            "pre_attn_norm": "input_layernorm",
            "post_attn_norm": "post_attention_layernorm",
            "pre_mlp_norm": "pre_feedforward_layernorm",
            "post_mlp_norm": "post_feedforward_layernorm"}
# LoRA fine-tuning on the frozen full-depth base: 4 adapters of rank 16
# on wq/wk/wv/wo, rows of adapters 1 and 2, 2 x 2,048 tokens a step from
# two shards of a repeated 512-token random phrase (learnable by
# copying), AdamW; a checkpoint after step 2 and a resume from it.
LORA_ADAPTERS = 4
LORA_RANK = 16
LORA_BATCH = 2
LORA_SEQ = 2048
LORA_STEPS = 4
LORA_SAVE_AFTER = 2
LORA_IDS = (1, 2)
# At 1e-2 the loss fell once and then rose (10.88, 10.14, 10.87, 11.12 on
# the H100): the first Adam step moves every entry of B by the rate.
LORA_LR = 1e-3
LORA_PHRASE = 512
LORA_SHARDS = ((40, np.uint16), (25, np.int32))   # repeats, token dtype
LORA_REF_LAYERS = 2
# Serving: the trained stack with adapter 3 drawn at LORA_B_SCALE (B of
# the untrained adapter 3 is still 0), one adapter a request.
LORA_B_SCALE = 0.05
LORA_SERVE_IDS = (0, 1, 2, 3, 1, 0)


def hf_state_dict(params) -> dict:
    """The port's parameters as an HF checkpoint holds them: HF's names,
    projections [out, in], bf16 (norm gains too), on the host, as
    `torch.load` of a checkpoint gives them."""
    import torch

    def host(t):
        return t.to(torch.bfloat16).cpu()
    sd = {"model.embed_tokens.weight": host(params["embed"]),
          "model.norm.weight": host(params["final_norm"])}
    for i, layer in enumerate(params["layers"]):
        for key, t in layer.items():
            if key in HF_PROJECTIONS:
                sd[f"model.layers.{i}.{HF_PROJECTIONS[key]}.weight"] = host(
                    t.t().contiguous())
            else:
                sd[f"model.layers.{i}.{HF_NORMS[key]}.weight"] = host(t)
    if "lm_head" in params:
        sd["lm_head.weight"] = host(params["lm_head"].t().contiguous())
    return sd


def hf_config(cfg, family):
    """A plain object with HF's config field names for ``cfg``."""
    from types import SimpleNamespace

    common = dict(vocab_size=cfg.vocab_size, hidden_size=cfg.dim,
                  num_hidden_layers=cfg.n_layers,
                  num_attention_heads=cfg.n_heads,
                  num_key_value_heads=cfg.n_kv_heads,
                  intermediate_size=cfg.hidden_dim,
                  rope_theta=cfg.rope_theta, rms_norm_eps=cfg.norm_eps)
    if family == "llama":
        return SimpleNamespace(**common, rope_scaling=LLAMA31_ROPE,
                               sliding_window=None)
    return SimpleNamespace(
        **common, head_dim=cfg.head_dim, sliding_window=cfg.sliding_window,
        attn_logit_softcapping=cfg.attn_logit_softcap,
        final_logit_softcapping=cfg.final_logit_softcap,
        query_pre_attn_scalar=cfg.head_dim)


def bit_mismatches(got, want) -> list:
    """The paths of the leaves of ``got`` that are not ``want``'s bit for
    bit (shape, dtype and every byte)."""
    import torch
    from metal_flash_attention_tpu_torch.utils.tree import flatten, leaf_paths

    ref = dict(zip(leaf_paths(want), flatten(want)[0]))
    bad = []
    for key, a in zip(leaf_paths(got), flatten(got)[0]):
        b = ref.pop(key, None)
        if (b is None or a.shape != b.shape or a.dtype != b.dtype
                or not torch.equal(a.contiguous().view(torch.uint8),
                                   b.contiguous().view(torch.uint8))):
            bad.append(key)
    return bad + sorted(ref)


def convert_check(params, cfg, family, dev, card) -> dict:
    """`models.convert` at full width and depth: the port's weights
    written out as an HF checkpoint in host memory, converted back onto
    the card, and held bit for bit to the source; a planted fault (one
    layer's wk and wv swapped in the checkpoint) must show."""
    import torch
    from metal_flash_attention_tpu_torch.models import convert

    t0 = time.perf_counter()
    sd = hf_state_dict(params)
    export_s = time.perf_counter() - t0
    checkpoint_bytes = nbytes(*sd.values())
    hcfg = hf_config(cfg, family)
    if family == "llama":
        ccfg = convert.config_from_hf_llama(hcfg)
        to_params = convert.params_from_hf_llama
        same_cfg = (dataclasses.replace(
            ccfg, rope_scaling_factor=None) == cfg
            and ccfg.rope_scaling_factor == LLAMA31_ROPE["factor"]
            and ccfg.rope_original_max_position == 8192)
    else:
        ccfg = convert.config_from_hf_gemma2(hcfg)
        to_params = convert.params_from_hf_gemma2
        same_cfg = (dataclasses.replace(ccfg, query_pre_attn_scalar=None)
                    == cfg and ccfg.attn_scale == cfg.attn_scale)
    if not same_cfg:
        fail(f"convert: the {family} config came back as {ccfg}")

    def run(state_dict):
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        out = to_params(state_dict, ccfg, device=dev)
        torch.cuda.synchronize(dev)
        return (out, time.perf_counter() - t0,
                torch.cuda.max_memory_allocated(dev) - base,
                torch.cuda.memory_allocated(dev) - base)

    converted, seconds, peak, held = run(sd)
    bad = bit_mismatches(converted, params)
    del converted
    torch.cuda.empty_cache()
    faulty = dict(sd)
    pre = f"model.layers.{CONVERT_FAULT_LAYER}.self_attn."
    faulty[pre + "k_proj.weight"], faulty[pre + "v_proj.weight"] = (
        sd[pre + "v_proj.weight"], sd[pre + "k_proj.weight"])
    converted, *_ = run(faulty)
    fault_bad = bit_mismatches(converted, params)
    del converted, faulty, sd
    torch.cuda.empty_cache()
    out = {"family": family, "layers": cfg.n_layers,
           "checkpoint": "HF names, [out, in], bf16, host memory",
           "checkpoint_bytes": checkpoint_bytes,
           "export_seconds": export_s, "seconds": seconds,
           "peak_device_bytes_above_base": peak,
           "converted_bytes": held, "mismatched_leaves": bad,
           "planted_fault": {"swapped": f"layers/{CONVERT_FAULT_LAYER}/wk "
                                        "with wv",
                             "mismatched_leaves": fault_bad},
           "card": card}
    print("convert: " + json.dumps(out), flush=True)
    if bad:
        fail(f"convert: {family} leaves not bit-equal: {bad[:8]}")
    want = {f"layers/{CONVERT_FAULT_LAYER}/wk",
            f"layers/{CONVERT_FAULT_LAYER}/wv"}
    if set(fault_bad) != want:
        fail(f"convert: the planted fault read {fault_bad}, not {want}")
    return out


def lora_shards(directory, vocab) -> list:
    """Two token shards of one repeated random phrase, of different sizes
    and dtypes, written by `utils.data.write_shard`."""
    from metal_flash_attention_tpu_torch.utils import data

    phrase = np.random.default_rng(SEED + 20).integers(0, vocab,
                                                       LORA_PHRASE)
    paths = []
    for i, (repeats, dtype) in enumerate(LORA_SHARDS):
        path = os.path.join(directory, f"shard{i}.bin")
        data.write_shard(path, np.tile(phrase, repeats).astype(dtype))
        paths.append(path)
    return paths


def fresh_adapters(cfg, dev, b_scale=0.0, seed=SEED + 21):
    import torch
    from metal_flash_attention_tpu_torch.models import lora

    return lora.init_lora_adapters(
        cfg, LORA_ADAPTERS, LORA_RANK, b_scale=b_scale, device=dev,
        generator=torch.Generator(device=dev).manual_seed(seed))


def lora_optimizer(tensors):
    import torch
    return torch.optim.AdamW(tensors, lr=LORA_LR, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


ATTENTION_COUNTS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def lora_train(params, cfg, dev, card, workdir):
    """LoRA fine-tuning at full depth on the frozen base, fed by the
    TokenLoader, checkpointed after LORA_SAVE_AFTER steps and resumed;
    returns the trained adapters, the loader's shards and the launch
    counts of one step."""
    import torch
    from metal_flash_attention_tpu_torch.models import lora
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
    from metal_flash_attention_tpu_torch.utils import checkpoint, data
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    paths = lora_shards(workdir, cfg.vocab_size)
    ckpt_dir = os.path.join(workdir, "lora_ckpt")
    ids = torch.tensor(LORA_IDS, dtype=torch.int32, device=dev)
    init_fn, step_fn = lora.make_lora_train_step(cfg, lora_optimizer)
    adapters = fresh_adapters(cfg, dev)
    state = init_fn(adapters)
    loader = data.TokenLoader(paths, LORA_BATCH, LORA_SEQ, seed=SEED,
                              device=dev)
    batches = iter(loader)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    unused = {k for k in (*fa.LAUNCH_COUNTS, *fb.LAUNCH_COUNTS)
              if not any(k in (n, n + "_sm90") for n in ATTENTION_COUNTS)}
    losses, seconds, launches = [], [], []
    with CardSampler() as sampler:
        for step in range(1, LORA_STEPS + 1):
            tokens = next(batches)
            fa.reset_launch_counts()
            fb.reset_launch_counts()
            t0 = time.perf_counter()
            adapters, state, loss = step_fn(adapters, state, params, tokens,
                                            ids)
            losses.append(float(loss))
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
            launches.append({k: n for k, n in {**fa.LAUNCH_COUNTS,
                                               **fb.LAUNCH_COUNTS}.items()
                             if n})
            if step == LORA_SAVE_AFTER:
                t0 = time.perf_counter()
                checkpoint.save(ckpt_dir, {"adapters": adapters,
                                           "state": state,
                                           "loader": loader.state()},
                                step=step)
                save_s = time.perf_counter() - t0
        clocks = sampler.stop()
    peak = torch.cuda.max_memory_allocated(dev)
    for step, counts in enumerate(launches, start=1):
        want = {f"{n}{s}": cfg.n_layers for n in ATTENTION_COUNTS
                for s in ("", "_sm90")}
        if counts != want or any(counts.get(k) for k in unused):
            fail(f"lora_train step {step} launched {counts}, expected "
                 f"{want}")
    base_grads = [p for p in flatten(params)[0]
                  if p.grad is not None or p.requires_grad]
    if base_grads:
        fail(f"lora_train: {len(base_grads)} base tensors carry a gradient")
    # Rows of adapters 0 and 3 took no part: Adam's first moment of every
    # adapter tensor is exactly zero there, and not in rows 1 and 2.
    opt = state["opt"]
    rows = {"unused_rows_zero": True, "used_rows_nonzero": 0}
    for p in state["shadow"]:
        m = opt.state[p]["exp_avg"]
        rows["unused_rows_zero"] &= bool(not m[0].any() and not m[3].any())
        rows["used_rows_nonzero"] += int(bool(m[1].any() and m[2].any()))
    if not rows["unused_rows_zero"] or rows["used_rows_nonzero"] != len(
            state["shadow"]):
        fail(f"lora_train: adapter gradients by row {rows}")
    if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
        fail(f"lora_train: losses not finite and falling: {losses}")

    # Resume: fresh adapters and optimizer, restored from the file of
    # step LORA_SAVE_AFTER, then the remaining steps again.
    final = [t.clone() for t in flatten(adapters)[0]
             if isinstance(t, torch.Tensor)]
    del state
    torch.cuda.empty_cache()
    again = fresh_adapters(cfg, dev)
    state2 = init_fn(again)
    t0 = time.perf_counter()
    out = checkpoint.restore(checkpoint.latest(ckpt_dir),
                             {"adapters": again, "state": state2,
                              "loader": (0, 0)})
    restore_s = time.perf_counter() - t0
    again, state2 = out["adapters"], out["state"]
    batches2 = iter(data.TokenLoader.from_state(
        paths, LORA_BATCH, LORA_SEQ, out["loader"], device=dev))
    resumed = []
    for _ in range(LORA_SAVE_AFTER, LORA_STEPS):
        again, state2, loss = step_fn(again, state2, params, next(batches2),
                                      ids)
        resumed.append(float(loss))
    got = [t for t in flatten(again)[0] if isinstance(t, torch.Tensor)]
    gap = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, final))
    identical = (resumed == losses[LORA_SAVE_AFTER:]
                 and all(torch.equal(a, b) for a, b in zip(got, final)))
    profile = lora_train_profile(step_fn, again, state2, params,
                                 next(batches2), ids, dev)
    del again, state2, final, got
    torch.cuda.empty_cache()
    steady = seconds[1:]
    reading = {
        "config": f"llama3_8b, {cfg.n_layers} layers (full depth), frozen "
                  "bf16 base",
        "adapters": LORA_ADAPTERS, "rank": LORA_RANK,
        "projections": ["wq", "wk", "wv", "wo"],
        "lora_ids": list(LORA_IDS), "batch": [LORA_BATCH, LORA_SEQ],
        "optimizer": f"AdamW lr {LORA_LR}, master weights",
        "data": f"TokenLoader over {len(paths)} shards "
                f"({[r for r, _ in LORA_SHARDS]} repeats of a "
                f"{LORA_PHRASE}-token phrase, uint16 and int32)",
        "losses": losses, "seconds_per_step": seconds,
        "tokens_per_s": LORA_BATCH * LORA_SEQ * len(steady) / sum(steady),
        "max_memory_allocated": peak, "launches_per_step": launches[0],
        "rows": rows, "checkpoint_seconds": save_s,
        "restore_seconds": restore_s, "resumed_losses": resumed,
        "resumed_bit_identical": identical, "resumed_max_abs_gap": gap,
        "card": card, "card_during_steps": clocks,
        "profile": profile}
    print("lora_train: " + json.dumps(reading), flush=True)
    if not identical:
        fail(f"lora_train: the resumed run is not bit-identical (losses "
             f"{resumed} against {losses[LORA_SAVE_AFTER:]}, adapters "
             f"{gap} apart)")
    return adapters, launches[0], paths


def lora_train_profile(step_fn, adapters, state, params, tokens, ids,
                       dev) -> dict:
    """Where a LoRA step's device time goes: one more step under
    torch.profiler (attention kernels, the forward deltas' products in
    `lora_delta` ranges, cuBLAS, the rest), and the delta products of
    every layer, forward and backward, timed alone."""
    import torch
    from metal_flash_attention_tpu_torch.models import lora

    def annotated(apply):
        def run(*args):
            with torch.profiler.record_function("lora_delta"):
                return apply(*args)
        return run
    with planted(lora, "apply_lora", annotated):
        reading = profile_step(
            "lora_train_profile",
            lambda: step_fn(adapters, state, params, tokens, ids),
            {"flash_fwd": "flash_fwd90_kernel",
             "flash_bwd_dq": "flash_bwd_dq90_kernel",
             "flash_bwd_dkv": "flash_bwd_dkv90_kernel",
             "optimizer": "multi_tensor"}, dev, spans=("lora_delta",))
    b, s = tokens.shape[0], tokens.shape[1] - 1
    layer = adapters["layers"][0]
    g = torch.Generator(device=dev).manual_seed(SEED + 22)
    inputs = {name: torch.randn((b, s, a.shape[1]), generator=g, device=dev,
                                dtype=a.dtype).requires_grad_(True)
              for name, (a, _) in layer.items()}

    def products():
        for name, (a, bb) in layer.items():
            a_ = a.detach().requires_grad_(True)
            b_ = bb.detach().requires_grad_(True)
            y = lora.apply_lora(inputs[name], (a_, b_), ids)
            torch.autograd.grad(y, (inputs[name], a_, b_),
                                torch.ones_like(y))
    device_ms, _ = timed(products, 5)
    n_layers = len(adapters["layers"])
    return {"step_device_ms": reading["device_ms"],
            "busy_share": reading["busy_share"],
            "by_family_ms": reading["device_ms_by_family"],
            "lora_products_fwd_bwd_ms_alone": device_ms * n_layers,
            "lora_products_note": "the 4 deltas of one layer, forward and "
                                  "backward (with the ones cotangent), "
                                  f"timed alone x {n_layers} layers"}


def plain_lora_loss(params, tokens, cfg, lora_tree, ids):
    """Mean next-token cross-entropy through `plain_hidden` (the plain
    attention) with the LoRA deltas."""
    import torch

    x = plain_hidden(params, tokens[:, :-1], cfg, lora_tree, ids)
    logp = torch.log_softmax((x @ params["lm_head"]).float(), dim=-1)
    return -logp.gather(-1, tokens[:, 1:, None].long()).mean()


def lora_train_reference(params, cfg, adapters, tokens, dev) -> dict:
    """The LoRA loss and every adapter gradient of the kernel path against
    the plain-attention path on a 2-layer cut, with the trained adapters;
    two planted faults (the wo delta dropped; each row given its
    neighbour's adapter) must read above the limits."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    cut = dict(params, layers=params["layers"][:LORA_REF_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=LORA_REF_LAYERS)
    layers = adapters["layers"][:LORA_REF_LAYERS]
    rank = adapters["rank"]
    ids = torch.tensor(LORA_IDS, dtype=torch.int32, device=dev)

    def value_and_grads(loss_fn):
        leaves, rebuild = flatten(layers)
        work = [t.detach().requires_grad_(True) for t in leaves]
        value = loss_fn({"rank": rank, "layers": rebuild(work)})
        # A fault may cut a leaf out of the graph: its gradient is zero.
        grads = torch.autograd.grad(value, work, allow_unused=True)
        return float(value.detach()), [
            torch.zeros_like(w) if g is None else g
            for w, g in zip(work, grads)]

    ref_loss, ref_grads = value_and_grads(
        lambda tree: plain_lora_loss(cut, tokens, ccfg, tree, ids))

    def reading(row_ids) -> dict:
        loss, grads = value_and_grads(lambda tree: llama.loss_fn(
            cut, tokens, ccfg, lora=tree, lora_ids=row_ids))
        rel = []
        for g, r in zip(grads, ref_grads):
            if not torch.isfinite(g).all():
                fail("lora_train_reference: a non-finite gradient")
            g, r = g.float(), r.float()
            rel.append(float((g - r).pow(2).mean().sqrt()
                             / r.pow(2).mean().sqrt().clamp_min(1e-30)))
        return {"loss": loss, "loss_abs_err": abs(loss - ref_loss),
                "grad_rel_rms_max": max(rel),
                "grad_rel_rms_median": float(np.median(rel))}

    def seen(r: dict) -> bool:
        return (r["loss_abs_err"] > TRAIN_LOSS_ABS
                or r["grad_rel_rms_max"] > TRAIN_GRAD_REL_RMS)

    def no_wo_delta(wo_proj):
        def run(o, layer, lora_layer=None, lora_ids=None):
            return wo_proj(o, layer)
        return run

    out = {"layers": LORA_REF_LAYERS, "tokens": list(tokens.shape),
           "plain_loss": ref_loss, **reading(ids),
           "tol": {"loss_abs": TRAIN_LOSS_ABS,
                   "grad_rel_rms": TRAIN_GRAD_REL_RMS}}
    with planted(llama, "wo_proj", no_wo_delta):
        faults = {"wo_delta_dropped": reading(ids)}
    faults["neighbour_adapter"] = reading(ids.flip(0))
    out["planted_faults"] = faults
    print("lora_train_reference: " + json.dumps(out), flush=True)
    if seen(out):
        fail("lora_train_reference: the LoRA loss or gradients disagree "
             "with the plain-attention path")
    for name, r in faults.items():
        if not seen(r):
            fail(f"lora_train_reference: the limits do not see the planted "
                 f"fault {name}")
    return out


def serving_stack(adapters, cfg, dev) -> dict:
    """The trained stack with adapter 3 (untrained: B = 0) replaced by a
    random one drawn at LORA_B_SCALE."""
    drawn = fresh_adapters(cfg, dev, b_scale=LORA_B_SCALE, seed=SEED + 23)
    layers = []
    for trained, rand in zip(adapters["layers"], drawn["layers"]):
        layer = {}
        for name, (a, b) in trained.items():
            a, b = a.clone(), b.clone()
            a[3], b[3] = rand[name][0][3], rand[name][1][3]
            layer[name] = (a, b)
        layers.append(layer)
    return {"rank": adapters["rank"], "layers": layers}


def lora_engine_run(params, cfg, prompts, lora_ids, dev, lora=None,
                    forced=None, fault=False, max_seq=None):
    """The engine (max_batch MAX_BATCH, page PAGE, ``max_seq`` or the
    prompts' longest span) over ``prompts`` with one adapter each; every
    step's logits kept by (request, token index).
    ``forced``: {(request, index): token} replaces the engine's choice
    (teacher forcing); ``fault``: the slot of adapter 3 handed its
    neighbour slot's adapter in every decode step.  Returns streams,
    logits, seconds and the step calls."""
    import torch
    from metal_flash_attention_tpu_torch import ServingEngine
    from metal_flash_attention_tpu_torch.models import serving

    max_seq = max_seq or max(map(len, prompts)) + MAX_NEW + 1
    eng = ServingEngine(params, cfg, max_batch=MAX_BATCH,
                        num_pages=MAX_BATCH * -(-max_seq // PAGE) + 1,
                        page_size=PAGE, max_seq=max_seq, lora=lora)
    logits_by = {}
    pick = eng._pick

    def kept(logits, bias, reqs, idxs):
        toks, lps = pick(logits, bias, reqs, idxs)
        for j, (r, i) in enumerate(zip(reqs, idxs)):
            if r is not None:
                logits_by[(r.rid, i)] = logits[j].float().clone()
                if forced is not None and (r.rid, i) in forced:
                    toks[j] = forced[(r.rid, i)]
        return toks, lps
    eng._pick = kept
    if fault:
        ids_of = eng._lora_ids

        def neighbours():
            ids = ids_of()
            out = ids.copy()
            for i in np.flatnonzero(ids == 3):
                out[i] = ids[(i + 1) % len(ids)]
            return out
        eng._lora_ids = neighbours
    rids = [eng.submit(p, MAX_NEW, lora_id=int(i))
            for p, i in zip(prompts, lora_ids)]
    calls = {}
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with counted_calls(serving, SERVE_STEPS[:2], calls):
        steps = 0
        while not eng.idle:
            eng.step()
            steps += 1
            if steps > 10_000:
                fail("engine did not drain")
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    streams = [eng.result(r)[len(p):].tolist() for r, p in zip(rids,
                                                               prompts)]
    if eng.alloc.free_pages != eng.alloc.num_pages - 1:
        fail("lora_serve: pages leaked")
    return streams, logits_by, seconds, calls


def rel_rms(got, want) -> float:
    return float((got - want).pow(2).mean().sqrt()
                 / want.pow(2).mean().sqrt().clamp_min(1e-30))


def lora_serve(params, cfg, adapters, prompts, dev, card) -> dict:
    """The engine at full depth serving the trained adapters and a random
    one side by side (LORA_SERVE_IDS), against each request's own
    single-request run (teacher-forced on the batched run's tokens) and,
    for adapter-0 rows, against the engine without LoRA; a planted fault
    (the adapter-3 slot given its neighbour's adapter) must fail; new
    tokens/s beside the same serve without LoRA."""
    import torch
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    stack = serving_stack(adapters, cfg, dev)
    ids = LORA_SERVE_IDS
    # Warm-up of the LoRA path (not counted).
    lora_engine_run(params, cfg, [prompts[1][:64]], [1], dev, lora=stack)
    base_streams, base_logits, base_s, _ = lora_engine_run(
        params, cfg, prompts, [0] * len(prompts), dev)
    pa.reset_launch_counts()
    streams, logits, seconds, calls = lora_engine_run(
        params, cfg, prompts, ids, dev, lora=stack)
    launches = {k: n for k, n in pa.LAUNCH_COUNTS.items() if n}
    expected = expected_serve_launches(cfg, calls, None)
    if launches != expected:
        fail(f"lora_serve launch counts {launches}, expected {expected}")

    def worst(run_logits, refs) -> tuple[float, list]:
        per = []
        for r in range(len(prompts)):
            per.append(max(rel_rms(run_logits[(r, i)], refs[r][i])
                           for i in range(MAX_NEW)))
        return max(per), per

    # Each request alone on an engine of the same configuration: its
    # max_seq sets the page table's width, and with it the paged decode's
    # key chunks (`decode_splits`), so a narrower table would add the
    # rounding of another split (1.7-1.8% at 32 layers on the H100).
    max_seq = max(map(len, prompts)) + MAX_NEW + 1
    singles, same = [], 0
    for r, (p, lid) in enumerate(zip(prompts, ids)):
        forced = {(0, i): t for i, t in enumerate(streams[r])}
        _, ref, _, _ = lora_engine_run(params, cfg, [p], [lid], dev,
                                       lora=stack, forced=forced,
                                       max_seq=max_seq)
        singles.append([ref[(0, i)] for i in range(MAX_NEW)])
        same += sum(int(ref[(0, i)].argmax()) == streams[r][i]
                    for i in range(MAX_NEW))
    sound, per_request = worst(logits, singles)
    base0 = max(rel_rms(logits[(r, i)], base_logits[(r, i)])
                for r, lid in enumerate(ids) if lid == 0
                for i in range(MAX_NEW))
    _, fault_logits, _, _ = lora_engine_run(params, cfg, prompts, ids, dev,
                                            lora=stack, fault=True)
    faulted, _ = worst(fault_logits, singles)
    tokens = MAX_NEW * len(prompts)
    out = {"requests": len(prompts), "lora_ids": list(ids),
           "adapters": f"{LORA_ADAPTERS} (1, 2 trained; 3 drawn at b_scale "
                       f"{LORA_B_SCALE}), rank {LORA_RANK}",
           "new_tokens": tokens, "seconds": seconds,
           "new_tokens_per_s": tokens / seconds,
           "base_new_tokens_per_s": tokens / base_s,
           "launches": launches,
           "logits_rel_rms_worst": sound,
           "logits_rel_rms_by_request": per_request,
           "adapter0_vs_base_engine_rel_rms": base0,
           "adapter0_streams_equal_base": all(
               streams[r] == base_streams[r] for r, lid in enumerate(ids)
               if lid == 0),
           "greedy_tokens_equal_share": same / tokens,
           "planted_fault_rel_rms": faulted,
           "tol": REF_REL_RMS, "card": card}
    print("lora_serve: " + json.dumps(out), flush=True)
    if sound > REF_REL_RMS or base0 > REF_REL_RMS:
        fail("lora_serve: a request's logits disagree with its own run")
    if not faulted > REF_REL_RMS:
        fail("lora_serve: the limit does not see the planted fault")
    return launches


# Speculative decoding and beam search at Llama-3-8B width and depth.
SPEC_BATCH = 4
SPEC_PROMPT = 512
SPEC_NEW = 64
SPEC_DRAFT = 4
SPEC_ROUNDS = 4
SPEC_WEAK_LAYERS = 2
SPEC_FAULT_NEW = 16
SPEC_LOOKUP_NGRAM = 2
# Where a speculative stream first differs from the plain one, both
# tokens' logits on the plain path (recomputed for that row alone) must
# lie within SPEC_TIE of its top logit: a near-tie of bf16 logits that the
# verify chunk's and the decode's numerics break two ways.  4 bf16 steps
# of a logit between 4 and 8.
SPEC_TIE = 0.125
# A verify chunk that straddles the page boundary at the prompt's end:
# one row's chunk starts at VERIFY_CROSS (keys 510 .. 514 over pages 3
# and 4).
VERIFY_CROSS = SPEC_PROMPT - 2
BEAM_BATCH = 2
BEAM_K = 4
BEAM_PROMPT = 512
BEAM_NEW = 32
# A beam's score (its log-probabilities summed over its tokens, over its
# length) against a rescoring of its sequence by the full forward, both
# bf16: the sound reading is the two paths' rounding (8.8e-3 at 32 layers
# on the H100), a gather skipped at step BEAM_FAULT_STEP reads 4.1e-2
# there.  Many steps' gathers move rows between beams whose caches differ
# in a few recent positions only, and reading a wrong one of ~530 keys
# stays inside the rounding.
BEAM_SCORE_ABS = 2e-2
BEAM_FAULT_STEP = 2


def spec_prompt(cfg, dev, batch=None, length=None, seed=SEED + 31):
    """Random prompts [batch, length] (SPEC_BATCH x SPEC_PROMPT unless
    given), int32 on ``dev``."""
    import torch
    batch, length = batch or SPEC_BATCH, length or SPEC_PROMPT
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, length)),
                           dtype=torch.int32, device=dev)


def attention_counts() -> dict:
    """The nonzero launch counts of the paged, decode and forward
    kernels."""
    return {k: n for k, n in gemma_launches().items() if n}


def on_sm90(counts: dict) -> dict:
    """``counts`` ({kernel: n}) with each kernel's `_sm90` entry beside
    it: every launch on its Hopper kernel."""
    return {**counts, **{f"{k}_sm90": n for k, n in counts.items()}}


@contextlib.contextmanager
def spec_watch(serving, rounds: list, dispatches=None):
    """Inside the block, each `serving._speculative_round` appends to
    ``rounds`` its row counts (n_em), live mask, entry lengths and the
    target's layer-0 pools and table (references, read after the run);
    with ``dispatches`` a list, each `_speculative_burst_rounds` call runs
    under `torch.cuda.set_sync_debug_mode("error")` (any synchronising
    call inside raises) and appends its rounds."""
    import torch
    real_round = serving._speculative_round
    real_burst = serving._speculative_burst_rounds

    def round_(params, cfg, cache, last, drafts, live, **kw):
        out = real_round(params, cfg, cache, last, drafts, live, **kw)
        rounds.append({"n_em": out[1], "live": live, "base": cache.lengths,
                       "k": cache.k[0], "v": cache.v[0],
                       "table": cache.page_table})
        return out

    def burst(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = real_burst(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        dispatches.append(kwargs["rounds"])
        return out
    serving._speculative_round = round_
    if dispatches is not None:
        serving._speculative_burst_rounds = burst
    try:
        yield
    finally:
        serving._speculative_round = real_round
        serving._speculative_burst_rounds = real_burst


def round_stats(rounds) -> dict:
    """Rounds and tokens a live row emitted a round (their mean, and
    each round's mean over its live rows)."""
    if not rounds:
        return {"rounds": 0}
    n_em = torch_stack_host([r["n_em"] for r in rounds])
    live = n_em > 0
    per = [float(row[m].mean()) for row, m in zip(n_em, live) if m.any()]
    return {"rounds": len(rounds),
            "tokens_per_live_row_round": float(n_em[live].mean()),
            "accepted_per_live_row_round": float(n_em[live].mean() - 1),
            "tokens_per_round_by_round": per}


def torch_stack_host(tensors) -> np.ndarray:
    import torch
    return torch.stack(tensors).cpu().numpy()


def paged_logits_at(params, cfg, prompt_row, prefix, dev, budget):
    """float32 logits [vocab] of the plain paged path (chunks of PAGE,
    then `paged_decode_step`) at the token after ``prompt_row`` and the
    generated ``prefix``, one row, a table as wide as ``budget``'s."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving
    with torch.inference_mode():
        cache = serving.init_paged_model_cache(cfg, 1, budget,
                                               page_size=PAGE, device=dev)
        p = torch.as_tensor(prompt_row, dtype=torch.int32, device=dev)[None]
        for i in range(0, p.shape[1], PAGE):
            logits, cache = serving.paged_chunk_step(params, p[:, i:i + PAGE],
                                                     cfg, cache)
        logits = logits[:, -1]
        for t in prefix:
            logits, cache = serving.paged_decode_step(
                params, torch.tensor([int(t)], dtype=torch.int32,
                                     device=dev), cfg, cache)
        return logits[0].float()


def dense_logits_at(params, cfg, prompt_row, prefix, dev, budget):
    """float32 logits [vocab] of the plain dense path (`prefill`, then
    `decode_step`) at the token after ``prompt_row`` and ``prefix``."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving
    with torch.inference_mode():
        cache = serving.init_cache(cfg, 1, budget, device=dev)
        p = torch.as_tensor(prompt_row, dtype=torch.int32, device=dev)[None]
        logits, cache = serving.prefill(params, p, cfg, cache)
        for t in prefix:
            logits, cache = serving.decode_step(
                params, torch.tensor([int(t)], dtype=torch.int32,
                                     device=dev), cfg, cache)
        return logits[0].float()


def tie_gate(plain, other, prompts, logits_at) -> dict:
    """Each row of ``other`` (generated tokens, [rows, n]) against the
    plain stream ``plain`` up to its first divergence; there both tokens'
    logits on the plain path (``logits_at(row, prefix)``, recomputed for
    the row alone) must lie within SPEC_TIE of its top logit (for two
    tokens: the top two, within SPEC_TIE of each other).  Returns the
    readings and whether every row passes."""
    rows, ok = [], True
    for r, (a, b) in enumerate(zip(plain, other)):
        diff = np.flatnonzero(np.asarray(a) != np.asarray(b))
        if not len(diff):
            continue
        j = int(diff[0])
        logits = logits_at(prompts[r], a[:j])
        top = float(logits.max())
        gaps = [top - float(logits[int(t)]) for t in (a[j], b[j])]
        fine = max(gaps) <= SPEC_TIE
        ok &= fine
        rows.append({"row": r, "at": j, "plain": int(a[j]),
                     "other": int(b[j]), "below_top": gaps,
                     "top2": logits.topk(2).indices.tolist(), "ok": fine})
    return {"rows": len(plain), "diverged": len(rows), "divergences": rows,
            "tie_limit": SPEC_TIE, "ok": ok}


def speculative_model(params, cfg, dev, card) -> dict:
    """(a) `speculative_generate_model` with the target as its own drafter
    (SPEC_BATCH random SPEC_PROMPT-token prompts, SPEC_NEW new tokens,
    draft_len SPEC_DRAFT, SPEC_ROUNDS rounds a dispatch), each dispatch
    under sync debug mode "error", launch counts exact; `paged_generate`
    on the same prompts beside it; the streams by the tie gate."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    prompt = spec_prompt(cfg, dev)
    kd, layers = SPEC_DRAFT, cfg.n_layers
    kw = dict(draft_len=kd, page_size=PAGE)
    # Warm-up at these shapes (cuBLAS handles); not counted.
    serving.speculative_generate_model(
        params, prompt, cfg, draft_params=params, draft_cfg=cfg,
        max_new_tokens=kd + 2, rounds_per_dispatch=1, **kw)
    serving.paged_generate(params, prompt, cfg, max_new_tokens=3,
                           page_size=PAGE)
    rounds, dispatches = [], []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_attention_counts()
    t0 = time.perf_counter()
    with spec_watch(serving, rounds, dispatches):
        out = serving.speculative_generate_model(
            params, prompt, cfg, draft_params=params, draft_cfg=cfg,
            max_new_tokens=SPEC_NEW, rounds_per_dispatch=SPEC_ROUNDS, **kw)
        torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    launches = attention_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    chunks = -(-SPEC_PROMPT // PAGE)
    n = len(rounds)
    expected = on_sm90({
        "paged_prefill": layers * (2 * chunks + 2 * n),
        "paged_decode": layers * (kd - 1) * n})
    if launch_errors(launches, expected):
        fail(f"speculative_model launched (count, expected) "
             f"{launch_errors(launches, expected)}")
    if sum(dispatches) != n or set(dispatches) != {SPEC_ROUNDS}:
        fail(f"speculative_model: {n} rounds in dispatches {dispatches}")

    torch.cuda.reset_peak_memory_stats(dev)
    reset_attention_counts()
    t0 = time.perf_counter()
    plain = serving.paged_generate(params, prompt, cfg,
                                   max_new_tokens=SPEC_NEW, page_size=PAGE)
    torch.cuda.synchronize(dev)
    plain_secs = time.perf_counter() - t0
    plain_launches = attention_counts()
    plain_peak = torch.cuda.max_memory_allocated(dev)
    expected = on_sm90({"paged_prefill": layers * chunks,
                        "paged_decode": layers * (SPEC_NEW - 1)})
    if launch_errors(plain_launches, expected):
        fail(f"paged_generate launched (count, expected) "
             f"{launch_errors(plain_launches, expected)}")
    out_np, plain_np = out.cpu().numpy(), plain.cpu().numpy()
    if not (out_np[:, :SPEC_PROMPT] == prompt.cpu().numpy()).all():
        fail("speculative_generate_model changed the prompt")
    budget = SPEC_PROMPT + SPEC_NEW + 1
    prompts = prompt.cpu().numpy()

    def logits_at(row, prefix):
        return paged_logits_at(params, cfg, row, prefix, dev, budget)
    gate = tie_gate(plain_np[:, SPEC_PROMPT:], out_np[:, SPEC_PROMPT:],
                    prompts, logits_at)
    tokens = SPEC_BATCH * SPEC_NEW
    print("speculative_model: " + json.dumps({
        "config": f"llama3_8b, {layers} layers (full depth), bf16, "
                  "self-draft",
        "batch": SPEC_BATCH, "prompt_tokens": SPEC_PROMPT,
        "new_tokens_per_sequence": SPEC_NEW, "draft_len": kd,
        "rounds_per_dispatch": SPEC_ROUNDS,
        "speculative": {"seconds": secs, "new_tokens_per_s": tokens / secs,
                        "dispatches": len(dispatches), **round_stats(rounds),
                        "max_memory_allocated": peak,
                        "launches": launches},
        "paged_generate": {"seconds": plain_secs,
                           "new_tokens_per_s": tokens / plain_secs,
                           "max_memory_allocated": plain_peak,
                           "launches": plain_launches},
        "gate": gate, "card": card}), flush=True)
    if not gate["ok"]:
        fail("speculative_model: a stream left greedy away from a near-tie")
    return {"prompt": prompt, "out": out_np, "plain": plain_np,
            "rounds": rounds, "launches": launches,
            "logits_at": logits_at}


def over_accepting(real):
    """`_accepted` counting one draft token more than matched (at most
    draft_len): a verify that accepts a draft the target did not
    predict."""
    def run(drafts, preds):
        return (real(drafts, preds) + 1).clamp_max(drafts.shape[1])
    return run


def speculative_weak(params, cfg, dev, card, model) -> dict:
    """(b) the same weights cut to their first SPEC_WEAK_LAYERS layers
    (full width, the target's final norm and head) as the drafter,
    through `make_model_draft_fn` and `speculative_generate` on (a)'s
    prompts: launch counts exact, acceptance a round, the tie gate
    against (a)'s plain stream, whether (a) and (b) agree token for
    token; then the gate must fail on a planted fault (a round accepting
    one draft more than matched)."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    prompt, kd = model["prompt"], SPEC_DRAFT
    weak = dict(params, layers=params["layers"][:SPEC_WEAK_LAYERS])
    wcfg = dataclasses.replace(cfg, n_layers=SPEC_WEAK_LAYERS)

    def run(max_new):
        draft_fn = serving.make_model_draft_fn(
            weak, wcfg, prompt=prompt, draft_len=kd, max_new_tokens=max_new,
            page_size=PAGE)
        return serving.speculative_generate(
            params, prompt, cfg, draft_fn=draft_fn, draft_len=kd,
            max_new_tokens=max_new, page_size=PAGE).cpu().numpy()
    run(kd + 2)                         # warm-up, not counted
    rounds = []
    torch.cuda.synchronize(dev)
    reset_attention_counts()
    t0 = time.perf_counter()
    with spec_watch(serving, rounds):
        out = run(SPEC_NEW)
    secs = time.perf_counter() - t0
    launches = attention_counts()
    chunks, n = -(-SPEC_PROMPT // PAGE), len(rounds)
    expected = on_sm90({
        "paged_prefill": (cfg.n_layers + SPEC_WEAK_LAYERS) * (chunks + n),
        "paged_decode": SPEC_WEAK_LAYERS * (kd - 1) * n})
    if launch_errors(launches, expected):
        fail(f"speculative_weak launched (count, expected) "
             f"{launch_errors(launches, expected)}")
    prompts = prompt.cpu().numpy()
    plain = model["plain"][:, SPEC_PROMPT:]
    gate = tie_gate(plain, out[:, SPEC_PROMPT:], prompts, model["logits_at"])
    with planted(serving, "_accepted", over_accepting):
        faulted = run(SPEC_FAULT_NEW)
    fault_gate = tie_gate(plain[:, :SPEC_FAULT_NEW],
                          faulted[:, SPEC_PROMPT:], prompts,
                          model["logits_at"])
    tokens = SPEC_BATCH * SPEC_NEW
    print("speculative_weak: " + json.dumps({
        "config": f"llama3_8b target, {cfg.n_layers} layers; drafter its "
                  f"first {SPEC_WEAK_LAYERS} layers with the target's "
                  "final norm and head",
        "seconds": secs, "new_tokens_per_s": tokens / secs,
        **round_stats(rounds), "launches": launches, "gate": gate,
        "agrees_with_speculative_model": bool(
            (out == model["out"]).all()),
        "rows_equal_to_speculative_model": int(
            (out == model["out"]).all(axis=1).sum()),
        "planted_fault_gate": fault_gate, "card": card}), flush=True)
    if not gate["ok"]:
        fail("speculative_weak: a stream left greedy away from a near-tie")
    if fault_gate["ok"]:
        fail("speculative_weak: the gate does not see a round that "
             "accepts one draft more than matched")
    return launches


def prompt_lookup(draft_len: int, ngram: int = SPEC_LOOKUP_NGRAM):
    """A prompt-lookup drafter over the engine's history (right-aligned,
    -1 padded, its last entry the newest token), all on the device: the
    most recent earlier occurrence of the history's last ``ngram`` tokens
    and the ``draft_len`` tokens after it, else the newest token
    repeated."""
    import torch

    def draft(last, history):
        h = history.shape[1]
        tail = history[:, -ngram:]
        windows = history.unfold(1, ngram, 1)[:, :-1]        # [b, h - n, n]
        match = (windows == tail[:, None]).all(-1) & (windows[..., 0] >= 0)
        pos = torch.arange(h - ngram, device=history.device)
        best = torch.where(match, pos, -1).amax(dim=1)
        idx = (best[:, None] + ngram + torch.arange(
            draft_len, device=history.device)).clamp(0, h - 1)
        drafts = history.gather(1, idx)
        return torch.where((best[:, None] >= 0) & (drafts >= 0), drafts,
                           last[:, None])
    return draft


def speculative_engine(params, cfg, prompts, dev, card) -> dict:
    """(c) the engine in speculative mode (a prompt-lookup drafter,
    draft_len SPEC_DRAFT, the history over whole sequences) beside the
    plain engine, the 6 PROMPT_LENS requests, MAX_NEW each, max_batch
    MAX_BATCH, page PAGE: launch counts exact (each speculative step one
    `paged_prefill` a layer, no decode kernel), every page back, new
    tokens/s and steps of both, the tie gate on every request."""
    import torch
    from metal_flash_attention_tpu_torch import ServingEngine
    from metal_flash_attention_tpu_torch.models import serving

    kd = SPEC_DRAFT
    max_seq = max(map(len, prompts)) + MAX_NEW + 2 * (kd + 1)
    num_pages = MAX_BATCH * -(-max_seq // PAGE) + 1

    def run(**kw):
        eng = ServingEngine(params, cfg, max_batch=MAX_BATCH,
                            num_pages=num_pages, page_size=PAGE,
                            max_seq=max_seq, **kw)
        rids = [eng.submit(p, MAX_NEW) for p in prompts]
        calls, rounds = {}, []
        torch.cuda.synchronize(dev)
        reset_attention_counts()
        t0 = time.perf_counter()
        with counted_calls(serving, SERVE_STEPS[:2], calls), \
                spec_watch(serving, rounds):
            steps = 0
            while not eng.idle:
                eng.step()
                steps += 1
                if steps > 10_000:
                    fail("engine did not drain")
            torch.cuda.synchronize(dev)
        secs = time.perf_counter() - t0
        if eng.alloc.free_pages != num_pages - 1:
            fail(f"speculative_engine leaked pages ({kw})")
        streams = np.asarray([eng.result(r)[len(p):]
                              for r, p in zip(rids, prompts)])
        return streams, secs, steps, calls, rounds, attention_counts()

    spec_kw = dict(draft_fn=prompt_lookup(kd), draft_len=kd,
                   draft_history=max_seq)
    run(**spec_kw)                          # warm-up, not counted
    plain, plain_s, plain_steps, plain_calls, _, plain_l = run()
    spec, spec_s, spec_steps, calls, rounds, launches = run(**spec_kw)
    if launch_errors(plain_l, expected_serve_launches(cfg, plain_calls,
                                                      None)):
        fail("speculative_engine: the plain engine's launch counts")
    expected = on_sm90({"paged_prefill": cfg.n_layers
                        * len(calls["paged_chunk_step"])})
    if launch_errors(launches, expected) or calls["paged_decode_step"]:
        fail(f"speculative_engine launched (count, expected) "
             f"{launch_errors(launches, expected)}")
    prefill_chunks = sum(-(-len(p) // PAGE) for p in prompts)
    if len(calls["paged_chunk_step"]) != prefill_chunks + len(rounds):
        fail(f"speculative_engine: {len(calls['paged_chunk_step'])} chunk "
             f"steps, not {prefill_chunks} prefill chunks and "
             f"{len(rounds)} rounds")
    budget = max(map(len, prompts)) + MAX_NEW + 1

    def logits_at(row, prefix):
        return paged_logits_at(params, cfg, row, prefix, dev, budget)
    gate = tie_gate(plain, spec, prompts, logits_at)
    tokens = MAX_NEW * len(prompts)
    print("speculative_engine: " + json.dumps({
        "config": f"llama3_8b, {cfg.n_layers} layers (full depth), bf16",
        "requests": len(prompts), "new_tokens": tokens,
        "drafter": f"prompt lookup ({SPEC_LOOKUP_NGRAM}-gram over the "
                   f"history), draft_len {kd}",
        "speculative": {"seconds": spec_s, "new_tokens_per_s": tokens
                        / spec_s, "steps": spec_steps,
                        "chunk_steps": len(calls["paged_chunk_step"]),
                        **round_stats(rounds), "launches": launches},
        "plain": {"seconds": plain_s, "new_tokens_per_s": tokens / plain_s,
                  "steps": plain_steps, "launches": plain_l},
        "gate": gate, "card": card}), flush=True)
    if not gate["ok"]:
        fail("speculative_engine: a stream left greedy away from a "
             "near-tie")
    return launches


def verify_checks(dev, card, model) -> dict:
    """(d) the paged prefill kernel at the verify shape, q [SPEC_BATCH, 32,
    SPEC_DRAFT + 1, 128] (random, seeded) over the target's layer-0 pools
    and the ragged lengths of a round of (a) (the last with rows live and
    not live), one row's chunk moved across the page boundary at the prompt's
    end unless one crosses already: against its plain version by the
    worst 64-row tile (KERNEL_TILE_REL_RMS), lse at MIXED_TOL, with a
    planted fault (the last query row without its diagonal key) that the
    limit must see; its time (median, min-max of GEMM_REPEATS profiled
    loops), bound and plain version's, beside the decode kernel's time
    for the same rows as SPEC_DRAFT + 1 single-token calls."""
    import torch
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa
    from metal_flash_attention_tpu_torch.utils.tolerances import (
        MIXED_TOL,
        max_abs_err,
    )

    rounds, kc, d = model["rounds"], SPEC_DRAFT + 1, HEAD_DIM
    live = torch_stack_host([r["live"] for r in rounds])
    pick = max([i for i in range(len(rounds))
                if live[i].any() and not live[i].all()],
               default=len(rounds) - 1)
    r = rounds[pick]
    base = r["base"].clone()
    moved = not bool(((base // PAGE) != (base + kc - 1) // PAGE).any())
    if moved:
        base[0] = VERIFY_CROSS
    lengths = (base + kc).to(torch.int32)
    cache = pa.PagedKVCache(r["k"], r["v"], r["table"], lengths)
    gen = torch.Generator(device=dev).manual_seed(SEED + 41)
    q = torch.randn((SPEC_BATCH, Q_HEADS, kc, d), generator=gen,
                    device=dev).to(torch.bfloat16)

    def plain(q, cache):
        return pa._paged_attention_plain(q, cache, scale=d ** -0.5,
                                         window_size=None)
    pa.reset_launch_counts()
    o, lse = pa.paged_prefill(q, cache, return_residuals=True)
    counts = {k: n for k, n in pa.LAUNCH_COUNTS.items() if n}
    if counts != on_sm90({"paged_prefill": 1}):
        fail(f"verify_checks launched {counts}")
    po, plse = plain(q, cache)
    reading = closeness(o, po)
    lse_err = max_abs_err(lse, plse)
    # The fault: each sequence's last query row attends keys 0 .. its
    # position - 1 (a one-row chunk over lengths - 1).
    short, _ = plain(q[:, :, -1:], cache._replace(lengths=lengths - 1))
    fault = po.clone()
    fault[:, :, -1] = short[:, :, 0]
    reading["planted_fault"] = closeness(fault, po)
    if not within_limits(reading) or lse_err > MIXED_TOL.lse:
        fail(f"verify chunk: paged_prefill disagrees with its plain "
             f"version: o {reading}, lse {lse_err}")
    if within_limits(reading["planted_fault"]):
        fail("verify chunk: the limit does not see a query row without "
             "its diagonal key")
    kernel = timed_spread(lambda: pa.paged_prefill(q, cache), 50)
    plain_ms, _ = timed(lambda: plain(q, cache), 10)
    steps = [cache._replace(lengths=(base + t + 1).to(torch.int32))
             for t in range(kc)]
    qd = [q[:, :, t].contiguous() for t in range(kc)]

    def decode_rows():
        for t in range(kc):
            pa.paged_decode(qd[t], steps[t])
    decode = timed_spread(decode_rows, 20)
    lens = lengths.tolist()
    pairs = sum(visible_pairs(kc, n, True, None) for n in lens)
    n_bytes = sum(lens) * KV_HEADS * d * 2 * 2 + 2 * q.numel() * 2 \
        + q[..., 0].numel() * 4
    bound_ms, bound_by = bound(4 * d * Q_HEADS * pairs, n_bytes)
    out = {"shape": f"q [{SPEC_BATCH}, {Q_HEADS}, {kc}, {d}], lengths "
                    f"{lens}", "round": pick,
           "live": live[pick].tolist(), "moved_across_page": moved,
           "o": reading, "lse_max_abs_err": lse_err,
           "limits": {"tile_rel_rms": KERNEL_TILE_REL_RMS,
                      "lse_abs": MIXED_TOL.lse},
           "ms": kernel["ms"], "spread": kernel, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "share_of_bound": bound_ms / kernel["ms"],
           "decode_as_single_tokens_ms": decode["ms"],
           "decode_spread": decode, "card": card}
    print("verify_checks: " + json.dumps(out), flush=True)
    return out


def skipped_gather(step: int):
    """`_gather_rows` that returns the cache unchanged at its ``step``-th
    call: a beam step whose beams keep their own K/V rows instead of
    their parents'."""
    def make(real):
        calls = [0]

        def run(cache, rows):
            calls[0] += 1
            return cache if calls[0] == step else real(cache, rows)
        return run
    return make


@contextlib.contextmanager
def synced_beam_steps(serving):
    """Inside the block, `serving._beam_steps` (every step after the
    prefill) runs under `torch.cuda.set_sync_debug_mode("error")`."""
    import torch
    real = serving._beam_steps

    def run(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    serving._beam_steps = run
    try:
        yield
    finally:
        serving._beam_steps = real


def beam_phase(params, cfg, dev, card) -> dict:
    """(e) `beam_generate`, BEAM_BATCH random BEAM_PROMPT-token prompts,
    BEAM_K beams, BEAM_NEW new tokens, its steps after the prefill under
    sync debug mode "error", launch counts exact (one `flash_fwd` a layer,
    then `flash_decode` a layer a step), beside greedy `generate` over
    the BEAM_BATCH x BEAM_K rows at the same max_seq (rows x tokens/s);
    an instrumented run gives the cache gather's share of a step.
    Checks: one beam against greedy `generate` by the tie gate; the beams
    distinct and best first; each score against a rescoring of its
    sequence by `llama.forward` within BEAM_SCORE_ABS, which a planted
    fault (step BEAM_FAULT_STEP's gather skipped) must exceed."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama, serving

    prompt = spec_prompt(cfg, dev, BEAM_BATCH, BEAM_PROMPT, SEED + 37)
    rows, layers = BEAM_BATCH * BEAM_K, cfg.n_layers
    max_seq = BEAM_PROMPT + BEAM_NEW
    wide = prompt.repeat_interleave(BEAM_K, dim=0)

    def beams(k=BEAM_K):
        return serving.beam_generate(params, prompt, cfg, num_beams=k,
                                     max_new_tokens=BEAM_NEW)
    # Warm-up at these shapes; not counted.
    serving.beam_generate(params, prompt, cfg, num_beams=BEAM_K,
                          max_new_tokens=3)
    serving.generate(params, wide, cfg, max_new_tokens=3, max_seq=max_seq)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_attention_counts()
    t0 = time.perf_counter()
    with synced_beam_steps(serving):
        seqs, scores = beams()
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = attention_counts()
    expected = on_sm90({"flash_fwd": layers,
                        "flash_decode": layers * (BEAM_NEW - 1)})
    if launch_errors(launches, expected):
        fail(f"beam launched (count, expected) "
             f"{launch_errors(launches, expected)}")
    reset_attention_counts()
    t0 = time.perf_counter()
    plain = serving.generate(params, wide, cfg, max_new_tokens=BEAM_NEW,
                             max_seq=max_seq)
    torch.cuda.synchronize(dev)
    plain_secs = time.perf_counter() - t0
    if launch_errors(attention_counts(), expected):
        fail("beam: plain generate's launch counts")
    steps, gathers = [], []
    with event_timed(serving, "_beam_step", steps), \
            event_timed(serving, "_gather_rows", gathers):
        again, _ = beams()
    torch.cuda.synchronize(dev)
    step_ms = [a.elapsed_time(b) for a, b, _ in steps]
    gather_ms = [a.elapsed_time(b) for a, b, _ in gathers]

    seqs_np, scores_np = seqs.cpu().numpy(), scores.cpu().numpy()
    prompts = prompt.cpu().numpy()
    one, _ = beams(1)
    greedy = serving.generate(params, prompt, cfg, max_new_tokens=BEAM_NEW,
                              max_seq=max_seq).cpu().numpy()

    def logits_at(row, prefix):
        return dense_logits_at(params, cfg, row, prefix, dev, max_seq)
    gate = tie_gate(greedy[:, BEAM_PROMPT:],
                    one[:, 0, BEAM_PROMPT:].cpu().numpy(), prompts,
                    logits_at)
    ordered = bool((np.diff(scores_np, axis=1) <= 0).all())
    distinct = all(len({tuple(s) for s in seqs_np[b].tolist()}) == BEAM_K
                   for b in range(BEAM_BATCH))

    def rescored_err(seqs, scores):
        """max |score - the sequence's summed log-probabilities over its
        BEAM_NEW tokens by the full forward / BEAM_NEW|."""
        with torch.inference_mode():
            toks = seqs.reshape(rows, -1)
            logits, _ = llama.forward(params, toks, cfg)
            logp = torch.log_softmax(
                logits[:, BEAM_PROMPT - 1:-1].float(), dim=-1)
            got = logp.gather(-1, toks[:, BEAM_PROMPT:, None].long())
            want = got.sum(dim=(1, 2)) / BEAM_NEW
            return float((want.reshape(BEAM_BATCH, BEAM_K)
                          - scores).abs().max())
    score_err = rescored_err(seqs, scores)
    with planted(serving, "_gather_rows", skipped_gather(BEAM_FAULT_STEP)):
        fseqs, fscores = beams()
    fault_err = rescored_err(fseqs, fscores)
    out = {"config": f"llama3_8b, {layers} layers (full depth), bf16",
           "batch": BEAM_BATCH, "beams": BEAM_K,
           "prompt_tokens": BEAM_PROMPT, "new_tokens": BEAM_NEW,
           "max_seq": max_seq,
           "beam": {"seconds": secs,
                    "rows_tokens_per_s": rows * BEAM_NEW / secs,
                    "max_memory_allocated": peak, "launches": launches},
           "plain_generate": {"rows": rows, "seconds": plain_secs,
                              "rows_tokens_per_s": rows * BEAM_NEW
                              / plain_secs},
           "instrumented_run": {
               "same_sequences": bool(torch.equal(again, seqs)),
               "step_ms": stats(step_ms), "gather_ms": stats(gather_ms),
               "gather_share_of_step": sum(gather_ms) / sum(step_ms),
               "gather_bytes": 2 * 2 * layers * rows * cfg.n_kv_heads
               * max_seq * cfg.head_dim},
           "one_beam_gate": gate, "ordered": ordered, "distinct": distinct,
           "score_vs_rescoring_max_abs": score_err,
           "planted_fault_score_err": fault_err,
           "tol": BEAM_SCORE_ABS, "card": card}
    print("beam: " + json.dumps(out), flush=True)
    if not gate["ok"]:
        fail("beam: one beam left greedy away from a near-tie")
    if not (ordered and distinct):
        fail("beam: beams not distinct or not best first")
    if score_err > BEAM_SCORE_ABS:
        fail("beam: a score disagrees with its sequence's rescoring")
    if not fault_err > BEAM_SCORE_ABS:
        fail("beam: the limit does not see a skipped cache gather")
    return launches


# Mixtral-8x7B's widths (`MoEConfig`'s defaults): 8 experts of hidden
# 14,336, top-2, capacity factor 1.25.  A layer is 2.90 GB in bf16, so the
# full 32 layers (93 GB) do not fit in 80 GB: the serve keeps 16.
MOE_LAYERS = 16
MOE_FULL_LAYERS = 32
MOE_TRAIN_LAYERS = 4
MOE_TRAIN_TOKENS = 8192
MOE_TRAIN_STEPS = 4
MOE_TRAIN_LR = 1.0
MOE_REF_LAYERS = 2
MOE_REF_PROMPTS = (300, 200, 130, 77)
MOE_REF_STEPS = 6
MOE_TRAIN_REF_TOKENS = 2048
# A short sequence for the capacity fault in training: 32 tokens, a
# capacity of 10 an expert, which random routes fill past it.
MOE_CAP_TOKENS = 32
MOE_LOST_EXPERT = 3
# The largest gate margin (in probability) at which the kernel path and
# the plain one may route a token differently: between the sound run's
# near-ties and the planted faults' margins (on an H100: sound at most
# 0.0037, the faults 0.039 to 0.45).
MOE_TIE = 0.02
MOE_FAULTS = ("expert_lost", "capacity_off_by_one")
MOE_PROFILE_FAMILIES = {
    "attention": ("flash_decode90_kernel", "paged_prefill90_kernel",
                  "merge_splits", "flash_fwd90_kernel",
                  "flash_bwd_dq90_kernel", "flash_bwd_dkv90_kernel"),
    "elementwise": ("elementwise_kernel", "reduce_kernel")}
MOE_SPANS = ("moe_experts", "moe_routing", "fused_ce")


@contextlib.contextmanager
def moe_fault(name: str):
    """A fault planted in the MoE layer: one expert's output lost, or the
    capacity one token short."""
    from metal_flash_attention_tpu_torch.models import moe

    if name == "expert_lost":
        def make(experts):
            def run(params, xe, cfg):
                ye = experts(params, xe, cfg)
                keep = ye.new_ones((ye.shape[0], 1, 1))
                keep[MOE_LOST_EXPERT] = 0
                return ye * keep
            return run
        with planted(moe, "_experts", make):
            yield
    else:
        with planted(moe, "_capacity", lambda capacity: (
                lambda cfg, n: capacity(cfg, n) - 1)):
            yield


@contextlib.contextmanager
def moe_annotated():
    """`moe.moe_ffn` inside a `record_function("moe_routing")` range and
    `moe._experts` inside a "moe_experts" one, so that `profile_step`
    counts the card's kernels of each as a family (the innermost range
    wins).  Only the forward: the backward's kernels run outside."""
    from torch.profiler import record_function
    from metal_flash_attention_tpu_torch.models import moe

    def annotated(name):
        def make(fn):
            def run(*args, **kwargs):
                with record_function(name):
                    return fn(*args, **kwargs)
            return run
        return make
    with planted(moe, "moe_ffn", annotated("moe_routing")), \
            planted(moe, "_experts", annotated("moe_experts")):
        yield


@contextlib.contextmanager
def moe_routes(taken=None, record=None, margins=None):
    """`moe._top_k` watched inside the block: each call's expert ids
    appended to ``record``; with ``taken`` (an earlier run's record) each
    call takes those ids instead of its own, weighted by its own gates,
    and ``margins`` gets, for each choice where its own ids differ, the
    margin of its own gate over the one taken."""
    from metal_flash_attention_tpu_torch.models import moe

    def make(top_k):
        calls = iter(taken or ())

        def run(gates, k):
            topw, topi = top_k(gates, k)
            if taken is not None:
                own = topi
                topi = next(calls).to(gates.device)
                if margins is not None:
                    diff = own != topi
                    margins.append((gates.gather(1, own)
                                    - gates.gather(1, topi))[diff].detach())
                topw = gates.gather(1, topi)
                topw = topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9)
            if record is not None:
                record.append(topi)
            return topw, topi
        return run
    with planted(moe, "_top_k", make):
        yield


@contextlib.contextmanager
def moe_drops(counts: dict, mode: list):
    """`moe._slots` watched inside the block: counts[mode[0]] gets each
    call's kept choices (a tensor summed on the card, read after the
    block) and its choices."""
    from metal_flash_attention_tpu_torch.models import moe

    def make(slots):
        def run(topi, n_experts, capacity):
            slot, kept = slots(topi, n_experts, capacity)
            entry = counts.setdefault(mode[0], {"kept": 0, "choices": 0})
            entry["kept"] = entry["kept"] + kept.sum()
            entry["choices"] += kept.numel()
            return slot, kept
        return run
    with planted(moe, "_slots", make):
        yield


def drop_shares(counts: dict) -> dict:
    """{mode: share of routed choices that capacity dropped}."""
    return {m: {"choices": c["choices"],
                "dropped": c["choices"] - int(c["kept"]),
                "dropped_share": 1.0 - int(c["kept"]) / c["choices"]}
            for m, c in counts.items()}


@contextlib.contextmanager
def step_modes(serving, mode: list):
    """Inside the block, mode[0] names the paged step running:
    "prefill" in a chunk step, "decode" in a decode step."""
    patched = {n: getattr(serving, n) for n in ("paged_chunk_step",
                                                 "paged_decode_step")}

    def wrap(name, fn):
        def run(*args, **kwargs):
            mode[0] = name
            return fn(*args, **kwargs)
        return run
    serving.paged_chunk_step = wrap("prefill", patched["paged_chunk_step"])
    serving.paged_decode_step = wrap("decode", patched["paged_decode_step"])
    try:
        yield
    finally:
        for n, fn in patched.items():
            setattr(serving, n, fn)


def moe_params(dev, card):
    """moe_params: Mixtral-8x7B widths, MOE_LAYERS layers, bf16, seeded
    random weights built on the card."""
    import torch
    from metal_flash_attention_tpu_torch.models import moe

    cfg = moe.MoEConfig(n_layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    params = moe.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize(dev)
    secs = time.perf_counter() - t0
    layer_bytes = sum(nbytes(t) for t in (
        *(params["layers"][0][k] for k in ("wq", "wk", "wv", "wo")),
        *params["layers"][0]["moe"].values()))
    print("moe_params: " + json.dumps({
        "config": "mixtral_8x7b widths (MoEConfig defaults: dim 4096, 32 "
                  "heads, 8 kv heads, head_dim 128, hidden 14336, 8 "
                  "experts, top-2, capacity factor 1.25, vocab 32000), "
                  "bf16, router float32",
        "layers": MOE_LAYERS, "cut": f"{MOE_LAYERS} of {MOE_FULL_LAYERS} "
        "layers: the full depth does not fit in the card's memory",
        "layer_bytes": layer_bytes,
        "full_depth_bytes": layer_bytes * MOE_FULL_LAYERS,
        "param_bytes": torch.cuda.memory_allocated(dev),
        "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
        "seconds": secs, "card": card}), flush=True)
    return params, cfg


def moe_profile(params, cfg, prompts, dev) -> dict:
    """One decode step of MAX_BATCH rows (at the serve's prompt lengths)
    and one chunk step (PAGE tokens after a 512-token prefix) under
    torch.profiler: device ms by family."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    lens = [len(p) for p in prompts[:MAX_BATCH]]
    cache = serving.init_paged_model_cache(cfg, MAX_BATCH, max(lens) + 1,
                                           page_size=PAGE, device=dev)
    cache = cache._replace(lengths=torch.tensor(lens, dtype=torch.int32,
                                                device=dev))
    token = torch.zeros((MAX_BATCH,), dtype=torch.int32, device=dev)
    row = serving.init_paged_model_cache(cfg, 1, 512 + PAGE, page_size=PAGE,
                                         device=dev)
    row = row._replace(lengths=torch.full((1,), 512, dtype=torch.int32,
                                          device=dev))
    chunk = torch.as_tensor(prompts[0][None, :PAGE], device=dev)
    out = {}
    with torch.inference_mode(), moe_annotated():
        for label, run in (
                ("decode", lambda: serving.paged_decode_step(
                    params, token, cfg, cache)),
                ("chunk", lambda: serving.paged_chunk_step(
                    params, chunk, cfg, row))):
            run()
            out[label] = profile_step(f"moe_{label}_profile", run,
                                      MOE_PROFILE_FAMILIES, dev,
                                      spans=MOE_SPANS)
    return out


def moe_serve(params, cfg, prompts, dev, card) -> dict:
    """moe_serve: the paged serve's requests through `ServingEngine` over
    the MoE weights by `step()` (timed; every paged launch count set to 0
    just before and read just after and held exact, all on the Hopper
    kernels), then by `step_burst(BURST_K)` under `watched_serve` (each
    burst's steps under sync debug mode "error"), streams equal, with the
    share of routed choices that capacity dropped in decode and in
    prefill; one decode and one chunk step profiled by family.  Returns
    the step run's launch counts."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    serve(params, cfg, [prompts[1][:64]], dev, burst=BURST_K)   # warm-up

    def run(burst=0):
        calls, bursts, steps, counts, mode = {}, [], [], {}, [None]
        watch = (watched_serve(serving, calls, bursts, steps) if burst
                 else contextlib.nullcontext())
        with counted_calls(serving, SERVE_STEPS, calls), watch, \
                step_modes(serving, mode), moe_drops(counts, mode):
            pa.reset_launch_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            eng, rids, secs, n_calls, num_pages = serve(
                params, cfg, prompts, dev, burst=burst)
        launches = {k: n for k, n in pa.LAUNCH_COUNTS.items() if n}
        wrong = launch_errors(launches, expected_serve_launches(
            cfg, calls, None))
        if wrong:
            fail(f"moe_serve (burst {burst}) launched (count, expected) "
                 f"{wrong}")
        streams = [eng.result(r).tolist() for r in rids]
        for out, p in zip(streams, prompts):
            if len(out) != len(p) + MAX_NEW or not all(
                    0 <= t < cfg.vocab_size for t in out):
                fail("moe_serve: a request's stream is short or leaves the "
                     "vocabulary")
        if eng.alloc.free_pages != num_pages - 1:
            fail("moe_serve: pages leaked")
        tokens = MAX_NEW * len(prompts)
        reading = {
            "seconds": secs, "calls": n_calls,
            "new_tokens_per_s": tokens / secs,
            "chunk_steps": len(calls["paged_chunk_step"]),
            "decode_steps": len(calls["paged_decode_step"]),
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev),
            "capacity_drops": drop_shares(counts), "launches": launches}
        if burst:
            torch.cuda.synchronize(dev)
            reading["bursts"] = len(bursts)
            reading["burst_steps"] = [b["n_steps"] for b in bursts]
            # Decode steps run inside bursts; the rest ran in `step()`
            # fallbacks (an MoE engine bursts only with an empty queue).
            reading["decode_steps_in_bursts"] = sum(
                b["decode_calls"] for b in bursts)
            reading["burst_card_ms"] = stats([
                b["events"][0].elapsed_time(b["events"][1])
                for b in bursts])
            reading["burst_host_enqueue_ms"] = stats([
                b["host_s"] * 1e3 for b in bursts])
        del eng
        torch.cuda.empty_cache()
        return streams, reading

    streams, by_step = run()
    burst_streams, by_burst = run(BURST_K)
    profile = moe_profile(params, cfg, prompts, dev)
    print("moe_serve: " + json.dumps({
        "config": f"mixtral_8x7b widths, {cfg.n_layers} layers, bf16",
        "requests": len(prompts), "prompt_tokens": int(sum(map(len, prompts))),
        "new_tokens": MAX_NEW * len(prompts), "max_batch": MAX_BATCH,
        "page": PAGE, "step": by_step, f"step_burst_{BURST_K}": by_burst,
        "burst_streams_equal": burst_streams == streams,
        "device_ms_by_family": {k: v["device_ms_by_family"]
                                for k, v in profile.items()},
        "card": card}), flush=True)
    if burst_streams != streams:
        fail(f"moe_serve: step_burst({BURST_K})'s streams differ from "
             "step()'s")
    return by_step["launches"]


def moe_plain_logits(params, cfg, prompts, feeds, dev) -> list:
    """The paged reference run (`moe_paged_logits`) recomputed on the
    plain attention path: dense K/V per row, `attention_reference`, and
    the same MoE calls on the same token groups (each prompt's chunks of
    PAGE alone, each decode step's rows together)."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama, moe, serving
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )

    base = moe._base_cfg(cfg)
    kv = [[None] * cfg.n_layers for _ in prompts]

    def attend(x, pos, rows):
        """x [len(rows), n, dim] at positions pos [len(rows), n]; each row
        r of ``rows`` attends its own prefix and itself."""
        cos, sin = llama.rope_frequencies(base, pos)
        for li, layer in enumerate(params["layers"]):
            q, k, v = llama.attention_qkv(layer, x, base, cos, sin)
            outs = []
            for i, r in enumerate(rows):
                if kv[r][li] is None:
                    kv[r][li] = (k[i:i + 1], v[i:i + 1])
                else:
                    kv[r][li] = tuple(torch.cat([c, n[i:i + 1]], dim=2)
                                      for c, n in zip(kv[r][li], (k, v)))
                outs.append(attention_reference(
                    q[i:i + 1], *kv[r][li], causal=True).to(cfg.dtype))
            o = torch.cat(outs).transpose(1, 2).reshape(*x.shape[:2], -1)
            x = x + llama.wo_proj(o, layer).to(x.dtype)
            x = serving._ffn_block(layer, x, cfg)
        x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
        return (x @ params["lm_head"]).float()

    logits = []
    for r, p in enumerate(prompts):
        for i in range(0, len(p), PAGE):
            tok = torch.as_tensor(p[None, i:i + PAGE], device=dev)
            pos = torch.arange(i, i + tok.shape[1], device=dev)[None]
            x = params["embed"][tok.long()].to(cfg.dtype)
            logits.append(attend(x, pos, [r])[0])
    lens = [len(p) for p in prompts]
    for step, tok in enumerate(feeds):
        tok = torch.as_tensor(tok, device=dev)
        pos = torch.tensor(lens, device=dev)[:, None] + step
        x = params["embed"][tok.long()][:, None].to(cfg.dtype)
        logits.append(attend(x, pos, range(len(prompts)))[:, 0])
    return logits


def moe_paged_logits(params, cfg, prompts, feeds, dev) -> list:
    """The kernel path on the reference's cut: each prompt prefilled
    alone by `paged_chunk_step` (PAGE-token chunks, as the engine does),
    then one `paged_decode_step` of every row a feed, teacher-forced:
    every chunk's logits, then every decode step's."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    lens = [len(p) for p in prompts]
    cache = serving.init_paged_model_cache(
        cfg, len(prompts), max(lens) + len(feeds), page_size=PAGE,
        device=dev)
    logits = []
    with torch.inference_mode():
        for r, p in enumerate(prompts):
            # A row of its own (copies: the kernel wants 16-byte-aligned
            # tensors), as the engine uploads a request's table row.
            row = cache._replace(
                page_table=cache.page_table[r:r + 1].clone(),
                lengths=cache.lengths[r:r + 1].clone())
            for i in range(0, len(p), PAGE):
                out, row = serving.paged_chunk_step(
                    params, torch.as_tensor(p[None, i:i + PAGE], device=dev),
                    cfg, row)
                logits.append(out[0])
        cache = cache._replace(lengths=torch.tensor(
            lens, dtype=torch.int32, device=dev))
        for tok in feeds:
            out, cache = serving.paged_decode_step(
                params, torch.as_tensor(tok, device=dev), cfg, cache)
            logits.append(out)
    return logits


def flip_reading(margins: list) -> dict:
    """The choices on which a plain run's own routes left the kernel
    run's, with their gate margins."""
    import torch

    m = torch.cat([x.float().flatten() for x in margins]) if margins \
        else torch.zeros((0,))
    return {"flips": int(m.numel()),
            "max_margin": float(m.max()) if m.numel() else 0.0,
            "margins": sorted(m.tolist(), reverse=True)[:8]}


def moe_reference(params, cfg, dev) -> dict:
    """moe_reference: on a MOE_REF_LAYERS-layer cut, the paged path's
    logits (MOE_REF_PROMPTS prefilled by chunks, then MOE_REF_STEPS
    teacher-forced decode steps of all rows together) against the same
    model on the plain attention path (REF_*), the plain path taking the
    kernel path's expert choices; the choices where the plain path's own
    routes differ, with their gate margins (MOE_TIE); and both planted
    faults (MOE_FAULTS), which the gates must see."""
    import torch
    from metal_flash_attention_tpu_torch.models import serving

    cut = dict(params, layers=params["layers"][:MOE_REF_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=MOE_REF_LAYERS)
    rng = np.random.default_rng(SEED + 41)
    prompts = [rng.integers(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in MOE_REF_PROMPTS]
    feeds = rng.integers(0, cfg.vocab_size,
                         (MOE_REF_STEPS, len(prompts))).astype(np.int32)

    def reading(fault=None) -> dict:
        record, margins, counts, mode = [], [], {}, [None]
        with (moe_fault(fault) if fault else contextlib.nullcontext()), \
                moe_routes(record=record), step_modes(serving, mode), \
                moe_drops(counts, mode):
            got = moe_paged_logits(cut, ccfg, prompts, feeds, dev)
        with torch.no_grad(), moe_routes(taken=record, margins=margins):
            want = moe_plain_logits(cut, ccfg, prompts, feeds, dev)
        got = torch.cat([g.reshape(-1, g.shape[-1]) for g in got])
        want = torch.cat([w.reshape(-1, w.shape[-1]) for w in want])
        if not torch.isfinite(got).all():
            fail("moe_reference: non-finite logits on the kernel path")
        return {"rel_rms": rel_rms(got, want),
                "max_abs_err": float((got - want).abs().max()),
                **flip_reading(margins),
                "capacity_drops": drop_shares(counts)}

    def seen(r: dict) -> bool:
        return (r["rel_rms"] > REF_REL_RMS or r["max_abs_err"] > REF_MAX_ABS
                or r["max_margin"] > MOE_TIE)

    out = {"layers": MOE_REF_LAYERS, "prompts": list(MOE_REF_PROMPTS),
           "decode_steps": MOE_REF_STEPS, **reading(),
           "tol": {"rel_rms": REF_REL_RMS, "max_abs": REF_MAX_ABS,
                   "tie": MOE_TIE},
           "planted_faults": {f: reading(f) for f in MOE_FAULTS}}
    print("moe_reference: " + json.dumps(out), flush=True)
    if seen(out):
        fail("moe_reference: the paged MoE path disagrees with the plain "
             "attention path, or routes a token otherwise above the tie "
             "limit")
    for name, r in out["planted_faults"].items():
        if not seen(r):
            fail(f"moe_reference: the gates do not see the planted fault "
                 f"{name}")
    return out


def moe_train(dev, card):
    """moe_train: MOE_TRAIN_STEPS `moe.train_step`s (SGD at MOE_TRAIN_LR
    over `moe.loss_fn`: the fused cross-entropy plus the load-balancing
    loss) at Mixtral-8x7B widths, MOE_TRAIN_LAYERS layers, bf16, seeded
    weights of its own, one sequence of MOE_TRAIN_TOKENS + 1 tokens; the
    flash launch counts set to 0 just before and read just after and held
    exact (a layer's forward one `flash_fwd`, its backward one
    `flash_bwd_dq` and one `flash_bwd_dkv`, all also `_sm90`); the loss
    finite and falling; then one more step under torch.profiler.
    Returns (the trained parameters, the config, the launch counts)."""
    import torch
    from metal_flash_attention_tpu_torch.models import moe
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    cfg = moe.MoEConfig(n_layers=MOE_TRAIN_LAYERS)
    params = moe.init_params(
        cfg, torch.Generator(device=dev).manual_seed(SEED + 42), device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 43)
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_TRAIN_TOKENS + 1),
                           generator=gen, device=dev)
    torch.cuda.synchronize(dev)
    param_bytes = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    losses, seconds, counts, mode = [], [], {}, ["train"]
    with CardSampler() as sampler, moe_drops(counts, mode):
        for _ in range(MOE_TRAIN_STEPS):
            t0 = time.perf_counter()
            params, loss = moe.train_step(params, tokens, cfg,
                                          lr=MOE_TRAIN_LR)
            losses.append(float(loss))
            torch.cuda.synchronize(dev)
            seconds.append(time.perf_counter() - t0)
        clocks = sampler.stop()
    launches = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
    peak = torch.cuda.max_memory_allocated(dev)
    expected = {f"{kernel}{s}": cfg.n_layers * MOE_TRAIN_STEPS
                for kernel in GEMMA_TRAIN_FAMILIES for s in ("", "_sm90")}
    wrong = launch_errors(launches, expected)
    if wrong:
        fail(f"moe_train launched (count, expected) {wrong}")
    if not all(np.isfinite(losses)):
        fail(f"non-finite MoE training loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the MoE training loss did not fall: {losses}")
    steady = seconds[1:]
    print("moe_train: " + json.dumps({
        "config": f"mixtral_8x7b widths, {cfg.n_layers} layers, bf16, SGD "
                  f"lr {MOE_TRAIN_LR}, no remat",
        "tokens_per_step": MOE_TRAIN_TOKENS, "steps": MOE_TRAIN_STEPS,
        "capacity": moe._capacity(cfg, MOE_TRAIN_TOKENS),
        "losses": losses, "seconds_per_step": seconds,
        "tokens_per_s": MOE_TRAIN_TOKENS * len(steady) / sum(steady),
        "capacity_drops": drop_shares(counts),
        "launches": {k: n for k, n in launches.items() if n},
        "param_bytes": param_bytes, "max_memory_allocated": peak,
        "card": card, "card_during_steps": clocks}), flush=True)
    # The steps leave ~15 GB cached in blocks too small for the next
    # step's largest tensors: hand them back before the profiled one.
    torch.cuda.empty_cache()
    with fused_ce_annotated(), moe_annotated():
        profile_step("moe_train_profile", lambda: moe.train_step(
            params, tokens, cfg, lr=MOE_TRAIN_LR),
            {**MOE_PROFILE_FAMILIES, "optimizer": "multi_tensor"}, dev,
            spans=MOE_SPANS)
    return params, cfg, launches


def moe_plain_loss(params, tokens, cfg):
    """`moe.loss_fn(fused_ce=False)` with `attention_reference` in place
    of the flash kernels (float32 softmax, differentiable)."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama, moe
    from metal_flash_attention_tpu_torch.ops.reference import (
        attention_reference,
    )

    base = moe._base_cfg(cfg)
    inp = tokens[:, :-1]
    b, s = inp.shape
    pos = torch.arange(s, device=tokens.device)[None].expand(b, s)
    cos, sin = llama.rope_frequencies(base, pos)
    x = params["embed"][inp.long()].to(cfg.dtype)
    aux = 0.0
    for layer in params["layers"]:
        q, k, v = llama.attention_qkv(layer, x, base, cos, sin)
        o = attention_reference(q, k, v, causal=True).to(cfg.dtype)
        x = x + llama.wo_proj(o.transpose(1, 2).reshape(b, s, -1),
                              layer).to(x.dtype)
        h = llama.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        y, a = moe.moe_ffn(layer["moe"], h, cfg)
        x, aux = x + y, aux + a
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logp = torch.log_softmax((x @ params["lm_head"]).float(), dim=-1)
    nll = -logp.gather(-1, tokens[:, 1:, None].long()).mean()
    return nll + cfg.aux_loss_weight * aux / cfg.n_layers


def moe_train_reference(params, cfg, dev) -> dict:
    """moe_train_reference: on a MOE_REF_LAYERS-layer cut of the trained
    weights, `moe.loss_fn` (the flash kernels, the fused cross-entropy)
    and every gradient, the router's included, against `moe_plain_loss`
    under autograd (TRAIN_LOSS_ABS, TRAIN_GRAD_REL_RMS), the plain path
    on the kernel path's expert choices, at MOE_TRAIN_REF_TOKENS tokens
    and at MOE_CAP_TOKENS (where capacity binds); the choices where the
    plain path's own routes differ, with their gate margins (MOE_TIE);
    both planted faults (MOE_FAULTS), which the gates must see."""
    import torch
    from metal_flash_attention_tpu_torch.models import moe
    from metal_flash_attention_tpu_torch.utils.tree import flatten, leaf_paths

    cut = dict(params, layers=params["layers"][:MOE_REF_LAYERS])
    ccfg = dataclasses.replace(cfg, n_layers=MOE_REF_LAYERS)
    rng = np.random.default_rng(SEED + 44)
    batches = {n: torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                               (1, n + 1)), device=dev)
               for n in (MOE_TRAIN_REF_TOKENS, MOE_CAP_TOKENS)}
    paths = leaf_paths(cut)

    def value_and_grads(loss_fn):
        leaves, rebuild = flatten(cut)
        work = [t.detach().requires_grad_(True) for t in leaves]
        value = loss_fn(rebuild(work))
        return float(value.detach()), torch.autograd.grad(value, work)

    def reading(tokens, fault=None) -> dict:
        record, margins, counts, mode = [], [], {}, ["train"]
        with (moe_fault(fault) if fault else contextlib.nullcontext()), \
                moe_routes(record=record), moe_drops(counts, mode):
            loss, grads = value_and_grads(
                lambda p: moe.loss_fn(p, tokens, ccfg))
        with moe_routes(taken=record, margins=margins):
            ref_loss, ref_grads = value_and_grads(
                lambda p: moe_plain_loss(p, tokens, ccfg))
        rel = {}
        for path, g, r in zip(paths, grads, ref_grads):
            if not torch.isfinite(g).all():
                fail("moe_train_reference: a non-finite gradient on the "
                     "kernel path")
            rel[path] = rel_rms(g.float(), r.float())
        worst = max(rel, key=rel.get)
        return {"loss": loss, "plain_loss": ref_loss,
                "loss_abs_err": abs(loss - ref_loss),
                "grad_rel_rms_max": rel[worst], "worst_leaf": worst,
                "grad_rel_rms_w_router": max(
                    v for k, v in rel.items() if k.endswith("w_router")),
                "grad_rel_rms_median": float(np.median(list(rel.values()))),
                **flip_reading(margins),
                "capacity_drops": drop_shares(counts)}

    def seen(r: dict) -> bool:
        return (r["loss_abs_err"] > TRAIN_LOSS_ABS
                or r["grad_rel_rms_max"] > TRAIN_GRAD_REL_RMS
                or r["max_margin"] > MOE_TIE)

    out = {"layers": MOE_REF_LAYERS,
           "tol": {"loss_abs": TRAIN_LOSS_ABS,
                   "grad_rel_rms": TRAIN_GRAD_REL_RMS, "tie": MOE_TIE}}
    for n, tokens in batches.items():
        out[f"tokens_{n}"] = {"sound": reading(tokens), "planted_faults": {
            f: reading(tokens, f) for f in MOE_FAULTS}}
    print("moe_train_reference: " + json.dumps(out), flush=True)
    for n in batches:
        if seen(out[f"tokens_{n}"]["sound"]):
            fail(f"moe_train_reference: at {n} tokens the kernel path's "
                 "loss or gradients disagree with the plain-attention "
                 "path, or a token routes otherwise above the tie limit")
    for f in MOE_FAULTS:
        if not any(seen(out[f"tokens_{n}"]["planted_faults"][f])
                   for n in batches):
            fail(f"moe_train_reference: the gates do not see the planted "
                 f"fault {f}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs an NVIDIA "
              "GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    # A private config cache for the whole run: no tuned winner of an
    # earlier run (in ~/.cache or anywhere) changes what this run
    # launches, and this run's winners go nowhere else.
    from metal_flash_attention_tpu_torch.runtime.cache import (
        KernelConfigCache,
    )
    cache_dir = tempfile.mkdtemp(prefix="mfa_smoke_cache_")
    os.environ["MFA_TORCH_CACHE_DIR"] = cache_dir
    KernelConfigCache._instance = KernelConfigCache(
        os.path.join(cache_dir, "autotune.json"))
    try:
        return run(dev, cache_dir)
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)


def run(dev, cache_dir) -> int:
    """Every phase on ``dev``, with the run's private config cache."""
    import torch
    from metal_flash_attention_tpu_torch.models import llama
    from metal_flash_attention_tpu_torch.native.build import (
        build_variants,
        sources,
    )
    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    phases = {}

    def phase(name, fn, *args):
        """fn(*args), its wall seconds kept under `name`."""
        t0 = time.perf_counter()
        out = fn(*args)
        phases[name] = time.perf_counter() - t0
        return out

    # The plain libraries and the runtime phase's tile variants, one nvcc
    # each, all started together.
    t0 = time.perf_counter()
    variants = runtime_variants()
    libs = phase("build", build_variants,
                 [(name, None) for name in sources()] + variants)
    build_seconds = time.perf_counter() - t0
    print(f"build: {sorted(sources())} and {len(libs) - len(sources())} "
          f"tile variants in {build_seconds:.2f} s", flush=True)

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

    serve_streams = [eng.result(r).tolist() for r in rids]
    tp_launches = phase("tp_serve", tp_serve, params, cfg, prompts, dev,
                        card, serve_streams, paged_launches)

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
    # The engine's bursts and prefix cache on a cut of the weights: their
    # host-bound steps take half the time at half the depth.
    ecut = dict(params, layers=params["layers"][:ENGINE_PHASE_LAYERS])
    ecfg = dataclasses.replace(cfg, n_layers=ENGINE_PHASE_LAYERS)
    burst_launches = phase("burst_serve", burst_serve, ecut, ecfg, prompts,
                           dev, card)
    torch.cuda.empty_cache()
    prefix_launches = phase("prefix_serve", prefix_serve, ecut, ecfg, dev,
                            card)
    del ecut
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
    torch.cuda.empty_cache()
    # Weights in and out and LoRA on the same full-depth weights: HF
    # conversion, then fine-tuning adapters on the frozen base from token
    # shards with a checkpoint and resume, then serving them.
    phase("convert", convert_check, params, cfg, "llama", dev, card)
    workdir = os.path.join(cache_dir, "lora")
    os.makedirs(workdir)
    adapters, lora_train_launches, shards = phase(
        "lora_train", lora_train, params, cfg, dev, card, workdir)
    from metal_flash_attention_tpu_torch.utils.data import TokenLoader
    first = next(iter(TokenLoader(shards, LORA_BATCH, LORA_SEQ, seed=SEED,
                                  device=dev)))
    phase("lora_train_reference", lora_train_reference, params, cfg,
          adapters, first, dev)
    torch.cuda.empty_cache()
    lora_serve_launches = phase("lora_serve", lora_serve, params, cfg,
                                adapters, prompts, dev, card)
    del adapters, first
    torch.cuda.empty_cache()
    # Speculative decoding and beam search on the same full-depth weights.
    spec = phase("speculative_model", speculative_model, params, cfg, dev,
                 card)
    spec_launches = {
        "speculative_model": spec["launches"],
        "speculative_weak": phase("speculative_weak", speculative_weak,
                                  params, cfg, dev, card, spec)}
    torch.cuda.empty_cache()
    spec_launches["speculative_engine"] = phase(
        "speculative_engine", speculative_engine, params, cfg, prompts, dev,
        card)
    verify = phase("verify_checks", verify_checks, dev, card, spec)
    del spec
    torch.cuda.empty_cache()
    beam_launches = phase("beam", beam_phase, params, cfg, dev, card)
    torch.cuda.empty_cache()
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
    quant_fwd = phase("quant_fwd_checks", quant_fwd_checks, dev)
    torch.cuda.empty_cache()

    tparams, tcfg, flash_launches = phase("train", train, dev, card)
    phase("train_reference", train_reference, tparams, tcfg, dev)
    del tparams
    torch.cuda.empty_cache()
    kernels += phase("flash_checks", flash_kernel_checks, dev,
                     flash_launches)
    torch.cuda.empty_cache()
    # Head dim 32: entry() on the card and the training mesh at world
    # size 1 (its dry-run config at D 32), then the D 32 kernels' checks.
    d32_paths = {"entry": phase("entry", entry_check, dev, card)}
    d32_paths["tp_train"] = phase("tp_train", tp_train, dev, card)
    torch.cuda.empty_cache()
    # Ring and zigzag attention as threads on this card, and the pipeline
    # at world size 1.
    ring_launches = phase("ring_checks", ring_checks, dev, card)
    torch.cuda.empty_cache()
    pp_launches = phase("pp_check", pp_check, dev, card)
    torch.cuda.empty_cache()
    d32_paths["ring_checks"] = collections.Counter()
    for counts in ring_launches["d32"].values():
        d32_paths["ring_checks"].update(counts)
    # The tiny Llama and Gemma-2 served at head dim 32, and the docs'
    # examples, on the card; then every D 32 kernel's checks.
    d32_paths.update({f"tiny_serve:{p}": c for p, c in phase(
        "tiny_serve", tiny_serve, dev, card).items()})
    d32_paths.update({f"docs_examples:{p}": c for p, c in phase(
        "docs_examples", docs_examples, dev, card).items()})
    torch.cuda.empty_cache()
    kernels += phase("d32_checks", d32_checks, dev, card, d32_paths)
    torch.cuda.empty_cache()
    softmax_kernels = phase("softmax_checks", softmax_kernel_checks, dev,
                            card)
    torch.cuda.empty_cache()
    # float32 (slice 22): training at Llama-3-8B widths on the true-fp32
    # kernels, the dry run on this card, then the three kernels' checks.
    f32_params, f32_cfg, f32_launches = phase("fp32_train", fp32_train, dev,
                                              card)
    phase("fp32_train_reference", fp32_train_reference, f32_params, f32_cfg,
          dev, card)
    del f32_params
    torch.cuda.empty_cache()
    dry_launches = phase("dryrun", dryrun_phase, dev, card)
    torch.cuda.empty_cache()
    f32_kernels = phase("fp32_checks", fp32_checks, dev, card,
                        {"fp32_train": f32_launches, "dryrun": dry_launches})
    torch.cuda.empty_cache()
    for entry in kernels:
        if entry["name"] == "flash_fwd":
            burst = burst_launches[QUANT_SERVE_PRECISION]
            prefix = prefix_launches[QUANT_SERVE_PRECISION]
            entry["launches_by_path"] = {
                "train": flash_launches["flash_fwd"],
                "dense_serve": dense_launches["flash_fwd"],
                "quant_serve": quant_launches["flash_fwd"],
                "burst_serve": burst["flash_fwd"],
                "prefix_serve": prefix["flash_fwd"]}
            entry["launches_sm90_by_path"] = {
                "train": flash_launches["flash_fwd_sm90"],
                "dense_serve": dense_launches["flash_fwd_sm90"],
                "quant_serve": quant_launches["flash_fwd_sm90"],
                "burst_serve": burst["flash_fwd_sm90"],
                "prefix_serve": prefix["flash_fwd_sm90"]}
        if entry["name"] in ("paged_decode", "paged_prefill"):
            entry["launches_by_path"] = {
                "serve": entry["launches"],
                "burst_serve": burst_launches["bf16"][entry["name"]],
                "prefix_serve": prefix_launches["bf16"][entry["name"]],
                "lora_serve": lora_serve_launches[entry["name"]],
                "tp_serve": tp_launches[entry["name"]]}
        if entry["name"] in ATTENTION_COUNTS:
            entry.setdefault("launches_by_path", {"train": entry[
                "launches"]})["lora_train_step"] = lora_train_launches[
                    entry["name"]]
    for entry in kernels:
        if entry["name"] in ("paged_decode", "paged_prefill"):
            for path, counts in spec_launches.items():
                entry["launches_by_path"][path] = counts.get(entry["name"],
                                                             0)
        if entry["name"] == "paged_prefill":
            entry["verify_chunk"] = verify
        if entry["name"] == "flash_fwd":
            entry["launches_by_path"]["beam"] = beam_launches["flash_fwd"]
            entry["launches_sm90_by_path"]["beam"] = beam_launches[
                "flash_fwd_sm90"]
        if entry["name"] in ATTENTION_COUNTS:
            entry["launches_by_path"]["ring_checks"] = sum(
                c.get(entry["name"], 0)
                for c in ring_launches["d128"].values())
            entry["launches_by_path"]["pp_check"] = pp_launches[
                entry["name"]]
            entry["launches_by_path"]["dryrun"] = dry_launches.get(
                f"{entry['name']}_sm90", 0)
    decode_kernel["launches_by_path"] = {
        "beam": beam_launches["flash_decode"],
        "dense_serve": dense_launches["flash_decode"],
        "quant_serve": quant_launches["flash_decode"],
        "burst_serve": burst_launches[QUANT_SERVE_PRECISION]["flash_decode"],
        "prefix_serve": prefix_launches[QUANT_SERVE_PRECISION][
            "flash_decode"]}
    for entry in quant_kernels:
        entry["launches_by_path"] = {
            "quant_serve": entry["launches"],
            "burst_serve": burst_launches[QUANT_SERVE_PRECISION].get(
                entry["name"], 0),
            "prefix_serve": prefix_launches[QUANT_SERVE_PRECISION].get(
                entry["name"], 0)}
    for entry in quant_fwd:
        entry["launches_by_path"] = {"quant_fwd_checks": entry["launches"]}

    # Gemma-2 at gemma2_2b width and depth, seeded random weights.
    from metal_flash_attention_tpu_torch.models import gemma
    gcfg = gemma.GemmaConfig.gemma2_2b()
    t0 = time.perf_counter()
    gparams = gemma.init_params(
        gcfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
    torch.cuda.synchronize(dev)
    print(f"gemma_params: gemma2_2b, {gcfg.n_layers} layers (full depth), "
          f"bf16, {torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    phase("convert_gemma", convert_check, gparams, gcfg, "gemma", dev, card)
    torch.cuda.empty_cache()
    gemma_serve_launches = phase("gemma_serve", gemma_serve, gparams, gcfg,
                                 dev, card)
    torch.cuda.empty_cache()
    gemma_dense_launches = phase("gemma_dense", gemma_dense, gparams, gcfg,
                                 dev, card)
    torch.cuda.empty_cache()
    phase("gemma_reference", gemma_reference, gparams, gcfg, dev)
    del gparams
    torch.cuda.empty_cache()
    gemma_kernels = phase("gemma_kernel_checks", gemma_kernel_checks, gcfg,
                          dev, card, gemma_serve_launches,
                          gemma_dense_launches)
    torch.cuda.empty_cache()
    # Gemma-2 training at full width and depth, its own seeded weights.
    gtparams, gtcfg, gemma_train_launches = phase("gemma_train", gemma_train,
                                                  dev, card)
    phase("gemma_train_reference", gemma_train_reference, gtparams, gtcfg,
          dev)
    del gtparams
    torch.cuda.empty_cache()
    gemma_kernels += phase("gemma_bwd_checks", gemma_bwd_checks, gtcfg, dev,
                           card, gemma_train_launches)
    torch.cuda.empty_cache()
    # The flash-attention options at Llama-3-8B's attention widths.
    cases = option_cases(dev)
    option_launches = phase("options_attention", options_attention, cases,
                            dev, card)
    option_kernels = phase("options_checks", options_checks, cases, dev,
                           card, option_launches)
    del cases
    torch.cuda.empty_cache()

    # The runtime: tile sweeps, dispatch by the config cache, the CLI.
    runtime_kernels = phase("runtime", runtime_phase, dev, card, cache_dir,
                            build_seconds)
    torch.cuda.empty_cache()

    # Mixtral-style MoE at Mixtral-8x7B widths, seeded random weights:
    # MOE_LAYERS layers served, MOE_TRAIN_LAYERS trained.
    mparams, mcfg = phase("moe_params", moe_params, dev, card)
    moe_serve_launches = phase("moe_serve", moe_serve, mparams, mcfg,
                               prompts, dev, card)
    torch.cuda.empty_cache()
    phase("moe_reference", moe_reference, mparams, mcfg, dev)
    del mparams
    torch.cuda.empty_cache()
    mtparams, mtcfg, moe_train_launches = phase("moe_train", moe_train, dev,
                                                card)
    phase("moe_train_reference", moe_train_reference, mtparams, mtcfg, dev)
    del mtparams
    torch.cuda.empty_cache()
    for entry in kernels:
        if entry["name"] in ("paged_decode", "paged_prefill"):
            entry["launches_by_path"]["moe_serve"] = moe_serve_launches.get(
                entry["name"], 0)
        if entry["name"] in ATTENTION_COUNTS:
            entry["launches_by_path"]["moe_train_step"] = \
                moe_train_launches[entry["name"]] // MOE_TRAIN_STEPS

    kernels.append(decode_kernel)
    kernels.append(gemm_kernel)
    kernels += softmax_kernels
    kernels += f32_kernels
    kernels += quant_kernels
    kernels += quant_fwd
    kernels += gemma_kernels
    kernels += option_kernels
    kernels += runtime_kernels

    print("phases: " + json.dumps(phases))
    print("profiler_lost: " + json.dumps(PROFILER_LOST))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
