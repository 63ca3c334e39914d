"""Serving steps for the Llama family (PyTorch).

The port of the JAX package's `models/serving.py`, in two parts.

Dense (a preallocated [batch, kv_heads, max_seq, head_dim] cache per
layer):

- `prefill`: the prompt through the model (attention is
  `llama.attention_block` -> `dispatch.attention` -> the fused forward);
  each layer's K/V go into the cache as the layer finishes, and only the
  last position reaches the lm head;
- `decode_step`: one token per sequence, its K/V written at each
  sequence's length, attention by `ops.flash_decode.flash_decode`;
- `generate`: the greedy loop over the two; `generate_sampled` the same
  loop with `sample_token` (temperature, then top-k, then top-p) drawing
  from a `torch.Generator`;
- `sink_decode`: attention-sink decode, two `flash_decode` partials
  merged by `_merge_partials`;
- quantized (`QuantizedKVCache`, `quantize_cache`,
  `decode_step_quantized`): the prefilled cache quantized once (INT8 /
  FP8 / NF4, one scale per sequence and kv head), new tokens in a
  full-precision tail; each step merges a `flash_decode` partial over
  each by lse.

Paged (a page pool shared by the sequences):

- `paged_chunk_step`: a chunk of tokens per sequence (prompt prefill,
  chunk by chunk) -> its K/V appended to the pools and per-position
  logits; attention is `ops.paged_attention.paged_prefill`;
- `paged_decode_step`: one token per sequence -> its K/V appended and
  the next-token logits; attention is `paged_decode`;
- `paged_generate`: greedy generation over the two;
- quantized (`QuantizedPagedModelCache`, `paged_chunk_step_q`,
  `paged_decode_step_q`, `paged_generate_quantized`): full pages live in
  INT8 / FP8 / NF4 pools with one scale per (page, kv head), each
  sequence's page in progress in a bf16 tail; attention merges a
  `paged_decode` partial over the quantized pages with one over the tail
  (`flash_decode`, or in a chunk the causal `dispatch.attention`), and a
  tail that fills is quantized into its page (`_flush_full_pages`);
- bursts (`paged_decode_burst`, `paged_decode_burst_q`): k decode steps
  with each row's token fed back on the device, per-row sampling
  (`sample_token_per_row`), stop ids and budgets, and no host read or
  upload inside the k steps; ``step_fn=`` runs a family's decode step.

Speculative decoding (greedy, over the paged cache):

- `_speculative_round`: one verify round, the chunk [last, d_1..d_kd]
  through a chunk step (`paged_chunk_step` by default: the paged
  prefill kernel at q_chunk kd + 1), the longest draft prefix equal to
  the argmaxes accepted, one more token (the correction, or the bonus)
  emitted, and each row's length rolled back to what it consumed;
- `speculative_generate`: the host loop around it with any
  ``draft_fn(last, buf)``; `make_model_draft_fn` makes one from a
  smaller model with its own paged cache;
- `_speculative_burst_rounds` / `speculative_generate_model`: a draft
  model's rounds, ``rounds_per_dispatch`` of them between two host
  reads, every tensor of the carry on the device.

Beam search (`_beam_step`, `_beam_steps`, `beam_generate`) over the
dense cache: beams ride as batch rows (`decode_step`, so `flash_decode`),
and each step gathers every layer's K/V rows by parent beam.  The JAX
module's jit caches (`_spec_burst_jit`, `_chunk_step_jit`,
`_prefill_jit`, `_beam_scan_jit`) have no eager counterpart: here the
functions run as they are, and `_beam_steps` is the loop JAX scans.

Mixtral-style MoE (`models.moe`): the paged steps, and so their bursts,
speculative decoding and the engine, are family-polymorphic: a layer
that carries ``"moe"`` runs `moe.moe_ffn` (`_ffn_block`), with ``cfg`` a
`MoEConfig`, and capacity counts every token of the step (a decode step
routes every row, a chunk step every token of its chunks).  As in the
JAX package, the dense and quantized steps take Llama layers only.

Tensor-parallel serving (``mesh=`` in the four paged steps, so in their
bursts, speculative rounds and the engine's ``kv_sharding``): SPMD over
`torch.distributed`, each rank holding its blocks of the parameters
(`parallel.mesh.shard` under a family's `param_shardings`) and pools of
its kv heads.  The paged kernel runs on the rank's heads
(`_paged_attn_tp`); the row-parallel products (wo, w_down, an MoE layer's
experts) are summed over the heads axis in float32, before Gemma's
post-norms; Llama's lm_head blocks are all-gathered, Gemma's tied head is
replicated.  LoRA stays unsharded.

Gemma-2 (`models.gemma`): `gemma_prefill`, `gemma_decode_step` and
`gemma_generate` over the dense cache, `gemma_paged_chunk_step` and
`gemma_paged_decode_step` over the paged one (the engine's family hooks).
Local layers attend through the sliding window (a `kv_starts` window in
the dense decode, ``window_size`` elsewhere), every attention soft-caps
its logits in the kernel, and the tied head's logits are soft-capped.
The JAX module's `_gemma_layer_qkv` and `_gemma_final_softcap` are
`gemma.attention_qkv` and `gemma.final_softcap` here, beside the model's
other blocks.

Sampled streams are a pure function of (seed, request id, token index):
`_row_keys` hashes the three into a 32-bit key a row, and
`sample_token_per_row` adds Gumbel noise hashed from (row key, vocabulary
position) to the filtered logits and takes the argmax, which is how
`jax.random.categorical` samples.  A counter-based hash in torch integer
ops, not a `torch.Generator`: it gives the same bits on the CPU and on the
card, carries no generator state, and is one batched chain of device ops,
so a burst stays free of host work (and could be captured in a CUDA
graph).  The bits are not JAX's `jax.random` stream; the filters are
JAX's exactly.

Caches and pools are updated IN PLACE (the JAX package donates them
instead); each step returns a cache whose lengths moved on and whose
tensors are the same.  Large products stay `torch.matmul`, as the JAX
package leaves them to XLA, and the sampler is plain torch, as JAX's is
XLA outside any Pallas kernel; only attention is a hand-written kernel on
the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from metal_flash_attention_tpu_torch import dispatch
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.models import llama, moe
from metal_flash_attention_tpu_torch.parallel.mesh import (
    HEAD_AXIS,
    axis_size,
    check_mesh,
    gather_columns,
    row_parallel_sum,
)
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.ops.flash_decode import (
    flash_decode,
    write_rows,
)
from metal_flash_attention_tpu_torch.ops.paged_attention import (
    PagedKVCache,
    QuantizedPagedKVCache,
    as_kv_precision,
    paged_append_chunk,
    paged_decode,
    paged_prefill,
    quantize_page_block,
)
from metal_flash_attention_tpu_torch.ops.quantization import quantize


class KVCache(NamedTuple):
    """Per-layer dense K/V caches and the live lengths."""
    k: list                # [layers] x [batch, kv_heads, max_seq, d]
    v: list
    lengths: torch.Tensor  # int32 [batch]


def init_cache(cfg: llama.LlamaConfig, batch: int, max_seq: int,
               dtype=None, device=None) -> KVCache:
    """Zeroed caches in ``dtype`` (default ``cfg.dtype``), on the card
    unless ``device`` says otherwise."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    shape = (batch, cfg.n_kv_heads, max_seq, cfg.head_dim)

    def caches():
        return [torch.zeros(shape, dtype=dtype, device=device)
                for _ in range(cfg.n_layers)]
    return KVCache(k=caches(), v=caches(),
                   lengths=torch.zeros((batch,), dtype=torch.int32,
                                       device=device))


def prefill(params: dict, tokens: torch.Tensor, cfg: llama.LlamaConfig,
            cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Run the prompt tokens [batch, s] through the model: returns the
    float32 logits of the last position [batch, vocab] and the cache
    with lengths s.  Each layer's K/V are written into the cache (in
    place, at positions 0 .. s - 1) as the layer finishes, so no second
    copy of them is held."""
    _llama_layers_only(params)
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    for li, layer in enumerate(params["layers"]):
        x, (k, v) = llama.attention_block(layer, x, cfg, cos, sin)
        cache.k[li][:, :, :s] = k
        cache.v[li][:, :, :s] = v
        del k, v
        x = llama.mlp_block(layer, x, cfg)
    x = llama.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, cache._replace(lengths=torch.full_like(cache.lengths, s))


def decode_step(params: dict, token: torch.Tensor, cfg: llama.LlamaConfig,
                cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One decode step: token [batch] -> its K/V written at each
    sequence's length (in place), float32 logits [batch, vocab] through
    `flash_decode`, and the cache with lengths + 1.  With
    ``cfg.sliding_window`` w each row attends its last w positions."""
    _llama_layers_only(params)
    b = token.shape[0]
    positions = cache.lengths.long()[:, None]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][token.long()][:, None, :].to(cfg.dtype)
    lens = cache.lengths + 1
    window = cfg.sliding_window
    starts = None if window is None else (lens - window).clamp_min(0)
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin)
        write_rows(cache.k[li], k[:, :, 0], cache.lengths)
        write_rows(cache.v[li], v[:, :, 0], cache.lengths)
        o = flash_decode(q[:, :, 0].to(cfg.dtype), cache.k[li], cache.v[li],
                         kv_lens=lens, kv_starts=starts)
        x = x + llama.wo_proj(o.reshape(b, 1, -1), layer).to(x.dtype)
        x = llama.mlp_block(layer, x, cfg)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits, cache._replace(lengths=lens)


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1).to(torch.int32)


@torch.inference_mode()
def generate(params: dict, prompt: torch.Tensor, cfg: llama.LlamaConfig, *,
             max_new_tokens: int, max_seq: Optional[int] = None,
             cache_dtype=None) -> torch.Tensor:
    """Greedy generation: `prefill`, then max_new_tokens - 1
    `decode_step`s (the last token needs no forward).  prompt: int
    [batch, s] -> int32 [batch, s + max_new_tokens].  The cache holds
    ``max_seq`` positions (default s + max_new_tokens) on the prompt's
    device."""
    return _generate(params, prompt, cfg, _greedy, max_new_tokens,
                     max_seq, cache_dtype)


def _generate(params, prompt, cfg, pick, max_new_tokens, max_seq,
              cache_dtype, prefill_fn=None, decode_fn=None) -> torch.Tensor:
    """The dense loop: each new token is pick(float32 logits [batch,
    vocab]); the family's steps are ``prefill_fn`` and ``decode_fn``
    (default `prefill` and `decode_step`)."""
    b, s = prompt.shape
    cache = init_cache(cfg, b, max_seq or (s + max_new_tokens),
                       dtype=cache_dtype, device=prompt.device)
    logits, cache = (prefill_fn or prefill)(params, prompt, cfg, cache)
    tokens = [prompt.to(torch.int32)]
    token = pick(logits)
    for i in range(max_new_tokens):
        tokens.append(token[:, None])
        if i + 1 < max_new_tokens:
            logits, cache = (decode_fn or decode_step)(params, token, cfg,
                                                       cache)
            token = pick(logits)
    return torch.cat(tokens, dim=1)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _nucleus(l: torch.Tensor, sorted_desc: torch.Tensor,
             top_p) -> torch.Tensor:
    """l with every logit below the nucleus cutoff at -inf: the smallest
    prefix of ``sorted_desc`` (l's survivors sorted high to low, -inf
    past them) whose cumulative probability reaches top_p.  The cutoff
    is the SMALLEST kept logit: position 0 is always kept, so a max
    would make every row greedy."""
    probs = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = cum - probs < top_p
    cutoff = torch.where(keep, sorted_desc, torch.inf).amin(dim=-1,
                                                           keepdim=True)
    return l.masked_fill(l < cutoff, -torch.inf)


def sample_token(logits: torch.Tensor,
                 generator: Optional[torch.Generator] = None, *,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None) -> torch.Tensor:
    """Sample next tokens int32 [batch] from [batch, vocab] logits.

    temperature 0 (or top_k 1) is greedy argmax; top_k keeps the logits
    at or above the k-th highest (ties at it included); top_p (nucleus)
    keeps the smallest prefix of the sorted distribution, over the top-k
    survivors, with cumulative probability >= top_p.  The draw is the
    argmax of the filtered logits plus Gumbel noise from ``generator``
    (on the logits' device), where JAX takes an rng key."""
    if temperature == 0.0 or top_k == 1:
        return _greedy(logits)
    l = logits.float() / max(temperature, 1e-6)
    if top_k is not None:
        kth = torch.sort(l, dim=-1).values[:, -top_k][:, None]
        l = l.masked_fill(l < kth, -torch.inf)
    if top_p is not None:
        l = _nucleus(l, torch.sort(l, dim=-1, descending=True).values,
                     top_p)
    exp = torch.empty_like(l).exponential_(generator=generator)
    return _greedy(l - torch.log(exp))


def _filter_logits(logits: torch.Tensor, temperature: torch.Tensor,
                   top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """The float32 logits [batch, vocab] that `sample_token_per_row` draws
    from: divided by max(temperature, 1e-6), then every logit below the
    row's k-th highest at -inf (top_k 0: no cut; ties at the k-th all
    kept), then below its nucleus cutoff, the nucleus taken over the
    first k sorted positions only (top_p >= 1: no cut)."""
    vocab = logits.shape[-1]
    l = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    sorted_l = torch.sort(l, dim=-1, descending=True).values
    k_idx = (torch.where(top_k > 0, top_k, vocab).long() - 1).clamp(
        0, vocab - 1)[:, None]
    l = l.masked_fill(l < sorted_l.gather(1, k_idx), -torch.inf)
    pos = torch.arange(vocab, device=logits.device)[None, :]
    sorted_kept = sorted_l.masked_fill(pos > k_idx, -torch.inf)
    return _nucleus(l, sorted_kept, top_p.float()[:, None])


_MASK32 = 0xFFFFFFFF


def _hash32(x):
    """A 32-bit integer hash (xorshift-multiply) of a Python int or an
    int64 tensor holding values in [0, 2^32).  Both multipliers are
    below 2^31, so every product fits in int64 exactly, on any
    device."""
    x = x ^ (x >> 16)
    x = (x * 0x21F0AAAD) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x735A2D97) & _MASK32
    return x ^ (x >> 15)


def _row_keys(seed: int, rids: torch.Tensor,
              idxs: torch.Tensor) -> torch.Tensor:
    """Request-addressed row keys, int64 [batch] in [0, 2^32): a hash of
    (seed, request id, token index), so a sampled stream is one pure
    function of the three wherever it is drawn (the engine's sampler and
    both bursts), whatever else shares the batch."""
    seed &= (1 << 64) - 1
    base = _hash32(_hash32((seed & _MASK32) ^ 0x9E3779B9) ^ (seed >> 32))
    key = _hash32((rids.long() & _MASK32) ^ base)
    return _hash32(key ^ (idxs.long() & _MASK32))


def _gumbel(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Standard Gumbel noise float32 [batch, vocab] hashed from each row's
    key and the vocabulary position: 24 bits a draw, uniform in (0, 1)."""
    pos = _hash32(torch.arange(vocab, device=keys.device))
    bits = _hash32(keys[:, None] ^ pos[None, :]) >> 8
    u = (bits.float() + 0.5) * 2.0 ** -24
    return -torch.log(-torch.log(u))


def sample_token_per_row(logits: torch.Tensor, keys: torch.Tensor,
                         temperature: torch.Tensor, top_k: torch.Tensor,
                         top_p: torch.Tensor) -> torch.Tensor:
    """Per-row sampling parameters over [batch, vocab] logits, the
    continuous-batching shape: ``keys`` int64 [batch] (`_row_keys`),
    temperature / top_p float [batch], top_k int [batch].  A row with
    temperature <= 0 is greedy (the argmax of the raw logits); top_k 0
    and top_p >= 1 turn that filter off.  Returns int32 [batch]."""
    l = _filter_logits(logits, temperature, top_k, top_p)
    sampled = (l + _gumbel(keys, logits.shape[-1])).argmax(dim=-1)
    return torch.where(temperature <= 0, logits.argmax(dim=-1),
                       sampled).to(torch.int32)


@torch.inference_mode()
def generate_sampled(params: dict, prompt: torch.Tensor,
                     cfg: llama.LlamaConfig, *, max_new_tokens: int,
                     generator: Optional[torch.Generator] = None,
                     temperature: float = 1.0, top_k: Optional[int] = None,
                     top_p: Optional[float] = None,
                     max_seq: Optional[int] = None,
                     cache_dtype=None) -> torch.Tensor:
    """`generate` with `sample_token` (temperature / top-k / nucleus,
    noise from ``generator``, a `torch.Generator` on the prompt's
    device); temperature 0 or top_k 1 is exactly `generate`'s greedy
    loop."""
    if temperature == 0.0 or top_k == 1:
        pick = _greedy
    elif generator is None:
        raise ValueError("sampling needs a torch.Generator")
    else:
        def pick(logits):
            return sample_token(logits, generator, temperature=temperature,
                                top_k=top_k, top_p=top_p)
    return _generate(params, prompt, cfg, pick, max_new_tokens, max_seq,
                     cache_dtype)


class QuantizedKVCache(NamedTuple):
    """A prefilled cache quantized once, plus a full-precision tail for
    the tokens decoded since; attention over the two merges by lse."""
    k_q: list                 # [layers] x QuantizedTensor [b, kvh, S, d]
    v_q: list
    k_tail: list              # [layers] x [b, kvh, tail_capacity, d]
    v_tail: list
    prefix_len: torch.Tensor  # int32 [batch]
    tail_len: torch.Tensor    # int32 [batch]


def quantize_cache(cache: KVCache, precision,
                   tail_capacity: int = 128) -> QuantizedKVCache:
    """A prefilled `KVCache` in the quantized-prefix layout: each layer's
    K and V quantized whole (`ops.quantization.quantize`, one scale per
    sequence and kv head) and an empty tail of ``tail_capacity``
    positions in the cache's dtype, on the cache's device."""
    precision = as_kv_precision(precision)
    b, kvh, _, d = cache.k[0].shape

    def tails(xs):
        return [torch.zeros((b, kvh, tail_capacity, d), dtype=x.dtype,
                            device=x.device) for x in xs]
    return QuantizedKVCache(
        k_q=[quantize(k.float(), precision) for k in cache.k],
        v_q=[quantize(v.float(), precision) for v in cache.v],
        k_tail=tails(cache.k), v_tail=tails(cache.v),
        prefix_len=cache.lengths,
        tail_len=torch.zeros_like(cache.lengths))


def decode_step_quantized(params: dict, token: torch.Tensor,
                          cfg: llama.LlamaConfig, cache: QuantizedKVCache
                          ) -> tuple[torch.Tensor, QuantizedKVCache]:
    """One decode step over (quantized prefix) + (tail): the token's K/V
    written into the tail at tail_len (in place), one `flash_decode`
    partial over each segment merged by lse; returns float32 logits
    [batch, vocab] and the cache with tail_len + 1."""
    _llama_layers_only(params)
    b = token.shape[0]
    positions = (cache.prefix_len + cache.tail_len).long()[:, None]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][token.long()][:, None, :].to(cfg.dtype)
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin)
        write_rows(cache.k_tail[li], k[:, :, 0], cache.tail_len)
        write_rows(cache.v_tail[li], v[:, :, 0], cache.tail_len)
        qv = q[:, :, 0].to(cfg.dtype)
        o_pre, lse_pre = flash_decode(qv, cache.k_q[li], cache.v_q[li],
                                      kv_lens=cache.prefix_len,
                                      return_residuals=True)
        o_tail, lse_tail = flash_decode(qv, cache.k_tail[li],
                                        cache.v_tail[li],
                                        kv_lens=cache.tail_len + 1,
                                        return_residuals=True)
        o = _merge_partials(o_pre.float(), lse_pre, o_tail.float(),
                            lse_tail)
        x = x + llama.wo_proj(o.to(x.dtype).reshape(b, 1, -1),
                              layer).to(x.dtype)
        x = llama.mlp_block(layer, x, cfg)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    return logits, cache._replace(tail_len=cache.tail_len + 1)


def _merge_partials(o1: torch.Tensor, lse1: torch.Tensor, o2: torch.Tensor,
                    lse2: torch.Tensor) -> torch.Tensor:
    """Combine two attention partials over disjoint key sets by their
    natural-log lse; a partial that saw no key (lse = -inf) weighs 0."""
    lse = torch.logaddexp(lse1, lse2)
    safe = torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))
    zero = torch.zeros_like(lse)
    w1 = torch.where(torch.isfinite(lse1), torch.exp(lse1 - safe), zero)
    w2 = torch.where(torch.isfinite(lse2), torch.exp(lse2 - safe), zero)
    return o1 * w1[..., None] + o2 * w2[..., None]


def sink_decode(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, kv_lens: torch.Tensor, *,
                window: int, sink: int = 4,
                scale: Optional[float] = None) -> torch.Tensor:
    """Attention-sink decode (StreamingLLM): each token attends the first
    ``sink`` positions and the last ``window`` ones.  Two `flash_decode`
    partials merged by lse: the sink partial reads a slice of the
    cache's first rows (a strided view, no copy), the window partial
    starts each row at max(kv_lens - window, sink) with
    ``max_span=window``.  q [batch, q_heads, d], caches [batch,
    kv_heads, max_seq, d], kv_lens int [batch]; returns o like q."""
    rows = min(max(sink, 1), k_cache.shape[2])
    o_s, lse_s = flash_decode(q, k_cache[:, :, :rows], v_cache[:, :, :rows],
                              kv_lens=kv_lens.clamp_max(sink), scale=scale,
                              return_residuals=True)
    starts = (kv_lens - window).clamp_min(sink)
    o_w, lse_w = flash_decode(q, k_cache, v_cache, kv_lens=kv_lens,
                              kv_starts=starts, max_span=window, scale=scale,
                              return_residuals=True)
    return _merge_partials(o_s.float(), lse_s, o_w.float(),
                           lse_w).to(q.dtype)


class PagedModelCache(NamedTuple):
    """Per-layer paged KV pools sharing one page table and length
    vector."""
    k: tuple                  # [layers] x [num_pages, kv_heads, page, d]
    v: tuple
    page_table: torch.Tensor  # [batch, max_pages] int32
    lengths: torch.Tensor     # [batch] int32


def init_paged_model_cache(cfg: llama.LlamaConfig, batch: int,
                           max_seq: int, *, page_size: int = 128,
                           dtype=None, device=None) -> PagedModelCache:
    """Contiguously page-assigned pools: sequence i owns pages
    i * max_pages .. (i + 1) * max_pages - 1.  On the card unless
    ``device`` says otherwise."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    max_pages = -(-max_seq // page_size)
    num_pages = batch * max_pages
    shape = (num_pages, cfg.n_kv_heads, page_size, cfg.head_dim)

    def pools():
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(cfg.n_layers))
    table = torch.arange(num_pages, dtype=torch.int32,
                         device=device).reshape(batch, max_pages)
    return PagedModelCache(k=pools(), v=pools(), page_table=table,
                           lengths=torch.zeros((batch,), dtype=torch.int32,
                                               device=device))


def _paged_attn_tp(fn, mesh, q: torch.Tensor, layer_cache: PagedKVCache,
                   **kw) -> torch.Tensor:
    """A paged kernel on this rank's heads (all of them without a mesh):
    the JAX package runs it as a shard_map island over the heads axis.
    Here q [b, q_heads / tp, ...] and the pools [P, kv_heads / tp, page,
    d] already hold the rank's blocks, so the call is local: q-head
    blocks are contiguous, so each GQA group stays whole on one rank, and
    attention moves no data between ranks."""
    if mesh is not None and q.shape[1] % layer_cache.k_pages.shape[1]:
        raise ValueError(f"{q.shape[1]} local q heads over "
                         f"{layer_cache.k_pages.shape[1]} local kv heads")
    return fn(q, layer_cache, **kw)


def _tp_mesh(mesh, cfg, lora=None):
    """Check ``mesh`` for the tensor-parallel steps: a `make_mesh` mesh
    whose heads axis divides the q and kv heads (ValueError otherwise);
    LoRA stays on one card, as the JAX engine keeps it there."""
    if mesh is None:
        return None
    tp = axis_size(check_mesh(mesh), HEAD_AXIS)
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(f"{cfg.n_heads} q heads and {cfg.n_kv_heads} kv "
                         f"heads do not split over {tp} ranks of the heads "
                         f"axis")
    if lora is not None:
        raise ValueError("lora rides on the unsharded paged steps only")
    return mesh


def _ffn_block(layer: dict, x: torch.Tensor, cfg, mesh=None) -> torch.Tensor:
    """Dense MLP or MoE FFN, keyed by the layer's parameters: the paged
    steps are family-polymorphic (Llama layers carry w_gate / w_up /
    w_down, Mixtral-style ones a routed expert bank, `models.moe`, with
    ``cfg`` a `MoEConfig`).  The load-balancing loss is a training
    quantity and is dropped.  ``mesh``: the layer holds the rank's
    blocks, and their partials are summed over the heads axis."""
    if "moe" in layer:
        h = llama.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        y, _ = moe.moe_ffn(layer["moe"], h, cfg, mesh=mesh)
        return x + y
    return llama.mlp_block(layer, x, cfg, mesh=mesh)


def _last_writes(slots: torch.Tensor) -> torch.Tensor:
    """slots [n]: each write's target -> [n], the index of the last write
    to the same target (by a stable sort, on the device, no host read)."""
    n = slots.numel()
    order = torch.sort(slots, stable=True).indices
    ranked = slots[order]
    ends = torch.ones_like(ranked, dtype=torch.bool)
    ends[:-1] = ranked[1:] != ranked[:-1]
    at = torch.arange(n, device=slots.device)
    # The first end of a run at or after each sorted position.
    end = torch.where(ends, at, n).flip(0).cummin(0).values.flip(0)
    last = torch.empty_like(order)
    last[order] = order[end]
    return last


def _routed_write_order(params: dict, cache: PagedModelCache,
                        kc: int) -> Optional[torch.Tensor]:
    """For a model with a routed layer, the step's [b * kc] pool writes
    (row-major) -> the index of the last write to the same (page, row),
    else None.  Rows that share a slot (the engine's idle rows, all at
    row 0 of the null page) differ under capacity, and on the card the
    scatter's winner is unordered, so it would reach live rows through
    the next layer's routes: `_take_writes` gives every such write the
    last row's values, as a sequential scatter leaves them.  A dense
    model's shared-slot rows reach no other row, so it skips this."""
    b = cache.page_table.shape[0]
    if b == 1 or not any("moe" in layer for layer in params["layers"]):
        return None
    ps = cache.k[0].shape[2]
    pos = (cache.lengths.long()[:, None]
           + torch.arange(kc, device=cache.lengths.device)[None, :])
    page = torch.gather(cache.page_table.long(), 1, pos // ps)
    return _last_writes((page * ps + pos % ps).flatten())


def _take_writes(new: torch.Tensor, order: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """new [b, kv_heads, kc, d] with each (row, token) write replaced by
    the one ``order`` names (`_routed_write_order`); None keeps it."""
    if order is None:
        return new
    b, h, kc, d = new.shape
    rows = new.transpose(1, 2).reshape(b * kc, h, d)[order]
    return rows.view(b, kc, h, d).transpose(1, 2)


def _llama_layers_only(params: dict) -> None:
    """The dense and quantized steps run `llama.mlp_block`, as the JAX
    package's do, so they serve no MoE layer: refuse one up front."""
    if any("moe" in layer for layer in params["layers"]):
        raise NotImplementedError(
            "a mixture-of-experts layer runs on the paged bf16 steps only "
            "(paged_chunk_step, paged_decode_step and what is built on "
            "them); the dense and quantized steps take Llama layers, as "
            "in the JAX package")


def paged_chunk_step(params: dict, tokens: torch.Tensor,
                     cfg: llama.LlamaConfig, cache: PagedModelCache,
                     mesh=None, lora=None, lora_ids=None
                     ) -> tuple[torch.Tensor, PagedModelCache]:
    """Consume a chunk of tokens [batch, k] at positions
    lengths .. lengths + k - 1: write their K/V into the pools (in
    place) and return float32 logits [batch, k, vocab] with the advanced
    cache.  Attention is `paged_prefill` (causal at each query's
    position, ragged lengths per sequence).  ``lora`` / ``lora_ids``:
    stacked adapters (`models.lora`) and each row's adapter, on the
    attention projections.

    ``mesh``: tensor-parallel serving over the mesh's heads axis (SPMD:
    every rank calls the step with the same tokens).  The rank holds its
    blocks of the parameters (`parallel.mesh.shard` under
    `llama.param_shardings` or `moe.param_shardings`) and pools of its
    n_kv_heads / tp heads (the engine's ``kv_sharding``).  The paged
    kernel runs on its n_heads / tp q heads (`_paged_attn_tp`); wo's and
    w_down's row-parallel partials (and an MoE layer's experts') are
    summed in float32 over the heads axis and cast back to the model
    dtype (`parallel.mesh.row_parallel_sum`); lm_head's column blocks
    are all-gathered, so every rank returns the whole float32 logits.
    ValueError when tp does not divide the heads (or the experts); LoRA
    is refused with a mesh."""
    mesh = _tp_mesh(mesh, cfg, lora)
    b, kc = tokens.shape
    positions = cache.lengths.long()[:, None] + torch.arange(
        kc, device=tokens.device)[None, :]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    order = _routed_write_order(params, cache, kc)
    for li, layer in enumerate(params["layers"]):
        ll = None if lora is None else lora["layers"][li]
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin, ll, lora_ids)
        layer_cache = paged_append_chunk(
            PagedKVCache(cache.k[li], cache.v[li], cache.page_table,
                         cache.lengths),
            _take_writes(k, order), _take_writes(v, order))
        o = _paged_attn_tp(paged_prefill, mesh, q.to(cfg.dtype),
                           layer_cache,
                           window_size=getattr(cfg, "sliding_window", None))
        o = o.transpose(1, 2).reshape(b, kc, -1)
        x = x + row_parallel_sum(llama.wo_proj(o, layer, ll, lora_ids),
                                 mesh).to(x.dtype)
        x = _ffn_block(layer, x, cfg, mesh=mesh)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = gather_columns((x @ params["lm_head"]).float(), mesh)
    return logits, cache._replace(lengths=cache.lengths + kc)


def paged_decode_step(params: dict, token: torch.Tensor,
                      cfg: llama.LlamaConfig, cache: PagedModelCache,
                      mesh=None, lora=None, lora_ids=None
                      ) -> tuple[torch.Tensor, PagedModelCache]:
    """One decode step: token [batch] -> its K/V appended at lengths
    (in place), float32 logits [batch, vocab] via `paged_decode`, and
    the cache with lengths + 1.  ``mesh``, ``lora`` / ``lora_ids`` as in
    `paged_chunk_step`."""
    mesh = _tp_mesh(mesh, cfg, lora)
    b = token.shape[0]
    positions = cache.lengths.long()[:, None]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][token.long()][:, None, :].to(cfg.dtype)
    order = _routed_write_order(params, cache, 1)
    for li, layer in enumerate(params["layers"]):
        ll = None if lora is None else lora["layers"][li]
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin, ll, lora_ids)
        layer_cache = paged_append_chunk(
            PagedKVCache(cache.k[li], cache.v[li], cache.page_table,
                         cache.lengths),
            _take_writes(k, order), _take_writes(v, order))
        o = _paged_attn_tp(paged_decode, mesh, q[:, :, 0].to(cfg.dtype),
                           layer_cache,
                           window_size=getattr(cfg, "sliding_window", None))
        o = o.reshape(b, 1, -1)
        x = x + row_parallel_sum(llama.wo_proj(o, layer, ll, lora_ids),
                                 mesh).to(x.dtype)
        x = _ffn_block(layer, x, cfg, mesh=mesh)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = gather_columns((x[:, 0] @ params["lm_head"]).float(), mesh)
    return logits, cache._replace(lengths=cache.lengths + 1)


@torch.inference_mode()
def paged_generate(params: dict, prompt: torch.Tensor,
                   cfg: llama.LlamaConfig, *, max_new_tokens: int,
                   page_size: int = 128) -> torch.Tensor:
    """Greedy generation over the paged cache: chunked prompt prefill,
    then one `paged_decode_step` per token.  prompt: [batch, s] ->
    [batch, s + max_new_tokens] int32."""
    b, s = prompt.shape
    cache = init_paged_model_cache(cfg, b, s + max_new_tokens + 1,
                                   page_size=page_size,
                                   device=prompt.device)
    logits, cache = _prefill_chunks(params, prompt, cfg, cache, page_size)
    tokens = [prompt.to(torch.int32)]
    token = _greedy(logits[:, -1])
    for i in range(max_new_tokens):
        tokens.append(token[:, None])
        if i + 1 < max_new_tokens:
            logits, cache = paged_decode_step(params, token, cfg, cache)
            token = _greedy(logits)
    return torch.cat(tokens, dim=1)


# ---------------------------------------------------------------------------
# Gemma-2: alternating local and global layers, soft-capped logits
# ---------------------------------------------------------------------------

def gemma_prefill(params: dict, tokens: torch.Tensor, cfg,
                  cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """Prefill for `models.gemma`: local layers attend through the sliding
    window, global layers causally over everything, every logit
    soft-capped (the fused forward, through `dispatch.attention`).  Each
    layer's K/V are written into the cache (in place) as it finishes;
    returns the soft-capped float32 logits of the last position [batch,
    vocab] and the cache with lengths s."""
    from metal_flash_attention_tpu_torch.models import gemma

    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = gemma.embed(params, tokens, cfg)
    for li, layer in enumerate(params["layers"]):
        x, (k, v) = gemma.attention_block(layer, x, cfg, cos, sin,
                                          window=gemma.layer_window(cfg, li))
        cache.k[li][:, :, :s] = k
        cache.v[li][:, :, :s] = v
        del k, v
        x = gemma.mlp_block(layer, x, cfg)
    x = gemma.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    return gemma.lm_head(params, x, cfg), cache._replace(
        lengths=torch.full_like(cache.lengths, s))


def gemma_decode_step(params: dict, token: torch.Tensor, cfg,
                      cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One Gemma decode step: token [batch] -> its K/V written at each
    sequence's length (in place), soft-capped float32 logits [batch,
    vocab] and the cache with lengths + 1.  Attention is `flash_decode`
    with the soft cap; a local layer attends its last sliding_window
    positions through ``kv_starts``."""
    from metal_flash_attention_tpu_torch.models import gemma

    b = token.shape[0]
    positions = cache.lengths.long()[:, None]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = gemma.embed(params, token[:, None], cfg)
    lens = cache.lengths + 1
    local_starts = (lens - cfg.sliding_window).clamp_min(0)
    for li, layer in enumerate(params["layers"]):
        q, k, v = gemma.attention_qkv(layer, x, cfg, cos, sin)
        write_rows(cache.k[li], k[:, :, 0], cache.lengths)
        write_rows(cache.v[li], v[:, :, 0], cache.lengths)
        o = flash_decode(
            q[:, :, 0].to(cfg.dtype), cache.k[li], cache.v[li], kv_lens=lens,
            kv_starts=local_starts if gemma.is_local_layer(li) else None,
            scale=cfg.attn_scale, logit_softcap=cfg.attn_logit_softcap)
        x = gemma.attention_out(layer, o.reshape(b, 1, -1), x, cfg)
        x = gemma.mlp_block(layer, x, cfg)
    x = gemma.rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return gemma.lm_head(params, x, cfg), cache._replace(lengths=lens)


@torch.inference_mode()
def gemma_generate(params: dict, prompt: torch.Tensor, cfg, *,
                   max_new_tokens: int, max_seq: Optional[int] = None,
                   cache_dtype=None) -> torch.Tensor:
    """Greedy generation for the Gemma family: `gemma_prefill`, then
    max_new_tokens - 1 `gemma_decode_step`s.  prompt: int [batch, s] ->
    int32 [batch, s + max_new_tokens]."""
    return _generate(params, prompt, cfg, _greedy, max_new_tokens, max_seq,
                     cache_dtype, gemma_prefill, gemma_decode_step)


def gemma_paged_chunk_step(params: dict, tokens: torch.Tensor, cfg,
                           cache: PagedModelCache, mesh=None
                           ) -> tuple[torch.Tensor, PagedModelCache]:
    """The Gemma chunk step over the paged cache: tokens [batch, k] at
    positions lengths .. lengths + k - 1, their K/V appended (in place),
    soft-capped float32 logits [batch, k, vocab].  Attention is
    `paged_prefill` with the soft cap, each local layer within its
    sliding window.  The engine's ``chunk_step`` for the Gemma family.
    ``mesh``: tensor-parallel serving, as in `paged_chunk_step` (shard
    with `gemma.param_shardings`); the tied head is replicated, so the
    logits need no gather."""
    from metal_flash_attention_tpu_torch.models import gemma

    mesh = _tp_mesh(mesh, cfg)
    b, kc = tokens.shape
    positions = cache.lengths.long()[:, None] + torch.arange(
        kc, device=tokens.device)[None, :]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = gemma.embed(params, tokens, cfg)
    for li, layer in enumerate(params["layers"]):
        q, k, v = gemma.attention_qkv(layer, x, cfg, cos, sin)
        layer_cache = paged_append_chunk(
            PagedKVCache(cache.k[li], cache.v[li], cache.page_table,
                         cache.lengths), k, v)
        o = _paged_attn_tp(paged_prefill, mesh, q.to(cfg.dtype),
                           layer_cache, scale=cfg.attn_scale,
                           logit_softcap=cfg.attn_logit_softcap,
                           window_size=gemma.layer_window(cfg, li))
        x = gemma.attention_out(layer, o.transpose(1, 2).reshape(b, kc, -1),
                                x, cfg, mesh=mesh)
        x = gemma.mlp_block(layer, x, cfg, mesh=mesh)
    x = gemma.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return gemma.lm_head(params, x, cfg), cache._replace(
        lengths=cache.lengths + kc)


def gemma_paged_decode_step(params: dict, token: torch.Tensor, cfg,
                            cache: PagedModelCache, mesh=None
                            ) -> tuple[torch.Tensor, PagedModelCache]:
    """One Gemma decode step over the paged cache: token [batch] -> its
    K/V appended at lengths (in place), soft-capped float32 logits
    [batch, vocab] via `paged_decode` with the soft cap (each local layer
    within its sliding window), and the cache with lengths + 1.  The
    engine's ``decode_step`` for the Gemma family.  ``mesh`` as in
    `gemma_paged_chunk_step`."""
    from metal_flash_attention_tpu_torch.models import gemma

    mesh = _tp_mesh(mesh, cfg)
    b = token.shape[0]
    positions = cache.lengths.long()[:, None]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = gemma.embed(params, token[:, None], cfg)
    for li, layer in enumerate(params["layers"]):
        q, k, v = gemma.attention_qkv(layer, x, cfg, cos, sin)
        layer_cache = paged_append_chunk(
            PagedKVCache(cache.k[li], cache.v[li], cache.page_table,
                         cache.lengths), k, v)
        o = _paged_attn_tp(paged_decode, mesh, q[:, :, 0].to(cfg.dtype),
                           layer_cache, scale=cfg.attn_scale,
                           logit_softcap=cfg.attn_logit_softcap,
                           window_size=gemma.layer_window(cfg, li))
        x = gemma.attention_out(layer, o.reshape(b, 1, -1), x, cfg,
                                mesh=mesh)
        x = gemma.mlp_block(layer, x, cfg, mesh=mesh)
    x = gemma.rms_norm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return gemma.lm_head(params, x, cfg), cache._replace(
        lengths=cache.lengths + 1)


class QuantizedPagedModelCache(NamedTuple):
    """Paged model cache whose full pages live quantized (INT8 / FP8 /
    NF4, one scale per (page, kv head)) while each sequence's page in
    progress stays in a tail of the model's dtype.  A page is quantized
    once, when its tail fills (`_flush_full_pages`); per-page scales keep
    pages shareable across sequences."""
    qk: tuple                 # [layers] x [pages, kvh, page (NF4 /2), d]
    qv: tuple
    k_scales: tuple           # [layers] x [pages, kvh] float32
    v_scales: tuple
    tail_k: tuple             # [layers] x [batch, kvh, page, d]
    tail_v: tuple
    page_table: torch.Tensor  # [batch, max_pages] int32
    full_len: torch.Tensor    # [batch] tokens in quantized pages
    tail_len: torch.Tensor    # [batch] tokens in the tail (< page)
    precision: OperandPrecision

    @property
    def lengths(self) -> torch.Tensor:
        return self.full_len + self.tail_len

    @property
    def page_size(self) -> int:
        return self.tail_k[0].shape[2]


def init_quantized_paged_model_cache(
        cfg: llama.LlamaConfig, batch: int, max_seq: int, *, precision,
        page_size: int = 128, num_pages: Optional[int] = None,
        device=None) -> QuantizedPagedModelCache:
    """Zeroed quantized pools (scales 1) and tails, pages assigned
    contiguously (sequence i owns pages i * max_pages ..), on the card
    unless ``device`` says otherwise.  The pools keep head_dim as it is
    (the JAX package pads it to 128 lanes)."""
    precision = as_kv_precision(precision)
    device = resolve_device(device)
    max_pages = -(-max_seq // page_size)
    num_pages = num_pages or batch * max_pages
    rows = page_size // 2 if precision is OperandPrecision.NF4 \
        else page_size
    pool = (num_pages, cfg.n_kv_heads, rows, cfg.head_dim)
    tail = (batch, cfg.n_kv_heads, page_size, cfg.head_dim)
    n = cfg.n_layers

    def zeros(shape, dtype):
        return tuple(torch.zeros(shape, dtype=dtype, device=device)
                     for _ in range(n))

    def ones(shape):
        return tuple(torch.ones(shape, dtype=torch.float32, device=device)
                     for _ in range(n))
    return QuantizedPagedModelCache(
        qk=zeros(pool, precision.storage_dtype),
        qv=zeros(pool, precision.storage_dtype),
        k_scales=ones(pool[:2]), v_scales=ones(pool[:2]),
        tail_k=zeros(tail, cfg.dtype), tail_v=zeros(tail, cfg.dtype),
        page_table=torch.arange(batch * max_pages, dtype=torch.int32,
                                device=device).reshape(batch, max_pages),
        full_len=torch.zeros((batch,), dtype=torch.int32, device=device),
        tail_len=torch.zeros((batch,), dtype=torch.int32, device=device),
        precision=precision)


def _q_layer_cache(cache: QuantizedPagedModelCache,
                   li: int) -> QuantizedPagedKVCache:
    """Layer li's quantized pages, their lengths the full pages'."""
    return QuantizedPagedKVCache(
        cache.qk[li], cache.qv[li], cache.k_scales[li], cache.v_scales[li],
        cache.page_table, cache.full_len, cache.precision)


def _write_tail(tail: torch.Tensor, new: torch.Tensor, start: torch.Tensor,
                active: Optional[torch.Tensor] = None) -> None:
    """tail [batch, kvh, page, d] <- new [batch, kvh, k, d] at positions
    start .. start + k - 1 of each row, IN PLACE; a row whose ``active``
    is False keeps what it held."""
    b, _, kc, _ = new.shape
    pos = start.long()[:, None] + torch.arange(kc, device=new.device)
    rows = torch.arange(b, device=new.device)[:, None].expand(b, kc)
    view = tail.permute(0, 2, 1, 3)             # [b, page, kvh, d]
    vals = new.permute(0, 2, 1, 3).to(tail.dtype)
    if active is not None:
        vals = torch.where(active[:, None, None, None], vals,
                           view[rows, pos])
    view.index_put_((rows, pos), vals)


def _flush_full_pages(cache: QuantizedPagedModelCache, added: torch.Tensor,
                      rows: Optional[torch.Tensor] = None
                      ) -> QuantizedPagedModelCache:
    """Rows whose tail fills after ``added`` more tokens quantize it into
    the pool page `table[row, full_len // page]` (pools and scales IN
    PLACE) and roll (full_len += page, tail_len = 0).

    ``rows`` (int64 on the cache's device) are the rows that may fill
    their tail now, as the caller knows them from its own length mirror;
    None means any row.  Each of them is quantized and written back
    masked by whether it filled (a row that did not, or a frozen one,
    writes its page's old bytes), so the flush has a fixed shape and
    reads nothing back to the host.  The JAX package's jit quantizes
    every row every step; eagerly that is 2 x layers quantizations a
    step, so the engine passes only the rows its mirror says may fill,
    and none on most steps."""
    page = cache.page_size
    new_tail = cache.tail_len + added
    flush = new_tail >= page
    if rows is None:
        rows = torch.arange(flush.shape[0], device=flush.device)
    if rows.numel():
        table = cache.page_table[rows].long()
        idx = (cache.full_len[rows].long() // page).clamp_max(
            table.shape[1] - 1)
        page_ids = table.gather(1, idx[:, None])[:, 0]
        filled = flush[rows]
        for li in range(len(cache.qk)):
            for pool, scales, tail in (
                    (cache.qk[li], cache.k_scales[li], cache.tail_k[li]),
                    (cache.qv[li], cache.v_scales[li], cache.tail_v[li])):
                payload, scale = quantize_page_block(tail[rows],
                                                     cache.precision)
                # As bytes: PyTorch selects and copies no FP8 by index.
                pool_bytes = pool.view(torch.uint8)
                pool_bytes.index_copy_(0, page_ids, torch.where(
                    filled[:, None, None, None], payload.view(torch.uint8),
                    pool_bytes[page_ids]))
                scales.index_copy_(0, page_ids, torch.where(
                    filled[:, None], scale, scales[page_ids]))
    return cache._replace(
        full_len=torch.where(flush, cache.full_len + page, cache.full_len),
        tail_len=torch.where(flush, torch.zeros_like(new_tail), new_tail))


def flush_schedule(tail_len: np.ndarray, active: np.ndarray, page_size: int,
                   n_steps: int) -> list:
    """The rows that may fill their tail at each of ``n_steps`` decode
    steps, from the host's mirror of the tail lengths: an active row
    advances one token a step until it freezes, so it can fill only at
    the steps where tail_len + step + 1 is a whole page.  Returns
    n_steps int64 arrays (the ``flush_rows`` of the quantized steps)."""
    rows = np.flatnonzero(active)
    tail = np.asarray(tail_len)[rows]
    return [rows[(tail + j + 1) % page_size == 0] for j in range(n_steps)]


def paged_chunk_step_q(params: dict, tokens: torch.Tensor,
                       cfg: llama.LlamaConfig,
                       cache: QuantizedPagedModelCache,
                       flush_rows: Optional[torch.Tensor] = None
                       ) -> tuple[torch.Tensor, QuantizedPagedModelCache]:
    """Chunk prefill over the quantized paged cache.  The chunk (at most
    a page, entering with an empty tail: the engine's page-aligned chunks
    give both) writes its K/V into the tail; attention merges by lse
    - the quantized prefix's partial: the chunk's positions folded into
      the head axis of ONE `paged_decode` call ([b, heads * k, d], a GQA
      group of group * k rows; every query attends the whole prefix,
      which ends before the chunk starts), and
    - the causal in-chunk partial (`dispatch.attention`).
    A chunk that fills the page then flushes it (``flush_rows``: see
    `_flush_full_pages`).  Returns float32 logits [batch, k, vocab] and
    the advanced cache."""
    _llama_layers_only(params)
    b, kc = tokens.shape
    positions = cache.lengths.long()[:, None] + torch.arange(
        kc, device=tokens.device)[None, :]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    heads, d = cfg.n_heads, cfg.head_dim
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin)
        _write_tail(cache.tail_k[li], k, cache.tail_len)
        _write_tail(cache.tail_v[li], v, cache.tail_len)
        qd = q.to(cfg.dtype)
        # [b, H, k, d] -> [b, H * k, d] keeps (kv head, group, position)
        # row order, so each folded row maps to its kv head.
        o_pre, lse_pre = paged_decode(qd.reshape(b, heads * kc, d),
                                      _q_layer_cache(cache, li),
                                      return_residuals=True)
        o_ch, lse_ch = dispatch.attention(
            qd, k.to(cfg.dtype), v.to(cfg.dtype), causal=True,
            return_residuals=True)
        o = _merge_partials(o_pre.reshape(b, heads, kc, d).float(),
                            lse_pre.reshape(b, heads, kc), o_ch.float(),
                            lse_ch)
        o = o.to(x.dtype).transpose(1, 2).reshape(b, kc, -1)
        x = x + llama.wo_proj(o, layer).to(x.dtype)
        x = llama.mlp_block(layer, x, cfg)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, _flush_full_pages(
        cache, torch.full_like(cache.tail_len, kc), flush_rows)


def paged_decode_step_q(params: dict, token: torch.Tensor,
                        cfg: llama.LlamaConfig,
                        cache: QuantizedPagedModelCache,
                        active: Optional[torch.Tensor] = None,
                        flush_rows: Optional[torch.Tensor] = None
                        ) -> tuple[torch.Tensor, QuantizedPagedModelCache]:
    """One decode step over the quantized paged cache: the token's K/V
    into the tail (in place), a `paged_decode` partial over the quantized
    pages merged by lse with a `flash_decode` one over the tail, and the
    tail's page flushed when it fills.  ``active`` (bool [batch]): rows
    marked False are frozen (no tail write, no length advance, no
    flush): the engine's ride-along rows, whose per-slot tails have no
    null page to absorb a write.  ``flush_rows``: see
    `_flush_full_pages`.  Returns float32 logits [batch, vocab] and the
    advanced cache."""
    _llama_layers_only(params)
    b = token.shape[0]
    positions = cache.lengths.long()[:, None]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][token.long()][:, None, :].to(cfg.dtype)
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin)
        _write_tail(cache.tail_k[li], k, cache.tail_len, active)
        _write_tail(cache.tail_v[li], v, cache.tail_len, active)
        qv = q[:, :, 0].to(cfg.dtype)
        o_pre, lse_pre = paged_decode(qv, _q_layer_cache(cache, li),
                                      return_residuals=True)
        o_tail, lse_tail = flash_decode(qv, cache.tail_k[li],
                                        cache.tail_v[li],
                                        kv_lens=cache.tail_len + 1,
                                        return_residuals=True)
        o = _merge_partials(o_pre.float(), lse_pre, o_tail.float(),
                            lse_tail)
        x = x + llama.wo_proj(o.to(x.dtype).reshape(b, 1, -1),
                              layer).to(x.dtype)
        x = llama.mlp_block(layer, x, cfg)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
    added = (torch.ones_like(cache.tail_len) if active is None
             else active.to(cache.tail_len.dtype))
    return logits, _flush_full_pages(cache, added, flush_rows)


@torch.inference_mode()
def paged_generate_quantized(params: dict, prompt: torch.Tensor,
                             cfg: llama.LlamaConfig, *,
                             max_new_tokens: int, precision,
                             page_size: int = 128) -> torch.Tensor:
    """Greedy generation entirely over the quantized paged cache: chunked
    prefill, then streaming decode with page flushes.  prompt: [batch, s]
    -> [batch, s + max_new_tokens] int32."""
    b, s = prompt.shape
    cache = init_quantized_paged_model_cache(
        cfg, b, s + max_new_tokens + 1, precision=precision,
        page_size=page_size, device=prompt.device)
    # Every row is at the same length, so the host knows when all of
    # them fill their tail (a whole-page chunk, then every page_size-th
    # decode step) and when none does.
    every = torch.arange(b, device=prompt.device)
    none = every[:0]
    for i in range(0, s, page_size):
        chunk = prompt[:, i:i + page_size]
        logits, cache = paged_chunk_step_q(
            params, chunk, cfg, cache,
            every if chunk.shape[1] == page_size else none)
    live = torch.ones((b,), dtype=torch.bool, device=prompt.device)
    tokens = [prompt.to(torch.int32)]
    token = _greedy(logits[:, -1])
    for i in range(max_new_tokens):
        tokens.append(token[:, None])
        if i + 1 < max_new_tokens:
            fills = (s + i + 1) % page_size == 0
            logits, cache = paged_decode_step_q(
                params, token, cfg, cache, live, every if fills else none)
            token = _greedy(logits)
    return torch.cat(tokens, dim=1)


# ---------------------------------------------------------------------------
# Burst decode: k steps between two host reads
# ---------------------------------------------------------------------------

def _logprob_rows(logits: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    """log P(tok | context) per row under the UNFILTERED distribution of
    ``logits`` (the model's own probability, not the sampler's
    renormalized one)."""
    l = logits.float()
    return l.gather(1, toks.long()[:, None])[:, 0] - torch.logsumexp(
        l, dim=-1)


def _burst_choose(logits, tok, alive, rem, i, *, seed, rids, idx0, temp,
                  top_k, top_p, stop_ids, logit_bias, want_logprobs,
                  sampled=True):
    """The shared tail of both bursts' steps: bias, sample, the unbiased
    logprob, and the emit / stop / budget bookkeeping, all on the device.
    ``sampled`` False (no row samples) makes the choice one argmax, with
    no sort."""
    biased = logits if logit_bias is None else logits + logit_bias
    if sampled:
        nxt = sample_token_per_row(biased, _row_keys(seed, rids, idx0 + i),
                                   temp, top_k, top_p)
    else:
        nxt = _greedy(biased)
    if want_logprobs:
        lp = _logprob_rows(logits, nxt)     # the UNBIASED distribution
    else:
        lp = torch.zeros(nxt.shape, dtype=torch.float32, device=nxt.device)
    emit = alive & (rem > 0)
    hit_stop = (nxt[:, None] == stop_ids).any(dim=-1)
    alive2 = emit & ~hit_stop & (rem > 1)
    return (torch.where(alive2, nxt, tok), alive2, rem - emit.to(rem.dtype),
            torch.where(emit, nxt, -1), emit, lp)


def _burst(step, cache, token, n_steps, active, remaining, **choose):
    """Run ``n_steps`` of step(tok, cache, alive, i) -> (logits, cache)
    with each row's token chosen by `_burst_choose` (keywords
    ``choose``) fed back; returns tokens, valid, logprobs [b, n_steps],
    the cache and the alive mask."""
    tok, alive, rem = token, active, remaining
    outs = []
    for i in range(n_steps):
        logits, cache = step(tok, cache, alive, i)
        tok, alive, rem, out_tok, emit, lp = _burst_choose(
            logits, tok, alive, rem, i, **choose)
        outs.append((out_tok, emit, lp))
    toks, valid, lps = (torch.stack(x, dim=1) for x in zip(*outs))
    return toks, valid, lps, cache, alive


def paged_decode_burst(params: dict, token: torch.Tensor,
                       cfg: llama.LlamaConfig, cache: PagedModelCache, *,
                       n_steps: int, active: torch.Tensor,
                       remaining: torch.Tensor, stop_ids: torch.Tensor,
                       seed: int, rids: torch.Tensor, idx0: torch.Tensor,
                       temp: torch.Tensor, top_k: torch.Tensor,
                       top_p: torch.Tensor, want_logprobs: bool = False,
                       lora=None, lora_ids=None, step_fn=None,
                       logit_bias: Optional[torch.Tensor] = None,
                       sampled: bool = True):
    """``n_steps`` paged decode steps with each row's token fed back on
    the device: no upload and no host read inside, and no shape that
    depends on the data (all n_steps run, as JAX's scan does).

    - ``active`` bool [b]: the rows taking part at entry;
    - ``remaining`` int32 [b]: tokens each row may still emit; a row
      freezes when they run out, or on a stop id;
    - ``stop_ids`` int32 [b, S]: each row's stop ids, -1 padded;
    - sampling as in `sample_token_per_row` (temp 0: greedy), the row
      keys `_row_keys(seed, rids, idx0 + step)`;
    - ``logit_bias`` float32 [b, vocab] or None;
    - ``step_fn``: a family's decode step, step_fn(params, token, cfg,
      cache) -> (logits, cache) (`gemma_paged_decode_step`), in place of
      `paged_decode_step`; LoRA rides only on the default step.

    A row that is not alive rides along as an idle slot of the engine's
    `step()` does: token 0 at length 0 on page 0, and its length stops
    advancing.  So page 0 must be a reserved null page that no sequence
    owns, as the engine's allocator keeps it.  A routed MoE layer counts
    every row against its capacity, so the burst's steps then route as
    `step()`'s (the JAX package's burst keeps a frozen row's token and
    pages).  Returns
    (tokens [b, n_steps] int32, -1 where not emitted; valid [b, n_steps]
    bool; logprobs [b, n_steps] float32; the cache; alive [b])."""
    def step(tok, before, alive, i):
        tok = torch.where(alive, tok, 0)
        seen = before._replace(
            page_table=torch.where(alive[:, None], before.page_table, 0),
            lengths=torch.where(alive, before.lengths, 0))
        if step_fn is not None:
            logits, after = step_fn(params, tok, cfg, seen)
        else:
            logits, after = paged_decode_step(params, tok, cfg, seen,
                                              lora=lora, lora_ids=lora_ids)
        return logits, after._replace(
            page_table=before.page_table,
            lengths=torch.where(alive, after.lengths, before.lengths))

    return _burst(step, cache, token, n_steps, active, remaining, seed=seed,
                  rids=rids, idx0=idx0, temp=temp, top_k=top_k, top_p=top_p,
                  stop_ids=stop_ids, logit_bias=logit_bias,
                  want_logprobs=want_logprobs, sampled=sampled)


def paged_decode_burst_q(params: dict, token: torch.Tensor,
                         cfg: llama.LlamaConfig,
                         cache: QuantizedPagedModelCache, *, n_steps: int,
                         active: torch.Tensor, remaining: torch.Tensor,
                         stop_ids: torch.Tensor, seed: int,
                         rids: torch.Tensor, idx0: torch.Tensor,
                         temp: torch.Tensor, top_k: torch.Tensor,
                         top_p: torch.Tensor, want_logprobs: bool = False,
                         logit_bias: Optional[torch.Tensor] = None,
                         sampled: bool = True,
                         flush_rows: Optional[Sequence] = None):
    """`paged_decode_burst` over the quantized paged cache: each step is
    `paged_decode_step_q` with the alive mask as its ``active`` (a frozen
    row writes no tail, does not advance and does not flush), so a page
    fills and flushes inside the burst as it would across single steps.
    ``flush_rows``: n_steps int64 tensors on the device, each step's
    rows that may fill their tail (`flush_schedule`, uploaded once); None
    lets any row flush at any step.  Returns as `paged_decode_burst`."""
    def step(tok, cache, alive, i):
        return paged_decode_step_q(
            params, tok, cfg, cache, alive,
            None if flush_rows is None else flush_rows[i])

    return _burst(step, cache, token, n_steps, active, remaining, seed=seed,
                  rids=rids, idx0=idx0, temp=temp, top_k=top_k, top_p=top_p,
                  stop_ids=stop_ids, logit_bias=logit_bias,
                  want_logprobs=want_logprobs, sampled=sampled)


# ---------------------------------------------------------------------------
# Speculative decoding
# ---------------------------------------------------------------------------

def _as_drafts(drafts, batch: int, draft_len: int,
               device) -> torch.Tensor:
    """A draft function's proposals (a tensor or a numpy array) as int32
    [batch, draft_len] on ``device``; any other shape is a ValueError."""
    drafts = torch.as_tensor(drafts)
    if tuple(drafts.shape) != (batch, draft_len):
        raise ValueError(f"draft_fn returned shape {tuple(drafts.shape)}, "
                         f"expected {(batch, draft_len)}")
    return drafts.to(device=device, dtype=torch.int32)


def _accepted(drafts: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """Each row's accepted draft count, int32 [b] in 0..kd: the length of
    its longest draft prefix equal to the target's preds [b, kd + 1]
    (the sum of the cumulative product of the matches)."""
    eq = (drafts == preds[:, :drafts.shape[1]]).to(torch.int32)
    return torch.cumprod(eq, dim=1, dtype=torch.int32).sum(dim=1,
                                                            dtype=torch.int32)


def _speculative_round(params, cfg, cache: PagedModelCache,
                       last: torch.Tensor, drafts: torch.Tensor,
                       live: torch.Tensor, chunk_step=None):
    """One verify round: the chunk [last, d_1..d_kd] -> greedy preds
    [b, kd + 1]; the longest draft prefix equal to the preds is
    accepted, then one more target token is emitted (the correction on a
    mismatch, the bonus on a full accept), 1..kd + 1 tokens a row, each
    the plain greedy continuation.

    The chunk writes K/V for all kd + 1 positions (in place); each row's
    length rolls back to what it consumed (base + n_acc + 1), so the
    rejected rows are dead until the next chunk overwrites them (no mask
    reads past a length).  A row with ``live`` False keeps its length,
    its ``last`` and emits 0, so a finished row's pages stop growing: a
    sequence needs s + max_new + 2 (kd + 1) positions at most.

    A draft outside the vocabulary is fed to the model clamped into it
    (it never equals a pred, so it and every position after it are
    rejected, whatever the model saw there).  Returns (emitted [b, kd +
    1] int32, -1 after the last emitted; n_em [b]; next_last [b]; the
    rolled-back cache).  No host read."""
    kd = drafts.shape[1]
    base = cache.lengths
    chunk = torch.cat([last[:, None], drafts], dim=1)
    logits, cache = (chunk_step or paged_chunk_step)(
        params, chunk.clamp(0, params["embed"].shape[0] - 1), cfg, cache)
    preds = _greedy(logits)                                  # [b, kd + 1]
    n_acc = _accepted(drafts, preds)                         # [b] 0..kd
    bonus = preds.gather(1, n_acc.long()[:, None])           # [b, 1]
    slots = torch.arange(kd + 1, device=drafts.device)[None, :]
    accepted = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    emitted = torch.where(slots < n_acc[:, None], accepted,
                          torch.where(slots == n_acc[:, None], bonus, -1))
    next_last = torch.where(live, bonus[:, 0], last)
    n_em = torch.where(live, n_acc + 1, 0).to(torch.int32)
    return emitted.to(torch.int32), n_em, next_last, cache._replace(
        lengths=torch.where(live, base + n_acc + 1, base))


def _scatter_emissions(buf: torch.Tensor, count: torch.Tensor,
                       emitted: torch.Tensor, n_em: torch.Tensor):
    """Each row's n_em emitted tokens into ``buf`` at count ..; the slots
    not emitted write -1 into the last column, the sacrificial one (so a
    row's non -1 entries stay its emitted tokens).  Returns (buf, count +
    n_em), on the device."""
    width = buf.shape[1]
    slots = torch.arange(emitted.shape[1], device=buf.device)[None, :]
    valid = slots < n_em[:, None]
    idx = torch.where(valid, (count[:, None] + slots).clamp_max(width - 1),
                      width - 1)
    buf = buf.scatter(1, idx.long(), torch.where(valid, emitted, -1))
    return buf, count + n_em


def _emission_buffer(last: torch.Tensor, max_new_tokens: int,
                     draft_len: int):
    """The emission buffer [b, max_new + 2 (kd + 1)] (-1, the first token
    in column 0, the last column sacrificial) and its count (1 a row)."""
    b = last.shape[0]
    buf = torch.full((b, max_new_tokens + 2 * (draft_len + 1)), -1,
                     dtype=torch.int32, device=last.device)
    buf[:, 0] = last
    return buf, torch.ones((b,), dtype=torch.int32, device=last.device)


def _prefill_chunks(params, prompt, cfg, cache, page_size, chunk_step=None):
    """The prompt through ``chunk_step`` (default `paged_chunk_step`) in
    page-size chunks; returns the last chunk's logits and the cache."""
    logits = None
    for i in range(0, prompt.shape[1], page_size):
        logits, cache = (chunk_step or paged_chunk_step)(
            params, prompt[:, i:i + page_size], cfg, cache)
    return logits, cache


@torch.inference_mode()
def speculative_generate(params: dict, prompt: torch.Tensor,
                         cfg: llama.LlamaConfig, *, draft_fn,
                         draft_len: int, max_new_tokens: int,
                         page_size: int = 128,
                         chunk_step=None) -> torch.Tensor:
    """Greedy speculative decoding over a paged cache.

    ``draft_fn(last [b], buf [b, T])`` (int32 tensors on the prompt's
    device: the newest token, and the emitted tokens so far, -1 after
    them) proposes [b, draft_len] continuations, as a tensor or a numpy
    array.  The output equals the plain greedy sequence for any draft,
    up to kernel numerics: the verify chunk runs on the paged prefill
    kernel and a plain decode on the decode kernel, so a near-tie of two
    logits can flip an argmax; two speculative runs agree exactly.  Only
    the round count varies.  ``chunk_step``: a family's chunk step
    (`gemma_paged_chunk_step`), for the prompt and every verify chunk.
    The loop reads the host once a round (the smallest count); prompt:
    [b, s] -> [b, s + max_new_tokens] int32."""
    b, s = prompt.shape
    cache = init_paged_model_cache(
        cfg, b, s + max_new_tokens + 2 * (draft_len + 1),
        page_size=page_size, device=prompt.device)
    logits, cache = _prefill_chunks(params, prompt, cfg, cache, page_size,
                                    chunk_step)
    last = _greedy(logits[:, -1])
    buf, count = _emission_buffer(last, max_new_tokens, draft_len)
    while int(count.min()) < max_new_tokens:
        drafts = _as_drafts(draft_fn(last, buf), b, draft_len, prompt.device)
        emitted, n_em, last, cache = _speculative_round(
            params, cfg, cache, last, drafts, count < max_new_tokens,
            chunk_step=chunk_step)
        buf, count = _scatter_emissions(buf, count, emitted, n_em)
    return torch.cat([prompt.to(torch.int32), buf[:, :max_new_tokens]], dim=1)


def _draft_round(draft_params, draft_cfg, cache: PagedModelCache,
                 gained: torch.Tensor, n_gain: torch.Tensor, draft_len: int):
    """The drafter's half of a round: ingest the verified tokens as one
    chunk (``gained`` [b, kd + 1], the first ``n_gain`` of each row
    real), roll the lengths back to the consumed count, then propose
    ``draft_len`` greedy tokens (kd - 1 decode steps) and roll those back
    too, so the drafter's cache only ever commits verified tokens.
    Returns (drafts [b, kd] int32, the cache).  No host read."""
    base = cache.lengths
    logits, cache = paged_chunk_step(draft_params, gained, draft_cfg, cache)
    synced = base + n_gain
    cache = cache._replace(lengths=synced)
    # The next-token logits sit at each row's last consumed position.
    rows = torch.arange(gained.shape[0], device=gained.device)
    row_logits = logits[rows, (n_gain - 1).clamp_min(0).long()]
    drafts = []
    for j in range(draft_len):
        tok = _greedy(row_logits)
        drafts.append(tok)
        if j + 1 < draft_len:
            row_logits, cache = paged_decode_step(draft_params, tok,
                                                  draft_cfg, cache)
    return torch.stack(drafts, dim=1), cache._replace(lengths=synced)


def make_model_draft_fn(draft_params: dict, draft_cfg, *,
                        prompt: torch.Tensor, draft_len: int,
                        max_new_tokens: int, page_size: int = 128):
    """Draft-model speculation for `speculative_generate`: a smaller
    model proposes each round's continuation while keeping its own paged
    cache (s + max_new + 4 (kd + 1) positions a row) in step with the
    verified stream.  Each round it reads the tokens the target emitted
    since its last call from ``buf`` on the host (a ragged 1..kd + 1 a
    row, in numpy, as the JAX package's host API does), ingests them as
    one chunk and drafts (`_draft_round`).

    Returns a stateful ``draft_fn(last, buf)`` for ONE
    `speculative_generate` call over ``prompt`` (the rows keep their
    identity).  Acceptance depends on how well the drafter tracks the
    target; the output never does."""
    b, s = prompt.shape
    kd = draft_len
    with torch.inference_mode():
        cache = init_paged_model_cache(
            draft_cfg, b, s + max_new_tokens + 4 * (kd + 1),
            page_size=page_size, device=prompt.device)
        _, cache = _prefill_chunks(draft_params, prompt, draft_cfg, cache,
                                   page_size)
    state = {"cache": cache, "consumed": np.zeros((b,), np.int64)}

    @torch.inference_mode()
    def draft_fn(last, buf):
        buf_np = torch.as_tensor(buf).cpu().numpy()
        counts = (buf_np != -1).sum(axis=1)
        gained = np.zeros((b, kd + 1), np.int32)
        n_gain = np.zeros((b,), np.int32)
        for r in range(b):
            new = buf_np[r, state["consumed"][r]:counts[r]]
            n_gain[r] = len(new)
            gained[r, :len(new)] = new
            gained[r, len(new):] = new[-1] if len(new) else 0
        state["consumed"] = counts.copy()
        drafts, state["cache"] = _draft_round(
            draft_params, draft_cfg, state["cache"],
            torch.as_tensor(gained, device=prompt.device),
            torch.as_tensor(n_gain, device=prompt.device), kd)
        return drafts

    return draft_fn


def _speculative_burst_rounds(params, cfg, draft_params, draft_cfg,
                              t_cache, d_cache, gained, n_gain, last,
                              buf, count, *, draft_len: int, rounds: int,
                              max_new_tokens: int):
    """``rounds`` full draft + verify rounds with nothing read back to
    the host: the drafter ingests the previous round's verified tokens
    (``gained`` [b, kd + 1], ``n_gain`` [b]) and drafts (`_draft_round`),
    the target verifies (`_speculative_round`), and the emissions go
    into ``buf`` on the device.  A row freezes once its ``count``
    reaches ``max_new_tokens`` (its lengths stop advancing).  JAX's
    `lax.scan` over the rounds is this Python loop.  Returns the carry
    (gained, n_gain, last, t_cache, d_cache, buf, count)."""
    for _ in range(rounds):
        drafts, d_cache = _draft_round(draft_params, draft_cfg, d_cache,
                                       gained, n_gain, draft_len)
        emitted, n_gain, last, t_cache = _speculative_round(
            params, cfg, t_cache, last, drafts, count < max_new_tokens)
        buf, count = _scatter_emissions(buf, count, emitted, n_gain)
        gained = emitted.clamp_min(0)
    return gained, n_gain, last, t_cache, d_cache, buf, count


@torch.inference_mode()
def speculative_generate_model(params: dict, prompt: torch.Tensor,
                               cfg: llama.LlamaConfig, *,
                               draft_params: dict, draft_cfg,
                               draft_len: int, max_new_tokens: int,
                               page_size: int = 128,
                               rounds_per_dispatch: int = 8
                               ) -> torch.Tensor:
    """Greedy speculative decoding with a draft MODEL, in bursts:
    ``rounds_per_dispatch`` draft + verify rounds between two host reads
    (`_speculative_burst_rounds`), so the host reads once per about
    rounds x (accepts + 1) tokens.  The output equals the plain greedy
    sequence for any drafter, with `speculative_generate`'s caveat on
    near-ties.  Use `speculative_generate` with a ``draft_fn`` for a
    drafter that is not a model.  prompt: [b, s] -> [b, s +
    max_new_tokens] int32."""
    b, s = prompt.shape
    kd = draft_len
    budget = s + max_new_tokens + 2 * (kd + 1)
    t_cache = init_paged_model_cache(cfg, b, budget, page_size=page_size,
                                     device=prompt.device)
    # The drafter writes kd - 1 decode rows past its chunk.
    d_cache = init_paged_model_cache(draft_cfg, b, budget + kd,
                                     page_size=page_size,
                                     device=prompt.device)
    logits, t_cache = _prefill_chunks(params, prompt, cfg, t_cache,
                                      page_size)
    _, d_cache = _prefill_chunks(draft_params, prompt, draft_cfg, d_cache,
                                 page_size)
    last = _greedy(logits[:, -1])
    buf, count = _emission_buffer(last, max_new_tokens, kd)
    gained = torch.zeros((b, kd + 1), dtype=torch.int32,
                         device=prompt.device)
    gained[:, 0] = last
    n_gain = torch.ones_like(count)
    while int(count.min()) < max_new_tokens:
        gained, n_gain, last, t_cache, d_cache, buf, count = \
            _speculative_burst_rounds(
                params, cfg, draft_params, draft_cfg, t_cache, d_cache,
                gained, n_gain, last, buf, count, draft_len=kd,
                rounds=rounds_per_dispatch, max_new_tokens=max_new_tokens)
    return torch.cat([prompt.to(torch.int32), buf[:, :max_new_tokens]], dim=1)


# ---------------------------------------------------------------------------
# Beam search
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The k largest of each row of x [rows, n], high to low, equal values
    lowest index first (`lax.top_k`'s order; `torch.topk` promises none
    for ties): a stable descending sort."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def _gather_rows(cache: KVCache, rows: torch.Tensor) -> KVCache:
    """Every layer's K/V rows and the lengths in the order ``rows`` (a
    beam's cache follows its parent)."""
    return KVCache(k=[c.index_select(0, rows) for c in cache.k],
                   v=[c.index_select(0, rows) for c in cache.v],
                   lengths=cache.lengths.index_select(0, rows))


def _beam_step(params, cfg, cache: KVCache, tokens, scores, finished,
               num_beams: int, eos_token: int):
    """One beam-search step over the flattened [batch * beams] cache:
    decode, expand each live beam by the whole vocabulary, keep the top
    num_beams (a finished beam survives as a single frozen candidate:
    eos, its score unchanged), and gather the cache rows by parent beam.
    Returns (cache, tokens [b * k] int32, scores [b, k], finished [b, k],
    parent [b, k])."""
    k = num_beams
    b = tokens.shape[0] // k
    logits, cache = decode_step(params, tokens, cfg, cache)
    logp = torch.log_softmax(logits.float(), dim=-1)
    vocab = logp.shape[-1]
    logp = logp.reshape(b, k, vocab)
    # A Python index written into a device tensor would synchronise.
    frozen = torch.full((vocab,), -torch.inf, device=logp.device).masked_fill(
        torch.arange(vocab, device=logp.device) == eos_token % vocab, 0.0)
    cand = scores[:, :, None] + torch.where(finished[:, :, None], frozen, logp)
    new_scores, idx = _top_k(cand.reshape(b, k * vocab), k)
    parent = idx // vocab
    tok = (idx % vocab).to(torch.int32)
    rows = (torch.arange(b, device=idx.device)[:, None] * k
            + parent).reshape(b * k)
    new_finished = finished.gather(1, parent) | (tok == eos_token)
    return (_gather_rows(cache, rows), tok.reshape(b * k), new_scores,
            new_finished, parent)


def _beam_steps(params, cfg, cache, tokens, scores, finished, seqs,
                gen_len, *, num_beams: int, eos_token: int,
                max_new_tokens: int):
    """Steps 1 .. max_new_tokens - 1 of the search (the loop the JAX
    package scans), the history ``seqs`` [b, k, max_new] and ``gen_len``
    [b, k] gathered by parent on the device, eos written after a beam
    finishes.  No host read."""
    b, k = scores.shape
    for t in range(1, max_new_tokens):
        cache, tokens, scores, new_finished, parent = _beam_step(
            params, cfg, cache, tokens, scores, finished,
            num_beams=num_beams, eos_token=eos_token)
        seqs = seqs.gather(1, parent[:, :, None].expand(-1, -1,
                                                        seqs.shape[2]))
        gen_len = gen_len.gather(1, parent)
        was_finished = finished.gather(1, parent)
        seqs[:, :, t] = torch.where(was_finished, eos_token,
                                    tokens.reshape(b, k))
        gen_len = torch.where(new_finished & ~was_finished, t + 1, gen_len)
        finished = new_finished
    return cache, tokens, scores, finished, seqs, gen_len


@torch.inference_mode()
def beam_generate(params: dict, prompt: torch.Tensor,
                  cfg: llama.LlamaConfig, *, num_beams: int,
                  max_new_tokens: int, eos_token: Optional[int] = None,
                  length_penalty: float = 1.0,
                  max_seq: Optional[int] = None):
    """Beam search over the dense KV cache (HF ``num_beams`` semantics).

    `prefill` runs once at batch b; its cache is repeated k-fold along
    the batch and the beams ride as batch rows ([b * k] `decode_step`s,
    cache rows gathered by parent beam each step).  A beam that emits
    ``eos_token`` freezes: its score stops accumulating and it survives
    as one candidate.  Every search runs exactly ``max_new_tokens``
    steps (no early stop, no host read inside), and the hypotheses are
    ranked at the end, on the host, by score / len(generated) **
    length_penalty.  Returns (sequences [b, k, s + max_new] int32,
    scores [b, k] float32) on the prompt's device, best beam first;
    positions after a beam's eos hold ``eos_token``."""
    b, s = prompt.shape
    k = num_beams
    eos = -1 if eos_token is None else int(eos_token)
    dev = prompt.device
    cache = init_cache(cfg, b, max_seq or (s + max_new_tokens), device=dev)
    logits, cache = prefill(params, prompt, cfg, cache)
    scores, tok0 = _top_k(torch.log_softmax(logits.float(), dim=-1), k)
    tok0 = tok0.to(torch.int32)
    cache = KVCache(k=[c.repeat_interleave(k, dim=0) for c in cache.k],
                    v=[c.repeat_interleave(k, dim=0) for c in cache.v],
                    lengths=cache.lengths.repeat_interleave(k, dim=0))
    finished = tok0 == eos
    seqs = torch.zeros((b, k, max_new_tokens), dtype=torch.int32, device=dev)
    seqs[:, :, 0] = tok0
    gen_len = torch.where(finished, 1, max_new_tokens).to(torch.int32)
    _, _, scores, _, seqs, gen_len = _beam_steps(
        params, cfg, cache, tok0.reshape(b * k), scores, finished, seqs,
        gen_len, num_beams=k, eos_token=eos, max_new_tokens=max_new_tokens)
    scores, gen_len, seqs = (x.cpu().numpy() for x in (scores, gen_len, seqs))
    final = scores.astype(np.float32) / np.maximum(gen_len, 1).astype(
        np.float32) ** length_penalty
    order = np.argsort(-final, axis=1)
    final = np.take_along_axis(final, order, axis=1)
    seqs = np.take_along_axis(seqs, order[:, :, None], axis=1)
    full = np.concatenate(
        [np.broadcast_to(prompt.cpu().numpy().astype(np.int32)[:, None, :],
                         (b, k, s)), seqs], axis=2)
    return torch.as_tensor(full, device=dev), torch.as_tensor(final,
                                                              device=dev)
