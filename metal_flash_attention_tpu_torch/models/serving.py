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
  upload inside the k steps.

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
from metal_flash_attention_tpu_torch.models import llama
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.utils.errors import not_ported
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
    b, s = tokens.shape
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    for li, layer in enumerate(params["layers"]):
        x, (k, v) = llama.attention_block(layer, x, cfg, cos, sin)
        cache.k[li][:, :, :s] = k
        cache.v[li][:, :, :s] = v
        del k, v
        x = _ffn_block(layer, x, cfg)
    x = llama.rms_norm(x[:, -1], params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, cache._replace(lengths=torch.full_like(cache.lengths, s))


def decode_step(params: dict, token: torch.Tensor, cfg: llama.LlamaConfig,
                cache: KVCache) -> tuple[torch.Tensor, KVCache]:
    """One decode step: token [batch] -> its K/V written at each
    sequence's length (in place), float32 logits [batch, vocab] through
    `flash_decode`, and the cache with lengths + 1.  With
    ``cfg.sliding_window`` w each row attends its last w positions."""
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
        x = x + _wo_proj(o.reshape(b, 1, -1), layer).to(x.dtype)
        x = _ffn_block(layer, x, cfg)
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
              cache_dtype) -> torch.Tensor:
    """The dense loop: each new token is pick(float32 logits [batch,
    vocab])."""
    b, s = prompt.shape
    cache = init_cache(cfg, b, max_seq or (s + max_new_tokens),
                       dtype=cache_dtype, device=prompt.device)
    logits, cache = prefill(params, prompt, cfg, cache)
    tokens = [prompt.to(torch.int32)]
    token = pick(logits)
    for i in range(max_new_tokens):
        tokens.append(token[:, None])
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, token, cfg, cache)
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
        x = x + _wo_proj(o.to(x.dtype).reshape(b, 1, -1), layer).to(x.dtype)
        x = _ffn_block(layer, x, cfg)
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


def _wo_proj(o: torch.Tensor, layer: dict) -> torch.Tensor:
    return o @ layer["wo"]


def _ffn_block(layer: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    """Dense SwiGLU MLP.  Mixture-of-experts layers are not ported."""
    if "moe" in layer:
        raise not_ported("mixture-of-experts FFN layers", "MoE")
    return llama.mlp_block(layer, x, cfg)


def _check_unported(mesh, lora) -> None:
    if mesh is not None:
        raise not_ported("tensor-parallel serving (mesh=)",
                         "tensor-parallel serving")
    if lora is not None:
        raise not_ported("multi-adapter LoRA", "LoRA")


def paged_chunk_step(params: dict, tokens: torch.Tensor,
                     cfg: llama.LlamaConfig, cache: PagedModelCache,
                     mesh=None, lora=None, lora_ids=None
                     ) -> tuple[torch.Tensor, PagedModelCache]:
    """Consume a chunk of tokens [batch, k] at positions
    lengths .. lengths + k - 1: write their K/V into the pools (in
    place) and return float32 logits [batch, k, vocab] with the advanced
    cache.  Attention is `paged_prefill` (causal at each query's
    position, ragged lengths per sequence)."""
    _check_unported(mesh, lora)
    b, kc = tokens.shape
    positions = cache.lengths.long()[:, None] + torch.arange(
        kc, device=tokens.device)[None, :]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][tokens.long()].to(cfg.dtype)
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin)
        layer_cache = paged_append_chunk(
            PagedKVCache(cache.k[li], cache.v[li], cache.page_table,
                         cache.lengths), k, v)
        o = paged_prefill(q.to(cfg.dtype), layer_cache,
                          window_size=cfg.sliding_window)
        o = o.transpose(1, 2).reshape(b, kc, -1)
        x = x + _wo_proj(o, layer).to(x.dtype)
        x = _ffn_block(layer, x, cfg)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"]).float()
    return logits, cache._replace(lengths=cache.lengths + kc)


def paged_decode_step(params: dict, token: torch.Tensor,
                      cfg: llama.LlamaConfig, cache: PagedModelCache,
                      mesh=None, lora=None, lora_ids=None
                      ) -> tuple[torch.Tensor, PagedModelCache]:
    """One decode step: token [batch] -> its K/V appended at lengths
    (in place), float32 logits [batch, vocab] via `paged_decode`, and
    the cache with lengths + 1."""
    _check_unported(mesh, lora)
    b = token.shape[0]
    positions = cache.lengths.long()[:, None]
    cos, sin = llama.rope_frequencies(cfg, positions)
    x = params["embed"][token.long()][:, None, :].to(cfg.dtype)
    for li, layer in enumerate(params["layers"]):
        q, k, v = llama.attention_qkv(layer, x, cfg, cos, sin)
        layer_cache = paged_append_chunk(
            PagedKVCache(cache.k[li], cache.v[li], cache.page_table,
                         cache.lengths), k, v)
        o = paged_decode(q[:, :, 0].to(cfg.dtype), layer_cache,
                         window_size=cfg.sliding_window)
        o = o.reshape(b, 1, -1)
        x = x + _wo_proj(o, layer).to(x.dtype)
        x = _ffn_block(layer, x, cfg)
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, 0] @ params["lm_head"]).float()
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
    for i in range(0, s, page_size):
        logits, cache = paged_chunk_step(params, prompt[:, i:i + page_size],
                                         cfg, cache)
    tokens = [prompt.to(torch.int32)]
    token = _greedy(logits[:, -1])
    for i in range(max_new_tokens):
        tokens.append(token[:, None])
        if i + 1 < max_new_tokens:
            logits, cache = paged_decode_step(params, token, cfg, cache)
            token = _greedy(logits)
    return torch.cat(tokens, dim=1)


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
        x = x + _wo_proj(o, layer).to(x.dtype)
        x = _ffn_block(layer, x, cfg)
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
        x = x + _wo_proj(o.to(x.dtype).reshape(b, 1, -1), layer).to(x.dtype)
        x = _ffn_block(layer, x, cfg)
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
                       lora=None, lora_ids=None,
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
    - ``logit_bias`` float32 [b, vocab] or None.

    A frozen row's length stops advancing; its write lands at its frozen
    length, which nothing reads.  Returns (tokens [b, n_steps] int32, -1
    where not emitted; valid [b, n_steps] bool; logprobs [b, n_steps]
    float32; the cache; alive [b])."""
    def step(tok, before, alive, i):
        logits, after = paged_decode_step(params, tok, cfg, before,
                                          lora=lora, lora_ids=lora_ids)
        return logits, after._replace(lengths=torch.where(
            alive, after.lengths, before.lengths))

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
