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
- `generate`: the greedy loop over the two;
- `sink_decode`: attention-sink decode, two `flash_decode` partials
  merged by `_merge_partials`.

Paged (a page pool shared by the sequences):

- `paged_chunk_step`: a chunk of tokens per sequence (prompt prefill,
  chunk by chunk) -> its K/V appended to the pools and per-position
  logits; attention is `ops.paged_attention.paged_prefill`;
- `paged_decode_step`: one token per sequence -> its K/V appended and
  the next-token logits; attention is `paged_decode`;
- `paged_generate`: greedy generation over the two.

Caches and pools are updated IN PLACE (the JAX package donates them
instead); each step returns a cache whose lengths moved on and whose
tensors are the same.  Large products stay `torch.matmul`, as the JAX
package leaves them to XLA; only attention is a hand-written kernel on
the card.  Not ported yet: the quantized dense cache
(`quantize_cache`, `decode_step_quantized`) and sampling
(`generate_sampled`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from metal_flash_attention_tpu_torch.models import llama
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.utils.errors import not_ported
from metal_flash_attention_tpu_torch.ops.flash_decode import (
    flash_decode,
    write_rows,
)
from metal_flash_attention_tpu_torch.ops.paged_attention import (
    PagedKVCache,
    paged_append_chunk,
    paged_decode,
    paged_prefill,
)


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


@torch.inference_mode()
def generate(params: dict, prompt: torch.Tensor, cfg: llama.LlamaConfig, *,
             max_new_tokens: int, max_seq: Optional[int] = None,
             cache_dtype=None) -> torch.Tensor:
    """Greedy generation: `prefill`, then max_new_tokens - 1
    `decode_step`s (the last token needs no forward).  prompt: int
    [batch, s] -> int32 [batch, s + max_new_tokens].  The cache holds
    ``max_seq`` positions (default s + max_new_tokens) on the prompt's
    device."""
    b, s = prompt.shape
    cache = init_cache(cfg, b, max_seq or (s + max_new_tokens),
                       dtype=cache_dtype, device=prompt.device)
    logits, cache = prefill(params, prompt, cfg, cache)
    tokens = [prompt.to(torch.int32)]
    token = logits.argmax(dim=-1).to(torch.int32)
    for i in range(max_new_tokens):
        tokens.append(token[:, None])
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, token, cfg, cache)
            token = logits.argmax(dim=-1).to(torch.int32)
    return torch.cat(tokens, dim=1)


def quantize_cache(cache: KVCache, precision, tail_capacity: int = 128):
    raise not_ported("quantize_cache (quantized dense KV)", "quantized KV")


def decode_step_quantized(params: dict, token: torch.Tensor, cfg, cache):
    raise not_ported("decode_step_quantized (quantized dense KV)",
                     "quantized KV")


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
    token = logits[:, -1].argmax(dim=-1).to(torch.int32)
    for i in range(max_new_tokens):
        tokens.append(token[:, None])
        if i + 1 < max_new_tokens:
            logits, cache = paged_decode_step(params, token, cfg, cache)
            token = logits.argmax(dim=-1).to(torch.int32)
    return torch.cat(tokens, dim=1)
