"""Paged serving steps for the Llama family (PyTorch).

The port of the paged part of the JAX package's `models/serving.py`:

- `paged_chunk_step`: a chunk of tokens per sequence (prompt prefill,
  chunk by chunk) -> its K/V appended to the pools and per-position
  logits; attention is `ops.paged_attention.paged_prefill`;
- `paged_decode_step`: one token per sequence -> its K/V appended and
  the next-token logits; attention is `paged_decode`;
- `paged_generate`: greedy generation over the two.

The pools are updated IN PLACE (the JAX package donates them instead);
each step returns a cache whose lengths moved on and whose pools are the
same tensors.  Large products stay `torch.matmul`, as the JAX package
leaves them to XLA; only attention is a hand-written kernel on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from metal_flash_attention_tpu_torch.models import llama
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.utils.errors import not_ported
from metal_flash_attention_tpu_torch.ops.paged_attention import (
    PagedKVCache,
    paged_append_chunk,
    paged_decode,
    paged_prefill,
)


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
