"""Llama-3-style transformer in PyTorch.

The port of the JAX package's `models/llama.py`: the configuration,
parameter init, RMSNorm, rotary embeddings (with the Llama-3.1
frequency scaling), GQA attention through the descriptor facade
(`dispatch.attention` -> the fused flash-attention kernels), the SwiGLU
MLP, and the training objective (`forward_hidden`, `forward`, `loss_fn`
with the fused chunked cross-entropy, and the SGD demo `train_step`).
Parameters are a plain dict of tensors with the JAX package's names and
layouts (projections stored [in, out], so a layer is ``x @ w``).

Large products stay `torch.matmul`, as the JAX package leaves them to
XLA; only attention is a hand-written kernel on the card.  Not ported
yet: sharded attention (``mesh=``) and LoRA deltas (``lora=``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metal_flash_attention_tpu_torch import dispatch
from metal_flash_attention_tpu_torch.models.losses import fused_cross_entropy
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.utils.errors import not_ported
from metal_flash_attention_tpu_torch.utils.tree import flatten


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    # Llama-3.1 RoPE frequency scaling ("rope_type: llama3"); None = off.
    rope_scaling_factor: Optional[float] = None
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    # Mistral-style sliding-window attention on every layer.
    sliding_window: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        """Test-scale config."""
        defaults = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=256)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        return LlamaConfig(**kw)


def init_params(cfg: LlamaConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters: normal / sqrt(fan_in) in float32, cast to
    ``cfg.dtype``; norms are ones.  ``device=None`` means the card;
    ``generator`` must live on the same device (a CUDA generator for
    CUDA parameters)."""
    device = resolve_device(device)

    def dense(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w / math.sqrt(shape[0])).to(cfg.dtype)

    def ones():
        return torch.ones((cfg.dim,), dtype=torch.float32, device=device)

    qkv = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    layers = [{
        "wq": dense((cfg.dim, qkv)),
        "wk": dense((cfg.dim, kv)),
        "wv": dense((cfg.dim, kv)),
        "wo": dense((qkv, cfg.dim)),
        "w_gate": dense((cfg.dim, cfg.hidden_dim)),
        "w_up": dense((cfg.dim, cfg.hidden_dim)),
        "w_down": dense((cfg.hidden_dim, cfg.dim)),
        "attn_norm": ones(),
        "mlp_norm": ones(),
    } for _ in range(cfg.n_layers)]
    return {
        "embed": dense((cfg.vocab_size, cfg.dim)),
        "layers": layers,
        "final_norm": ones(),
        "lm_head": dense((cfg.dim, cfg.vocab_size)),
    }


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    """RMSNorm in float32, cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight).to(x.dtype)


def rope_frequencies(cfg: LlamaConfig, positions: torch.Tensor):
    """positions [..., seq] -> (cos, sin) [..., seq, head_dim / 2].

    With ``rope_scaling_factor`` set, applies the Llama-3.1 rule:
    wavelengths longer than orig_max / low_freq_factor divide by the
    factor, those shorter than orig_max / high_freq_factor keep, and the
    band between interpolates by the smoothing coefficient."""
    half = cfg.head_dim // 2
    freqs = cfg.rope_theta ** (
        -torch.arange(0, half, dtype=torch.float32,
                      device=positions.device) / half)
    if cfg.rope_scaling_factor is not None:
        factor = float(cfg.rope_scaling_factor)
        lo_f = float(cfg.rope_low_freq_factor)
        hi_f = float(cfg.rope_high_freq_factor)
        orig = float(cfg.rope_original_max_position)
        wavelen = 2.0 * math.pi / freqs
        smooth = ((orig / wavelen - lo_f) / (hi_f - lo_f)).clamp(0.0, 1.0)
        freqs = torch.where(
            wavelen > orig / lo_f, freqs / factor,
            torch.where(wavelen < orig / hi_f, freqs,
                        (1.0 - smooth) * freqs / factor + smooth * freqs))
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x: [batch, heads, seq, head_dim]; rotate pairs (split-half)."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, None, :, :]
    s = sin[:, None, :, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c],
                     dim=-1).to(x.dtype)


def mlp_block(layer: dict, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """Residual SwiGLU MLP; the SiLU and the gate product in float32."""
    h = rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
    gate = F.silu((h @ layer["w_gate"]).float())
    up = (h @ layer["w_up"]).float()
    return x + ((gate * up).to(x.dtype) @ layer["w_down"]).to(x.dtype)


def attention_qkv(layer: dict, x: torch.Tensor, cfg: LlamaConfig, cos, sin):
    """norm -> QKV projections (+ Qwen2-style bias) -> rope.  Returns
    q [b, q_heads, s, d] and k/v [b, kv_heads, s, d]."""
    b, s, _ = x.shape
    h = rms_norm(x, layer["attn_norm"], cfg.norm_eps)

    def proj(name):
        y = h @ layer[name]
        bias = layer.get("b" + name[1:])
        return y if bias is None else y + bias.to(y.dtype)
    q = proj("wq").reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = proj("wk").reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = proj("wv").reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def attention_block(layer: dict, x: torch.Tensor, cfg: LlamaConfig, cos,
                    sin, kv_cache: Optional[tuple] = None, mesh=None,
                    lora_layer: Optional[dict] = None, lora_ids=None):
    """x: [batch, seq, dim] -> (x + attention, (k, v)).

    With ``kv_cache = (k_prefix, v_prefix)`` the new K/V are appended to
    the prefix and attention spans all of it (causal, bottom-right)."""
    if mesh is not None:
        raise not_ported("sharded attention (mesh=)",
                         "tensor-parallel serving")
    if lora_layer is not None:
        raise not_ported("LoRA deltas (lora=)", "LoRA")
    b, s, _ = x.shape
    q, k, v = attention_qkv(layer, x, cfg, cos, sin)
    if kv_cache is not None:
        k = torch.cat([kv_cache[0], k], dim=2)
        v = torch.cat([kv_cache[1], v], dim=2)
    o = dispatch.attention(q, k, v, causal=True,
                           window_size=cfg.sliding_window)
    y = o.transpose(1, 2).reshape(b, s, -1) @ layer["wo"]
    return x + y.to(x.dtype), (k, v)


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   kv_caches: Optional[list] = None, mesh=None,
                   lora: Optional[dict] = None, lora_ids=None,
                   remat: bool = False):
    """tokens [batch, seq] -> (final-norm hidden states [batch, seq,
    dim], per-layer (k, v)): everything before the lm head, so the loss
    can fuse the head into its chunked cross-entropy.

    ``remat=True`` checkpoints each layer (`torch.utils.checkpoint`,
    non-reentrant): the backward recomputes the layer's activations, so
    attention's forward kernel runs twice per layer and step."""
    if lora is not None:
        raise not_ported("LoRA deltas (lora=)", "LoRA")
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = rope_frequencies(cfg, positions)
    x = params["embed"][tokens.long()].to(cfg.dtype)

    def one_layer(layer, x, cache):
        x, kv = attention_block(layer, x, cfg, cos, sin, kv_cache=cache,
                                mesh=mesh)
        return mlp_block(layer, x, cfg), kv

    new_caches = []
    for i, layer in enumerate(params["layers"]):
        cache = kv_caches[i] if kv_caches is not None else None
        if remat:
            x, kv = checkpoint(one_layer, layer, x, cache,
                               use_reentrant=False)
        else:
            x, kv = one_layer(layer, x, cache)
        new_caches.append(kv)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), new_caches


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, **kw):
    """tokens [batch, seq] -> (float32 logits [batch, seq, vocab],
    per-layer (k, v))."""
    x, new_caches = forward_hidden(params, tokens, cfg, **kw)
    return (x @ params["lm_head"]).float(), new_caches


def loss_fn(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
            fused_ce: bool = True, **kw) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [batch, seq].

    ``fused_ce`` (the default) runs the lm head inside the chunked
    cross-entropy (`models.losses`), never holding the [batch * seq,
    vocab] logits; ``fused_ce=False`` materialises them."""
    targets = tokens[:, 1:]
    if fused_ce:
        x, _ = forward_hidden(params, tokens[:, :-1], cfg, **kw)
        nll = fused_cross_entropy(x.reshape(-1, x.shape[-1]),
                                  params["lm_head"], targets.reshape(-1))
        return nll.mean()
    logits, _ = forward(params, tokens[:, :-1], cfg, **kw)
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, targets[..., None].long()).mean()


def train_step(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
               lr: float = 1e-4, **kw):
    """One SGD step, out of place: returns (new_params, loss).  Each
    update is taken in float32 and rounded to the parameter's dtype."""
    leaves, rebuild = flatten(params)
    work = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(rebuild(work), tokens, cfg, **kw)
    grads = torch.autograd.grad(loss, work)
    with torch.no_grad():
        new = [(p.float() - lr * g.float()).to(p.dtype)
               for p, g in zip(leaves, grads)]
    return rebuild(new), loss.detach()
