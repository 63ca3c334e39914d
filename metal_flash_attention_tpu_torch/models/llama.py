"""Llama-3-style transformer blocks in PyTorch.

The port of the JAX package's `models/llama.py` pieces that serving
runs: the configuration, parameter init, RMSNorm, rotary embeddings
(with the Llama-3.1 frequency scaling) and the SwiGLU MLP.  Parameters
are a plain dict of tensors with the JAX package's names and layouts
(projections stored [in, out], so a layer is ``x @ w``).

The training-side functions (`forward`, `attention_block`, `loss_fn`,
`train_step`) come with the training slice (ROADMAP.md).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F


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
    ``cfg.dtype``; norms are ones.  ``generator`` must live on
    ``device`` (a CUDA generator for CUDA parameters)."""
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
