"""Gemma-2 transformer in PyTorch.

The port of the JAX package's `models/gemma.py`, the second model family
and the one that runs the kernel options Llama does not:

- alternating local and global attention: even layers attend through a
  sliding window (``sliding_window``), odd layers causally over
  everything;
- logit soft-capping: cap * tanh(s / cap) on the attention logits (in
  the kernels, ``attn_logit_softcap``) and on the final logits
  (``final_logit_softcap``);
- head_dim 256 with 8 query and 4 KV heads at `gemma2_2b`;
- Gemma's conventions: RMSNorm with a (1 + w) gain, norms before and
  after both attention and the MLP, a GeGLU MLP (tanh GELU), the
  embedding scaled by sqrt(dim), and the embedding tied to the LM head.

Attention goes through `dispatch.attention` (the fused forward and its
atomic-free backward, both of which take the soft cap and head_dim 256),
as in the JAX package, so the model serves and trains (`loss_fn`: the
fused chunked cross-entropy over the tied head with the final cap;
`train_step`: plain SGD).  Parameters are a plain dict of tensors with
the JAX package's names and layouts (projections [in, out]; norm gains
float32).  Large products stay `torch.matmul`.  `param_shardings` and
the blocks' ``mesh=`` serve over a tensor-parallel mesh (the paged steps
in `models.serving`): each row-parallel partial is summed across the
ranks BEFORE the post-attention / post-MLP norm, since a norm of a
partial sum is not the norm of the sum.  Data- and head-parallel
training takes ``mesh=`` in `attention_block`, `forward_hidden`,
`loss_fn` and `train_step` as `models.llama` does (the JAX package's
``shard_map`` over P(data, heads) at its `attention_block`): the normed
inputs of the column blocks through `parallel.mesh.column_parallel_input`,
the partials summed before the post-norms, every parameter through
`data_replicated` and the loss through `data_mean`.  The tied head reads
the replicated embedding, so the loss needs no gather.  A context axis
leaves the sequence whole, as the JAX package's specs do (its Gemma has
no ring path): every context rank computes the same loss and gradients.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metal_flash_attention_tpu_torch import dispatch
from metal_flash_attention_tpu_torch.models.llama import (
    apply_rope,
    rope_frequencies,
)
from metal_flash_attention_tpu_torch.models.losses import fused_cross_entropy
from metal_flash_attention_tpu_torch.models.optim import sgd_step
from metal_flash_attention_tpu_torch.parallel.mesh import (
    HEAD_AXIS,
    P,
    check_mesh,
    column_parallel_input,
    data_mean,
    data_replicated,
    row_parallel_sum,
)
from metal_flash_attention_tpu_torch.utils.device import resolve_device

# The fused cross-entropy's vocabulary chunk (the JAX package's).
CE_CHUNK = 8192


@dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 256128
    dim: int = 2304
    n_layers: int = 26
    n_heads: int = 8
    n_kv_heads: int = 4
    head_dim: int = 256
    hidden_dim: int = 9216
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    sliding_window: int = 4096
    attn_logit_softcap: Optional[float] = 50.0
    final_logit_softcap: Optional[float] = 30.0
    # Gemma-2 27B scales queries by 1/sqrt(query_pre_attn_scalar), not
    # 1/sqrt(head_dim).
    query_pre_attn_scalar: Optional[float] = None
    dtype: torch.dtype = torch.bfloat16

    @property
    def attn_scale(self) -> float:
        s = self.query_pre_attn_scalar or self.head_dim
        return 1.0 / math.sqrt(s)

    @staticmethod
    def tiny(**kw) -> "GemmaConfig":
        """Test-scale config (a window below the tests' prompts)."""
        defaults = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, head_dim=32, hidden_dim=256,
                        sliding_window=64)
        defaults.update(kw)
        return GemmaConfig(**defaults)

    @staticmethod
    def gemma2_2b(**kw) -> "GemmaConfig":
        return GemmaConfig(**kw)


def is_local_layer(i: int) -> bool:
    """Gemma-2's alternation: even layers sliding-window, odd global."""
    return i % 2 == 0


def layer_window(cfg: GemmaConfig, i: int) -> Optional[int]:
    """Layer i's attention window: the sliding window on a local layer,
    None on a global one."""
    return cfg.sliding_window if is_local_layer(i) else None


def init_params(cfg: GemmaConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters: normal / sqrt(fan_in) in float32, cast to
    ``cfg.dtype``; norm gains are zeros (a gain of 1 + 0), in float32.
    ``device=None`` means the card; ``generator`` must live on the same
    device."""
    device = resolve_device(device)

    def dense(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (w / math.sqrt(shape[0])).to(cfg.dtype)

    def gain():
        return torch.zeros((cfg.dim,), dtype=torch.float32, device=device)

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
        "pre_attn_norm": gain(),
        "post_attn_norm": gain(),
        "pre_mlp_norm": gain(),
        "post_mlp_norm": gain(),
    } for _ in range(cfg.n_layers)]
    return {
        # Tied embedding and LM head.
        "embed": dense((cfg.vocab_size, cfg.dim)),
        "layers": layers,
        "final_norm": gain(),
    }


def param_shardings(cfg: GemmaConfig, mesh) -> dict:
    """Tensor-parallel layout over the heads axis, a `PartitionSpec` per
    leaf: wq / wk / wv / w_gate / w_up column-parallel, wo / w_down
    row-parallel, the norms and the tied embedding replicated (so the
    head needs no gather)."""
    check_mesh(mesh)
    col, row, rep = P(None, HEAD_AXIS), P(HEAD_AXIS, None), P()
    layer = {
        "wq": col, "wk": col, "wv": col, "wo": row,
        "w_gate": col, "w_up": col, "w_down": row,
        "pre_attn_norm": rep, "post_attn_norm": rep,
        "pre_mlp_norm": rep, "post_mlp_norm": rep,
    }
    return {
        "embed": rep,
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": rep,
    }


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """Gemma RMSNorm in float32, the gain applied as (1 + w), cast back to
    x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * (1.0 + w)).to(x.dtype)


def embed(params: dict, tokens: torch.Tensor,
          cfg: GemmaConfig) -> torch.Tensor:
    """Token embeddings in the model dtype, scaled by sqrt(dim) rounded
    to that dtype (Gemma's scaling)."""
    x = params["embed"][tokens.long()].to(cfg.dtype)
    return x * torch.tensor(math.sqrt(cfg.dim), dtype=cfg.dtype,
                            device=x.device)


def final_softcap(logits: torch.Tensor, cfg: GemmaConfig) -> torch.Tensor:
    """cap * tanh(logits / cap) with the final-logit cap, if any."""
    cap = cfg.final_logit_softcap
    return logits if cap is None else cap * torch.tanh(logits / cap)


def lm_head(params: dict, x: torch.Tensor, cfg: GemmaConfig) -> torch.Tensor:
    """Final-norm hidden states -> soft-capped float32 logits (the tied
    head)."""
    return final_softcap((x @ params["embed"].T).float(), cfg)


def attention_qkv(layer: dict, x: torch.Tensor, cfg: GemmaConfig, cos, sin,
                  mesh=None):
    """pre_attn_norm -> QKV projections -> rope.  Returns q [b, q_heads,
    s, d] and k/v [b, kv_heads, s, d]; with a rank's column blocks of the
    projections, its own heads (with ``mesh``, the normed input enters
    them through `column_parallel_input`)."""
    b, s, _ = x.shape
    h = column_parallel_input(
        rms_norm(x, layer["pre_attn_norm"], cfg.norm_eps), mesh)
    q = (h @ layer["wq"]).reshape(b, s, -1, cfg.head_dim)
    k = (h @ layer["wk"]).reshape(b, s, -1, cfg.head_dim)
    v = (h @ layer["wv"]).reshape(b, s, -1, cfg.head_dim)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def attention_out(layer: dict, o: torch.Tensor, x: torch.Tensor,
                  cfg: GemmaConfig, mesh=None) -> torch.Tensor:
    """Attention's output o [b, s, q_heads * d] through wo and
    post_attn_norm, added to the residual x.  With ``mesh``, o holds this
    rank's heads and wo its row block: the partials are summed over the
    heads axis before the norm."""
    o = row_parallel_sum(o @ layer["wo"], mesh).to(x.dtype)
    return x + rms_norm(o, layer["post_attn_norm"], cfg.norm_eps)


def attention_block(layer: dict, x: torch.Tensor, cfg: GemmaConfig, cos,
                    sin, *, window: Optional[int],
                    kv_cache: Optional[tuple] = None, mesh=None):
    """x [batch, seq, dim] -> (x + attention, (k, v)); causal, within
    ``window`` when given, the logits soft-capped.  With ``kv_cache =
    (k_prefix, v_prefix)`` the new K/V are appended to the prefix.  With
    ``mesh`` the layer holds this rank's blocks and x its data-axis rows
    (module docstring)."""
    if mesh is not None:
        check_mesh(mesh)
    b, s, _ = x.shape
    q, k, v = attention_qkv(layer, x, cfg, cos, sin, mesh)
    if kv_cache is not None:
        k = torch.cat([kv_cache[0], k], dim=2)
        v = torch.cat([kv_cache[1], v], dim=2)
    o = dispatch.attention(q, k, v, causal=True, window_size=window,
                           scale=cfg.attn_scale,
                           logit_softcap=cfg.attn_logit_softcap)
    return attention_out(layer, o.transpose(1, 2).reshape(b, s, -1), x,
                         cfg, mesh), (k, v)


def mlp_block(layer: dict, x: torch.Tensor, cfg: GemmaConfig,
              mesh=None) -> torch.Tensor:
    """Residual GeGLU MLP: the tanh GELU and the gate product in float32,
    the down projection in the model dtype, then post_mlp_norm.  With
    ``mesh``, the row-parallel partials are summed before the norm."""
    h = column_parallel_input(
        rms_norm(x, layer["pre_mlp_norm"], cfg.norm_eps), mesh)
    gate = F.gelu((h @ layer["w_gate"]).float(), approximate="tanh")
    up = (h @ layer["w_up"]).float()
    o = row_parallel_sum((gate * up).to(x.dtype) @ layer["w_down"],
                         mesh).to(x.dtype)
    return x + rms_norm(o, layer["post_mlp_norm"], cfg.norm_eps)


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: GemmaConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   kv_caches: Optional[list] = None, mesh=None,
                   remat: bool = False):
    """tokens [batch, seq] -> (final-norm hidden states [batch, seq,
    dim], per-layer (k, v)): everything before the tied head.
    ``remat=True`` checkpoints each layer (`torch.utils.checkpoint`)."""
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = rope_frequencies(cfg, positions)
    x = embed(params, tokens, cfg)

    def one_layer(layer, x, cache, window):
        x, kv = attention_block(layer, x, cfg, cos, sin, window=window,
                                kv_cache=cache, mesh=mesh)
        return mlp_block(layer, x, cfg, mesh), kv

    new_caches = []
    for i, layer in enumerate(params["layers"]):
        cache = kv_caches[i] if kv_caches is not None else None
        window = layer_window(cfg, i)
        if remat:
            x, kv = checkpoint(one_layer, layer, x, cache, window,
                               use_reentrant=False)
        else:
            x, kv = one_layer(layer, x, cache, window)
        new_caches.append(kv)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), new_caches


def forward(params: dict, tokens: torch.Tensor, cfg: GemmaConfig, **kw):
    """tokens [batch, seq] -> (soft-capped float32 logits [batch, seq,
    vocab], per-layer (k, v))."""
    x, new_caches = forward_hidden(params, tokens, cfg, **kw)
    return lm_head(params, x, cfg), new_caches


def loss_fn(params: dict, tokens: torch.Tensor, cfg: GemmaConfig, *,
            fused_ce: bool = True, **kw) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [batch, seq].

    ``fused_ce`` (the default) runs the tied head and the final-logit
    cap inside the chunked cross-entropy (`models.losses`, CE_CHUNK
    columns at a time), never holding the [batch * seq, vocab] logits;
    ``fused_ce=False`` materialises them.  ``kw`` goes to
    `forward_hidden` (``remat=True`` checkpoints each layer).  With
    ``mesh``, ``params`` are this rank's blocks and ``tokens`` its
    data-axis rows; the loss is the global batch's mean on every rank."""
    mesh = kw.get("mesh")
    if mesh is not None:
        check_mesh(mesh)
        params = data_replicated(params, mesh)
    targets = tokens[:, 1:]
    if fused_ce:
        x, _ = forward_hidden(params, tokens[:, :-1], cfg, **kw)
        nll = fused_cross_entropy(x.reshape(-1, x.shape[-1]),
                                  params["embed"].T, targets.reshape(-1),
                                  CE_CHUNK, cfg.final_logit_softcap)
        return data_mean(nll.mean(), mesh)
    logits, _ = forward(params, tokens[:, :-1], cfg, **kw)
    logp = torch.log_softmax(logits, dim=-1)
    return data_mean(-logp.gather(-1, targets[..., None].long()).mean(),
                     mesh)


def train_step(params: dict, tokens: torch.Tensor, cfg: GemmaConfig,
               lr: float = 1e-4, **kw):
    """One SGD step, out of place: returns (new_params, loss).  Each
    update is taken in float32 and rounded to the parameter's dtype (norm
    gains stay float32).  With ``mesh``: this rank's updated blocks and
    the global loss."""
    return sgd_step(lambda p: loss_fn(p, tokens, cfg, **kw), params, lr)
