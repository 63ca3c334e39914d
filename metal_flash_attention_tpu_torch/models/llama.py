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
XLA; only attention is a hand-written kernel on the card.  ``lora=`` /
``lora_ids=`` add per-row multi-adapter LoRA deltas to the attention
projections (`models.lora`), differentiable, so the same path
fine-tunes.  `param_shardings` gives the tensor-parallel layout that
`parallel.mesh.shard` cuts each rank's block by (the serving steps take
``mesh=``, `models.serving`).

Data- and head-parallel training (``mesh=`` in `attention_block`,
`forward_hidden`, `forward`, `loss_fn` and `train_step`; the JAX
package's ``shard_map`` over P(data, heads) at its `attention_block`,
and GSPMD's collectives around the sharded products under `jax.jit`)
runs SPMD: each rank holds its block of every parameter
(`param_shardings`) and its data-axis rows of the tokens.  Attention
runs the rank's (rows, heads) through the same fused kernels and their
backward as without a mesh; the inputs of the column-parallel products
(wq / wk / wv, w_gate / w_up) go through
`parallel.mesh.column_parallel_input`, and wo's and w_down's partials
through `row_parallel_sum`.  The loss gathers lm_head's column blocks
(`gather_columns`, each rank computing the whole vocabulary's
cross-entropy on its rows), takes every parameter through
`data_replicated` and returns `data_mean` of the rank's loss, so the
loss is the global batch's mean on every rank and every gradient that
mean's.

The context axis (the JAX package's long-context tier: its
`attention_block` runs the differentiable ring there): with a context
axis of more than one rank, x holds the rank's rows AND its context
shard of the sequence.  Attention is the causal ring over that axis
(`parallel.ring_attention`, the GQA K/V heads rotating as they are,
since the kernels sum a group's dK/dV); norms, projections and the MLP
stay per token.  `forward_hidden` gives the shard its global positions,
`loss_fn` takes the rank's rows whole and cuts inputs and targets to its
context columns, and the data average runs over the data and context
ranks together.  A sliding window with a context axis raises ValueError
(the JAX ring drops the window).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metal_flash_attention_tpu_torch import dispatch
from metal_flash_attention_tpu_torch.models.lora import lora_delta
from metal_flash_attention_tpu_torch.models.losses import fused_cross_entropy
from metal_flash_attention_tpu_torch.models.optim import sgd_step
from metal_flash_attention_tpu_torch.ops.flash_attention import (
    flash_attention,
)
from metal_flash_attention_tpu_torch.parallel.mesh import (
    CONTEXT_AXIS,
    HEAD_AXIS,
    P,
    axis_index,
    axis_size,
    check_mesh,
    column_parallel_input,
    data_mean,
    data_replicated,
    gather_columns,
    row_parallel_sum,
)
from metal_flash_attention_tpu_torch.parallel.ring_attention import (
    ring_attention,
)
from metal_flash_attention_tpu_torch.utils.device import resolve_device


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


def param_shardings(cfg: LlamaConfig, mesh, *, qkv_bias: bool = False
                    ) -> dict:
    """Tensor-parallel layout over the heads axis, a `PartitionSpec` per
    leaf: wq / wk / wv / w_gate / w_up / lm_head column-parallel, wo /
    w_down row-parallel, the rest replicated.  ``qkv_bias``: the tree has
    Qwen2's bq / bk / bv, split with their weights' columns (the JAX
    package's layout has no biases).  ``mesh`` is checked
    (`parallel.mesh.check_mesh`)."""
    check_mesh(mesh)
    col, row, rep = P(None, HEAD_AXIS), P(HEAD_AXIS, None), P()
    layer = {
        "wq": col, "wk": col, "wv": col, "wo": row,
        "w_gate": col, "w_up": col, "w_down": row,
        "attn_norm": rep, "mlp_norm": rep,
    }
    if qkv_bias:
        layer.update(bq=P(HEAD_AXIS), bk=P(HEAD_AXIS), bv=P(HEAD_AXIS))
    return {
        "embed": rep,
        "layers": [dict(layer) for _ in range(cfg.n_layers)],
        "final_norm": rep,
        "lm_head": col,
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
    # Configs without the field (Gemma's) take no scaling.
    scaling = getattr(cfg, "rope_scaling_factor", None)
    if scaling is not None:
        factor = float(scaling)
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


def mlp_block(layer: dict, x: torch.Tensor, cfg: LlamaConfig,
              mesh=None) -> torch.Tensor:
    """Residual SwiGLU MLP; the SiLU and the gate product in float32.
    With ``mesh`` the layer holds this rank's column block of w_gate /
    w_up and row block of w_down, and the partial products are summed
    over the heads axis (`parallel.mesh.row_parallel_sum`; the normed
    input enters the column blocks through `column_parallel_input`)."""
    h = column_parallel_input(rms_norm(x, layer["mlp_norm"], cfg.norm_eps),
                              mesh)
    gate = F.silu((h @ layer["w_gate"]).float())
    up = (h @ layer["w_up"]).float()
    down = (gate * up).to(x.dtype) @ layer["w_down"]
    return x + row_parallel_sum(down, mesh).to(x.dtype)


def attention_qkv(layer: dict, x: torch.Tensor, cfg: LlamaConfig, cos, sin,
                  lora_layer: Optional[dict] = None, lora_ids=None,
                  mesh=None):
    """norm -> QKV projections (+ Qwen2-style bias, + each row's LoRA
    delta) -> rope.  Returns q [b, q_heads, s, d] and k/v [b, kv_heads,
    s, d]; with a rank's column blocks of the projections, its own heads
    (with ``mesh``, the normed input enters them through
    `column_parallel_input`)."""
    b, s, _ = x.shape
    h = column_parallel_input(rms_norm(x, layer["attn_norm"], cfg.norm_eps),
                              mesh)

    def proj(name):
        y = h @ layer[name]
        bias = layer.get("b" + name[1:])
        if bias is not None:
            y = y + bias.to(y.dtype)
        return lora_delta(y, h, lora_layer, name, lora_ids)
    q = proj("wq").reshape(b, s, -1, cfg.head_dim)
    k = proj("wk").reshape(b, s, -1, cfg.head_dim)
    v = proj("wv").reshape(b, s, -1, cfg.head_dim)
    q = apply_rope(q.transpose(1, 2), cos, sin)
    k = apply_rope(k.transpose(1, 2), cos, sin)
    return q, k, v.transpose(1, 2)


def wo_proj(o: torch.Tensor, layer: dict, lora_layer: Optional[dict] = None,
            lora_ids=None) -> torch.Tensor:
    """The output projection of o [b, s, q_heads * d], with each row's
    LoRA delta."""
    return lora_delta(o @ layer["wo"], o, lora_layer, "wo", lora_ids)


def _context_parallel(mesh) -> bool:
    return mesh is not None and axis_size(mesh, CONTEXT_AXIS) > 1


def _context_columns(t: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's context shard of the sequence dim (dim 1) of ``t``
    [rows, seq]: the whole of it without a context axis; ValueError where
    the context size does not divide seq."""
    if not _context_parallel(mesh):
        return t
    n, s = axis_size(mesh, CONTEXT_AXIS), t.shape[1]
    if s % n:
        raise ValueError(f"sequence {s} does not split over {n} context "
                         "ranks")
    lo = axis_index(mesh, CONTEXT_AXIS) * (s // n)
    return t[:, lo:lo + s // n]


def attention_block(layer: dict, x: torch.Tensor, cfg: LlamaConfig, cos,
                    sin, kv_cache: Optional[tuple] = None,
                    block_q: Optional[int] = None,
                    block_kv: Optional[int] = None, mesh=None,
                    lora_layer: Optional[dict] = None, lora_ids=None,
                    seq_sharded: bool = True):
    """x: [batch, seq, dim] -> (x + attention, (k, v)).

    With ``kv_cache = (k_prefix, v_prefix)`` the new K/V are appended to
    the prefix and attention spans all of it (causal, bottom-right).
    Without ``block_q`` / ``block_kv`` attention resolves through
    `dispatch.attention`; with either it calls `flash_attention` with
    that tile, as the JAX package does.  ``lora_layer`` / ``lora_ids``:
    this layer's adapter pairs and each row's adapter (None: adapter 0).

    With ``mesh`` (module docstring) the layer holds this rank's blocks
    and x its data-axis rows: the rank attends its own heads, and wo's
    partials are summed over the heads axis.  With a context axis of more
    than one rank, x holds the rank's context shard of the sequence and
    attention is the causal ring over it; ``seq_sharded=False`` (MoE's
    path, whose JAX attention leaves the sequence whole) takes x whole on
    every context rank and attends it as without the axis."""
    if mesh is not None:
        check_mesh(mesh)
        if lora_layer is not None:
            raise ValueError("LoRA adapters with mesh=: the adapters are "
                             "not sharded")
    ring = seq_sharded and _context_parallel(mesh)
    if ring and (cfg.sliding_window is not None or kv_cache is not None):
        raise ValueError("the context axis takes no sliding window and no "
                         "KV cache: ring attention is causal over the "
                         "whole sequence")
    b, s, _ = x.shape
    q, k, v = attention_qkv(layer, x, cfg, cos, sin, lora_layer, lora_ids,
                            mesh)
    if kv_cache is not None:
        k = torch.cat([kv_cache[0], k], dim=2)
        v = torch.cat([kv_cache[1], v], dim=2)
    if ring:
        o = ring_attention(mesh, causal=True, block_q=block_q,
                           block_kv=block_kv)(q, k, v)
    elif block_q is None and block_kv is None:
        o = dispatch.attention(q, k, v, causal=True,
                               window_size=cfg.sliding_window)
    else:
        o = flash_attention(q, k, v, causal=True,
                            window_size=cfg.sliding_window, block_q=block_q,
                            block_kv=block_kv)
    y = wo_proj(o.transpose(1, 2).reshape(b, s, -1), layer, lora_layer,
                lora_ids)
    return x + row_parallel_sum(y, mesh).to(x.dtype), (k, v)


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   kv_caches: Optional[list] = None,
                   block_q: Optional[int] = None,
                   block_kv: Optional[int] = None, mesh=None,
                   lora: Optional[dict] = None, lora_ids=None,
                   remat: bool = False):
    """tokens [batch, seq] -> (final-norm hidden states [batch, seq,
    dim], per-layer (k, v)): everything before the lm head, so the loss
    can fuse the head into its chunked cross-entropy.

    ``remat=True`` checkpoints each layer (`torch.utils.checkpoint`,
    non-reentrant): the backward recomputes the layer's activations, so
    attention's forward kernel runs twice per layer and step.
    ``block_q`` / ``block_kv``: every layer's attention tile
    (`attention_block`).  ``lora`` / ``lora_ids``: stacked adapters
    (`models.lora`) and each row's adapter.  ``mesh``: this rank's
    blocks and rows, and with a context axis its context shard of the
    sequence, whose positions start at context index x shard length
    (module docstring)."""
    if mesh is not None:
        check_mesh(mesh)
    b, s = tokens.shape
    if positions is None:
        start = axis_index(mesh, CONTEXT_AXIS) * s \
            if _context_parallel(mesh) else 0
        positions = torch.arange(start, start + s,
                                 device=tokens.device).expand(b, s)
    cos, sin = rope_frequencies(cfg, positions)
    x = params["embed"][tokens.long()].to(cfg.dtype)

    def one_layer(layer, x, cache, lora_layer):
        x, kv = attention_block(layer, x, cfg, cos, sin, kv_cache=cache,
                                block_q=block_q, block_kv=block_kv,
                                mesh=mesh, lora_layer=lora_layer,
                                lora_ids=lora_ids)
        return mlp_block(layer, x, cfg, mesh), kv

    new_caches = []
    for i, layer in enumerate(params["layers"]):
        cache = kv_caches[i] if kv_caches is not None else None
        lora_layer = None if lora is None else lora["layers"][i]
        if remat:
            x, kv = checkpoint(one_layer, layer, x, cache, lora_layer,
                               use_reentrant=False)
        else:
            x, kv = one_layer(layer, x, cache, lora_layer)
        new_caches.append(kv)
    return rms_norm(x, params["final_norm"], cfg.norm_eps), new_caches


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, **kw):
    """tokens [batch, seq] -> (float32 logits [batch, seq, vocab],
    per-layer (k, v)); with ``mesh``, the rank's rows' logits over the
    whole vocabulary (lm_head's column blocks gathered)."""
    x, new_caches = forward_hidden(params, tokens, cfg, **kw)
    head = gather_columns(params["lm_head"], kw.get("mesh"))
    return (x @ head).float(), new_caches


def loss_fn(params: dict, tokens: torch.Tensor, cfg: LlamaConfig, *,
            fused_ce: bool = True, **kw) -> torch.Tensor:
    """Mean next-token cross-entropy of tokens [batch, seq].

    ``fused_ce`` (the default) runs the lm head inside the chunked
    cross-entropy (`models.losses`), never holding the [batch * seq,
    vocab] logits; ``fused_ce=False`` materialises them.  With ``mesh``,
    ``params`` are this rank's blocks and ``tokens`` its data-axis rows,
    whole [rows, seq]: with a context axis the shifted inputs and targets
    are cut to the rank's context columns (seq - 1 must divide over it).
    The loss is the global batch's mean on every rank (module
    docstring)."""
    mesh = kw.get("mesh")
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if mesh is not None:
        check_mesh(mesh)
        params = data_replicated(params, mesh, context=True)
        inputs = _context_columns(inputs, mesh)
        targets = _context_columns(targets, mesh)
    if fused_ce:
        x, _ = forward_hidden(params, inputs, cfg, **kw)
        nll = fused_cross_entropy(x.reshape(-1, x.shape[-1]),
                                  gather_columns(params["lm_head"], mesh),
                                  targets.reshape(-1))
        return data_mean(nll.mean(), mesh, context=True)
    logits, _ = forward(params, inputs, cfg, **kw)
    logp = torch.log_softmax(logits, dim=-1)
    return data_mean(-logp.gather(-1, targets[..., None].long()).mean(),
                     mesh, context=True)


def train_step(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
               lr: float = 1e-4, **kw):
    """One SGD step, out of place: returns (new_params, loss).  Each
    update is taken in float32 and rounded to the parameter's dtype.
    With ``mesh``: this rank's updated blocks and the global loss."""
    return sgd_step(lambda p: loss_fn(p, tokens, cfg, **kw), params, lr)
