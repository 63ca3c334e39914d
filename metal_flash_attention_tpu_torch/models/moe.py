"""Mixture-of-Experts layer and the Mixtral-style model in PyTorch.

The port of the JAX package's `models/moe.py`: a Llama backbone whose
every FFN is a bank of SwiGLU experts behind a router.

- **GShard-style capacity routing**: each token picks its top-k experts
  from the float32 softmax gates (ties to the lower expert index, as
  `jax.lax.top_k` breaks them), and the selected gates are renormalized
  (the Mixtral convention).  Each expert takes at most
  ``ceil(capacity_factor * tokens * top_k / n_experts)`` tokens: a
  token's slot is its rank among that expert's tokens, round 0 first,
  then round 1, each in token order, and a slot past the capacity is
  dropped (that expert adds nothing to the token).
- **Load-balancing auxiliary loss** (Switch/GShard form): E * sum_e
  (share of tokens whose first choice is e * mean gate of e).

The JAX package forms one-hot dispatch and combine tensors [tokens,
experts, capacity] and contracts them in float32; at 8,192 training
tokens each would be 671 MB a layer and each contraction 1.4 TFLOP.
The port computes the same values by index: a kept (token, choice)
copies the token's row into its expert's slot (`index_copy`), and the
token gathers its experts' outputs back, weighted by their gates.  A
product with a one-hot is exact, so both forms agree; `route` still
returns JAX's (dispatch, combine, aux).  The expert products are
`torch.bmm` in the model dtype with the SiLU and the gate product in
float32, plain products that the JAX package leaves to XLA; attention
is `llama.attention_block` (the fused flash-attention kernels on the
card).

Expert parallelism (`param_shardings`, ``mesh=`` in `moe_ffn`,
`forward_hidden`, `forward`, `loss_fn` and `train_step`): the experts
split over the mesh's heads axis (E / tp a rank, as the JAX package
shards them), attention tensor-parallel as in Llama, the batch's rows
over the data axis.  Every rank of a heads group routes the group's
tokens (input and router are replicated there, so the routes are the
same on each), runs only its own experts over their capacity slots, and
combines their gated outputs into a float32 partial that
`parallel.mesh.row_parallel_sum` adds over the heads axis; the token
rows and the gate weights enter the experts through
`column_parallel_input`, so their gradients are summed there too (the
router's gradient through the aux loss is whole on every rank already).
JAX lowers its sharded einsums to the same sums.

Over a data axis of more than one rank, capacity is the JAX package's:
it counts the global batch, and each choice's slot is its rank among the
expert's choices over every data rank's tokens in order.  Each rank
gathers the data axis's choices (`gather_rows`, integers) and takes its
own rows' slots; an expert's output for a token depends on that token
alone, so each data rank runs its experts on its own tokens, in slots
numbered globally (the rest of the buffer stays zero, as JAX's sharding
constraint replicates the capacity buffer over the data axis).  The aux
loss's token shares and mean gates are the global batch's
(`sum_over` the data axis, with its gradient summed back).  A context
axis leaves the sequence whole on every context rank (attention with
``seq_sharded=False``), as the JAX package's specs do: every context
rank computes the same loss and gradients.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from metal_flash_attention_tpu_torch.models import llama
from metal_flash_attention_tpu_torch.models.losses import fused_cross_entropy
from metal_flash_attention_tpu_torch.models.optim import sgd_step
from metal_flash_attention_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    HEAD_AXIS,
    P,
    axis_index,
    axis_size,
    check_mesh,
    column_parallel_input,
    data_mean,
    data_replicated,
    gather_columns,
    gather_rows,
    row_parallel_sum,
    sum_over,
)
from metal_flash_attention_tpu_torch.utils.device import resolve_device


@dataclass(frozen=True)
class MoEConfig:
    """Mixtral-style: Llama backbone, MoE FFN every layer.  The defaults
    are Mixtral-8x7B's widths."""
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    hidden_dim: int = 14336
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @staticmethod
    def tiny(**kw) -> "MoEConfig":
        defaults = dict(vocab_size=256, dim=128, n_layers=2, n_heads=4,
                        n_kv_heads=2, hidden_dim=256, n_experts=4,
                        top_k=2)
        defaults.update(kw)
        return MoEConfig(**defaults)


def _expert_block(cfg: MoEConfig, mesh) -> tuple[int, int]:
    """(this rank's expert block index, experts a rank) over the heads
    axis; (0, n_experts) without a mesh.  ValueError when the axis does
    not divide the experts."""
    if mesh is None:
        return 0, cfg.n_experts
    tp = axis_size(check_mesh(mesh), HEAD_AXIS)
    if cfg.n_experts % tp:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{tp} ranks of the heads axis")
    return axis_index(mesh, HEAD_AXIS), cfg.n_experts // tp


def _capacity(cfg: MoEConfig, n_tokens: int) -> int:
    cap = int(math.ceil(
        cfg.capacity_factor * n_tokens * cfg.top_k / cfg.n_experts))
    return max(cap, cfg.top_k)


def init_moe_ffn(cfg: MoEConfig, generator: torch.Generator,
                 device=None) -> dict:
    """One layer's router and expert bank: normal / sqrt(fan_in) in
    float32, experts cast to ``cfg.dtype`` ([E, dim, hidden] and [E,
    hidden, dim]); the router [dim, E] stays float32.  ``device=None``
    means the card; ``generator`` must live on the same device."""
    device = resolve_device(device)

    def normal(shape):
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device)
        return w.div_(math.sqrt(shape[-2]))

    e, d, h = cfg.n_experts, cfg.dim, cfg.hidden_dim
    return {
        "w_router": normal((d, e)),
        "w_gate": normal((e, d, h)).to(cfg.dtype),
        "w_up": normal((e, d, h)).to(cfg.dtype),
        "w_down": normal((e, h, d)).to(cfg.dtype),
    }


def _top_k(gates: torch.Tensor, k: int):
    """-> (renormalized weights [T, k], expert ids [T, k]), best first,
    equal gates in expert order (`jax.lax.top_k`'s tie rule, by a
    stable sort)."""
    topi = torch.sort(gates, dim=-1, descending=True,
                      stable=True).indices[:, :k]
    topw = gates.gather(1, topi)
    return topw / topw.sum(dim=-1, keepdim=True).clamp_min(1e-9), topi


def _slots(topi: torch.Tensor, n_experts: int, capacity: int):
    """Each choice's slot in its expert's bucket -> (slot [T, k], kept
    [T, k]): the rank among the expert's choices, round 0 first, then
    round 1, each in token order; slots >= capacity are dropped."""
    used = torch.zeros((n_experts,), dtype=torch.long, device=topi.device)
    slots = []
    for j in range(topi.shape[1]):
        onehot = F.one_hot(topi[:, j], n_experts)
        rank = onehot.cumsum(dim=0) - onehot + used
        slots.append(rank.gather(1, topi[:, j:j + 1])[:, 0])
        used = used + onehot.sum(dim=0)
    slot = torch.stack(slots, dim=1)
    return slot, slot < capacity


def _aux_loss(gates: torch.Tensor, topi: torch.Tensor,
              mesh=None) -> torch.Tensor:
    """E * sum_e(share of first choices on e * mean gate of e), over the
    global batch: with ``mesh``, the counts and gate sums of every data
    rank's tokens (`sum_over`)."""
    t, e = gates.shape
    counts = F.one_hot(topi[:, 0], e).sum(dim=0).to(gates.dtype)
    if _data_ranks(mesh) == 1:
        return e * (counts / t * gates.mean(dim=0)).sum()
    n = t * _data_ranks(mesh)
    counts = sum_over(counts, mesh, DATA_AXIS)
    sums = sum_over(gates.sum(dim=0), mesh, DATA_AXIS)
    return e * (counts / n * (sums / n)).sum()


def _data_ranks(mesh) -> int:
    return 1 if mesh is None else axis_size(mesh, DATA_AXIS)


def route(gates: torch.Tensor, top_k: int, capacity: int):
    """gates [T, E] softmax probabilities -> (dispatch [T, E, C] one-hot,
    combine [T, E, C] gate-weighted, aux loss): the JAX package's
    `route`, built from the index form that `moe_ffn` runs."""
    t, e = gates.shape
    topw, topi = _top_k(gates, top_k)
    slot, kept = _slots(topi, e, capacity)
    rows = torch.arange(t, device=gates.device)[:, None].expand_as(topi)
    where = (rows[kept], topi[kept], slot[kept])
    zeros = gates.new_zeros((t, e, capacity))
    dispatch = zeros.index_put(where, torch.ones_like(topw[kept]))
    combine = zeros.index_put(where, topw[kept])
    return dispatch, combine, _aux_loss(gates, topi)


def _dispatch(xt: torch.Tensor, topi, slot, kept, capacity: int,
              n_experts: int):
    """-> (expert inputs [E, C, dim], each choice's row in them [T, k]):
    a kept choice copies its token into row e * C + c; the dropped ones
    go to one spare row past the end, which is cut off."""
    t, k = topi.shape
    rows = n_experts * capacity
    dest = torch.where(kept, topi * capacity + slot, rows)
    src = xt[:, None].expand(t, k, xt.shape[1]).reshape(t * k, -1)
    xe = xt.new_zeros((rows + 1, xt.shape[1])).index_copy(
        0, dest.reshape(-1), src)
    return xe[:-1].view(n_experts, capacity, -1), dest


def _experts(params: dict, xe: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Every expert's SwiGLU on its slots: [E, C, dim] -> [E, C, dim] in
    ``cfg.dtype``; the SiLU and the gate product in float32."""
    gate = F.silu(torch.bmm(xe, params["w_gate"]).float())
    up = torch.bmm(xe, params["w_up"]).float()
    return torch.bmm((gate * up).to(cfg.dtype), params["w_down"])


def _combine(ye: torch.Tensor, dest, topw, kept) -> torch.Tensor:
    """Each token's choices' outputs gathered back and summed, weighted
    by their gates in float32 (a dropped choice weighs 0): -> [T, dim]
    float32."""
    t, k = dest.shape
    flat = ye.reshape(-1, ye.shape[-1])
    yk = flat.index_select(0, torch.where(kept, dest, 0).reshape(-1))
    w = torch.where(kept, topw, 0.0)
    return (yk.view(t, k, -1).float() * w[..., None]).sum(dim=1)


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig, mesh=None):
    """x [batch, seq, dim] -> (y [batch, seq, dim] in x's dtype, aux
    loss).  Capacity counts every token of the call.  With ``mesh``,
    ``params`` holds this rank's block of the experts (`param_shardings`)
    and x is this rank's data-axis rows, whole over the heads axis: the
    rank's experts' float32 partial is summed over the heads axis, and
    capacity and the aux loss count every data rank's tokens (module
    docstring)."""
    block, e_local = _expert_block(cfg, mesh)
    b, s, d = x.shape
    t = b * s
    xt = x.reshape(t, d)
    gates = torch.softmax(xt.float() @ params["w_router"].float(), dim=-1)
    topw, topi = _top_k(gates, cfg.top_k)
    # Slots over the global token set, then this rank's rows of them.
    cap = _capacity(cfg, t * _data_ranks(mesh))
    slot, kept = _slots(gather_rows(topi, mesh), cfg.n_experts, cap)
    if _data_ranks(mesh) > 1:
        lo = axis_index(mesh, DATA_AXIS) * t
        slot, kept = slot[lo:lo + t], kept[lo:lo + t]
    # This rank's choices, numbered among its own experts.
    mine = kept & (topi // e_local == block)
    xe, dest = _dispatch(column_parallel_input(xt, mesh).to(cfg.dtype),
                         topi - block * e_local, slot, mine, cap, e_local)
    y = _combine(_experts(params, xe, cfg), dest,
                 column_parallel_input(topw, mesh), mine)
    y = row_parallel_sum(y, mesh)
    return y.reshape(b, s, d).to(x.dtype), _aux_loss(gates, topi, mesh)


def _base_cfg(cfg: MoEConfig) -> llama.LlamaConfig:
    """The Llama backbone config this MoE model wraps."""
    return llama.LlamaConfig(
        vocab_size=cfg.vocab_size, dim=cfg.dim, n_layers=cfg.n_layers,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        hidden_dim=cfg.hidden_dim, rope_theta=cfg.rope_theta,
        norm_eps=cfg.norm_eps, dtype=cfg.dtype)


def init_params(cfg: MoEConfig, generator: torch.Generator,
                device=None) -> dict:
    """Llama backbone parameters with an MoE FFN (``layer["moe"]``) in
    every layer.  The backbone is drawn with hidden_dim 0, so no dense
    MLP is allocated (352 MB a layer at Mixtral's widths)."""
    device = resolve_device(device)
    params = llama.init_params(
        dataclasses.replace(_base_cfg(cfg), hidden_dim=0), generator,
        device=device)
    for layer in params["layers"]:
        for name in ("w_gate", "w_up", "w_down"):
            del layer[name]
        layer["moe"] = init_moe_ffn(cfg, generator, device=device)
    return params


def param_shardings(cfg: MoEConfig, mesh) -> dict:
    """The backbone's `llama.param_shardings` (attention tensor-parallel
    over the heads axis), every expert weight split on its expert dim
    over the same axis, the router replicated."""
    specs = llama.param_shardings(_base_cfg(cfg), mesh)
    ep = P(HEAD_AXIS, None, None)
    for layer in specs["layers"]:
        for name in ("w_gate", "w_up", "w_down"):
            del layer[name]
        layer["moe"] = {"w_router": P(), "w_gate": ep, "w_up": ep,
                        "w_down": ep}
    return specs


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: MoEConfig, *,
                   positions: Optional[torch.Tensor] = None,
                   kv_caches: Optional[list] = None, mesh=None,
                   remat: bool = False):
    """tokens [batch, seq] -> (final-norm hidden states, per-layer (k,
    v), aux loss averaged over the layers): everything before the lm
    head.  ``remat=True`` checkpoints each layer
    (`torch.utils.checkpoint`, non-reentrant), as `llama.forward_hidden`
    does.  ``mesh``: this rank's blocks and data-axis rows (module
    docstring)."""
    base = _base_cfg(cfg)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = llama.rope_frequencies(base, positions)
    x = params["embed"][tokens.long()].to(cfg.dtype)

    def one_layer(layer, x, cache):
        x, kv = llama.attention_block(layer, x, base, cos, sin,
                                      kv_cache=cache, mesh=mesh,
                                      seq_sharded=False)
        h = llama.rms_norm(x, layer["mlp_norm"], cfg.norm_eps)
        y, aux = moe_ffn(layer["moe"], h, cfg, mesh=mesh)
        return x + y, kv, aux

    new_caches = []
    aux_total = 0.0
    for i, layer in enumerate(params["layers"]):
        cache = kv_caches[i] if kv_caches is not None else None
        if remat:
            x, kv, aux = checkpoint(one_layer, layer, x, cache,
                                    use_reentrant=False)
        else:
            x, kv, aux = one_layer(layer, x, cache)
        new_caches.append(kv)
        aux_total = aux_total + aux
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return x, new_caches, aux_total / cfg.n_layers


def forward(params: dict, tokens: torch.Tensor, cfg: MoEConfig, **kw):
    """tokens [batch, seq] -> (float32 logits, per-layer (k, v), aux
    loss); with ``mesh``, over the whole vocabulary (lm_head's column
    blocks gathered)."""
    x, new_caches, aux = forward_hidden(params, tokens, cfg, **kw)
    head = gather_columns(params["lm_head"], kw.get("mesh"))
    return (x @ head).float(), new_caches, aux


def loss_fn(params: dict, tokens: torch.Tensor, cfg: MoEConfig, *,
            fused_ce: bool = True, **kw) -> torch.Tensor:
    """Next-token cross-entropy plus ``aux_loss_weight`` times the
    load-balancing loss.  ``fused_ce`` (the default) runs the lm head
    inside the chunked cross-entropy (`models.losses`);
    ``fused_ce=False`` materialises the logits.  With ``mesh``, this
    rank's blocks and data-axis rows; the loss is the global batch's on
    every rank (`llama.loss_fn`'s scheme; the aux loss is global
    already)."""
    mesh = kw.get("mesh")
    if mesh is not None:
        check_mesh(mesh)
        params = data_replicated(params, mesh)
    targets = tokens[:, 1:]
    if fused_ce:
        x, _, aux = forward_hidden(params, tokens[:, :-1], cfg, **kw)
        nll = fused_cross_entropy(x.reshape(-1, x.shape[-1]),
                                  gather_columns(params["lm_head"], mesh),
                                  targets.reshape(-1))
        return data_mean(nll.mean() + cfg.aux_loss_weight * aux, mesh)
    logits, _, aux = forward(params, tokens[:, :-1], cfg, **kw)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, targets[..., None].long())
    return data_mean(nll.mean() + cfg.aux_loss_weight * aux, mesh)


def train_step(params: dict, tokens: torch.Tensor, cfg: MoEConfig,
               lr: float = 1e-4, **kw):
    """One SGD step, out of place: returns (new_params, loss), each
    update taken in float32 and rounded to the parameter's dtype.  With
    ``mesh``: this rank's updated blocks and the global loss."""
    return sgd_step(lambda p: loss_fn(p, tokens, cfg, **kw), params, lr)
