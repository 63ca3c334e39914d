"""Multi-adapter LoRA: many tenants' low-rank adapters resident at once,
chosen per batch row, for fine-tuning on a frozen base and for serving.

The port of the JAX package's `models/lora.py`.  Adapters are stacked
along a leading axis (``A [n_adapters, in, r]``, ``B [n_adapters, r,
out]``) and a per-row id vector gathers each sequence's pair before two
thin batched products add the delta:

    y = x @ W + (x @ A[ids]) @ B[ids]

Adapter 0 starts with B = 0, so it is the base model, and unadapted
requests share the batch at the cost of a zero delta.  The scaling
alpha / rank is folded into B at init.  The products are `torch.bmm`
(the JAX package computes them outside any Pallas kernel too); the
adapters' gradients reach them through the attention kernels' backward.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from metal_flash_attention_tpu_torch.models.optim import make_train_step
from metal_flash_attention_tpu_torch.utils.device import resolve_device

ATTN_PROJS = ("wq", "wk", "wv", "wo")


def init_lora_adapters(cfg, n_adapters: int, rank: int, *,
                       generator: torch.Generator, projs=ATTN_PROJS,
                       alpha: Optional[float] = None, b_scale: float = 0.0,
                       device=None) -> dict:
    """Stacked adapters for the Llama family: ``{"rank": r, "layers":
    [{proj: (A, B)}]}`` in ``cfg.dtype``, on the card unless ``device``
    says otherwise (``generator`` must live there).

    A ~ N(0, 1/in); B = 0, or N(0, b_scale^2) for adapters 1.. when
    ``b_scale > 0``; adapter 0's B is always 0 (the base model).
    ``alpha`` defaults to ``rank`` (scaling 1) and is folded into B."""
    if not set(projs) <= set(ATTN_PROJS):
        raise ValueError(f"LoRA projections must be among {ATTN_PROJS}, "
                         f"got {projs}")
    device = resolve_device(device)
    scaling = float(alpha if alpha is not None else rank) / rank
    qkv = cfg.n_heads * cfg.head_dim
    kv = cfg.n_kv_heads * cfg.head_dim
    dims = {"wq": (cfg.dim, qkv), "wk": (cfg.dim, kv), "wv": (cfg.dim, kv),
            "wo": (qkv, cfg.dim)}

    def normal(shape):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=device)

    layers = []
    for _ in range(cfg.n_layers):
        layer = {}
        for pj in projs:
            d_in, d_out = dims[pj]
            a = normal((n_adapters, d_in, rank)) / math.sqrt(d_in)
            # B is drawn whatever b_scale is, so A does not depend on it.
            b = normal((n_adapters, rank, d_out)) * b_scale
            b[0] = 0.0
            layer[pj] = (a.to(cfg.dtype), (b * scaling).to(cfg.dtype))
        layers.append(layer)
    return {"rank": rank, "layers": layers}


def n_adapters(lora: dict) -> int:
    """The number of adapters in a stack."""
    return next(iter(lora["layers"][0].values()))[0].shape[0]


def apply_lora(h: torch.Tensor, pair, ids: torch.Tensor) -> torch.Tensor:
    """Each row's low-rank delta: h [b, s, in] -> [b, s, out] through
    its adapter (``ids`` int [b])."""
    a, b = pair
    ids = ids.long()
    return torch.bmm(torch.bmm(h, a[ids]), b[ids])


def lora_delta(y: torch.Tensor, h: torch.Tensor, lora_layer, name: str,
               lora_ids) -> torch.Tensor:
    """y plus projection ``name``'s delta from h, when ``lora_layer``
    adapts it (ids default to adapter 0 for every row)."""
    if lora_layer is None or name not in lora_layer:
        return y
    if lora_ids is None:
        lora_ids = torch.zeros((h.shape[0],), dtype=torch.int32,
                               device=h.device)
    return y + apply_lora(h, lora_layer[name], lora_ids)


def make_lora_train_step(cfg, optimizer: Optional[Callable[
        [list], torch.optim.Optimizer]] = None):
    """Fine-tuning on a frozen base: ``(init_fn, step_fn)``, as
    `models.optim.make_train_step` builds them (float32 master weights;
    ``optimizer`` as there, AdamW at optax's defaults when None).

    init_fn(adapters) -> state
    step_fn(adapters, state, params, tokens, lora_ids=None)
        -> (adapters, state, loss)

    Only the adapter stacks train.  The base parameters are never given
    ``requires_grad``, so no gradient or optimizer state is built for
    them; ``lora_ids`` (int [batch]) picks each row's adapter.  The
    adapters update in place and then serve as trained
    (``ServingEngine(..., lora=adapters)``)."""
    from metal_flash_attention_tpu_torch.models import llama

    def loss(layers, batch):
        params, tokens, rank, lora_ids = batch
        return llama.loss_fn(params, tokens, cfg,
                             lora={"rank": rank, "layers": layers},
                             lora_ids=lora_ids)

    init, step = make_train_step(loss, optimizer)

    def init_fn(adapters):
        return init(adapters["layers"])

    def step_fn(adapters, state, params, tokens, lora_ids=None):
        rank = adapters["rank"]
        layers, state, value = step(adapters["layers"], state,
                                    (params, tokens, rank, lora_ids))
        return {"rank": rank, "layers": layers}, state, value

    return init_fn, step_fn
