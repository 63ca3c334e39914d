"""Training-step construction: AdamW with float32 master weights and
gradient accumulation.

The port of the JAX package's `models/optim.py`:

- the optimizer is a `torch.optim` optimizer, AdamW by default at the
  JAX package's optax defaults (lr 1e-4, betas (0.9, 0.999), eps 1e-8,
  weight_decay 1e-4; torch's own AdamW default decay is 1e-2);
- with ``master_weights`` every parameter gets a float32 shadow, the
  optimizer owns the shadows (their ``.grad`` is the float32 gradient),
  and the working copy is re-rounded from its shadow after each step:
  without it AdamW's small updates vanish in bf16's mantissa;
- with ``accum_steps > 1`` every batch leaf carries a leading
  microbatch axis, and the gradients are averaged in float32.

Where the JAX package is functional, the port updates in place to save
memory: ``step_fn`` writes the new values into the parameter tensors it
is given and returns the same structure.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from metal_flash_attention_tpu_torch.utils.tree import flatten, tree_map


def adamw(tensors: list) -> torch.optim.Optimizer:
    """The default optimizer: optax.adamw(1e-4)'s settings."""
    return torch.optim.AdamW(tensors, lr=1e-4, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=1e-4)


def sgd_step(loss_fn: Callable[[object], torch.Tensor], params, lr: float):
    """One plain SGD step, out of place: -> (new_params, loss).  Each
    update is taken in float32 and rounded to the parameter's dtype (the
    JAX package's `train_step`s)."""
    leaves, rebuild = flatten(params)
    work = [p.detach().requires_grad_(True) for p in leaves]
    loss = loss_fn(rebuild(work))
    grads = list(torch.autograd.grad(loss, work))
    new = []
    with torch.no_grad():
        for i, p in enumerate(leaves):
            # Each gradient goes once its update is taken, so that the
            # old parameters, the gradients and the new ones are never
            # all held at once.
            g, grads[i] = grads[i], None
            new.append((p.float() - lr * g.float()).to(p.dtype))
            del g
    return rebuild(new), loss.detach()


def make_train_step(loss_fn: Callable[..., torch.Tensor],
                    optimizer: Optional[Callable[[list],
                                                 torch.optim.Optimizer]] = None,
                    *, accum_steps: int = 1, master_weights: bool = True):
    """Build ``(init_fn, step_fn)`` around a scalar ``loss_fn(params,
    batch)``.

    init_fn(params) -> state  (the optimizer [+ the float32 shadows])
    step_fn(params, state, batch) -> (params, state, loss)

    ``optimizer`` takes the list of tensors to update and returns a
    `torch.optim.Optimizer` over them (default `adamw`).  ``step_fn``
    must be given the parameters that ``init_fn`` saw."""
    make_optimizer = optimizer or adamw
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def init_fn(params):
        leaves, _ = flatten(params)
        if master_weights:
            shadow = [p.detach().float().clone() for p in leaves]
            return {"opt": make_optimizer(shadow), "shadow": shadow}
        return {"opt": make_optimizer(leaves), "shadow": None}

    def value_and_grad(params, batch):
        leaves, rebuild = flatten(params)
        work = [p.detach().requires_grad_(True) for p in leaves]
        loss = loss_fn(rebuild(work), batch)
        return loss.detach(), torch.autograd.grad(loss, work)

    def grads(params, batch):
        if accum_steps == 1:
            loss, g = value_and_grad(params, batch)
            return loss, [x.float() for x in g]
        loss_sum, g_sum = None, None
        for i in range(accum_steps):
            loss, g = value_and_grad(params, tree_map(lambda x: x[i], batch))
            if g_sum is None:
                loss_sum, g_sum = loss.float(), [x.float() for x in g]
            else:
                loss_sum = loss_sum + loss.float()
                for acc, x in zip(g_sum, g):
                    acc.add_(x.float())
        inv = 1.0 / accum_steps
        return loss_sum * inv, [x.mul_(inv) for x in g_sum]

    def step_fn(params, state, batch):
        loss, g = grads(params, batch)
        leaves, _ = flatten(params)
        anchor = state["shadow"] if master_weights else leaves
        for a, x in zip(anchor, g):
            a.grad = x.to(a.dtype)
        state["opt"].step()
        state["opt"].zero_grad(set_to_none=True)
        if master_weights:
            with torch.no_grad():
                for p, s in zip(leaves, state["shadow"]):
                    p.copy_(s)
        return params, state, loss

    return init_fn, step_fn


def make_train_loop(loss_fn: Callable[..., torch.Tensor],
                    optimizer: Optional[Callable[[list],
                                                 torch.optim.Optimizer]] = None,
                    *, steps_per_call: int, accum_steps: int = 1,
                    master_weights: bool = True):
    """Like `make_train_step`, but each call runs ``steps_per_call``
    full optimizer steps: a plain loop over ``step_fn``.

    loop_fn(params, state, batches) -> (params, state, losses [K])

    ``batches`` carries an extra leading axis of length
    ``steps_per_call`` (before any microbatch axis)."""
    init_fn, step_fn = make_train_step(loss_fn, optimizer,
                                       accum_steps=accum_steps,
                                       master_weights=master_weights)

    def loop_fn(params, state, batches):
        losses = []
        for i in range(steps_per_call):
            params, state, loss = step_fn(
                params, state, tree_map(lambda x: x[i], batches))
            losses.append(loss)
        return params, state, torch.stack(losses)

    return init_fn, loop_fn
