"""Memory-efficient fused cross-entropy over a chunked vocabulary.

The port of the JAX package's `models/losses.py`.  Hidden states [T, d]
-> lm-head product -> logits [T, V] -> log-softmax -> NLL at the
targets, without ever holding the [T, V] logits: the forward walks the
vocabulary in chunks with an online (max, sum) logsumexp and gathers the
target logit where it falls; the backward recomputes each chunk's
logits, turns them into the softmax with the saved lse (no stored
probabilities), and contracts dlogits = (p - onehot) * g at once into dx
and that chunk's dW columns.

The products are `torch.matmul`, as the JAX package leaves them to XLA.
Precision: the products run in the promoted dtype of x and w, so fp32
stays true fp32 (TF32 is never enabled) whenever either operand is fp32;
with 16-bit x and w they run in that type and are widened to fp32 for
the softmax.  (The JAX package keys its precision on x alone,
`losses.py:44`; the two agree when both are fp32.)

The JAX package pads the vocabulary to a chunk multiple with -inf columns
because `lax.scan` needs equal steps; an eager loop simply makes the last
chunk narrower, which computes the same thing.
"""

from __future__ import annotations

from typing import Optional

import torch


def _product(a: torch.Tensor, b: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """a @ b with both operands in ``dtype``, returned in float32."""
    return (a.to(dtype) @ b.to(dtype)).float()


def _chunk_logits(x, w_c, softcap):
    """float32 logits of one chunk, softcapped (Gemma-2 semantics) when
    asked, and the cap's derivative (None without a cap)."""
    logits = _product(x, w_c, torch.promote_types(x.dtype, w_c.dtype))
    if softcap is None:
        return logits, None
    capped = softcap * torch.tanh(logits / softcap)
    return capped, 1.0 - (capped / softcap) ** 2


def _target_hits(targets, c0, width):
    hit = (targets >= c0) & (targets < c0 + width)
    local = (targets - c0).clamp(0, width - 1)
    return hit, local


class _FusedCrossEntropy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk, softcap):
        t = x.shape[0]
        vocab = w.shape[1]
        m = torch.full((t,), float("-inf"), device=x.device)
        s = torch.zeros((t,), device=x.device)
        tl = torch.zeros((t,), device=x.device)
        for c0 in range(0, vocab, chunk):
            logits, _ = _chunk_logits(x, w[:, c0:c0 + chunk], softcap)
            m_new = torch.maximum(m, logits.amax(dim=1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(dim=1)
            m = m_new
            hit, local = _target_hits(targets, c0, logits.shape[1])
            tl += torch.where(hit, logits.gather(1, local[:, None])[:, 0],
                              0.0)
        lse = m + torch.log(s)
        ctx.save_for_backward(x, w, targets, lse)
        ctx.chunk, ctx.softcap = chunk, softcap
        return lse - tl

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lse = ctx.saved_tensors
        chunk, softcap = ctx.chunk, ctx.softcap
        dtype = torch.promote_types(x.dtype, w.dtype)
        t = x.shape[0]
        dx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        dw = torch.empty_like(w)
        rows = torch.arange(t, device=x.device)
        for c0 in range(0, w.shape[1], chunk):
            w_c = w[:, c0:c0 + chunk]
            logits, deriv = _chunk_logits(x, w_c, softcap)
            p = torch.exp(logits - lse[:, None])  # softmax, recomputed
            hit, local = _target_hits(targets, c0, logits.shape[1])
            p[rows[hit], local[hit]] -= 1.0
            dlogits = p * g[:, None]
            if deriv is not None:
                dlogits = dlogits * deriv
            dx += _product(dlogits, w_c.t(), dtype)
            dw[:, c0:c0 + chunk] = _product(x.t(), dlogits, dtype).to(w.dtype)
        return dx.to(x.dtype), dw, None, None, None


def fused_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                        targets: torch.Tensor, chunk: int = 8192,
                        softcap: Optional[float] = None) -> torch.Tensor:
    """Per-token NLL [T] float32 of softmax(x @ w) at ``targets``.

    x: [T, d] hidden states; w: [d, V] lm-head weight; targets: [T]
    integer ids.  ``softcap`` applies the Gemma-2 final-logit cap
    softcap * tanh(logit / softcap) before the softmax.  Peak live
    state is one [T, chunk] block of logits."""
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    return _FusedCrossEntropy.apply(x, w, targets.long(), chunk, softcap)
