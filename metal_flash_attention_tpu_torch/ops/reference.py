"""Golden reference attention (plain torch, float32).

The counterpart of the JAX package's `ops/reference.attention_reference`:
a naive O(R·C·D) softmax attention in float32, used by the tests and by
`chip_smoke.py` as the independent answer the paged kernels are held to.

Conventions shared with the kernels:

- q is [..., heads, R, D] and k/v are [..., kv_heads, C, D]; a q head h
  reads kv head h // (heads // kv_heads) (GQA).  2-D [R, D] inputs are
  one head.
- Causal masking is aligned bottom-right: row r sees columns
  c <= r + (C - R), so a short query block sits at the end of its keys.
- ``window_size`` w keeps columns c > r + (C - R) - w.
- ``logit_softcap`` c (Gemma-2) replaces each scaled logit s by
  c * tanh(s / c), after the scale and before the mask.
- The returned lse is the natural-log row log-sum-exp of the scaled
  logits.  A row with every column masked gives o = 0 and lse = -inf.
- `attention_reference_grads` is the analytic backward under the loss
  Phi = sum(dO * O) (with the soft cap too), the basis of the flash
  backward's plain version.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def softcap_value(logit_softcap) -> Optional[float]:
    """The cap the kernels apply for a ``logit_softcap`` argument: None
    for None or 0 (the JAX kernels test it for truth), else its absolute
    value (c * tanh(s / c) is the same curve for c and -c)."""
    return abs(float(logit_softcap)) if logit_softcap else None


def _probabilities(q, k, *, causal, window_size, scale, logit_softcap=None):
    """Float32 softmax of the masked, scaled (and soft-capped) logits of
    q [..., R, D] against k [..., C, D] (k already repeated to q's
    heads).  Returns (p, lse); a row that sees no key has p = 0 and
    lse = -inf."""
    r, c = q.shape[-2], k.shape[-2]
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    if causal or window_size is not None:
        rows = torch.arange(r, device=q.device)[:, None]
        cols = torch.arange(c, device=q.device)[None, :]
        offset = c - r
        live = torch.ones((r, c), dtype=torch.bool, device=q.device)
        if causal:
            live &= cols <= rows + offset
        if window_size is not None:
            live &= cols > rows + offset - window_size
        s = s.masked_fill(~live, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, torch.ones_like(l), l)
    lse = torch.where(l[..., 0] > 0.0, m[..., 0] + torch.log(safe_l[..., 0]),
                      torch.full_like(l[..., 0], float("-inf")))
    return p / safe_l, lse


def _group(q, k):
    """Query heads per kv head (1 for 2-D inputs)."""
    if q.dim() >= 3 and k.shape[-3] != q.shape[-3]:
        return q.shape[-3] // k.shape[-3]
    return 1


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        window_size: Optional[int] = None,
                        scale: Optional[float] = None,
                        logit_softcap: Optional[float] = None,
                        return_residuals: bool = False):
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = _group(q, k)
    if group > 1:
        k = k.repeat_interleave(group, dim=-3)
        v = v.repeat_interleave(group, dim=-3)
    p, lse = _probabilities(q, k, causal=causal, window_size=window_size,
                            scale=scale, logit_softcap=logit_softcap)
    o = p @ v.float()
    return (o, lse) if return_residuals else o


def attention_reference_grads(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = False,
                              window_size: Optional[int] = None,
                              scale: Optional[float] = None,
                              logit_softcap: Optional[float] = None):
    """Analytic gradients of Phi = sum(dO * O) w.r.t. Q, K, V, in float32
    (the JAX package's `attention_reference_grads`, batched and GQA):

        D  = rowsum(dO * O)
        dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * scale
        dQ = dS K,    dK = dS^T Q

    With ``logit_softcap`` c, P is that of the capped logits and dS takes
    the chain factor of c * tanh(s / c), 1 - tanh(s / c)^2 (the JAX
    kernels' `ds * (1 - t * t)`).  dK and dV are summed over each kv
    head's group of q heads.  Returns (dq, dk, dv, o, lse, d_term)."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = _group(q, k)
    kr, vr = k, v
    if group > 1:
        kr = k.repeat_interleave(group, dim=-3)
        vr = v.repeat_interleave(group, dim=-3)
    p, lse = _probabilities(q, kr, causal=causal, window_size=window_size,
                            scale=scale, logit_softcap=logit_softcap)
    q32, k32, v32, do32 = q.float(), kr.float(), vr.float(), do.float()
    o = p @ v32
    d_term = (do32 * o).sum(dim=-1, keepdim=True)
    dv = p.transpose(-1, -2) @ do32
    ds = p * (do32 @ v32.transpose(-1, -2) - d_term) * scale
    if logit_softcap is not None:
        t = torch.tanh((q32 @ k32.transpose(-1, -2)) * scale
                       / logit_softcap)
        ds = ds * (1.0 - t * t)
    dq = ds @ k32
    dk = ds.transpose(-1, -2) @ q32
    if group > 1:
        dk = dk.unflatten(-3, (k.shape[-3], group)).sum(dim=-3)
        dv = dv.unflatten(-3, (k.shape[-3], group)).sum(dim=-3)
    return dq, dk, dv, o, lse, d_term[..., 0]
