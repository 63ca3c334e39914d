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
- The options of the JAX kernels (`AttentionOptions`), in their order:
  an additive ``bias`` (natural units, after the cap); a ``mask``, read
  as int8, whose gate min(|mask|, 1) (AND ``mask2``'s) takes 1e30 off a
  gated logit, finite, and multiplies its p; segment ids, which keep a
  pair only where the query's id equals the key's, as the structural
  masks do.  mask and bias are [B_m, H_m, R, C], each of B_m and H_m 1
  or a divisor of the batch and heads: (b, h) reads (b % B_m, h % H_m).
- The JAX reference's own ``mask`` (nonzero attends) and ``bias`` (added
  after the cap), broadcast against the logits [..., R, C] by torch's
  rules: a masked pair is dropped as the structural masks drop it.
- The returned lse is the natural-log row log-sum-exp of the scaled
  logits.  A row with every column masked or gated gives o = 0 and
  lse = -inf.
- `attention_reference_grads` is the analytic backward under the loss
  Phi = sum(dO * O) (with the soft cap and the options too), the basis
  of the flash backward's plain version.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

# What a gated logit loses (the JAX kernels' GATE_MAGNITUDE): finite, so
# that a row whose keys are all gated has no -inf - -inf.
GATE_MAGNITUDE = 1e30


@dataclasses.dataclass(frozen=True)
class AttentionOptions:
    """The JAX kernels' optional operands, as the kernels take them: mask
    and mask2 int8 [B_m, H_m, R, C] (nonzero attends; mask2 only beside
    mask), bias [B_b, H_b, R, C] float, segment ids int32 [batch, R] and
    [batch, C] (both or neither)."""

    mask: Optional[torch.Tensor] = None
    mask2: Optional[torch.Tensor] = None
    bias: Optional[torch.Tensor] = None
    q_segment_ids: Optional[torch.Tensor] = None
    kv_segment_ids: Optional[torch.Tensor] = None


def tile_heads(t: torch.Tensor, batch: int, heads: int) -> torch.Tensor:
    """A mask or bias [B_m, H_m, R, C] at every (b, h) of [batch, heads]:
    (b % B_m, h % H_m), the JAX kernels' index map (a size-1 dim
    broadcasts, a divisor repeats)."""
    bm, hm = t.shape[:2]
    if bm != batch:
        t = t.expand(batch, -1, -1, -1) if bm == 1 else \
            t.repeat(batch // bm, 1, 1, 1)
    if hm != heads:
        t = t.expand(-1, heads, -1, -1) if hm == 1 else \
            t.repeat(1, heads // hm, 1, 1)
    return t


def softcap_value(logit_softcap) -> Optional[float]:
    """The cap the kernels apply for a ``logit_softcap`` argument: None
    for None or 0 (the JAX kernels test it for truth), else its absolute
    value (c * tanh(s / c) is the same curve for c and -c)."""
    return abs(float(logit_softcap)) if logit_softcap else None


def _logits(q, k, *, causal, window_size, scale, logit_softcap=None,
            options=None, mask=None, bias=None):
    """The float32 logits of q [..., R, D] against k [..., C, D] (k
    already repeated to q's heads), scaled, soft-capped and biased, with
    -inf where the structural masks (causal, window, segments, the JAX
    reference's ``mask``) drop a pair, and the gate (None without an
    options mask)."""
    r, c = q.shape[-2], k.shape[-2]
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    gate = None
    if options is not None:
        batch, heads = q.shape[0], q.shape[1]
        if options.bias is not None:
            s = s + tile_heads(options.bias, batch, heads).float()
        if options.mask is not None:
            gate = tile_heads(options.mask, batch, heads).float().abs() \
                .clamp_max(1.0)
            if options.mask2 is not None:
                gate = gate * tile_heads(options.mask2, batch, heads) \
                    .float().abs().clamp_max(1.0)
            s = s + (gate - 1.0) * GATE_MAGNITUDE
        if options.q_segment_ids is not None:
            same = options.q_segment_ids[:, None, :, None] == \
                options.kv_segment_ids[:, None, None, :]
            s = s.masked_fill(~same, float("-inf"))
    if bias is not None:
        s = s + bias.float()
    if mask is not None:
        s = s.masked_fill(mask == 0, float("-inf"))
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
    return s, gate


def _probabilities(q, k, *, causal, window_size, scale, logit_softcap=None,
                   options=None, lse=None, mask=None, bias=None):
    """Float32 softmax of the masked, scaled (and soft-capped, biased and
    gated) logits of q [..., R, D] against k [..., C, D] (k already
    repeated to q's heads).  Returns (p, lse); a row that sees no key, or
    only gated ones, has p = 0 and lse = -inf.  With ``lse`` given (the
    forward's, as the backward kernels read it), p = exp(s - lse) times
    the gate, a row of lse -inf reading as 0."""
    s, gate = _logits(q, k, causal=causal, window_size=window_size,
                      scale=scale, logit_softcap=logit_softcap,
                      options=options, mask=mask, bias=bias)
    if lse is not None:
        lse = lse.float()
        base = torch.where(torch.isinf(lse), torch.zeros_like(lse), lse)
        p = torch.exp(s - base[..., None])
        return (p if gate is None else p * gate), lse
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isinf(m), torch.zeros_like(m), m)
    p = torch.exp(s - m)
    if gate is not None:
        p = p * gate
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
                        return_residuals: bool = False,
                        options: Optional[AttentionOptions] = None,
                        mask: Optional[torch.Tensor] = None,
                        bias: Optional[torch.Tensor] = None):
    """softmax(Q K^T * scale) V in float32 (the conventions above);
    with ``return_residuals`` also the natural-log lse.  ``options``
    takes q and k/v 4-D, [batch, heads, R or C, D]; ``mask`` and
    ``bias`` are the JAX reference's."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = _group(q, k)
    if group > 1:
        k = k.repeat_interleave(group, dim=-3)
        v = v.repeat_interleave(group, dim=-3)
    p, lse = _probabilities(q, k, causal=causal, window_size=window_size,
                            scale=scale, logit_softcap=logit_softcap,
                            options=options, mask=mask, bias=bias)
    o = p @ v.float()
    return (o, lse) if return_residuals else o


def attention_reference_grads(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = False,
                              window_size: Optional[int] = None,
                              scale: Optional[float] = None,
                              logit_softcap: Optional[float] = None,
                              options: Optional[AttentionOptions] = None,
                              lse: Optional[torch.Tensor] = None,
                              d_term: Optional[torch.Tensor] = None,
                              mask: Optional[torch.Tensor] = None,
                              bias: Optional[torch.Tensor] = None):
    """Analytic gradients of Phi = sum(dO * O) w.r.t. Q, K, V, in float32
    (the JAX package's `attention_reference_grads`, batched and GQA):

        D  = rowsum(dO * O)
        dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D) * scale
        dQ = dS K,    dK = dS^T Q

    With ``logit_softcap`` c, P is that of the capped logits and dS takes
    the chain factor of c * tanh(s / c), 1 - tanh(s / c)^2 (the JAX
    kernels' `ds * (1 - t * t)`).  dK and dV are summed over each kv
    head's group of q heads.  With ``options``, P is that of the biased,
    gated and segmented logits, and dbias = P * (dP - D), in natural units
    and before the cap's factor (the JAX dQ kernel's), [batch, heads, R,
    C], not reduced over a broadcast bias's dims.  ``lse`` and ``d_term``
    given (the forward's, as stored): P and D are read from them, as the
    kernels read theirs.  ``mask`` and ``bias``: the JAX reference's
    (no dbias for them, as there).  Returns (dq, dk, dv, o, lse, d_term,
    dbias), dbias None without an options bias."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    group = _group(q, k)
    kr, vr = k, v
    if group > 1:
        kr = k.repeat_interleave(group, dim=-3)
        vr = v.repeat_interleave(group, dim=-3)
    p, lse = _probabilities(q, kr, causal=causal, window_size=window_size,
                            scale=scale, logit_softcap=logit_softcap,
                            options=options, lse=lse, mask=mask, bias=bias)
    q32, k32, v32, do32 = q.float(), kr.float(), vr.float(), do.float()
    o = p @ v32
    if d_term is None:
        d_term = (do32 * o).sum(dim=-1)
    d_term = d_term.float()[..., None]
    dv = p.transpose(-1, -2) @ do32
    ds = p * (do32 @ v32.transpose(-1, -2) - d_term)
    dbias = ds if options is not None and options.bias is not None \
        else None
    ds = ds * scale
    if logit_softcap is not None:
        t = torch.tanh((q32 @ k32.transpose(-1, -2)) * scale
                       / logit_softcap)
        ds = ds * (1.0 - t * t)
    dq = ds @ k32
    dk = ds.transpose(-1, -2) @ q32
    if group > 1:
        dk = dk.unflatten(-3, (k.shape[-3], group)).sum(dim=-3)
        dv = dv.unflatten(-3, (k.shape[-3], group)).sum(dim=-3)
    return dq, dk, dv, o, lse, d_term[..., 0], dbias
