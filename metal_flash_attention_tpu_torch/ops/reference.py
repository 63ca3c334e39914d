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
- The returned lse is the natural-log row log-sum-exp of the scaled
  logits.  A row with every column masked gives o = 0 and lse = -inf.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = False,
                        window_size: Optional[int] = None,
                        scale: Optional[float] = None,
                        return_residuals: bool = False):
    r, d = q.shape[-2:]
    c = k.shape[-2]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.dim() >= 3 and k.shape[-3] != q.shape[-3]:
        group = q.shape[-3] // k.shape[-3]
        k = k.repeat_interleave(group, dim=-3)
        v = v.repeat_interleave(group, dim=-3)
    q32, k32, v32 = q.float(), k.float(), v.float()
    s = (q32 @ k32.transpose(-1, -2)) * scale
    live = None
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
    o = (p / safe_l) @ v32
    if not return_residuals:
        return o
    lse = torch.where(l[..., 0] > 0.0, m[..., 0] + torch.log(safe_l[..., 0]),
                      torch.full_like(l[..., 0], float("-inf")))
    return o, lse
