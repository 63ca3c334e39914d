"""Drop-in adapter for `jax.nn.dot_product_attention` call sites.

The port of the JAX package's `compat.py`: the fused kernels behind
`jax.nn.dot_product_attention`'s signature (BTNH layout, boolean mask
semantics, GQA by head ratio), so that code written against it moves by
an import swap.  The adapter transposes BTNH <-> BHTD around the kernel
and maps the arguments:

    bias / mask           -> the additive bias / boolean mask options
    is_causal             -> causal=True (T == S)
    scale                 -> scale (default 1/sqrt(D))
    local_window_size     -> window_size; an int w means (w, w), as in
                             jax.nn (the right half is moot under
                             is_causal, refused otherwise)
    key_value_seq_lengths -> the in-kernel segment-id compare
    query_seq_lengths     -> the same, on the query axis

Alignment: jax.nn builds its causal and window masks top-left aligned
(query i against key j), the kernels bottom-right (offset = kv_len -
q_len).  The two coincide when T == S, the fused path.  For T != S the
adapter builds jax.nn's mask as an explicit [1, 1, T, S] mask, ANDed
into ``mask2`` when the caller gives a mask too.
"""

from __future__ import annotations

from typing import Optional

import torch

from metal_flash_attention_tpu_torch.ops.flash_attention import (
    flash_attention,
)


def dot_product_attention(
    query: torch.Tensor,
    key: torch.Tensor,
    value: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    mask: Optional[torch.Tensor] = None,
    *,
    scale: Optional[float] = None,
    is_causal: bool = False,
    query_seq_lengths: Optional[torch.Tensor] = None,
    key_value_seq_lengths: Optional[torch.Tensor] = None,
    local_window_size=None,
) -> torch.Tensor:
    """`jax.nn.dot_product_attention`-compatible fused attention.

    query [B, T, N, H], key/value [B, S, K, H] with N % K == 0 (GQA);
    returns [B, T, N, H].  bias and mask are [B|1, N|1, T, S].  A padded
    query row (past its length) attends only to padded keys, and gives 0
    where there are none.
    """
    b, t, _, _ = query.shape
    s = key.shape[1]

    q = query.transpose(1, 2)
    k = key.transpose(1, 2)
    v = value.transpose(1, 2)

    left = None
    if local_window_size is not None:
        if isinstance(local_window_size, (tuple, list)):
            left, right = (int(x) for x in local_window_size)
        else:
            # jax.nn treats an int w as the symmetric window (w, w).
            left = right = int(local_window_size)
        if right != 0 and not is_causal:
            raise NotImplementedError(
                "right-looking windows are only supported under "
                "is_causal (which masks the right half anyway); use "
                "an explicit mask otherwise")

    aligned = t == s
    causal_kw = is_causal and aligned
    # jax.nn's `left` counts keys before the diagonal; the kernels'
    # window_size spans the visible run including the query's own key.
    window_kw = left + 1 if left is not None and aligned else None

    align_mask = None
    if not aligned and (is_causal or left is not None):
        rows = torch.arange(t, device=query.device)[:, None]
        cols = torch.arange(s, device=query.device)[None, :]
        keep = torch.ones((t, s), dtype=torch.bool, device=query.device)
        if is_causal:
            keep &= cols <= rows
        if left is not None:
            keep &= cols >= rows - left
            if not is_causal:
                keep &= cols <= rows  # the right half is 0 (checked)
        align_mask = keep[None, None]

    # Lengths become segment ids: 0 for valid positions, 1 for padding.
    q_seg = kv_seg = None
    if query_seq_lengths is not None or key_value_seq_lengths is not None:
        def ids(lengths, n):
            if lengths is None:
                return torch.zeros((b, n), dtype=torch.int32,
                                   device=query.device)
            pos = torch.arange(n, device=query.device)[None, :]
            return (pos >= lengths.to(query.device)[:, None]).to(
                torch.int32)
        q_seg = ids(query_seq_lengths, t)
        kv_seg = ids(key_value_seq_lengths, s)

    if mask is not None and mask.dtype != torch.bool:
        mask = mask.to(torch.bool)
    # The kernels' two mask slots AND together; mask2 needs mask.
    mask2 = None
    if align_mask is not None:
        if mask is None:
            mask = align_mask
        else:
            mask2 = align_mask

    o = flash_attention(
        q, k, v, mask, bias, mask2, q_seg, kv_seg,
        causal=causal_kw, window_size=window_kw, scale=scale)
    return o.transpose(1, 2)
