"""Descriptor-driven dispatch facade.

The port of the JAX package's `dispatch.py`: derive an
`AttentionDescriptor` from the operands, resolve it to a configured
callable, and call it.  This is the route `models.llama.attention_block`
takes, as in the JAX package.  The callables are cached on the
descriptor's options (everything but batch, q_len and kv_len), so a
decode loop whose kv_len grows each step reuses one entry.  The JAX
package's second cache level, `jax.jit`'s executables, has no
counterpart: PyTorch runs eagerly and the kernels are built once per
process (`native/build.py`).  `ops.flash_attention` checks the operands
and refuses what the port does not compute yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from metal_flash_attention_tpu_torch.descriptors.attention_descriptor import (
    AttentionDescriptor,
)
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.ops.flash_attention import (
    flash_attention,
)

_DISPATCH_CACHE: dict[AttentionDescriptor, Callable] = {}


def _options(descriptor: AttentionDescriptor) -> AttentionDescriptor:
    """The descriptor without the per-call lengths: the cache key."""
    return dataclasses.replace(descriptor, batch=0, q_len=0, kv_len=0)


def build_attention(descriptor: AttentionDescriptor) -> Callable:
    """Resolve a descriptor to a ready-to-dispatch attention callable
    (q, k, v, mask=None, bias=None, mask2=None, q_segment_ids=None,
    kv_segment_ids=None, return_residuals=False)."""
    key = _options(descriptor)
    cached = _DISPATCH_CACHE.get(key)
    if cached is not None:
        return cached
    out_dtype = (descriptor.output_precision.storage_dtype
                 if descriptor.output_precision is not None else None)

    def dispatch(q, k, v, mask=None, bias=None, mask2=None,
                 q_segment_ids=None, kv_segment_ids=None,
                 return_residuals: bool = False):
        return flash_attention(
            q, k, v, mask, bias, mask2, q_segment_ids, kv_segment_ids,
            causal=descriptor.causal, window_size=descriptor.window_size,
            scale=descriptor.scale, logit_softcap=descriptor.logit_softcap,
            return_residuals=return_residuals,
            low_precision_intermediates=(
                descriptor.low_precision_intermediates),
            out_dtype=out_dtype)

    _DISPATCH_CACHE[key] = dispatch
    return dispatch


def attention(q, k, v, mask=None, bias=None, mask2=None,
              q_segment_ids=None, kv_segment_ids=None, *,
              causal: bool = False, window_size=None, scale=None,
              logit_softcap=None, low_precision_intermediates: bool = False,
              return_residuals: bool = False):
    """Descriptor-routed attention: the one resolution point the model
    paths use."""
    batch, q_heads, q_len, head_dim = q.shape
    desc = AttentionDescriptor(
        batch=batch, q_heads=q_heads, kv_heads=k.shape[1], q_len=q_len,
        kv_len=k.shape[2], head_dim=head_dim,
        input_precision=OperandPrecision.from_dtype(q.dtype), causal=causal,
        has_mask=mask is not None, has_mask2=mask2 is not None,
        has_bias=bias is not None, has_segments=q_segment_ids is not None,
        window_size=window_size, scale=scale, logit_softcap=logit_softcap,
        low_precision_intermediates=low_precision_intermediates)
    return build_attention(desc)(
        q, k, v, mask, bias, mask2, q_segment_ids, kv_segment_ids,
        return_residuals=return_residuals)


def clear_dispatch_cache() -> None:
    _DISPATCH_CACHE.clear()


def cache_info() -> dict:
    return {"dispatch_entries": len(_DISPATCH_CACHE)}
