"""Carry parameters and KV caches from the JAX package into the port.

The tests hand both packages the same weights, caches and quantized
operands: the JAX pytree is turned into numpy (bf16 as float32, which
numpy can hold; bf16 -> f32 -> bf16 is exact) and this module builds the
port's structures from it.
"""

from __future__ import annotations

import numpy as np
import torch

from metal_flash_attention_tpu_torch.utils.device import resolve_device


def _to_tensor(name: str, x, device, dtype: torch.dtype) -> torch.Tensor:
    # Norm weights stay float32, as in the JAX package; every other
    # array takes the model dtype.
    keep = name.endswith("norm")
    t = torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=torch.float32 if keep else dtype)


def params_from_numpy(tree, device=None,
                      dtype: torch.dtype = torch.bfloat16):
    """Nested dicts / lists of numpy arrays (the JAX params pytree under
    `jax.tree.map(np.asarray, ...)`) -> the same structure of tensors,
    on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v, name) for v in node]
        return _to_tensor(name, node, device, dtype)
    return walk(tree, "")


def pools_from_numpy(pools, head_dim: int, device=None,
                     dtype: torch.dtype = torch.bfloat16) -> list:
    """JAX KV pools [num_pages, kv_heads, page_size, d_lanes] (head_dim
    padded to 128 lanes) -> port pools cut back to ``head_dim``, on the
    card unless ``device`` says otherwise."""
    device = resolve_device(device)
    return [torch.from_numpy(np.array(p[..., :head_dim]))
            .to(device=device, dtype=dtype) for p in pools]


def cache_from_numpy(cache, device=None, dtype: torch.dtype = torch.bfloat16):
    """A JAX dense `KVCache` as numpy (per-layer k and v lists of
    [batch, kv_heads, max_seq, head_dim] arrays, lengths [batch]) -> the
    port's `models.serving.KVCache`, on the card unless ``device`` says
    otherwise."""
    from metal_flash_attention_tpu_torch.models.serving import KVCache

    device = resolve_device(device)

    def caches(xs):
        return [torch.from_numpy(np.array(x, np.float32)).to(
            device=device, dtype=dtype) for x in xs]
    return KVCache(k=caches(cache.k), v=caches(cache.v),
                   lengths=torch.from_numpy(np.array(
                       cache.lengths, np.int32)).to(device))


def quantized_matrix_from_numpy(values, scale, precision, shape,
                                device=None):
    """A JAX `QuantizedMatrix` as numpy (under `jax.tree.map(np.asarray,
    ...)`) -> the port's `ops.quantization.QuantizedMatrix`, on the card
    unless ``device`` says otherwise.  ``precision``: an
    `OperandPrecision` of either package, or its value ("int8", ...).

    The payload keeps its bits: FP8 arrays (ml_dtypes float8) go through
    uint8 and `Tensor.view` to torch's float8 dtype, never through
    float32; INT8 stays int8 and NF4 uint8."""
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops.quantization import (
        QuantizedMatrix,
    )

    device = resolve_device(device)
    precision = OperandPrecision(getattr(precision, "value", precision))
    if not precision.is_quantized:
        raise ValueError(f"not a quantized precision: {precision}")
    raw = np.array(values)   # a writable, contiguous copy
    if raw.dtype.itemsize != 1:
        raise TypeError(f"a {precision.value} payload has one byte an "
                        f"element, got {raw.dtype}")
    payload = torch.from_numpy(raw.view(np.uint8)).view(
        precision.storage_dtype)
    return QuantizedMatrix(
        payload.to(device),
        torch.from_numpy(np.array(scale, np.float32)).to(device),
        precision, tuple(int(x) for x in shape))
