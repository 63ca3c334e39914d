"""Carry parameters, KV caches (quantized ones too) and quantized
operands from the JAX package into the port.

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
    The payload keeps its bits (`_payload`)."""
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops.quantization import (
        QuantizedMatrix,
    )

    device = resolve_device(device)
    precision = OperandPrecision(getattr(precision, "value", precision))
    return QuantizedMatrix(
        _payload(values, precision, device), _floats(scale, device),
        precision, tuple(int(x) for x in shape))


def _payload(values, precision, device) -> torch.Tensor:
    """A quantized payload with its bits kept: FP8 arrays (ml_dtypes
    float8) go through uint8 and `Tensor.view` to torch's float8 dtype,
    never through float32; INT8 stays int8 and NF4 uint8."""
    if not precision.is_quantized:
        raise ValueError(f"not a quantized precision: {precision}")
    raw = np.array(values)   # a writable, contiguous copy
    if raw.dtype.itemsize != 1:
        raise TypeError(f"a {precision.value} payload has one byte an "
                        f"element, got {raw.dtype}")
    return torch.from_numpy(raw.view(np.uint8)).view(
        precision.storage_dtype).to(device)


def _floats(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.float32)).to(device=device,
                                                        dtype=dtype)


def _ints(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, np.int32)).to(device)


def quantized_kv_cache_from_numpy(cache, device=None,
                                  dtype: torch.dtype = torch.bfloat16):
    """A JAX `models.serving.QuantizedKVCache` as numpy (under
    `jax.tree.map(np.asarray, ...)`; a tail in bf16 as float32) -> the
    port's, payload bits kept, tails in ``dtype``, on the card unless
    ``device`` says otherwise."""
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.models.serving import (
        QuantizedKVCache,
    )
    from metal_flash_attention_tpu_torch.ops.quantization import (
        QuantizedTensor,
    )

    device = resolve_device(device)

    def tensors(xs):
        out = []
        for x in xs:
            precision = OperandPrecision(x.precision.value)
            out.append(QuantizedTensor(
                _payload(x.values, precision, device),
                _floats(x.scales, device), precision))
        return out
    return QuantizedKVCache(
        k_q=tensors(cache.k_q), v_q=tensors(cache.v_q),
        k_tail=[_floats(x, device, dtype) for x in cache.k_tail],
        v_tail=[_floats(x, device, dtype) for x in cache.v_tail],
        prefix_len=_ints(cache.prefix_len, device),
        tail_len=_ints(cache.tail_len, device))


def quantized_paged_cache_from_numpy(cache, head_dim: int, device=None,
                                     dtype: torch.dtype = torch.bfloat16):
    """A JAX `models.serving.QuantizedPagedModelCache` as numpy -> the
    port's, on the card unless ``device`` says otherwise.  The JAX pools
    pad head_dim to 128 lanes; the port's do not, so the lanes past
    ``head_dim`` are cut, after checking that each holds the code of 0.0
    (the JAX quantizer pads with zeros), so that no payload bit is lost;
    the kept payload keeps its bits.  Tails come in ``dtype``."""
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.models.serving import (
        QuantizedPagedModelCache,
    )

    device = resolve_device(device)
    precision = OperandPrecision(cache.precision.value)
    # A page never written holds zero bytes; a written one the code of
    # 0.0 in its padding (NF4: codebook index 7, in both nibbles).
    padding = (0, 0x77 if precision is OperandPrecision.NF4 else 0)

    def pools(xs):
        out = []
        for x in xs:
            raw = np.array(x)
            pad = raw[..., head_dim:].view(np.uint8)
            if pad.size and not np.all(np.isin(pad, padding)):
                raise ValueError("a pool's lanes past head_dim hold "
                                 "payload, not padding")
            out.append(_payload(raw[..., :head_dim], precision, device))
        return tuple(out)
    return QuantizedPagedModelCache(
        qk=pools(cache.qk), qv=pools(cache.qv),
        k_scales=tuple(_floats(x, device) for x in cache.k_scales),
        v_scales=tuple(_floats(x, device) for x in cache.v_scales),
        tail_k=tuple(_floats(x, device, dtype) for x in cache.tail_k),
        tail_v=tuple(_floats(x, device, dtype) for x in cache.tail_v),
        page_table=_ints(cache.page_table, device),
        full_len=_ints(cache.full_len, device),
        tail_len=_ints(cache.tail_len, device), precision=precision)
