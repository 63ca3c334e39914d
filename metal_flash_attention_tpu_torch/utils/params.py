"""Carry parameters, KV caches (quantized ones too) and quantized
operands from the JAX package into the port.

The tests hand both packages the same weights, caches and quantized
operands: the JAX pytree is turned into numpy (bf16 as float32, which
numpy can hold; bf16 -> f32 -> bf16 is exact) and this module builds the
port's structures from it (`params_to_numpy` carries parameters back).
"""

from __future__ import annotations

import numpy as np
import torch

from metal_flash_attention_tpu_torch.utils.device import resolve_device


def _to_tensor(name: str, x, device, dtype: torch.dtype) -> torch.Tensor:
    # Norm weights and the MoE router stay float32, as in the JAX
    # package (a bf16 router would round the gates and move the routes);
    # every other array takes the model dtype.
    keep = name.endswith("norm") or name == "w_router"
    t = torch.from_numpy(np.array(x))
    return t.to(device=device, dtype=torch.float32 if keep else dtype)


def params_from_numpy(tree, device=None,
                      dtype: torch.dtype = torch.bfloat16):
    """Nested dicts / lists of numpy arrays (the JAX params pytree under
    `jax.tree.map(np.asarray, ...)`) -> the same structure of tensors,
    on the card unless ``device`` says otherwise.  A JAX LoRA adapter
    tree carries across too: its (A, B) tuples stay tuples and its
    ``rank`` a Python int."""
    device = resolve_device(device)

    def walk(node, name):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v, name) for v in node)
        if isinstance(node, list):
            return [walk(v, name) for v in node]
        if isinstance(node, (int, np.integer)) or (
                isinstance(node, np.ndarray) and node.ndim == 0
                and node.dtype.kind in "iu"):
            return int(node)      # a LoRA tree's rank
        return _to_tensor(name, node, device, dtype)
    return walk(tree, "")


def params_to_numpy(params):
    """The port's parameters (nested dicts / lists of tensors) -> the
    same structure of float32 numpy arrays, on the host: the inverse of
    `params_from_numpy`, so that a test can hold a trained step against
    the JAX package's leaf by leaf."""
    from metal_flash_attention_tpu_torch.utils.tree import tree_map

    return tree_map(lambda t: t.detach().float().cpu().numpy(), params)


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


def quantized_tensor_from_numpy(x, device=None):
    """A JAX `ops.quantization.QuantizedTensor` (its arrays as JAX or
    numpy arrays) -> the port's, payload bits kept, on the card unless
    ``device`` says otherwise."""
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops.quantization import (
        QuantizedTensor,
    )

    device = resolve_device(device)
    precision = OperandPrecision(x.precision.value)
    return QuantizedTensor(_payload(x.values, precision, device),
                           _floats(x.scales, device), precision)


def quantized_kv_cache_from_numpy(cache, device=None,
                                  dtype: torch.dtype = torch.bfloat16):
    """A JAX `models.serving.QuantizedKVCache` as numpy (under
    `jax.tree.map(np.asarray, ...)`; a tail in bf16 as float32) -> the
    port's, payload bits kept, tails in ``dtype``, on the card unless
    ``device`` says otherwise."""
    from metal_flash_attention_tpu_torch.models.serving import (
        QuantizedKVCache,
    )

    device = resolve_device(device)

    def tensors(xs):
        return [quantized_tensor_from_numpy(x, device) for x in xs]
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
