"""Quantized KV in the PyTorch port against the JAX package: the paged
pools' quantizer and the kernels' plain versions over INT8 / FP8 / NF4
K/V.

- `quantize_paged` and `quantize_page_block` (the JAX package's
  `serving._quantize_page_block`): payloads bit for bit, scales exactly,
  in every precision, an odd head_dim among the shapes.
- `paged_decode` / `paged_prefill` over quantized pools against the JAX
  kernel in interpret mode, at page sizes 8 and 16 (NF4 at 16 and 32:
  the JAX kernel takes NF4 pages of a multiple of 8 stored rows), and a
  decode whose GQA group (the chunk's positions folded into the heads)
  exceeds 16.
- `flash_decode` over `QuantizedTensor` K/V against the JAX kernel.

Tolerances: float32 at FP32_TOL (2e-5: both compute q . k_int * scale in
float32, in another order), except FP8, whose subnormal codes the JAX
kernel expands by bit shifts into float32 subnormals that XLA flushes to
zero (`ops/quantization.py` `fp8_expand_bits`: an error below absmax *
2^-14 a value) where the port decodes them exactly: FP8 is held at
FP32_TOL + 2^-14 * absmax of the pages.  bf16 queries at MIXED_TOL, on
unit-scale pages (the JAX kernel rounds q * scale * log2(e) to bf16, an
error that grows with the scores).
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.descriptors.precision import (
    OperandPrecision as JP,
)
from metal_flash_attention_tpu.models import serving as js
from metal_flash_attention_tpu.ops import paged_attention as jpa
from metal_flash_attention_tpu.ops import quantization as jq
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision as TP,
)
from metal_flash_attention_tpu_torch.ops import flash_decode as tfd
from metal_flash_attention_tpu_torch.ops import paged_attention as tpa
from metal_flash_attention_tpu_torch.ops import quantization as tq
from metal_flash_attention_tpu_torch.utils.tolerances import (
    max_abs_err,
    tolerances_for,
)

# The module (the package's `ops` exports the function of the same name).
jfd = importlib.import_module("metal_flash_attention_tpu.ops.flash_decode")

PRECISIONS = ["int8", "fp8_e4m3", "fp8_e5m2", "nf4"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _bits(x) -> np.ndarray:
    """A payload's bytes, from either package."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.asarray(x).view(np.uint8)


def _pages(seed, shape, spread=4.0, tiny=True):
    """Pages of magnitudes up to e^spread apart, so their scales differ;
    with ``tiny`` a few values small enough to land among FP8's subnormals
    after scaling (the quantizer tests).  The attention tests take unit-
    scale pages (spread 1), where the tolerance tiers' absolute limits
    apply."""
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(-spread, min(spread, 3.0), shape[:2] + (1, 1))
                 ).astype(np.float32)
    x = rng.standard_normal(shape).astype(np.float32) * mag
    if tiny:
        x.reshape(-1)[::97] *= 1e-6
    return x


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("shape", [(5, 2, 16, 32), (4, 3, 8, 21)])
def test_quantize_paged_is_bit_equal(precision, shape):
    k, v = _pages(0, shape), _pages(1, shape)
    table = np.array([[1, 3], [2, 4]], np.int32)
    lengths = np.array([20, 9], np.int32)
    j = jpa.quantize_paged(
        jpa.PagedKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                         jnp.asarray(lengths)), JP(precision))
    t = tpa.quantize_paged(
        tpa.PagedKVCache(torch.from_numpy(k), torch.from_numpy(v),
                         torch.from_numpy(table), torch.from_numpy(lengths)),
        TP(precision))
    assert t.precision is TP(precision) and t.page_size == shape[2]
    for name in ("k_pages", "v_pages"):
        got, want = getattr(t, name), getattr(j, name)
        assert got.dtype == TP(precision).storage_dtype
        assert tuple(got.shape) == tuple(want.shape)
        diff = int(np.sum(_bits(got) != _bits(want)))
        assert diff == 0, f"{name}: {diff} payload codes differ"
    for name in ("k_scales", "v_scales"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)))
    assert t.page_table is not None and torch.equal(
        t.lengths, torch.from_numpy(lengths))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_quantize_page_block_matches_serving_flush(precision):
    """The tail flush's quantizer: JAX pads head_dim 24 to 128 lanes of
    zeros, which do not move the absmax; the port keeps 24."""
    x = _pages(2, (3, 2, 16, 24))
    jp_, js_ = js._quantize_page_block(jnp.asarray(x), JP(precision), 128)
    tp_, ts_ = tpa.quantize_page_block(torch.from_numpy(x), TP(precision))
    assert int(np.sum(_bits(tp_) != _bits(jp_)[..., :24])) == 0
    np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
    # The padding the port drops is the code of 0.0.
    zero = 0x77 if precision == "nf4" else 0
    assert np.all(_bits(jp_)[..., 24:] == zero)


def test_dequantize_pages_inverts_the_row_split_nf4_packing():
    """Token r of a page is the low nibble of stored row r, token r +
    page/2 the high nibble: asymmetric pages (token t = t) come back in
    order."""
    ps, d = 8, 4
    x = np.broadcast_to(np.arange(ps, dtype=np.float32)[:, None] - 3.5,
                        (1, 1, ps, d)).copy()
    payload, scale = tpa.quantize_page_block(torch.from_numpy(x), TP.NF4)
    assert tuple(payload.shape) == (1, 1, ps // 2, d)
    got = tpa.dequantize_pages(payload, scale, TP.NF4)[0, 0, :, 0].numpy()
    assert np.all(np.diff(got) > 0), got


def _quantized_case(seed, *, q_heads, kv_heads, d, page_size, lengths,
                    q_chunk, precision):
    """A shuffled page table (page 0 kept null), pools quantized by the
    JAX package, and q."""
    rng = np.random.default_rng(seed)
    batch = len(lengths)
    max_pages = max(-(-n // page_size) for n in lengths) + 1
    num_pages = batch * max_pages + 2
    shape = (num_pages, kv_heads, page_size, d)
    k, v = (_pages(seed + i, shape, spread=0.0, tiny=False)
            for i in (1, 2))
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((batch, max_pages), np.int32)
    for b in range(batch):
        n = -(-lengths[b] // page_size)
        table[b, :n] = perm[b * max_pages:b * max_pages + n]
    q = rng.standard_normal((batch, q_heads, q_chunk, d)).astype(np.float32)
    jcache = jpa.quantize_paged(
        jpa.PagedKVCache(jnp.asarray(k), jnp.asarray(v), jnp.asarray(table),
                         jnp.asarray(np.asarray(lengths, np.int32))),
        JP(precision))
    return q, jcache, max(float(np.abs(k).max()), float(np.abs(v).max()))


def _tolerances(tdt, precision, absmax):
    """(o, lse) limits: the dtype's tier, and for FP8 in float32 the
    JAX kernel's flushed subnormals on top (module docstring)."""
    tol = tolerances_for(tdt)
    extra = (2.0 ** -14 * absmax if tdt == torch.float32
             and precision.startswith("fp8") else 0.0)
    return tol.o + extra, tol.lse + extra


def _port_cache(jcache):
    precision = TP(jcache.precision.value)
    return tpa.QuantizedPagedKVCache(
        *(torch.from_numpy(_bits(x).copy()).view(precision.storage_dtype)
          for x in (jcache.k_pages, jcache.v_pages)),
        *(torch.from_numpy(np.array(x)) for x in (
            jcache.k_scales, jcache.v_scales, jcache.page_table,
            jcache.lengths)), precision)


# (q_heads, kv_heads, head_dim, page_size, lengths, q_chunk): decode at
# page sizes 8 and 16 with a partial last page and an empty row; the
# chunk's folded rows (group 4 x 6 positions = 24 > 16); prefill chunks.
DECODE_CASES = [
    (4, 2, 32, 8, [13, 0, 40], None),
    (8, 2, 64, 16, [33, 20], None),
    (24, 1, 32, 8, [16, 29], None),
]
PREFILL_CASES = [
    (4, 2, 32, 8, [8, 21], 8),
    (8, 2, 64, 16, [16, 35], 12),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("case", DECODE_CASES + PREFILL_CASES)
def test_paged_attention_over_quantized_pools_matches_jax(case, precision,
                                                         dtype):
    qh, kvh, d, ps, lengths, qc = case
    if precision == "nf4":
        ps *= 2
    jdt, tdt = DTYPES[dtype]
    q, jcache, absmax = _quantized_case(3, q_heads=qh, kv_heads=kvh, d=d,
                                        page_size=ps, lengths=lengths,
                                        q_chunk=qc or 1,
                                        precision=precision)
    q = np.array(jnp.asarray(q, jdt).astype(jnp.float32))
    tcache = _port_cache(jcache)
    if qc is None:
        jo, jl = jpa.paged_decode(jnp.asarray(q[:, :, 0], jdt), jcache,
                                  return_residuals=True)
        to, tl = tpa.paged_decode(torch.from_numpy(q[:, :, 0]).to(tdt),
                                  tcache, return_residuals=True)
    else:
        jo, jl = jpa.paged_prefill(jnp.asarray(q, jdt), jcache,
                                   return_residuals=True)
        to, tl = tpa.paged_prefill(torch.from_numpy(q).to(tdt), tcache,
                                   return_residuals=True)
    tol_o, tol_lse = _tolerances(tdt, precision, absmax)
    assert max_abs_err(to, np.asarray(jo.astype(jnp.float32))) < tol_o
    assert max_abs_err(tl, np.asarray(jl)) < tol_lse
    empty = np.asarray(lengths) == 0
    assert np.all(to.float().numpy()[empty] == 0.0)
    assert np.all(np.isneginf(tl.numpy()[empty]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("precision", PRECISIONS)
def test_flash_decode_over_quantized_cache_matches_jax(precision, dtype):
    """A [2, 2, 40, 64] cache (NF4 split-half along D), ragged lengths
    with an empty row, GQA group 2."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(4)
    k, v = (_pages(i, (3, 2, 40, 64), spread=0.0, tiny=False)
            for i in (5, 6))
    q = np.array(jnp.asarray(rng.standard_normal((3, 4, 64)), jdt)
                 .astype(jnp.float32))
    lens = np.array([40, 17, 0], np.int32)
    jk, jv = (jq.quantize(jnp.asarray(x), JP(precision)) for x in (k, v))
    tk, tv = (tq.quantize(torch.from_numpy(x), TP(precision))
              for x in (k, v))
    for jt, tt in ((jk, tk), (jv, tv)):
        assert int(np.sum(_bits(tt.values) != _bits(jt.values))) == 0
    jo, jl = jfd.flash_decode(jnp.asarray(q, jdt), jk, jv,
                              kv_lens=jnp.asarray(lens),
                              return_residuals=True)
    to, tl = tfd.flash_decode(torch.from_numpy(q).to(tdt), tk, tv,
                              kv_lens=torch.from_numpy(lens),
                              return_residuals=True)
    absmax = max(float(np.abs(k).max()), float(np.abs(v).max()))
    tol_o, tol_lse = _tolerances(tdt, precision, absmax)
    assert max_abs_err(to, np.asarray(jo.astype(jnp.float32))) < tol_o
    assert max_abs_err(tl[:2], np.asarray(jl)[:2]) < tol_lse
    assert np.all(to[2].float().numpy() == 0.0)
    assert np.all(np.isneginf(tl[2].numpy()))


def test_quantized_inputs_are_checked():
    cache = tpa.init_paged_cache(num_pages=4, kv_heads=1, page_size=8,
                                 head_dim=16, batch=1, max_pages=2,
                                 dtype=torch.float32, device="cpu")
    q = torch.zeros((1, 2, 16))
    raw = cache._replace(k_pages=cache.k_pages.to(torch.int8),
                         v_pages=cache.v_pages.to(torch.int8))
    with pytest.raises(TypeError, match="QuantizedPagedKVCache"):
        tpa.paged_decode(q, raw)
    with pytest.raises(ValueError, match="streaming KV precision"):
        tpa.quantize_paged(cache, TP.BF16)
    with pytest.raises(ValueError, match="streaming KV precision"):
        tpa.quantize_paged(cache, "int4")
    assert tpa.quantize_paged(cache, "int8").precision is TP.INT8
    assert tpa.quantize_paged(cache, JP.NF4).precision is TP.NF4
    k = tq.quantize(torch.randn(1, 1, 8, 16), TP.INT8)
    with pytest.raises(TypeError, match="both"):
        tfd.flash_decode(q, k, torch.zeros(1, 1, 8, 16))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tfd.flash_decode(q, k, k, logit_softcap=30.0)
