"""GEMM in the PyTorch port against the JAX package.

The same numpy inputs, and the same quantized payloads (JAX's, carried
over with `quantized_matrix_from_numpy`), go through the JAX `gemm` (its
Pallas kernel in interpret mode, as the JAX tests run it on the CPU, or
XLA's dot on the "auto" route) and the port's (`_gemm_plain` on CPU
tensors, or `torch.matmul` on the "auto" route).

Tolerances, the JAX tests' own (`tests/test_gemm_mixed.py`): float32
results at the float32 accumulation tier, `FP32_KERNEL_TOL` (3e-5, the
JAX package's CPU `fp32_kernel_tol`) x (K / 32) x (max |ref| + 1), since
both sides sum the same exactly-rounded products in another order; bf16
and fp16 results at MIXED_TOL.o x (max |ref| + 1), one rounding of the
output apart.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.descriptors.gemm_descriptor import (
    GEMMDescriptor as JaxGEMMDescriptor,
)
from metal_flash_attention_tpu.descriptors.precision import (
    OperandPrecision as JP,
)
from metal_flash_attention_tpu.ops.gemm import (
    batched_gemm as jax_batched_gemm,
    gemm as jax_gemm,
    gemm_chain as jax_gemm_chain,
)
from metal_flash_attention_tpu.ops.quantization import (
    quantize_matrix as jax_quantize_matrix,
)
from metal_flash_attention_tpu_torch.descriptors.gemm_descriptor import (
    GEMMDescriptor,
)
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision as TP,
)
from metal_flash_attention_tpu_torch.native.build import tile_defines
from metal_flash_attention_tpu_torch.ops.quantization import QuantizedMatrix
from metal_flash_attention_tpu_torch.utils.params import (
    quantized_matrix_from_numpy,
)
from metal_flash_attention_tpu_torch.utils.tolerances import MIXED_TOL

tg = importlib.import_module("metal_flash_attention_tpu_torch.ops.gemm")

FP32_KERNEL_TOL = 3e-5
QUANT = ["int8", "fp8_e4m3", "fp8_e5m2", "nf4"]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16,
       "float16": jnp.float16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16,
       "float16": torch.float16}


def _dense(rng, shape, dtype):
    """The same values for both packages, rounded through ``dtype``."""
    x = rng.standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        TDT[dtype])


def _quant(rng, shape, precision, contract_axis, per_channel=False):
    x = rng.standard_normal(shape).astype(np.float32)
    j = jax_quantize_matrix(jnp.asarray(x), JP(precision),
                            contract_axis=contract_axis,
                            per_channel=per_channel)
    t = quantized_matrix_from_numpy(np.asarray(j.values),
                                    np.asarray(j.scale), j.precision,
                                    j.shape, device="cpu")
    return j, t


def _close(got, want, k):
    """Assert the port's result against JAX's at the stated tier."""
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    got_np = got.float().numpy()
    assert got_np.shape == want.shape
    scale = float(np.abs(want).max()) + 1.0
    if got.dtype == torch.float32:
        tol = FP32_KERNEL_TOL * max(k // 32, 1) * scale
    else:
        tol = MIXED_TOL.o * scale
    err = float(np.abs(got_np - want).max())
    assert err <= tol, (err, tol)


def _both(ja, ta, jb, tb, jc=None, tc=None, k=None, **kw):
    jout = jax_gemm(ja, jb, jc, **{key: (JDT[v] if key == "out_dtype"
                                         else v) for key, v in kw.items()})
    tout = tg.gemm(ta, tb, tc, **{key: (TDT[v] if key == "out_dtype"
                                        else v) for key, v in kw.items()})
    assert tout.dtype == TDT[str(jnp.dtype(jout.dtype))]
    _close(tout, jout, k)
    return tout


@pytest.mark.parametrize("precision", QUANT)
def test_quantized_b(precision):
    rng = np.random.default_rng(0)
    m, k, n = 128, 512, 256
    ja, ta = _dense(rng, (m, k), "bfloat16")
    jb, tb = _quant(rng, (k, n), precision, 0)
    _both(ja, ta, jb, tb, k=k, out_dtype="float32")
    _both(ja, ta, jb, tb, k=k)      # default out: bf16 registers -> bf16


@pytest.mark.parametrize("precision", ["int8", "nf4"])
def test_quantized_a(precision):
    rng = np.random.default_rng(1)
    m, k, n = 256, 512, 128
    ja, ta = _quant(rng, (m, k), precision, 1)
    jb, tb = _dense(rng, (k, n), "bfloat16")
    _both(ja, ta, jb, tb, k=k, out_dtype="float32")


def test_int8_times_int8():
    rng = np.random.default_rng(2)
    m = k = n = 256
    ja, ta = _quant(rng, (m, k), "int8", 1)
    jb, tb = _quant(rng, (k, n), "int8", 0)
    _both(ja, ta, jb, tb, k=k, out_dtype="float32")


@pytest.mark.parametrize("ta_,tb_", [(False, False), (False, True),
                                     (True, False), (True, True)])
def test_nf4_all_transpose_layouts(ta_, tb_):
    rng = np.random.default_rng(3)
    m, k, n = 128, 512, 128
    ja, ta = _quant(rng, (k, m) if ta_ else (m, k), "nf4", 0 if ta_ else 1)
    jb, tb = _quant(rng, (n, k) if tb_ else (k, n), "nf4", 1 if tb_ else 0)
    _both(ja, ta, jb, tb, k=k, transpose_a=ta_, transpose_b=tb_,
          out_dtype="float32")


def test_nf4_partial_group():
    """K = 200: one NF4 group, padded by zero codes."""
    rng = np.random.default_rng(4)
    ja, ta = _dense(rng, (64, 200), "bfloat16")
    jb, tb = _quant(rng, (200, 128), "nf4", 0, per_channel=True)
    _both(ja, ta, jb, tb, k=200, out_dtype="float32")


def test_fp16_with_a_quantized_partner():
    rng = np.random.default_rng(5)
    m, k, n = 64, 256, 128
    ja, ta = _dense(rng, (m, k), "float16")
    jb, tb = _quant(rng, (k, n), "int8", 0)
    out = _both(ja, ta, jb, tb, k=k)
    assert out.dtype == torch.bfloat16
    out16 = _both(ja, ta, jb, tb, k=k, out_dtype="float16")
    assert out16.dtype == torch.float16


@pytest.mark.parametrize("precision", ["int8", "fp8_e5m2"])
def test_per_channel_scales(precision):
    rng = np.random.default_rng(6)
    m, k, n = 128, 256, 192
    ja, ta = _quant(rng, (m, k), precision, 1, per_channel=True)
    jb, tb = _quant(rng, (k, n), "nf4", 0, per_channel=True)
    assert tuple(ta.scale.shape) == (m,) and tuple(tb.scale.shape) == (n,)
    _both(ja, ta, jb, tb, k=k, out_dtype="float32")


def test_quantized_with_previous_c():
    """C adds after the scales (out = s * (A B) + C)."""
    rng = np.random.default_rng(7)
    m, k, n = 128, 256, 128
    ja, ta = _dense(rng, (m, k), "bfloat16")
    jb, tb = _quant(rng, (k, n), "int8", 0, per_channel=True)
    jc, tc = _dense(rng, (m, n), "float32")
    _both(ja, ta, jb, tb, jc, tc, k=k, out_dtype="float32")
    _both(ja, ta, jb, tb, jc, tc, k=k)


def test_register_promotion_with_a_quantized_operand():
    rng = np.random.default_rng(8)
    m = k = n = 256
    ja, ta = _dense(rng, (m, k), "float32")
    jb, tb = _quant(rng, (k, n), "int8", 0)
    out = _both(ja, ta, jb, tb, k=k, register_precision="fp32")
    assert out.dtype == torch.float32


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_register_demotion_to_bf16(backend):
    rng = np.random.default_rng(9)
    m = k = n = 256
    ja, ta = _dense(rng, (m, k), "float32")
    jb, tb = _dense(rng, (k, n), "float32")
    out = _both(ja, ta, jb, tb, k=k, backend=backend,
                register_precision="bf16")
    assert out.dtype == torch.float32


def test_invalid_register_precision():
    a = torch.ones((8, 8))
    with pytest.raises(ValueError, match="register_precision"):
        tg.gemm(a, a, register_precision="int8")
    with pytest.raises(ValueError, match="backend"):
        tg.gemm(a, a, backend="mosaic")


@pytest.mark.parametrize("m,k,n", [(7, 127, 257), (127, 513, 7),
                                   (257, 7, 127)])
def test_misaligned_dense_with_c(m, k, n):
    rng = np.random.default_rng(10)
    ja, ta = _dense(rng, (m, k), "bfloat16")
    jb, tb = _dense(rng, (k, n), "bfloat16")
    jc, tc = _dense(rng, (m, n), "float32")
    _both(ja, ta, jb, tb, jc, tc, k=k, backend="pallas",
          out_dtype="float32")
    _both(ja, ta, jb, tb, jc, tc, k=k, block_m=128, block_n=128,
          block_k=128)


@pytest.mark.parametrize("backend", ["auto", "pallas"])
def test_mixed_fp32_times_bf16(backend):
    rng = np.random.default_rng(11)
    m = k = n = 256
    ja, ta = _dense(rng, (m, k), "float32")
    jb, tb = _dense(rng, (k, n), "bfloat16")
    out = _both(ja, ta, jb, tb, k=k, backend=backend)
    assert out.dtype == torch.float32


def test_batched_gemm_dense_and_quantized():
    rng = np.random.default_rng(12)
    bsz, m, k, n = 3, 64, 128, 96
    ja, ta = _dense(rng, (bsz, m, k), "bfloat16")
    jb, tb = _dense(rng, (bsz, k, n), "bfloat16")
    _close(tg.batched_gemm(ta, tb, backend="pallas", out_dtype=torch.float32),
           jax_batched_gemm(ja, jb, backend="pallas",
                            out_dtype=jnp.float32), k)
    qs = [_quant(rng, (k, n), "nf4", 0, per_channel=True)
          for _ in range(bsz)]
    jq = type(qs[0][0])(jnp.stack([q[0].values for q in qs]),
                        jnp.stack([q[0].scale for q in qs]),
                        qs[0][0].precision, qs[0][0].shape)
    tq = QuantizedMatrix(torch.stack([q[1].values for q in qs]),
                         torch.stack([q[1].scale for q in qs]),
                         qs[0][1].precision, qs[0][1].shape)
    _close(tg.batched_gemm(ta, tq, out_dtype=torch.float32),
           jax_batched_gemm(ja, jq, out_dtype=jnp.float32), k)


def test_gemm_chain():
    rng = np.random.default_rng(13)
    jx, tx = _dense(rng, (64, 256), "bfloat16")
    pairs = [_quant(rng, (256, 256), p, 0, per_channel=True)
             for p in ("int8", "nf4")]
    got = tg.gemm_chain(tx, [t for _, t in pairs], out_dtype=torch.float32)
    want = jax_gemm_chain(jx, [j for j, _ in pairs], out_dtype=jnp.float32)
    # Two products: the first's float32 output feeds the second, so the
    # tier is taken over both contractions.
    _close(got, want, 2 * 256)


def test_auto_route_is_the_plain_product():
    """Dense operands without blocks go to torch.matmul on either
    device; the kernel path is not taken (no launch on the CPU ever)."""
    rng = np.random.default_rng(14)
    ja, ta = _dense(rng, (96, 160), "bfloat16")
    jb, tb = _dense(rng, (160, 64), "bfloat16")
    out = _both(ja, ta, jb, tb, k=160)
    assert out.dtype == torch.bfloat16
    _both(ja, ta, jb, tb, k=160, backend="xla", out_dtype="float32")


def test_descriptor_fields_and_flops():
    kw = dict(m=8192, n=14336, k=4096, transpose_a=False, transpose_b=True,
              batch=2, load_previous_c=True)
    j = JaxGEMMDescriptor(precision_a=JP.BF16, precision_b=JP.NF4, **kw)
    t = GEMMDescriptor(precision_a=TP.BF16, precision_b=TP.NF4, **kw)
    assert t.flops == j.flops == 2 * 2 * 8192 * 14336 * 4096
    for field in ("m", "n", "k", "transpose_a", "transpose_b", "batch",
                  "load_previous_c"):
        assert getattr(t, field) == getattr(j, field)
    assert t.precision_a.value == j.precision_a.value
    assert t.precision_b.value == j.precision_b.value
    assert t.precision_out is None and j.precision_out is None
    cfg = t.kernel_config()
    tiles = tile_defines()
    assert (cfg.block_m, cfg.block_n, cfg.block_k) == (
        tiles["MFA_GEMM_BLOCK_M"], tiles["MFA_GEMM_BLOCK_N"],
        tiles["MFA_GEMM_BLOCK_K"])
    # The K step divides the NF4 half-group, so a step reads one plane.
    assert 256 % cfg.block_k == 0


def test_k_splits_fill_the_card_without_empty_splits():
    # Llama-3-8B decode (M = 8): w_down's 32 tiles split K nine ways,
    # w_gate's 112 tiles three ways; a prefill's tiles fill the card.
    assert tg.k_splits(8, 4096, 14336, 1, 132, 128, 128, 32) == (9, 1600)
    assert tg.k_splits(8, 14336, 4096, 1, 132, 128, 128, 32) == (3, 1376)
    assert tg.k_splits(8192, 14336, 4096, 1, 132, 128, 128, 32) == (1, 4096)
    # Short K keeps at least 8 steps a split, and every split has work.
    for m, n, k in ((8, 128, 300), (1, 256, 4096), (16, 4096, 14335)):
        splits, per = tg.k_splits(m, n, k, 1, 132, 128, 128, 32)
        assert per % 32 == 0 and (splits - 1) * per < k <= splits * per
        assert splits == 1 or per >= 8 * 32


def test_chunk_loads_need_a_contiguous_aligned_axis():
    """The kernel reads 16-byte chunks only along an axis of stride 1
    whose rows start 16-byte aligned; anything else goes element by
    element (the layouts the card tests cover)."""
    t = torch.zeros((1, 64, 40), dtype=torch.bfloat16)
    assert tg._chunks_ok(t, *t.stride())                 # k contiguous
    assert tg._chunks_ok(t, t.stride(0), 1, t.stride(1))  # rows contiguous
    odd = torch.zeros((1, 64, 41), dtype=torch.bfloat16)
    assert not tg._chunks_ok(odd, *odd.stride())         # 82-byte rows
    shifted = t.view(-1)[1:1 + 64 * 32].view(1, 64, 32)
    assert not tg._chunks_ok(shifted, *shifted.stride())  # start off by 2
    assert not tg._chunks_ok(t, t.stride(0), 40, 2)      # no unit stride


# The kernel's routes (`_route`) and the sm90 tile: decided on the host
# from types, layouts and addresses, so they are checked here without a
# card.  Payloads are allocated, not quantized: only their types, shapes
# and strides matter.

LLAMA_MLP = {"w_gate": (4096, 14336), "w_up": (4096, 14336),
             "w_down": (14336, 4096)}
SM90 = GEMMDescriptor(m=8192, n=1, k=1).kernel_config("sm90")
SM90_DECODE = GEMMDescriptor(m=8, n=1, k=1).kernel_config("sm90")


def _weight(k, n, precision):
    if precision == "bf16":
        return torch.empty((k, n), dtype=torch.bfloat16)
    tp = TP(precision)
    rows = -(-k // 512) * 256 if tp is TP.NF4 else k
    return QuantizedMatrix(torch.empty((rows, n), dtype=tp.storage_dtype),
                           torch.ones(n), tp, (k, n))


def _route_of(a, b, register_dtype=torch.bfloat16, transpose_a=False,
              transpose_b=False):
    a_pay, qa, sa, a_shape = tg._operand_info(a)
    b_pay, qb, sb, b_shape = tg._operand_info(b)
    m, k = a_shape[::-1] if transpose_a else a_shape
    n = b_shape[0] if transpose_b else b_shape[1]
    ops = tg._Operands(a_pay, qa, sa, b_pay, qb, sb, m, n, k, transpose_a,
                       transpose_b, False)
    return tg._route(ops, register_dtype)


@pytest.mark.parametrize("precision", ["bf16"] + QUANT)
@pytest.mark.parametrize("name", sorted(LLAMA_MLP))
@pytest.mark.parametrize("tokens", [8192, 8])
def test_route_main_path_goes_to_sm90(precision, name, tokens):
    """Every product of the quantized MLP (and its bf16 weight) takes
    the TMA / wgmma kernel."""
    k, n = LLAMA_MLP[name]
    x = torch.empty((tokens, k), dtype=torch.bfloat16)
    assert _route_of(x, _weight(k, n, precision)) == "sm90"


def test_route_dense_4096_cube_goes_to_sm90():
    a = torch.empty((4096, 4096), dtype=torch.bfloat16)
    assert _route_of(a, torch.empty((4096, 4096),
                                    dtype=torch.bfloat16)) == "sm90"


def test_route_sends_the_rest_to_mma():
    a = torch.empty((64, 256), dtype=torch.bfloat16)
    w8 = _weight(256, 128, "int8")
    assert _route_of(a, w8) == "sm90"
    # fp32 registers, or an fp32 operand under bf16 registers.
    assert _route_of(a, w8, register_dtype=torch.float32) == "mma"
    assert _route_of(a.float(), w8) == "mma"
    # A quantized A, alone or against a quantized B.
    qa = QuantizedMatrix(torch.empty((64, 256), dtype=torch.int8),
                         torch.ones(64), TP.INT8, (64, 256))
    assert _route_of(qa, torch.empty((256, 128), dtype=torch.bfloat16)) \
        == "mma"
    assert _route_of(qa, w8) == "mma"
    # B stored [N, K] (K contiguous) and A stored [K, M].
    assert _route_of(a, torch.empty((128, 256), dtype=torch.bfloat16),
                     transpose_b=True) == "mma"
    assert _route_of(torch.empty((256, 64), dtype=torch.bfloat16), w8,
                     transpose_a=True) == "mma"
    # Rows that are no 16-byte multiple: A's 1,026 bytes, B's 136.
    assert _route_of(torch.empty((64, 513), dtype=torch.bfloat16),
                     torch.empty((513, 128), dtype=torch.bfloat16)) == "mma"
    assert _route_of(a, _weight(256, 136, "int8")) == "mma"
    # A base off a 16-byte boundary.
    shifted = torch.empty(64 * 256 + 8, dtype=torch.bfloat16)[1:]
    assert _route_of(shifted[:64 * 256].view(64, 256), w8) == "mma"
    # The same rows in padded storage are fine.
    padded = torch.empty((64, 264), dtype=torch.bfloat16)[:, :250]
    assert _route_of(padded, _weight(250, 128, "int8")) == "sm90"


def test_route_on_a_cpu_tensor_builds_no_library(monkeypatch):
    """A call that `_route` would send to sm90 on the card runs the plain
    version on the CPU, without asking for the CUDA library."""
    def refuse():
        raise AssertionError("the CPU path asked for the CUDA library")
    monkeypatch.setattr(tg, "_kernel_library", refuse)
    rng = np.random.default_rng(15)
    _, ta = _dense(rng, (8, 64), "bfloat16")
    _, tb = _quant(rng, (64, 128), "int8", 0, per_channel=True)
    assert _route_of(ta, tb) == "sm90"
    before = dict(tg.LAUNCH_COUNTS)
    assert tg.gemm(ta, tb).shape == (8, 128)
    assert tg.gemm(ta, ta.T.contiguous(), backend="pallas").shape == (8, 8)
    assert tg.LAUNCH_COUNTS == before


def test_kernel_config_gives_each_routes_tile():
    tiles = tile_defines()
    d = GEMMDescriptor(m=8, n=4096, k=14336)
    assert (SM90.block_m, SM90.block_n, SM90.block_k) == (
        tiles["MFA_GEMM90_BLOCK_M"], tiles["MFA_GEMM90_BLOCK_N"],
        tiles["MFA_GEMM90_BLOCK_K"])
    # A decode batch takes the narrower tile, one M tile more than that
    # the wide one.
    assert SM90_DECODE == dataclasses.replace(
        SM90, block_n=tiles["MFA_GEMM90_BLOCK_N_DECODE"])
    edge = tiles["MFA_GEMM90_DECODE_M"]
    assert GEMMDescriptor(m=edge, n=1, k=1).kernel_config("sm90") == \
        SM90_DECODE
    assert GEMMDescriptor(m=edge + 1, n=1, k=1).kernel_config("sm90") == \
        SM90
    assert d.kernel_config("mma") == d.kernel_config()
    assert d.kernel_config("sm90") == SM90_DECODE
    # A quantized B takes the taller tile past a decode batch.
    for precision in (TP.INT8, TP.FP8_E4M3, TP.NF4):
        cfg = GEMMDescriptor(m=edge + 1, n=1, k=1, precision_a=TP.BF16,
                             precision_b=precision).kernel_config("sm90")
        assert (cfg.block_m, cfg.block_n, cfg.block_k) == (
            tiles["MFA_GEMM90_QUANT_BLOCK_M"],
            tiles["MFA_GEMM90_QUANT_BLOCK_N"], SM90.block_k)
        assert GEMMDescriptor(m=edge, n=1, k=1, precision_b=precision
                              ).kernel_config("sm90") == SM90_DECODE
    # A K step inside one NF4 nibble plane; stages for a ring.
    assert 256 % SM90.block_k == 0 and tiles["MFA_GEMM90_STAGES"] >= 2
    with pytest.raises(ValueError, match="route"):
        d.kernel_config("wgmma")


@pytest.mark.parametrize("precision", [TP.BF16, TP.INT8])
@pytest.mark.parametrize("name", sorted(LLAMA_MLP))
@pytest.mark.parametrize("tokens", [8192, 8, 1])
def test_k_splits_with_the_sm90_tile(name, tokens, precision):
    """Every split a whole number of 64-deep K steps, none empty, and a
    decode batch split until the card has about two blocks an SM."""
    k, n = LLAMA_MLP[name]
    cfg = GEMMDescriptor(m=tokens, n=n, k=k, precision_a=TP.BF16,
                         precision_b=precision).kernel_config("sm90")
    splits, per = tg.k_splits(tokens, n, k, 1, 132, cfg.block_m,
                              cfg.block_n, cfg.block_k)
    assert per % cfg.block_k == 0
    assert (splits - 1) * per < k <= splits * per
    tiles = -(-tokens // cfg.block_m) * -(-n // cfg.block_n)
    if tiles >= 132:
        assert splits == 1
    else:
        assert tiles * splits >= 2 * 132 or per == \
            tg.MIN_STEPS_PER_SPLIT * cfg.block_k


def test_k_splits_w_down_at_a_decode_batch():
    # 32 output tiles, 224 K steps: 9 splits of 25 steps, 288 blocks.
    tile = (SM90_DECODE.block_m, SM90_DECODE.block_n, SM90_DECODE.block_k)
    assert tg.k_splits(8, 4096, 14336, 1, 132, *tile) == (9, 1600)
    assert tg.k_splits(8, 14336, 4096, 1, 132, *tile) == (3, 1408)
