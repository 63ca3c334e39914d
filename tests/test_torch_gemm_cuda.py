"""The GEMM and softmax CUDA kernels against their plain PyTorch versions,
on the card.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
that launches a kernel skips with its reason.  The file imports neither
JAX nor the JAX package, so it also runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -q tests/test_torch_gemm_cuda.py

The plain versions run on the card too (`_gemm_plain`, float32 products
of the same register-rounded values; PyTorch leaves TF32 off for float32
products, which the tests assert).  Tolerances: a float32 result sums
the same exact products in another order, `FP32_TOL` x (K / 32) x (max
|ref| + 1); a bf16 or fp16 result may land one rounding of the output
away, 2^-7 x (max |ref| + 1).  Softmax: float32 2e-6 (P) and 1e-5 (dS),
as the JAX tests' tiers; bf16 and fp16 one rounding of the output.
"""

import importlib

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision as P,
)
from metal_flash_attention_tpu_torch.ops import quantization as tq
from metal_flash_attention_tpu_torch.ops import softmax as ts

tg = importlib.import_module("metal_flash_attention_tpu_torch.ops.gemm")

FP32_TOL = 3e-5
ROUNDING = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
QUANT = [P.INT8, P.FP8_E4M3, P.FP8_E5M2, P.NF4]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernel has no CPU mode")
    assert not torch.backends.cuda.matmul.allow_tf32
    return torch.device("cuda")


def _dense(seed, shape, dtype, device):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.standard_normal(shape).astype(
        np.float32)).to(device=device, dtype=dtype)


def _quant(seed, shape, precision, contract_axis, device,
           per_channel=False):
    x = _dense(seed, shape, torch.float32, device)
    return tq.quantize_matrix(x, precision, contract_axis=contract_axis,
                              per_channel=per_channel)


def _assert_close(got, want, scale, k, out_dtype):
    err = float((got.float() - want.float()).abs().max())
    if out_dtype == torch.float32:
        tol = FP32_TOL * max(k // 32, 1) * scale
    else:
        tol = ROUNDING[out_dtype] * scale
    assert err <= tol, (err, tol)


def _padded(x, cols):
    """x [..., rows, cols] as a view whose rows lie 16-byte multiples
    apart (the storage padded to `cols` columns)."""
    buf = torch.zeros((*x.shape[:-1], cols), dtype=x.dtype, device=x.device)
    buf[..., :x.shape[-1]] = x
    return buf[..., :x.shape[-1]]


def _padded_quant(q, cols):
    """A QuantizedMatrix whose payload rows lie `cols` bytes apart."""
    return tq.QuantizedMatrix(_padded(q.values, cols), q.scale, q.precision,
                              q.shape)


def run_case(a, b, c=None, *, k, batched=False, sm90=None, **kw):
    """One kernel launch against `_gemm_plain`; `sm90` True / False
    asserts that the launch took / did not take the sm90 route."""
    before = dict(tg.LAUNCH_COUNTS)
    if batched:
        got = tg.batched_gemm(a, b, c=c, **kw)
    else:
        got = tg.gemm(a, b, c, **kw)
    torch.cuda.synchronize()
    assert tg.LAUNCH_COUNTS["gemm"] == before["gemm"] + 1
    if sm90 is not None:
        assert tg.LAUNCH_COUNTS["gemm_sm90"] == before["gemm_sm90"] + int(
            sm90)
    want = tg._gemm_plain(a, b, c, batched=batched, **kw)
    assert got.dtype == want.dtype and got.shape == want.shape
    _assert_close(got, want, float(want.float().abs().max()) + 1.0, k,
                  got.dtype)
    return got


@pytest.mark.parametrize("precision", QUANT)
@pytest.mark.parametrize("out_dtype", [torch.float32, None])
def test_quantized_b(cuda, precision, out_dtype):
    a = _dense(0, (128, 512), torch.bfloat16, cuda)
    b = _quant(1, (512, 256), precision, 0, cuda)
    run_case(a, b, k=512, out_dtype=out_dtype)


@pytest.mark.parametrize("precision", [P.INT8, P.NF4])
def test_quantized_a(cuda, precision):
    a = _quant(2, (256, 512), precision, 1, cuda)
    b = _dense(3, (512, 128), torch.bfloat16, cuda)
    run_case(a, b, k=512, out_dtype=torch.float32)


def test_int8_times_int8(cuda):
    a = _quant(4, (256, 256), P.INT8, 1, cuda)
    b = _quant(5, (256, 256), P.INT8, 0, cuda)
    run_case(a, b, k=256, out_dtype=torch.float32)


@pytest.mark.parametrize("ta,tb", [(False, False), (False, True),
                                   (True, False), (True, True)])
def test_nf4_all_transpose_layouts(cuda, ta, tb):
    m, k, n = 192, 1100, 136     # three NF4 groups, ragged tiles
    a = _quant(6, (k, m) if ta else (m, k), P.NF4, 0 if ta else 1, cuda,
               per_channel=True)
    b = _quant(7, (n, k) if tb else (k, n), P.NF4, 1 if tb else 0, cuda,
               per_channel=True)
    run_case(a, b, k=k, transpose_a=ta, transpose_b=tb,
             out_dtype=torch.float32)


def test_fp16_with_a_quantized_partner(cuda):
    a = _dense(8, (64, 256), torch.float16, cuda)
    b = _quant(9, (256, 128), P.FP8_E4M3, 0, cuda, per_channel=True)
    assert run_case(a, b, k=256).dtype == torch.bfloat16
    assert run_case(a, b, k=256,
                    out_dtype=torch.float16).dtype == torch.float16


@pytest.mark.parametrize("precision", QUANT)
def test_per_channel_scales_and_c(cuda, precision):
    a = _quant(10, (130, 300), precision, 1, cuda, per_channel=True)
    b = _quant(11, (300, 200), P.INT8, 0, cuda, per_channel=True)
    c = _dense(12, (130, 200), torch.float32, cuda)
    run_case(a, b, c, k=300, out_dtype=torch.float32)
    run_case(a, b, c.to(torch.bfloat16), k=300)


def test_register_promotion_and_demotion(cuda):
    a32 = _dense(13, (256, 256), torch.float32, cuda)
    b = _quant(14, (256, 256), P.INT8, 0, cuda)
    assert run_case(a32, b, k=256, register_precision="fp32").dtype == \
        torch.float32
    b32 = _dense(15, (256, 256), torch.float32, cuda)
    run_case(a32, b32, k=256, backend="pallas", register_precision="bf16")
    a16 = _dense(16, (256, 256), torch.bfloat16, cuda)
    run_case(a16, b, k=256, register_precision="fp32")
    with pytest.raises(ValueError, match="register_precision"):
        tg.gemm(a16, b, register_precision="fp8")


@pytest.mark.parametrize("m,k,n", [(7, 127, 257), (127, 513, 7),
                                   (257, 7, 127), (513, 257, 129)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_misaligned_dense_with_c(cuda, m, k, n, dtype):
    """Ragged M, N and K; fp32 operands are true fp32 (CUDA-core FMA)."""
    a = _dense(17, (m, k), dtype, cuda)
    b = _dense(18, (k, n), dtype, cuda)
    c = _dense(19, (m, n), torch.float32, cuda)
    run_case(a, b, c, k=k, backend="pallas", out_dtype=torch.float32)
    run_case(a, b, None, k=k, block_m=64, block_n=64, block_k=64)


def test_true_fp32_beats_bf16_rounding(cuda):
    """fp32 x fp32 on the kernel route agrees with float64 far below
    bf16's or TF32's rounding."""
    a = _dense(20, (256, 1024), torch.float32, cuda)
    b = _dense(21, (1024, 256), torch.float32, cuda)
    got = tg.gemm(a, b, backend="pallas").double()
    ref = a.double() @ b.double()
    assert float((got - ref).abs().max() / ref.abs().max()) < 1e-5


def test_mixed_fp32_times_bf16(cuda):
    a = _dense(22, (256, 256), torch.float32, cuda)
    b = _dense(23, (256, 256), torch.bfloat16, cuda)
    assert run_case(a, b, k=256, backend="pallas").dtype == torch.float32


@pytest.mark.parametrize("m", [1, 8, 64])
def test_split_k_for_a_small_batch(cuda, m):
    """M at a decode batch: K is split over blocks and summed by the
    second kernel, C before the splits and the scales after."""
    a = _dense(24, (m, 4096), torch.bfloat16, cuda)
    b = _quant(25, (4096, 512), P.NF4, 0, cuda, per_channel=True)
    splits, _ = tg.k_splits(m, 512, 4096, 1, torch.cuda.get_device_properties(
        cuda).multi_processor_count, 128, 128, 32)
    assert splits > 1
    c = _dense(26, (m, 512), torch.float32, cuda)
    run_case(a, b, c, k=4096, out_dtype=torch.float32)
    d = _dense(27, (4096, 512), torch.bfloat16, cuda)
    run_case(a, d, c, k=4096, backend="pallas", out_dtype=torch.float32)


def test_batched_gemm_is_one_launch(cuda):
    a = _dense(28, (3, 64, 200), torch.bfloat16, cuda)
    b = _dense(29, (3, 200, 96), torch.bfloat16, cuda)
    run_case(a, b, k=200, batched=True, backend="pallas",
             out_dtype=torch.float32)
    qs = [_quant(30 + i, (200, 96), P.INT8, 0, cuda, per_channel=True)
          for i in range(3)]
    qb = tq.QuantizedMatrix(torch.stack([q.values for q in qs]),
                            torch.stack([q.scale for q in qs]), P.INT8,
                            (200, 96))
    c = _dense(33, (64, 96), torch.float32, cuda)
    run_case(a, qb, c, k=200, batched=True, out_dtype=torch.float32)


def test_gemm_chain(cuda):
    x = _dense(34, (64, 256), torch.bfloat16, cuda)
    ws = [_quant(35 + i, (256, 256), p, 0, cuda, per_channel=True)
          for i, p in enumerate((P.FP8_E5M2, P.NF4))]
    before = tg.LAUNCH_COUNTS["gemm"]
    got = tg.gemm_chain(x, ws)
    assert tg.LAUNCH_COUNTS["gemm"] == before + 2
    want = x
    for w in ws:
        want = tg._gemm_plain(want, w)
    _assert_close(got, want, float(want.float().abs().max()) + 1.0, 256,
                  torch.bfloat16)


def test_kernel_refuses_what_it_does_not_take(cuda):
    a = _dense(40, (16, 32), torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        tg.gemm(a.double(), a.double().T, backend="pallas")
    b = _quant(41, (32, 16), P.INT8, 0, cuda)
    with pytest.raises(TypeError):
        tg.gemm(a, b, out_dtype=torch.float64)
    with pytest.raises(ValueError):
        tg.gemm(a, tq.QuantizedMatrix(b.values, b.scale.cpu(), b.precision,
                                      b.shape))


# The sm90 route (TMA ring, wgmma): every B class, ragged M, N and K.

SM90_B = ["bf16"] + QUANT


def _b_operand(seed, k, n, precision, device, per_channel=True):
    """B [k, n] in `precision` ("bf16" or a quantized one), its payload
    rows padded to a 16-byte multiple."""
    if precision == "bf16":
        return _padded(_dense(seed, (k, n), torch.bfloat16, device),
                       -(-n // 8) * 8)
    return _padded_quant(_quant(seed, (k, n), precision, 0, device,
                                per_channel=per_channel), -(-n // 16) * 16)


@pytest.mark.parametrize("precision", SM90_B)
@pytest.mark.parametrize("m", [1, 8, 65, 300])
@pytest.mark.parametrize("n", [136, 200])
def test_sm90_every_b_class_ragged(cuda, precision, m, n):
    k = 1000                                  # 15 K steps and 40 more
    a = _dense(70, (m, k), torch.bfloat16, cuda)
    b = _b_operand(71, k, n, precision, cuda)
    kw = {"backend": "pallas"} if precision == "bf16" else {}
    run_case(a, b, k=k, sm90=True, out_dtype=torch.float32, **kw)


@pytest.mark.parametrize("m", [8, 192])
def test_sm90_nf4_three_groups_both_planes(cuda, m):
    k, n = 1100, 256                          # groups 0, 1 and part of 2
    a = _padded(_dense(72, (m, k), torch.bfloat16, cuda), 1104)
    b = _quant(73, (k, n), P.NF4, 0, cuda, per_channel=True)
    run_case(a, b, k=k, sm90=True, out_dtype=torch.float32)


@pytest.mark.parametrize("k", [4096, 14336])
@pytest.mark.parametrize("precision", ["bf16", P.INT8, P.NF4])
def test_sm90_split_k_at_a_decode_batch(cuda, k, precision):
    m, n = 8, 512
    cfg = tg.GEMMDescriptor(m=m, n=n, k=k).kernel_config("sm90")
    splits, per = tg.k_splits(m, n, k, 1, torch.cuda.get_device_properties(
        cuda).multi_processor_count, cfg.block_m, cfg.block_n, cfg.block_k)
    assert splits > 1 and per % cfg.block_k == 0
    a = _dense(74, (m, k), torch.bfloat16, cuda)
    b = _b_operand(75, k, n, precision, cuda)
    c = _dense(76, (m, n), torch.float32, cuda)
    kw = {"backend": "pallas"} if precision == "bf16" else {}
    run_case(a, b, c, k=k, sm90=True, out_dtype=torch.float32, **kw)
    run_case(a, b, k=k, sm90=True, **kw)


def test_sm90_c_seeds_a_dense_sum_and_follows_the_scales(cuda):
    a = _dense(77, (130, 512), torch.bfloat16, cuda)
    c = _dense(78, (130, 192), torch.float32, cuda)
    d = _dense(79, (512, 192), torch.bfloat16, cuda)
    run_case(a, d, c, k=512, sm90=True, backend="pallas",
             out_dtype=torch.float32)
    for per_channel in (False, True):
        for precision in QUANT:
            b = _quant(80, (512, 192), precision, 0, cuda,
                       per_channel=per_channel)
            run_case(a, b, c, k=512, sm90=True, out_dtype=torch.float32)
            run_case(a, b, c.to(torch.bfloat16), k=512, sm90=True)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16,
                                       torch.float16])
@pytest.mark.parametrize("precision", ["bf16", P.FP8_E4M3])
def test_sm90_output_types(cuda, out_dtype, precision):
    a = _dense(81, (200, 384), torch.bfloat16, cuda)
    b = _b_operand(82, 384, 256, precision, cuda)
    kw = {"backend": "pallas"} if precision == "bf16" else {}
    got = run_case(a, b, k=384, sm90=True, out_dtype=out_dtype, **kw)
    assert got.dtype == out_dtype


def test_sm90_batched_gemm_is_one_launch(cuda):
    a = _dense(83, (3, 100, 200), torch.bfloat16, cuda)
    b = _dense(84, (3, 200, 96), torch.bfloat16, cuda)
    run_case(a, b, k=200, batched=True, sm90=True, backend="pallas",
             out_dtype=torch.float32)
    for precision in QUANT:
        qs = [_quant(85 + i, (200, 96), precision, 0, cuda, per_channel=True)
              for i in range(3)]
        qb = tq.QuantizedMatrix(torch.stack([q.values for q in qs]),
                                torch.stack([q.scale for q in qs]),
                                precision, (200, 96))
        c = _dense(88, (100, 96), torch.float32, cuda)
        run_case(a, qb, c, k=200, batched=True, sm90=True,
                 out_dtype=torch.float32)


@pytest.mark.parametrize("precision", QUANT)
def test_sm90_decodes_every_code_exactly(cuda, precision):
    """The identity times a payload holding every code (row k holds code
    k; NF4's 16 in the low plane) reads back each code's value exactly,
    FP8 subnormals included; FP8's NaN and infinity codes, which
    quantize_matrix never writes, are left out."""
    k, n = 256, 16
    codes = torch.arange(k, dtype=torch.int64)
    if precision is P.FP8_E4M3:
        codes[(codes & 0x7F) == 0x7F] = 0
    elif precision is P.FP8_E5M2:
        codes[(codes & 0x7C) == 0x7C] = 0
    elif precision is P.NF4:
        codes = codes % 16
    pay = codes.to(torch.uint8).view(precision.storage_dtype)
    pay = pay[:, None].expand(k, n).contiguous().to(cuda)
    b = tq.QuantizedMatrix(pay, torch.ones((), device=cuda), precision,
                           (k, n))
    eye = torch.eye(k, dtype=torch.bfloat16, device=cuda)
    before = tg.LAUNCH_COUNTS["gemm_sm90"]
    got = tg.gemm(eye, b, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert tg.LAUNCH_COUNTS["gemm_sm90"] == before + 1
    want = tg._gemm_plain(eye, b, out_dtype=torch.float32)
    assert torch.isfinite(want).all()
    assert torch.equal(got, want)


def test_mma_route_takes_what_sm90_does_not(cuda):
    """fp32 registers, a quantized A, quantized x quantized, B stored
    [N, K], and rows TMA cannot describe keep the mma kernel."""
    a16 = _dense(90, (96, 256), torch.bfloat16, cuda)
    b8 = _quant(91, (256, 128), P.INT8, 0, cuda)
    run_case(a16, b8, k=256, sm90=False, register_precision="fp32")
    qa = _quant(92, (96, 256), P.NF4, 1, cuda)
    run_case(qa, _dense(93, (256, 128), torch.bfloat16, cuda), k=256,
             sm90=False, out_dtype=torch.float32)
    run_case(qa, b8, k=256, sm90=False, out_dtype=torch.float32)
    bt = _dense(94, (128, 256), torch.bfloat16, cuda)
    run_case(a16, bt, k=256, sm90=False, transpose_b=True, backend="pallas",
             out_dtype=torch.float32)
    odd = _dense(95, (96, 513), torch.bfloat16, cuda)    # 1,026-byte rows
    run_case(odd, _dense(96, (513, 128), torch.bfloat16, cuda), k=513,
             sm90=False, backend="pallas", out_dtype=torch.float32)
    run_case(a16, _quant(97, (256, 136), P.INT8, 0, cuda), k=256,
             sm90=False, out_dtype=torch.float32)        # 136-byte rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
@pytest.mark.parametrize("shape", [(3, 50, 777), (64, 8192), (7, 1),
                                   (2, 9, 129)])
def test_softmax_kernels_match_plain(cuda, dtype, shape):
    rng = np.random.default_rng(50)
    s = torch.as_tensor(rng.standard_normal(shape).astype(np.float32) * 3,
                        device=cuda).to(dtype)
    dp = torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                         device=cuda).to(dtype)
    before = dict(ts.LAUNCH_COUNTS)
    p = ts.scaled_softmax(s)
    ds = ts.derivative_softmax(p, dp, scale=0.5)
    torch.cuda.synchronize()
    assert ts.LAUNCH_COUNTS == {k: v + 1 for k, v in before.items()}
    want_p = ts._scaled_softmax_plain(s, 1.0 / shape[-1] ** 0.5)
    want_ds = ts._derivative_softmax_plain(p, dp, 0.5)
    assert p.dtype == ds.dtype == dtype
    for got, want, tier in ((p, want_p, 2e-6), (ds, want_ds, 1e-5)):
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        assert err <= (tier if dtype == torch.float32
                       else ROUNDING[dtype] * scale), err


def test_softmax_strided_rows_mixed_types_and_extremes(cuda):
    rng = np.random.default_rng(51)
    full = torch.as_tensor(rng.standard_normal((32, 300)).astype(
        np.float32) * 1e4, device=cuda)
    s = full[:, 8:264]                       # rows 300 apart, unaligned
    p = ts.scaled_softmax(s, scale=1.0)
    assert torch.isfinite(p).all()
    assert float((p.sum(-1) - 1).abs().max()) < 1e-5
    want = ts._scaled_softmax_plain(s, 1.0)
    assert float((p - want).abs().max()) < 2e-6
    dp = torch.as_tensor(rng.standard_normal((32, 256)).astype(np.float32),
                         device=cuda).to(torch.bfloat16)
    ds = ts.derivative_softmax(p, dp)        # fp32 P, bf16 dP
    want = ts._derivative_softmax_plain(p, dp, 1.0)
    assert ds.dtype == torch.float32
    assert float((ds - want).abs().max()) < 1e-5


def test_a_cpu_tensor_never_builds_the_kernels(monkeypatch):
    """The CPU path takes the plain versions without asking for a
    library (this test needs no card)."""
    def refuse():
        raise AssertionError("the CPU path asked for the CUDA library")
    monkeypatch.setattr(tg, "_kernel_library", refuse)
    monkeypatch.setattr(ts, "_kernel_library", refuse)
    before = (dict(tg.LAUNCH_COUNTS), dict(ts.LAUNCH_COUNTS))
    a = _dense(60, (16, 40), torch.bfloat16, "cpu")
    b = _quant(61, (40, 24), P.NF4, 0, "cpu")
    assert tg.gemm(a, b).shape == (16, 24)
    assert tg.gemm(a, a.T, backend="pallas").shape == (16, 16)
    ts.derivative_softmax(ts.scaled_softmax(a), a)
    assert (dict(tg.LAUNCH_COUNTS), dict(ts.LAUNCH_COUNTS)) == before
