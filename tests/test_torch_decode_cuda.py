"""The dense decode CUDA kernel against its plain PyTorch version, on the
card.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
that launches the kernel skips with its reason.  The file imports
neither JAX nor the JAX package, so it also runs on a machine that has
only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_decode_cuda.py

The kernel computes fp32 inputs in float32 on CUDA cores, and bf16 and
fp16 inputs on tensor cores with float32 sums and P rounded to the input
type before PV; it is held against the plain version run on the same
values in float32: they differ by the order of float32 sums and by the
rounding of P and of o to the input type.  fp32 o and every lse: the
dtype's tier (`tolerances_for`).  bf16 and fp16 o: the relative rms
error of each (sequence, head) row, `ROW_REL_RMS`, since a max abs limit
of 5e-2 would pass almost any output where |o| is about 0.03 (a row of
1,000 keys with N(0, 1) values).  Over a quantized cache (INT8 / FP8 /
NF4 `QuantizedTensor`s, bf16 queries) the plain version dequantizes in
float32 (NF4's codebook rounded to bf16, as the kernel rounds it): o at
the bf16 row limit, lse at the bf16 tier.  Gemma-2's cases (head_dim
256, the soft cap, a window as kv_starts) are held at the same limits,
beside a planted fault (the cap left out) that the row limit must see.
"""

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.models import llama, serving
from metal_flash_attention_tpu_torch.ops import flash_attention as fa
from metal_flash_attention_tpu_torch.ops import flash_decode as fd
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.ops.quantization import quantize
from metal_flash_attention_tpu_torch.utils.tolerances import (
    max_abs_err,
    tolerances_for,
)

# A few times the rounding of o to the type (relative rms about 0.2% for
# bf16 and 0.03% for fp16); one dropped key of a 1,000-key row moves its
# row by about 3%.
ROW_REL_RMS = {torch.bfloat16: 1e-2, torch.float16: 2e-3}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(seed, *, batch, q_heads, kv_heads, d, max_seq, dtype, device,
         cache_seq=None):
    """q and K/V; with ``cache_seq`` K/V are the [8, 8 + max_seq) slice of
    a longer cache (strided along batch and head)."""
    rng = np.random.default_rng(seed)
    full = cache_seq or max_seq

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)
    q = t(batch, q_heads, d)
    k, v = t(batch, kv_heads, full, d), t(batch, kv_heads, full, d)
    if cache_seq is not None:
        k, v = k[:, :, 8:8 + max_seq], v[:, :, 8:8 + max_seq]
    return q, k, v


def worst_row_rel_rms(got, ref):
    """The largest ||got - ref|| / ||ref|| over the rows (last axis) of
    two [..., d] tensors; a row whose reference is 0 must be 0 too."""
    got, ref = got.float(), ref.float()
    err, norm = (got - ref).pow(2).sum(-1), ref.pow(2).sum(-1)
    live = norm > 0
    assert (err[~live] == 0).all()
    return float((err[live] / norm[live]).sqrt().max()) if live.any() \
        else 0.0


def _ints(x, device):
    return None if x is None else torch.tensor(x, dtype=torch.int32,
                                               device=device)


# (q_heads, kv_heads, d, max_seq, lens, starts, max_span, cache_seq)
CASES = [
    (4, 4, 64, 200, [13, 0, 200, 1], None, None, None),       # group 1
    (32, 8, 128, 1100, [1100, 1, 64, 65, 1023], None, None, None),
    # Windows, one start past its row's length.
    (8, 2, 128, 500, [500, 77, 3], [400, 76, 5], None, None),
    # max_span, and one span longer than it (clamped).
    (16, 4, 64, 300, [300, 129, 50], [100, 29, 0], 128, None),
    (32, 8, 128, 600, [600, 300], [88, 0], 512, 700),          # strided
    (64, 4, 128, 256, [256, 255], None, None, None),            # group 16
    (8, 8, 64, 64, [64, 63], None, None, 128),
    (32, 8, 128, 96, None, None, None, None),                   # full cache
    # Batch 1 at 8,192 keys: many chunks.
    (32, 8, 128, 8192, [8192], None, None, None),
    # Starts and spans in the middle of chunks.
    (32, 8, 128, 8192, [8192, 6000, 7777], [1000, 4100, 7000], 3000, None),
    # A row whose live keys are the cache's last few, beside a full row
    # and a one-key row.
    (16, 4, 64, 4096, [4096, 4096, 1], [4090, 0, 0], None, None),
    # Head dim 32 (the tiny configs'): an empty row, starts and spans, a
    # group of 16, a strided slice, many chunks.
    (4, 2, 32, 200, [13, 0, 200, 1], None, None, None),
    (16, 4, 32, 300, [300, 129, 50], [100, 29, 0], 128, None),
    (64, 4, 32, 256, [256, 255], None, None, None),
    (8, 2, 32, 600, [600, 300], [88, 0], 512, 700),
    (4, 2, 32, 8192, [8192, 6000, 7777], [1000, 4100, 7000], 3000, None),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("qh,kvh,d,n,lens,starts,span,cache_seq", CASES)
def test_decode_kernel_matches_plain(cuda, dtype, qh, kvh, d, n, lens,
                                     starts, span, cache_seq):
    q, k, v = _qkv(0, batch=len(lens) if lens else 2, q_heads=qh,
                   kv_heads=kvh, d=d, max_seq=n, dtype=dtype, device=cuda,
                   cache_seq=cache_seq)
    lens_t, starts_t = _ints(lens, cuda), _ints(starts, cuda)
    before = dict(fd.LAUNCH_COUNTS)
    o, lse = fd.flash_decode(q, k, v, kv_lens=lens_t, kv_starts=starts_t,
                             max_span=span, return_residuals=True)
    torch.cuda.synchronize()
    for name in ("flash_decode", "flash_decode_sm90"):
        assert fd.LAUNCH_COUNTS[name] == before[name] + 1
    assert fd.LAUNCH_COUNTS["flash_decode_d32"] == \
        before["flash_decode_d32"] + (d == 32)
    po, plse = fd._flash_decode_plain(q.float(), k.float(), v.float(),
                                      kv_lens=lens_t, kv_starts=starts_t,
                                      max_span=span, scale=d ** -0.5)
    tol = tolerances_for(dtype)
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        assert max_abs_err(o, po) <= tol.o
    else:
        assert worst_row_rel_rms(o, po) <= ROW_REL_RMS[dtype]
    assert max_abs_err(lse, plse) <= tol.lse
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))
    assert (o[torch.isinf(lse)] == 0).all()


@pytest.mark.parametrize("precision", ["int8", "fp8_e4m3", "fp8_e5m2",
                                       "nf4"])
@pytest.mark.parametrize("qh,kvh,d,n,lens,starts,span", [
    # The generate shape, ragged, a one-key row.
    (32, 8, 128, 8192, [8192, 8191, 7000, 4097, 2048, 129, 64, 1], None,
     None),
    (8, 2, 64, 300, [300, 0, 77], None, None),                # empty row
    (16, 4, 128, 600, [600, 300], [88, 0], 512),              # windows
    # Head dim 32: an NF4 row is 16 bytes, a tile 64 pieces.
    (8, 2, 32, 300, [300, 0, 77], None, None),
    (16, 4, 32, 600, [600, 300], [88, 0], 512),
])
def test_quantized_decode_kernel_matches_plain(cuda, precision, qh, kvh, d,
                                               n, lens, starts, span):
    q, k, v = _qkv(4, batch=len(lens), q_heads=qh, kv_heads=kvh, d=d,
                   max_seq=n, dtype=torch.bfloat16, device=cuda)
    prec = OperandPrecision(precision)
    kq, vq = quantize(k, prec), quantize(v, prec)
    lens_t, starts_t = _ints(lens, cuda), _ints(starts, cuda)
    before = dict(fd.LAUNCH_COUNTS)
    o, lse = fd.flash_decode(q, kq, vq, kv_lens=lens_t, kv_starts=starts_t,
                             max_span=span, return_residuals=True)
    torch.cuda.synchronize()
    for name in ("flash_decode", "flash_decode_sm90",
                 f"flash_decode_{precision}"):
        assert fd.LAUNCH_COUNTS[name] == before[name] + 1
    assert fd.LAUNCH_COUNTS["flash_decode_d32"] == \
        before["flash_decode_d32"] + (d == 32)
    po, plse = fd._flash_decode_plain(q, kq, vq, kv_lens=lens_t,
                                      kv_starts=starts_t, max_span=span,
                                      scale=d ** -0.5)
    assert worst_row_rel_rms(o, po) <= ROW_REL_RMS[torch.bfloat16]
    assert max_abs_err(lse, plse) <= tolerances_for(torch.bfloat16).lse
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))


def test_decode_step_quantized_launches_two_decodes_a_layer(cuda):
    """A tiny bf16 model: the quantized prefix and the bf16 tail, one
    decode kernel each a layer and step."""
    cfg = llama.LlamaConfig.tiny(n_layers=2, dim=256, n_heads=4,
                                 n_kv_heads=2)
    params = llama.init_params(cfg, torch.Generator(device=cuda)
                               .manual_seed(0), device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    cache = serving.init_cache(cfg, 2, 64, device=cuda)
    logits, cache = serving.prefill(params, prompt, cfg, cache)
    qcache = serving.quantize_cache(cache, "nf4", tail_capacity=8)
    fd.reset_launch_counts()
    token = logits.argmax(-1).to(torch.int32)
    for _ in range(3):
        logits, qcache = serving.decode_step_quantized(params, token, cfg,
                                                       qcache)
        token = logits.argmax(-1).to(torch.int32)
    torch.cuda.synchronize()
    assert fd.LAUNCH_COUNTS["flash_decode"] == 2 * 3 * cfg.n_layers
    assert fd.LAUNCH_COUNTS["flash_decode_nf4"] == 3 * cfg.n_layers
    assert torch.isfinite(logits).all()


def test_sink_decode_on_the_card_matches_the_cpu(cuda):
    q, k, v = _qkv(1, batch=3, q_heads=32, kv_heads=8, d=128,
                   max_seq=2048, dtype=torch.bfloat16, device=cuda)
    lens = torch.tensor([2048, 3, 700], dtype=torch.int32, device=cuda)
    before = dict(fd.LAUNCH_COUNTS)
    o = serving.sink_decode(q, k, v, lens, window=256, sink=4)
    torch.cuda.synchronize()
    for name in ("flash_decode", "flash_decode_sm90"):
        assert fd.LAUNCH_COUNTS[name] == before[name] + 2
    ref = serving.sink_decode(q.cpu().float(), k.cpu().float(),
                              v.cpu().float(), lens.cpu(), window=256,
                              sink=4)
    assert worst_row_rel_rms(o.cpu(), ref) <= ROW_REL_RMS[torch.bfloat16]


def test_generate_launches_each_kernel_per_layer_and_step(cuda):
    """Greedy generate on a tiny bf16 model: one fused forward per layer
    for the prefill and one decode kernel per layer and decode step; the
    tokens lie in the vocabulary."""
    cfg = llama.LlamaConfig.tiny(n_layers=2, dim=256, n_heads=4,
                                 n_kv_heads=2)
    params = llama.init_params(cfg, torch.Generator(device=cuda)
                               .manual_seed(0), device=cuda)
    prompt = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(1))
    fa.reset_launch_counts()
    fd.reset_launch_counts()
    out = serving.generate(params, prompt, cfg, max_new_tokens=5)
    torch.cuda.synchronize()
    assert fa.LAUNCH_COUNTS["flash_fwd"] == cfg.n_layers
    assert fd.LAUNCH_COUNTS["flash_decode"] == cfg.n_layers * 4
    assert fd.LAUNCH_COUNTS["flash_decode_sm90"] == cfg.n_layers * 4
    assert out.shape == (2, 45)
    assert ((out >= 0) & (out < cfg.vocab_size)).all()


# Gemma-2's dense decode: head_dim 256 (and 128) with the soft cap (50,
# the model's; 2 over queries scaled by 4, where the tanh saturates), its
# local layers' window as kv_starts.
GEMMA_CASES = [
    # (q_heads, kv_heads, d, max_seq, lens, starts, q_gain, cap)
    (8, 4, 256, 5000, [5000, 4097, 1], [904, 1, 0], 1.0, 50.0),
    (8, 4, 256, 5000, [5000, 4097, 1], [904, 1, 0], 4.0, 2.0),
    (8, 4, 256, 700, [700, 13], None, 1.0, None),
    (32, 8, 128, 1100, [1100, 64], [100, 0], 4.0, 2.0),
    # The tiny Gemma-2's heads (head dim 32), its window as starts.
    (4, 2, 32, 700, [700, 13], [636, 0], 4.0, 2.0),
    (4, 2, 32, 700, [700, 13], None, 1.0, 50.0),
]


def _gemma_decode(cuda, dtype, qh, kvh, d, n, lens, starts, gain, cap,
                  kernel_cap):
    """The kernel with ``kernel_cap`` and the plain version with ``cap``
    on the same inputs: (o, lse, plain o, plain lse)."""
    q, k, v = _qkv(5, batch=len(lens), q_heads=qh, kv_heads=kvh, d=d,
                   max_seq=n, dtype=dtype, device=cuda)
    q = (q.float() * gain).to(dtype)
    lens_t, starts_t = _ints(lens, cuda), _ints(starts, cuda)
    before = dict(fd.LAUNCH_COUNTS)
    o, lse = fd.flash_decode(q, k, v, kv_lens=lens_t, kv_starts=starts_t,
                             logit_softcap=kernel_cap, return_residuals=True)
    torch.cuda.synchronize()
    for name in ("flash_decode", "flash_decode_sm90"):
        assert fd.LAUNCH_COUNTS[name] == before[name] + 1
    assert fd.LAUNCH_COUNTS["flash_decode_softcap"] == \
        before["flash_decode_softcap"] + (kernel_cap is not None)
    assert fd.LAUNCH_COUNTS["flash_decode_d256"] == \
        before["flash_decode_d256"] + (d == 256)
    assert fd.LAUNCH_COUNTS["flash_decode_d32"] == \
        before["flash_decode_d32"] + (d == 32)
    po, plse = fd._flash_decode_plain(q.float(), k.float(), v.float(),
                                      kv_lens=lens_t, kv_starts=starts_t,
                                      max_span=None, scale=d ** -0.5,
                                      softcap=cap)
    return o, lse, po, plse


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("qh,kvh,d,n,lens,starts,gain,cap", GEMMA_CASES)
def test_decode_kernel_gemma_matches_plain(cuda, dtype, qh, kvh, d, n, lens,
                                           starts, gain, cap):
    o, lse, po, plse = _gemma_decode(cuda, dtype, qh, kvh, d, n, lens,
                                     starts, gain, cap, cap)
    assert o.dtype == dtype
    assert worst_row_rel_rms(o, po) <= ROW_REL_RMS[dtype]
    assert max_abs_err(lse, plse) <= tolerances_for(dtype).lse
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))


@pytest.mark.parametrize("qh,kvh,d", [(32, 8, 128), (4, 2, 32)])
def test_decode_kernel_float32_takes_the_cap(cuda, qh, kvh, d):
    """fp32 on CUDA cores, with the accurate tanh, at the fp32 tier."""
    o, lse, po, plse = _gemma_decode(cuda, torch.float32, qh, kvh, d, 1100,
                                     [1100, 64], [100, 0], 4.0, 2.0, 2.0)
    assert max_abs_err(o, po) <= tolerances_for(torch.float32).o
    assert max_abs_err(lse, plse) <= tolerances_for(torch.float32).lse


def test_decode_kernel_without_its_cap_is_seen(cuda):
    """A planted fault: the kernel run without its cap, against the capped
    plain version at a saturating cap, is far outside the row limit."""
    o, _, po, _ = _gemma_decode(cuda, torch.bfloat16, 8, 4, 256, 5000,
                                [5000, 4097, 1], [904, 1, 0], 4.0, 2.0,
                                None)
    assert worst_row_rel_rms(o, po) > 10 * ROW_REL_RMS[torch.bfloat16]


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(2, batch=1, q_heads=4, kv_heads=2, d=64, max_seq=32,
                   dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):       # head_dim 48
        fd.flash_decode(q[..., :48], k[..., :48], v[..., :48])
    with pytest.raises(TypeError):
        fd.flash_decode(q, k.float(), v.float())
    with pytest.raises(TypeError):
        fd.flash_decode(q.double(), k.double(), v.double())
    padded = torch.zeros((1, 2, 32, 65), dtype=torch.bfloat16,
                         device=cuda)[..., :64]    # rows not 16-byte apart
    with pytest.raises(ValueError):
        fd.flash_decode(q, padded, padded)
    with pytest.raises(ValueError):
        fd.flash_decode(q, k, v, kv_lens=torch.tensor([5], dtype=torch.int32))
    big = torch.zeros((1, 68, 64), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(NotImplementedError):       # group 34
        fd.flash_decode(big, k, v)
    int8, nf4 = OperandPrecision.INT8, OperandPrecision.NF4
    kq, vq = quantize(k, int8), quantize(v, int8)
    fd.flash_decode(q, kq, vq)                     # INT8 K/V: taken
    with pytest.raises(NotImplementedError):       # fp16 queries
        fd.flash_decode(q.half(), kq, vq)
    with pytest.raises(NotImplementedError):       # head_dim 48
        fd.flash_decode(q[..., :48], quantize(k[..., :48], nf4),
                        quantize(v[..., :48], nf4))
    with pytest.raises(NotImplementedError):       # a cap over INT8 K/V
        fd.flash_decode(q, kq, vq, logit_softcap=50.0)
    q256, k256, v256 = _qkv(2, batch=1, q_heads=4, kv_heads=2, d=256,
                            max_seq=32, dtype=torch.float32, device=cuda)
    with pytest.raises(NotImplementedError):       # fp32 at head_dim 256
        fd.flash_decode(q256, k256, v256)


@pytest.mark.parametrize("precision", [None, "nf4"])
def test_head_dim_32_of_a_wider_cache_matches_plain(cuda, precision):
    """The first 32 columns of a head dim 64 cache, read in place through
    their strides (or quantized), against the plain version."""
    q, k, v = _qkv(2, batch=2, q_heads=4, kv_heads=2, d=64, max_seq=96,
                   dtype=torch.bfloat16, device=cuda)
    q, k, v = q[..., :32], k[..., :32], v[..., :32]
    if precision is not None:
        prec = OperandPrecision(precision)
        k, v = quantize(k.contiguous(), prec), quantize(v.contiguous(), prec)
    lens = _ints([96, 40], cuda)
    before = dict(fd.LAUNCH_COUNTS)
    o, lse = fd.flash_decode(q, k, v, kv_lens=lens, return_residuals=True)
    torch.cuda.synchronize()
    assert fd.LAUNCH_COUNTS["flash_decode_d32"] == \
        before["flash_decode_d32"] + 1
    po, plse = fd._flash_decode_plain(q, k, v, kv_lens=lens, kv_starts=None,
                                      max_span=None, scale=32 ** -0.5)
    assert worst_row_rel_rms(o, po) <= ROW_REL_RMS[torch.bfloat16]
    assert max_abs_err(lse, plse) <= tolerances_for(torch.bfloat16).lse


def test_a_cpu_tensor_never_builds_the_kernel(monkeypatch):
    """The CPU path takes the plain version without asking for the
    library (this test needs no card)."""
    def refuse():
        raise AssertionError("the CPU path asked for the CUDA library")
    monkeypatch.setattr(fd, "_kernel_library", refuse)
    q, k, v = _qkv(3, batch=2, q_heads=4, kv_heads=2, d=64, max_seq=70,
                   dtype=torch.bfloat16, device="cpu")
    before = fd.LAUNCH_COUNTS["flash_decode"]
    o = fd.flash_decode(q, k, v, kv_lens=torch.tensor([70, 5]))
    assert o.shape == q.shape
    assert fd.LAUNCH_COUNTS["flash_decode"] == before
