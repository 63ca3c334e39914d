"""The paged-attention CUDA kernels against their plain PyTorch version,
on the card.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_paged_cuda.py

Tolerance: the bf16 tier, MIXED_TOL (o 5e-2, lse 7e-3); the kernel
rounds P to bf16 before PV, the plain version keeps it in float32.  Over
quantized pools (INT8 / FP8 / NF4) o is held by the relative rms error of
each (sequence, head, query) row, ROW_REL_RMS: the kernel also rounds
P * (V's scale) to bf16, where the plain version dequantizes in float32
(both round NF4's codebook to bf16).  Gemma-2's cases (head_dim 256 over
bf16 pools, the soft cap over every pool, windows and kv_starts) are held
at the row limit too, beside a planted fault (the cap left out) that the
limit must see.
"""

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.models import llama
from metal_flash_attention_tpu_torch.models.engine import ServingEngine
from metal_flash_attention_tpu_torch.ops import flash_attention as fa
from metal_flash_attention_tpu_torch.ops import flash_decode as fd
from metal_flash_attention_tpu_torch.ops import paged_attention as pa
from metal_flash_attention_tpu_torch.utils.tolerances import (
    MIXED_TOL,
    max_abs_err,
)

PRECISIONS = ["int8", "fp8_e4m3", "fp8_e5m2", "nf4"]
# A few times the bf16 rounding of P and o (about 0.3% rms); a key tile
# dropped from a row of a few hundred keys moves it by 10% or more.
ROW_REL_RMS = 1e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernel has no CPU mode")
    return torch.device("cuda")


def _case(seed, *, batch, q_heads, kv_heads, d, page_size, lengths,
          q_chunk, device):
    """Random bf16 pools with a shuffled page table; page 0 stays the
    null page."""
    rng = np.random.default_rng(seed)
    max_pages = max(-(-n // page_size) for n in lengths) + 1
    num_pages = batch * max_pages + 2
    shape = (num_pages, kv_heads, page_size, d)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    perm = rng.permutation(np.arange(1, num_pages))
    table = np.zeros((batch, max_pages), np.int32)
    for b in range(batch):
        n = -(-lengths[b] // page_size)
        table[b, :n] = perm[b * max_pages:b * max_pages + n]
    qshape = (batch, q_heads, d) if q_chunk is None else \
        (batch, q_heads, q_chunk, d)
    q = rng.standard_normal(qshape).astype(np.float32)

    def t(x, dtype=torch.bfloat16):
        return torch.as_tensor(x).to(device=device, dtype=dtype)
    cache = pa.PagedKVCache(t(k), t(v), t(table, torch.int32),
                            t(np.asarray(lengths), torch.int32))
    return t(q), cache


def _plain(q, cache, window, decode, starts=None, cap=None):
    q4 = q[:, :, None] if decode else q
    o, lse = pa._paged_attention_plain(q4, cache, scale=q.shape[-1] ** -0.5,
                                       window_size=window, kv_starts=starts,
                                       softcap=cap)
    return (o[:, :, 0], lse[:, :, 0]) if decode else (o, lse)


@pytest.mark.parametrize("q_heads,kv_heads,d,page_size,lengths,window", [
    (4, 4, 64, 16, [37, 0, 200], None),
    (8, 4, 128, 128, [1100, 200, 645, 930], None),
    (32, 8, 128, 128, [1, 129, 1024, 257], None),
    (16, 4, 64, 32, [500, 77, 3], 40),
    # 8-token pages (eight a tile), a zero-length row beside full ones.
    (32, 8, 128, 8, [1000, 0, 77, 2048], None),
    # 256-token pages, a window that crosses pages.
    (16, 4, 128, 256, [300, 1100, 513], 300),
    # Many chunks of one long row beside short ones.
    (32, 8, 128, 64, [8192, 5, 700], None),
    # Head dim 32 (the tiny configs'): a zero-length row, odd pages and a
    # window across them, a full group of 16, many chunks.
    (4, 2, 32, 16, [37, 0, 200], None),
    (8, 2, 32, 13, [300, 1, 77], 40),
    (32, 2, 32, 128, [1100, 129], None),
    (4, 2, 32, 64, [8192, 5, 700], None),
])
def test_decode_kernel_matches_plain(cuda, q_heads, kv_heads, d, page_size,
                                     lengths, window):
    q, cache = _case(0, batch=len(lengths), q_heads=q_heads,
                     kv_heads=kv_heads, d=d, page_size=page_size,
                     lengths=lengths, q_chunk=None, device=cuda)
    before = dict(pa.LAUNCH_COUNTS)
    o, lse = pa.paged_decode(q, cache, window_size=window,
                             return_residuals=True)
    torch.cuda.synchronize()
    for name in ("paged_decode", "paged_decode_sm90"):
        assert pa.LAUNCH_COUNTS[name] == before[name] + 1
    assert pa.LAUNCH_COUNTS["paged_decode_d32"] == \
        before["paged_decode_d32"] + (d == 32)
    ro, rlse = _plain(q, cache, window, decode=True)
    assert max_abs_err(o, ro) < MIXED_TOL.o
    assert max_abs_err(lse, rlse) < MIXED_TOL.lse
    assert torch.isinf(lse[np.asarray(lengths) == 0]).all()


@pytest.mark.parametrize("q_heads,kv_heads,d,page_size,q_chunk,lengths,"
                         "window", [
    (4, 2, 64, 16, 16, [16, 40, 100], None),
    (32, 8, 128, 128, 128, [128, 1100], None),
    (32, 8, 128, 128, 72, [200, 1100], None),
    (8, 8, 128, 64, 33, [33, 500], 50),
    (6, 2, 64, 32, 5, [5, 61], None),
    # q_chunk larger than the page.
    (32, 8, 128, 8, 40, [40, 1100], None),
    # 256-token pages, a window that crosses pages.
    (8, 2, 64, 256, 100, [100, 900], 200),
    # A short row beside a long one: its late splits see no key.
    (32, 8, 128, 16, 64, [64, 2000], None),
    # Head dim 32: the tiny engine's chunks, odd pages with a window.
    (4, 2, 32, 16, 16, [16, 40, 100], None),
    (4, 2, 32, 13, 9, [9, 300], 50),
    (4, 2, 32, 128, 128, [128, 1100], None),
])
def test_prefill_kernel_matches_plain(cuda, q_heads, kv_heads, d, page_size,
                                      q_chunk, lengths, window):
    q, cache = _case(1, batch=len(lengths), q_heads=q_heads,
                     kv_heads=kv_heads, d=d, page_size=page_size,
                     lengths=lengths, q_chunk=q_chunk, device=cuda)
    before = dict(pa.LAUNCH_COUNTS)
    o, lse = pa.paged_prefill(q, cache, window_size=window,
                              return_residuals=True)
    torch.cuda.synchronize()
    for name in ("paged_prefill", "paged_prefill_sm90"):
        assert pa.LAUNCH_COUNTS[name] == before[name] + 1
    assert pa.LAUNCH_COUNTS["paged_prefill_d32"] == \
        before["paged_prefill_d32"] + (d == 32)
    ro, rlse = _plain(q, cache, window, decode=False)
    assert max_abs_err(o, ro) < MIXED_TOL.o
    assert max_abs_err(lse, rlse) < MIXED_TOL.lse


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, cache = _case(2, batch=1, q_heads=4, kv_heads=2, d=64, page_size=16,
                     lengths=[20], q_chunk=None, device=cuda)
    with pytest.raises(NotImplementedError):        # an fp32 pool
        pa.paged_decode(q.float(), cache._replace(
            k_pages=cache.k_pages.float(), v_pages=cache.v_pages.float()))
    with pytest.raises(TypeError):                  # q and pools differ
        pa.paged_decode(q.float(), cache)
    with pytest.raises(ValueError):
        pa.paged_decode(q[..., :32].contiguous(), cache)
    with pytest.raises(ValueError):                 # kv_starts' shape
        pa.paged_decode(q, cache, kv_starts=torch.zeros(
            2, dtype=torch.int32, device=cuda))


def worst_row_rel_rms(got, ref):
    """The largest ||got - ref|| / ||ref|| over the rows (last axis); a
    row whose reference is 0 must be 0 too."""
    got, ref = got.float(), ref.float()
    err, norm = (got - ref).pow(2).sum(-1), ref.pow(2).sum(-1)
    live = norm > 0
    assert (err[~live] == 0).all()
    return float((err[live] / norm[live]).sqrt().max()) if live.any() \
        else 0.0


def _check(name, precision, before, o, lse, ro, rlse):
    torch.cuda.synchronize()
    for key in (name, f"{name}_sm90", f"{name}_{precision}"):
        assert pa.LAUNCH_COUNTS[key] == before[key] + 1, key
    assert pa.LAUNCH_COUNTS[f"{name}_d32"] == \
        before[f"{name}_d32"] + (o.shape[-1] == 32)
    assert worst_row_rel_rms(o, ro) <= ROW_REL_RMS
    assert max_abs_err(lse, rlse) < MIXED_TOL.lse
    assert torch.equal(torch.isinf(lse), torch.isinf(rlse))


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("q_heads,kv_heads,d,page_size,lengths,window", [
    (32, 8, 128, 128, [1132, 232, 677, 962], None),   # the serve's shape
    # 8-token pages (eight a tile, eight scales), a zero-length row.
    (32, 8, 128, 8, [1000, 0, 77, 2048], None),
    (16, 4, 64, 16, [500, 77, 3], 40),
    (8, 2, 128, 256, [300, 1100, 513], 300),
    # Head dim 32: an NF4 tile has fewer 16-byte pieces than threads.
    (4, 2, 32, 16, [500, 77, 3], 40),
    (8, 2, 32, 8, [300, 0, 129, 2048], None),
])
def test_quantized_decode_kernel_matches_plain(cuda, precision, q_heads,
                                               kv_heads, d, page_size,
                                               lengths, window):
    q, cache = _case(3, batch=len(lengths), q_heads=q_heads,
                     kv_heads=kv_heads, d=d, page_size=page_size,
                     lengths=lengths, q_chunk=None, device=cuda)
    qcache = pa.quantize_paged(cache, precision)
    before = dict(pa.LAUNCH_COUNTS)
    o, lse = pa.paged_decode(q, qcache, window_size=window,
                             return_residuals=True)
    ro, rlse = _plain(q, qcache, window, decode=True)
    _check("paged_decode", precision, before, o[:, :, None], lse,
           ro[:, :, None], rlse)


@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("q_heads,kv_heads,d,page_size,q_chunk,lengths,"
                         "window", [
    (32, 8, 128, 128, 128, [1024, 1100], None),
    (32, 8, 128, 8, 40, [40, 1100], None),
    (8, 2, 64, 16, 33, [33, 500], 50),
    (4, 2, 32, 16, 33, [33, 500], 50),
    (4, 2, 32, 128, 128, [128, 1100], None),
])
def test_quantized_prefill_kernel_matches_plain(cuda, precision, q_heads,
                                                kv_heads, d, page_size,
                                                q_chunk, lengths, window):
    q, cache = _case(4, batch=len(lengths), q_heads=q_heads,
                     kv_heads=kv_heads, d=d, page_size=page_size,
                     lengths=lengths, q_chunk=q_chunk, device=cuda)
    qcache = pa.quantize_paged(cache, precision)
    before = dict(pa.LAUNCH_COUNTS)
    o, lse = pa.paged_prefill(q, qcache, window_size=window,
                              return_residuals=True)
    ro, rlse = _plain(q, qcache, window, decode=False)
    _check("paged_prefill", precision, before, o, lse, ro, rlse)


@pytest.mark.parametrize("precision", [None, "int8", "nf4"])
@pytest.mark.parametrize("lengths", [[1024], [0], [640, 0, 1280]])
@pytest.mark.parametrize("q_heads,kv_heads,d,page_size", [
    (32 * 128, 8, 128, 128),
    # The tiny engine's chunk prefix: 64 positions x 4 q heads over 2 kv
    # heads at head dim 32, pages of 16.
    (4 * 64, 2, 32, 16),
])
def test_wide_group_decode_runs_on_the_prefill_kernel(cuda, precision,
                                                      lengths, q_heads,
                                                      kv_heads, d,
                                                      page_size):
    """A serving chunk's positions folded into the heads: q [b, 32 * 128,
    128] against 8 kv heads, a GQA group of 512 (and the tiny engine's
    group of 128 at D 32).  It runs once on the prefill kernel, every row
    at position length - 1; a row without keys (a first chunk's empty
    prefix) gives o = 0, lse = -inf."""
    q, cache = _case(5, batch=len(lengths), q_heads=q_heads,
                     kv_heads=kv_heads, d=d, page_size=page_size,
                     lengths=lengths, q_chunk=None, device=cuda)
    if precision is not None:
        cache = pa.quantize_paged(cache, precision)
    before = dict(pa.LAUNCH_COUNTS)
    o, lse = pa.paged_decode(q, cache, return_residuals=True)
    torch.cuda.synchronize()
    names = ["paged_decode_wide", "paged_decode_wide_sm90"]
    if precision is not None:
        names.append(f"paged_decode_wide_{precision}")
    if d == 32:
        names.append("paged_decode_wide_d32")
    for key, n in pa.LAUNCH_COUNTS.items():
        assert n == before[key] + (key in names), key
    ro, rlse = _plain(q, cache, None, decode=True)
    assert worst_row_rel_rms(o, ro) <= ROW_REL_RMS
    assert max_abs_err(lse, rlse) < MIXED_TOL.lse
    empty = torch.as_tensor(lengths, device=cuda) == 0
    assert (o[empty] == 0).all() and torch.isneginf(lse[empty]).all()


def test_quantized_engine_launches_the_quantized_kernels(cuda,
                                                        monkeypatch):
    """A tiny bf16 model (GQA group 8) served with INT8 pools: every
    chunk's prefix is one wide paged decode (8 x its 5 to 16 positions
    are more rows than one fragment) and one forward a layer, every decode
    step one quantized paged decode and one bf16 tail decode a layer."""
    from metal_flash_attention_tpu_torch.models import serving

    cfg = llama.LlamaConfig.tiny(n_layers=2, dim=512, n_heads=8,
                                 n_kv_heads=1)
    params = llama.init_params(cfg, torch.Generator(device=cuda)
                               .manual_seed(0), device=cuda)
    calls = {"chunk": 0, "decode": 0}

    def counted(name, fn):
        def run(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return run
    monkeypatch.setattr(serving, "paged_chunk_step_q",
                        counted("chunk", serving.paged_chunk_step_q))
    monkeypatch.setattr(serving, "paged_decode_step_q",
                        counted("decode", serving.paged_decode_step_q))
    gen = np.random.default_rng(6)
    eng = ServingEngine(params, cfg, max_batch=2, num_pages=24,
                        page_size=16, max_seq=128, kv_precision="int8")
    for n, m in ((40, 12), (21, 9)):
        eng.submit(gen.integers(0, cfg.vocab_size, (n,)), m)
    pa.reset_launch_counts()
    fd.reset_launch_counts()
    fa.reset_launch_counts()
    while not eng.idle:
        eng.step()
    torch.cuda.synchronize()
    chunks, decodes = calls["chunk"] * cfg.n_layers, \
        calls["decode"] * cfg.n_layers
    assert calls["chunk"] == 5 and calls["decode"] > 0
    expected = {"paged_decode": decodes, "paged_decode_sm90": decodes,
                "paged_decode_int8": decodes,
                "paged_decode_wide": chunks,
                "paged_decode_wide_sm90": chunks,
                "paged_decode_wide_int8": chunks}
    for key, n in pa.LAUNCH_COUNTS.items():
        assert n == expected.get(key, 0), key
    assert fd.LAUNCH_COUNTS["flash_decode"] == decodes
    assert fd.LAUNCH_COUNTS["flash_decode_sm90"] == decodes
    assert fa.LAUNCH_COUNTS["flash_fwd"] == chunks
    assert eng.alloc.free_pages == 23


def test_quantized_pools_refuse_what_the_kernel_does_not_take(cuda):
    q, cache = _case(7, batch=1, q_heads=4, kv_heads=2, d=64, page_size=16,
                     lengths=[20], q_chunk=None, device=cuda)
    qcache = pa.quantize_paged(cache, "int8")
    pa.paged_decode(q, qcache)                       # INT8 pools: taken
    with pytest.raises(NotImplementedError):         # fp16 queries
        pa.paged_decode(q.half(), qcache)
    q32, c32 = _case(7, batch=1, q_heads=4, kv_heads=2, d=32, page_size=16,
                     lengths=[20], q_chunk=None, device=cuda)
    n32 = pa.quantize_paged(c32, "nf4")               # head_dim 32: taken
    o32, lse32 = pa.paged_decode(q32, n32, return_residuals=True)
    ro32, rlse32 = _plain(q32, n32, None, decode=True)
    assert worst_row_rel_rms(o32, ro32) <= ROW_REL_RMS
    assert max_abs_err(lse32, rlse32) < MIXED_TOL.lse
    q48, c48 = _case(7, batch=1, q_heads=4, kv_heads=2, d=48, page_size=16,
                     lengths=[20], q_chunk=None, device=cuda)
    for pool in (c48, pa.quantize_paged(c48, "nf4")):
        with pytest.raises(NotImplementedError):     # head_dim 48
            pa.paged_decode(q48, pool)
    with pytest.raises(ValueError):                  # scales' shape
        pa.paged_decode(q, qcache._replace(k_scales=qcache.k_scales[:1]))
    q256, c256 = _case(7, batch=1, q_heads=4, kv_heads=2, d=256,
                       page_size=16, lengths=[20], q_chunk=None,
                       device=cuda)
    with pytest.raises(NotImplementedError):         # head_dim 256, INT8
        pa.paged_decode(q256, pa.quantize_paged(c256, "int8"))


# Gemma-2: head_dim 256 over bf16 pools, its local layers' window of
# 4,096 and kv_starts, with the soft cap (50, the model's; 2 over queries
# scaled by 4, where the tanh saturates); and D 128 with them.
GEMMA_CASES = [
    # (q_heads, kv_heads, d, page, lengths, window, starts, q_gain, cap)
    (8, 4, 256, 128, [5000, 700, 1], 4096, None, 1.0, 50.0),
    (8, 4, 256, 128, [5000, 700, 1], 4096, None, 4.0, 2.0),
    (8, 4, 256, 128, [1100, 200], None, [100, 0], 4.0, 2.0),
    (8, 4, 256, 16, [300, 45], None, None, 1.0, None),
    (32, 8, 128, 128, [1100, 200], 300, [700, 3], 4.0, 2.0),
    # The tiny Gemma-2's heads: head dim 32, its window of 64, odd pages.
    (4, 2, 32, 16, [300, 45], 64, [10, 0], 4.0, 2.0),
    (4, 2, 32, 13, [300, 100], None, [30, 0], 1.0, 50.0),
]


def _gemma_paged(cuda, mode, q_heads, kv_heads, d, page, lengths, window,
                 starts, gain, cap, kernel_cap, precision=None):
    """One launch of ``mode`` with ``kernel_cap`` beside the plain version
    with ``cap``: (o, lse, plain o, plain lse), the launch counted."""
    decode = mode == "paged_decode"
    q, cache = _case(8, batch=len(lengths), q_heads=q_heads,
                     kv_heads=kv_heads, d=d, page_size=page,
                     lengths=lengths, q_chunk=None if decode else 64,
                     device=cuda)
    q = (q.float() * gain).to(torch.bfloat16)
    if precision is not None:
        cache = pa.quantize_paged(cache, precision)
    starts_t = None if starts is None else torch.tensor(
        starts, dtype=torch.int32, device=cuda)
    fn = pa.paged_decode if decode else pa.paged_prefill
    before = dict(pa.LAUNCH_COUNTS)
    o, lse = fn(q, cache, window_size=window, kv_starts=starts_t,
                logit_softcap=kernel_cap, return_residuals=True)
    torch.cuda.synchronize()
    names = [mode, f"{mode}_sm90"]
    if precision is not None:
        names.append(f"{mode}_{precision}")
    if kernel_cap is not None:
        names.append(f"{mode}_softcap")
    if d in (32, 256):
        names.append(f"{mode}_d{d}")
    for key, n in pa.LAUNCH_COUNTS.items():
        assert n == before[key] + (key in names), key
    ro, rlse = _plain(q, cache, window, decode, starts_t, cap)
    return o, lse, ro, rlse


@pytest.mark.parametrize("mode", ["paged_decode", "paged_prefill"])
@pytest.mark.parametrize("q_heads,kv_heads,d,page,lengths,window,starts,"
                         "gain,cap", GEMMA_CASES)
def test_gemma_kernels_match_plain(cuda, mode, q_heads, kv_heads, d, page,
                                   lengths, window, starts, gain, cap):
    if mode == "paged_prefill":
        lengths = [max(n, 64) for n in lengths]
    o, lse, ro, rlse = _gemma_paged(cuda, mode, q_heads, kv_heads, d, page,
                                    lengths, window, starts, gain, cap, cap)
    assert worst_row_rel_rms(o, ro) <= ROW_REL_RMS
    assert max_abs_err(lse, rlse) < MIXED_TOL.lse
    assert torch.equal(torch.isinf(lse), torch.isinf(rlse))


@pytest.mark.parametrize("mode", ["paged_decode", "paged_prefill"])
@pytest.mark.parametrize("precision", PRECISIONS)
@pytest.mark.parametrize("q_heads,kv_heads,d,page,lengths,window,starts", [
    (32, 8, 128, 128, [1100, 200], 300, [700, 3]),
    (4, 2, 32, 16, [300, 100], 64, [10, 0]),
])
def test_quantized_kernels_take_the_cap(cuda, mode, precision, q_heads,
                                        kv_heads, d, page, lengths, window,
                                        starts):
    o, lse, ro, rlse = _gemma_paged(cuda, mode, q_heads, kv_heads, d, page,
                                    lengths, window, starts, 4.0, 2.0,
                                    2.0, precision)
    assert worst_row_rel_rms(o, ro) <= ROW_REL_RMS
    assert max_abs_err(lse, rlse) < MIXED_TOL.lse


@pytest.mark.parametrize("mode", ["paged_decode", "paged_prefill"])
def test_kernels_without_their_cap_are_seen(cuda, mode):
    """A planted fault: each kernel at D 256 run without its cap, against
    the capped plain version at a saturating cap."""
    o, _, ro, _ = _gemma_paged(cuda, mode, 8, 4, 256, 128, [5000, 700, 64],
                               4096, None, 4.0, 2.0, None)
    assert worst_row_rel_rms(o, ro) > 10 * ROW_REL_RMS
