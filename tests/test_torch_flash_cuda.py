"""The flash-attention CUDA kernels (forward, dQ, dK/dV) against their
plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_flash_cuda.py

Tolerance: the bf16 tier, MIXED_TOL (o 5e-2, lse 7e-3, grads 5e-2).  The
kernels round P and dS to the input type before the products that
consume them; the plain versions stay in float32.  float32 runs on the
true-fp32 kernels (csrc/flash_attention_f32.cu) and is held at FP32_TOL
(2e-5), and by the worst tile at F32_TILE_REL_RMS where the 16-bit
cases use TILE_REL_RMS; the plain versions run with TF32 off, PyTorch's
default for a float32 matrix product.  Gradients are held
relative to their own size where it exceeds 1: err <= tol * max(1,
max |ref|).  Gemma-2's cases (head_dim 256, the soft cap; the forward,
and the backward pair) are held by the worst 64-row tile's relative rms
error, TILE_REL_RMS, and a planted fault (the cap left out) must read
above 10 x TILE_REL_RMS.  A tiny Gemma-2 `train_step` on the card is held
to the same step on the CPU (TRAIN_REL_RMS).
"""

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.ops import flash_attention as fa
from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
from metal_flash_attention_tpu_torch.utils.tolerances import (
    MIXED_TOL,
    max_abs_err,
    tolerances_for,
)

DTYPES = [torch.bfloat16, torch.float16, torch.float32]


def _kernel(dtype) -> str:
    """The counter suffix of the kernel that runs ``dtype``."""
    return "_f32" if dtype == torch.float32 else "_sm90"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    return torch.device("cuda")


def _qkv(seed, b, qh, kvh, n, m, d, dtype, device):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(
            np.float32)).to(device=device, dtype=dtype)
    return t(b, qh, n, d), t(b, kvh, m, d), t(b, kvh, m, d), t(b, qh, n, d)


def _grad_ok(got, ref, tol):
    err = max_abs_err(got, ref)
    return err <= tol * max(1.0, float(ref.float().abs().max())), err


CASES = [
    # b, qh, kvh, n, m, d, causal, window
    (1, 4, 4, 128, 128, 64, False, None),
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 93, 77, 128, True, None),        # ragged, q_len > kv_len
    (1, 4, 1, 250, 123, 64, True, None),       # rows that see no key
    (1, 4, 2, 100, 300, 128, True, None),      # q_len < kv_len
    (2, 8, 2, 300, 300, 128, True, 77),        # window
    (1, 4, 4, 200, 333, 64, False, 50),        # window without causal
    (1, 32, 8, 1000, 1536, 128, True, 512),    # the smoke's window shape
]

# The forward kernel's tile edges (128 group-major rows a block, two
# warpgroups of 64; 128 keys a tile).
EDGE_CASES = [
    (2, 8, 2, 93, 93, 128, True, None),     # row tiles cross q heads
    (1, 8, 2, 93, 200, 64, False, None),    # the same, not causal
    (1, 4, 2, 256, 300, 128, False, None),  # kv_len not a tile multiple
    (1, 4, 2, 64, 40, 128, False, None),    # kv_len under one tile
    (1, 4, 4, 40, 40, 64, True, None),      # ... causal
    (1, 2, 2, 50, 180, 128, True, None),    # second warpgroup: no rows
    (1, 3, 1, 64, 64, 64, False, None),     # ... in the second of 2 tiles
    (1, 4, 2, 512, 512, 128, True, 200),    # window edge inside a tile
    (1, 4, 4, 300, 700, 64, False, 130),    # ... without causal
    (1, 4, 2, 2048, 2048, 128, True, None),  # masked and unmasked tiles
]

# The backward kernels' tile edges: dQ takes 128 group-major rows a block
# (two warpgroups of 64) and 64 keys a tile, dK/dV 128 keys a block (two
# warpgroups of 64) and 64 query rows a step.  The forward's edges above
# cover rows that cross q heads (q_len 93, group 4), kv_len off and under
# one tile, a dQ block whose second warpgroup has no rows, a window edge
# inside a tile with and without causal, and masked and whole tiles at
# 2,048; these add the dK/dV blocks'.
BWD_EDGE_CASES = EDGE_CASES + [
    (1, 4, 2, 180, 50, 128, True, None),    # second warpgroup: no keys
    (1, 4, 1, 150, 130, 64, True, None),    # a block of 2 keys
    (1, 2, 1, 64, 400, 64, False, 40),      # keys that no query sees
    (2, 8, 2, 130, 260, 128, False, 100),   # window, ragged query tiles
]

# Head dim 32 (the tiny configs': `entry()`, the training meshes): the D
# 64 kernels over 32-column rows, TMA filling the boxes' other 32 columns
# with zeros and clipping the stores.  Causal, windows, GQA, ragged tiles,
# rows that see no key, and the tiny configs' training shape.
D32_CASES = [
    (2, 4, 2, 128, 128, 32, True, None),    # LlamaConfig.tiny's heads
    (2, 4, 2, 256, 256, 32, True, None),    # entry()'s shape
    (1, 8, 2, 93, 77, 32, True, None),      # ragged, q_len > kv_len
    (1, 4, 1, 250, 123, 32, True, None),    # rows that see no key
    (1, 4, 2, 100, 300, 32, False, None),   # q_len < kv_len
    (2, 8, 2, 300, 300, 32, True, 77),      # window
    (1, 4, 4, 40, 40, 32, True, None),      # under one tile
    (2, 4, 2, 4096, 4096, 32, True, None),  # the smoke's d32_checks shape
]


def _forward_checked(q, k, v, d, causal, window, out_dtype=None,
                     cap=None):
    """One forward through the kernel, held against the plain version;
    the launch counted on the op and on the kernel that ran (sm90, or
    f32 for float32), at the dtype's tolerance."""
    before = dict(fa.LAUNCH_COUNTS)
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                        window_size=window,
                                        out_dtype=out_dtype,
                                        logit_softcap=cap)
    torch.cuda.synchronize()
    assert fa.LAUNCH_COUNTS["flash_fwd"] == before["flash_fwd"] + 1
    kernel = _kernel(q.dtype)
    for suffix in ("_sm90", "_f32"):
        name = f"flash_fwd{suffix}"
        assert fa.LAUNCH_COUNTS[name] == before[name] + (suffix == kernel)
    assert fa.LAUNCH_COUNTS["flash_fwd_softcap"] == \
        before["flash_fwd_softcap"] + (cap is not None)
    assert fa.LAUNCH_COUNTS["flash_fwd_d256"] == \
        before["flash_fwd_d256"] + (d == 256)
    assert fa.LAUNCH_COUNTS["flash_fwd_d32"] == \
        before["flash_fwd_d32"] + (d == 32)
    po, plse = fa._forward_plain(q, k, v, causal=causal, window_size=window,
                                 scale=d ** -0.5, out_dtype=torch.float32,
                                 softcap=cap)
    tol = tolerances_for(q.dtype)
    assert o.dtype == (out_dtype or q.dtype) and lse.dtype == torch.float32
    assert max_abs_err(o, po) <= tol.o
    assert max_abs_err(lse, plse) <= tol.lse
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,qh,kvh,n,m,d,causal,window",
                         CASES + EDGE_CASES + D32_CASES)
def test_forward_kernel_matches_plain(cuda, dtype, b, qh, kvh, n, m, d,
                                      causal, window):
    q, k, v, _ = _qkv(0, b, qh, kvh, n, m, d, dtype, cuda)
    _forward_checked(q, k, v, d, causal, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [32, 64, 128])
def test_forward_kernel_float32_out(cuda, dtype, d):
    """out_dtype=float32: O stored from the fragments, rows past the head
    (q_len 93, group 4: the last tile's second warpgroup) not written."""
    q, k, v, _ = _qkv(6, 1, 8, 2, 93, 150, d, dtype, cuda)
    _forward_checked(q, k, v, d, True, None, out_dtype=torch.float32)


def _expected_bwd_counts(before, dtype, d, cap=None) -> dict:
    """The backward's counts after one call: each op, the kernel that ran,
    the cap and the head dim."""
    bumped = ("", _kernel(dtype)) + (("_softcap",) if cap is not None
                                     else ()) + (
        (f"_d{d}",) if d in (32, 256) else ())
    return {name: c + any(name == f"flash_bwd_{op}{s}"
                          for op in ("dq", "dkv") for s in bumped)
            for name, c in before.items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,qh,kvh,n,m,d,causal,window",
                         CASES + BWD_EDGE_CASES + D32_CASES)
def test_backward_kernels_match_plain(cuda, dtype, b, qh, kvh, n, m, d,
                                      causal, window):
    q, k, v, do = _qkv(1, b, qh, kvh, n, m, d, dtype, cuda)
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                        window_size=window)
    before = dict(fb.LAUNCH_COUNTS)
    dq, dk, dv = fb.flash_attention_backward(q, k, v, do, o, lse,
                                             causal=causal,
                                             window_size=window)
    torch.cuda.synchronize()
    assert fb.LAUNCH_COUNTS == _expected_bwd_counts(before, dtype, d)
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    ref = fb._backward_plain(q.float(), k.float(), v.float(), do.float(),
                             causal=causal, window_size=window,
                             scale=d ** -0.5)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert torch.isfinite(got).all(), name
        ok, err = _grad_ok(got, want, tolerances_for(dtype).grads)
        assert ok, (name, err)


def test_rows_that_see_no_key(cuda):
    """Causal with q_len > kv_len: the first rows see nothing, so o = 0,
    lse = -inf, and their gradients are exactly 0, never NaN."""
    q, k, v, do = _qkv(2, 1, 4, 2, 250, 123, 64, torch.bfloat16, cuda)
    q.requires_grad_(True)
    k.requires_grad_(True)
    v.requires_grad_(True)
    o, lse = fa.flash_attention(q, k, v, causal=True, return_residuals=True)
    (o.float() * do.float()).sum().backward()
    blind = 250 - 123
    assert torch.all(o[:, :, :blind] == 0)
    assert torch.all(torch.isneginf(lse[:, :, :blind]))
    assert torch.all(torch.isfinite(lse[:, :, blind:]))
    assert torch.all(q.grad[:, :, :blind] == 0)
    for g in (q.grad, k.grad, v.grad):
        assert torch.isfinite(g).all()


def test_autograd_matches_plain_and_out_dtype(cuda):
    q, k, v, do = _qkv(3, 2, 8, 2, 256, 256, 128, torch.bfloat16, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fa.flash_attention(*leaves, causal=True, out_dtype=torch.float32)
    assert o.dtype == torch.float32
    (o * do.float()).sum().backward()
    ref = fb._backward_plain(q.float(), k.float(), v.float(), do.float(),
                             causal=True, window_size=None,
                             scale=128 ** -0.5)
    for leaf, want in zip(leaves, ref):
        ok, err = _grad_ok(leaf.grad, want, MIXED_TOL.grads)
        assert ok, err


def test_kernels_refuse_what_they_do_not_take(cuda):
    q, k, v, do = _qkv(4, 1, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    # float32 runs on the true-fp32 kernels, but not with the options.
    mask64 = torch.ones((1, 1, 64, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(NotImplementedError, match="flash-kernel coverage"):
        fa.flash_attention_forward(q.float(), k.float(), v.float(),
                                   mask=mask64)
    q96, k96, v96, _ = _qkv(4, 1, 4, 2, 64, 64, 96, torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_forward(q96, k96, v96)
    with pytest.raises(TypeError):
        fa.flash_attention_forward(q, k.half(), v)
    kq, vq = _quantized_kv(9, 1, 2, 64, 64, "int8", cuda)
    with pytest.raises(NotImplementedError):       # a cap over INT8 K/V
        fa.flash_attention_forward(q, kq, vq, logit_softcap=30.0)
    # At head dim 32: no options and no quantized K/V.
    q32, k32, v32, _ = _qkv(4, 1, 4, 2, 64, 64, 32, torch.bfloat16, cuda)
    mask = torch.ones((1, 1, 64, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(NotImplementedError, match="flash-kernel coverage"):
        fa.flash_attention_forward(q32, k32, v32, mask=mask)
    kq32, vq32 = _quantized_kv(9, 1, 2, 64, 32, "int8", cuda)
    with pytest.raises(NotImplementedError, match="flash-kernel coverage"):
        fa.flash_attention_forward(q32, kq32, vq32)


def test_entry_runs_on_the_card(cuda):
    """`entry()` builds on the card by default (head dim 32) and its
    forward runs the D 32 forward kernel once a layer; its logits agree
    with the same weights' plain path on the CPU by chip_smoke.py's
    logits gate (relative rms 2e-2, max abs 1e-1)."""
    from metal_flash_attention_tpu_torch.entry import entry

    fn, (params, tokens) = entry()
    assert tokens.is_cuda and params["embed"].is_cuda
    before = dict(fa.LAUNCH_COUNTS)
    logits = fn(params, tokens)
    torch.cuda.synchronize()
    layers = len(params["layers"])
    for name in ("flash_fwd", "flash_fwd_sm90", "flash_fwd_d32"):
        assert fa.LAUNCH_COUNTS[name] == before[name] + layers, name
    cpu = {k: ([{n: w.cpu() for n, w in layer.items()} for layer in v]
               if k == "layers" else v.cpu()) for k, v in params.items()}
    ref = fn(cpu, tokens.cpu())
    got = logits.float().cpu()
    rel = float((got - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt())
    assert torch.isfinite(got).all()
    assert rel <= 2e-2 and max_abs_err(got, ref) <= 1e-1, rel


# Gemma-2's forward: head_dim 256 (one consumer warpgroup of 64 rows,
# 64-key tiles) and 128, with the soft cap (50, the model's; 2 over
# queries scaled by 4, where the tanh saturates) and its local layers'
# window.
GEMMA_CASES = [
    # b, qh, kvh, n, m, d, causal, window, q_gain, cap
    (1, 8, 4, 1000, 1000, 256, True, None, 1.0, 50.0),
    (1, 8, 4, 1000, 1000, 256, True, None, 4.0, 2.0),
    (2, 8, 4, 600, 600, 256, True, 256, 4.0, 2.0),
    (1, 8, 4, 93, 200, 256, False, None, 1.0, None),   # ragged tiles
    (1, 4, 4, 40, 40, 256, True, None, 1.0, None),     # under one tile
    (1, 2, 2, 300, 700, 256, False, 130, 4.0, 2.0),
    (1, 32, 8, 1000, 1536, 128, True, 512, 4.0, 2.0),
    (1, 8, 2, 300, 300, 32, True, 77, 4.0, 2.0),       # D 32, the cap
]

TILE_REL_RMS = 1.5e-2
# float32 against its float32 plain version: chip_smoke.py's sound
# readings on an H100 were 1.4e-6 to 4.3e-6, inputs rounded to TF32's
# 10-bit mantissa 3.9e-4 to 7.2e-4 (its own limit, 4e-5, sits between
# them; these cases, saturating caps among them, keep more room).
F32_TILE_REL_RMS = 1e-4


def tile_limit(dtype) -> float:
    return F32_TILE_REL_RMS if dtype == torch.float32 else TILE_REL_RMS


def worst_tile_rel_rms(got, ref, rows=64):
    """The largest relative rms error of any `rows`-row tile of a head."""
    got, ref = got.float(), ref.float()
    n = got.shape[-2]
    worst = 0.0
    for r in range(0, n, rows):
        g, w = got[..., r:r + rows, :], ref[..., r:r + rows, :]
        err = (g - w).pow(2).sum((-1, -2))
        norm = w.pow(2).sum((-1, -2)).clamp_min(1e-30)
        worst = max(worst, float((err / norm).sqrt().max()))
    return worst


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,qh,kvh,n,m,d,causal,window,gain,cap",
                         GEMMA_CASES)
def test_forward_kernel_gemma_matches_plain(cuda, dtype, b, qh, kvh, n, m,
                                            d, causal, window, gain, cap):
    q, k, v, _ = _qkv(10, b, qh, kvh, n, m, d, dtype, cuda)
    q = (q.float() * gain).to(dtype)
    _forward_checked(q, k, v, d, causal, window, cap=cap)


def test_forward_kernel_d256_float32_out(cuda):
    q, k, v, _ = _qkv(11, 1, 8, 4, 93, 150, 256, torch.bfloat16, cuda)
    _forward_checked(q, k, v, 256, True, None, out_dtype=torch.float32,
                     cap=50.0)


def test_forward_kernel_without_its_cap_is_seen(cuda):
    """A planted fault: the kernel at D 256 without its cap, against the
    capped plain version at a saturating cap."""
    q, k, v, _ = _qkv(10, 1, 8, 4, 1000, 1000, 256, torch.bfloat16, cuda)
    q = (q.float() * 4.0).to(torch.bfloat16)
    o, _ = fa.flash_attention_forward(q, k, v, causal=True)
    po, _ = fa._forward_plain(q, k, v, causal=True, window_size=None,
                              scale=256 ** -0.5, out_dtype=torch.float32,
                              softcap=2.0)
    capped, _ = fa.flash_attention_forward(q, k, v, causal=True,
                                           logit_softcap=2.0)
    assert worst_tile_rel_rms(capped, po) <= TILE_REL_RMS
    assert worst_tile_rel_rms(o, po) > 10 * TILE_REL_RMS


# Gemma-2's backward: both kernels at head_dim 256 (dQ one warpgroup of
# 64 rows and 64-key tiles; dK/dV 64 keys a block, the two warpgroups
# splitting D) and with the soft cap (50, the model's; 2 over queries
# scaled by 4, where 1 - t^2 is far from 1), also at D 64 and 128.
# Causal, windows, GQA groups 2 and 4, lengths off the 64 tiles, and the
# first 128 rows seeing no key (q_len - kv_len = 128, so that no 64-row
# tile holds only a row whose one key makes its dQ zero up to rounding).
BWD_GEMMA_CASES = [
    # b, qh, kvh, n, m, d, causal, window, q_gain, cap
    (1, 8, 4, 1000, 1000, 256, True, None, 1.0, 50.0),
    (1, 8, 4, 1000, 1000, 256, True, None, 4.0, 2.0),
    (2, 8, 4, 600, 600, 256, True, 256, 4.0, 2.0),
    (1, 8, 2, 333, 333, 256, True, None, 1.0, 50.0),     # group 4
    (1, 8, 4, 250, 122, 256, True, None, 1.0, 50.0),     # rows see no key
    (1, 4, 4, 93, 200, 256, False, None, 4.0, 2.0),
    (1, 2, 2, 300, 700, 256, False, 130, 4.0, 2.0),      # keys unseen
    (1, 8, 4, 77, 77, 256, True, None, 1.0, None),       # D 256, no cap
    (1, 32, 8, 1000, 1536, 128, True, 512, 4.0, 2.0),
    (1, 4, 2, 300, 300, 64, True, 77, 1.0, 50.0),
    (1, 4, 2, 300, 300, 32, True, 77, 4.0, 2.0),         # D 32, the cap
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,qh,kvh,n,m,d,causal,window,gain,cap",
                         BWD_GEMMA_CASES)
def test_backward_kernels_gemma_match_plain(cuda, dtype, b, qh, kvh, n, m,
                                            d, causal, window, gain, cap):
    """dq, dk and dv against `_backward_plain` by the worst 64-row tile
    (`tile_limit`), each launch counted on the op, the kernel that ran
    (`_sm90`, or `_f32` for float32), `_softcap` (with the cap) and
    `_d256` (at head_dim 256)."""
    q, k, v, do = _qkv(12, b, qh, kvh, n, m, d, dtype, cuda)
    q = (q.float() * gain).to(dtype)
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                        window_size=window,
                                        logit_softcap=cap)
    before = dict(fb.LAUNCH_COUNTS)
    dq, dk, dv = fb.flash_attention_backward(q, k, v, do, o, lse,
                                             causal=causal,
                                             window_size=window,
                                             logit_softcap=cap)
    torch.cuda.synchronize()
    assert fb.LAUNCH_COUNTS == _expected_bwd_counts(before, dtype, d, cap)
    ref = fb._backward_plain(q.float(), k.float(), v.float(), do.float(),
                             causal=causal, window_size=window,
                             scale=d ** -0.5, softcap=cap)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert got.dtype == dtype and torch.isfinite(got).all(), name
        assert worst_tile_rel_rms(got, want) <= tile_limit(dtype), name


def test_backward_kernel_without_its_cap_factor_is_seen(cuda):
    """A planted fault: dQ from the kernel run without the cap (its lse
    the capped forward's) against the capped plain version at a
    saturating cap."""
    q, k, v, do = _qkv(13, 1, 8, 4, 500, 500, 256, torch.bfloat16, cuda)
    q = (q.float() * 4.0).to(torch.bfloat16)
    o, lse = fa.flash_attention_forward(q, k, v, causal=True,
                                        logit_softcap=2.0)
    ref = fb._backward_plain(q.float(), k.float(), v.float(), do.float(),
                             causal=True, window_size=None,
                             scale=256 ** -0.5, softcap=2.0)
    capped = fb.flash_attention_backward(q, k, v, do, o, lse, causal=True,
                                         logit_softcap=2.0)
    uncapped = fb.flash_attention_backward(q, k, v, do, o, lse, causal=True)
    for got, fault, want in zip(capped, uncapped, ref):
        assert worst_tile_rel_rms(got, want) <= TILE_REL_RMS
        assert worst_tile_rel_rms(fault, want) > 10 * TILE_REL_RMS


# A tiny Gemma-2 train step (head_dim 256: the card's kernels take 64,
# 128 and 256) on the card against the same step on the CPU, in bf16, at
# the model's cap.  TRAIN_LR, a power of two, makes each update so much
# larger than its parameter that rounding the new parameter to bf16
# costs 2^-9 of the update, so (new - old) / TRAIN_LR is the gradient;
# each is held to the CPU's by its relative rms error, TRAIN_REL_RMS:
# chip_smoke.py's limit on gradients against plain attention
# (TRAIN_GRAD_REL_RMS; the kernels round P and dS to bf16).  The CPU's
# own bf16 step reads at most 1.7% against its float32 step here.  (At a
# saturating cap that reading is 3.2%, too near the limit at this size:
# the saturating regime is held by the kernel cases above and by
# chip_smoke.py's gemma_train_reference.)
TRAIN_LR = 1024.0
TRAIN_REL_RMS = 4e-2


def test_gemma_train_step_matches_cpu(cuda):
    from metal_flash_attention_tpu_torch.models import gemma
    from metal_flash_attention_tpu_torch.utils.tree import flatten, tree_map

    cfg = gemma.GemmaConfig.tiny(head_dim=256)
    params = gemma.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 81)))
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    new, loss = gemma.train_step(tree_map(lambda t: t.to(cuda), params),
                                 tokens.to(cuda), cfg, lr=TRAIN_LR)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        for suffix in ("", "_sm90", "_softcap", "_d256"):
            counts = fa.LAUNCH_COUNTS if name == "flash_fwd" else \
                fb.LAUNCH_COUNTS
            assert counts[name + suffix] == cfg.n_layers, name + suffix
    ref_new, ref_loss = gemma.train_step(params, tokens, cfg, lr=TRAIN_LR)
    assert abs(float(loss) - float(ref_loss)) <= MIXED_TOL.o
    for old, got, want in zip(flatten(params)[0], flatten(new)[0],
                              flatten(ref_new)[0]):
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        step, ref_step = got.cpu().float() - old.float(), \
            want.float() - old.float()
        err = (step - ref_step).pow(2).mean().sqrt()
        assert err <= TRAIN_REL_RMS * ref_step.pow(2).mean().sqrt()


# The forward over quantized K/V (bf16 queries): each precision at both
# head dims, causal and not, windows, GQA, ragged and short key ranges.
QUANT_CASES = [
    # b, qh, kvh, n, m, d, causal, window
    (2, 4, 2, 128, 128, 64, True, None),
    (1, 8, 2, 93, 77, 128, True, None),        # rows cross q heads
    (1, 4, 2, 100, 300, 128, True, None),      # q_len < kv_len
    (2, 8, 2, 300, 300, 128, True, 77),        # window
    (1, 4, 4, 200, 333, 64, False, 50),        # window without causal
    (1, 4, 2, 256, 300, 128, False, None),     # kv_len not a tile multiple
    (1, 4, 1, 64, 40, 64, False, None),        # kv_len under one tile
    (1, 32, 8, 1000, 1536, 128, True, None),   # a chunk over a prefix
]
KV_PRECISIONS = ["int8", "fp8_e4m3", "fp8_e5m2", "nf4"]


def _quantized_kv(seed, b, kvh, m, d, precision, device):
    """K and V quantized per (batch, kv head), heads of magnitudes apart
    so that their scales differ."""
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops import quantization as tq

    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(-1.0, 1.0, (b, kvh, 1, 1)))
    return tuple(tq.quantize(torch.as_tensor(
        (rng.standard_normal((b, kvh, m, d)) * mag).astype(np.float32),
        device=device), OperandPrecision(precision)) for _ in range(2))


@pytest.mark.parametrize("precision", KV_PRECISIONS)
@pytest.mark.parametrize("b,qh,kvh,n,m,d,causal,window", QUANT_CASES)
def test_quantized_forward_kernel_matches_plain(cuda, precision, b, qh, kvh,
                                                n, m, d, causal, window):
    q = _qkv(6, b, qh, kvh, n, m, d, torch.bfloat16, cuda)[0]
    k, v = _quantized_kv(7, b, kvh, m, d, precision, cuda)
    name = f"flash_fwd_{precision}"
    before = dict(fa.LAUNCH_COUNTS)
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                        window_size=window)
    torch.cuda.synchronize()
    for key in ("flash_fwd", "flash_fwd_sm90", name):
        assert fa.LAUNCH_COUNTS[key] == before[key] + 1, key
    po, plse = fa._forward_plain_quantized(
        q, k, v, causal=causal, window_size=window, scale=d ** -0.5,
        out_dtype=torch.float32)
    assert o.dtype == torch.bfloat16
    assert max_abs_err(o, po) <= MIXED_TOL.o
    assert max_abs_err(lse, plse) <= MIXED_TOL.lse
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))


@pytest.mark.parametrize("precision", KV_PRECISIONS)
@pytest.mark.parametrize("d", [64, 128])
def test_quantized_forward_float32_out_and_refusals(cuda, precision, d):
    """A float32 O from the fragments; fp16 queries over quantized K/V
    are refused on the card (the plain version takes them)."""
    q = _qkv(8, 1, 8, 2, 200, 260, d, torch.bfloat16, cuda)[0]
    k, v = _quantized_kv(9, 1, 2, 260, d, precision, cuda)
    o, lse = fa.flash_attention_forward(q, k, v, causal=True,
                                        out_dtype=torch.float32)
    po, plse = fa._forward_plain_quantized(
        q, k, v, causal=True, window_size=None, scale=d ** -0.5,
        out_dtype=torch.float32)
    assert o.dtype == torch.float32
    assert max_abs_err(o, po) <= MIXED_TOL.o
    assert max_abs_err(lse, plse) <= MIXED_TOL.lse
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fa.flash_attention_forward(q.half(), k, v)


def _tiny_train_setup(device):
    """A 2-layer Llama at head dim 64 (a width the kernels take) in bf16,
    with the same weights and tokens on ``device``."""
    from metal_flash_attention_tpu_torch.models import llama

    cfg = llama.LlamaConfig.tiny(dim=256, n_heads=4, n_kv_heads=2,
                                 hidden_dim=512, n_layers=2)
    params = llama.init_params(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 97)))
    move = lambda t: t.to(device)  # noqa: E731
    params = {k: ([{n: move(w) for n, w in layer.items()} for layer in v]
                  if k == "layers" else move(v)) for k, v in params.items()}
    return llama, cfg, params, move(tokens)


def _loss_and_grads(llama, cfg, params, tokens, **kw):
    from metal_flash_attention_tpu_torch.utils.tree import flatten

    leaves, rebuild = flatten(params)
    work = [p.detach().requires_grad_(True) for p in leaves]
    loss = llama.loss_fn(rebuild(work), tokens, cfg, **kw)
    return loss.detach().float().cpu(), [
        g.float().cpu() for g in torch.autograd.grad(loss, work)]


def test_remat_runs_the_forward_kernel_twice(cuda):
    """Under remat the backward recomputes each layer, so the forward
    kernel runs twice per layer and step; the gradients stay the
    same."""
    llama, cfg, params, tokens = _tiny_train_setup(cuda)
    counts = []
    results = []
    for remat in (False, True):
        fa.reset_launch_counts()
        fb.reset_launch_counts()
        results.append(_loss_and_grads(llama, cfg, params, tokens,
                                       remat=remat))
        torch.cuda.synchronize()
        counts.append({**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS})
    n = cfg.n_layers
    bwd = {"flash_bwd_dq": n, "flash_bwd_dkv": n, "flash_bwd_dq_sm90": n,
           "flash_bwd_dkv_sm90": n,
           **{f"flash_bwd_{op}_{v}": 0 for op in ("dq", "dkv")
              for v in ("softcap", "d256", "d32", "aux", "f32")},
           **{f"flash_fwd_{p.value}": 0 for p in fa.KV_PRECISIONS},
           "flash_fwd_softcap": 0, "flash_fwd_d256": 0, "flash_fwd_d32": 0,
           "flash_fwd_aux": 0, "flash_fwd_f32": 0}
    assert counts[0] == {"flash_fwd": n, "flash_fwd_sm90": n, **bwd}
    assert counts[1] == {"flash_fwd": 2 * n, "flash_fwd_sm90": 2 * n, **bwd}
    (l0, g0), (l1, g1) = results
    assert float(l0) == float(l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_train_loss_and_gradients_on_the_card_match_the_cpu(cuda):
    """The kernels' loss and every parameter gradient against the same
    bf16 model on the CPU (the plain versions): loss within 1e-2 and
    each gradient within 5e-2 relative rms (bf16 products and
    activations rounded at other places on the two devices)."""
    llama, cfg, params, tokens = _tiny_train_setup(cuda)
    loss, grads = _loss_and_grads(llama, cfg, params, tokens)
    _, _, cpu_params, cpu_tokens = _tiny_train_setup(torch.device("cpu"))
    ref_loss, ref_grads = _loss_and_grads(llama, cfg, cpu_params,
                                          cpu_tokens)
    assert abs(float(loss) - float(ref_loss)) <= 1e-2
    for g, r in zip(grads, ref_grads):
        assert torch.isfinite(g).all()
        rel = (g - r).pow(2).mean().sqrt() / r.pow(2).mean().sqrt()
        assert float(rel) <= 5e-2


# The flash-attention options on the `kAux` kernels: (b, qh, kvh, n, m, d,
# causal, window, cap, options), each option set built by `_options`.
AUX_CASES = [
    (4, 4, 2, 200, 200, 64, True, None, None, "mask"),
    (4, 4, 2, 130, 300, 128, False, None, None, "mask_repeat"),
    (2, 8, 2, 256, 256, 128, True, 90, None, "mask_head_and_mask2"),
    (2, 4, 2, 200, 200, 64, True, None, None, "bias"),
    (2, 4, 4, 93, 160, 128, False, 70, 5.0, "bias_full_f32"),
    (2, 8, 2, 300, 300, 128, True, None, None, "segments"),
    (1, 4, 1, 250, 250, 64, False, None, None, "segments_no_keys"),
    (2, 8, 2, 256, 256, 128, True, 100, 20.0, "everything"),
]


def _options(kind, b, qh, n, m, dtype, device, seed=20):
    """Seeded options of one kind: masks with rows gated whole, biases
    [1 or b, qh, n, m], packed segments (3 documents), a q segment with no
    kv token."""
    rng = np.random.default_rng(seed)

    def mask(bm, hm, keep=0.7):
        x = rng.random((bm, hm, n, m)) < keep
        x[..., 3, :] = False
        return torch.as_tensor(x, device=device)

    def bias(bb, dt):
        return torch.as_tensor(rng.standard_normal((bb, qh, n, m)).astype(
            np.float32), device=device).to(dt)

    def segments(no_keys=False):
        cuts = sorted(rng.choice(np.arange(1, min(n, m)), 2, replace=False))
        q_ids = np.zeros((b, n), np.int32)
        kv_ids = np.zeros((b, m), np.int32)
        for i, c in enumerate(cuts):
            q_ids[:, c:] = i + 1
            kv_ids[:, c * m // n:] = i + 1
        if no_keys:
            q_ids[:, n // 2:n // 2 + 20] = 7
        return dict(q_segment_ids=torch.as_tensor(q_ids, device=device),
                    kv_segment_ids=torch.as_tensor(kv_ids, device=device))
    if kind == "mask":
        return dict(mask=mask(1, 1))
    if kind == "mask_repeat":
        return dict(mask=mask(2, 1, keep=0.5))
    if kind == "mask_head_and_mask2":
        return dict(mask=mask(1, qh), mask2=mask(b, 1, keep=0.9))
    if kind == "bias":
        return dict(bias=bias(1, dtype))
    if kind == "bias_full_f32":
        return dict(bias=bias(b, torch.float32))
    if kind == "segments":
        return segments()
    if kind == "segments_no_keys":
        return segments(no_keys=True)
    return dict(mask=mask(1, qh, keep=0.9), mask2=mask(2, 1, keep=0.9),
                bias=bias(1, dtype), **segments())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,qh,kvh,n,m,d,causal,window,cap,kind", AUX_CASES)
def test_option_kernels_match_plain(cuda, dtype, b, qh, kvh, n, m, d, causal,
                                    window, cap, kind):
    """The forward, dQ (with dbias) and dK/dV `_aux` kernels under
    autograd against the plain versions: o and lse at MIXED_TOL, the
    gradients (dbias reduced over the bias's size-1 dims) at MIXED_TOL
    relative to their size; each launch counted on the op, `_sm90` and
    `_aux`."""
    q, k, v, do = _qkv(30, b, qh, kvh, n, m, d, dtype, cuda)
    opts = _options(kind, b, qh, n, m, dtype, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    if "bias" in opts:
        opts["bias"] = opts["bias"].clone().requires_grad_(True)
        leaves.append(opts["bias"])
    fa.reset_launch_counts()
    fb.reset_launch_counts()
    o, lse = fa.flash_attention(*leaves[:3], **opts, causal=causal,
                                window_size=window, logit_softcap=cap,
                                return_residuals=True)
    (o.float() * do.float()).sum().backward()
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_fwd_sm90", "flash_fwd_aux"):
        assert fa.LAUNCH_COUNTS[name] == 1, name
    for op in ("dq", "dkv"):
        for suffix in ("", "_sm90", "_aux"):
            assert fb.LAUNCH_COUNTS[f"flash_bwd_{op}{suffix}"] == 1
    options = fa.check_options(q, k, **{n_: t.detach() for n_, t in
                                        opts.items()})
    kw = dict(causal=causal, window_size=window, scale=d ** -0.5,
              softcap=cap, options=options)
    po, plse = fa._forward_plain(q, k, v, out_dtype=torch.float32, **kw)
    assert max_abs_err(o, po) <= MIXED_TOL.o
    assert max_abs_err(lse, plse) <= MIXED_TOL.lse
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))
    *ref, dbias = fb._backward_plain(q.float(), k.float(), v.float(),
                                     do.float(), compute_dbias=True, **kw)
    if dbias is not None:
        ref.append(fb.reduce_dbias(dbias, opts["bias"]))
    for name, leaf, want in zip(("dq", "dk", "dv", "dbias"), leaves, ref):
        assert leaf.grad.dtype == leaf.dtype, name
        assert torch.isfinite(leaf.grad).all(), name
        ok, err = _grad_ok(leaf.grad, want, MIXED_TOL.grads)
        assert ok, (name, err)


def test_option_rows_without_keys_and_low_precision(cuda):
    """Rows whose keys are all gated or of another segment give o = 0 and
    lse = -inf; ``low_precision_intermediates`` returns lse in bf16 (the
    float32 lse rounded) and the gradients stay within MIXED_TOL."""
    q, k, v, do = _qkv(31, 1, 4, 1, 250, 250, 64, torch.bfloat16, cuda)
    opts = _options("segments_no_keys", 1, 4, 250, 250, torch.bfloat16,
                    cuda)
    opts["mask"] = _options("mask", 1, 4, 250, 250, torch.bfloat16,
                            cuda)["mask"]
    o, lse = fa.flash_attention_forward(q, k, v, **opts)
    blind = list(range(125, 145)) + [3]
    assert torch.all(o[:, :, blind] == 0)
    assert torch.all(torch.isneginf(lse[:, :, blind]))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o2, lse2 = fa.flash_attention(*leaves, **opts, return_residuals=True,
                                  low_precision_intermediates=True)
    assert lse2.dtype == torch.bfloat16
    assert torch.equal(lse2, lse.to(torch.bfloat16))
    (o2.float() * do.float()).sum().backward()
    ref = fb._backward_plain(q.float(), k.float(), v.float(), do.float(),
                             causal=False, window_size=None,
                             scale=64 ** -0.5,
                             options=fa.check_options(q, k, **opts))
    for leaf, want in zip(leaves, ref):
        ok, err = _grad_ok(leaf.grad, want, MIXED_TOL.grads)
        assert ok, err


def test_options_refused_where_the_kernels_do_not_take_them(cuda):
    """Options at head_dim 256, over quantized K/V and in float32 raise
    on the card (the plain versions take them)."""
    mask = torch.ones(1, 1, 64, 64, dtype=torch.bool, device=cuda)
    q, k, v, _ = _qkv(32, 1, 4, 2, 64, 64, 256, torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fa.flash_attention_forward(q, k, v, mask=mask)
    q, k, v, _ = _qkv(32, 1, 4, 2, 64, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fa.flash_attention_forward(q.float(), k.float(), v.float(),
                                   mask=mask)
    kq, vq = _quantized_kv(9, 1, 2, 64, 64, "int8", cuda)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        fa.flash_attention_forward(q, kq, vq, mask=mask)


def test_options_never_take_a_plain_version_on_the_card(cuda, monkeypatch):
    """A CUDA tensor with options runs the kernels or raises: the plain
    versions, replaced by a fault, are never reached."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(fa, "_forward_plain", refuse)
    monkeypatch.setattr(fb, "_backward_plain", refuse)
    q, k, v, do = _qkv(33, 2, 4, 2, 128, 128, 64, torch.bfloat16, cuda)
    opts = _options("everything", 2, 4, 128, 128, torch.bfloat16, cuda)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fa.flash_attention(*leaves, **opts, causal=True)
    (o.float() * do.float()).sum().backward()
    torch.cuda.synchronize()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


def test_float32_never_takes_a_plain_version_on_the_card(cuda, monkeypatch):
    """A float32 CUDA tensor runs the true-fp32 kernels (causal, a window
    and the cap at D 32, 128 and 256): the plain versions, replaced by a
    fault, are never reached, and every launch counts on `_f32`."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on a CUDA tensor")
    monkeypatch.setattr(fa, "_forward_plain", refuse)
    monkeypatch.setattr(fb, "_backward_plain", refuse)
    for d, window, cap in ((32, None, None), (128, 77, None),
                           (256, None, 50.0)):
        q, k, v, do = _qkv(34, 1, 4, 2, 200, 200, d, torch.float32, cuda)
        before = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fa.flash_attention(*leaves, causal=True, window_size=window,
                               logit_softcap=cap)
        (o * do).sum().backward()
        torch.cuda.synchronize()
        assert o.dtype == torch.float32
        assert all(torch.isfinite(x.grad).all() for x in leaves)
        after = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            assert after[f"{name}_f32"] == before[f"{name}_f32"] + 1, name
            assert after[f"{name}_sm90"] == before[f"{name}_sm90"], name


def test_dryrun_multichip_on_one_card(cuda, capsys):
    """`dryrun_multichip(1)` on the card in a one-rank NCCL group it starts
    itself: JAX's three lines (mesh dp=1 tp=1 cp=1, ep 1, one pipeline
    stage equal to its chain), the pipeline leg on the true-fp32
    kernels at head_dim 32."""
    from metal_flash_attention_tpu_torch.entry import dryrun_multichip

    before = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
    dryrun_multichip(1)
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("dryrun_multichip(1): mesh dp=1 tp=1 cp=1, "
                               "loss=")
    assert lines[1].startswith("  ep dryrun: mesh dp=1 ep=1, loss=")
    assert lines[2].startswith("  pp dryrun: 1 stages fwd+bwd, loss=")
    after = {**fa.LAUNCH_COUNTS, **fb.LAUNCH_COUNTS}
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        assert after[f"{name}_f32"] > before[f"{name}_f32"], name
        assert after[f"{name}_d32"] > before[f"{name}_d32"], name
