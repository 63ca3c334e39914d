"""The flash-attention CUDA kernels (forward, dQ, dK/dV) against their
plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_flash_cuda.py

Tolerance: the bf16 tier, MIXED_TOL (o 5e-2, lse 7e-3, grads 5e-2).  The
kernels round P and dS to the input type before the products that
consume them; the plain versions stay in float32.  Gradients are held
relative to their own size where it exceeds 1: err <= tol * max(1,
max |ref|).
"""

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.ops import flash_attention as fa
from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
from metal_flash_attention_tpu_torch.utils.tolerances import (
    MIXED_TOL,
    max_abs_err,
)


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


def _forward_checked(q, k, v, d, causal, window, out_dtype=None):
    """One forward through the kernel, held against the plain version;
    the launch counted on the op and on the sm90 kernel."""
    before = dict(fa.LAUNCH_COUNTS)
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                        window_size=window,
                                        out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert fa.LAUNCH_COUNTS["flash_fwd"] == before["flash_fwd"] + 1
    assert fa.LAUNCH_COUNTS["flash_fwd_sm90"] == \
        before["flash_fwd_sm90"] + 1
    po, plse = fa._forward_plain(q, k, v, causal=causal, window_size=window,
                                 scale=d ** -0.5, out_dtype=torch.float32)
    assert o.dtype == (out_dtype or q.dtype) and lse.dtype == torch.float32
    assert max_abs_err(o, po) <= MIXED_TOL.o
    assert max_abs_err(lse, plse) <= MIXED_TOL.lse
    assert torch.equal(torch.isinf(lse), torch.isinf(plse))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,qh,kvh,n,m,d,causal,window",
                         CASES + EDGE_CASES)
def test_forward_kernel_matches_plain(cuda, dtype, b, qh, kvh, n, m, d,
                                      causal, window):
    q, k, v, _ = _qkv(0, b, qh, kvh, n, m, d, dtype, cuda)
    _forward_checked(q, k, v, d, causal, window)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", [64, 128])
def test_forward_kernel_float32_out(cuda, dtype, d):
    """out_dtype=float32: O stored from the fragments, rows past the head
    (q_len 93, group 4: the last tile's second warpgroup) not written."""
    q, k, v, _ = _qkv(6, 1, 8, 2, 93, 150, d, dtype, cuda)
    _forward_checked(q, k, v, d, True, None, out_dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b,qh,kvh,n,m,d,causal,window",
                         CASES + BWD_EDGE_CASES)
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
    assert fb.LAUNCH_COUNTS == {name: c + 1 for name, c in before.items()}
    assert (dq.dtype, dk.dtype, dv.dtype) == (dtype,) * 3
    ref = fb._backward_plain(q.float(), k.float(), v.float(), do.float(),
                             causal=causal, window_size=window,
                             scale=d ** -0.5)
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        assert torch.isfinite(got).all(), name
        ok, err = _grad_ok(got, want, MIXED_TOL.grads)
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
    with pytest.raises(NotImplementedError):
        fa.flash_attention_forward(q.float(), k.float(), v.float())
    q96, k96, v96, _ = _qkv(4, 1, 4, 2, 64, 64, 96, torch.bfloat16, cuda)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_forward(q96, k96, v96)
    with pytest.raises(TypeError):
        fa.flash_attention_forward(q, k.half(), v)
    with pytest.raises(NotImplementedError):
        fa.flash_attention_forward(q, k, v, logit_softcap=30.0)


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
           "flash_bwd_dkv_sm90": n}
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
