"""The paged-attention CUDA kernels against their plain PyTorch version,
on the card.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_paged_cuda.py

Tolerance: the bf16 tier, MIXED_TOL (o 5e-2, lse 7e-3); the kernel
rounds P to bf16 before PV, the plain version keeps it in float32.
"""

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.ops import paged_attention as pa
from metal_flash_attention_tpu_torch.utils.tolerances import (
    MIXED_TOL,
    max_abs_err,
)


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


def _plain(q, cache, window, decode):
    q4 = q[:, :, None] if decode else q
    o, lse = pa._paged_attention_plain(q4, cache, scale=q.shape[-1] ** -0.5,
                                       window_size=window)
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
    with pytest.raises(NotImplementedError):
        pa.paged_decode(q, cache, logit_softcap=30.0)
