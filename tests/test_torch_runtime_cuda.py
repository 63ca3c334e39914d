"""The runtime's tile choice on the card: tile variants of the forward,
the backward pair and the GEMM against their plain versions, the launch
counters' tiles, the clamp of an illegal request, dispatch by a cached
winner, the decode and paged chunk caps, and a variant that fails to
build.

These tests need an NVIDIA GPU with sm_90a and nvcc; elsewhere each one
skips with its reason.  The file imports neither JAX nor the JAX
package, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_runtime_cuda.py

The variants build once, together, in a fixture (one nvcc each).  Every
config cache here is private.  Tolerance: the worst 64-row tile's
relative rms error within KERNEL_TILE_REL_RMS (1.5e-2), lse within
MIXED_TOL.
"""

import importlib

import pytest
import torch

from metal_flash_attention_tpu_torch.descriptors import parameters as P
from metal_flash_attention_tpu_torch.descriptors.gemm_descriptor import (
    GEMMDescriptor,
)
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.native import build
from metal_flash_attention_tpu_torch.ops import flash_attention as fa
from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
from metal_flash_attention_tpu_torch.ops import flash_decode as fd
from metal_flash_attention_tpu_torch.ops import paged_attention as pa
from metal_flash_attention_tpu_torch.ops.quantization import quantize_matrix
from metal_flash_attention_tpu_torch.runtime.cache import KernelConfigCache
from metal_flash_attention_tpu_torch.utils.tolerances import (
    KERNEL_TILE_REL_RMS,
    MIXED_TOL,
    max_abs_err,
    worst_tile_rel_rms,
)

tg = importlib.import_module("metal_flash_attention_tpu_torch.ops.gemm")

FWD_TILES = [(64, 128), (128, 64), (64, 64)]
DQ_TILES = [(64, 128), (128, 64), (64, 64)]
GEMM = {"bf16": (256, 128), "int8": (128, 256)}


def _variants():
    out = [("flash_attention", P.tile_library("forward", *t, 128))
           for t in FWD_TILES]
    out += [("flash_attention_bwd", P.tile_library("backward_query", *t, 128))
            for t in DQ_TILES]
    for prec, tile in GEMM.items():
        desc = GEMMDescriptor(m=1024, n=1024, k=1024,
                              precision_a=OperandPrecision.BF16,
                              precision_b=OperandPrecision(prec))
        out.append(("gemm", desc.library("sm90", *tile)))
    return out


@pytest.fixture(scope="module")
def variants():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels have no CPU mode")
    build.build_variants([(n, None) for n in build.sources()] + _variants())
    return torch.device("cuda")


@pytest.fixture
def cuda(variants, tmp_path, monkeypatch):
    monkeypatch.setattr(KernelConfigCache, "_instance", KernelConfigCache(
        str(tmp_path / "store.json")))
    for module in (fa, fb, tg, fd, pa):
        module.reset_launch_counts()
    return variants


def _qkv(seed, q_heads, kv_heads, n, d, device, count=3):
    g = torch.Generator(device=device).manual_seed(seed)
    heads = (q_heads, kv_heads, kv_heads, q_heads)[:count]
    return [torch.randn((1, h, n, d), generator=g, device=device).to(
        torch.bfloat16) for h in heads]


@pytest.mark.parametrize("tile", FWD_TILES + [(128, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_tile_against_plain(cuda, tile, causal):
    q, k, v = _qkv(0, 8, 2, 1000, 128, cuda)
    o, lse = fa.flash_attention_forward(q, k, v, causal=causal,
                                        block_q=tile[0], block_kv=tile[1])
    ref_o, ref_lse = fa._forward_plain(q, k, v, causal=causal,
                                       window_size=None, scale=128 ** -0.5,
                                       out_dtype=torch.bfloat16)
    assert worst_tile_rel_rms(o, ref_o) <= KERNEL_TILE_REL_RMS
    assert max_abs_err(lse, ref_lse) <= MIXED_TOL.lse
    assert dict(fa.LAUNCH_TILES["flash_fwd"]) == {tile: 1}


@pytest.mark.parametrize("tile", DQ_TILES + [(128, 128)])
def test_backward_pair_tile_against_plain(cuda, tile):
    q, k, v, do = _qkv(1, 8, 2, 700, 128, cuda, count=4)
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    dq, dk, dv, _ = fb._backward(
        q, k, v, do, o, lse, causal=True, window_size=None, scale=None,
        tiles={"backward_query": tile})
    ref = fb._backward_plain(q, k, v, do, causal=True, window_size=None,
                             scale=128 ** -0.5)
    for got, want in zip((dq, dk, dv), ref):
        assert worst_tile_rel_rms(got, want) <= KERNEL_TILE_REL_RMS
    assert dict(fb.LAUNCH_TILES["flash_bwd_dq"]) == {tile: 1}
    assert dict(fb.LAUNCH_TILES["flash_bwd_dkv"]) == {(64, 128): 1}


def test_flash_attention_block_keywords_reach_all_three(cuda):
    """flash_attention(block_q=64, block_kv=64): the forward and dQ take
    64 x 64; dK/dV's nearest legal tile is 64 x 128."""
    q, k, v = (t.requires_grad_(True) for t in _qkv(2, 8, 2, 512, 128,
                                                     cuda))
    o = fa.flash_attention(q, k, v, causal=True, block_q=64, block_kv=64)
    o.float().sum().backward()
    assert dict(fa.LAUNCH_TILES["flash_fwd"]) == {(64, 64): 1}
    assert dict(fb.LAUNCH_TILES["flash_bwd_dq"]) == {(64, 64): 1}
    assert dict(fb.LAUNCH_TILES["flash_bwd_dkv"]) == {(64, 128): 1}


@pytest.mark.parametrize("prec", ["bf16", "int8"])
def test_gemm_tile_against_plain(cuda, prec):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = torch.randn((1000, 1024), generator=g, device=cuda).to(
        torch.bfloat16)
    b = torch.randn((1024, 1536), generator=g, device=cuda)
    b = b.to(torch.bfloat16) if prec == "bf16" else quantize_matrix(
        b, OperandPrecision.INT8, contract_axis=0, per_channel=True)
    tile = GEMM[prec]
    kw = {"backend": "pallas"} if prec == "bf16" else {}
    out = tg.gemm(a, b, block_m=tile[0], block_n=tile[1], **kw)
    ref = tg._gemm_plain(a, b)
    assert worst_tile_rel_rms(out, ref) <= KERNEL_TILE_REL_RMS
    assert dict(tg.LAUNCH_TILES["gemm"]) == {(*tile, 64): 1}
    assert tg.LAUNCH_COUNTS["gemm_sm90"] == 1


def test_illegal_requests_are_clamped(cuda):
    q, k, v = _qkv(4, 4, 4, 300, 128, cuda)
    fa.flash_attention_forward(q, k, v, block_q=96, block_kv=300)
    assert dict(fa.LAUNCH_TILES["flash_fwd"]) == {(64, 128): 1}
    a = torch.randn((512, 512), device=cuda).to(torch.bfloat16)
    tg.gemm(a, a, block_m=512, block_n=512, block_k=512)
    assert dict(tg.LAUNCH_TILES["gemm"]) == {(128, 256, 64): 1}


def test_cached_winner_dispatches(cuda):
    cache = KernelConfigCache.get()
    cache.insert(cache.attention_key("forward_causal", 128, torch.bfloat16,
                                     q_len_bucket=1024), (128, 64))
    q, k, v = _qkv(5, 8, 2, 1000, 128, cuda)
    o = fa.flash_attention(q, k, v, causal=True)
    o_default = fa.flash_attention(q, k, v, causal=False)
    assert dict(fa.LAUNCH_TILES["flash_fwd"]) == {(128, 64): 1,
                                                  (128, 128): 1}
    ref = fa._forward_plain(q, k, v, causal=True, window_size=None,
                            scale=128 ** -0.5, out_dtype=torch.bfloat16)[0]
    assert worst_tile_rel_rms(o, ref) <= KERNEL_TILE_REL_RMS
    assert o_default.shape == o.shape


def test_decode_chunk_caps(cuda):
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((8, 32, 128), generator=g, device=cuda).to(
        torch.bfloat16)
    k, v = (torch.randn((8, 8, 8192, 128), generator=g, device=cuda).to(
        torch.bfloat16) for _ in range(2))
    lens = torch.tensor([8192, 3000] * 4, dtype=torch.int32, device=cuda)
    o = fd.flash_decode(q, k, v, kv_lens=lens)
    o_cap = fd.flash_decode(q, k, v, kv_lens=lens, block_kv=256)
    # 64 (sequence, kv head) pairs: two waves want ~1,600-key chunks, so
    # MFA_DECODE_CHUNK (1,024) and the 256 cap each bind.
    assert dict(fd.LAUNCH_TILES["flash_decode"]) == {1024: 1, 256: 1}
    ref = fd._flash_decode_plain(q, k, v, kv_lens=lens, kv_starts=None,
                                 max_span=None, scale=128 ** -0.5)[0]
    for got in (o, o_cap):
        assert worst_tile_rel_rms(got[:, :, None], ref[:, :, None]) <= \
            KERNEL_TILE_REL_RMS
    # The same K/V as a pool of 128-token pages: pages_per_chunk=2 caps
    # the paged decode's chunk at 256 keys.
    def pages(x):
        return x.unflatten(2, (64, 128)).transpose(1, 2).reshape(
            512, 8, 128, 128).contiguous()
    table = torch.arange(512, dtype=torch.int32, device=cuda).reshape(8, 64)
    cache = pa.PagedKVCache(pages(k), pages(v), table, lens)
    for ppc, chunk in ((None, 1024), (2, 256)):
        pa.reset_launch_counts()
        got = pa.paged_decode(q, cache, pages_per_chunk=ppc)
        assert dict(pa.LAUNCH_TILES["paged_decode"]) == {chunk: 1}
        assert worst_tile_rel_rms(got[:, :, None], ref[:, :, None]) <= \
            KERNEL_TILE_REL_RMS


def test_failing_variant_build_raises(cuda, monkeypatch):
    """A tile whose variant does not build raises: nothing falls back to
    the plain library or the plain version."""
    bad = (("MFA_FWD90_BLOCK_KV", 128), ("MFA_FWD90_BLOCK_Q", 192))
    real = fa.kernel_config

    def broken(*args, **kw):
        cfg = real(*args, **kw)
        return type(cfg)(**{**cfg.__dict__, "library": bad})
    monkeypatch.setattr(fa, "kernel_config", broken)
    q, k, v = _qkv(7, 2, 2, 128, 128, cuda)
    fa.reset_launch_counts()
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fa.flash_attention_forward(q, k, v)
    assert fa.LAUNCH_COUNTS["flash_fwd"] == 0
