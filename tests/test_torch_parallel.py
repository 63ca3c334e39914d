"""The port's `parallel/` (`mesh.py`, `sharded_attention.py`) on four
gloo ranks against the JAX package's mesh functions on its virtual CPU
devices.

All port-side cases run in ONE module-scoped spawn of four ranks
(`tests/_torch_tp_workers.py`), each rank returning its blocks as numpy;
each test then holds one case.  The JAX functions run the Pallas kernels
in interpret mode.  Each rank's block is held against the matching block
of JAX's global output: float32 at FP32_TOL, bf16 at MIXED_TOL (o).  The
decode cases have rows whose tokens lie on fewer ranks than four, so
some ranks merge a partial of length 0 (lse -inf, o 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_tp_workers as w
from metal_flash_attention_tpu.models import gemma as jg
from metal_flash_attention_tpu.models import llama as jl
from metal_flash_attention_tpu.models import moe as jm
from metal_flash_attention_tpu.parallel import sharded_attention as jsa
from metal_flash_attention_tpu.parallel.mesh import make_mesh as jmake_mesh
from metal_flash_attention_tpu_torch.parallel import (
    make_mesh,
    shard_paged_cache_pages,
)
from metal_flash_attention_tpu_torch.utils.tolerances import (
    max_abs_err,
    tolerances_for,
)

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs 4 (virtual) JAX devices")
    return w.spawn(w.parallel_body, WORLD,
                   str(tmp_path_factory.mktemp("parallel")))


def _jax(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype))


def _tol(dtype):
    return tolerances_for(getattr(torch, dtype)).o


def test_make_mesh_needs_the_whole_group(ranks):
    """A mesh of another size than the group, a card that is not there,
    a device type that is not one, and no process group at all raise."""
    for r in ranks:
        assert r["raises"] == {"wrong_world": "ValueError",
                               "no_card": "RuntimeError",
                               "bad_device": "ValueError",
                               "not_a_mesh": "TypeError"}
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(heads=1, devices="cpu")


def test_param_shardings_match_jax_leaf_by_leaf(ranks):
    mesh = jmake_mesh(heads=2, devices=jax.devices()[:2])
    want = {"llama": jl.param_shardings(jl.LlamaConfig.tiny(), mesh),
            "gemma": jg.param_shardings(jg.GemmaConfig.tiny(), mesh),
            "moe": jm.param_shardings(jm.MoEConfig.tiny(), mesh)}
    for r in ranks:
        specs = r["specs"]
        for family, tree in want.items():
            jax_specs = jax.tree.map(lambda s: tuple(s.spec), tree)
            assert specs[family] == jax_specs, family
        # Qwen2's biases go with their weights' columns.
        for layer in specs["llama_bias"]["layers"]:
            assert layer.pop("bq") == layer.pop("bk") == layer.pop("bv") \
                == ("heads",)
        assert specs["llama_bias"] == specs["llama"]


def test_shard_and_unshard_round_trip(ranks):
    rng = np.random.default_rng(0)
    col, row, both = (rng.standard_normal(s).astype(np.float32)
                      for s in ((6, 8), (8, 6), (4, 8, 3)))
    for rank, r in enumerate(ranks):
        data, heads = divmod(rank, 2)
        assert np.array_equal(r["blocks"]["col"],
                              col[:, 4 * heads:4 * heads + 4])
        assert np.array_equal(r["blocks"]["row"],
                              row[4 * heads:4 * heads + 4])
        assert np.array_equal(r["blocks"]["both"],
                              both[2 * data:2 * data + 2,
                                   4 * heads:4 * heads + 4])
        assert r["rep_is_whole"]
        for name, full in (("col", col), ("row", row), ("both", both)):
            assert np.array_equal(r["round_trip"][name], full), name
        assert r["bad_split"] == "ValueError"
        assert r["bad_tree"] == "ValueError"


def test_shard_paged_cache_pages_is_jax_bit_for_bit():
    _, cache = w.paged_inputs(4, **w.PAGED_SHAPE)
    want = jsa.shard_paged_cache_pages(cache, WORLD)
    got = shard_paged_cache_pages(cache, WORLD)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # Pools given as CPU tensors come back as tensors, the same bits.
    tcache = w.PagedCache(torch.as_tensor(cache.k_pages),
                          torch.as_tensor(cache.v_pages), cache.page_table,
                          cache.lengths)
    got = shard_paged_cache_pages(tcache, WORLD)
    for a, b in zip(got, want):
        assert np.array_equal(np.asarray(a), b)
    # Row 0's tokens lie on fewer ranks than four.
    assert (want[3][:, 0] == 0).any()


@pytest.mark.parametrize("dtype", w.DTYPES)
def test_sharded_flash_attention_matches_jax(ranks, dtype):
    mesh = jmake_mesh(**w.FLASH_MESH, devices=jax.devices()[:WORLD])
    q, k, v = (_jax(x, dtype) for x in w.attention_inputs(1, **w.FLASH_SHAPE))
    o = np.asarray(jsa.sharded_flash_attention(mesh, causal=True)(q, k, v),
                   np.float32)
    for r in ranks:
        d, h, block = r[f"flash_{dtype}"]
        bl, hl = block.shape[:2]
        assert max_abs_err(block, o[d * bl:(d + 1) * bl,
                                    h * hl:(h + 1) * hl]) <= _tol(dtype)


@pytest.mark.parametrize("dtype", w.DTYPES)
def test_context_parallel_attention_matches_jax(ranks, dtype):
    mesh = jmake_mesh(**w.CP_MESH, devices=jax.devices()[:WORLD])
    q, k, v = (_jax(x, dtype) for x in w.attention_inputs(2, **w.CP_SHAPE))
    o = np.asarray(jsa.context_parallel_attention(mesh)(q, k, v),
                   np.float32)
    for r in ranks:
        h, _, block = r[f"cp_{dtype}"]
        hl = block.shape[1]
        assert max_abs_err(block, o[:, h * hl:(h + 1) * hl]) <= _tol(dtype)


@pytest.mark.parametrize("dtype", w.DTYPES)
def test_context_parallel_decode_matches_jax(ranks, dtype):
    """Row 0's 40 tokens lie in rank 0's 64-position slice: ranks 1-3
    merge a partial of length 0."""
    mesh = jmake_mesh(**w.DECODE_MESH, devices=jax.devices()[:WORLD])
    q, k, v, lens = w.decode_inputs(3, **w.DECODE_SHAPE)
    assert w.DECODE_LENS[0] <= w.DECODE_SHAPE["s"] // WORLD
    o = np.asarray(jsa.context_parallel_decode(mesh, block_kv=64)(
        _jax(q, dtype), _jax(k, dtype), _jax(v, dtype), jnp.asarray(lens)),
        np.float32)
    for r in ranks:
        assert max_abs_err(r[f"decode_{dtype}"], o) <= _tol(dtype)


@pytest.mark.parametrize("dtype", w.DTYPES)
def test_context_parallel_paged_decode_matches_jax(ranks, dtype):
    mesh = jmake_mesh(**w.DECODE_MESH, devices=jax.devices()[:WORLD])
    q, cache = w.paged_inputs(4, **w.PAGED_SHAPE)
    kst, vst, tbl, ln = jsa.shard_paged_cache_pages(cache, WORLD)
    o = np.asarray(jsa.context_parallel_paged_decode(mesh)(
        _jax(q, dtype), _jax(kst, dtype), _jax(vst, dtype),
        jnp.asarray(tbl), jnp.asarray(ln)), np.float32)
    local_lens = [int(r[f"paged_local_len_{dtype}"][0, 0]) for r in ranks]
    assert 0 in local_lens and sum(local_lens) == w.PAGED_LENS[0]
    for r in ranks:
        assert max_abs_err(r[f"paged_{dtype}"], o) <= _tol(dtype)
