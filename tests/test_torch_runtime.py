"""The port's runtime against the JAX package's: the device context, the
kernel-config cache and its C++ store, the H100 tile table with the
card's rules, and the tuned-winner and on-miss paths.

Each class mirrors one of JAX's `tests/test_runtime.py`.  No sweep builds
anything here: a sweep on CPU tensors runs the plain versions, timed by a
fake timer, and a fake builder records what a sweep on the card would
build.  Every cache is private (a temporary store), so that no test reads
or writes the user's `~/.cache`.
"""

import json
import logging
import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from metal_flash_attention_tpu.runtime.cache import (
    KernelConfigCache as JaxCache,
)
from metal_flash_attention_tpu.runtime.context import (
    DeviceContext as JaxContext,
)
from metal_flash_attention_tpu_torch.descriptors import parameters as P
from metal_flash_attention_tpu_torch.descriptors.attention_descriptor import (
    AttentionDescriptor,
    AttentionKernelType,
    kernel_tiles,
)
from metal_flash_attention_tpu_torch.descriptors.gemm_descriptor import (
    GEMMDescriptor,
)
from metal_flash_attention_tpu_torch.descriptors.precision import (
    OperandPrecision,
)
from metal_flash_attention_tpu_torch.native import build
from metal_flash_attention_tpu_torch.runtime import autotune
from metal_flash_attention_tpu_torch.runtime.cache import KernelConfigCache
from metal_flash_attention_tpu_torch.runtime.context import (
    KERNEL_SMEM_LIMIT,
    DeviceContext,
)

DTYPES = [(jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32),
          (jnp.float16, torch.float16)]


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    cache = KernelConfigCache(str(tmp_path / "store.json"))
    monkeypatch.setattr(KernelConfigCache, "_instance", cache)
    return cache


@pytest.fixture
def fake_timer(monkeypatch):
    """Deterministic ranking in place of the card's clock: the first
    candidate timed is the slowest, so a sweep's winner is never simply
    its first candidate."""
    calls = []

    def fake(fn, args, *, iters, repeats):
        calls.append(1)
        return 1.0 / len(calls)

    monkeypatch.setattr(autotune, "_loop_timed", fake)
    return calls


@pytest.fixture
def fake_builder(monkeypatch):
    """Records the variant libraries a sweep on the card would build."""
    built = []

    def fake(variants):
        built.append(list(variants))
        return 0.0

    monkeypatch.setattr(autotune, "_build_variants", fake)
    return built


@pytest.fixture
def on_miss():
    prev = P._AUTOTUNE_ON_MISS
    P.set_autotune_on_miss(True)
    yield
    P.set_autotune_on_miss(prev)


class TestDeviceContext:
    @pytest.mark.parametrize("kind,gen", [
        ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA H100 PCIe", "h100"),
        ("NVIDIA H200", "h200"), ("NVIDIA A100-SXM4-80GB", "a100"),
        ("cpu", "cpu"), ("Some Other Card", "cpu")])
    def test_generation_parsing(self, kind, gen):
        assert DeviceContext._parse_generation(kind) == gen

    def test_cpu_row_and_singleton(self):
        ctx = DeviceContext.get("cpu")
        assert ctx is DeviceContext.get("cpu")
        assert ctx.generation == "cpu" and ctx.platform == "cpu"
        jax_cpu = JaxContext.get().info
        assert (ctx.info.peak_bf16_flops, ctx.info.hbm_bandwidth) == (
            jax_cpu.peak_bf16_flops, jax_cpu.hbm_bandwidth)
        # The kernels' own shared-memory limit rules a CPU run's tiles.
        assert ctx.info.smem_per_block == KERNEL_SMEM_LIMIT == 232448
        assert ctx.roofline_ginstrs_per_s > 0

    def test_none_is_the_card(self):
        if torch.cuda.is_available():
            assert DeviceContext.get().platform == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                DeviceContext.get()

    def test_h100_rates_are_the_bounds_of_the_smoke(self):
        """989 TFLOP/s and 3.35 TB/s, the figures every bound of
        chip_smoke.py uses (the H100 SXM data sheet)."""
        from metal_flash_attention_tpu_torch.runtime import context
        assert context._RATES["h100"] == (989e12, 3.35e12)

    @pytest.mark.parametrize("n,d,kw", [
        (1024, 64, {}), (1024, 64, {"with_backward": True}),
        (1024, 64, {"causal": True}), (4096, 128, {"heads": 32}),
        (8192, 256, {"heads": 8, "with_backward": True, "causal": True})])
    def test_work_model_matches_jax(self, n, d, kw):
        port = DeviceContext.get("cpu").attention_ginstrs(n, d, **kw)
        assert port == JaxContext.get().attention_ginstrs(n, d, **kw)


class TestKernelConfigCache:
    @pytest.mark.parametrize("kernel", ["forward", "forward_causal",
                                        "backward_query", "decode_bf16",
                                        "paged_int8"])
    @pytest.mark.parametrize("jdt,tdt", DTYPES)
    def test_attention_keys_equal_jax(self, tmp_path, kernel, jdt, tdt):
        jax_cache = JaxCache(store_path=str(tmp_path / "jax.json"))
        for d, bucket, gen in ((64, 0, "v5"), (128, 4096, "h100"),
                               (256, 8192, "cpu")):
            assert KernelConfigCache.attention_key(
                kernel, d, tdt, q_len_bucket=bucket, generation=gen) == \
                jax_cache.attention_key(kernel, d, jdt, q_len_bucket=bucket,
                                        generation=gen)

    @pytest.mark.parametrize("ta,tb", [(False, False), (True, False),
                                       (False, True)])
    def test_gemm_keys_equal_jax(self, tmp_path, ta, tb):
        jax_cache = JaxCache(store_path=str(tmp_path / "jax.json"))
        for jdt, tdt in DTYPES:
            assert KernelConfigCache.gemm_key(
                512, 1024, 256, tdt, ta, tb, generation="h100") == \
                jax_cache.gemm_key(512, 1024, 256, jdt, ta, tb,
                                   generation="h100")

    def test_gemm_descriptor_keys(self):
        """Dense operands: JAX's key (the CPU's generation on both);
        a quantized operand adds its precision."""
        from metal_flash_attention_tpu.descriptors import (
            gemm_descriptor as jgd,
            precision as jprec,
        )
        for name in ("BF16", "FP32"):
            port = GEMMDescriptor(
                m=300, n=5000, k=1000,
                precision_a=getattr(OperandPrecision, name),
                precision_b=getattr(OperandPrecision, name),
                transpose_b=True).cache_key()
            jax_key = jgd.GEMMDescriptor(
                m=300, n=5000, k=1000,
                precision_a=getattr(jprec.OperandPrecision, name),
                precision_b=getattr(jprec.OperandPrecision, name),
                transpose_b=True).cache_key()
            assert port == jax_key
        quant = GEMMDescriptor(m=300, n=5000, k=1000,
                               precision_a=OperandPrecision.BF16,
                               precision_b=OperandPrecision.INT8)
        dense = GEMMDescriptor(m=300, n=5000, k=1000,
                               precision_a=OperandPrecision.BF16,
                               precision_b=OperandPrecision.BF16)
        assert quant.cache_key() == dense.cache_key() + "|bint8"

    def test_insert_lookup_roundtrip(self, tmp_path):
        cache = KernelConfigCache(str(tmp_path / "store.json"))
        key = cache.attention_key("forward", 128, torch.bfloat16,
                                  q_len_bucket=4096, generation="h100")
        assert cache.lookup(key) is None
        cache.insert(key, (64, 128))
        assert cache.lookup(key) == (64, 128)

    def test_persistence(self, tmp_path):
        path = str(tmp_path / "store.json")
        c1 = KernelConfigCache(path)
        key = c1.attention_key("forward", 64, torch.float32,
                               generation="h100")
        c1.insert(key, (128, 64))
        assert KernelConfigCache(path).lookup(key) == (128, 64)
        with open(path) as f:
            assert json.load(f)[key] == [128, 64]
        assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]

    def test_private_instance_and_default_store(self, tmp_path,
                                                monkeypatch):
        """An explicit path is private (no native level); the default
        store lives under MFA_TORCH_CACHE_DIR or ~/.cache/mfa_torch,
        never the JAX package's."""
        from metal_flash_attention_tpu_torch.runtime import cache as rc
        assert KernelConfigCache(str(tmp_path / "s.json"))._native is None
        monkeypatch.setenv("MFA_TORCH_CACHE_DIR", str(tmp_path / "d"))
        assert rc._default_store_path() == str(tmp_path / "d" /
                                               "autotune.json")
        monkeypatch.delenv("MFA_TORCH_CACHE_DIR")
        monkeypatch.setenv("MFA_TPU_CACHE_DIR", str(tmp_path / "jax"))
        path = rc._default_store_path()
        assert path.endswith(os.path.join(".cache", "mfa_torch",
                                          "autotune.json"))

    def test_thread_safety(self, tmp_path):
        cache = KernelConfigCache(str(tmp_path / "store.json"))

        def writer(tid):
            for i in range(50):
                cache.insert(f"k{tid}-{i}", (64 * (tid + 1), 128),
                             persist=False)

        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(cache) == 400
        for tid in range(8):
            for i in range(50):
                assert cache.lookup(f"k{tid}-{i}") == (64 * (tid + 1), 128)

    @pytest.mark.parametrize("kernel", ["backward_query",
                                        "backward_key_value", "forward"])
    def test_tuned_winner_is_card_clamped(self, fresh_cache, kernel):
        """A poisoned or foreign cache entry comes back as a tile the
        card builds (JAX: `test_tuned_winner_is_vmem_clamped`)."""
        key = fresh_cache.attention_key(kernel, 128, torch.bfloat16,
                                        q_len_bucket=4096)
        fresh_cache.insert(key, (1024, 2048))
        tile = P.select_block_sizes(kernel, 128, torch.bfloat16,
                                    seq_len=4096)
        assert tile != (1024, 2048)
        assert P.tile_is_legal(kernel, *tile, 128)

    def test_descriptor_causal_tuned_winner_is_clamped(self, fresh_cache):
        key = fresh_cache.attention_key("backward_query_causal", 128,
                                        torch.bfloat16, q_len_bucket=4096)
        fresh_cache.insert(key, (2048, 4096))
        desc = AttentionDescriptor(q_len=4096, head_dim=128, causal=True,
                                   input_precision=OperandPrecision.BF16)
        cfg = desc.kernel_config(AttentionKernelType.BACKWARD_QUERY)
        assert (cfg.block_q, cfg.block_kv) == (128, 128)
        assert cfg.library == ()


class TestNativeStore:
    """The port's own C++ store (`native/src/config_store.cpp`), built by
    its own `build_native` into `build/libmfa_native.so`: it never skips
    and never loads the JAX package's `libmfa_tpu.so`."""

    @pytest.fixture(scope="class")
    def store(self):
        from metal_flash_attention_tpu_torch.native.config_store import (
            ConfigStore,
        )
        store = ConfigStore.get()
        assert store._lib._name == build.NATIVE_LIB
        return store

    def test_insert_lookup(self, store):
        store.insert("test|native|a", (64, 128))
        assert store.lookup("test|native|a") == (64, 128)
        assert store.lookup("test|native|missing") is None

    def test_overwrite(self, store):
        store.insert("test|native|b", (128, 128))
        store.insert("test|native|b", (64, 64))
        assert store.lookup("test|native|b") == (64, 64)

    def test_rejects_bad_input(self, store):
        from metal_flash_attention_tpu_torch.native.config_store import (
            NativeError,
        )
        with pytest.raises(NativeError, match="positive"):
            store.insert("test|native|c", (0, 128))

    def test_hash_determinism_and_dispersion(self, store):
        h1 = store.hash_bytes(b"attn|forward|d128|bfloat16|n4096|h100")
        h2 = store.hash_bytes(b"attn|forward|d128|bfloat16|n4096|h100")
        h3 = store.hash_bytes(b"attn|forward|d128|bfloat16|n4096|h200")
        assert h1 == h2 and h1 != h3
        assert bin(h1 ^ h3).count("1") > 16
        assert store.combine64(1, 2) != store.combine64(2, 1)

    def test_save_load(self, store, tmp_path):
        path = str(tmp_path / "store.bin")
        store.insert("test|native|persist", (128, 64))
        store.save(path)
        assert os.path.getsize(path) > 8
        store.load(path)
        assert store.lookup("test|native|persist") == (128, 64)

    def test_concurrent_insert_lookup(self, store):
        errors = []

        def worker(tid):
            try:
                for i in range(100):
                    key = f"test|conc|{tid}|{i}"
                    store.insert(key, (tid + 1, i + 1))
                    assert store.lookup(key) == (tid + 1, i + 1)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errors

    def test_default_cache_uses_the_store(self, tmp_path, monkeypatch,
                                          store):
        monkeypatch.setenv("MFA_TORCH_CACHE_DIR", str(tmp_path))
        cache = KernelConfigCache()
        assert cache._native is store
        cache.insert("test|default|a", (64, 64))
        assert store.lookup("test|default|a") == (64, 64)
        assert os.path.exists(tmp_path / "autotune.json")


class TestTable:
    """The H100 table and the card's rules."""

    @pytest.mark.parametrize("d", [64, 128, 256])
    def test_default_rows_equal_kernel_tiles(self, d):
        tiles = kernel_tiles(d)
        for kind in AttentionKernelType:
            for table in (kind.value, f"{kind.value}_causal"):
                tile = P.select_block_sizes(table, d, torch.bfloat16,
                                            generation="h100")
                assert tile == tiles[kind]
                assert P.tile_library(table, *tile, d) == ()
        defines = build.tile_defines()
        assert tiles[AttentionKernelType.FORWARD] == (
            (defines["MFA_FWD90_D256_BLOCK_Q"],
             defines["MFA_FWD90_D256_BLOCK_KV"]) if d == 256 else
            (defines["MFA_FWD90_BLOCK_Q"], defines["MFA_FWD90_BLOCK_KV"]))

    def test_legal_tiles_follow_the_kernels_asserts(self):
        legal = {(k, d): P.legal_tiles(k, d) for k in P.FAMILIES
                 for d in (64, 128, 256)}
        quad = [(64, 64), (64, 128), (128, 64), (128, 128)]
        assert legal["forward", 128] == quad
        assert legal["forward", 256] == [(64, 64), (128, 64)]
        assert legal["backward_query", 64] == quad
        assert legal["backward_query", 256] == [(64, 64)]
        # dK/dV: 128-row steps overflow the options' stages at D 128, and
        # 64-key blocks split D 64 into 32-column halves.
        assert legal["backward_key_value", 64] == [(64, 128)]
        assert legal["backward_key_value", 128] == [(64, 128)]
        assert legal["backward_key_value", 256] == [(64, 64)]
        # The default quantized forward fills the block but fits.
        assert P._fwd_smem(128, 128, 128, 2, "int8") <= KERNEL_SMEM_LIMIT
        # Less shared memory, fewer tiles: the quantized rings decide.
        assert P.legal_tiles("forward", 128, limit=200_000) == [
            (64, 64), (128, 64)]

    @pytest.mark.parametrize("kernel,req,d,want", [
        ("forward", (64, 64), 128, (64, 64)),
        ("forward", (1024, 2048), 128, (128, 128)),
        ("forward", (96, 200), 128, (64, 128)),
        ("forward", (32, 32), 128, (64, 64)),
        ("forward", (256, 256), 256, (128, 64)),
        ("backward_key_value", (64, 64), 128, (64, 128)),
        ("backward_query_causal", (512, 64), 128, (128, 64))])
    def test_clamp_to_card(self, kernel, req, d, want):
        assert P.clamp_to_card(kernel, *req, d) == want

    def test_tile_libraries(self):
        lib = P.tile_library("forward", 64, 128, 128)
        assert lib == (("MFA_FWD90_BLOCK_KV", 128), ("MFA_FWD90_BLOCK_Q",
                                                      64))
        assert P.tile_library("backward_query_causal", 128, 64, 256) == (
            ("MFA_BWD90_D256_DQ_BLOCK_KV", 64),
            ("MFA_BWD90_D256_DQ_BLOCK_Q", 128))
        path = build.library_path("flash_attention", lib)
        assert path.startswith(build.VARIANTS_DIR)
        assert os.path.basename(os.path.dirname(path)) == \
            build.variant_tag("flash_attention", dict(lib))
        assert build.library_path("flash_attention", ()) == \
            os.path.join(build.BUILD_DIR, "libflash_attention.so")

    def test_gemm_tiles(self):
        bf16 = GEMMDescriptor(m=8192, n=14336, k=4096,
                              precision_a=OperandPrecision.BF16,
                              precision_b=OperandPrecision.BF16)
        int8 = GEMMDescriptor(m=8192, n=14336, k=4096,
                              precision_a=OperandPrecision.BF16,
                              precision_b=OperandPrecision.INT8)
        assert bf16.kernel_config("sm90", generation="h100") == \
            bf16.table_config("sm90")
        cfg = bf16.kernel_config("sm90", block_m=256, block_n=128,
                                 block_k=512)
        assert (cfg.block_m, cfg.block_n, cfg.block_k) == (256, 128, 64)
        assert cfg.library == (("MFA_GEMM90_BLOCK_M", 256),
                               ("MFA_GEMM90_BLOCK_N", 128))
        assert bf16.kernel_config("sm90", block_m=128,
                                  block_n=128).library == ()
        cfg = bf16.kernel_config("sm90", block_m=512, block_n=512)
        assert (cfg.block_m, cfg.block_n) == (128, 256)
        cfg = int8.kernel_config("sm90", block_m=128, block_n=256)
        assert cfg.library == (("MFA_GEMM90_QUANT_BLOCK_M", 128),
                               ("MFA_GEMM90_QUANT_BLOCK_N", 256))
        mma = bf16.kernel_config("mma", block_m=256, block_n=64, block_k=8)
        assert mma == bf16.table_config("mma")


class TestTunedLookupIntegration:
    def test_select_block_sizes_prefers_tuned(self, fresh_cache):
        key = fresh_cache.attention_key("forward", 128, torch.bfloat16,
                                        q_len_bucket=4096)
        fresh_cache.insert(key, (64, 128))
        assert P.select_block_sizes("forward", 128, torch.bfloat16,
                                    seq_len=3000) == (64, 128)
        # Without seq_len the table serves.
        assert P.select_block_sizes("forward", 128,
                                    torch.bfloat16) == (128, 128)
        desc = AttentionDescriptor(q_len=4096, head_dim=128,
                                   input_precision=OperandPrecision.BF16)
        cfg = desc.kernel_config(AttentionKernelType.FORWARD)
        assert (cfg.block_q, cfg.block_kv) == (64, 128)
        assert cfg.library == P.tile_library("forward", 64, 128, 128)
        # A caller's tile beats the winner, clamped to the rules.
        cfg = desc.kernel_config(AttentionKernelType.FORWARD, block_q=64,
                                 block_kv=64)
        assert (cfg.block_q, cfg.block_kv) == (64, 64)

    def test_decode_and_paged_tuned_lookups_fire(self, fresh_cache):
        from metal_flash_attention_tpu_torch.ops import flash_decode as fd
        from metal_flash_attention_tpu_torch.ops import paged_attention as pa
        fresh_cache.insert(fresh_cache.attention_key(
            "decode_bf16", 64, torch.bfloat16, q_len_bucket=512), (1, 256))
        assert autotune.lookup_tuned_blocks(
            "decode_bf16", 64, torch.bfloat16, 512) == (1, 256)
        assert fd.decode_chunk_cap(None, None, 64, torch.bfloat16,
                                   500) == 256
        assert fd.decode_chunk_cap(None, None, 64, torch.bfloat16,
                                   4096) == 1024
        assert fd.decode_chunk_cap(200, None, 64, torch.bfloat16,
                                   500) == 192
        fresh_cache.insert(fresh_cache.attention_key(
            "paged_int8", 128, torch.bfloat16, q_len_bucket=8192), (1, 16))
        assert pa.tuned_chunk("paged", OperandPrecision.INT8, 128,
                              torch.bfloat16, 8192) == 16

    def test_generation_fallback_logged_once(self, caplog):
        P._FALLBACK_NOTED.clear()
        with caplog.at_level(logging.WARNING, logger=P.__name__):
            for _ in range(2):
                assert P.select_block_sizes(
                    "forward", 128, torch.bfloat16,
                    generation="h200") == (128, 128)
        assert len([r for r in caplog.records
                    if "card" in r.getMessage()]) == 1
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=P.__name__):
            P.select_block_sizes("forward", 128, torch.bfloat16,
                                 generation=P.TUNED_GENERATION)
            P.select_block_sizes("forward", 128, torch.bfloat16,
                                 generation="cpu")
        assert not caplog.records

    def test_autotune_causal_key_matches_lookup(self, fresh_cache,
                                                fake_timer):
        winner, results = autotune.autotune_attention(
            kernel_type="forward", n=256, head_dim=64, heads=2,
            causal=True, candidates=((128, 128), (64, 64)), device="cpu",
            cache=fresh_cache)
        assert winner == (64, 64) and len(results) == 2
        assert P.select_block_sizes("forward_causal", 64, torch.bfloat16,
                                    seq_len=256) == winner
        # The dense entry stays the table's.
        assert P.select_block_sizes("forward", 64, torch.bfloat16,
                                    seq_len=256) == (128, 128)

    def test_backward_sweep_records_both_kernels(self, fresh_cache,
                                                 fake_timer):
        winner, results = autotune.autotune_attention(
            kernel_type="backward_query", n=128, head_dim=64, heads=2,
            device="cpu", cache=fresh_cache)
        assert list(results)[0] == ((128, 128), (64, 128))
        assert len(results) == 4
        pair = min(results, key=results.get)
        assert winner == pair[0]
        assert P.select_block_sizes("backward_query", 64, torch.bfloat16,
                                    seq_len=128) == pair[0]
        assert P.select_block_sizes("backward_key_value", 64,
                                    torch.bfloat16, seq_len=128) == pair[1]

    def test_failing_candidate_is_an_error(self, fresh_cache, fake_timer):
        """A candidate whose output misses the plain version's is never a
        winner: the sweep raises."""
        def strict(got, ref):
            raise AssertionError("planted")
        with pytest.raises(RuntimeError, match="failed its check"):
            autotune.autotune_attention(
                kernel_type="forward", n=128, head_dim=64, heads=1,
                candidates=((64, 64),), device="cpu", cache=fresh_cache,
                check=strict)
        assert len(fresh_cache) == 0

    def test_default_check_sees_a_dropped_tile(self):
        ref = {"o": torch.randn(1, 2, 256, 64), "lse": torch.randn(1, 2, 256)}
        got = {"o": ref["o"].clone(), "lse": ref["lse"].clone()}
        assert autotune.default_check(got, ref)["o"] == 0.0
        got["o"][0, 1, 192:] = 0
        with pytest.raises(AssertionError):
            autotune.default_check(got, ref)

    def test_sweep_builds_every_variant_together(self, fake_builder):
        """What a sweep on the card builds: one library a non-default
        tile, all in one call."""
        forward = autotune.attention_candidates("forward", 128)
        autotune.build_candidates(
            [("flash_attention", P.tile_library("forward", *t, 128))
             for t in forward], torch.device("cuda"))
        assert len(fake_builder) == 1 and len(fake_builder[0]) == 3
        assert all(name == "flash_attention" and lib
                   for name, lib in fake_builder[0])
        fake_builder.clear()
        autotune.build_candidates([("gemm", ())], torch.device("cuda"))
        autotune.build_candidates(
            [("gemm", (("MFA_GEMM90_BLOCK_M", 256),))],
            torch.device("cpu"))
        assert fake_builder == []


class TestAutotuneOnMiss:
    def test_attention_novel_head_dim_sweeps_once(
            self, fresh_cache, fake_timer, fake_builder, on_miss):
        got1 = P.select_block_sizes("forward", 96, torch.bfloat16,
                                    seq_len=512, device="cpu")
        n_first = len(fake_timer)
        assert n_first >= 2
        got2 = P.select_block_sizes("forward", 96, torch.bfloat16,
                                    seq_len=512, device="cpu")
        assert len(fake_timer) == n_first and got1 == got2
        assert fake_builder == []  # a CPU sweep builds nothing

    def test_long_seq_miss_winner_is_reused(
            self, fresh_cache, fake_timer, on_miss, monkeypatch):
        """The sweep runs at a capped length and its winner lands under
        the caller's bucket too (JAX: the sweep at min(bucket, 8192));
        the cap is lowered here so that the CPU's plain versions stay
        small."""
        monkeypatch.setattr(P, "MISS_SWEEP_MAX_N", 256)
        got1 = P.select_block_sizes("forward", 96, torch.bfloat16,
                                    seq_len=16384, device="cpu")
        n_first = len(fake_timer)
        assert n_first >= 2
        got2 = P.select_block_sizes("forward", 96, torch.bfloat16,
                                    seq_len=16384, device="cpu")
        assert len(fake_timer) == n_first and got1 == got2

    def test_unmeasured_generation_sweeps(self, fresh_cache, fake_timer,
                                          on_miss):
        P.select_block_sizes("forward", 128, torch.bfloat16, seq_len=256,
                             generation="h200", device="cpu")
        assert len(fake_timer) >= 2

    def test_measured_head_dim_never_sweeps(self, fresh_cache, fake_timer,
                                            on_miss):
        for d in P.MEASURED_HEAD_DIMS:
            P.select_block_sizes("forward", d, torch.bfloat16,
                                 seq_len=4096, generation="h100",
                                 device="cpu")
        assert not fake_timer

    def test_disabled_on_cpu_by_default(self, fresh_cache, fake_timer):
        P.set_autotune_on_miss(None)
        assert not P.autotune_on_miss_enabled("cpu")
        P.select_block_sizes("forward", 96, torch.bfloat16, seq_len=512,
                             device="cpu")
        assert not fake_timer

    def test_cpu_tensor_never_sweeps_nor_builds(self, fresh_cache,
                                                fake_timer, on_miss):
        from metal_flash_attention_tpu_torch.ops import flash_attention as fa
        q = torch.randn(1, 2, 64, 96)
        fa.flash_attention(q, q, q, causal=True)
        fa.flash_attention(q, q, q, block_q=64, block_kv=64)
        assert not fake_timer
        assert fa._kernel_library.cache_info().currsize == 0
        assert not fa.LAUNCH_TILES["flash_fwd"]

    def test_gemm_miss_sweeps_once(self, fresh_cache, fake_timer, on_miss):
        desc = GEMMDescriptor(m=384, n=384, k=384,
                              precision_a=OperandPrecision.BF16,
                              precision_b=OperandPrecision.BF16)
        cfg1 = desc.kernel_config("sm90", generation="h200", device="cpu")
        n_first = len(fake_timer)
        assert n_first >= 2
        cfg2 = desc.kernel_config("sm90", generation="h200", device="cpu")
        assert len(fake_timer) == n_first and cfg1 == cfg2
        # The measured card never sweeps a GEMM.
        desc.kernel_config("sm90", generation="h100", device="cpu")
        assert len(fake_timer) == n_first


def test_plain_results_do_not_depend_on_the_tile():
    """On the CPU a tile request changes nothing the plain versions
    compute."""
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 4, 96, 64, generator=g) for _ in range(3))
    o = fa.flash_attention(q, k, v, causal=True)
    o2 = fa.flash_attention(q, k, v, causal=True, block_q=64, block_kv=64)
    assert torch.equal(o, o2)
    assert np.isfinite(o.numpy()).all()
