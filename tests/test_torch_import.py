"""The port stands apart from JAX, and its CUDA-only paths refuse to run
on a machine without a card instead of quietly running on the CPU.

Each check runs in a fresh interpreter, so that JAX, imported by the
other test files, is not already in `sys.modules`."""

import dataclasses
import os
import shutil
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from metal_flash_attention_tpu_torch.models import (
    convert,
    llama,
    lora,
    serving,
)
from metal_flash_attention_tpu_torch.ops import paged_attention
from metal_flash_attention_tpu_torch.utils import data, device, params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "metal_flash_attention_tpu_torch",
    "metal_flash_attention_tpu_torch.descriptors.attention_descriptor",
    "metal_flash_attention_tpu_torch.descriptors.gemm_descriptor",
    "metal_flash_attention_tpu_torch.descriptors.parameters",
    "metal_flash_attention_tpu_torch.descriptors.precision",
    "metal_flash_attention_tpu_torch.dispatch",
    "metal_flash_attention_tpu_torch.entry",
    "metal_flash_attention_tpu_torch.models.convert",
    "metal_flash_attention_tpu_torch.models.engine",
    "metal_flash_attention_tpu_torch.models.llama",
    "metal_flash_attention_tpu_torch.models.lora",
    "metal_flash_attention_tpu_torch.models.losses",
    "metal_flash_attention_tpu_torch.models.moe",
    "metal_flash_attention_tpu_torch.models.optim",
    "metal_flash_attention_tpu_torch.models.prefix_cache",
    "metal_flash_attention_tpu_torch.models.serving",
    "metal_flash_attention_tpu_torch.native.build",
    "metal_flash_attention_tpu_torch.native.config_store",
    "metal_flash_attention_tpu_torch.native.page_allocator",
    "metal_flash_attention_tpu_torch.ops.flash_attention",
    "metal_flash_attention_tpu_torch.ops.flash_attention_bwd",
    "metal_flash_attention_tpu_torch.ops.flash_decode",
    "metal_flash_attention_tpu_torch.ops.gemm",
    "metal_flash_attention_tpu_torch.ops.paged_attention",
    "metal_flash_attention_tpu_torch.ops.quantization",
    "metal_flash_attention_tpu_torch.ops.reference",
    "metal_flash_attention_tpu_torch.ops.softmax",
    "metal_flash_attention_tpu_torch.parallel",
    "metal_flash_attention_tpu_torch.parallel.mesh",
    "metal_flash_attention_tpu_torch.parallel.pipeline",
    "metal_flash_attention_tpu_torch.parallel.ring_attention",
    "metal_flash_attention_tpu_torch.parallel.sharded_attention",
    "metal_flash_attention_tpu_torch.parallel.zigzag",
    "metal_flash_attention_tpu_torch.runtime",
    "metal_flash_attention_tpu_torch.runtime.__main__",
    "metal_flash_attention_tpu_torch.runtime.autotune",
    "metal_flash_attention_tpu_torch.runtime.cache",
    "metal_flash_attention_tpu_torch.runtime.context",
    "metal_flash_attention_tpu_torch.utils.checkpoint",
    "metal_flash_attention_tpu_torch.utils.data",
    "metal_flash_attention_tpu_torch.utils.device",
    "metal_flash_attention_tpu_torch.utils.errors",
    "metal_flash_attention_tpu_torch.utils.params",
    "metal_flash_attention_tpu_torch.utils.profiling",
    "metal_flash_attention_tpu_torch.utils.shapes",
    "metal_flash_attention_tpu_torch.utils.tolerances",
    "metal_flash_attention_tpu_torch.utils.tree",
]


def _run(code, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or "
            "m == 'metal_flash_attention_tpu' or "
            "m.startswith('metal_flash_attention_tpu.') or "
            "m == 'transformers' or m.startswith('transformers.'))\n"
            "assert not bad, bad\n"
            "from metal_flash_attention_tpu_torch.ops import "
            "paged_attention, flash_attention, flash_attention_bwd, "
            "flash_decode, softmax\n"
            "gemm = importlib.import_module("
            "'metal_flash_attention_tpu_torch.ops.gemm')\n"
            "for m in (paged_attention, flash_attention, "
            "flash_attention_bwd, flash_decode, gemm, softmax):\n"
            "    assert m._kernel_library.cache_info().currsize == 0\n"
            "import chip_smoke\n"
            "sys.path.insert(0, 'tools')\n"
            "import tp_probe\n"
            "assert 'jax' not in sys.modules\n"
            "assert 'transformers' not in sys.modules\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def test_public_names_cover_the_jax_packages():
    """Every name of the JAX package's ``__all__`` is in the port's and
    resolves there (the docs write ``mfa.AttentionDescriptor``,
    ``mfa.OperandPrecision``, ``mfa.dot_product_attention``), from the
    port's own modules."""
    import metal_flash_attention_tpu as jmfa

    import metal_flash_attention_tpu_torch as mfa

    missing = sorted(set(jmfa.__all__) - set(mfa.__all__))
    assert not missing, missing
    for name in mfa.__all__:
        value = getattr(mfa, name)
        module = getattr(value, "__module__", None)
        assert module is None or not module.startswith(
            "metal_flash_attention_tpu."), (name, module)
    assert mfa.OperandPrecision("int8").value == "int8"
    desc = mfa.AttentionDescriptor(batch=1, q_heads=2, kv_heads=1, q_len=8,
                                   kv_len=8, head_dim=32)
    assert desc.head_dim == 32


def test_page_allocator_library_is_the_ports_own():
    """The C++ allocator builds from the port's own sources into the
    port's `build/`, under the port's library name, never at the JAX
    package's `libmfa_tpu.so`, and loads without the JAX package."""
    jax_lib = os.path.join(REPO, "metal_flash_attention_tpu", "native",
                           "libmfa_tpu.so")
    code = ("import sys\n"
            "from metal_flash_attention_tpu_torch.native.page_allocator "
            "import NativePageAllocator, make_page_allocator\n"
            "a = make_page_allocator(4, 2)\n"
            "assert type(a) is NativePageAllocator, type(a)\n"
            "print(a._lib._name)\n"
            "assert not any(m.startswith('metal_flash_attention_tpu.') "
            "for m in sys.modules)\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    from metal_flash_attention_tpu_torch.native import build
    path = proc.stdout.strip()
    assert path == build.NATIVE_LIB and os.path.exists(path)
    assert os.path.dirname(path) == build.BUILD_DIR
    assert os.path.basename(path) == "libmfa_native.so"
    assert os.path.realpath(path) != os.path.realpath(jax_lib)
    assert build.NATIVE_SRC_DIR == os.path.join(
        REPO, "metal_flash_attention_tpu_torch", "native", "src")
    assert sorted(os.listdir(build.NATIVE_SRC_DIR)) == [
        "config_store.cpp", "mfa_error.hpp", "mfa_hash.hpp",
        "page_allocator.cpp"]


def test_build_without_nvcc_raises():
    """With no CUDA toolkit on PATH the kernel build raises a clear
    error instead of returning anything."""
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has the CUDA toolkit")
    env = dict(os.environ, PATH=os.path.dirname(sys.executable))
    code = ("from metal_flash_attention_tpu_torch.native import build\n"
            "try:\n"
            "    build.load_library('paged_attention')\n"
            "except RuntimeError as e:\n"
            "    assert 'nvcc' in str(e), e\n"
            "else:\n"
            "    raise SystemExit('built without nvcc')\n")
    proc = _run(code, env=env)
    assert proc.returncode == 0, proc.stderr


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor on neither the CPU nor a CUDA card is refused rather
    than computed by the plain version."""
    code = ("import torch\n"
            "from metal_flash_attention_tpu_torch.ops import "
            "paged_attention as pa\n"
            "c = pa.init_paged_cache(num_pages=4, kv_heads=1, page_size=8,"
            " head_dim=64, batch=1, max_pages=2, device='meta')\n"
            "try:\n"
            "    pa.paged_decode(torch.zeros((1, 2, 64), device='meta',"
            " dtype=torch.bfloat16), c)\n"
            "except ValueError as e:\n"
            "    assert 'meta' in str(e), e\n"
            "else:\n"
            "    raise SystemExit('ran on meta')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


def _ok_line(stdout):
    lines = stdout.strip().splitlines()
    return bool(lines) and '"ok": true' in lines[-1]


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not _ok_line(proc.stdout)


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    """Alone in a directory, without the package, the script fails."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not _ok_line(proc.stdout)


def _constructors():
    """Each constructor of the port, called without ``device``."""
    cfg = llama.LlamaConfig.tiny(n_layers=1)
    return {
        "init_params": lambda: llama.init_params(cfg, None)["lm_head"],
        "params_from_numpy": lambda: params.params_from_numpy(
            {"w": np.zeros((2, 2), np.float32)})["w"],
        "pools_from_numpy": lambda: params.pools_from_numpy(
            [np.zeros((1, 1, 4, 128), np.float32)], head_dim=32)[0],
        "init_paged_cache": lambda: paged_attention.init_paged_cache(
            num_pages=2, kv_heads=1, page_size=4, head_dim=32, batch=1,
            max_pages=1).k_pages,
        "init_paged_model_cache": lambda: serving.init_paged_model_cache(
            cfg, 1, 8, page_size=4).k[0],
        "init_cache": lambda: serving.init_cache(cfg, 1, 8).k[0],
        "cache_from_numpy": lambda: params.cache_from_numpy(
            serving.KVCache(k=[np.zeros((1, 1, 4, 32), np.float32)],
                            v=[np.zeros((1, 1, 4, 32), np.float32)],
                            lengths=np.zeros((1,), np.int32))).k[0],
        "init_lora_adapters": lambda: lora.init_lora_adapters(
            cfg, 2, 4, generator=None)["layers"][0]["wq"][0],
        "params_from_hf_llama": lambda: convert.params_from_hf_llama(
            {"embed_tokens.weight": torch.zeros((3, 2)),
             "norm.weight": torch.ones(2)},
            dataclasses.replace(cfg, n_layers=0))["lm_head"],
        "TokenLoader": lambda: next(iter(data.TokenLoader(
            [_shard()], batch=1, seq_len=4))),
    }


def _shard() -> str:
    path = os.path.join(tempfile.mkdtemp(), "shard.bin")
    data.write_shard(path, np.arange(8, dtype=np.int32))
    return path


def test_default_device_is_the_card(monkeypatch):
    """``device=None`` resolves to CUDA; without a card it raises and
    never falls back to CPU tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve_device()
    assert device.resolve_device("cpu") == torch.device("cpu")
    for name, make in _constructors().items():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.resolve_device() == torch.device("cuda")


def test_constructors_put_tensors_where_the_default_resolves(monkeypatch):
    """Every constructor resolves ``device=None`` through the one helper
    and builds its tensors there (here the helper's answer, CUDA, is
    recorded and swapped for the meta device: this machine may have no
    card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    seen = []

    def spy(dev=None):
        seen.append(device.resolve_device(dev))
        return torch.device("meta")
    for module in (llama, params, paged_attention, serving, lora, convert,
                   data):
        monkeypatch.setattr(module, "resolve_device", spy)
    for name, make in _constructors().items():
        seen.clear()
        assert make().device.type == "meta", name
        assert seen and all(d == torch.device("cuda") for d in seen), name


@pytest.mark.parametrize("source,names", [
    ("flash_attention.cu", ("MFA_FWD90_BLOCK_Q", "MFA_FWD90_BLOCK_KV",
                            "MFA_FWD90_STAGES", "MFA_FWD90_RAW_STAGES")),
    ("flash_attention_bwd.cu", ("MFA_BWD90_DQ_BLOCK_Q",
                                "MFA_BWD90_DQ_BLOCK_KV",
                                "MFA_BWD90_DKV_BLOCK_Q",
                                "MFA_BWD90_DKV_BLOCK_KV",
                                "MFA_BWD90_STAGES",
                                "MFA_BWD90_D256_DQ_BLOCK_Q",
                                "MFA_BWD90_D256_DQ_BLOCK_KV",
                                "MFA_BWD90_D256_DKV_BLOCK_Q",
                                "MFA_BWD90_D256_DKV_BLOCK_KV",
                                "MFA_BWD90_D256_STAGES")),
    ("paged_attention.cu", ("MFA_PAGED_BLOCK_Q", "MFA_PAGED_BLOCK_KV",
                            "MFA_PAGED_STAGES", "MFA_DECODE_BLOCK_KV",
                            "MFA_DECODE_STAGES")),
    ("flash_decode.cu", ("MFA_DECODE_BLOCK_KV", "MFA_DECODE_MAX_GROUP",
                         "MFA_DECODE_STAGES", "MFA_DECODE_MMA")),
    ("flash_attention_f32.cu", ("MFA_F32_BLOCK_Q", "MFA_F32_BLOCK_KV",
                                "MFA_F32_D256_FWD_BLOCK_KV",
                                "MFA_F32_D256_DQ_BLOCK_KV",
                                "MFA_F32_DKV_BLOCK_KV",
                                "MFA_F32_D256_DKV_BLOCK_KV",
                                "MFA_F32_DKV_BLOCK_Q", "MFA_F32_STAGES")),
    ("gemm.cu", ("MFA_GEMM_BLOCK_M", "MFA_GEMM_BLOCK_N", "MFA_GEMM_BLOCK_K")),
    ("gemm.cu", ("MFA_GEMM90_BLOCK_M", "MFA_GEMM90_BLOCK_N",
                 "MFA_GEMM90_QUANT_BLOCK_M", "MFA_GEMM90_QUANT_BLOCK_N",
                 "MFA_GEMM90_BLOCK_N_DECODE", "MFA_GEMM90_BLOCK_K",
                 "MFA_GEMM90_STAGES")),
])
def test_kernels_and_wrappers_share_the_tiles_header(source, names):
    """Each kernel takes its tiles from csrc/flash_tiles.cuh, the header
    its wrapper reads (directly, or through a shared header of csrc/ that
    it includes), and keeps no copy of its own."""
    import re

    from metal_flash_attention_tpu_torch.native import build

    text, todo, seen = "", [source], set()
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        with open(os.path.join(build.SRC_DIR, name)) as f:
            body = f.read()
        text += body
        todo += [h for h in re.findall(r'#include "(\w+\.cuh)"', body)
                 if os.path.exists(os.path.join(build.SRC_DIR, h))]
    assert '#include "flash_tiles.cuh"' in text
    defines = build.tile_defines()
    for name in names:
        assert name in text and defines[name] > 0


def test_decode_splits_fill_the_card_without_empty_splits():
    """Fixed chunks of whole tiles, up to the largest chunk, small enough
    for two waves of blocks over the SMs when every row is full; as many
    splits as cover the longest row, and none that a full row leaves
    empty."""
    from metal_flash_attention_tpu_torch.native import build

    tiles = build.tile_defines()
    tile, most = tiles["MFA_DECODE_BLOCK_KV"], tiles["MFA_DECODE_CHUNK"]
    # The dense generate shape: 8 x 8 (sequence, kv head) pairs on 132
    # SMs take chunks of the largest size, 8 of them over 8,192 keys.
    assert paged_attention.decode_splits(64, 8192, 132, tile, most) == (
        most, 8192 // most)
    # One sequence: small chunks, many of them, at least two waves.
    chunk, splits = paged_attention.decode_splits(8, 8192, 132, tile, most)
    assert chunk % tile == 0 and 8 * splits >= 2 * 132
    assert (splits - 1) * chunk < 8192 <= splits * chunk
    # Few keys: one tile a chunk, no split without a key.
    assert paged_attention.decode_splits(8, tile + 1, 132, tile, most) == (
        tile, 2)
    assert paged_attention.decode_splits(8, 0, 132, tile, most) == (tile, 1)
    # A batch that fills the card still takes chunks of at most `most`.
    assert paged_attention.decode_splits(512, 8192, 132, tile, most) == (
        most, 8192 // most)
    # The prefill's rule, at most two waves: the engine's chunk (8 row
    # tiles x 8 kv heads) against 1,024 keys takes 4 splits of 256 keys.
    assert paged_attention.decode_splits(64, 1024, 132, 64, 512,
                                         at_most=True) == (256, 4)
    assert paged_attention.decode_splits(512, 1024, 132, 64, 512,
                                         at_most=True) == (512, 2)


def test_a_library_is_stale_when_a_shared_header_is_newer(tmp_path,
                                                          monkeypatch):
    from metal_flash_attention_tpu_torch.native import build

    src, out = tmp_path / "csrc", tmp_path / "build"
    src.mkdir()
    out.mkdir()
    monkeypatch.setattr(build, "SRC_DIR", str(src))
    monkeypatch.setattr(build, "BUILD_DIR", str(out))
    (src / "k.cu").write_text("")
    (src / "common.cuh").write_text("")
    assert build._stale("k")                  # never built
    lib = out / "libk.so"
    lib.write_text("")
    for f, t in ((src / "k.cu", 100), (src / "common.cuh", 100), (lib, 200)):
        os.utime(f, (t, t))
    assert not build._stale("k")
    os.utime(src / "common.cuh", (300, 300))
    assert build._stale("k")                  # a header changed
    os.utime(src / "common.cuh", (100, 100))
    os.utime(src / "k.cu", (300, 300))
    assert build._stale("k")                  # the source changed


def test_gemm_descriptor_reads_the_kernel_tiles_from_the_header():
    """`GEMMDescriptor.kernel_config` returns the tile that gemm.cu takes
    from csrc/flash_tiles.cuh, whatever the problem."""
    from metal_flash_attention_tpu_torch.descriptors.gemm_descriptor import (
        GEMMDescriptor,
    )
    from metal_flash_attention_tpu_torch.native import build

    defines = build.tile_defines()
    for m, n, k in ((8, 14336, 4096), (8192, 4096, 14336), (7, 5, 3)):
        cfg = GEMMDescriptor(m=m, n=n, k=k).kernel_config()
        assert (cfg.block_m, cfg.block_n, cfg.block_k) == (
            defines["MFA_GEMM_BLOCK_M"], defines["MFA_GEMM_BLOCK_N"],
            defines["MFA_GEMM_BLOCK_K"])


def test_quant_helpers_header_is_shared():
    """The dequantization helpers live once, in csrc/quant_common.cuh,
    with the same NF4 codebook as ops/quantization.py."""
    import re

    from metal_flash_attention_tpu_torch.native import build
    from metal_flash_attention_tpu_torch.ops.quantization import NF4_CODEBOOK

    with open(os.path.join(build.SRC_DIR, "quant_common.cuh")) as f:
        header = f.read()
    for source in ("gemm.cu", "flash_attention.cu", "decode_common.cuh"):
        with open(os.path.join(build.SRC_DIR, source)) as f:
            assert '#include "quant_common.cuh"' in f.read(), source
    table = header[header.index("kNf4Codebook[16]"):]
    values = [float(v) for v in re.findall(r"(-?\d+\.\d+)f", table)[:16]]
    assert np.allclose(values, NF4_CODEBOOK, rtol=0, atol=0)
