"""The port stands apart from JAX, and its CUDA-only paths refuse to run
on a machine without a card instead of quietly running on the CPU.

Each check runs in a fresh interpreter, so that JAX, imported by the
other test files, is not already in `sys.modules`."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MODULES = [
    "metal_flash_attention_tpu_torch",
    "metal_flash_attention_tpu_torch.models.engine",
    "metal_flash_attention_tpu_torch.models.llama",
    "metal_flash_attention_tpu_torch.models.serving",
    "metal_flash_attention_tpu_torch.native.build",
    "metal_flash_attention_tpu_torch.native.page_allocator",
    "metal_flash_attention_tpu_torch.ops.paged_attention",
    "metal_flash_attention_tpu_torch.ops.reference",
    "metal_flash_attention_tpu_torch.utils.params",
    "metal_flash_attention_tpu_torch.utils.shapes",
    "metal_flash_attention_tpu_torch.utils.tolerances",
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
            "m.startswith('metal_flash_attention_tpu.'))\n"
            "assert not bad, bad\n"
            "import metal_flash_attention_tpu_torch.ops.paged_attention "
            "as pa\n"
            "assert pa._kernel_library.cache_info().currsize == 0\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr


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
