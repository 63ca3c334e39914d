"""Build driver for the port's CUDA kernels.

Each `csrc/<name>.cu` compiles at first use, with nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), into its own shared library
`build/lib<name>.so` inside the package, and is bound with ctypes (plain
C interface, no PyTorch headers: a build takes seconds).  A library is
rebuilt when its source, or a header it may include
(`csrc/*.cuh`), is newer.  `build_all` starts one nvcc per
source, all together.  The compiler's report (`-Xptxas -v`: registers,
shared memory, spills) is kept beside each library as `lib<name>.log`.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
TILES_HEADER = os.path.join(SRC_DIR, "flash_tiles.cuh")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
NVCC_TIMEOUT_S = 600
_LOCK = threading.Lock()


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(SRC_DIR) if f.endswith(".cu"))


@functools.cache
def tile_defines() -> dict[str, int]:
    """The kernels' tiles: every ``#define MFA_<NAME> <int>`` line of
    `csrc/flash_tiles.cuh`, which the kernels include.  Reading a text
    file needs no toolkit, so the wrappers use it on any machine."""
    with open(TILES_HEADER) as f:
        return {name: int(value) for name, value in re.findall(
            r"^#define (MFA_\w+) (\d+)", f.read(), re.MULTILINE)}


def library_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _stale(name: str) -> bool:
    """A library is stale when its source or any shared header under
    csrc/ is newer than it."""
    lib = library_path(name)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(SRC_DIR, f"{name}.cu")] + [
        os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
        if f.endswith(".cuh")]
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(d) > built for d in deps)


def build_all(names=None) -> dict[str, str]:
    """Compile every stale source, one nvcc each, all started together.
    Returns {name: library path}; raises RuntimeError on any failure."""
    names = sources() if names is None else list(names)
    with _LOCK:
        todo = [n for n in names if _stale(n)]
        if todo:
            nvcc = _nvcc()
            os.makedirs(BUILD_DIR, exist_ok=True)
            procs = {}
            for n in todo:
                tmp = library_path(n) + f".{os.getpid()}.tmp"
                cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                       os.path.join(SRC_DIR, f"{n}.cu")]
                procs[n] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for n, (tmp, proc) in procs.items():
                try:
                    log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    log, _ = proc.communicate()
                    log += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
                with open(os.path.join(BUILD_DIR, f"lib{n}.log"), "w") as f:
                    f.write(log)
                if proc.returncode == 0:
                    os.replace(tmp, library_path(n))
                else:
                    failed.append(f"{n}.cu:\n{log}")
            if failed:
                raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {n: library_path(n) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if stale and load it."""
    return ctypes.CDLL(build_all([name])[name])
