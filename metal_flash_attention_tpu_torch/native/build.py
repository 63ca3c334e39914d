"""Build driver for the port's CUDA kernels and its native host library.

Each `csrc/<name>.cu` compiles at first use, with nvcc for Hopper
(`-gencode arch=compute_90a,code=sm_90a`), into its own shared library
`build/lib<name>.so` inside the package, and is bound with ctypes (plain
C interface, no PyTorch headers: a build takes seconds).  A library is
rebuilt when its source, or a header it may include
(`csrc/*.cuh`), is newer.  `build_all` starts one nvcc per
source, all together.  The compiler's report (`-Xptxas -v`: registers,
shared memory, spills) is kept beside each library as `lib<name>.log`.

A tile variant is a library built with `-D` values over
`csrc/flash_tiles.cuh`'s (``defines``): it goes to
`build/variants/<name>-<short hash of the sorted defines>/lib<name>.so`,
beside its report, under the same staleness rule; the launchers size
their grids and shared memory from those macros, so a variant carries its
own geometry.  `build_variants` builds any set of them together, and
`compile_sources` is the one nvcc driver (also for `tools/`' patched
sources).

The host library `build/libmfa_native.so` (the C++ page allocator and
config store, `native/src/*.cpp`) builds with g++ at first use, on any
machine with a C++ compiler (`build_native`).  Every build writes to a
file named for its process and moves it into place with `os.replace`, so
processes that build at once (test workers) never load a half-written
library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
TILES_HEADER = os.path.join(SRC_DIR, "flash_tiles.cuh")
VARIANTS_DIR = os.path.join(BUILD_DIR, "variants")
NATIVE_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "src")
NATIVE_LIB = os.path.join(BUILD_DIR, "libmfa_native.so")
GXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wextra"]
GXX_TIMEOUT_S = 120
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


def _define_items(defines) -> tuple:
    """A variant's -D defines (a dict or (name, value) pairs) as sorted
    (name, int) pairs."""
    return tuple(sorted((k, int(v)) for k, v in dict(defines or {}).items()))


def variant_tag(name: str, defines=None) -> str:
    """``<name>-<short hash of the sorted defines>``: a variant's folder
    under build/variants/."""
    text = ";".join(f"{k}={v}" for k, v in _define_items(defines))
    return f"{name}-{hashlib.sha1(text.encode()).hexdigest()[:10]}"


def library_path(name: str, defines=None) -> str:
    """build/lib<name>.so, or with tile ``defines`` (``{"MFA_...": int}``,
    values over `csrc/flash_tiles.cuh`'s) the variant's
    build/variants/<variant_tag>/lib<name>.so."""
    if not _define_items(defines):
        return os.path.join(BUILD_DIR, f"lib{name}.so")
    return os.path.join(VARIANTS_DIR, variant_tag(name, defines),
                        f"lib{name}.so")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _stale(name: str, defines=None) -> bool:
    """A library is stale when its source or any shared header under
    csrc/ is newer than it."""
    lib = library_path(name, defines)
    if not os.path.exists(lib):
        return True
    deps = [os.path.join(SRC_DIR, f"{name}.cu")] + [
        os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
        if f.endswith(".cuh")]
    built = os.path.getmtime(lib)
    return any(os.path.getmtime(d) > built for d in deps)


def compile_sources(jobs: dict) -> dict:
    """Run nvcc for every job at once, one process each: ``jobs`` maps a
    key to (source path, library path, extra flags such as -D defines).
    Each library is written to a file named for the process and moved
    into place with `os.replace`; the compiler's report goes beside it
    (lib<name>.log).  Returns {key: report}; raises RuntimeError naming
    every job that failed."""
    nvcc = _nvcc()
    procs = {}
    for key, (src, lib, flags) in jobs.items():
        os.makedirs(os.path.dirname(lib), exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-I", SRC_DIR, "-o", tmp, src]
        procs[key] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    logs, failed = {}, []
    for key, (lib, tmp, proc) in procs.items():
        try:
            log, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            log, _ = proc.communicate()
            log += f"\nnvcc timed out after {NVCC_TIMEOUT_S} s"
        with open(lib[:-3] + ".log", "w") as f:
            f.write(log)
        logs[key] = log
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(f"{key}:\n{log}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return logs


def build_variants(variants) -> dict:
    """Compile every stale library of ``variants``, each a (name,
    defines) pair (defines None or {} for the plain library), one nvcc
    each, all started together.  Returns {(name, sorted define pairs):
    library path}; raises RuntimeError on any failure."""
    wanted = {(name, _define_items(defines)): library_path(name, defines)
              for name, defines in variants}
    with _LOCK:
        todo = {key: (os.path.join(SRC_DIR, f"{key[0]}.cu"), path,
                      [f"-D{k}={v}" for k, v in key[1]])
                for key, path in wanted.items() if _stale(*key)}
        if todo:
            compile_sources(todo)
    return wanted


def build_all(names=None, defines=None) -> dict[str, str]:
    """Compile every stale source of ``names`` (all of csrc/ by default),
    with the tile ``defines`` if given, one nvcc each, all started
    together.  Returns {name: library path}; raises RuntimeError on any
    failure."""
    names = sources() if names is None else list(names)
    built = build_variants((n, defines) for n in names)
    return {name: path for (name, _), path in built.items()}


def load_library(name: str, defines=None) -> ctypes.CDLL:
    """Build csrc/<name>.cu (the variant of ``defines``) if stale and
    load it."""
    return ctypes.CDLL(build_all([name], defines)[name])


def build_native() -> str:
    """Build `build/libmfa_native.so` from `native/src/` with g++ when it
    is missing or older than a source or header; returns its path.
    Raises RuntimeError when there is no compiler or the build fails."""
    sources = sorted(os.path.join(NATIVE_SRC_DIR, f)
                     for f in os.listdir(NATIVE_SRC_DIR)
                     if f.endswith(".cpp"))
    deps = sources + [os.path.join(NATIVE_SRC_DIR, f)
                      for f in os.listdir(NATIVE_SRC_DIR)
                      if f.endswith(".hpp")]
    with _LOCK:
        if os.path.exists(NATIVE_LIB) and all(
                os.path.getmtime(d) <= os.path.getmtime(NATIVE_LIB)
                for d in deps):
            return NATIVE_LIB
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{NATIVE_LIB}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, *sources],
                                  capture_output=True, text=True,
                                  timeout=GXX_TIMEOUT_S)
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native build unavailable: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"native build failed:\n{proc.stderr}")
        os.replace(tmp, NATIVE_LIB)
    return NATIVE_LIB
