"""Two-level kernel-config cache.

The port of the JAX package's `runtime/cache.py`.  The compiled kernels
are libraries (`native.build`: one a source, and one a tile variant), so
what this cache holds is the level above them:

- **config level**: problem key -> measured tile (an autotune winner);
  the H100 table's rows (`descriptors.parameters`) serve a miss;
- **persistent level**: winners survive the process in a JSON store, by
  default `~/.cache/mfa_torch/autotune.json` (the directory
  `MFA_TORCH_CACHE_DIR` names, if set), and, for the default store, in
  the process-wide C++ table of `native.config_store` (lock-free readers
  shared by every thread).

An instance built on an explicit path is private: it uses no native
level, so that a test's or an embedder's cache never sees the user's
winners (nor they its).  The keys are JAX's strings for the same
problem, the dtype named as torch names it ("bfloat16", "float32").
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import torch

from metal_flash_attention_tpu_torch.runtime.context import (
    default_generation,
)


def _default_store_path() -> str:
    base = os.environ.get("MFA_TORCH_CACHE_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "mfa_torch")
    return os.path.join(base, "autotune.json")


def dtype_name(dtype) -> str:
    """"bfloat16" for torch.bfloat16 (also for the string)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


class KernelConfigCache:
    """Process-wide config cache with a native (C++) level for the default
    store.  Keys are canonical strings built from the problem."""

    _instance: "KernelConfigCache | None" = None

    def __init__(self, store_path: Optional[str] = None) -> None:
        self._lock = threading.Lock()
        self._configs: dict[str, tuple[int, int]] = {}
        # Bumped by every insert: resolved tiles are kept per version.
        self.version = 0
        self._store_path = store_path or _default_store_path()
        self._native = None
        if store_path is None:
            try:
                from metal_flash_attention_tpu_torch.native import (
                    config_store,
                )
                self._native = config_store.ConfigStore.get()
            except Exception:
                self._native = None
        self._load()

    @property
    def store_path(self) -> str:
        return self._store_path

    @classmethod
    def get(cls) -> "KernelConfigCache":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    @classmethod
    def reset(cls) -> None:
        cls._instance = None

    # ---- canonical keys ------------------------------------------------

    @staticmethod
    def attention_key(kernel_type: str, head_dim: int, dtype,
                      *, q_len_bucket: int = 0,
                      generation: Optional[str] = None) -> str:
        """The problem's key; the sequence length comes bucketed."""
        gen = generation or default_generation()
        return (f"attn|{kernel_type}|d{head_dim}|{dtype_name(dtype)}"
                f"|n{q_len_bucket}|{gen}")

    @staticmethod
    def gemm_key(m_bucket: int, n_bucket: int, k_bucket: int, dtype,
                 transpose_a: bool, transpose_b: bool,
                 *, generation: Optional[str] = None) -> str:
        gen = generation or default_generation()
        return (f"gemm|m{m_bucket}|n{n_bucket}|k{k_bucket}"
                f"|{dtype_name(dtype)}|ta{int(transpose_a)}"
                f"|tb{int(transpose_b)}|{gen}")

    # ---- lookup / insert -------------------------------------------------

    def lookup(self, key: str) -> Optional[tuple[int, int]]:
        if self._native is not None:
            hit = self._native.lookup(key)
            if hit is not None:
                return hit
        with self._lock:
            return self._configs.get(key)

    def insert(self, key: str, blocks: tuple[int, int],
               *, persist: bool = True) -> None:
        if self._native is not None:
            self._native.insert(key, blocks)
        with self._lock:
            self._configs[key] = tuple(int(b) for b in blocks)
            self.version += 1
        if persist:
            self.save()

    def __len__(self) -> int:
        with self._lock:
            return len(self._configs)

    # ---- persistence -----------------------------------------------------

    def _load(self) -> None:
        try:
            with open(self._store_path) as f:
                data = json.load(f)
        except (OSError, ValueError):
            return
        with self._lock:
            self._configs.update({k: tuple(v) for k, v in data.items()})
        if self._native is not None:
            for k, v in data.items():
                self._native.insert(k, tuple(v))

    def save(self) -> None:
        """Write the store: to a file named for the process, then moved
        into place, so that processes saving at once never leave a torn
        file."""
        try:
            os.makedirs(os.path.dirname(self._store_path), exist_ok=True)
            with self._lock:
                payload = dict(self._configs)
            tmp = f"{self._store_path}.{os.getpid()}.tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=0, sort_keys=True)
            os.replace(tmp, self._store_path)
        except OSError:
            pass
