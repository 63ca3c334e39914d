"""ctypes binding of the port's native config store.

The port of the JAX package's `native/config_store.py`: the Python face
of `native/src/config_store.cpp` (a copy of the JAX package's C++ under
the port's `mfa_native_*` names), built with the page allocator into
`build/libmfa_native.so` by `native.build.build_native`.  The store maps
the hash of a canonical key string to a tile (two positive integers), is
shared by every thread of the process (lock-free readers, insert-only),
and saves to and loads from a flat binary table.
"""

from __future__ import annotations

import ctypes
from typing import Optional

from metal_flash_attention_tpu_torch.native.build import build_native

MFA_NATIVE_OK = 0
MFA_NATIVE_ERR_PRECONDITION = 1
MFA_NATIVE_ERR_NOT_FOUND = 2
MFA_NATIVE_ERR_IO = 3


class NativeError(RuntimeError):
    pass


def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_native())
    u32, u64, p_u32 = (ctypes.c_uint32, ctypes.c_uint64,
                       ctypes.POINTER(ctypes.c_uint32))
    lib.mfa_native_last_error.restype = ctypes.c_char_p
    lib.mfa_native_store_insert.argtypes = [ctypes.c_char_p, u32, u32, u32]
    lib.mfa_native_store_insert.restype = ctypes.c_int
    lib.mfa_native_store_lookup.argtypes = [ctypes.c_char_p, u32, p_u32,
                                            p_u32]
    lib.mfa_native_store_lookup.restype = ctypes.c_int
    lib.mfa_native_store_size.restype = u32
    lib.mfa_native_store_save.argtypes = [ctypes.c_char_p]
    lib.mfa_native_store_save.restype = ctypes.c_int
    lib.mfa_native_store_load.argtypes = [ctypes.c_char_p]
    lib.mfa_native_store_load.restype = ctypes.c_int
    lib.mfa_native_hash_bytes.argtypes = [ctypes.c_char_p, u32]
    lib.mfa_native_hash_bytes.restype = u64
    lib.mfa_native_combine64.argtypes = [u64, u64]
    lib.mfa_native_combine64.restype = u64
    return lib


class ConfigStore:
    """Process-wide native store (lock-free readers, insert-only)."""

    _instance: "ConfigStore | None" = None

    def __init__(self) -> None:
        self._lib = _load()

    @classmethod
    def get(cls) -> "ConfigStore":
        if cls._instance is None:
            cls._instance = cls()
        return cls._instance

    def _err(self) -> str:
        return self._lib.mfa_native_last_error().decode(errors="replace")

    def insert(self, key: str, blocks: tuple[int, int]) -> None:
        kb = key.encode()
        rc = self._lib.mfa_native_store_insert(
            kb, len(kb), int(blocks[0]), int(blocks[1]))
        if rc != MFA_NATIVE_OK:
            raise NativeError(self._err())

    def lookup(self, key: str) -> Optional[tuple[int, int]]:
        kb = key.encode()
        first, second = ctypes.c_uint32(), ctypes.c_uint32()
        rc = self._lib.mfa_native_store_lookup(
            kb, len(kb), ctypes.byref(first), ctypes.byref(second))
        if rc == MFA_NATIVE_ERR_NOT_FOUND:
            return None
        if rc != MFA_NATIVE_OK:
            raise NativeError(self._err())
        return (first.value, second.value)

    def __len__(self) -> int:
        return int(self._lib.mfa_native_store_size())

    def save(self, path: str) -> None:
        rc = self._lib.mfa_native_store_save(path.encode())
        if rc != MFA_NATIVE_OK:
            raise NativeError(self._err())

    def load(self, path: str) -> None:
        rc = self._lib.mfa_native_store_load(path.encode())
        if rc != MFA_NATIVE_OK:
            raise NativeError(self._err())

    # Self-test hooks of the hash pipeline.
    def hash_bytes(self, data: bytes) -> int:
        return int(self._lib.mfa_native_hash_bytes(data, len(data)))

    def combine64(self, seed: int, v: int) -> int:
        return int(self._lib.mfa_native_combine64(seed, v))
