"""Host-side page allocators for the paged KV pools.

The port of the JAX package's `native/page_allocator.py`: a fixed pool of
pages, handed to sequences by `reserve` and returned by `release`, with a
reference count a page.  Page 0 is the null page and is never handed out,
so table rows that point at it absorb the writes of batch slots that are
not live.

- `reserve(seq, num_tokens)` grows a sequence; each new page starts at
  refcount 1 (its sequence's).
- `release(seq)` drops the sequence's ref on each of its pages; a page
  returns to the free list when its count reaches 0.
- `retain(pages)` / `release_pages(pages)` add and drop one ref a page
  (a prefix-cache pin, a request borrowing a cached prefix); both raise
  PagerError, changing nothing, on a free or out-of-range page.

Two allocators with those semantics: `NativePageAllocator`, a ctypes
binding of the port's C++ allocator (`native/src/page_allocator.cpp`,
built with g++ at first use into `build/libmfa_native.so`), and
`PythonPageAllocator` (`PageAllocator` is its other name).
`make_page_allocator` takes the native one where it builds and loads, the
Python one otherwise, as the JAX package's does.  Both hand out the same
page ids for the same calls.
"""

from __future__ import annotations

import ctypes
import threading

MFA_NATIVE_OK = 0


class PagerError(RuntimeError):
    pass


class NativePageAllocator:
    """Thread-safe page allocator over ``num_pages`` pages of
    ``page_size`` tokens, in C++ (`native/src/page_allocator.cpp`)."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        from metal_flash_attention_tpu_torch.native.build import (
            build_native,
        )

        lib = ctypes.CDLL(build_native())
        u32, u64 = ctypes.c_uint32, ctypes.c_uint64
        pu32 = ctypes.POINTER(u32)
        lib.mfa_native_last_error.restype = ctypes.c_char_p
        lib.mfa_native_pager_create.argtypes = [u32, u32]
        lib.mfa_native_pager_create.restype = u64
        lib.mfa_native_pager_destroy.argtypes = [u64]
        lib.mfa_native_pager_reserve.argtypes = [u64, u64, u32, pu32, u32,
                                                 pu32]
        lib.mfa_native_pager_release.argtypes = [u64, u64]
        lib.mfa_native_pager_pages.argtypes = [u64, u64, pu32, u32, pu32]
        lib.mfa_native_pager_free_count.argtypes = [u64]
        lib.mfa_native_pager_free_count.restype = u32
        lib.mfa_native_pager_retain_pages.argtypes = [u64, pu32, u32]
        lib.mfa_native_pager_release_pages.argtypes = [u64, pu32, u32]
        lib.mfa_native_pager_refcount.argtypes = [u64, u32]
        lib.mfa_native_pager_refcount.restype = u32
        self._lib = lib
        self._id = lib.mfa_native_pager_create(num_pages, page_size)
        if self._id == 0:
            raise PagerError(self._err())
        self.num_pages = num_pages
        self.page_size = page_size

    def _err(self) -> str:
        return self._lib.mfa_native_last_error().decode(errors="replace")

    def _check(self, rc: int) -> None:
        if rc != MFA_NATIVE_OK:
            raise PagerError(self._err())

    def reserve(self, seq: int, num_tokens: int) -> list[int]:
        """Grow ``seq`` to cover ``num_tokens``; returns the NEW page ids.
        Raises PagerError, changing nothing, when the pool is short."""
        cap = num_tokens // self.page_size + 2
        out = (ctypes.c_uint32 * cap)()
        n = ctypes.c_uint32()
        self._check(self._lib.mfa_native_pager_reserve(
            self._id, seq, num_tokens, out, cap, ctypes.byref(n)))
        return list(out[:n.value])

    def release(self, seq: int) -> None:
        """Drop ``seq``'s ref on each of its pages (an unknown ``seq``: no
        change)."""
        self._lib.mfa_native_pager_release(self._id, seq)

    def pages(self, seq: int) -> list[int]:
        out = (ctypes.c_uint32 * self.num_pages)()
        n = ctypes.c_uint32()
        self._check(self._lib.mfa_native_pager_pages(
            self._id, seq, out, self.num_pages, ctypes.byref(n)))
        return list(out[:n.value])

    def _pages_call(self, fn, pages) -> None:
        arr = (ctypes.c_uint32 * len(pages))(*(int(p) for p in pages))
        self._check(fn(self._id, arr, len(pages)))

    def retain(self, pages) -> None:
        """Add one ref to each page; every page must be live."""
        self._pages_call(self._lib.mfa_native_pager_retain_pages, pages)

    def release_pages(self, pages) -> None:
        """Drop one ref from each page; a page at 0 returns to the pool."""
        self._pages_call(self._lib.mfa_native_pager_release_pages, pages)

    def refcount(self, page: int) -> int:
        return int(self._lib.mfa_native_pager_refcount(self._id, page))

    @property
    def free_pages(self) -> int:
        return int(self._lib.mfa_native_pager_free_count(self._id))

    def __del__(self):
        if getattr(self, "_id", 0):
            self._lib.mfa_native_pager_destroy(self._id)


class PythonPageAllocator:
    """Thread-safe allocator over ``num_pages`` pages of ``page_size``
    tokens, in Python, with the native allocator's semantics."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2 or page_size <= 0:
            raise PagerError("pager needs >= 2 pages, positive size")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(1, num_pages))
        self._seqs: dict[int, list[int]] = {}
        self._rc = [0] * num_pages
        self._lock = threading.Lock()

    def reserve(self, seq: int, num_tokens: int) -> list[int]:
        """Grow ``seq`` to cover ``num_tokens``; returns the NEW page ids.
        Raises PagerError, changing nothing, when the pool is short."""
        need = -(-num_tokens // self.page_size)
        with self._lock:
            pages = self._seqs.setdefault(seq, [])
            grow = need - len(pages)
            if grow <= 0:
                return []
            if grow > len(self._free):
                raise PagerError(
                    f"pool exhausted: need {grow}, {len(self._free)} free")
            new = [self._free.pop() for _ in range(grow)]
            for pg in new:
                self._rc[pg] = 1
            pages.extend(new)
            return new

    def release(self, seq: int) -> None:
        """Drop ``seq``'s ref on each of its pages (an unknown ``seq``: no
        change)."""
        with self._lock:
            for pg in self._seqs.pop(seq, []):
                self._rc[pg] -= 1
                if self._rc[pg] == 0:
                    self._free.append(pg)

    def _check_live(self, pages, what: str) -> None:
        for pg in pages:
            if not (1 <= pg < self.num_pages) or self._rc[pg] == 0:
                raise PagerError(f"{what} page {pg}")

    def retain(self, pages) -> None:
        """Add one ref to each page; every page must be live."""
        with self._lock:
            self._check_live(pages, "retain of free")
            for pg in pages:
                self._rc[pg] += 1

    def release_pages(self, pages) -> None:
        """Drop one ref from each page; a page at 0 returns to the pool."""
        with self._lock:
            self._check_live(pages, "double free of")
            for pg in pages:
                self._rc[pg] -= 1
                if self._rc[pg] == 0:
                    self._free.append(pg)

    def refcount(self, page: int) -> int:
        with self._lock:
            return self._rc[page] if 0 <= page < self.num_pages else 0

    def pages(self, seq: int) -> list[int]:
        with self._lock:
            return list(self._seqs.get(seq, []))

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)


# The name the engine and the tests used before the native allocator.
PageAllocator = PythonPageAllocator


def make_page_allocator(num_pages: int, page_size: int):
    """The native allocator where it builds and loads, the Python one
    otherwise."""
    try:
        return NativePageAllocator(num_pages, page_size)
    except Exception:
        return PythonPageAllocator(num_pages, page_size)
