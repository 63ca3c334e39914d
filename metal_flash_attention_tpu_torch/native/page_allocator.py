"""Host-side page allocator for the paged KV pools.

The semantics of the JAX package's `PythonPageAllocator`
(`metal_flash_attention_tpu/native/page_allocator.py`) for what the
serving engine uses: a fixed pool of pages, handed to sequences by
`reserve` and returned by `release`.  Page 0 is the null page and is
never handed out, so table rows that point at it absorb the writes of
batch slots that are not live.  The shared-page refcounts
(`retain` / `release_pages`) come with the prefix cache, and binding
the C++ allocator (`native/src/page_allocator.cpp`) is a later item;
both are in ROADMAP.md.
"""

from __future__ import annotations

import threading


class PagerError(RuntimeError):
    pass


class PageAllocator:
    """Thread-safe allocator over ``num_pages`` pages of ``page_size``
    tokens."""

    def __init__(self, num_pages: int, page_size: int) -> None:
        if num_pages < 2 or page_size <= 0:
            raise PagerError("pager needs >= 2 pages, positive size")
        self.num_pages = num_pages
        self.page_size = page_size
        self._free = list(range(1, num_pages))
        self._seqs: dict[int, list[int]] = {}
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
            pages.extend(new)
            return new

    def release(self, seq: int) -> None:
        """Return every page of ``seq`` to the pool."""
        with self._lock:
            self._free.extend(self._seqs.pop(seq, []))

    @property
    def free_pages(self) -> int:
        with self._lock:
            return len(self._free)
