"""Page-granular automatic prefix caching for the paged serving engine.

The port of the JAX package's `models/prefix_cache.py` (host code, no
torch).  When a new request's prompt starts with token pages that an
earlier request already prefilled (a shared system prompt, few-shot
preambles, multi-turn history), the engine borrows those KV pages and
prefills only the unshared suffix.

- **Page-granular, chained keys.** An entry maps
  ``blake2b(parent_digest || page_tokens)`` to a KV page id, so a page's
  key depends on its whole prefix and a lookup is a walk: page k hits
  only if pages 0..k-1 hit.  Entries keep the page's tokens and compare
  them exactly, so a digest collision never serves wrong KV.  A chain
  starts from a ``root`` (empty by default); the engine with LoRA
  adapters roots each request's chain at its adapter, whose delta is in
  the K/V, so one adapter's pages never serve another's request.
- **Refcounted pages.** A cached page holds one reference in the page
  allocator (`native.page_allocator`, C++ where it builds); a borrowing
  request holds one more for its lifetime.  A page returns to the pool
  when its last owner drops it.
- **Read-only sharing.** Only complete prompt pages are cached, and a
  borrower's prefill starts at the page-aligned hit, so every KV write it
  makes lands in its own pages.
- **Leaves-first LRU eviction.** Only entries that no other entry chains
  from are evicted, oldest first, so no cached page is left unreachable
  while it pins a page.

`models.engine.ServingEngine(prefix_cache=True)` registers each retired
request's complete prompt pages.
"""

from __future__ import annotations

import hashlib
import heapq

import numpy as np


def _digest(parent: bytes, page_tokens: bytes) -> bytes:
    return hashlib.blake2b(parent + page_tokens, digest_size=16).digest()


class PrefixCache:
    """Maps chained prompt-page digests to live KV page ids.

    Not thread-safe by itself: the owning engine serialises access (the
    allocator underneath is thread-safe)."""

    def __init__(self, alloc) -> None:
        self._alloc = alloc
        self.page_size = int(alloc.page_size)
        # digest -> [page_id, page_tokens, parent_digest, last_use]
        self._entries: dict[bytes, list] = {}
        self._tick = 0
        self.hit_tokens = 0        # cumulative, counted by the engine
        self.miss_tokens = 0

    def __len__(self) -> int:
        return len(self._entries)

    def lookup(self, prompt: np.ndarray,
               root: bytes = b"") -> tuple[list[int], int]:
        """The longest cached page chain covering at most
        ``len(prompt) - 1`` tokens (the last prompt token is always
        recomputed, so the caller gets its logits); the hit pages are
        retained for the caller, one allocator ref each, to release when
        the request retires.  Returns ``(pages, tokens covered)``.  The
        hit and miss counters are the caller's to add to, once an
        admission succeeds: a retried lookup must not count twice."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        pages: list[int] = []
        parent = root
        for k in range(max(len(prompt) - 1, 0) // ps):
            tb = prompt[k * ps:(k + 1) * ps].tobytes()
            d = _digest(parent, tb)
            e = self._entries.get(d)
            if e is None or e[1] != tb:
                break
            self._tick += 1
            e[3] = self._tick
            pages.append(e[0])
            parent = d
        if pages:
            self._alloc.retain(pages)
        return pages, len(pages) * ps

    def register(self, prompt: np.ndarray, pages, root: bytes = b"") -> int:
        """Cache every complete page of ``prompt`` (its KV in
        ``pages[k]``), pinning each newly cached page with one allocator
        ref.  A page already cached under the same chain key is kept (the
        same KV; the duplicate frees with its request).  Returns the number
        of new entries."""
        prompt = np.asarray(prompt, np.int32)
        ps = self.page_size
        parent = root
        added = 0
        for k in range(len(prompt) // ps):
            tb = prompt[k * ps:(k + 1) * ps].tobytes()
            d = _digest(parent, tb)
            if d not in self._entries:
                self._alloc.retain([int(pages[k])])
                self._tick += 1
                self._entries[d] = [int(pages[k]), tb, parent, self._tick]
                added += 1
            parent = d
        return added

    def evict(self, n_pages: int) -> int:
        """Drop entries, leaves first in LRU order, until ``n_pages``
        pages have returned to the pool or the cache is empty.  A page a
        live request still borrows only sheds the cache's ref and does not
        count.  Returns the pages freed."""
        freed = 0
        # Child counts once; evicting a leaf decrements its parent's count,
        # which may make the parent a leaf.
        children: dict[bytes, int] = {}
        for e in self._entries.values():
            children[e[2]] = children.get(e[2], 0) + 1
        heap = [(e[3], d) for d, e in self._entries.items()
                if children.get(d, 0) == 0]
        heapq.heapify(heap)
        while freed < n_pages and heap:
            tick, victim = heapq.heappop(heap)
            e = self._entries.get(victim)
            if e is None or e[3] != tick:
                continue                      # a stale heap entry
            del self._entries[victim]
            before = self._alloc.refcount(e[0])
            self._alloc.release_pages([e[0]])
            if before == 1:
                freed += 1
            parent = e[2]
            if parent:
                children[parent] -= 1
                if children[parent] == 0 and parent in self._entries:
                    heapq.heappush(heap,
                                   (self._entries[parent][3], parent))
        return freed

    def flush(self) -> None:
        """Release every cache ref and forget every entry."""
        pages = [e[0] for e in self._entries.values()]
        if pages:
            self._alloc.release_pages(pages)
        self._entries.clear()
