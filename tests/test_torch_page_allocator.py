"""The port's page allocators (the C++ one bound by ctypes, the Python
one) against the JAX package's `PythonPageAllocator`: refcounts, thread
safety, and one seeded random sequence of reserve / retain / release /
release_pages run on all three, which must give the same page ids, free
counts, refcounts and errors.  (The JAX package's C++ allocator hands
out page 1 first where both Python allocators hand out the last page
first; the port's C++ copy hands them out as the Python ones do.)"""

import threading

import numpy as np
import pytest

from metal_flash_attention_tpu.native import page_allocator as jpa
from metal_flash_attention_tpu_torch.native import build as tbuild
from metal_flash_attention_tpu_torch.native import page_allocator as tpa
from metal_flash_attention_tpu_torch.native.page_allocator import (
    NativePageAllocator,
    PagerError,
    PythonPageAllocator,
)

ALLOCATORS = [NativePageAllocator, PythonPageAllocator]


@pytest.mark.parametrize("cls", ALLOCATORS)
def test_allocator_refcounts(cls):
    """JAX's `test_allocator_refcounts`, on the port's allocators."""
    a = cls(8, 16)
    pgs = a.reserve(seq=0, num_tokens=32)
    assert len(pgs) == 2 and a.free_pages == 5
    assert a.pages(0) == pgs and all(a.refcount(p) == 1 for p in pgs)
    a.retain(pgs)                       # the cache pins both
    a.release(0)                        # the sequence's refs drop
    assert a.free_pages == 5 and a.pages(0) == []
    assert a.refcount(pgs[0]) == 1
    a.release_pages(pgs)                # the last refs: freed
    assert a.free_pages == 7
    assert a.refcount(pgs[0]) == 0
    with pytest.raises(PagerError):
        a.release_pages([pgs[0]])       # a double free
    with pytest.raises(PagerError):
        a.retain([pgs[0]])              # retaining a free page
    # A failed retain or release has no side effect.
    b = cls(8, 16)
    live = b.reserve(seq=1, num_tokens=16)
    free_pg = (set(range(1, 8)) - set(live)).pop()
    with pytest.raises(PagerError):
        b.retain([live[0], free_pg])
    with pytest.raises(PagerError):
        b.release_pages([live[0], 8])
    assert b.refcount(live[0]) == 1 and b.free_pages == 6
    with pytest.raises(PagerError):
        b.reserve(seq=2, num_tokens=16 * 7)
    assert b.free_pages == 6 and b.pages(2) == []
    with pytest.raises(PagerError):
        cls(1, 16)


@pytest.mark.parametrize("cls", ALLOCATORS)
def test_allocator_concurrent_stress(cls):
    """JAX's `test_allocator_concurrent_stress`: under mixed reserve /
    retain / release traffic from 8 threads, pages are conserved and no
    page is owned twice."""
    alloc = cls(257, 16)
    errors = []

    def worker(tid):
        try:
            rng = np.random.default_rng(tid)
            for it in range(60):
                seq = tid * 1000 + (it % 7)
                pages = alloc.reserve(
                    seq=seq, num_tokens=int(rng.integers(1, 64)))
                if pages:
                    alloc.retain(pages)          # a cache-style pin
                    alloc.release_pages(pages)   # unpinned
                if it % 3 == 2:
                    alloc.release(seq)
        except PagerError:
            pass          # pool pressure is fine; corruption is not
        except Exception as e:            # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    owned = [p for tid in range(8) for k in range(7)
             for p in alloc.pages(tid * 1000 + k)]
    assert len(owned) == len(set(owned))
    assert alloc.free_pages + len(owned) == 256
    for tid in range(8):
        for k in range(7):
            alloc.release(tid * 1000 + k)
    assert alloc.free_pages == 256
    assert all(alloc.refcount(pg) == 0 for pg in range(1, 257))


def test_allocators_match_jax_op_by_op():
    """One seeded random sequence of 600 calls on JAX's Python allocator
    and both of the port's: the same results, the same errors, and after
    every call the same free count, refcounts and page lists.  The calls
    use the allocator as the prefix cache does: retain live pages (or, to
    be refused, a free one), and release_pages only what was retained
    (or, to be refused, a free page)."""
    n, ps, seqs = 24, 8, 6
    allocs = [jpa.PythonPageAllocator(n, ps), PythonPageAllocator(n, ps),
              NativePageAllocator(n, ps)]
    rng = np.random.default_rng(0)
    pins: list[int] = []     # pages retained by the sequence below

    def run(a, op, arg):
        try:
            out = getattr(a, op)(*arg)
        except (PagerError, jpa.PagerError):
            return "PagerError"
        return out

    def pick(pool, k):
        return [int(p) for p in rng.choice(pool, k, replace=False)]

    outcomes = {"PagerError": 0}
    for _ in range(600):
        op = str(rng.choice(["reserve", "reserve", "release", "retain",
                             "release_pages"]))
        free = [p for p in range(n + 1) if not allocs[0].refcount(p)]
        if op == "reserve":
            arg = (int(rng.integers(seqs)), int(rng.integers(1, 10 * ps)))
        elif op == "release":
            arg = (int(rng.integers(seqs)),)
        elif op == "retain":
            live = [p for p in range(1, n) if allocs[0].refcount(p)]
            arg = (pick(live, min(len(live), 3)) if live else [],)
            if not live or rng.random() < 0.15:
                arg = (arg[0] + pick(free, 1),)
        else:
            arg = (pick(sorted(set(pins)), min(len(set(pins)), 2))
                   if pins else [],)
            if not pins or rng.random() < 0.15:
                arg = (arg[0] + pick(free, 1),)
        got = [run(a, op, arg) for a in allocs]
        assert got[1] == got[0] and got[2] == got[0], (op, arg, got)
        if got[0] != "PagerError":
            if op == "retain":
                pins += arg[0]
            elif op == "release_pages":
                for p in arg[0]:
                    pins.remove(p)
        outcomes[op] = outcomes.get(op, 0) + 1
        outcomes["PagerError"] += got[0] == "PagerError"
        for a in allocs[1:]:
            assert a.free_pages == allocs[0].free_pages
            assert [a.refcount(p) for p in range(n + 1)] == \
                [allocs[0].refcount(p) for p in range(n + 1)]
            assert [a.pages(s) for s in range(seqs)] == \
                [allocs[0].pages(s) for s in range(seqs)]
    # The sequence reached every call and every refusal.
    assert outcomes["PagerError"] >= 20 and len(outcomes) == 5, outcomes


def test_make_page_allocator_is_native_where_it_builds(monkeypatch):
    a = tpa.make_page_allocator(8, 4)
    assert type(a) is NativePageAllocator
    assert tbuild.NATIVE_LIB.startswith(tbuild.BUILD_DIR)

    def no_compiler():
        raise RuntimeError("native build unavailable")
    monkeypatch.setattr(tbuild, "build_native", no_compiler)
    assert type(tpa.make_page_allocator(8, 4)) is PythonPageAllocator
    assert tpa.PageAllocator is PythonPageAllocator
