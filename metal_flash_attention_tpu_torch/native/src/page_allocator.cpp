// Page allocator: host-side memory management for the paged KV pools.
//
// The port's copy of the JAX package's `native/src/page_allocator.cpp`,
// under the port's names, built with g++ at first use
// (`native/build.py::build_native`) and bound by ctypes
// (`native/page_allocator.py::NativePageAllocator`).  The card holds a
// fixed pool of KV pages; this allocator owns the free list, the
// per-sequence page lists and each page's reference count (its reserving
// sequence, sequences that borrow it as a shared prompt prefix, and the
// prefix cache).  Allocation is O(1) popping and must be callable from
// every serving thread, so the allocator is mutex-guarded (coarse;
// operations are nanoseconds).
//
// One departure from the JAX copy: the free list starts as 1 .. n - 1, so
// pages are handed out from the top, n - 1 first, as by the Python
// allocator of both packages (the JAX copy hands out 1 first).  The same
// sequence of calls then gives the same page ids on either allocator.

#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

#include "mfa_error.hpp"
#include "mfa_hash.hpp"

namespace mfa_native {

thread_local char g_error[256] = {0};

void set_error(const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  std::vsnprintf(g_error, sizeof(g_error), fmt, ap);
  va_end(ap);
}

namespace {

struct Pager {
  uint32_t num_pages = 0;
  uint32_t page_size = 0;
  std::vector<uint32_t> free_list;                 // LIFO for locality
  std::map<uint64_t, std::vector<uint32_t>> seqs;  // seq_id -> pages
  // Per-page reference counts: a page can be co-owned by its
  // reserving sequence, by borrowing sequences (shared prompt
  // prefixes), and by the host prefix cache.  0 == on the free list.
  // A page returns to the free list only when the last ref drops.
  std::vector<uint32_t> refcount;
  std::mutex mu;
};

std::mutex g_registry_mu;
std::map<uint64_t, Pager*> g_pagers;
uint64_t g_next_id = 1;

Pager* find(uint64_t id) {
  std::lock_guard<std::mutex> lock(g_registry_mu);
  auto it = g_pagers.find(id);
  return it == g_pagers.end() ? nullptr : it->second;
}

}  // namespace
}  // namespace mfa_native

extern "C" {

using namespace mfa_native;

const char* mfa_native_last_error() { return g_error; }

// Create an allocator over `num_pages` pages of `page_size` tokens.
// Page 0 is reserved as the null page (never handed out), matching the
// Python layer's convention of 0-filled unassigned table entries.
uint64_t mfa_native_pager_create(uint32_t num_pages, uint32_t page_size) {
  if (num_pages < 2 || page_size == 0) {
    set_error("pager needs >= 2 pages and a positive page size");
    return 0;
  }
  auto* p = new Pager();
  p->num_pages = num_pages;
  p->page_size = page_size;
  p->free_list.reserve(num_pages - 1);
  for (uint32_t i = 1; i < num_pages; ++i) p->free_list.push_back(i);
  p->refcount.assign(num_pages, 0);
  std::lock_guard<std::mutex> lock(g_registry_mu);
  const uint64_t id = g_next_id++;
  g_pagers[id] = p;
  return id;
}

int mfa_native_pager_destroy(uint64_t id) {
  std::lock_guard<std::mutex> lock(g_registry_mu);
  auto it = g_pagers.find(id);
  MFA_NATIVE_PRECONDITION(it != g_pagers.end(), "no pager %llu",
                       (unsigned long long)id);
  delete it->second;
  g_pagers.erase(it);
  return MFA_NATIVE_OK;
}

// Grow sequence `seq` to cover `num_tokens` tokens.  Newly assigned
// page ids are appended to `out` (capacity `max_out`); returns the
// number of NEW pages via *n_new.  Fails without side effects when the
// pool cannot satisfy the request.
int mfa_native_pager_reserve(uint64_t id, uint64_t seq, uint32_t num_tokens,
                          uint32_t* out, uint32_t max_out,
                          uint32_t* n_new) {
  Pager* p = find(id);
  MFA_NATIVE_PRECONDITION(p != nullptr, "no pager %llu",
                       (unsigned long long)id);
  MFA_NATIVE_PRECONDITION(out != nullptr && n_new != nullptr,
                       "null out params");
  std::lock_guard<std::mutex> lock(p->mu);
  auto& pages = p->seqs[seq];
  const uint32_t need =
      (num_tokens + p->page_size - 1) / p->page_size;
  if (need <= pages.size()) {
    *n_new = 0;
    return MFA_NATIVE_OK;
  }
  const uint32_t grow = need - static_cast<uint32_t>(pages.size());
  if (grow > p->free_list.size()) {
    set_error("pool exhausted: need %u pages, %zu free", grow,
              p->free_list.size());
    return MFA_NATIVE_ERR_PRECONDITION;
  }
  MFA_NATIVE_PRECONDITION(grow <= max_out,
                       "out buffer too small: %u < %u", max_out, grow);
  for (uint32_t i = 0; i < grow; ++i) {
    const uint32_t page = p->free_list.back();
    p->free_list.pop_back();
    p->refcount[page] = 1;  // owned by the reserving sequence
    pages.push_back(page);
    out[i] = page;
  }
  *n_new = grow;
  return MFA_NATIVE_OK;
}

// Release every page owned by `seq`: drop the sequence's ref on each;
// pages return to the free list only when the last co-owner (prefix
// cache, borrowing sequences) has also released.
int mfa_native_pager_release(uint64_t id, uint64_t seq) {
  Pager* p = find(id);
  MFA_NATIVE_PRECONDITION(p != nullptr, "no pager %llu",
                       (unsigned long long)id);
  std::lock_guard<std::mutex> lock(p->mu);
  auto it = p->seqs.find(seq);
  if (it == p->seqs.end()) return MFA_NATIVE_ERR_NOT_FOUND;
  for (uint32_t page : it->second) {
    MFA_NATIVE_PRECONDITION(p->refcount[page] > 0,
                         "double free of page %u", page);
    if (--p->refcount[page] == 0) p->free_list.push_back(page);
  }
  p->seqs.erase(it);
  return MFA_NATIVE_OK;
}

// Add one reference to each page in `pages` (shared-prefix borrow or
// prefix-cache pin).  Every page must currently be live (rc > 0):
// retaining a free page would resurrect stale KV.
int mfa_native_pager_retain_pages(uint64_t id, const uint32_t* pages,
                               uint32_t n) {
  Pager* p = find(id);
  MFA_NATIVE_PRECONDITION(p != nullptr, "no pager %llu",
                       (unsigned long long)id);
  MFA_NATIVE_PRECONDITION(pages != nullptr || n == 0, "null pages");
  std::lock_guard<std::mutex> lock(p->mu);
  for (uint32_t i = 0; i < n; ++i) {
    MFA_NATIVE_PRECONDITION(pages[i] >= 1 && pages[i] < p->num_pages,
                         "page %u out of range", pages[i]);
    MFA_NATIVE_PRECONDITION(p->refcount[pages[i]] > 0,
                         "retain of free page %u", pages[i]);
  }
  for (uint32_t i = 0; i < n; ++i) ++p->refcount[pages[i]];
  return MFA_NATIVE_OK;
}

// Drop one reference from each page in `pages`; a page whose count
// reaches zero returns to the free list.
int mfa_native_pager_release_pages(uint64_t id, const uint32_t* pages,
                                uint32_t n) {
  Pager* p = find(id);
  MFA_NATIVE_PRECONDITION(p != nullptr, "no pager %llu",
                       (unsigned long long)id);
  MFA_NATIVE_PRECONDITION(pages != nullptr || n == 0, "null pages");
  std::lock_guard<std::mutex> lock(p->mu);
  for (uint32_t i = 0; i < n; ++i) {
    MFA_NATIVE_PRECONDITION(pages[i] >= 1 && pages[i] < p->num_pages,
                         "page %u out of range", pages[i]);
    MFA_NATIVE_PRECONDITION(p->refcount[pages[i]] > 0,
                         "double free of page %u", pages[i]);
  }
  for (uint32_t i = 0; i < n; ++i) {
    if (--p->refcount[pages[i]] == 0) p->free_list.push_back(pages[i]);
  }
  return MFA_NATIVE_OK;
}

// Current reference count of `page` (0 == free).
uint32_t mfa_native_pager_refcount(uint64_t id, uint32_t page) {
  Pager* p = find(id);
  if (!p || page >= p->num_pages) return 0;
  std::lock_guard<std::mutex> lock(p->mu);
  return p->refcount[page];
}

// Copy sequence `seq`'s page list into `out`; returns count via *n.
int mfa_native_pager_pages(uint64_t id, uint64_t seq, uint32_t* out,
                        uint32_t max_out, uint32_t* n) {
  Pager* p = find(id);
  MFA_NATIVE_PRECONDITION(p != nullptr, "no pager %llu",
                       (unsigned long long)id);
  MFA_NATIVE_PRECONDITION(out != nullptr && n != nullptr, "null out");
  std::lock_guard<std::mutex> lock(p->mu);
  auto it = p->seqs.find(seq);
  if (it == p->seqs.end()) {
    *n = 0;
    return MFA_NATIVE_OK;
  }
  MFA_NATIVE_PRECONDITION(it->second.size() <= max_out,
                       "out buffer too small");
  std::memcpy(out, it->second.data(),
              it->second.size() * sizeof(uint32_t));
  *n = static_cast<uint32_t>(it->second.size());
  return MFA_NATIVE_OK;
}

uint32_t mfa_native_pager_free_count(uint64_t id) {
  Pager* p = find(id);
  if (!p) return 0;
  std::lock_guard<std::mutex> lock(p->mu);
  return static_cast<uint32_t>(p->free_list.size());
}

}  // extern "C"
