// Kernel-config store: the native level of the runtime's config cache.
//
// A copy of the JAX package's `native/src/config_store.cpp` under the
// port's names (`mfa_native_*`).  Measured autotune winners (two
// integers, a tile) keyed by the hash of a canonical problem key, shared
// by every thread in the process and persistable to a flat binary table:
// lock-free for readers (open addressing over atomic slots, insert-only).
// `set_error` and `mfa_native_last_error` are the page allocator's
// (`page_allocator.cpp`), one library with it.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include "mfa_error.hpp"
#include "mfa_hash.hpp"

namespace mfa_native {

namespace {

constexpr uint32_t kCapacity = 1 << 14;  // 16384 slots, insert-only
constexpr uint64_t kEmpty = 0;

struct Slot {
  std::atomic<uint64_t> key{kEmpty};    // mix64 hash of the canonical key
  std::atomic<uint64_t> value{0};       // packed (block_q << 32) | block_kv
};

struct Store {
  Slot slots[kCapacity];
  std::atomic<uint32_t> count{0};
};

Store g_store;

inline uint64_t pack(uint32_t block_q, uint32_t block_kv) {
  return (static_cast<uint64_t>(block_q) << 32) | block_kv;
}

}  // namespace
}  // namespace mfa_native

extern "C" {

using namespace mfa_native;

// Insert (or overwrite) the config for a canonical key string.
int mfa_native_store_insert(const char* key, uint32_t key_len,
                         uint32_t block_q, uint32_t block_kv) {
  MFA_NATIVE_PRECONDITION(key != nullptr && key_len > 0, "empty key");
  MFA_NATIVE_PRECONDITION(block_q > 0 && block_kv > 0,
                       "blocks must be positive: %u x %u", block_q,
                       block_kv);
  const uint64_t h0 = hash_bytes(key, key_len);
  const uint64_t h = h0 ? h0 : 1;  // reserve 0 for empty
  for (uint32_t probe = 0; probe < kCapacity; ++probe) {
    const uint32_t idx = (h + probe) & (kCapacity - 1);
    Slot& s = g_store.slots[idx];
    uint64_t existing = s.key.load(std::memory_order_acquire);
    if (existing == h) {
      s.value.store(pack(block_q, block_kv), std::memory_order_release);
      return MFA_NATIVE_OK;
    }
    if (existing == kEmpty) {
      uint64_t expected = kEmpty;
      // Publish value before the key so a concurrent reader that sees
      // the key always sees a valid value.
      s.value.store(pack(block_q, block_kv), std::memory_order_release);
      if (s.key.compare_exchange_strong(expected, h,
                                        std::memory_order_acq_rel)) {
        g_store.count.fetch_add(1, std::memory_order_relaxed);
        return MFA_NATIVE_OK;
      }
      if (expected == h) {  // racer inserted the same key
        s.value.store(pack(block_q, block_kv), std::memory_order_release);
        return MFA_NATIVE_OK;
      }
      // Different key won the slot; keep probing.
    }
  }
  set_error("config store full (%u slots)", kCapacity);
  return MFA_NATIVE_ERR_PRECONDITION;
}

// Lookup; returns MFA_NATIVE_OK and fills blocks on hit.
int mfa_native_store_lookup(const char* key, uint32_t key_len,
                         uint32_t* block_q, uint32_t* block_kv) {
  MFA_NATIVE_PRECONDITION(key != nullptr && key_len > 0, "empty key");
  MFA_NATIVE_PRECONDITION(block_q != nullptr && block_kv != nullptr,
                       "null out params");
  const uint64_t h0 = hash_bytes(key, key_len);
  const uint64_t h = h0 ? h0 : 1;
  for (uint32_t probe = 0; probe < kCapacity; ++probe) {
    const uint32_t idx = (h + probe) & (kCapacity - 1);
    const Slot& s = g_store.slots[idx];
    const uint64_t existing = s.key.load(std::memory_order_acquire);
    if (existing == h) {
      const uint64_t v = s.value.load(std::memory_order_acquire);
      *block_q = static_cast<uint32_t>(v >> 32);
      *block_kv = static_cast<uint32_t>(v & 0xffffffffULL);
      return MFA_NATIVE_OK;
    }
    if (existing == kEmpty) return MFA_NATIVE_ERR_NOT_FOUND;
  }
  return MFA_NATIVE_ERR_NOT_FOUND;
}

uint32_t mfa_native_store_size() {
  return g_store.count.load(std::memory_order_relaxed);
}

// Persist the table: flat binary of (hash, value) pairs.
int mfa_native_store_save(const char* path) {
  MFA_NATIVE_PRECONDITION(path != nullptr, "null path");
  std::FILE* f = std::fopen(path, "wb");
  if (!f) {
    set_error("cannot open %s for writing", path);
    return MFA_NATIVE_ERR_IO;
  }
  const uint64_t magic = 0x4d46414e41543031ULL;  // "MFANAT01"
  std::fwrite(&magic, sizeof(magic), 1, f);
  for (uint32_t i = 0; i < kCapacity; ++i) {
    const uint64_t k = g_store.slots[i].key.load(std::memory_order_acquire);
    if (k == kEmpty) continue;
    const uint64_t v = g_store.slots[i].value.load(std::memory_order_acquire);
    std::fwrite(&k, sizeof(k), 1, f);
    std::fwrite(&v, sizeof(v), 1, f);
  }
  std::fclose(f);
  return MFA_NATIVE_OK;
}

// Load a table saved by mfa_native_store_save (merges into the live table).
int mfa_native_store_load(const char* path) {
  MFA_NATIVE_PRECONDITION(path != nullptr, "null path");
  std::FILE* f = std::fopen(path, "rb");
  if (!f) return MFA_NATIVE_ERR_IO;
  uint64_t magic = 0;
  if (std::fread(&magic, sizeof(magic), 1, f) != 1 ||
      magic != 0x4d46414e41543031ULL) {
    std::fclose(f);
    set_error("bad magic in %s", path);
    return MFA_NATIVE_ERR_IO;
  }
  uint64_t kv[2];
  while (std::fread(kv, sizeof(uint64_t), 2, f) == 2) {
    const uint64_t h = kv[0] ? kv[0] : 1;
    for (uint32_t probe = 0; probe < kCapacity; ++probe) {
      const uint32_t idx = (h + probe) & (kCapacity - 1);
      Slot& s = g_store.slots[idx];
      uint64_t existing = s.key.load(std::memory_order_acquire);
      if (existing == h) {
        s.value.store(kv[1], std::memory_order_release);
        break;
      }
      if (existing == kEmpty) {
        uint64_t expected = kEmpty;
        s.value.store(kv[1], std::memory_order_release);
        if (s.key.compare_exchange_strong(expected, h,
                                          std::memory_order_acq_rel)) {
          g_store.count.fetch_add(1, std::memory_order_relaxed);
          break;
        }
        if (expected == h) break;
      }
    }
  }
  std::fclose(f);
  return MFA_NATIVE_OK;
}

// Self-test hooks for the Python binding.
uint64_t mfa_native_hash_bytes(const char* data, uint32_t len) {
  return hash_bytes(data, len);
}

uint64_t mfa_native_combine64(uint64_t seed, uint64_t v) {
  return combine64(seed, v);
}

}  // extern "C"
