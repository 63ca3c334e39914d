// Hash combinators for canonical keys.
//
// A copy of the JAX package's `native/src/mfa_native_hash.hpp` under the
// port's names: a key arrives as a canonical string and is mixed with a
// 64-bit FNV-1a/xorshift pipeline.
#pragma once

#include <cstdint>
#include <cstddef>

namespace mfa_native {

// xorshift finalizer (same structure as the reference's combine_64).
inline uint64_t mix64(uint64_t x) {
  x ^= x >> 33;
  x *= 0xff51afd7ed558ccdULL;
  x ^= x >> 33;
  x *= 0xc4ceb9fe1a85ec53ULL;
  x ^= x >> 33;
  return x;
}

inline uint64_t combine64(uint64_t seed, uint64_t v) {
  // Boost-style combine with xorshift mixing, as in the reference's
  // hash_combine_64.
  return mix64(seed ^ (v + 0x9e3779b97f4a7c15ULL + (seed << 6) +
                       (seed >> 2)));
}

// FNV-1a over bytes, finalized with mix64.
inline uint64_t hash_bytes(const char* data, size_t len) {
  uint64_t h = 0xcbf29ce484222325ULL;
  for (size_t i = 0; i < len; ++i) {
    h ^= static_cast<unsigned char>(data[i]);
    h *= 0x100000001b3ULL;
  }
  return mix64(h);
}

}  // namespace mfa_native
