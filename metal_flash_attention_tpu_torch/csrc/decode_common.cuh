// The pipelined split-KV core of the port's decode-family kernels (sm_90a):
// the cp.async K/V ring, the two ways to find a key row (a dense cache
// through its strides, a paged pool through its page table), the storage
// precisions a ring takes (16- or 32-bit K/V, or INT8 / FP8 / NF4 payloads
// with their scales), and the one-token decode kernel that flash_decode.cu
// (dense) and paged_attention.cu (paged) instantiate.  paged_attention.cu's
// chunked-prefill kernel runs on the same ring and address policy.
//
// What bounds a decode: HBM bytes.  Each live K and V row is read once and
// feeds only the `group` query rows of its kv head (about 4 FLOP a byte at
// group 4, D 128), so the design is about keeping bytes in flight:
//
//  * a ring of kStages tiles of kTile keys in shared memory, filled by
//    16-byte `cp.async.cg` copies (rows outside the live range are zero:
//    src-size 0) and drained with commit_group / wait_group, so tiles
//    t + 1 .. t + kStages - 1 load while tile t is computed; one
//    __syncthreads() a tile, the one the ring needs;
//  * split-KV by fixed chunks: a block takes `chunk` keys (a multiple of
//    the tile) counted from its row's first live tile, so a ragged batch
//    spends its blocks on live keys; a block past its row's end writes
//    lse = -inf and a zero partial and leaves; `merge_splits` merges the
//    partials;
//  * the paged policy reads the block's page-table entries once, into
//    shared memory, before its first copy (while the sequence's length
//    loads, when there is no window), not once per 16-byte piece.
//
// Arithmetic: 16-bit inputs on tensor cores (mma.sync m16n8k16, fp32
// accumulators): the group's rows (<= 16, zero-padded) are the M of one
// fragment, each of the block's 4 warps takes 16 keys of every tile and
// keeps its own online softmax (m, l, acc) in the exp2 domain; K and V
// fragments come from the ring by ldmatrix (.trans for V); P is rounded to
// the input type before PV.  Q's fragments stay in registers up to D 128;
// at D 256 (Gemma-2) the accumulator alone is 128 floats a thread, so Q
// sits in shared memory and each 16-deep step reads its fragment by
// ldmatrix.  kCap (a template flag, so the uncapped kernels are unchanged)
// soft-caps each fully scaled logit before the mask (`softcap`).  fp32
// inputs run in true fp32 on CUDA cores in the same ring (never TF32).
// The warps combine once, at the end, through shared memory.
//
// Quantized K/V (bf16 queries; the TPU kernels' `kv_precision`): tiles land
// in the ring in their storage type, 1 byte a value for INT8 / FP8-E4M3 /
// FP8-E5M2 and half a byte for NF4, so a tile pair is a quarter or an
// eighth of the bf16 pair's bytes.  Once a tile has landed the block
// decodes it in shared memory into one bf16 tile pair that the same
// ldmatrix / mma.sync code reads (INT8 and FP8 values are exact in bf16;
// NF4 goes through a 256-entry table of byte -> two codebook values rounded
// to bf16).  The scales are never multiplied into K or V: as in the TPU
// kernel, the K scale is a column scale of S and the V scale a column scale
// of P.  A paged pool has one scale per (page, kv head): each tile's 64 K
// and 64 V scales ride the ring beside it (4-byte cp.async copies); a dense
// cache has one per (sequence, kv head), folded into the softmax scale and
// the output.  NF4 packs two values a byte: a dense cache along D (byte j
// of a row holds elements j and j + D/2), a paged pool across tokens (byte
// (r, c) of a page holds column c of tokens r and r + page/2), so a paged
// NF4 tile is kTile/2 stored rows, both nibbles, and its keys are not in
// position order (`slot_pos`): the online softmax does not care.
//
// TMA is not used: a paged gather at any page size is not a tensor map,
// and a map encoded on the host per call costs host time that the decode
// step (host-bound, ~1,850 launches a step) does not have.

#pragma once

#include "attention_common.cuh"
#include "flash_tiles.cuh"
#include "quant_common.cuh"

namespace mfa {

// --- cp.async and ldmatrix ----------------------------------------------

// 16 bytes global -> shared, bypassing L1; zero-filled when !live (no byte
// of src is read then).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool live) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(live ? 16 : 0) : "memory");
}

// 4 bytes global -> shared (a scale), zero-filled when !live.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool live) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(live ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 16-bit matrices; lane l gives the row address of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ uint32_t ld_u32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 16 bytes of T as floats, two adjacent values as a float2, and one value.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  __device__ static void unpack(const uint4& x, float* f) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static float one(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <>
struct Elem<__half> {
  __device__ static void unpack(const uint4& x, float* f) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static float2 pair(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  __device__ static float one(const __half* p) { return __half2float(*p); }
};

template <>
struct Elem<float> {
  __device__ static void unpack(const uint4& x, float* f) {
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  }
  __device__ static float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static float one(const float* p) { return *p; }
};

// --- the ring ------------------------------------------------------------

// At most this much shared memory for a ring: fp32 tiles take fewer stages.
constexpr size_t kRingBudget = 160 * 1024;

// kStages slots, each a K tile then a V tile of kTile rows of D values
// padded by 16 bytes (the 8 rows an ldmatrix or a 16-byte read touches
// fall in distinct banks).
template <typename T, int D, int kTile, int kStagesWanted>
struct Ring {
  static constexpr int kVec = 16 / sizeof(T);  // values a 16-byte copy
  static constexpr int kStride = D + kVec;
  static constexpr int kTileElems = kTile * kStride;
  static constexpr size_t kStageBytes = 2 * sizeof(T) * kTileElems;
  static constexpr int kFit = (int)(kRingBudget / kStageBytes);
  static constexpr int kStages = kStagesWanted < kFit ? kStagesWanted
                                 : (kFit < 2 ? 2 : kFit);
  static constexpr size_t kBytes = kStages * kStageBytes;
  static_assert(kStagesWanted >= 2, "a ring needs two stages");
};

// Copy key rows j0 .. j0 + kTile - 1 into a slot (K at ks, V at vs); rows
// outside [lo, hi) are zero and never looked up.
template <typename T, int D, int kTile, int kThreads, class Rows>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const Rows& rows,
                                          int j0, int lo, int hi) {
  using R = Ring<T, D, kTile, 2>;
  constexpr int kPerRow = D / R::kVec;
  constexpr int kPieces = kTile * kPerRow;
  static_assert(kPieces % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int i = 0; i < kPieces / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kPerRow, part = (c % kPerRow) * R::kVec;
    const int pos = j0 + r;
    const bool live = pos >= lo && pos < hi;
    const T* kr = rows.k;
    const T* vr = rows.v;
    if (live) rows.find(pos, kr, vr);
    cp_async_16(ks + r * R::kStride + part, kr + part, live);
    cp_async_16(vs + r * R::kStride + part, vr + part, live);
  }
}

// Tiles [t0, t1) through the ring: body(j0, K tile, V tile) runs on each
// once its copies have landed.  Every thread of the block calls it.  On
// return every copy has landed and every thread is past its last tile, so
// the ring's memory may be reused.
template <typename T, int D, int kTile, int kStages, int kThreads, class Rows,
          class Body>
__device__ __forceinline__ void ring_loop(T* ring, const Rows& rows, int t0,
                                          int t1, int lo, int hi,
                                          Body&& body) {
  using R = Ring<T, D, kTile, kStages>;
  static_assert(R::kStages == kStages, "pass the ring's own stage count");
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int t = t0 + s;
    if (t < t1) {
      T* ks = ring + (t % kStages) * 2 * R::kTileElems;
      load_tile<T, D, kTile, kThreads>(ks, ks + R::kTileElems, rows,
                                       t * kTile, lo, hi);
    }
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kStages - 2>();  // tile t has landed (this thread's part)
    __syncthreads();               // ... and every thread's; slot t - 1 free
    const int next = t + kStages - 1;
    if (next < t1) {
      T* ks = ring + (next % kStages) * 2 * R::kTileElems;
      load_tile<T, D, kTile, kThreads>(ks, ks + R::kTileElems, rows,
                                       next * kTile, lo, hi);
    }
    cp_async_commit();
    const T* ks = ring + (t % kStages) * 2 * R::kTileElems;
    body(t * kTile, ks, ks + R::kTileElems);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// --- where the keys of a tile lie ----------------------------------------

// Tile t holds keys t * kTile .. t * kTile + kTile - 1 in order, except in a
// paged NF4 pool (Rows::kSplitRows): there it is stored rows t * kTile/2 ..
// of the sequence's pages, slot o < kTile/2 the low nibble of stored row o
// (token r of its page) and slot o >= kTile/2 the high nibble of stored row
// o - kTile/2 (token r + page/2).  `slot_pos` is a slot's position in the
// sequence; for stored row r < kTile/2 of a split tile it is the low
// nibble's, the position `Rows::find` takes.
template <int kTile, class Rows>
__device__ __forceinline__ int slot_pos(const Rows& rows, int t, int o) {
  if constexpr (Rows::kSplitRows) {
    constexpr int kRows = kTile / 2;
    const int half = rows.page_rows;
    const int g = t * kRows + (o % kRows);
    const int pg = g / half;
    return pg * rows.page_size + (g - pg * half) + (o >= kRows ? half : 0);
  } else {
    return t * kTile + o;
  }
}

// Whether stored row `pos` (its low nibble's position) holds a live key.
template <class Rows>
__device__ __forceinline__ bool stored_live(const Rows& rows, int pos,
                                            int lo, int hi) {
  bool live = pos >= lo && pos < hi;
  if constexpr (Rows::kSplitRows) {
    const int pos2 = pos + rows.page_rows;
    live = live || (pos2 >= lo && pos2 < hi);
  }
  return live;
}

// The least and the greatest position of tile t's keys.
template <int kTile, class Rows>
__device__ __forceinline__ void tile_span(const Rows& rows, int t, int& pmin,
                                          int& pmax) {
  pmin = slot_pos<kTile>(rows, t, 0);
  pmax = slot_pos<kTile>(rows, t, kTile - 1);
}

// The tiles [first, last) that hold the keys [lo, hi) (last == first when
// there is none).
template <int kTile, class KV>
__device__ __forceinline__ void tile_range(const KV& kv, int lo, int hi,
                                           int& first, int& last) {
  if constexpr (KV::kSplitRows) {
    constexpr int kRows = kTile / 2;
    const int ps = kv.page_size, half = kv.page_rows;
    first = lo / ps * half / kRows;
    last = first;
    if (hi > lo) {
      const int pg = (hi - 1) / ps;
      const int stored_end = pg * half + min(half, hi - pg * ps);
      last = (stored_end + kRows - 1) / kRows;
    }
  } else {
    first = lo / kTile;
    last = hi > lo ? (hi + kTile - 1) / kTile : first;
  }
}

// --- the quantized ring ---------------------------------------------------

// kStages slots of a quantized tile pair in its storage type (kRows stored
// rows of kRowBytes each, K then V) and the tile's per-key K and V scales
// (paged pools); after the ring, the bf16 tile pair the tensor cores read
// (kTile rows of D values, padded as Ring<bf16>'s) and, for NF4, the byte
// -> two codebook values table.
template <int P, bool kSplitRows, int D, int kTile_, int kStages_>
struct QRing {
  static constexpr int kPrec = P;
  static constexpr int kTile = kTile_;
  static constexpr bool kNf4 = P == kPrecNf4;
  static constexpr bool kSplit = kNf4 && kSplitRows;
  static constexpr int kRowBytes = kNf4 && !kSplit ? D / 2 : D;
  static constexpr int kRows = kSplit ? kTile / 2 : kTile;
  static constexpr int kTileBytes = kRows * kRowBytes;
  static constexpr int kStageBytes =
      2 * kTileBytes + 2 * kTile * (int)sizeof(float);
  static constexpr int kStages = kStages_;
  static constexpr int kStride = D + 8;
  static constexpr int kWorkTileElems = kTile * kStride;
  static constexpr size_t kRingBytes = (size_t)kStages * kStageBytes;
  static constexpr size_t kWorkBytes =
      2 * sizeof(__nv_bfloat16) * kWorkTileElems;
  static constexpr size_t kTableBytes = kNf4 ? 256 * sizeof(uint32_t) : 0;
  static constexpr size_t kBytes = kRingBytes + kWorkBytes + kTableBytes;
  static_assert(kRowBytes % 16 == 0, "whole 16-byte copies a stored row");
  static_assert(kStages >= 2, "a ring needs two stages");
};

// The NF4 table (`fill_nf4_pairs`), filled by every thread of the block.
template <class QR>
__device__ __forceinline__ void fill_nf4_table(uint32_t* table) {
  if constexpr (QR::kNf4) fill_nf4_pairs(table, threadIdx.x, blockDim.x);
}

// The passes of a block's threads over kPieces 16-byte pieces: whole
// passes, or one guarded pass when a tile has fewer pieces than threads (an
// NF4 tile at D 32: 64 rows of 16 bytes dense, 32 rows of 32 bytes paged).
template <int kPieces, int kThreads>
__host__ __device__ constexpr int passes() {
  static_assert(kPieces % kThreads == 0 || kPieces < kThreads,
                "whole passes, or one guarded pass");
  return kPieces < kThreads ? 1 : kPieces / kThreads;
}

__device__ __forceinline__ void store32(__nv_bfloat16* dst,
                                        const uint4 (&x)[2]) {
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = x[0];
  d[1] = x[1];
}

// One stored tile (raw) into the bf16 tile (work) that ldmatrix reads.
template <class QR, int kThreads>
__device__ __forceinline__ void dequant_tile(const unsigned char* raw,
                                             __nv_bfloat16* work,
                                             const uint32_t* table) {
  constexpr int kPerRow = QR::kRowBytes / 16;
  constexpr int kPieces = QR::kRows * kPerRow;
  constexpr int kStride = QR::kStride;
#pragma unroll
  for (int i = 0; i < passes<kPieces, kThreads>(); ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (kPieces < kThreads && c >= kPieces) break;
    const int r = c / kPerRow, part = (c % kPerRow) * 16;
    const uint4 x =
        *reinterpret_cast<const uint4*>(raw + r * QR::kRowBytes + part);
    if constexpr (!QR::kNf4) {
      uint4 out[2];
      bytes_to_bf16<QR::kPrec>(x, out);
      store32(work + r * kStride + part, out);
    } else {
      uint4 lo[2], hi[2];
      nf4_to_bf16(x, table, lo, hi);
      store32(work + r * kStride + part, lo);
      if constexpr (QR::kSplit)  // token r + page/2: tile row r + kTile/2
        store32(work + (r + QR::kTile / 2) * kStride + part, hi);
      else  // element j + D/2 of the same row
        store32(work + r * kStride + QR::kRowBytes + part, hi);
    }
  }
}

// The copies of tile t into a stage: its stored rows (zero where no key is
// live), then, when the pool has per-page scales (Rows::kSlotScales), each
// slot's K scale (threads 0 .. kTile - 1) and V scale (the next kTile).
template <class QR, int kThreads, class Rows>
__device__ __forceinline__ void load_qtile(unsigned char* stage,
                                           const Rows& rows, int t, int lo,
                                           int hi) {
  constexpr int kPerRow = QR::kRowBytes / 16;
  constexpr int kPieces = QR::kRows * kPerRow;
#pragma unroll
  for (int i = 0; i < passes<kPieces, kThreads>(); ++i) {
    const int c = threadIdx.x + i * kThreads;
    if (kPieces < kThreads && c >= kPieces) break;
    const int r = c / kPerRow, part = (c % kPerRow) * 16;
    const int pos = slot_pos<QR::kTile>(rows, t, r);
    const bool live = stored_live(rows, pos, lo, hi);
    const uint8_t* kr = rows.k;
    const uint8_t* vr = rows.v;
    if (live) rows.find(pos, kr, vr);
    cp_async_16(stage + r * QR::kRowBytes + part, kr + part, live);
    cp_async_16(stage + QR::kTileBytes + r * QR::kRowBytes + part,
                vr + part, live);
  }
  if constexpr (Rows::kSlotScales) {
    static_assert(2 * QR::kTile == kThreads, "a scale a thread");
    const int o = threadIdx.x % QR::kTile;
    const bool is_v = threadIdx.x >= QR::kTile;
    const int pos = slot_pos<QR::kTile>(rows, t, o);
    const bool live = pos >= lo && pos < hi;
    const float* src = is_v ? rows.v_scales : rows.k_scales;
    if (live) src += rows.scale_offset(pos);
    cp_async_4(stage + 2 * QR::kTileBytes + threadIdx.x * sizeof(float), src,
               live);
  }
}

// ring_loop for quantized tiles: once tile t has landed every thread decodes
// part of it into the bf16 tile pair, and body(t, K tile, V tile, K scales,
// V scales) runs on that (the scales are the stage's, null-free only when
// Rows::kSlotScales).  [lo, hi) is the rows' live range.
template <class QR, int kThreads, class Rows, class Body>
__device__ __forceinline__ void qring_loop(unsigned char* ring,
                                           const uint32_t* table,
                                           const Rows& rows, int t0, int t1,
                                           int lo, int hi, Body&& body) {
  constexpr int kStages = QR::kStages;
  __nv_bfloat16* work =
      reinterpret_cast<__nv_bfloat16*>(ring + QR::kRingBytes);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    const int t = t0 + s;
    if (t < t1)
      load_qtile<QR, kThreads>(ring + (t % kStages) * QR::kStageBytes, rows,
                               t, lo, hi);
    cp_async_commit();
  }
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile t is in; every thread is past tile t - 1
    const int next = t + kStages - 1;
    if (next < t1)
      load_qtile<QR, kThreads>(ring + (next % kStages) * QR::kStageBytes,
                               rows, next, lo, hi);
    cp_async_commit();
    const unsigned char* stage = ring + (t % kStages) * QR::kStageBytes;
    dequant_tile<QR, kThreads>(stage, work, table);
    dequant_tile<QR, kThreads>(stage + QR::kTileBytes,
                               work + QR::kWorkTileElems, table);
    __syncthreads();  // the bf16 tiles are in
    const float* scales =
        reinterpret_cast<const float*>(stage + 2 * QR::kTileBytes);
    body(t, work, work + QR::kWorkTileElems, scales, scales + QR::kTile);
  }
  cp_async_wait<0>();
  __syncthreads();
}

// --- finding a key row ---------------------------------------------------

// A dense cache [b, kv_heads, S, D] read in place through its batch, head
// and sequence strides (in elements of S: bytes for a quantized cache,
// whose NF4 rows hold D/2 bytes).  Row b sees start <= pos < end (end =
// kv_lens[b] or S; with max_span at most start + max_span).  A quantized
// cache has one K and one V scale per (sequence, kv head).
template <typename S>
struct DenseKV {
  static constexpr bool kPaged = false;
  static constexpr bool kSplitRows = false;
  static constexpr int kStages = MFA_DECODE_STAGES;  // of the decode ring
  const S* k;
  const S* v;
  const float* k_scales;  // [b, kv_heads] (quantized) or null
  const float* v_scales;
  const int* lens;    // [b] or null (S)
  const int* starts;  // [b] or null (0)
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int seq, max_span;

  struct Rows {
    static constexpr bool kSplitRows = false;
    static constexpr bool kSlotScales = false;
    const S* k;
    const S* v;
    long long k_ss, v_ss;
    __device__ void find(int pos, const S*& kr, const S*& vr) const {
      kr = k + pos * k_ss;
      vr = v + pos * v_ss;
    }
  };

  __device__ void range(int b, int& lo, int& hi) const {
    lo = starts ? max(starts[b], 0) : 0;
    hi = lens ? min(lens[b], seq) : seq;
    if (max_span > 0) hi = min(hi, lo + max_span);
  }

  __device__ bool prefetch(int, int, int, int*) const { return false; }

  __device__ Rows rows(int b, int h, int*, int, int, bool) const {
    return {k + b * k_sb + h * k_sh, v + b * v_sb + h * v_sh, k_ss, v_ss};
  }
};

// A paged pool [pages, kv_heads, page_rows, row] through the page table
// [b, max_pages]; row b's keys are 0 .. lengths[b] - 1, from starts[b]
// when there are starts, and a decode row sees the last `window` of them
// (window <= 0: all).  page_rows is the
// page size, or half of it for an NF4 pool (kSplit: token r of a page in
// the low nibble of stored row r, token r + page/2 in the high one);
// head_dim is a stored row's elements (D; bytes for a quantized pool).  A
// quantized pool has one K and one V scale per (page, kv head).
template <typename S, bool kSplit = false>
struct PagedKV {
  static constexpr bool kPaged = true;
  static constexpr bool kSplitRows = kSplit;
  static constexpr int kStages = MFA_PAGED_STAGES;
  const S* k;
  const S* v;
  const float* k_scales;  // [pages, kv_heads] (quantized) or null
  const float* v_scales;
  const int* table;
  const int* lengths;
  const int* starts;  // [b] each row's first position, or null (0)
  int kv_heads, head_dim, page_size, page_rows, max_pages, window;

  struct Rows {
    static constexpr bool kSplitRows = kSplit;
    static constexpr bool kSlotScales = !std::is_same<S,
                                                      __nv_bfloat16>::value;
    const S* k;  // pool + this head's first row of page 0
    const S* v;
    const float* k_scales;  // scales + this head
    const float* v_scales;
    const int* pages;  // table entries first .. (shared memory)
    size_t page_elems;  // elements from one page to the next
    int first, page_size, page_rows, head_dim, kv_heads;
    __device__ void find(int pos, const S*& kr, const S*& vr) const {
      const int pg = pos / page_size;
      int r = pos - pg * page_size;
      if (kSplit && r >= page_rows) r -= page_rows;
      const size_t off = (size_t)pages[pg - first] * page_elems +
                         (size_t)r * head_dim;
      kr = k + off;
      vr = v + off;
    }
    // Elements from the head's first scale to the scale of pos's page.
    __device__ size_t scale_offset(int pos) const {
      return (size_t)pages[pos / page_size - first] * kv_heads;
    }
  };

  __device__ void range(int b, int& lo, int& hi) const {
    hi = lengths[b];
    lo = window > 0 ? max(0, hi - window) : 0;
    if (starts) lo = max(lo, starts[b]);
  }

  // The table entries of keys [lo, hi) into `pages` (at most (hi - lo -
  // 1) / page_size + 2 of them, none past the table's row).
  __device__ void fetch(int b, int lo, int hi, int* pages) const {
    const int first = lo / page_size;
    const int last = min((hi - 1) / page_size, max_pages - 1);
    for (int i = threadIdx.x; i <= last - first; i += blockDim.x)
      pages[i] = table[(size_t)b * max_pages + first + i];
  }

  // Without a window or starts a block's keys start where its chunk does,
  // whatever the sequence's length: fetch the chunk's entries [lo, hi)
  // while the length loads (entries past the live pages are read, never
  // used).  True when it did.
  __device__ bool prefetch(int b, int lo, int hi, int* pages) const {
    if (window > 0 || starts) return false;
    fetch(b, lo, hi, pages);
    return true;
  }

  // The rows of keys [lo, hi) (lo < hi), whose table entries are fetched
  // here unless `prefetched` (then lo is the prefetch's start).  The
  // caller syncs the block before the first copy.  A paged tile's keys lie
  // in the pages of the positions [t * kTile, (t + 1) * kTile) in either
  // layout, so [lo, hi) may be a chunk's positions.
  __device__ Rows rows(int b, int h, int* pages, int lo, int hi,
                       bool prefetched) const {
    if (!prefetched) fetch(b, lo, hi, pages);
    const size_t head = (size_t)h * page_rows * head_dim;
    return {k + head, v + head, k_scales ? k_scales + h : nullptr,
            v_scales ? v_scales + h : nullptr, pages,
            (size_t)kv_heads * page_rows * head_dim, lo / page_size,
            page_size, page_rows, head_dim, kv_heads};
  }
};

// Table entries a block's smem holds for a chunk of `chunk` keys.
inline int pages_capacity(int chunk, int page_size) {
  return chunk / page_size + 2;
}

// --- the decode kernel ---------------------------------------------------

constexpr int kDecodeWarps = 4;
constexpr int kDecodeThreads = 32 * kDecodeWarps;
constexpr int kDecodeTile = MFA_DECODE_BLOCK_KV;
constexpr int kDecodeMaxGroup = MFA_DECODE_MAX_GROUP;
constexpr int kWarpKeys = kDecodeTile / kDecodeWarps;
static_assert(kWarpKeys == 16, "a warp takes one 16-key mma step a tile");
static_assert(kDecodeMaxGroup == 16, "the group is the M of one fragment");

template <typename T>
struct DecodeIO {
  const T* q;       // [b, q_heads, D]
  T* o;             // [b, q_heads, D]
  float* lse;       // [b, q_heads], natural log
  float* part_o;    // [b, kv_heads, splits, group, D]
  float* part_lse;  // [b, kv_heads, splits, group], base 2
  int q_heads, kv_heads, chunk, splits;
  float scale_log2e;
  float cap2, inv_cap2;  // the soft cap in the exp2 domain (kCap kernels)
};

// P: the K/V storage precision (kUnquantized: K/V in T; else a Precision of
// quant_common.cuh, with T bf16).
template <typename T, int D, class KV, int P = kUnquantized>
struct DecodeSmem {
  static constexpr bool kQuant = P != kUnquantized;
  using R = Ring<T, D, kDecodeTile, KV::kStages>;
  using QR = QRing<P, KV::kSplitRows, D, kDecodeTile, KV::kStages>;
  static_assert(!kQuant || std::is_same<T, __nv_bfloat16>::value,
                "quantized K/V take bf16 queries");
  // MFA_DECODE_MMA 0 (an ablation) moves 16-bit K/V in the queries' type
  // to CUDA cores; quantized K/V stay on tensor cores.
  static constexpr bool kMma =
      !std::is_same<T, float>::value && (MFA_DECODE_MMA != 0 || kQuant);
  static_assert(!kQuant || kMma, "quantized K/V run on tensor cores");
  static constexpr int kStages = kQuant ? QR::kStages : R::kStages;
  static constexpr int kStride = R::kStride;
  static constexpr size_t kRingBytes = kQuant ? QR::kBytes : R::kBytes;
  // The warps' (m, l) and acc, once the ring is drained: [warp][row], and
  // [warp][row][D + 8] (8 floats of padding: the rows' float2 stores fall
  // in two wavefronts).
  static constexpr int kCombStride = D + 8;
  static constexpr size_t kCombBytes =
      sizeof(float) * kDecodeWarps * kDecodeMaxGroup * (2 + kCombStride);
  // Q in shared memory: on tensor cores at D 256, the group's rows
  // (zero-padded to 16) in T, padded as the ring's rows; on CUDA cores in
  // float32.  The CUDA-core path also keeps each warp's P [16 rows][16
  // keys] with the tile's rescale of each row.
  static constexpr bool kQSmem = kMma && D > 128;
  static constexpr size_t kQBytes =
      kMma ? (kQSmem ? sizeof(T) * kDecodeMaxGroup * kStride : 0)
           : sizeof(float) * kDecodeMaxGroup * D;
  static constexpr int kScratch = kDecodeMaxGroup * (kWarpKeys + 1);
  static constexpr size_t kScratchBytes =
      kMma ? 0 : sizeof(float) * kDecodeWarps * kScratch;
  static_assert(kCombBytes <= (kQuant ? QR::kRingBytes + QR::kWorkBytes
                                      : R::kBytes),
                "the combine fits the ring");
  static_assert(!kQuant || kStride == QR::kStride, "one bf16 tile layout");
  static size_t bytes(int pages_cap) {
    return kRingBytes + kQBytes + kScratchBytes + sizeof(int) * pages_cap;
  }
};

// One block: the group's rows of (sequence b, kv head h) against the
// chunk of key tiles of split blockIdx.x.  Writes o and lse when the call
// has one split, else its normalized float32 partial and base-2 lse.
// kCap: soft-cap the logits (io.cap2).
template <typename T, int D, class KV, int P = kUnquantized,
          bool kCap = false>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode90_kernel(DecodeIO<T> io, KV kv) {
  using S = DecodeSmem<T, D, KV, P>;
  using R = typename S::R;
  using QR = typename S::QR;
  constexpr bool kQuant = S::kQuant;
  constexpr int kTile = kDecodeTile, kStages = S::kStages;
  constexpr int kStride = S::kStride;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  uint32_t* table =
      reinterpret_cast<uint32_t*>(smem + QR::kRingBytes + QR::kWorkBytes);
  float* qs = reinterpret_cast<float*>(smem + S::kRingBytes);
  float* scratch =
      reinterpret_cast<float*>(smem + S::kRingBytes + S::kQBytes);
  int* pages = reinterpret_cast<int*>(smem + S::kRingBytes + S::kQBytes +
                                      S::kScratchBytes);
  float* cm = reinterpret_cast<float*>(smem);  // after the ring drains
  float* cl = cm + kDecodeWarps * kDecodeMaxGroup;
  float* ca = cl + kDecodeWarps * kDecodeMaxGroup;

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int group = io.q_heads / io.kv_heads;
  const size_t q_row = (size_t)b * io.q_heads + (size_t)h * group;
  const size_t p_row =
      (((size_t)b * io.kv_heads + h) * io.splits + split) * group;

  const bool prefetched =
      kv.prefetch(b, split * io.chunk, (split + 1) * io.chunk, pages);
  int lo, hi, first, last;
  kv.range(b, lo, hi);
  tile_range<kTile>(kv, lo, hi, first, last);
  const int t0 = first + split * (io.chunk / kTile);
  const int t1 = min(last, t0 + io.chunk / kTile);
  if (t0 >= t1) {  // no live key in this chunk
    if (io.splits > 1) {
      for (int i = tid; i < group * D; i += kDecodeThreads)
        io.part_o[p_row * D + i] = 0.f;
      if (tid < group) io.part_lse[p_row + tid] = -INFINITY;
    } else {
      for (int i = tid; i < group * D; i += kDecodeThreads)
        io.o[q_row * D + i] = from_float<T>(0.f);
      if (tid < group) io.lse[q_row + tid] = -INFINITY;
    }
    return;
  }
  const int k_lo = max(lo, t0 * kTile), k_hi = min(hi, t1 * kTile);
  const auto rows = kv.rows(b, h, pages, k_lo, k_hi, prefetched);
  const T* q = io.q + q_row * D;
  // A dense quantized cache's scales are the row's: K's folds into the
  // softmax scale, V's into the output.
  float scale = io.scale_log2e, out_scale = 1.f;
  if constexpr (kQuant && !KV::kPaged) {
    scale *= kv.k_scales[(size_t)b * io.kv_heads + h];
    out_scale = kv.v_scales[(size_t)b * io.kv_heads + h];
  }
  fill_nf4_table<QR>(table);
  const int key0 = warp * kWarpKeys;

  if constexpr (S::kMma) {
    // Lane (g, t4) holds rows g and g + 8 of the fragments; rows past the
    // group are zero.  At D 256 the rows go to shared memory instead (the
    // ring loop's first barrier publishes them).
    const int g = lane / 4, t4 = lane % 4;
    uint32_t qf[S::kQSmem ? 1 : D / 16][4];
    T* qsm = reinterpret_cast<T*>(smem + S::kRingBytes);
    if constexpr (S::kQSmem) {
      for (int i = tid; i < kDecodeMaxGroup * (D / 2); i += kDecodeThreads) {
        const int r = i / (D / 2), c = 2 * (i % (D / 2));
        *reinterpret_cast<uint32_t*>(qsm + r * kStride + c) =
            r < group ? ld_u32(q + r * D + c) : 0u;
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t4;
        qf[kk][0] = g < group ? ld_u32(q + g * D + c) : 0u;
        qf[kk][1] = g + 8 < group ? ld_u32(q + (g + 8) * D + c) : 0u;
        qf[kk][2] = g < group ? ld_u32(q + g * D + c + 8) : 0u;
        qf[kk][3] = g + 8 < group ? ld_u32(q + (g + 8) * D + c + 8) : 0u;
      }
    }
    if (KV::kPaged) __syncthreads();  // the page entries are in
    float acc[D / 8][4];
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
    // ldmatrix rows: K as [key][dim] (both key octets of one 16-dim step),
    // V transposed (both key octets of one 16-column pair).
    const int mi = lane >> 3, r8 = lane & 7;
    const int k_off = (key0 + (mi >> 1) * 8 + r8) * kStride + (mi & 1) * 8;
    const int v_off = (key0 + (mi & 1) * 8 + r8) * kStride + (mi >> 1) * 8;
    // Q from shared memory: matrix mi is rows (mi & 1) * 8 .., columns
    // (mi >> 1) * 8 .. of a 16-deep step, the A fragment's order.
    const int q_off = ((mi & 1) * 8 + r8) * kStride + (mi >> 1) * 8;

    // One tile: ks / vs the bf16 (or T) tiles, ksc / vsc the paged
    // quantized pool's per-key scales (slot order).
    auto step = [&](int t, const T* ks, const T* vs, const float* ksc,
                    const float* vsc) {
      float s[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + k_off + kk * 16);
        if constexpr (S::kQSmem) {
          uint32_t qa[4];
          ldsm_x4(qa, qsm + q_off + kk * 16);
          mma_16816<T>(s[0], qa, kb[0], kb[1]);
          mma_16816<T>(s[1], qa, kb[2], kb[3]);
        } else {
          mma_16816<T>(s[0], qf[kk], kb[0], kb[1]);
          mma_16816<T>(s[1], qf[kk], kb[2], kb[3]);
        }
      }
      int pmin, pmax;
      tile_span<kTile>(rows, t, pmin, pmax);
      const bool edge = pmin < lo || pmax >= hi;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int o = key0 + nt * 8 + 2 * t4 + (e & 1);
          const int col = slot_pos<kTile>(rows, t, o);
          float x = s[nt][e] * scale;
          if constexpr (KV::Rows::kSlotScales) x *= ksc[o];
          if constexpr (kCap) x = softcap(x, io.cap2, io.inv_cap2);
          s[nt][e] = !edge || (col >= lo && col < hi) ? x : -INFINITY;
        }
      float alpha[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float mx = quad_max(
            fmaxf(fmaxf(s[0][2 * rr], s[0][2 * rr + 1]),
                  fmaxf(s[1][2 * rr], s[1][2 * rr + 1])));
        const float mn = fmaxf(m[rr], mx);
        const float base = mn == -INFINITY ? 0.f : mn;
        alpha[rr] = exp2f(m[rr] - base);
        m[rr] = mn;
        float sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 2 * rr; e < 2 * rr + 2; ++e) {
            s[nt][e] = exp2f(s[nt][e] - base);
            sum += s[nt][e];
          }
        l[rr] = l[rr] * alpha[rr] + sum;
      }
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        acc[dn][0] *= alpha[0];
        acc[dn][1] *= alpha[0];
        acc[dn][2] *= alpha[1];
        acc[dn][3] *= alpha[1];
      }
      // P's columns take V's scales (after l: the sums are of P itself).
      if constexpr (KV::Rows::kSlotScales) {
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            s[nt][e] *= vsc[key0 + nt * 8 + 2 * t4 + (e & 1)];
      }
      // The score accumulators of the warp's two key octets are the A
      // fragment of one 16-key step.
      const uint32_t a[4] = {pack2<T>(s[0][0], s[0][1]),
                             pack2<T>(s[0][2], s[0][3]),
                             pack2<T>(s[1][0], s[1][1]),
                             pack2<T>(s[1][2], s[1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + v_off + dp * 16);
        mma_16816<T>(acc[2 * dp], a, vb[0], vb[1]);
        mma_16816<T>(acc[2 * dp + 1], a, vb[2], vb[3]);
      }
    };
    if constexpr (kQuant) {
      qring_loop<QR, kDecodeThreads>(smem, table, rows, t0, t1, lo, hi,
                                     step);
    } else {
      ring_loop<T, D, kTile, kStages, kDecodeThreads>(
          ring, rows, t0, t1, k_lo, k_hi,
          [&](int j0, const T* ks, const T* vs) {
            step(j0 / kTile, ks, vs, nullptr, nullptr);
          });
    }

    l[0] = quad_sum(l[0]);
    l[1] = quad_sum(l[1]);
    const int w = warp * kDecodeMaxGroup;
    if (t4 == 0) {
      cm[w + g] = m[0];
      cm[w + g + 8] = m[1];
      cl[w + g] = l[0];
      cl[w + g + 8] = l[1];
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<float2*>(ca + (w + g) * S::kCombStride + dn * 8 +
                                 2 * t4) = make_float2(acc[dn][0],
                                                       acc[dn][1]);
      *reinterpret_cast<float2*>(ca + (w + g + 8) * S::kCombStride +
                                 dn * 8 + 2 * t4) =
          make_float2(acc[dn][2], acc[dn][3]);
    }
  } else {
    // CUDA cores: lane (key kl, half) scores rows half, half + 2, ... of
    // the group against key kl of the warp's 16; for PV it owns columns
    // lane * kCols .. + kCols - 1 of every row.
    constexpr int kRowsL = kDecodeMaxGroup / 2, kCols = D / 32;
    constexpr int kVec = R::kVec;
    for (int i = 2 * tid; i < group * D; i += 2 * kDecodeThreads) {
      const float2 x = Elem<T>::pair(q + i);
      qs[i] = x.x;
      qs[i + 1] = x.y;
    }
    __syncthreads();  // qs (and the page entries) are in
    const int kl = lane & 15, half = lane >> 4;
    const int rows_l = (group + 1) / 2;  // warp-uniform
    float* pw = scratch + warp * S::kScratch;  // [row][key], then alpha
    float acc[kDecodeMaxGroup][kCols];
#pragma unroll
    for (int r = 0; r < kDecodeMaxGroup; ++r)
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
    float m[kRowsL], l[kRowsL];
#pragma unroll
    for (int i = 0; i < kRowsL; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
    }

    ring_loop<T, D, kTile, kStages, kDecodeThreads>(
        ring, rows, t0, t1, k_lo, k_hi,
        [&](int j0, const T* ks, const T* vs) {
          float s[kRowsL] = {};
          const T* kr = ks + (key0 + kl) * kStride;
#pragma unroll 4
          for (int part = 0; part < D; part += kVec) {
            float kf[kVec];
            Elem<T>::unpack(*reinterpret_cast<const uint4*>(kr + part), kf);
#pragma unroll
            for (int i = 0; i < kRowsL; ++i) {
              if (i >= rows_l) break;
              const float4* qr = reinterpret_cast<const float4*>(
                  qs + (half + 2 * i) * D + part);
#pragma unroll
              for (int e = 0; e < kVec / 4; ++e) {
                const float4 qv = qr[e];
                s[i] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] +
                        qv.z * kf[4 * e + 2] + qv.w * kf[4 * e + 3];
              }
            }
          }
          const int col = j0 + key0 + kl;
          const bool live = col >= lo && col < hi;
#pragma unroll
          for (int i = 0; i < kRowsL; ++i) {
            if (i >= rows_l) break;
            float x = s[i] * scale;
            if constexpr (kCap) x = softcap(x, io.cap2, io.inv_cap2);
            x = live ? x : -INFINITY;
            float mx = x;
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
              mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
            const float mn = fmaxf(m[i], mx);
            const float base = mn == -INFINITY ? 0.f : mn;
            const float alpha = exp2f(m[i] - base);
            const float p = exp2f(x - base);
            float sum = p;
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
              sum += __shfl_xor_sync(kFull, sum, off);
            m[i] = mn;
            l[i] = l[i] * alpha + sum;
            const int r = half + 2 * i;
            pw[r * kWarpKeys + kl] = p;
            if (kl == 0) pw[kDecodeMaxGroup * kWarpKeys + r] = alpha;
          }
          __syncwarp();
#pragma unroll
          for (int r = 0; r < kDecodeMaxGroup; ++r) {
            if (r >= group) break;
            const float alpha = pw[kDecodeMaxGroup * kWarpKeys + r];
#pragma unroll
            for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
          }
#pragma unroll 4
          for (int j = 0; j < kWarpKeys; ++j) {
            float vf[kCols];
            const T* vr = vs + (key0 + j) * kStride + lane * kCols;
            if constexpr (kCols == 1) {  // D 32: a column a lane
              vf[0] = Elem<T>::one(vr);
            } else {
#pragma unroll
              for (int c = 0; c < kCols; c += 2) {
                const float2 x = Elem<T>::pair(vr + c);
                vf[c] = x.x;
                vf[c + 1] = x.y;
              }
            }
#pragma unroll
            for (int r = 0; r < kDecodeMaxGroup; ++r) {
              if (r >= group) break;
              const float p = pw[r * kWarpKeys + j];
#pragma unroll
              for (int c = 0; c < kCols; ++c) acc[r][c] += p * vf[c];
            }
          }
          __syncwarp();  // pw is rewritten by the next tile
        });

    const int w = warp * kDecodeMaxGroup;
#pragma unroll
    for (int i = 0; i < kRowsL; ++i) {
      const int r = half + 2 * i;
      if (kl == 0 && r < group) {
        cm[w + r] = m[i];
        cl[w + r] = l[i];
      }
    }
#pragma unroll
    for (int r = 0; r < kDecodeMaxGroup; ++r) {
      if (r >= group) break;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        ca[(w + r) * S::kCombStride + lane * kCols + c] = acc[r][c];
    }
  }
  __syncthreads();

  // Combine the warps: each row's max, then its rescaled sums.
  for (int i = tid; i < group * (D / 2); i += kDecodeThreads) {
    const int r = i / (D / 2), c = 2 * (i % (D / 2));
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w)
      mx = fmaxf(mx, cm[w * kDecodeMaxGroup + r]);
    float sum = 0.f, a0 = 0.f, a1 = 0.f;
    if (mx != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kDecodeWarps; ++w) {
        const int wr = w * kDecodeMaxGroup + r;
        const float f = exp2f(cm[wr] - mx);
        const float2 x =
            *reinterpret_cast<const float2*>(ca + wr * S::kCombStride + c);
        sum += f * cl[wr];
        a0 += f * x.x;
        a1 += f * x.y;
      }
    }
    const float inv = sum > 0.f ? out_scale / sum : 0.f;
    const float lse2 = sum > 0.f ? mx + log2f(sum) : -INFINITY;
    if (io.splits == 1) {
      T* orow = io.o + (q_row + r) * D + c;
      orow[0] = from_float<T>(a0 * inv);
      orow[1] = from_float<T>(a1 * inv);
      if (c == 0) io.lse[q_row + r] = lse2 * kLn2;
    } else {
      *reinterpret_cast<float2*>(io.part_o + (p_row + r) * D + c) =
          make_float2(a0 * inv, a1 * inv);
      if (c == 0) io.part_lse[p_row + r] = lse2;
    }
  }
}

// Launch the decode kernel on grid (splits, kv_heads, batch), then, when
// there is more than one split, the merge.  Returns cudaGetLastError().
template <typename T, int D, class KV, int P = kUnquantized,
          bool kCap = false>
int launch_decode(const DecodeIO<T>& io, const KV& kv, int batch,
                  int pages_cap, cudaStream_t stream) {
  const size_t smem = DecodeSmem<T, D, KV, P>::bytes(pages_cap);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode90_kernel<T, D, KV, P, kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_decode90_kernel<T, D, KV, P, kCap>
      <<<dim3(io.splits, io.kv_heads, batch), kDecodeThreads, smem,
         stream>>>(io, kv);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || io.splits == 1) return (int)e;
  merge_splits<T, D>(io.part_o, io.part_lse, io.o, io.lse,
                     io.q_heads / io.kv_heads, io.kv_heads, batch,
                     io.splits, stream);
  return (int)cudaGetLastError();
}

}  // namespace mfa
