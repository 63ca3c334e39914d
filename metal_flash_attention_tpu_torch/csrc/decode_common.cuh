// The pipelined split-KV core of the port's decode-family kernels (sm_90a):
// the cp.async K/V ring, the two ways to find a key row (a dense cache
// through its strides, a paged pool through its page table), and the
// one-token decode kernel that flash_decode.cu (dense) and
// paged_attention.cu (paged) instantiate.  paged_attention.cu's chunked-
// prefill kernel runs on the same ring and address policy.
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
// the input type before PV.  fp32 inputs run in true fp32 on CUDA cores in
// the same ring (never TF32).  The warps combine once, at the end, through
// shared memory.
//
// TMA is not used: a paged gather at any page size is not a tensor map,
// and a map encoded on the host per call costs host time that the decode
// step (host-bound, ~1,850 launches a step) does not have.

#pragma once

#include "attention_common.cuh"
#include "flash_tiles.cuh"

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

// 16 bytes of T as floats, and two adjacent values as a float2.
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

// --- finding a key row ---------------------------------------------------

// A dense cache [b, kv_heads, S, D] read in place through its batch, head
// and sequence strides (in elements).  Row b sees start <= pos < end (end =
// kv_lens[b] or S; with max_span at most start + max_span).
template <typename T>
struct DenseKV {
  static constexpr bool kPaged = false;
  static constexpr int kStages = MFA_DECODE_STAGES;  // of the decode ring
  const T* k;
  const T* v;
  const int* lens;    // [b] or null (S)
  const int* starts;  // [b] or null (0)
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int seq, max_span;

  struct Rows {
    const T* k;
    const T* v;
    long long k_ss, v_ss;
    __device__ void find(int pos, const T*& kr, const T*& vr) const {
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

// A paged pool [pages, kv_heads, page_size, D] (bf16) through the page
// table [b, max_pages]; row b's keys are 0 .. lengths[b] - 1, and a decode
// row sees the last `window` of them (window <= 0: all).
struct PagedKV {
  static constexpr bool kPaged = true;
  static constexpr int kStages = MFA_PAGED_STAGES;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const int* table;
  const int* lengths;
  int kv_heads, head_dim, page_size, max_pages, window;

  struct Rows {
    const __nv_bfloat16* k;  // pool + this head's first row of page 0
    const __nv_bfloat16* v;
    const int* pages;        // table entries first .. (shared memory)
    size_t page_elems;       // elements from one page to the next
    int first, page_size, head_dim;
    __device__ void find(int pos, const __nv_bfloat16*& kr,
                         const __nv_bfloat16*& vr) const {
      const int pg = pos / page_size;
      const size_t off = (size_t)pages[pg - first] * page_elems +
                         (size_t)(pos - pg * page_size) * head_dim;
      kr = k + off;
      vr = v + off;
    }
  };

  __device__ void range(int b, int& lo, int& hi) const {
    hi = lengths[b];
    lo = window > 0 ? max(0, hi - window) : 0;
  }

  // The table entries of keys [lo, hi) into `pages` (at most (hi - lo -
  // 1) / page_size + 2 of them, none past the table's row).
  __device__ void fetch(int b, int lo, int hi, int* pages) const {
    const int first = lo / page_size;
    const int last = min((hi - 1) / page_size, max_pages - 1);
    for (int i = threadIdx.x; i <= last - first; i += blockDim.x)
      pages[i] = table[(size_t)b * max_pages + first + i];
  }

  // Without a window a block's keys start where its chunk does, whatever
  // the sequence's length: fetch the chunk's entries [lo, hi) while the
  // length loads (entries past the live pages are read, never used).
  // True when it did.
  __device__ bool prefetch(int b, int lo, int hi, int* pages) const {
    if (window > 0) return false;
    fetch(b, lo, hi, pages);
    return true;
  }

  // The rows of keys [lo, hi) (lo < hi), whose table entries are fetched
  // here unless `prefetched` (then lo is the prefetch's start).  The
  // caller syncs the block before the first copy.
  __device__ Rows rows(int b, int h, int* pages, int lo, int hi,
                       bool prefetched) const {
    if (!prefetched) fetch(b, lo, hi, pages);
    const size_t head = (size_t)h * page_size * head_dim;
    return {k + head, v + head, pages,
            (size_t)kv_heads * page_size * head_dim, lo / page_size,
            page_size, head_dim};
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
};

template <typename T, int D, class KV>
struct DecodeSmem {
  using R = Ring<T, D, kDecodeTile, KV::kStages>;
  static constexpr bool kMma =
      !std::is_same<T, float>::value && MFA_DECODE_MMA != 0;
  // The warps' (m, l) and acc, once the ring is drained: [warp][row], and
  // [warp][row][D + 8] (8 floats of padding: the rows' float2 stores fall
  // in two wavefronts).
  static constexpr int kCombStride = D + 8;
  static constexpr size_t kCombBytes =
      sizeof(float) * kDecodeWarps * kDecodeMaxGroup * (2 + kCombStride);
  // CUDA-core path: q in float32, and each warp's P [16 rows][16 keys]
  // with the tile's rescale of each row.
  static constexpr size_t kQBytes =
      kMma ? 0 : sizeof(float) * kDecodeMaxGroup * D;
  static constexpr int kScratch = kDecodeMaxGroup * (kWarpKeys + 1);
  static constexpr size_t kScratchBytes =
      kMma ? 0 : sizeof(float) * kDecodeWarps * kScratch;
  static_assert(kCombBytes <= R::kBytes, "the combine fits the ring");
  static size_t bytes(int pages_cap) {
    return R::kBytes + kQBytes + kScratchBytes + sizeof(int) * pages_cap;
  }
};

// One block: the group's rows of (sequence b, kv head h) against the
// chunk of key tiles of split blockIdx.x.  Writes o and lse when the call
// has one split, else its normalized float32 partial and base-2 lse.
template <typename T, int D, class KV>
__global__ void __launch_bounds__(kDecodeThreads)
flash_decode90_kernel(DecodeIO<T> io, KV kv) {
  using S = DecodeSmem<T, D, KV>;
  using R = typename S::R;
  constexpr int kTile = kDecodeTile, kStages = R::kStages;
  constexpr int kStride = R::kStride;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* qs = reinterpret_cast<float*>(smem + R::kBytes);
  float* scratch = reinterpret_cast<float*>(smem + R::kBytes + S::kQBytes);
  int* pages = reinterpret_cast<int*>(smem + R::kBytes + S::kQBytes +
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
  int lo, hi;
  kv.range(b, lo, hi);
  const int first = lo / kTile;
  const int last = hi > lo ? (hi + kTile - 1) / kTile : first;
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
  const float scale = io.scale_log2e;
  const int key0 = warp * kWarpKeys;

  if constexpr (S::kMma) {
    // Lane (g, t4) holds rows g and g + 8 of the fragments; rows past the
    // group are zero.
    const int g = lane / 4, t4 = lane % 4;
    uint32_t qf[D / 16][4];
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qf[kk][0] = g < group ? ld_u32(q + g * D + c) : 0u;
      qf[kk][1] = g + 8 < group ? ld_u32(q + (g + 8) * D + c) : 0u;
      qf[kk][2] = g < group ? ld_u32(q + g * D + c + 8) : 0u;
      qf[kk][3] = g + 8 < group ? ld_u32(q + (g + 8) * D + c + 8) : 0u;
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

    ring_loop<T, D, kTile, kStages, kDecodeThreads>(
        ring, rows, t0, t1, k_lo, k_hi,
        [&](int j0, const T* ks, const T* vs) {
          float s[2][4] = {};
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t kb[4];
            ldsm_x4(kb, ks + k_off + kk * 16);
            mma_16816<T>(s[0], qf[kk], kb[0], kb[1]);
            mma_16816<T>(s[1], qf[kk], kb[2], kb[3]);
          }
          const bool edge = j0 < lo || j0 + kTile > hi;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = j0 + key0 + nt * 8 + 2 * t4 + (e & 1);
              s[nt][e] = !edge || (col >= lo && col < hi)
                             ? s[nt][e] * scale : -INFINITY;
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
        });

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
            const float x = live ? s[i] * scale : -INFINITY;
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
#pragma unroll
            for (int c = 0; c < kCols; c += 2) {
              const float2 x = Elem<T>::pair(vr + c);
              vf[c] = x.x;
              vf[c + 1] = x.y;
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
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
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
template <typename T, int D, class KV>
int launch_decode(const DecodeIO<T>& io, const KV& kv, int batch,
                  int pages_cap, cudaStream_t stream) {
  const size_t smem = DecodeSmem<T, D, KV>::bytes(pages_cap);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode90_kernel<T, D, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  flash_decode90_kernel<T, D, KV>
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
