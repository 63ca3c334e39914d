// Helpers shared by the port's attention kernels (sm_90a): the tensor-core
// tile product, fragment packing, exp2, the logit soft cap, quad reductions
// and the lse merge of split-KV partials.
//
// Fragment layout of mma.sync m16n8k16 (row.col), for lane
// (g = lane / 4, t4 = lane % 4):
//   A 16x16 row-major, 4 registers: A[g][2t4..], A[g+8][2t4..],
//     A[g][2t4+8..], A[g+8][2t4+8..] (two 16-bit values each);
//   B 16x8 "col", 2 registers: B[2t4..2t4+1][g], B[2t4+8..2t4+9][g];
//   C 16x8 fp32, 4 registers: C[g][2t4], C[g][2t4+1], C[g+8][2t4],
//     C[g+8][2t4+1].
// So the C tiles of two adjacent 8-column steps are, once packed, the A
// fragment of one 16-deep step: a score tile feeds the next product
// without a trip through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace mfa {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned kFull = 0xffffffffu;

// c += a * b on tensor cores, 16-bit inputs, fp32 accumulators.
template <typename T = __nv_bfloat16>
__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(
    float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(
    float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to T, packed lo | hi << 16 (one fragment register).
template <typename T = __nv_bfloat16>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                         float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit (flushes subnormals; 2^-inf = 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Gemma-2's logit soft cap on a logit already in the exp2 domain: cap *
// tanh(x / cap), cap = softcap * log2(e) (the same curve as softcap *
// tanh(s / softcap) on natural-unit logits), inv_cap = 1 / cap.  Applied
// to the fully scaled logit and before any mask: tanh(-inf) is -1, so a
// key masked first would keep the weight e^-softcap.  tanhf is the
// accurate one (2 ulp): tanh.approx.f32's ~2^-11 relative error moves
// exp2 of a saturated logit by percents.
__device__ __forceinline__ float softcap(float x, float cap, float inv_cap) {
  return cap * tanhf(x * inv_cap);
}

// Accumulator values of a wgmma (x: a thread's N / 2 of a 64 x N tile)
// rounded to T and packed as the A operand of an RS wgmma that contracts
// over those N columns: slice kk holds columns 16 kk .. 16 kk + 15, a[0]
// the thread's first row, a[1] the row 8 down, a[2] and a[3] their next 8
// columns.
template <typename T, int N>
__device__ __forceinline__ void pack_rs(uint32_t (&a)[N / 16][4],
                                        const float (&x)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack2<T>(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}

// A B-fragment register from two rows of a [rows][stride] 16-bit tile in
// shared memory, same column: B[k][n] = tile[k][n] (the "PV" operand).
__device__ __forceinline__ uint32_t rows_pair(const uint16_t* tile,
                                              int stride, int row,
                                              int col) {
  return (uint32_t)tile[row * stride + col] |
         ((uint32_t)tile[(row + 1) * stride + col] << 16);
}

// A fragment register from one row, two adjacent columns: B[k][n] =
// tile[n][k] (the "QK^T" operand) or an A-fragment pair.
__device__ __forceinline__ uint32_t cols_pair(const uint16_t* tile,
                                              int stride, int row,
                                              int col) {
  return *reinterpret_cast<const uint32_t*>(tile + row * stride + col);
}

// A float rounded to a kernel's storage type.
template <typename T>
__device__ __forceinline__ T from_float(float x);

template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half(x);
}

template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// The flash kernels' optional operands (the TPU kernels' mask, mask2,
// bias and segment-id refs; the kAux kernels), each null when absent.
// mask and mask2 are int8 [mask_b, mask_h, q_len, ld] (nonzero attends,
// the two ANDed), bias [bias_b, bias_h, q_len, ld] in the inputs' 16-bit
// type or float32 (bias_f32), natural units, where ld, the planes' row
// stride, is kv_len rounded up to a multiple of 16 (the wrapper pads), so
// that the two keys a thread holds side by side load as one and dK/dV
// copies whole 16-byte pieces of a row; (b, h) reads
// plane (b % *_b) * *_h + h % *_h, so a size-1 dim broadcasts and a
// divisor repeats.  q_seg [b, q_len] and kv_seg [b, kv_len] int32: a pair
// attends only where the ids are equal.  dbias (dQ only): float32 [b,
// q_heads, q_len, kv_len], dS in natural units before the cap's factor.
// The host passes this struct by pointer (ops/flash_attention.py's
// `AuxOperands` mirrors it); the kernels take it by value.
struct AuxOperands {
  const int8_t* mask;
  const int8_t* mask2;
  const void* bias;
  const int* q_seg;
  const int* kv_seg;
  float* dbias;
  int mask_b, mask_h, mask2_b, mask2_h, bias_b, bias_h;
  int bias_f32;
  int ld;
};

// What an absent mask or bias reads instead: every key attends, no bias.
__device__ __align__(16) const uint32_t kAuxAttend[2] = {0x01010101u,
                                                         0x01010101u};
__device__ __align__(16) const float kAuxNoBias[2] = {0.f, 0.f};

// How a launch reads mask, mask2 and bias, the same for every thread and
// chosen once a tile, outside the loops over its keys: kAuxNone (none of
// them: segments at most), kAuxPlanes16 (a 16-bit bias or none, with or
// without masks), kAuxPlanes32 (a float32 bias).  A null test or a
// branch on the operands inside a tile's unrolled loop splits it at each
// load and costs more than the loads (PERF.md, rows 2o-5o).
enum AuxMode { kAuxNone = 0, kAuxPlanes16 = 1, kAuxPlanes32 = 2 };

__device__ __forceinline__ int aux_mode(const AuxOperands& a) {
  if (!a.mask && !a.mask2 && !a.bias) return kAuxNone;
  return a.bias && a.bias_f32 ? kAuxPlanes32 : kAuxPlanes16;
}

// One (batch, q head, query) row's view of the planes.  An absent
// plane's view is the dummy above, which aux_index keeps at element 0.
// At query 0 it is the (batch, q head)'s planes, from which dK/dV copies
// a step's rows (t * ld + key).
struct AuxRow {
  const uint8_t* mask;
  const uint8_t* mask2;
  const void* bias;
};

__device__ __forceinline__ AuxRow aux_row(const AuxOperands& a, int b,
                                          int qh, int t, int q_len) {
  auto row = [&](int pb, int ph) {
    return ((size_t)((b % pb) * ph + qh % ph) * q_len + t) * a.ld;
  };
  const uint8_t* attend = reinterpret_cast<const uint8_t*>(kAuxAttend);
  AuxRow r;
  r.mask = a.mask ? reinterpret_cast<const uint8_t*>(a.mask) +
                        row(a.mask_b, a.mask_h)
                  : attend;
  r.mask2 = a.mask2 ? reinterpret_cast<const uint8_t*>(a.mask2) +
                          row(a.mask2_b, a.mask2_h)
                    : attend;
  r.bias = kAuxNoBias;
  if (a.bias) {
    const size_t at = row(a.bias_b, a.bias_h);
    r.bias = a.bias_f32
                 ? (const void*)(static_cast<const float*>(a.bias) + at)
                 : (const void*)(static_cast<const uint16_t*>(a.bias) + at);
  }
  return r;
}

// Query t's segment id in batch b (0 without segments).
__device__ __forceinline__ int aux_q_seg(const AuxOperands& a, int b,
                                         int t, int q_len) {
  return a.q_seg ? __ldg(a.q_seg + (size_t)b * q_len + t) : 0;
}

// Element i of a plane, or 0 of an absent one's dummy: no branch.
__device__ __forceinline__ size_t aux_index(const void* present, size_t i) {
  return present ? i : 0;
}

// A 16-bit value of type T widened.
template <typename T>
__device__ __forceinline__ float aux_widen(uint32_t x);

template <>
__device__ __forceinline__ float aux_widen<__nv_bfloat16>(uint32_t x) {
  return __uint_as_float(x << 16);
}

template <>
__device__ __forceinline__ float aux_widen<__half>(uint32_t x) {
  return __half2float(__ushort_as_half((unsigned short)x));
}

// What mask, mask2 and bias add to the logits (exp2 domain) of keys c
// and c + 1 of row r (c even, c + 1 < ld) in mode kMode (not kAuxNone):
// the bias times log2(e), or -inf where a mask gates the key off.  One
// load an operand for the two side-by-side keys, every load made, none
// behind a branch.  A gated logit is -inf where the TPU kernels take 1e30
// off it and multiply its p by the gate: both give p = 0, and a row left
// with no key keeps l = 0 (o = 0, lse = -inf).
template <typename T, int kMode>
__device__ __forceinline__ float2 aux_pair(const AuxRow& r,
                                           const AuxOperands& a, int c) {
  float2 add;
  if constexpr (kMode == kAuxPlanes32) {
    add = __ldg(reinterpret_cast<const float2*>(
        static_cast<const float*>(r.bias) + aux_index(a.bias, c)));
  } else {
    const uint32_t v = __ldg(reinterpret_cast<const unsigned int*>(
        static_cast<const uint16_t*>(r.bias) + aux_index(a.bias, c)));
    add = make_float2(aux_widen<T>(v & 0xffffu), aux_widen<T>(v >> 16));
  }
  const unsigned m = __ldg(reinterpret_cast<const unsigned short*>(
      r.mask + aux_index(a.mask, c)));
  const unsigned m2 = __ldg(reinterpret_cast<const unsigned short*>(
      r.mask2 + aux_index(a.mask2, c)));
  return make_float2((m & 0xffu) && (m2 & 0xffu) ? add.x * kLog2e : -INFINITY,
                     (m >> 8) && (m2 >> 8) ? add.y * kLog2e : -INFINITY);
}

// Segment ids over a tile of kKeys keys from c0, for the warp whose rows
// share it (the forward's and dQ's): each lane loads kKeys / 32 ids
// (kv_seg: the batch's; keys past kv_len read the last key's) before the
// tile's products are waited for, then `publish` writes them to the
// warp's scratch of kKeys ids and takes their range, so that a row whose
// id is the tile's only one tests no key, a row whose id lies outside the
// range drops every key, and only a tile with a segment boundary reads
// the scratch key by key.  No tile is skipped: the ids need not be
// sorted.
template <int kKeys>
struct SegTile {
  static constexpr int kPer = kKeys / 32;
  int ids[kPer];
  int lo, hi;

  __device__ __forceinline__ void load(const int* kv_seg, int c0, int kv_len,
                                       int lane) {
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      ids[u] = __ldg(kv_seg + min(c0 + kPer * lane + u, kv_len - 1));
  }

  __device__ __forceinline__ void publish(int* scratch, int lane) {
    __syncwarp();  // the warp's reads of the last tile are done
    lo = hi = ids[0];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      scratch[kPer * lane + u] = ids[u];
      lo = min(lo, ids[u]);
      hi = max(hi, ids[u]);
    }
    lo = __reduce_min_sync(kFull, lo);
    hi = __reduce_max_sync(kFull, hi);
    __syncwarp();
  }

  // 0: every key shares q_seg; 1: none does; 2: test each key.
  __device__ __forceinline__ int state(int q_seg) const {
    if (q_seg == lo && q_seg == hi) return 0;
    return q_seg < lo || q_seg > hi ? 1 : 2;
  }
};

// The options on x, a forward or dQ thread's logits of columns c and c + 1
// (c even; group j of its columns) of both its rows (x[2 h + {0, 1}] row
// h, whose view is ar[h]): in mode kMode, mask, mask2 and bias (keys past
// c_last, the planes' last even key, read c_last's); then the segments,
// by each row's SegTile::state st[h] and segment id q_seg[h] (seg: the
// warp's scratch of the tile's ids, offset to the thread's first column;
// read also where the launch has no segments, when st is 0 and the value
// unused).
template <typename T, int kMode>
__device__ __forceinline__ void aux_tile_pair(const AuxRow (&ar)[2],
                                              const AuxOperands& a,
                                              const int* seg,
                                              const int (&st)[2],
                                              const int (&q_seg)[2],
                                              int c_last, float (&x)[4],
                                              int c, int j) {
  if constexpr (kMode != kAuxNone) {
    const int cc = min(c, c_last);
    float2 add[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) add[h] = aux_pair<T, kMode>(ar[h], a, cc);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[2 * h] += add[h].x;
      x[2 * h + 1] += add[h].y;
    }
  }
  const int2 k = *reinterpret_cast<const int2*>(seg + 8 * j);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool mixed = st[h] == 2, none = st[h] == 1;
    if (none || (mixed && k.x != q_seg[h])) x[2 * h] = -INFINITY;
    if (none || (mixed && k.y != q_seg[h])) x[2 * h + 1] = -INFINITY;
  }
}

// The visible-key rule of every flash kernel (forward, dQ, dK/dV; bf16,
// fp16 and float32): causal masking aligned bottom-right (offset = kv_len
// - q_len, query t at position t + offset sees keys c <= t + offset), a
// window w keeping keys c > t + offset - w, with or without causal.
//
// A row at position qpos sees keys [lo, hi] (empty when lo > hi).
__device__ __forceinline__ void row_keys(int qpos, int kv_len, bool causal,
                                         int window, int& lo, int& hi) {
  hi = causal ? min(qpos, kv_len - 1) : kv_len - 1;
  lo = window > 0 ? qpos - window + 1 : 0;
}

// The query positions [t_min, t_max] of group-major rows [r0, r_last] of
// a kv head (row g * q_len + t is query t of the group's q head g): the
// rows' own when they lie in one q head, else every position.
__device__ __forceinline__ void row_positions(int r0, int r_last, int q_len,
                                              int& t_min, int& t_max) {
  t_min = 0;
  t_max = q_len - 1;
  if (r0 / q_len == r_last / q_len) {
    t_min = r0 % q_len;
    t_max = r_last % q_len;
  }
}

// The key tiles of `tile` keys that query positions [t_min, t_max] can
// see, [n_lo, n_hi) (n_lo == n_hi: none), so that a key loop visits the
// visible tiles and no others.
__device__ __forceinline__ void visible_key_tiles(int t_min, int t_max,
                                                  int q_len, int kv_len,
                                                  bool causal, int window,
                                                  int tile, int& n_lo,
                                                  int& n_hi) {
  const int offset = kv_len - q_len;
  const int col_hi = causal ? min(kv_len - 1, offset + t_max) : kv_len - 1;
  const int col_lo = window > 0 ? max(0, offset + t_min - window + 1) : 0;
  n_lo = col_lo / tile;
  n_hi = col_hi >= col_lo ? col_hi / tile + 1 : n_lo;
}

// The query tiles of `tile` rows of one q head whose positions see a key
// of [j0, j_last], [m_lo, m_hi) (m_lo == m_hi: none).
__device__ __forceinline__ void visible_query_tiles(int j0, int j_last,
                                                    int q_len, int kv_len,
                                                    bool causal, int window,
                                                    int tile, int& m_lo,
                                                    int& m_hi) {
  const int offset = kv_len - q_len;
  const int t_lo = causal ? max(0, j0 - offset) : 0;
  const int t_hi = window > 0 ? min(q_len - 1, j_last - offset + window - 1)
                              : q_len - 1;
  m_lo = t_lo / tile;
  m_hi = t_hi >= t_lo ? t_hi / tile + 1 : m_lo;
}

// A forward lse (natural log) in base 2 for the backward's recomputed P;
// a row that saw no key (lse = -inf) reads 0, so that its P, masked
// everywhere, is exactly 0 and never NaN.
__device__ __forceinline__ float lse_base2(float lse) {
  return lse == -INFINITY ? 0.f : lse * kLog2e;
}

// The second launch of a split-KV kernel: merge each row's `splits`
// normalized float32 partials by their base-2 lse.  part_o is [batch,
// kv_heads, splits, rows, D] and part_lse [batch, kv_heads, splits, rows];
// row r of kv head h is row h * rows + r of o [batch, kv_heads * rows, D]
// and of lse (natural log).  A split that saw no key writes lse = -inf and
// a zero part_o, and weighs 0; a row that no split saw gives o = 0 and
// lse = -inf.
//
// One warp a row, kMergeRows rows a block, grid (cdiv(rows, kMergeRows),
// kv_heads, batch); each lane owns D / 32 columns.  The kernel is a chain
// of memory round trips, so it keeps them few: it reads eight splits'
// lse and partials at once and folds them into a running (max, sum, acc),
// so a row of up to eight splits is one round trip.
constexpr int kMergeRows = 4;
constexpr int kMergeSplits = 8;

template <typename T, int D>
__global__ void __launch_bounds__(32 * kMergeRows)
merge_splits_kernel(const float* part_o, const float* part_lse, T* o,
                    float* lse, int rows, int splits) {
  constexpr int kCols = D / 32;  // a lane's columns
  static_assert(kCols == 1 || kCols == 2 || kCols == 4 || kCols == 8,
                "D 32, 64, 128 or 256");
  using Vec = typename std::conditional<
      kCols == 1, float,
      typename std::conditional<kCols == 2, float2, float4>::type>::type;
  constexpr int kVecs = kCols <= 2 ? 1 : kCols / 4;  // loads a lane
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kMergeRows + threadIdx.x / 32;
  if (r >= rows) return;
  const size_t head = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = head * splits;
  float mx = -INFINITY, sum = 0.f, acc[kCols] = {};
  for (int s0 = 0; s0 < splits; s0 += kMergeSplits) {
    float l[kMergeSplits];
    Vec x[kMergeSplits][kVecs];
#pragma unroll
    for (int j = 0; j < kMergeSplits; ++j) {
      const size_t pr = (base + s0 + j) * rows + r;
      const bool in = s0 + j < splits;
      l[j] = in ? part_lse[pr] : -INFINITY;
#pragma unroll
      for (int u = 0; u < kVecs; ++u)
        x[j][u] = in ? reinterpret_cast<const Vec*>(part_o + pr * D +
                                                    lane * kCols)[u]
                     : Vec{};
    }
    float m = mx;
#pragma unroll
    for (int j = 0; j < kMergeSplits; ++j) m = fmaxf(m, l[j]);
    if (m == -INFINITY) continue;
    const float alpha = exp2f(mx - m);
    mx = m;
    sum *= alpha;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kMergeSplits; ++j) {
      const float w = exp2f(l[j] - m);
      const float* xj = reinterpret_cast<const float*>(&x[j][0]);
      sum += w;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] += w * xj[c];
    }
  }
  const size_t row = head * rows + r;
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
  T* out = o + row * D + lane * kCols;
#pragma unroll
  for (int c = 0; c < kCols; ++c) out[c] = from_float<T>(acc[c] * inv);
  if (lane == 0) lse[row] = sum > 0.f ? (mx + log2f(sum)) * kLn2 : -INFINITY;
}

template <typename T, int D>
inline void merge_splits(const float* part_o, const float* part_lse, T* o,
                         float* lse, int rows, int kv_heads, int batch,
                         int splits, cudaStream_t stream) {
  merge_splits_kernel<T, D>
      <<<dim3((rows + kMergeRows - 1) / kMergeRows, kv_heads, batch),
         32 * kMergeRows, 0, stream>>>(part_o, part_lse, o, lse, rows,
                                       splits);
}

}  // namespace mfa
