// Helpers shared by the port's attention kernels (sm_90a): the tensor-core
// tile product, fragment packing, exp2, quad reductions and the lse merge
// of split-KV partials.
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
  static_assert(kCols == 2 || kCols == 4, "D 64 or 128");
  using Vec = typename std::conditional<kCols == 4, float4, float2>::type;
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kMergeRows + threadIdx.x / 32;
  if (r >= rows) return;
  const size_t head = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const size_t base = head * splits;
  float mx = -INFINITY, sum = 0.f, acc[kCols] = {};
  for (int s0 = 0; s0 < splits; s0 += kMergeSplits) {
    float l[kMergeSplits];
    Vec x[kMergeSplits];
#pragma unroll
    for (int j = 0; j < kMergeSplits; ++j) {
      const size_t pr = (base + s0 + j) * rows + r;
      const bool in = s0 + j < splits;
      l[j] = in ? part_lse[pr] : -INFINITY;
      x[j] = in ? *reinterpret_cast<const Vec*>(part_o + pr * D +
                                                lane * kCols)
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
      const float* xj = reinterpret_cast<const float*>(&x[j]);
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
