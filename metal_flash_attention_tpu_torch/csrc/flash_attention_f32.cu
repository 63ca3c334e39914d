// True-fp32 flash attention for NVIDIA Hopper (sm_90a), plain C interface:
// the forward, dQ and dK/dV on CUDA cores.
//
// Replaces the float32 path of four TPU kernels, which the JAX package runs
// at Precision.HIGHEST (true fp32):
//   metal_flash_attention_tpu/ops/flash_attention.py
//     _make_fwd_kernel          (:223, pallas_call at :1253) and
//     _make_fwd_kernel_dynamic  (:552, pallas_call at :1097): one kernel
//                               whose key loop visits only the visible
//                               key tiles, as the 16-bit forward's;
//   metal_flash_attention_tpu/ops/flash_attention_bwd.py
//     _make_dq_kernel   (:73, pallas_call at :587);
//     _make_dkv_kernel  (:226, pallas_call at :700), the GQA group summed
//                       inside the kernel, no atomics.
// The 16-bit kernels (flash_attention.cu, flash_attention_bwd.cu) cannot
// carry float32: Hopper's wgmma takes 32-bit inputs only as TF32, which
// keeps 10 mantissa bits.  Every product here is an FFMA in full float32;
// nothing is rounded to TF32 or split into TF32 pieces.  The softmax runs
// in the exp2 domain with scale * log2(e) folded into the scores, as the
// 16-bit kernels do (ex2.approx, ~2 ulp).
//
// The functions: q [b, q_heads, q_len, D], k/v [b, kv_heads, kv_len, D]
// float32 (GQA: q head h reads kv head h / group), D 32, 64, 128 or 256;
// causal aligned bottom-right, a window, Gemma-2's soft cap (the TPU
// kernels' :339-340; t = tanh(s / c) and s = c t before the mask, dS
// times 1 - t^2 in the backward), the visible-key rule of
// attention_common.cuh (`row_keys`, `visible_key_tiles`,
// `visible_query_tiles`) shared with the 16-bit kernels.  The forward
// writes a float32 O and the natural-log lse; a row that sees no key gives
// o = 0 and lse = -inf.  dQ reads the given lse and D = rowsum(dO * O).
// The options (mask, bias, segments) and quantized K/V are not taken.
//
// Bound: 4 D FLOPs a visible (row, key) pair in the forward, 6 D in dQ
// and 8 D in dK/dV, against a few hundred MB: at the training shapes the
// card's float32 rate (67 TFLOP/s on CUDA cores) bounds all three.  The
// design is the simple one:
// - 256 threads a block as a 16 x 16 grid (ty, tx).  A block takes 64
//   group-major query rows of one kv head (row g * q_len + t is query t
//   of q head h * group + g), so one K/V tile serves the group; dK/dV
//   takes a block of keys and loops over the group's q heads.  Each
//   thread owns a register micro-tile: rows ty * RM .. + RM - 1 of the
//   block, keys tx + 16 j of a score tile, and columns 4 tx + 64 g .. + 3
//   (2 tx, 2 tx + 1 at D 32) of an output tile.
// - Operands stream through shared memory by 16-byte cp.async copies
//   (rows past the tensor zero-filled) into a ring of MFA_F32_STAGES
//   stages, rows padded by 4 floats so that the 8 lanes of a quarter warp
//   reading keys tx + 16 j hit 8 different bank groups.
// - Scores S = A B^T (`scores`) read float4s of both operands along D;
//   P or dS goes to a shared scratch tile, and the output product
//   (`accumulate`) reads it by rows (a broadcast) against the operand's
//   rows (contiguous float4s).
// - Row maxima and sums are reduced over the 16 lanes of a row by
//   shuffles; each thread keeps a partial l and the row's m.
// - Causal grids take the heaviest row tiles first.
// Every launcher returns cudaGetLastError() after its launch.

#include <type_traits>

#include "attention_common.cuh"
#include "decode_common.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace mfa;

constexpr int kThreads = 256;  // a 16 x 16 grid of threads
constexpr int kStages = MFA_F32_STAGES;
static_assert(kStages >= 2, "a ring");

// The tiles at head dim D: query rows a forward / dQ block and the keys of
// its tiles; keys a dK/dV block and the query rows of its steps.
template <int D>
struct F32Tiles {
  static constexpr bool kWide = D > 128;
  static constexpr int kFwdRows = MFA_F32_BLOCK_Q;
  static constexpr int kFwdKeys = kWide ? MFA_F32_D256_FWD_BLOCK_KV
                                        : MFA_F32_BLOCK_KV;
  static constexpr int kDqKeys = kWide ? MFA_F32_D256_DQ_BLOCK_KV
                                       : MFA_F32_BLOCK_KV;
  static constexpr int kDkvKeys = kWide ? MFA_F32_D256_DKV_BLOCK_KV
                                        : MFA_F32_DKV_BLOCK_KV;
  static constexpr int kDkvRows = MFA_F32_DKV_BLOCK_Q;
  static constexpr int kLd = D + 4;  // a padded row in shared memory
  static constexpr int kCols = D / 16;  // a thread's output columns
  static_assert(D == 32 || D == 64 || D == 128 || D == 256,
                "D 32, 64, 128 or 256");
  static_assert(kFwdRows % 16 == 0 && kFwdKeys % 16 == 0 &&
                    kDqKeys % 16 == 0 && kDkvKeys % 16 == 0 &&
                    kDkvRows % 16 == 0,
                "tiles of whole 16-lane rows and columns");
};

// Blocks an SM holds, for __launch_bounds__: two where two blocks' shared
// memory fits the SM's 228 KB (1 KB of it reserved a block), so that the
// registers are capped to match; else one.
__host__ __device__ constexpr int min_blocks(int bytes) {
  return 2 * (bytes + 1024) <= 233472 ? 2 : 1;
}

struct F32Params {
  int rows;  // group * q_len: the rows of one kv head
  int group, q_len, kv_len;
  float scale, scale_log2e;
  float cap2, inv_cap2;  // the soft cap in the exp2 domain
  int causal, window;
};

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [row0, row0 + kRows) of a [n][D] float32 matrix into a shared tile
// of kLd-float rows by 16-byte cp.async copies; rows >= n zero-filled.
// Not committed.
template <int D, int kRows>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int n, int tid) {
  constexpr int kPieces = D / 4;
  constexpr int kTotal = kRows * kPieces;
#pragma unroll
  for (int u = 0; u < (kTotal + kThreads - 1) / kThreads; ++u) {
    const int i = tid + u * kThreads;
    if (kTotal % kThreads == 0 || i < kTotal) {
      const int r = i / kPieces, c = i % kPieces * 4;
      const bool live = row0 + r < n;
      cp_async_16(dst + r * F32Tiles<D>::kLd + c,
                  src + (size_t)(live ? row0 + r : 0) * D + c, live);
    }
  }
}

// kN floats [row0, row0 + kN) of a vector into shared memory by 4-byte
// cp.async copies, entry i by the thread whose `lane` is i (lanes outside
// [0, kN) copy nothing); entries >= n zero-filled.  Not committed.
template <int kN>
__device__ __forceinline__ void load_vector(float* dst, const float* src,
                                            int row0, int n, int lane) {
  if (lane >= 0 && lane < kN) {
    const bool live = row0 + lane < n;
    cp_async_4(dst + lane, src + (live ? row0 + lane : 0), live);
  }
}

// s[i][j] = sum_d A[ty RM + i][d] B[tx + 16 j][d]: RM rows of A, RN rows
// of B, both shared tiles of kLd-float rows.
template <int D, int RM, int RN>
__device__ __forceinline__ void scores(float (&s)[RM][RN], const float* a,
                                       const float* b, int ty, int tx) {
  constexpr int kLd = F32Tiles<D>::kLd;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * RM + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < RN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        s[i][j] = fmaf(av[i].x, bv[j].x, s[i][j]);
        s[i][j] = fmaf(av[i].y, bv[j].y, s[i][j]);
        s[i][j] = fmaf(av[i].z, bv[j].z, s[i][j]);
        s[i][j] = fmaf(av[i].w, bv[j].w, s[i][j]);
      }
  }
}

// A thread's D / 16 columns of a shared row: 4 tx + 64 g + {0..3}, or 2 tx
// + {0, 1} at D 32.
template <int D>
__device__ __forceinline__ void row_cols(float (&x)[D / 16], const float* row,
                                         int tx) {
  if constexpr (D == 32) {
    const float2 t = *reinterpret_cast<const float2*>(row + 2 * tx);
    x[0] = t.x;
    x[1] = t.y;
  } else {
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 t =
          *reinterpret_cast<const float4*>(row + 4 * tx + 64 * g);
      x[4 * g] = t.x;
      x[4 * g + 1] = t.y;
      x[4 * g + 2] = t.z;
      x[4 * g + 3] = t.w;
    }
  }
}

// acc[i][c] += sum_k P[ty RM + i][k] V[k][col c]: P a shared [16 RM][kN +
// 4] scratch, V a shared tile of kN rows of kLd floats.
template <int D, int RM, int kN>
__device__ __forceinline__ void accumulate(float (&acc)[RM][D / 16],
                                           const float* p, const float* v,
                                           int ty, int tx) {
  constexpr int kLd = F32Tiles<D>::kLd;
#pragma unroll 2
  for (int k = 0; k < kN; k += 4) {
    float4 pv[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      pv[i] = *reinterpret_cast<const float4*>(p + (ty * RM + i) * (kN + 4) +
                                               k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float x[D / 16];
      row_cols<D>(x, v + (k + kk) * kLd, tx);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float w = lane_of(pv[i], kk);
#pragma unroll
        for (int c = 0; c < D / 16; ++c) acc[i][c] = fmaf(w, x[c], acc[i][c]);
      }
    }
  }
}

// A thread's columns of one output row, times `mul`, to global memory.
template <int D>
__device__ __forceinline__ void store_cols(float* row, const float (&x)[D / 16],
                                           float mul, int tx) {
  if constexpr (D == 32) {
    *reinterpret_cast<float2*>(row + 2 * tx) =
        make_float2(x[0] * mul, x[1] * mul);
  } else {
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      *reinterpret_cast<float4*>(row + 4 * tx + 64 * g) =
          make_float4(x[4 * g] * mul, x[4 * g + 1] * mul, x[4 * g + 2] * mul,
                      x[4 * g + 3] * mul);
  }
}

// The row tile that block x of `tiles` takes: causal work grows with a
// row's position, so the heaviest tiles go first (by descending position
// across the group's heads when the tiles align with them, else in
// reverse order).
template <int kRows>
__device__ __forceinline__ int row_tile(const F32Params& p, int x,
                                        int tiles) {
  if (!p.causal) return x;
  if (p.q_len % kRows) return tiles - 1 - x;
  const int per = p.q_len / kRows;
  return x % p.group * per + per - 1 - x / p.group;
}

// ---- forward ------------------------------------------------------------

template <int D>
struct FwdSmem {
  using Tl = F32Tiles<D>;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + Tl::kFwdRows * Tl::kLd;
  static constexpr int kV = kK + kStages * Tl::kFwdKeys * Tl::kLd;
  static constexpr int kP = kV + kStages * Tl::kFwdKeys * Tl::kLd;
  static constexpr int kFloats = kP + Tl::kFwdRows * (Tl::kFwdKeys + 4);
  static constexpr int kBytes = kFloats * 4;
  static_assert(kBytes <= 232448, "an H100 block's shared memory");
};

// Grid (row tiles of kFwdRows, kv_heads, batch), kThreads threads,
// FwdSmem<D>::kBytes of dynamic shared memory.  o [b, kv_heads, rows, D]
// (the q heads' rows, group-major), lse [b, kv_heads, rows].
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, min_blocks(FwdSmem<D>::kBytes))
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, const F32Params p) {
  using Tl = F32Tiles<D>;
  using L = FwdSmem<D>;
  constexpr int kRows = Tl::kFwdRows, kKeys = Tl::kFwdKeys, kLd = Tl::kLd;
  constexpr int RM = kRows / 16, RN = kKeys / 16, kC = Tl::kCols;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem + L::kQ;
  float* ps = smem + L::kP;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int r0 = row_tile<kRows>(p, blockIdx.x, gridDim.x) * kRows;
  const bool causal = p.causal != 0;
  const int offset = p.kv_len - p.q_len;
  int t_min, t_max, n_lo, n_hi;
  row_positions(r0, min(r0 + kRows, p.rows) - 1, p.q_len, t_min, t_max);
  visible_key_tiles(t_min, t_max, p.q_len, p.kv_len, causal, p.window, kKeys,
                    n_lo, n_hi);
  const int n_tiles = n_hi - n_lo;
  const float* kh = k + bh * p.kv_len * D;
  const float* vh = v + bh * p.kv_len * D;

  // Loop step i takes key tile n_hi - 1 - i, into stage i % kStages.
  auto load_tile = [&](int i) {
    const int s = i % kStages, j0 = (n_hi - 1 - i) * kKeys;
    load_rows<D, kKeys>(smem + L::kK + s * kKeys * kLd, kh, j0, p.kv_len,
                        tid);
    load_rows<D, kKeys>(smem + L::kV + s * kKeys * kLd, vh, j0, p.kv_len,
                        tid);
  };
  load_rows<D, kRows>(qs, q + bh * p.rows * D, r0, p.rows, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  int lo[RM], hi[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i)
    row_keys((r0 + ty * RM + i) % p.q_len + offset, p.kv_len, causal,
             p.window, lo[i], hi[i]);
  float m[RM], l[RM], acc[RM][kC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    // The tile kStages - 1 steps ahead goes into the stage that step t - 1
    // freed; then tile t is waited for.
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    float sc[RM][RN];
    scores<D, RM, RN>(sc, qs, smem + L::kK + s * kKeys * kLd, ty, tx);
    const int c0 = (n_hi - 1 - t) * kKeys + tx;
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float x = sc[i][j] * p.scale_log2e;
        if constexpr (kCap) x = softcap(x, p.cap2, p.inv_cap2);
        const int col = c0 + 16 * j;
        if (col < lo[i] || col > hi[i]) x = -INFINITY;
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float mn = fmaxf(m[i], max16(mx));
      const float base = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2_approx(m[i] - base);
      m[i] = mn;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < kC; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float pj = exp2_approx(sc[i][j] - base);
        l[i] += pj;
        ps[(ty * RM + i) * (kKeys + 4) + tx + 16 * j] = pj;
      }
    }
    __syncthreads();
    accumulate<D, RM, kKeys>(acc, ps, smem + L::kV + s * kKeys * kLd, ty, tx);
    __syncthreads();  // the stage and P are free again
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const float sum = sum16(l[i]);
    const int row = r0 + ty * RM + i;
    if (row >= p.rows) continue;
    const size_t at = bh * p.rows + row;
    if (tx == 0)
      lse[at] = sum > 0.f ? (m[i] + log2f(sum)) * kLn2 : -INFINITY;
    store_cols<D>(o + at * D, acc[i], sum > 0.f ? 1.f / sum : 0.f, tx);
  }
}

// ---- dQ -------------------------------------------------------------------

template <int D>
struct DqSmem {
  using Tl = F32Tiles<D>;
  static constexpr int kQ = 0;
  static constexpr int kDo = kQ + Tl::kFwdRows * Tl::kLd;
  static constexpr int kK = kDo + Tl::kFwdRows * Tl::kLd;
  static constexpr int kV = kK + kStages * Tl::kDqKeys * Tl::kLd;
  static constexpr int kDs = kV + kStages * Tl::kDqKeys * Tl::kLd;
  static constexpr int kFloats = kDs + Tl::kFwdRows * (Tl::kDqKeys + 4);
  static constexpr int kBytes = kFloats * 4;
  static_assert(kBytes <= 232448, "an H100 block's shared memory");
};

// Grid (row tiles of kFwdRows, kv_heads, batch), kThreads threads,
// DqSmem<D>::kBytes.  For each key tile: S = Q K^T and dP = dO V^T, P =
// exp2(S scale log2(e) - L log2(e)) (capped: t = tanh(x / c2), x = c2 t),
// dS = P (dP - D) (capped: times 1 - t^2), dQ += dS K; dQ *= scale.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, min_blocks(DqSmem<D>::kBytes))
flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dterm,
                        float* __restrict__ dq, const F32Params p) {
  using Tl = F32Tiles<D>;
  using L = DqSmem<D>;
  constexpr int kRows = Tl::kFwdRows, kKeys = Tl::kDqKeys, kLd = Tl::kLd;
  constexpr int RM = kRows / 16, RN = kKeys / 16, kC = Tl::kCols;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ds = smem + L::kDs;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int r0 = row_tile<kRows>(p, blockIdx.x, gridDim.x) * kRows;
  const bool causal = p.causal != 0;
  const int offset = p.kv_len - p.q_len;
  int t_min, t_max, n_lo, n_hi;
  row_positions(r0, min(r0 + kRows, p.rows) - 1, p.q_len, t_min, t_max);
  visible_key_tiles(t_min, t_max, p.q_len, p.kv_len, causal, p.window, kKeys,
                    n_lo, n_hi);
  const int n_tiles = n_hi - n_lo;
  const float* kh = k + bh * p.kv_len * D;
  const float* vh = v + bh * p.kv_len * D;

  auto load_tile = [&](int i) {
    const int s = i % kStages, j0 = (n_hi - 1 - i) * kKeys;
    load_rows<D, kKeys>(smem + L::kK + s * kKeys * kLd, kh, j0, p.kv_len,
                        tid);
    load_rows<D, kKeys>(smem + L::kV + s * kKeys * kLd, vh, j0, p.kv_len,
                        tid);
  };
  load_rows<D, kRows>(smem + L::kQ, q + bh * p.rows * D, r0, p.rows, tid);
  load_rows<D, kRows>(smem + L::kDo, dout + bh * p.rows * D, r0, p.rows, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_tiles) load_tile(i);
    cp_async_commit();
  }

  int lo[RM], hi[RM];
  float l2[RM], dt[RM], acc[RM][kC];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + ty * RM + i;
    row_keys(row % p.q_len + offset, p.kv_len, causal, p.window, lo[i],
             hi[i]);
    const size_t at = bh * p.rows + row;
    l2[i] = row < p.rows ? lse_base2(__ldg(lse + at)) : 0.f;
    dt[i] = row < p.rows ? __ldg(dterm + at) : 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* ks = smem + L::kK + s * kKeys * kLd;
    float sc[RM][RN], dp[RM][RN];
    scores<D, RM, RN>(sc, smem + L::kQ, ks, ty, tx);
    scores<D, RM, RN>(dp, smem + L::kDo, smem + L::kV + s * kKeys * kLd, ty,
                      tx);
    const int c0 = (n_hi - 1 - t) * kKeys + tx;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float x = sc[i][j] * p.scale_log2e, chain = 1.f;
        if constexpr (kCap) {
          const float th = tanhf(x * p.inv_cap2);
          x = p.cap2 * th;
          chain = 1.f - th * th;
        }
        const int col = c0 + 16 * j;
        const bool seen = col >= lo[i] && col <= hi[i];
        const float pj = seen ? exp2_approx(x - l2[i]) : 0.f;
        ds[(ty * RM + i) * (kKeys + 4) + tx + 16 * j] =
            pj * (dp[i][j] - dt[i]) * chain;
      }
    __syncthreads();
    accumulate<D, RM, kKeys>(acc, ds, ks, ty, tx);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = r0 + ty * RM + i;
    if (row < p.rows) store_cols<D>(dq + (bh * p.rows + row) * D, acc[i],
                                    p.scale, tx);
  }
}

// ---- dK / dV -------------------------------------------------------------

template <int D>
struct DkvSmem {
  using Tl = F32Tiles<D>;
  static constexpr int kK = 0;
  static constexpr int kV = kK + Tl::kDkvKeys * Tl::kLd;
  static constexpr int kQ = kV + Tl::kDkvKeys * Tl::kLd;
  static constexpr int kDo = kQ + kStages * Tl::kDkvRows * Tl::kLd;
  static constexpr int kL = kDo + kStages * Tl::kDkvRows * Tl::kLd;
  static constexpr int kDt = kL + kStages * Tl::kDkvRows;
  static constexpr int kPt = kDt + kStages * Tl::kDkvRows;
  static constexpr int kDst = kPt + Tl::kDkvKeys * (Tl::kDkvRows + 4);
  static constexpr int kFloats = kDst + Tl::kDkvKeys * (Tl::kDkvRows + 4);
  static constexpr int kBytes = kFloats * 4;
  static_assert(kBytes <= 232448, "an H100 block's shared memory");
};

// Grid (key tiles of kDkvKeys, kv_heads, batch), kThreads threads,
// DkvSmem<D>::kBytes.  The block keeps its keys' K and V and steps over
// the query tiles of kDkvRows rows that see them, q head by q head of the
// group: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T as dQ's, dV += P^T
// dO and dK += dS^T Q; dK *= scale.  The group is summed in the block's
// registers, so no atomics.
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, min_blocks(DkvSmem<D>::kBytes))
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dterm,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const F32Params p) {
  using Tl = F32Tiles<D>;
  using L = DkvSmem<D>;
  constexpr int kKeys = Tl::kDkvKeys, kRows = Tl::kDkvRows, kLd = Tl::kLd;
  constexpr int RM = kKeys / 16, RN = kRows / 16, kC = Tl::kCols;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* pt = smem + L::kPt;
  float* dst = smem + L::kDst;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const int j0 = blockIdx.x * kKeys;
  const bool causal = p.causal != 0;
  const int offset = p.kv_len - p.q_len;
  int m_lo, m_hi;
  visible_query_tiles(j0, min(j0 + kKeys, p.kv_len) - 1, p.q_len, p.kv_len,
                      causal, p.window, kRows, m_lo, m_hi);
  const int per = m_hi - m_lo;
  const int n_steps = p.group * per;

  // Step i: query tile m_lo + i % per of the group's q head i / per.
  auto load_step = [&](int i) {
    const int s = i % kStages, t0 = (m_lo + i % per) * kRows;
    const size_t head = bh * p.group + i / per;
    load_rows<D, kRows>(smem + L::kQ + s * kRows * kLd,
                        q + head * p.q_len * D, t0, p.q_len, tid);
    load_rows<D, kRows>(smem + L::kDo + s * kRows * kLd,
                        dout + head * p.q_len * D, t0, p.q_len, tid);
    load_vector<kRows>(smem + L::kL + s * kRows, lse + head * p.q_len, t0,
                       p.q_len, tid);
    load_vector<kRows>(smem + L::kDt + s * kRows, dterm + head * p.q_len,
                       t0, p.q_len, tid - kRows);
  };
  load_rows<D, kKeys>(smem + L::kK, k + bh * p.kv_len * D, j0, p.kv_len, tid);
  load_rows<D, kKeys>(smem + L::kV, v + bh * p.kv_len * D, j0, p.kv_len, tid);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n_steps) load_step(i);
    cp_async_commit();
  }

  float ak[RM][kC], av[RM][kC];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int c = 0; c < kC; ++c) ak[i][c] = av[i][c] = 0.f;

  for (int t = 0; t < n_steps; ++t) {
    const int s = t % kStages;
    if (t + kStages - 1 < n_steps) load_step(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* qs = smem + L::kQ + s * kRows * kLd;
    const float* dos = smem + L::kDo + s * kRows * kLd;
    float st[RM][RN], dpt[RM][RN];
    scores<D, RM, RN>(st, smem + L::kK, qs, ty, tx);
    scores<D, RM, RN>(dpt, smem + L::kV, dos, ty, tx);
    const int t0 = (m_lo + t % per) * kRows;
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int r = tx + 16 * j, row = t0 + r;
      const float l2 = lse_base2(smem[L::kL + s * kRows + r]);
      const float dt = smem[L::kDt + s * kRows + r];
      int lo, hi;
      row_keys(row + offset, p.kv_len, causal, p.window, lo, hi);
      if (row >= p.q_len) hi = lo - 1;
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int key = j0 + ty * RM + i;
        float x = st[i][j] * p.scale_log2e, chain = 1.f;
        if constexpr (kCap) {
          const float th = tanhf(x * p.inv_cap2);
          x = p.cap2 * th;
          chain = 1.f - th * th;
        }
        const bool seen = key >= lo && key <= hi;
        const float pj = seen ? exp2_approx(x - l2) : 0.f;
        pt[(ty * RM + i) * (kRows + 4) + r] = pj;
        dst[(ty * RM + i) * (kRows + 4) + r] = pj * (dpt[i][j] - dt) * chain;
      }
    }
    __syncthreads();
    accumulate<D, RM, kRows>(av, pt, dos, ty, tx);
    accumulate<D, RM, kRows>(ak, dst, qs, ty, tx);
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int key = j0 + ty * RM + i;
    if (key >= p.kv_len) continue;
    const size_t at = (bh * p.kv_len + key) * D;
    store_cols<D>(dk + at, ak[i], p.scale, tx);
    store_cols<D>(dv + at, av[i], 1.f, tx);
  }
}

// ---- launchers -------------------------------------------------------------

enum Kind { kFwd = 0, kDq = 1, kDkv = 2 };

struct Operands {
  const float *q, *k, *v, *dout, *lse, *dterm;
  float *o, *out_lse, *dq, *dk, *dv;
};

template <typename Kernel>
int prepare(Kernel kernel, int bytes) {
  if (cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return (int)cudaGetLastError();
  return 0;
}

template <int D, bool kCap>
int launch(Kind kind, const Operands& x, const F32Params& p, int batch,
           int kv_heads, cudaStream_t s) {
  using Tl = F32Tiles<D>;
  int rc;
  if (kind == kFwd) {
    auto kernel = flash_fwd_f32_kernel<D, kCap>;
    if ((rc = prepare(kernel, FwdSmem<D>::kBytes))) return rc;
    const dim3 grid((p.rows + Tl::kFwdRows - 1) / Tl::kFwdRows, kv_heads,
                    batch);
    kernel<<<grid, kThreads, FwdSmem<D>::kBytes, s>>>(x.q, x.k, x.v, x.o,
                                                      x.out_lse, p);
  } else if (kind == kDq) {
    auto kernel = flash_bwd_dq_f32_kernel<D, kCap>;
    if ((rc = prepare(kernel, DqSmem<D>::kBytes))) return rc;
    const dim3 grid((p.rows + Tl::kFwdRows - 1) / Tl::kFwdRows, kv_heads,
                    batch);
    kernel<<<grid, kThreads, DqSmem<D>::kBytes, s>>>(
        x.q, x.k, x.v, x.dout, x.lse, x.dterm, x.dq, p);
  } else {
    auto kernel = flash_bwd_dkv_f32_kernel<D, kCap>;
    if ((rc = prepare(kernel, DkvSmem<D>::kBytes))) return rc;
    const dim3 grid((p.kv_len + Tl::kDkvKeys - 1) / Tl::kDkvKeys, kv_heads,
                    batch);
    kernel<<<grid, kThreads, DkvSmem<D>::kBytes, s>>>(
        x.q, x.k, x.v, x.dout, x.lse, x.dterm, x.dk, x.dv, p);
  }
  return (int)cudaGetLastError();
}

template <int D>
int launch_cap(Kind kind, bool capped, const Operands& x,
               const F32Params& p, int batch, int kv_heads, cudaStream_t s) {
  return capped ? launch<D, true>(kind, x, p, batch, kv_heads, s)
                : launch<D, false>(kind, x, p, batch, kv_heads, s);
}

int run(Kind kind, const Operands& x, int batch, int q_heads, int kv_heads,
        int q_len, int kv_len, int head_dim, float scale, float softcap,
        int causal, int window, void* stream) {
  if (kv_heads <= 0 || q_heads % kv_heads || q_len < 0 || kv_len < 0 ||
      softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || (kind == kDkv ? kv_len : q_len) == 0) return 0;
  F32Params p;
  p.group = q_heads / kv_heads;
  p.rows = p.group * q_len;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.scale = scale;
  p.scale_log2e = scale * kLog2e;
  p.cap2 = softcap * kLog2e;
  p.inv_cap2 = softcap > 0.f ? 1.f / p.cap2 : 0.f;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool cap = softcap > 0.f;
  switch (head_dim) {
    case 32:
      return launch_cap<32>(kind, cap, x, p, batch, kv_heads, s);
    case 64:
      return launch_cap<64>(kind, cap, x, p, batch, kv_heads, s);
    case 128:
      return launch_cap<128>(kind, cap, x, p, batch, kv_heads, s);
    case 256:
      return launch_cap<256>(kind, cap, x, p, batch, kv_heads, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Every tensor float32, contiguous and 16-byte aligned: q [b, q_heads,
// q_len, D], k and v [b, kv_heads, kv_len, D], head_dim 32, 64, 128 or
// 256.  softcap > 0 soft-caps the scaled logits (the backward's lse must
// be the capped logits'); 0: none.  window <= 0: none.
//
// The forward: o like q, lse [b, q_heads, q_len] (natural log).
int mfa_flash_fwd_f32(const float* q, const float* k, const float* v,
                      float* o, float* lse, int batch, int q_heads,
                      int kv_heads, int q_len, int kv_len, int head_dim,
                      float scale, float softcap, int causal, int window,
                      void* stream) {
  const Operands x{q, k, v, nullptr, nullptr, nullptr,
                   o, lse, nullptr, nullptr, nullptr};
  return run(kFwd, x, batch, q_heads, kv_heads, q_len, kv_len, head_dim,
             scale, softcap, causal, window, stream);
}

// dQ like q from dout (like q), the forward's lse and dterm = rowsum(dout *
// o), both [b, q_heads, q_len].
int mfa_flash_bwd_dq_f32(const float* q, const float* k, const float* v,
                         const float* dout, const float* lse,
                         const float* dterm, float* dq, int batch,
                         int q_heads, int kv_heads, int q_len, int kv_len,
                         int head_dim, float scale, float softcap, int causal,
                         int window, void* stream) {
  const Operands x{q, k, v, dout, lse, dterm,
                   nullptr, nullptr, dq, nullptr, nullptr};
  return run(kDq, x, batch, q_heads, kv_heads, q_len, kv_len, head_dim,
             scale, softcap, causal, window, stream);
}

// dK and dV like k, the GQA group summed in the kernel.
int mfa_flash_bwd_dkv_f32(const float* q, const float* k, const float* v,
                          const float* dout, const float* lse,
                          const float* dterm, float* dk, float* dv,
                          int batch, int q_heads, int kv_heads, int q_len,
                          int kv_len, int head_dim, float scale,
                          float softcap, int causal, int window,
                          void* stream) {
  const Operands x{q, k, v, dout, lse, dterm,
                   nullptr, nullptr, nullptr, dk, dv};
  return run(kDkv, x, batch, q_heads, kv_heads, q_len, kv_len, head_dim,
             scale, softcap, causal, window, stream);
}

const char* mfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
