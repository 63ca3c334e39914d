// Atomic-free flash-attention backward for NVIDIA Hopper (sm_90a), plain C
// interface: two kernels, each owning its output tiles.
//
// Replaces the two TPU kernels of
// metal_flash_attention_tpu/ops/flash_attention_bwd.py:
//   _make_dq_kernel   (:73, pallas_call at :587), backwardQuery;
//   _make_dkv_kernel  (:226, pallas_call at :700), backwardKeyValue, which
//                     sums the GQA group inside the kernel (:613-618).
//
// Both recompute the scores from Q, K and the forward's lse L, in the
// exp2 domain: P = exp2(S * scale * log2(e) - L * log2(e)).  A row that
// saw no key has L = -inf; it is read as 0 so that its P, masked
// everywhere, is exactly 0 and never NaN.  D = rowsum(dO * O) comes in
// precomputed (fp32).  Then dP = dO V^T, dS = P * (dP - D), and
//   flash_bwd_dq:  dQ = scale * dS K;
//   flash_bwd_dkv: dV = P^T dO and dK = scale * dS^T Q, the group's q
//                  heads summed in the block's accumulators: each block
//                  owns its dK/dV rows, so there are no atomics.
// P and dS are rounded to the input type before the products that
// consume them.
//
// Bound: 3 (dQ) and 4 (dK/dV) products of 2 * D FLOPs per visible (row,
// key) pair against a few hundred MB of traffic at the training shapes:
// the tensor cores bound both.  The design:
// - Both kernels run two consumer warpgroups and no producer warpgroup
//   (256 threads).  ptxas gives a wgmma kernel's threads the budget of
//   its block counted in whole warpgroups: 168 registers at three, too
//   few for dK/dV's two 64 x D float32 accumulators beside S^T and dP^T;
//   255 at two.  Thread 0 issues the TMA loads: what the block keeps (Q
//   and dO, or K and V) once, then the operand it streams (K and V, or Q
//   and dO) into a ring of MFA_BWD90_STAGES stages.  At each step it
//   refills the slot that the step before freed, once all 8 warps have
//   released it, outside any branch around a wgmma.
// - The products are wgmma.  The scores (S = Q K^T and dP = dO V^T, or
//   S^T = K Q^T and dP^T = V dO^T) are SS, both operands K-major in
//   128-byte swizzled panels of 64 columns.  P and dS stay in fp32
//   registers, packed pairwise to 16 bits where the accumulator layout
//   is the A operand's, and dQ += dS K (or dV += P^T dO and dK += dS^T Q)
//   are RS, the K tile (or the Q and dO tiles) already in shared memory
//   serving as an MN-major B.  P is computed while dP's product runs,
//   and dS while dV's does.
// - flash_bwd_dq: a block takes 128 group-major query rows of one kv
//   head (row g * q_len + t is query t of q head h * group + g; as the
//   forward), 64 a warpgroup, and loops over its visible key tiles from
//   the last down.  The tiles that cross the causal diagonal, kv_len or a
//   window's edge test each key; the tiles every row sees whole do not.
//   Causal grids take the heaviest row tiles first.
// - flash_bwd_dkv: a block takes 128 keys of one kv head, 64 a
//   warpgroup, and loops over the group's q heads and, in each, over the
//   query tiles that see its keys, testing each pair only in the tiles at
//   the diagonal or a window's edge.  The grid takes the first key tiles
//   (the heaviest, when causal) of every head first.  L and D of a step's
//   rows come from global memory, two a lane, and reach the threads that
//   need them through a scratch of the warp's own in shared memory.
// - The epilogues stage the outputs in the warpgroup's own rows of a
//   buffer it no longer reads (Q's, or K's and V's) and write them with
//   TMA stores, clipped to the head's rows by the maps.
//
// Every function returns cudaGetLastError() after its launch.

#include <type_traits>

#include "attention_common.cuh"
#include "flash_tiles.cuh"
#include "hopper_common.cuh"

namespace {

using namespace mfa;

constexpr int kThreads = 256;  // two consumer warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kStages = MFA_BWD90_STAGES;
constexpr int kDqRows = MFA_BWD90_DQ_BLOCK_Q;     // dQ: query rows a block
constexpr int kDqKeys = MFA_BWD90_DQ_BLOCK_KV;    // dQ: keys a tile
constexpr int kDkvKeys = MFA_BWD90_DKV_BLOCK_KV;  // dK/dV: keys a block
constexpr int kDkvRows = MFA_BWD90_DKV_BLOCK_Q;   // dK/dV: query rows a step
constexpr int kErrTensorMap = 10000;  // cuTensorMapEncodeTiled refused
static_assert(kStages >= 2, "a ring");
static_assert(kDqRows == 2 * 64 && kDkvKeys == 2 * 64,
              "two warpgroups of 64 rows");
static_assert((kDqKeys == 64 || kDqKeys == 128) &&
                  (kDkvRows == 64 || kDkvRows == 128),
              "the N of an SS wgmma, the K of an RS one");

struct BwdParams {
  const float* lse;    // [b, q_heads, q_len], natural log
  const float* dterm;  // [b, q_heads, q_len], rowsum(dO * O)
  int group, q_len, kv_len;
  float scale, scale_log2e;
  int causal, window;
};

__device__ __forceinline__ float lse_base2(float lse) {
  return lse == -INFINITY ? 0.f : lse * kLog2e;
}

// A [rows][D] 16-bit operand in shared memory: D / 64 panels of kRows
// 128-byte rows (one TMA box of 64 columns each), 128-byte swizzled.
template <int D, int kRows>
struct Operand {
  static constexpr int kPanel = kRows * 128;
  static constexpr int kBytes = D / 64 * kPanel;
};

// Shared memory of a block: the operands it keeps (A, B), then the ring's
// stages of two streamed operands each, the barriers (the kept operands'
// full, each stage's full and empty), and room to align the whole to
// 1024 bytes.
template <int D, int kKeptRows, int kStreamRows>
struct Smem {
  using Kept = Operand<D, kKeptRows>;
  using Stream = Operand<D, kStreamRows>;
  static constexpr int kA = 0;
  static constexpr int kB = Kept::kBytes;
  static constexpr int kRing = 2 * Kept::kBytes;
  static constexpr int kStage = 2 * Stream::kBytes;
  static constexpr int kBar = kRing + kStages * kStage;
  static constexpr int kBytes = kBar + (1 + 2 * kStages) * 8 + 1024;
  static_assert(kBytes <= 232448, "an H100 block's shared memory");
};
template <int D>
using DqSmem = Smem<D, kDqRows, kDqKeys>;  // Q, dO; K and V
template <int D>
using DkvSmem = Smem<D, kDkvKeys, kDkvRows>;  // K, V; Q and dO

// acc = A B^T over D, issued: A the warpgroup's 64 rows at `a`, B the N
// rows at `b`, both K-major in panels a_panel and b_panel bytes apart.
template <int N, int D, bool kFp16>
__device__ __forceinline__ void ss_product(float (&acc)[N / 2],
                                           const uint8_t* a, int a_panel,
                                           const uint8_t* b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    sm90::wgmma_ss<N, 0, kFp16>(
        acc, sm90::smem_desc(a + kk / 4 * a_panel + kk % 4 * 32, 16, 1024),
        sm90::smem_desc(b + kk / 4 * b_panel + kk % 4 * 32, 16, 1024),
        kk > 0);
}

// acc += A B over K rows, issued: A from registers, B the [K][D] rows at
// `b` (panels b_panel bytes apart) as an MN-major operand.
template <int K, int D, bool kFp16>
__device__ __forceinline__ void rs_product(float (&acc)[D / 2],
                                           const uint32_t (&a)[K / 16][4],
                                           const uint8_t* b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    sm90::wgmma_rs<D, 1, kFp16>(acc, a[kk],
                                sm90::smem_desc(b + kk * 2048, b_panel, 1024));
}

// Loads of the D / 64 panels of one operand's box at row `row` of head
// `head` into `dst`, completing on `bar`.
template <int D, int kRows>
__device__ __forceinline__ void load_operand(uint8_t* dst,
                                             const CUtensorMap* map,
                                             uint64_t* bar, int row,
                                             int head) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    sm90::tma_load_3d(dst + c * Operand<D, kRows>::kPanel, map, bar, 64 * c,
                      row, head);
}

// A warpgroup's 64 x D float32 accumulator times `mul`, rounded to T and
// written in its rows of a [*][D] operand buffer (panels `panel` bytes
// apart, swizzled as TMA reads them).
template <typename T, int D>
__device__ __forceinline__ void stage_rows(uint8_t* dst, int panel,
                                           const float (&acc)[D / 2],
                                           float mul, int warp, int lane) {
  const int r = 16 * warp + lane / 4, t4 = lane % 4;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(dst + j / 8 * panel +
                                   sm90::swizzle128(r + 8 * h, j % 8) +
                                   4 * t4) =
          pack2<T>(acc[4 * j + 2 * h] * mul, acc[4 * j + 2 * h + 1] * mul);
}

// The row tile that block x of a row of `tiles` takes (the forward's
// order).  Causal work grows with a row's position t, so the heaviest
// tiles go first: when the tiles align with the q heads, by descending t
// across the group's heads; otherwise in reverse order.
__device__ __forceinline__ int dq_row_tile(const BwdParams& p, int x,
                                           int tiles) {
  if (!p.causal) return x;
  if (p.q_len % kDqRows) return tiles - 1 - x;
  const int per = p.q_len / kDqRows;
  return x % p.group * per + per - 1 - x / p.group;
}

// Grid (row tiles, kv_heads, batch), kThreads threads, DqSmem<D>::kBytes of
// dynamic shared memory.  The maps are over [b * kv_heads][rows][D] (q,
// do, dq) and [b * kv_heads][kv_len][D] (k, v), 16-bit elements, boxes of
// 64 columns by kDqRows rows (q, do), kDqKeys rows (k, v) and 64 rows
// (dq).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_dq,
                      BwdParams p) {
  using namespace sm90;
  using L = DqSmem<D>;
  using Rows = typename L::Kept;
  using Keys = typename L::Stream;
  constexpr bool kFp16 = std::is_same<T, __half>::value;
  constexpr int kS = kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* rows_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = rows_full + 1;
  uint64_t* empty = full + kS;

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int rows = p.group * p.q_len;
  const int r0 = dq_row_tile(p, blockIdx.x, gridDim.x) * kDqRows;
  const int offset = p.kv_len - p.q_len;
  const bool causal = p.causal != 0;

  // Keys any row of this tile can see, [col_lo, col_hi], as key tiles
  // [n_lo, n_hi); of those, every row sees tiles [u_lo, u_hi) whole.
  // Loop step i takes tile n_hi - 1 - i: steps [0, open_begin) and
  // [open_end, n_steps) test each key, the rest do not.
  const int r_last = min(r0 + kDqRows, rows) - 1;
  int t_min = 0, t_max = p.q_len - 1;
  if (r0 / p.q_len == r_last / p.q_len) {
    t_min = r0 % p.q_len;
    t_max = r_last % p.q_len;
  }
  const int col_hi =
      causal ? min(p.kv_len - 1, offset + t_max) : p.kv_len - 1;
  const int col_lo = p.window > 0 ? max(0, offset + t_min - p.window + 1) : 0;
  const int n_lo = col_lo / kDqKeys;
  const int n_hi = col_hi >= col_lo ? col_hi / kDqKeys + 1 : n_lo;
  const int n_steps = n_hi - n_lo;
  int u_hi = p.kv_len / kDqKeys;
  if (causal) u_hi = min(u_hi, max(0, offset + t_min + 1) / kDqKeys);
  u_hi = max(n_lo, min(u_hi, n_hi));
  int u_lo = 0;
  if (p.window > 0)
    u_lo = (max(0, offset + t_max - p.window + 1) + kDqKeys - 1) / kDqKeys;
  u_lo = max(n_lo, min(u_lo, u_hi));
  const int open_begin = n_hi - u_hi, open_end = n_hi - u_lo;

  if (tid == 0) {
    mbar_init(rows_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // K and V of loop step i (key tile n_hi - 1 - i) into stage i % kS.
  auto load_step = [&](int i) {
    const int s = i % kS, j0 = (n_hi - 1 - i) * kDqKeys;
    uint8_t* dst = smem + L::kRing + s * L::kStage;
    mbar_arrive_expect_tx(&full[s], L::kStage);
    load_operand<D, kDqKeys>(dst, &map_k, &full[s], j0, bh);
    load_operand<D, kDqKeys>(dst + Keys::kBytes, &map_v, &full[s], j0, bh);
  };
  if (tid == 0 && n_steps > 0) {
    prefetch_tensor_map(&map_q);
    prefetch_tensor_map(&map_do);
    prefetch_tensor_map(&map_k);
    prefetch_tensor_map(&map_v);
    mbar_arrive_expect_tx(rows_full, 2 * Rows::kBytes);
    load_operand<D, kDqRows>(smem + L::kA, &map_q, rows_full, r0, bh);
    load_operand<D, kDqRows>(smem + L::kB, &map_do, rows_full, r0, bh);
    for (int i = 0; i < min(kS, n_steps); ++i) load_step(i);
  }

  // Warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile; this thread
  // rows ra and ra + 8 of them (the accumulator layout).  The warpgroup
  // comes through a shuffle so that ptxas sees it uniform across each
  // warp: wgmma in a path it cannot prove uniform is serialised.  Every
  // warpgroup issues its products, also where its rows lie past the head
  // (their outputs are not stored).
  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
  const int warp = tid / 32 % 4, t4 = lane % 4;
  const int ra = r0 + 64 * wg + 16 * warp + lane / 4;
  // Each row's visible keys [lo, hi], L in base 2 and D.
  int lo[2], hi[2];
  float l2[2], dt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = ra + 8 * h;
    const int qpos = row % p.q_len + offset;
    hi[h] = causal ? min(qpos, p.kv_len - 1) : p.kv_len - 1;
    lo[h] = p.window > 0 ? qpos - p.window + 1 : 0;
    const size_t at = (size_t)bh * rows + row;
    l2[h] = row < rows ? lse_base2(__ldg(p.lse + at)) : 0.f;
    dt[h] = row < rows ? __ldg(p.dterm + at) : 0.f;
  }
  const uint8_t* q_wg = smem + L::kA + wg * 64 * 128;
  const uint8_t* do_wg = smem + L::kB + wg * 64 * 128;

  float acc[D / 2], sc[kDqKeys / 2], dp[kDqKeys / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kDqKeys / 2; ++e) sc[e] = dp[e] = 0.f;
  uint32_t ds[kDqKeys / 16][4];

  // One key tile (loop step i), with or without the test on keys.
  auto step = [&](int i, auto masked) {
    const int s = i % kS;
    if (tid == 0 && i >= 1 && i - 1 + kS < n_steps) {
      mbar_wait(&empty[(i - 1) % kS], ((i - 1) / kS) & 1);
      load_step(i - 1 + kS);
    }
    mbar_wait(&full[s], (i / kS) & 1);
    const uint8_t* k = smem + L::kRing + s * L::kStage;
    const uint8_t* v = k + Keys::kBytes;
    fence_operands(sc);
    fence_operands(dp);
    wgmma_fence();
    ss_product<kDqKeys, D, kFp16>(sc, q_wg, Rows::kPanel, k, Keys::kPanel);
    wgmma_commit();
    ss_product<kDqKeys, D, kFp16>(dp, do_wg, Rows::kPanel, v, Keys::kPanel);
    wgmma_commit();
    wgmma_wait<1>();
    fence_operands(sc);
    // P in place of S; this thread's columns are col0 + 8 j + {0, 1}.
    const int col0 = (n_hi - 1 - i) * kDqKeys + 2 * t4;
#pragma unroll
    for (int j = 0; j < kDqKeys / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2_approx(fmaf(sc[4 * j + e], p.scale_log2e, -l2[e / 2]));
        if constexpr (decltype(masked)::value) {
          const int col = col0 + 8 * j + e % 2;
          if (col < lo[e / 2] || col > hi[e / 2]) x = 0.f;
        }
        sc[4 * j + e] = x;
      }
    wgmma_wait<0>();
    fence_operands(dp);
    // dS = P (dP - D), packed as the A of dQ += dS K.
#pragma unroll
    for (int e = 0; e < kDqKeys / 2; ++e)
      dp[e] = sc[e] * (dp[e] - dt[e % 4 / 2]);
    pack_rs<T, kDqKeys>(ds, dp);
    fence_operands(acc);
    wgmma_fence();
    rs_product<kDqKeys, D, kFp16>(acc, ds, k, Keys::kPanel);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(acc);
    fence_operands(ds);
    // One arrival a warp frees the stage.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };

  if (n_steps > 0) mbar_wait(rows_full, 0);
  int i = 0;
  for (; i < open_begin; ++i) step(i, std::true_type());
  for (; i < open_end; ++i) step(i, std::false_type());
  for (; i < n_steps; ++i) step(i, std::true_type());

  // Epilogue: dQ = scale * acc, staged in this warpgroup's rows of Q's
  // buffer (free after its last product), then TMA-stored.
  if (r0 + 64 * wg < rows) {
    uint8_t* stage = smem + L::kA + wg * 64 * 128;
    stage_rows<T, D>(stage, Rows::kPanel, acc, p.scale, warp, lane);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (tid % 128 == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_store_3d(&map_dq, stage + c * Rows::kPanel, 64 * c,
                     r0 + 64 * wg, bh);
      tma_store_wait();
    }
  }
}

// Grid (b * kv_heads, key tiles): every head's first key tile first.
// kThreads threads, DkvSmem<D>::kBytes of dynamic shared memory.  The
// maps are over [b * q_heads][q_len][D] (q, do) and [b * kv_heads][kv_len]
// [D] (k, v, dk, dv), 16-bit elements, boxes of 64 columns by kDkvRows
// rows (q, do), kDkvKeys rows (k, v) and 64 rows (dk, dv).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv90_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_dk,
                       const __grid_constant__ CUtensorMap map_dv,
                       BwdParams p) {
  using namespace sm90;
  using L = DkvSmem<D>;
  using Keys = typename L::Kept;
  using Rows = typename L::Stream;
  constexpr bool kFp16 = std::is_same<T, __half>::value;
  constexpr int kS = kStages;
  constexpr int kR = kDkvRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* keys_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = keys_full + 1;
  uint64_t* empty = full + kS;

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.x;
  const int j0 = blockIdx.y * kDkvKeys;
  const int offset = p.kv_len - p.q_len;
  const bool causal = p.causal != 0;

  // Query rows t of each q head that see a key of [j0, j_last], as query
  // tiles [m_lo, m_hi); of those, tiles [w_lo, w_hi) see every key whole.
  const int j_last = min(j0 + kDkvKeys, p.kv_len) - 1;
  const int t_lo = causal ? max(0, j0 - offset) : 0;
  const int t_hi = p.window > 0
                       ? min(p.q_len - 1, j_last - offset + p.window - 1)
                       : p.q_len - 1;
  const int m_lo = t_lo / kR;
  const int m_hi = t_hi >= t_lo ? t_hi / kR + 1 : m_lo;
  const int per = m_hi - m_lo;
  const int n_steps = p.group * per;
  int w_lo = causal ? (max(0, j_last - offset) + kR - 1) / kR : m_lo;
  w_lo = max(m_lo, min(w_lo, m_hi));
  int w_hi = p.window > 0 ? max(0, j0 - offset + p.window) / kR : m_hi;
  w_hi = max(w_lo, min(w_hi, m_hi));

  if (tid == 0) {
    mbar_init(keys_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // Q and dO of loop step i (query tile m_lo + i % per of the group's
  // q head i / per) into stage i % kS.
  auto load_step = [&](int i) {
    const int s = i % kS, t0 = (m_lo + i % per) * kR;
    const int head = bh * p.group + i / per;
    uint8_t* dst = smem + L::kRing + s * L::kStage;
    mbar_arrive_expect_tx(&full[s], L::kStage);
    load_operand<D, kR>(dst, &map_q, &full[s], t0, head);
    load_operand<D, kR>(dst + Rows::kBytes, &map_do, &full[s], t0, head);
  };
  if (tid == 0 && n_steps > 0) {
    prefetch_tensor_map(&map_q);
    prefetch_tensor_map(&map_do);
    prefetch_tensor_map(&map_k);
    prefetch_tensor_map(&map_v);
    mbar_arrive_expect_tx(keys_full, 2 * Keys::kBytes);
    load_operand<D, kDkvKeys>(smem + L::kA, &map_k, keys_full, j0, bh);
    load_operand<D, kDkvKeys>(smem + L::kB, &map_v, keys_full, j0, bh);
    for (int i = 0; i < min(kS, n_steps); ++i) load_step(i);
  }

  // Warpgroup wg takes keys 64 wg .. 64 wg + 63 of the block; this thread
  // keys ka and ka + 8 of them (the rows of the accumulator layout).
  // Each warpgroup issues its products also where its keys lie past
  // kv_len (their rows are not stored).
  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
  const int warp = tid / 32 % 4, t4 = lane % 4;
  const int ka = j0 + 64 * wg + 16 * warp + lane / 4;
  // The query rows that see each key, [lo, hi].
  int lo[2], hi[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int key = ka + 8 * h;
    lo[h] = causal ? key - offset : 0;
    hi[h] = p.window > 0 ? key - offset + p.window - 1 : p.q_len - 1;
  }
  const uint8_t* k_wg = smem + L::kA + wg * 64 * 128;
  const uint8_t* v_wg = smem + L::kB + wg * 64 * 128;

  float dk[D / 2], dv[D / 2], st[kR / 2], dpt[kR / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) dk[e] = dv[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kR / 2; ++e) st[e] = dpt[e] = 0.f;
  uint32_t pa[kR / 16][4], da[kR / 16][4];
  // Each warp's copy of a step's L (base 2) and D, [0] and [1], as pairs
  // of columns: the thread that needs column 8 j + 2 t4 + {0, 1} reads
  // pair 4 j + t4, which the lane that loaded it wrote.
  __shared__ float2 scratch[kWarps][2][kR / 2];

  // One query tile (loop step i: tile m of a q head), with or without the
  // test on pairs.
  auto step = [&](int i, int m, auto masked) {
    const int s = i % kS;
    if (tid == 0 && i >= 1 && i - 1 + kS < n_steps) {
      mbar_wait(&empty[(i - 1) % kS], ((i - 1) / kS) & 1);
      load_step(i - 1 + kS);
    }
    // L (base 2) and D of rows 64 u + 2 lane + {0, 1} of the tile, loaded
    // here and written to the warp's scratch once the products are issued.
    float2 lv[kR / 64], dv_[kR / 64];
    const size_t base = ((size_t)bh * p.group + i / per) * p.q_len;
#pragma unroll
    for (int u = 0; u < kR / 64; ++u) {
      const int t = m * kR + 64 * u + 2 * lane;
      lv[u].x = t < p.q_len ? lse_base2(__ldg(p.lse + base + t)) : 0.f;
      lv[u].y = t + 1 < p.q_len ? lse_base2(__ldg(p.lse + base + t + 1))
                                : 0.f;
      dv_[u].x = t < p.q_len ? __ldg(p.dterm + base + t) : 0.f;
      dv_[u].y = t + 1 < p.q_len ? __ldg(p.dterm + base + t + 1) : 0.f;
    }
    mbar_wait(&full[s], (i / kS) & 1);
    const uint8_t* q = smem + L::kRing + s * L::kStage;
    const uint8_t* d_o = q + Rows::kBytes;
    fence_operands(st);
    fence_operands(dpt);
    wgmma_fence();
    ss_product<kR, D, kFp16>(st, k_wg, Keys::kPanel, q, Rows::kPanel);
    wgmma_commit();
    ss_product<kR, D, kFp16>(dpt, v_wg, Keys::kPanel, d_o, Rows::kPanel);
    wgmma_commit();
    // The previous step's reads of the scratch ended at its last
    // __syncwarp.
#pragma unroll
    for (int u = 0; u < kR / 64; ++u) {
      scratch[tid / 32][0][32 * u + lane] = lv[u];
      scratch[tid / 32][1][32 * u + lane] = dv_[u];
    }
    __syncwarp();
    wgmma_wait<1>();
    fence_operands(st);
    // P^T in place of S^T; this thread's columns are query rows
    // t0 + 8 j + {0, 1}.
    const int t0 = m * kR + 2 * t4;
#pragma unroll
    for (int j = 0; j < kR / 8; ++j) {
      const float2 l = scratch[tid / 32][0][4 * j + t4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = exp2_approx(
            fmaf(st[4 * j + e], p.scale_log2e, e % 2 ? -l.y : -l.x));
        if constexpr (decltype(masked)::value) {
          const int t = t0 + 8 * j + e % 2;
          if (t < lo[e / 2] || t > hi[e / 2]) x = 0.f;
        }
        st[4 * j + e] = x;
      }
    }
    pack_rs<T, kR>(pa, st);
    fence_operands(dv);
    wgmma_fence();
    rs_product<kR, D, kFp16>(dv, pa, d_o, Rows::kPanel);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T's product; dV's runs on
    fence_operands(dpt);
    // dS^T = P^T (dP^T - D), packed as the A of dK += dS^T Q.
#pragma unroll
    for (int j = 0; j < kR / 8; ++j) {
      const float2 d = scratch[tid / 32][1][4 * j + t4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] =
            st[4 * j + e] * (dpt[4 * j + e] - (e % 2 ? d.y : d.x));
    }
    pack_rs<T, kR>(da, dpt);
    fence_operands(dk);
    wgmma_fence();
    rs_product<kR, D, kFp16>(dk, da, q, Rows::kPanel);
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(dv);
    fence_operands(dk);
    fence_operands(pa);
    fence_operands(da);
    // One arrival a warp frees the stage.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  };

  if (n_steps > 0) mbar_wait(keys_full, 0);
  for (int g = 0, i = 0; g < p.group; ++g) {
    int m = m_lo;
    for (; m < w_lo; ++m, ++i) step(i, m, std::true_type());
    for (; m < w_hi; ++m, ++i) step(i, m, std::false_type());
    for (; m < m_hi; ++m, ++i) step(i, m, std::true_type());
  }

  // Epilogue: dK = scale * dk and dV = dv, staged in this warpgroup's rows
  // of K's and V's buffers (free after its last product), then
  // TMA-stored.
  if (j0 + 64 * wg < p.kv_len) {
    uint8_t* sk = smem + L::kA + wg * 64 * 128;
    uint8_t* sv = smem + L::kB + wg * 64 * 128;
    stage_rows<T, D>(sk, Keys::kPanel, dk, p.scale, warp, lane);
    stage_rows<T, D>(sv, Keys::kPanel, dv, 1.f, warp, lane);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (tid % 128 == 0) {
#pragma unroll
      for (int c = 0; c < D / 64; ++c) {
        tma_store_3d(&map_dk, sk + c * Keys::kPanel, 64 * c, j0 + 64 * wg,
                     bh);
        tma_store_3d(&map_dv, sv + c * Keys::kPanel, 64 * c, j0 + 64 * wg,
                     bh);
      }
      tma_store_wait();
    }
  }
}

// A TMA map over a [heads][rows][D] 16-bit operand, boxes of 64 columns by
// box_rows rows, 128-byte swizzled.  A tensor with no rows is mapped as
// one row of `fallback` (nothing is then loaded), so that
// cuTensorMapEncodeTiled accepts it.
template <int D>
bool operand_map(CUtensorMap* map, const void* base, const void* fallback,
                 int rows, long long heads, int box_rows) {
  if (rows == 0) base = fallback;
  const long long r = rows > 0 ? rows : 1;
  return sm90::tensor_map(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, D, r,
                          heads, D, r * D, 64, box_rows,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Operands {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
};

template <typename T, int D>
int launch_dq(const Operands& x, const BwdParams& p, int batch,
              int kv_heads, cudaStream_t s) {
  using L = DqSmem<D>;
  const long long heads = (long long)batch * kv_heads;
  const int rows = p.group * p.q_len;
  CUtensorMap mq, mdo, mk, mv, mdq;
  const bool ok =
      operand_map<D>(&mq, x.q, x.q, rows, heads, kDqRows) &&
      operand_map<D>(&mdo, x.dout, x.q, rows, heads, kDqRows) &&
      operand_map<D>(&mk, x.k, x.q, p.kv_len, heads, kDqKeys) &&
      operand_map<D>(&mv, x.v, x.q, p.kv_len, heads, kDqKeys) &&
      operand_map<D>(&mdq, x.dq, x.q, rows, heads, 64);
  if (!ok) return kErrTensorMap;
  if (cudaFuncSetAttribute(flash_bwd_dq90_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kBytes) != cudaSuccess)
    return (int)cudaGetLastError();
  const dim3 grid((rows + kDqRows - 1) / kDqRows, kv_heads, batch);
  flash_bwd_dq90_kernel<T, D><<<grid, kThreads, L::kBytes, s>>>(
      mq, mdo, mk, mv, mdq, p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Operands& x, const BwdParams& p, int batch,
               int kv_heads, cudaStream_t s) {
  using L = DkvSmem<D>;
  const long long heads = (long long)batch * kv_heads;
  CUtensorMap mq, mdo, mk, mv, mdk, mdv;
  const bool ok =
      operand_map<D>(&mq, x.q, x.k, p.q_len, heads * p.group, kDkvRows) &&
      operand_map<D>(&mdo, x.dout, x.k, p.q_len, heads * p.group,
                     kDkvRows) &&
      operand_map<D>(&mk, x.k, x.k, p.kv_len, heads, kDkvKeys) &&
      operand_map<D>(&mv, x.v, x.k, p.kv_len, heads, kDkvKeys) &&
      operand_map<D>(&mdk, x.dk, x.k, p.kv_len, heads, 64) &&
      operand_map<D>(&mdv, x.dv, x.k, p.kv_len, heads, 64);
  if (!ok) return kErrTensorMap;
  if (cudaFuncSetAttribute(flash_bwd_dkv90_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kBytes) != cudaSuccess)
    return (int)cudaGetLastError();
  const dim3 grid((unsigned)heads, (p.kv_len + kDkvKeys - 1) / kDkvKeys);
  flash_bwd_dkv90_kernel<T, D><<<grid, kThreads, L::kBytes, s>>>(
      mq, mdo, mk, mv, mdk, mdv, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(bool dkv, const Operands& x, const BwdParams& p, int batch,
           int kv_heads, int head_dim, cudaStream_t s) {
  if (head_dim == 64)
    return dkv ? launch_dkv<T, 64>(x, p, batch, kv_heads, s)
               : launch_dq<T, 64>(x, p, batch, kv_heads, s);
  if (head_dim == 128)
    return dkv ? launch_dkv<T, 128>(x, p, batch, kv_heads, s)
               : launch_dq<T, 128>(x, p, batch, kv_heads, s);
  return (int)cudaErrorInvalidValue;
}

int run(bool dkv, const Operands& x, const void* lse, const void* dterm,
        int batch, int q_heads, int kv_heads, int q_len, int kv_len,
        int head_dim, float scale, int causal, int window, int is_fp16,
        void* stream) {
  if (kv_heads <= 0 || q_heads % kv_heads || q_len < 0 || kv_len < 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.lse = static_cast<const float*>(lse);
  p.dterm = static_cast<const float*>(dterm);
  p.group = q_heads / kv_heads;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.scale = scale;
  p.scale_log2e = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_fp16 ? launch<__half>(dkv, x, p, batch, kv_heads, head_dim, s)
                 : launch<__nv_bfloat16>(dkv, x, p, batch, kv_heads,
                                         head_dim, s);
}

}  // namespace

extern "C" {

// q, k, v, dout contiguous, 16-byte aligned; lse and dterm float32.
// dq like q; is_fp16 selects fp16 (else bf16) for q, k, v, dout and dq.
// window <= 0: none.  Returns kErrTensorMap when cuTensorMapEncodeTiled
// refuses a TMA map.
int mfa_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dterm,
                     void* dq, int batch, int q_heads, int kv_heads,
                     int q_len, int kv_len, int head_dim, float scale,
                     int causal, int window, int is_fp16, void* stream) {
  if (batch == 0 || q_len == 0) return 0;
  const Operands x{q, k, v, dout, dq, nullptr, nullptr};
  return run(false, x, lse, dterm, batch, q_heads, kv_heads, q_len, kv_len,
             head_dim, scale, causal, window, is_fp16, stream);
}

// dk/dv like k, the GQA group summed in the kernel.
int mfa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dterm,
                      void* dk, void* dv, int batch, int q_heads,
                      int kv_heads, int q_len, int kv_len, int head_dim,
                      float scale, int causal, int window, int is_fp16,
                      void* stream) {
  if (batch == 0 || kv_len == 0) return 0;
  const Operands x{q, k, v, dout, nullptr, dk, dv};
  return run(true, x, lse, dterm, batch, q_heads, kv_heads, q_len, kv_len,
             head_dim, scale, causal, window, is_fp16, stream);
}

const char* mfa_cuda_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a TMA map of the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
