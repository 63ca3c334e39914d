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
// Gemma-2 (the TPU kernels' `logit_softcap`, :79, :156-159, :194-196 and
// :232, :310-313, :359-360).  With the soft cap c the fully scaled score
// goes through t = tanh(s / c2) and s = c2 t (c2 = c log2(e), the exp2
// domain) before the mask, so P is the capped logits' (the forward's
// lse is too), and dS, chained through c tanh(s / c), takes the factor
// 1 - t^2 before the dQ (or dK) product; dV = P^T dO takes none.  tanhf,
// not tanh.approx (whose ~2^-11 error moves a saturated logit's exp2 by
// percents).  The cap is a template flag (kCap), so the uncapped kernels
// are unchanged code.  dQ needs P only inside dS and keeps P (1 - t^2) in
// place of P; dK/dV packs P as dV's operand as it goes and keeps
// P (1 - t^2) for dS, so t never takes registers of its own.
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
// - Head dim 256 (BwdTiles<256>, MFA_BWD90_D256_* tiles): two 128-row
//   kept operands and two stages of 128-key (or 64-row) operands would
//   take 384 KB (dQ) and 256 KB (dK/dV) of the 227 KB a block has, and a
//   warpgroup owning 64 keys would hold 256 float32 of dK and dV a
//   thread.  dQ takes one warpgroup of 64 rows (128 threads) and 64-key
//   tiles: 192 KB, and 128 float32 of dQ a thread.  dK/dV takes 64 keys a
//   block, which both warpgroups share: each computes the tile's S^T and
//   dP^T over all of D (the products over D are repeated: 1.5x the
//   tensor-core work of one pass) and owns columns 128 wg .. 128 wg + 127
//   of dK and dV, 128 float32 a thread, as at D 128; K, V and two stages
//   of Q and dO take 192 KB.  A barrier of both warpgroups precedes the
//   epilogue, which stages each warpgroup's columns in K's and V's
//   buffers.
// - The options (the TPU kernels' mask, mask2, bias and segment refs: dQ
//   :86-95, :125-135, :160-196; dK/dV :239-246, :282-290, :310-330).  A
//   template flag, kAux, beside kCap (D 64 and 128, bf16 and fp16): the
//   kernels without it are the same code.  The recomputed logit takes the
//   bias and the -inf of a gated or other-segment pair after the
//   structural masks (attention_common.cuh `aux_pair`, `SegTile`, as the
//   forward reads them), so P is the forward's.  dQ waits for both score
//   products before its elementwise pass (kAux only) and emits dbias = P
//   (dP - D), natural units, before the cap's factor (the TPU kernel's
//   :191-193), from its fragments into a float32 [b, q_heads, q_len,
//   kv_len] buffer that the wrapper zeroes where a causal or window loop
//   skips tiles (:210-213); the reduction over a broadcast bias's dims is
//   a torch.sum afterwards (:562-611).  dK/dV computes S^T, so a thread's
//   fragment rows are keys and its columns queries, and a column of a
//   plane runs down its rows, ld apart.  So each warp stages its 16 keys
//   by the step's rows of mask, mask2 and bias in shared memory by
//   cp.async, 16-byte pieces of the rows issued before the step's
//   products and waited for after them (`AuxStage`), and reads them down
//   the columns there; read from global memory at t * ld + key, the
//   options took 2.8 ms beside the step's 1.1 (ALiBi, H100).  Its keys'
//   segment ids sit in registers and the step's query ids reach the
//   threads through the warp's scratch, as L and D do.
//
// Head dim 32 (the tiny configs') runs the D 64 kernels over TMA maps
// whose rows are 32 columns, as the forward does (csrc/flash_attention.cu):
// the loads' 64-column boxes come in with zeros in columns 32..63, so the
// scores and dP are unchanged and dQ's, dK's and dV's extra columns are
// products with those zeros; the stores' boxes are clipped to the 32 real
// columns.  No option (aux) at D 32.
//
// Every function returns cudaGetLastError() after its launch.

#include <type_traits>

#include "attention_common.cuh"
#include "flash_tiles.cuh"
#include "hopper_common.cuh"

namespace {

using namespace mfa;

constexpr int kErrTensorMap = 10000;  // cuTensorMapEncodeTiled refused

// The tiles at head dim D (flash_tiles.cuh): dQ's query rows a block (64
// a warpgroup) and keys a tile; dK/dV's keys a block and query rows a
// step; the ring's stages.  dK/dV's two warpgroups own 64 keys each
// (128 a block), or share a block of 64 keys and split dK's and dV's
// columns (kDkvSplit, each owning kDkvCols).
template <int D>
struct BwdTiles {
  static constexpr bool kWide = D > 128;
  static constexpr int kDqRows =
      kWide ? MFA_BWD90_D256_DQ_BLOCK_Q : MFA_BWD90_DQ_BLOCK_Q;
  static constexpr int kDqKeys =
      kWide ? MFA_BWD90_D256_DQ_BLOCK_KV : MFA_BWD90_DQ_BLOCK_KV;
  static constexpr int kDkvKeys =
      kWide ? MFA_BWD90_D256_DKV_BLOCK_KV : MFA_BWD90_DKV_BLOCK_KV;
  static constexpr int kDkvRows =
      kWide ? MFA_BWD90_D256_DKV_BLOCK_Q : MFA_BWD90_DKV_BLOCK_Q;
  static constexpr int kStages =
      kWide ? MFA_BWD90_D256_STAGES : MFA_BWD90_STAGES;
  static constexpr int kDqThreads = 128 * (kDqRows / 64);
  static constexpr int kDkvThreads = 256;  // two warpgroups
  static constexpr bool kDkvSplit = kDkvKeys == 64;
  static constexpr int kDkvCols = kDkvSplit ? D / 2 : D;
  static_assert(D == 64 || D == 128 || D == 256, "D 64, 128 or 256");
  static_assert(kStages >= 2, "a ring");
  static_assert(kDqRows == 64 || kDqRows == 128,
                "one or two warpgroups of 64 rows");
  static_assert(kDkvKeys == 64 || kDkvKeys == 128,
                "two warpgroups over 64 keys, or 64 each");
  static_assert((kDqKeys == 64 || kDqKeys == 128) &&
                    (kDkvRows == 64 || kDkvRows == 128),
                "the N of an SS wgmma, the K of an RS one");
  static_assert(kDkvCols % 64 == 0 && kDkvCols <= 256,
                "the N of an RS wgmma");
};

struct BwdParams {
  const float* lse;    // [b, q_heads, q_len], natural log
  const float* dterm;  // [b, q_heads, q_len], rowsum(dO * O)
  int group, q_len, kv_len, kv_heads;
  float scale, scale_log2e;
  float cap2, inv_cap2;  // the soft cap in the exp2 domain (kCap kernels)
  int causal, window;
};

// A [rows][D] 16-bit operand in shared memory: D / 64 panels of kRows
// 128-byte rows (one TMA box of 64 columns each), 128-byte swizzled.
template <int D, int kRows>
struct Operand {
  static constexpr int kPanel = kRows * 128;
  static constexpr int kBytes = D / 64 * kPanel;
};

// Shared memory of a block: the operands it keeps (A, B), then the ring's
// kStages stages of two streamed operands each, the barriers (the kept
// operands' full, each stage's full and empty), and room to align the
// whole to 1024 bytes.
template <int D, int kKeptRows, int kStreamRows, int kStages>
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
using DqSmem = Smem<D, BwdTiles<D>::kDqRows, BwdTiles<D>::kDqKeys,
                    BwdTiles<D>::kStages>;  // Q, dO; K and V
template <int D>
using DkvSmem = Smem<D, BwdTiles<D>::kDkvKeys, BwdTiles<D>::kDkvRows,
                     BwdTiles<D>::kStages>;  // K, V; Q and dO

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

// acc += A B over K rows, issued: A from registers, B the N columns of
// the [K][*] rows at `b` (panels b_panel bytes apart, `b` at the first
// column's) as an MN-major operand.
template <int K, int N, bool kFp16>
__device__ __forceinline__ void rs_product(float (&acc)[N / 2],
                                           const uint32_t (&a)[K / 16][4],
                                           const uint8_t* b, int b_panel) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    sm90::wgmma_rs<N, 1, kFp16>(acc, a[kk],
                                sm90::smem_desc(b + kk * 2048, b_panel, 1024));
}

// One recomputed score soft-capped in the exp2 domain: x = S * scale *
// log2(e), then c2 tanh(x / c2); f = 1 - tanh^2, the factor dS takes.
__device__ __forceinline__ float capped_score(float s, const BwdParams& p,
                                              float& f) {
  const float t = tanhf(s * p.scale_log2e * p.inv_cap2);
  f = fmaf(-t, t, 1.f);
  return p.cap2 * t;
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

// The row tile (of kDqRows rows) that block x of a row of `tiles` takes
// (the forward's order).  Causal work grows with a row's position t, so
// the heaviest tiles go first: when the tiles align with the q heads, by
// descending t across the group's heads; otherwise in reverse order.
template <int kDqRows>
__device__ __forceinline__ int dq_row_tile(const BwdParams& p, int x,
                                           int tiles) {
  if (!p.causal) return x;
  if (p.q_len % kDqRows) return tiles - 1 - x;
  const int per = p.q_len / kDqRows;
  return x % p.group * per + per - 1 - x / p.group;
}

// Grid (row tiles, kv_heads, batch), BwdTiles<D>::kDqThreads threads,
// DqSmem<D>::kBytes of dynamic shared memory.  The maps are over
// [b * kv_heads][rows][D] (q, do, dq) and [b * kv_heads][kv_len][D] (k,
// v), 16-bit elements, boxes of 64 columns by kDqRows rows (q, do),
// kDqKeys rows (k, v) and 64 rows (dq).  kCap: soft-capped logits.  kAux:
// the options in aux, and dbias when aux.dbias is not null.
template <typename T, int D, bool kCap, bool kAux = false>
__global__ void __launch_bounds__(BwdTiles<D>::kDqThreads, 1)
flash_bwd_dq90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_do,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_dq,
                      BwdParams p, const AuxOperands aux) {
  using namespace sm90;
  using L = DqSmem<D>;
  using Rows = typename L::Kept;
  using Keys = typename L::Stream;
  constexpr bool kFp16 = std::is_same<T, __half>::value;
  constexpr int kS = BwdTiles<D>::kStages;
  constexpr int kDqRows = BwdTiles<D>::kDqRows;
  constexpr int kDqKeys = BwdTiles<D>::kDqKeys;
  constexpr int kWarps = BwdTiles<D>::kDqThreads / 32;
  static_assert(!kAux || D <= 128, "the options at D 64 and 128");
  extern __shared__ uint8_t smem_raw[];
  // kAux: each warp's scratch of a key tile's segment ids.
  __shared__ __align__(16) int seg_scratch[kAux ? kWarps : 1]
                                          [kAux ? kDqKeys : 1];
  uint8_t* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* rows_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full = rows_full + 1;
  uint64_t* empty = full + kS;

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int rows = p.group * p.q_len;
  const int r0 = dq_row_tile<kDqRows>(p, blockIdx.x, gridDim.x) * kDqRows;
  const int offset = p.kv_len - p.q_len;
  const bool causal = p.causal != 0;

  // Keys any row of this tile can see, [col_lo, col_hi], as key tiles
  // [n_lo, n_hi); of those, every row sees tiles [u_lo, u_hi) whole.
  // Loop step i takes tile n_hi - 1 - i: steps [0, open_begin) and
  // [open_end, n_steps) test each key, the rest do not.
  const int r_last = min(r0 + kDqRows, rows) - 1;
  int t_min, t_max, n_lo, n_hi;
  row_positions(r0, r_last, p.q_len, t_min, t_max);
  visible_key_tiles(t_min, t_max, p.q_len, p.kv_len, causal, p.window,
                    kDqKeys, n_lo, n_hi);
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
    row_keys(row % p.q_len + offset, p.kv_len, causal, p.window, lo[h],
             hi[h]);
    const size_t at = (size_t)bh * rows + row;
    l2[h] = row < rows ? lse_base2(__ldg(p.lse + at)) : 0.f;
    dt[h] = row < rows ? __ldg(p.dterm + at) : 0.f;
  }
  // kAux: each row's view of the planes, segment id and row of dbias (a
  // row past the head reads the last row's and writes nothing), and the
  // warp's scratch of a tile's segment ids.
  AuxRow ar[2] = {};
  int q_seg[2] = {0, 0};
  float* db[2] = {nullptr, nullptr};
  int* seg_warp = nullptr;
  if constexpr (kAux) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = min(ra + 8 * h, rows - 1);
      const int qh = blockIdx.y * p.group + row / p.q_len;
      ar[h] = aux_row(aux, blockIdx.z, qh, row % p.q_len, p.q_len);
      q_seg[h] = aux_q_seg(aux, blockIdx.z, row % p.q_len, p.q_len);
      if (aux.dbias && ra + 8 * h < rows)
        db[h] = aux.dbias +
                (((size_t)blockIdx.z * gridDim.y * p.group + qh) * p.q_len +
                 row % p.q_len) * p.kv_len;
    }
    seg_warp = seg_scratch[tid / 32];
  }
  const int mode = kAux ? aux_mode(aux) : kAuxNone;
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
    // this thread's columns are col0 + 8 j + {0, 1}.
    const int col0 = (n_hi - 1 - i) * kDqKeys + 2 * t4;
    if constexpr (kAux) {
      // The tile's segment ids load while the products run; then one
      // pass: P (the options after the structural masks), dS = P (dP -
      // D), dbias = dS before the cap's factor, and dS times the factor in
      // place of dP.
      SegTile<kDqKeys> seg;
      if (aux.kv_seg)
        seg.load(aux.kv_seg + (size_t)blockIdx.z * p.kv_len,
                 (n_hi - 1 - i) * kDqKeys, p.kv_len, lane);
      wgmma_wait<0>();
      fence_operands(sc);
      fence_operands(dp);
      int st[2] = {0, 0};
      if (aux.kv_seg) {
        seg.publish(seg_warp, lane);
#pragma unroll
        for (int h = 0; h < 2; ++h) st[h] = seg.state(q_seg[h]);
      }
      const bool kv_even = (p.kv_len & 1) == 0;
      // The options' mode, chosen once a tile (as the forward's).
      auto pass = [&](auto mode_c) {
        constexpr int kMode = decltype(mode_c)::value;
#pragma unroll
        for (int j = 0; j < kDqKeys / 8; ++j) {
          const int c = col0 + 8 * j;
          float x[4], f[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kCap)
              x[e] = capped_score(sc[4 * j + e], p, f[e]);
            else
              x[e] = sc[4 * j + e] * p.scale_log2e;
            if constexpr (decltype(masked)::value) {
              const int col = c + e % 2;
              if (col < lo[e / 2] || col > hi[e / 2]) x[e] = -INFINITY;
            }
          }
          aux_tile_pair<T, kMode>(ar, aux, seg_warp + 2 * t4, st, q_seg,
                                  (p.kv_len - 1) & ~1, x, c, j);
          float d_s[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            d_s[e] = exp2_approx(x[e] - l2[e / 2]) *
                     (dp[4 * j + e] - dt[e / 2]);
            dp[4 * j + e] = d_s[e] * f[e];
          }
          // dbias, beside a bias only (a mode other than kAuxNone).
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (kMode == kAuxNone || !db[h] || c >= p.kv_len) continue;
            if (kv_even) {
              *reinterpret_cast<float2*>(db[h] + c) =
                  make_float2(d_s[2 * h], d_s[2 * h + 1]);
            } else {
              db[h][c] = d_s[2 * h];
              if (c + 1 < p.kv_len) db[h][c + 1] = d_s[2 * h + 1];
            }
          }
        }
      };
      if (mode == kAuxNone)
        pass(std::integral_constant<int, kAuxNone>());
      else if (mode == kAuxPlanes16)
        pass(std::integral_constant<int, kAuxPlanes16>());
      else
        pass(std::integral_constant<int, kAuxPlanes32>());
    } else {
      wgmma_wait<1>();
      fence_operands(sc);
      // P in place of S (with the cap, P (1 - t^2), all dS needs of P).
#pragma unroll
      for (int j = 0; j < kDqKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x, f = 1.f;
          if constexpr (kCap)
            x = exp2_approx(capped_score(sc[4 * j + e], p, f) -
                            l2[e / 2]);
          else
            x = exp2_approx(fmaf(sc[4 * j + e], p.scale_log2e, -l2[e / 2]));
          if constexpr (decltype(masked)::value) {
            const int col = col0 + 8 * j + e % 2;
            if (col < lo[e / 2] || col > hi[e / 2]) x = 0.f;
          }
          sc[4 * j + e] = kCap ? x * f : x;
        }
      wgmma_wait<0>();
      fence_operands(dp);
      // dS = P (dP - D) (times 1 - t^2 with the cap), packed as the A of
      // dQ += dS K.
#pragma unroll
      for (int e = 0; e < kDqKeys / 2; ++e)
        dp[e] = sc[e] * (dp[e] - dt[e % 4 / 2]);
    }
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

// dK/dV's stage of the options (kAux, mask, mask2 or bias present): each
// warp's 16 keys by a step's kDkvRows query rows, copied by cp.async from
// the step's (batch, q head) planes, which run along the keys, and read
// down the columns from shared memory.  Rows of 16 keys: mask, mask2 (a
// byte each), then the bias (2 or 4 bytes).
// Where dK/dV's stages start in its shared memory: past `used` bytes,
// 128-aligned.
__host__ __device__ constexpr int aux_stage_offset(int used) {
  return (used + 127) / 128 * 128;
}

template <int kRows>
struct AuxStage {
  static constexpr int kKeys = 16;
  static constexpr int kMask2 = kRows * kKeys;
  static constexpr int kBias = 2 * kRows * kKeys;
  static constexpr int kBytes = kBias + kRows * kKeys * 4;
};

// One 16-byte copy into shared memory; src_bytes 0 fills zeros.
__device__ __forceinline__ void aux_cp16(void* dst, const void* src,
                                         bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

// What the staged options add to the logit of local query row tl and key
// kl of a warp's stage: the bias times log2(e), or -inf where a mask
// gates the pair off; an absent operand's slot is unread garbage that
// the selects drop.
template <typename T, int kMode, int kRows>
__device__ __forceinline__ float aux_staged(const uint8_t* ws,
                                            const AuxOperands& a, int tl,
                                            int kl) {
  using S = AuxStage<kRows>;
  const int i = tl * S::kKeys + kl;
  float add;
  if constexpr (kMode == kAuxPlanes32)
    add = reinterpret_cast<const float*>(ws + S::kBias)[i];
  else
    add = aux_widen<T>(reinterpret_cast<const uint16_t*>(ws + S::kBias)[i]);
  add = a.bias ? add * kLog2e : 0.f;
  const bool live = (ws[i] != 0 || !a.mask) & (ws[S::kMask2 + i] != 0 ||
                                              !a.mask2);
  return live ? add : -INFINITY;
}

// Grid (b * kv_heads, key tiles): every head's first key tile first.
// BwdTiles<D>::kDkvThreads threads, DkvSmem<D>::kBytes of dynamic shared
// memory.  The maps are over [b * q_heads][q_len][D] (q, do) and
// [b * kv_heads][kv_len][D] (k, v, dk, dv), 16-bit elements, boxes of 64
// columns by kDkvRows rows (q, do), kDkvKeys rows (k, v) and 64 rows (dk,
// dv).  kCap: soft-capped logits.  kAux: the options in aux.
template <typename T, int D, bool kCap, bool kAux = false>
__global__ void __launch_bounds__(BwdTiles<D>::kDkvThreads, 1)
flash_bwd_dkv90_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_do,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v,
                       const __grid_constant__ CUtensorMap map_dk,
                       const __grid_constant__ CUtensorMap map_dv,
                       BwdParams p, const AuxOperands aux) {
  using namespace sm90;
  using L = DkvSmem<D>;
  using Keys = typename L::Kept;
  using Rows = typename L::Stream;
  constexpr bool kFp16 = std::is_same<T, __half>::value;
  constexpr int kS = BwdTiles<D>::kStages;
  constexpr int kR = BwdTiles<D>::kDkvRows;
  constexpr int kDkvKeys = BwdTiles<D>::kDkvKeys;
  constexpr bool kSplit = BwdTiles<D>::kDkvSplit;
  constexpr int kCols = BwdTiles<D>::kDkvCols;
  constexpr int kWarps = BwdTiles<D>::kDkvThreads / 32;
  static_assert(!kAux || D <= 128, "the options at D 64 and 128");
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
  int m_lo, m_hi;
  visible_query_tiles(j0, j_last, p.q_len, p.kv_len, causal, p.window, kR,
                      m_lo, m_hi);
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

  // Warpgroup wg takes keys 64 wg .. 64 wg + 63 of the block (kSplit:
  // all 64 keys, and columns wg kCols .. wg kCols + kCols - 1 of dK and
  // dV); this thread keys ka and ka + 8 of them (the rows of the
  // accumulator layout).  Each warpgroup issues its products also where
  // its keys lie past kv_len (their rows are not stored).
  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
  const int warp = tid / 32 % 4, t4 = lane % 4;
  const int k0 = kSplit ? j0 : j0 + 64 * wg;  // the warpgroup's first key
  const int ka = k0 + 16 * warp + lane / 4;
  // The query rows that see each key, [lo, hi].
  int lo[2], hi[2];
  // kAux: the keys whose options a thread reads (clamped) and their
  // segment ids.
  int key[2], kv_id[2] = {0, 0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    key[h] = ka + 8 * h;
    lo[h] = causal ? key[h] - offset : 0;
    hi[h] = p.window > 0 ? key[h] - offset + p.window - 1 : p.q_len - 1;
    key[h] = min(key[h], p.kv_len - 1);
  }
  // kAux: the batch, where its query segment ids start, and the options'
  // mode.
  const int batch = kAux ? bh / p.kv_heads : 0;
  const int mode = kAux ? aux_mode(aux) : kAuxNone;
  const size_t b_q = (size_t)batch * p.q_len;
  if constexpr (kAux)
    if (aux.kv_seg)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        kv_id[h] = __ldg(aux.kv_seg + (size_t)batch * p.kv_len + key[h]);
  const int key_row = kSplit ? 0 : wg * 64 * 128;  // in a panel
  const uint8_t* k_wg = smem + L::kA + key_row;
  const uint8_t* v_wg = smem + L::kB + key_row;
  // The first of the warpgroup's columns in a streamed panel's offsets.
  const int col_panel = kSplit ? wg * (kCols / 64) * Rows::kPanel : 0;

  float dk[kCols / 2], dv[kCols / 2], st[kR / 2], dpt[kR / 2];
#pragma unroll
  for (int e = 0; e < kCols / 2; ++e) dk[e] = dv[e] = 0.f;
#pragma unroll
  for (int e = 0; e < kR / 2; ++e) st[e] = dpt[e] = 0.f;
  uint32_t pa[kR / 16][4], da[kR / 16][4];
  // Each warp's copy of a step's L (base 2) and D, [0] and [1], as pairs
  // of columns: the thread that needs column 8 j + 2 t4 + {0, 1} reads
  // pair 4 j + t4, which the lane that loaded it wrote.
  __shared__ float2 scratch[kWarps][2][kR / 2];
  // kAux: the step's query segment ids, handed out the same way.
  __shared__ int2 seg_scratch[kAux ? kWarps : 1][kAux ? kR / 2 : 1];
  // kAux: this warp's stage of a step's mask, mask2 and bias (dynamic
  // shared memory past the barriers; see launch_dkv).
  using Stage = AuxStage<kR>;
  uint8_t* ws = smem + aux_stage_offset(L::kBar + (1 + 2 * kS) * 8) +
                (tid / 32) * Stage::kBytes;

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
    // kAux: the planes of the step's (batch, q head), and the rows'
    // segment ids (rows past q_len read the last row's).
    AuxRow ap{};
    int2 qs[kR / 64];
    if constexpr (kAux) {
      ap = aux_row(aux, batch, (bh % p.kv_heads) * p.group + i / per, 0,
                   p.q_len);
      if (mode != kAuxNone) {
        // The warp's 16 keys by the step's rows into its stage, two rows
        // a lane; a row past q_len or keys past kv_len fill zeros.
        __syncwarp();  // the warp's reads of the last step's stage
        const int kw0 = ka - lane / 4;  // the warp's first key
        const int kc = min(kw0, aux.ld - Stage::kKeys);
#pragma unroll
        for (int r = lane; r < kR; r += 32) {
          const int t = m * kR + r;
          const bool in = kw0 < p.kv_len && t < p.q_len;
          const size_t at = (size_t)min(t, p.q_len - 1) * aux.ld + kc;
          if (aux.mask) aux_cp16(ws + r * 16, ap.mask + at, in);
          if (aux.mask2)
            aux_cp16(ws + Stage::kMask2 + r * 16, ap.mask2 + at, in);
          if (aux.bias) {
            if (aux.bias_f32) {
#pragma unroll
              for (int c = 0; c < 4; ++c)
                aux_cp16(ws + Stage::kBias + r * 64 + 16 * c,
                         static_cast<const float*>(ap.bias) + at + 4 * c,
                         in);
            } else {
#pragma unroll
              for (int c = 0; c < 2; ++c)
                aux_cp16(ws + Stage::kBias + r * 32 + 16 * c,
                         static_cast<const uint16_t*>(ap.bias) + at + 8 * c,
                         in);
            }
          }
        }
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      }
    }
#pragma unroll
    for (int u = 0; u < kR / 64; ++u) {
      const int t = m * kR + 64 * u + 2 * lane;
      lv[u].x = t < p.q_len ? lse_base2(__ldg(p.lse + base + t)) : 0.f;
      lv[u].y = t + 1 < p.q_len ? lse_base2(__ldg(p.lse + base + t + 1))
                                : 0.f;
      dv_[u].x = t < p.q_len ? __ldg(p.dterm + base + t) : 0.f;
      dv_[u].y = t + 1 < p.q_len ? __ldg(p.dterm + base + t + 1) : 0.f;
      if constexpr (kAux) {
        qs[u] = make_int2(0, 0);  // no segments: every id 0, as kv_id
        if (aux.q_seg) {
          qs[u].x = __ldg(aux.q_seg + b_q + min(t, p.q_len - 1));
          qs[u].y = __ldg(aux.q_seg + b_q + min(t + 1, p.q_len - 1));
        }
      }
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
      if constexpr (kAux) seg_scratch[tid / 32][32 * u + lane] = qs[u];
    }
    __syncwarp();
    wgmma_wait<1>();
    fence_operands(st);
    if constexpr (kAux)
      if (mode != kAuxNone) {
        asm volatile("cp.async.wait_group 0;\n" ::: "memory");
        __syncwarp();
      }
    // P^T in place of S^T; this thread's columns are query rows
    // t0 + 8 j + {0, 1}.  With the cap, P^T is packed as dV's operand
    // here and P^T (1 - t^2) kept, which is all dS^T needs of it.
    const int t0 = m * kR + 2 * t4;
    // kAux: the options' mode, chosen once a step (as the forward's).
    auto pass = [&](auto mode_c) {
#pragma unroll
      for (int j = 0; j < kR / 8; ++j) {
        const float2 l = scratch[tid / 32][0][4 * j + t4];
        int2 q_id = make_int2(0, 0);
        if constexpr (kAux) q_id = seg_scratch[tid / 32][4 * j + t4];
        float x[4], f[4] = {1.f, 1.f, 1.f, 1.f};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if constexpr (kAux) {
            // The options after the structural masks, at query t of the
            // step's q head and key ka + 8 (e / 2), for the pairs that exist.
            const int t = t0 + 8 * j + e % 2;
            float s2 = kCap ? capped_score(st[4 * j + e], p, f[e])
                            : st[4 * j + e] * p.scale_log2e;
            bool live = true;
            if constexpr (decltype(masked)::value)
              live = t >= lo[e / 2] && t <= hi[e / 2];
            // Pairs past q_len or kv_len read the stage's zeros; their P
            // meets zero rows of dO or is not stored.
            if constexpr (decltype(mode_c)::value != kAuxNone)
              s2 += aux_staged<T, decltype(mode_c)::value, kR>(
                  ws, aux, t - m * kR, lane / 4 + 8 * (e / 2));
            if ((e % 2 ? q_id.y : q_id.x) != kv_id[e / 2]) live = false;
            x[e] = live ? exp2_approx(s2 - (e % 2 ? l.y : l.x)) : 0.f;
          } else {
            if constexpr (kCap)
              x[e] = exp2_approx(capped_score(st[4 * j + e], p, f[e]) -
                                 (e % 2 ? l.y : l.x));
            else
              x[e] = exp2_approx(
                  fmaf(st[4 * j + e], p.scale_log2e, e % 2 ? -l.y : -l.x));
            if constexpr (decltype(masked)::value) {
              const int t = t0 + 8 * j + e % 2;
              if (t < lo[e / 2] || t > hi[e / 2]) x[e] = 0.f;
            }
          }
        }
        if constexpr (kCap) {
          // pack_rs's slots of entries 4 j .. 4 j + 3.
          pa[j / 2][2 * (j % 2)] = pack2<T>(x[0], x[1]);
          pa[j / 2][2 * (j % 2) + 1] = pack2<T>(x[2], x[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) st[4 * j + e] = kCap ? x[e] * f[e] : x[e];
      }
    };
    if (!kAux || mode == kAuxNone)
      pass(std::integral_constant<int, kAuxNone>());
    else if (mode == kAuxPlanes16)
      pass(std::integral_constant<int, kAuxPlanes16>());
    else
      pass(std::integral_constant<int, kAuxPlanes32>());
    if constexpr (!kCap) pack_rs<T, kR>(pa, st);
    fence_operands(dv);
    wgmma_fence();
    rs_product<kR, kCols, kFp16>(dv, pa, d_o + col_panel, Rows::kPanel);
    wgmma_commit();
    wgmma_wait<1>();  // dP^T's product; dV's runs on
    fence_operands(dpt);
    // dS^T = P^T (dP^T - D) (times 1 - t^2 with the cap), packed as the
    // A of dK += dS^T Q.
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
    rs_product<kR, kCols, kFp16>(dk, da, q + col_panel, Rows::kPanel);
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
  // (kSplit: its columns) of K's and V's buffers, free after the last
  // product that reads them (kSplit: both warpgroups'), then TMA-stored.
  if constexpr (kSplit) __syncthreads();
  if (k0 < p.kv_len) {
    constexpr int kPanels = kCols / 64;
    const int at = key_row + (kSplit ? wg * kPanels * Keys::kPanel : 0);
    uint8_t* sk = smem + L::kA + at;
    uint8_t* sv = smem + L::kB + at;
    stage_rows<T, kCols>(sk, Keys::kPanel, dk, p.scale, warp, lane);
    stage_rows<T, kCols>(sv, Keys::kPanel, dv, 1.f, warp, lane);
    fence_proxy_async();
    named_barrier_sync(1 + wg, 128);
    if (tid % 128 == 0) {
      const int c0 = kSplit ? wg * kPanels : 0;
#pragma unroll
      for (int c = 0; c < kPanels; ++c) {
        tma_store_3d(&map_dk, sk + c * Keys::kPanel, 64 * (c0 + c), k0, bh);
        tma_store_3d(&map_dv, sv + c * Keys::kPanel, 64 * (c0 + c), k0, bh);
      }
      tma_store_wait();
    }
  }
}

// A TMA map over a [heads][rows][cols] 16-bit operand (cols the kernel's
// D, or 32 for the D 64 kernel at head dim 32), boxes of 64 columns by
// box_rows rows, 128-byte swizzled.  A tensor with no rows is mapped as
// one row of `fallback` (nothing is then loaded), so that
// cuTensorMapEncodeTiled accepts it.
bool operand_map(CUtensorMap* map, const void* base, const void* fallback,
                 int rows, long long heads, int cols, int box_rows) {
  if (rows == 0) base = fallback;
  const long long r = rows > 0 ? rows : 1;
  return sm90::tensor_map(map, base, CU_TENSOR_MAP_DATA_TYPE_UINT16, 2, cols,
                          r, heads, cols, r * cols, 64, box_rows,
                          CU_TENSOR_MAP_SWIZZLE_128B);
}

struct Operands {
  const void *q, *k, *v, *dout;
  void *dq, *dk, *dv;
  int cols;  // a row's columns: the head dim
};

template <typename T, int D, bool kCap, bool kAux>
int launch_dq(const Operands& x, const BwdParams& p, const AuxOperands& aux,
              int batch, int kv_heads, cudaStream_t s) {
  using L = DqSmem<D>;
  constexpr int kDqRows = BwdTiles<D>::kDqRows;
  constexpr int kDqKeys = BwdTiles<D>::kDqKeys;
  const long long heads = (long long)batch * kv_heads;
  const int rows = p.group * p.q_len;
  const int c = x.cols;
  CUtensorMap mq, mdo, mk, mv, mdq;
  const bool ok =
      operand_map(&mq, x.q, x.q, rows, heads, c, kDqRows) &&
      operand_map(&mdo, x.dout, x.q, rows, heads, c, kDqRows) &&
      operand_map(&mk, x.k, x.q, p.kv_len, heads, c, kDqKeys) &&
      operand_map(&mv, x.v, x.q, p.kv_len, heads, c, kDqKeys) &&
      operand_map(&mdq, x.dq, x.q, rows, heads, c, 64);
  if (!ok) return kErrTensorMap;
  if (cudaFuncSetAttribute(flash_bwd_dq90_kernel<T, D, kCap, kAux>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kBytes) != cudaSuccess)
    return (int)cudaGetLastError();
  const dim3 grid((rows + kDqRows - 1) / kDqRows, kv_heads, batch);
  flash_bwd_dq90_kernel<T, D, kCap, kAux>
      <<<grid, BwdTiles<D>::kDqThreads, L::kBytes, s>>>(mq, mdo, mk, mv,
                                                        mdq, p, aux);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kCap, bool kAux>
int launch_dkv(const Operands& x, const BwdParams& p, const AuxOperands& aux,
               int batch, int kv_heads, cudaStream_t s) {
  using L = DkvSmem<D>;
  constexpr int kDkvRows = BwdTiles<D>::kDkvRows;
  constexpr int kDkvKeys = BwdTiles<D>::kDkvKeys;
  const long long heads = (long long)batch * kv_heads;
  const int c = x.cols;
  CUtensorMap mq, mdo, mk, mv, mdk, mdv;
  const bool ok =
      operand_map(&mq, x.q, x.k, p.q_len, heads * p.group, c, kDkvRows) &&
      operand_map(&mdo, x.dout, x.k, p.q_len, heads * p.group, c,
                  kDkvRows) &&
      operand_map(&mk, x.k, x.k, p.kv_len, heads, c, kDkvKeys) &&
      operand_map(&mv, x.v, x.k, p.kv_len, heads, c, kDkvKeys) &&
      operand_map(&mdk, x.dk, x.k, p.kv_len, heads, c, 64) &&
      operand_map(&mdv, x.dv, x.k, p.kv_len, heads, c, 64);
  if (!ok) return kErrTensorMap;
  // kAux: each warp's stage of the options, past the barriers.
  constexpr int kBytes =
      kAux ? aux_stage_offset(L::kBar + (1 + 2 * BwdTiles<D>::kStages) * 8) +
                 1024 +
                 BwdTiles<D>::kDkvThreads / 32 *
                     AuxStage<BwdTiles<D>::kDkvRows>::kBytes
           : L::kBytes;
  static_assert(kBytes <= 232448, "an H100 block's shared memory");
  if (cudaFuncSetAttribute(flash_bwd_dkv90_kernel<T, D, kCap, kAux>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kBytes) != cudaSuccess)
    return (int)cudaGetLastError();
  const dim3 grid((unsigned)heads, (p.kv_len + kDkvKeys - 1) / kDkvKeys);
  flash_bwd_dkv90_kernel<T, D, kCap, kAux>
      <<<grid, BwdTiles<D>::kDkvThreads, kBytes, s>>>(mq, mdo, mk, mv, mdk,
                                                      mdv, p, aux);
  return (int)cudaGetLastError();
}

template <typename T, int D, bool kCap, bool kAux = false>
int launch_one(bool dkv, const Operands& x, const BwdParams& p,
               const AuxOperands& aux, int batch, int kv_heads,
               cudaStream_t s) {
  return dkv ? launch_dkv<T, D, kCap, kAux>(x, p, aux, batch, kv_heads, s)
             : launch_dq<T, D, kCap, kAux>(x, p, aux, batch, kv_heads, s);
}

// Head dim 64, 128 or 256, with or without the cap; with the options (aux
// non-null), 64 or 128.
template <typename T, int D>
int launch_d(bool dkv, bool capped, const Operands& x, const BwdParams& p,
             const AuxOperands* aux, int batch, int kv_heads,
             cudaStream_t s) {
  if constexpr (D <= 128) {
    if (aux)
      return capped ? launch_one<T, D, true, true>(dkv, x, p, *aux, batch,
                                                   kv_heads, s)
                    : launch_one<T, D, false, true>(dkv, x, p, *aux, batch,
                                                    kv_heads, s);
  } else {
    if (aux) return (int)cudaErrorInvalidValue;
  }
  const AuxOperands none{};
  return capped ? launch_one<T, D, true>(dkv, x, p, none, batch, kv_heads, s)
                : launch_one<T, D, false>(dkv, x, p, none, batch, kv_heads,
                                          s);
}

template <typename T>
int launch(bool dkv, bool capped, const Operands& x, const BwdParams& p,
           const AuxOperands* aux, int batch, int kv_heads, int head_dim,
           cudaStream_t s) {
  if (head_dim == 32 && !aux)  // the D 64 kernels over 32-column rows
    return launch_d<T, 64>(dkv, capped, x, p, aux, batch, kv_heads, s);
  if (head_dim == 64)
    return launch_d<T, 64>(dkv, capped, x, p, aux, batch, kv_heads, s);
  if (head_dim == 128)
    return launch_d<T, 128>(dkv, capped, x, p, aux, batch, kv_heads, s);
  if (head_dim == 256)
    return launch_d<T, 256>(dkv, capped, x, p, aux, batch, kv_heads, s);
  return (int)cudaErrorInvalidValue;
}

int run(bool dkv, const Operands& x, const void* lse, const void* dterm,
        const AuxOperands* aux, int batch, int q_heads, int kv_heads,
        int q_len, int kv_len, int head_dim, float scale, float softcap,
        int causal, int window, int is_fp16, void* stream) {
  if (kv_heads <= 0 || q_heads % kv_heads || q_len < 0 || kv_len < 0 ||
      softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.lse = static_cast<const float*>(lse);
  p.dterm = static_cast<const float*>(dterm);
  p.group = q_heads / kv_heads;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.kv_heads = kv_heads;
  p.scale = scale;
  p.scale_log2e = scale * kLog2e;
  p.cap2 = softcap * kLog2e;
  p.inv_cap2 = softcap > 0.f ? 1.f / p.cap2 : 0.f;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool capped = softcap > 0.f;
  return is_fp16 ? launch<__half>(dkv, capped, x, p, aux, batch, kv_heads,
                                  head_dim, s)
                 : launch<__nv_bfloat16>(dkv, capped, x, p, aux, batch,
                                         kv_heads, head_dim, s);
}

}  // namespace

extern "C" {

// q, k, v, dout contiguous, 16-byte aligned; lse and dterm float32.
// dq like q; is_fp16 selects fp16 (else bf16) for q, k, v, dout and dq.
// head_dim 32 (no aux), 64, 128 or 256.  softcap > 0 soft-caps the
// scaled logits (the forward's lse must be the capped logits'); 0: none.
// window <= 0: none.
// aux: the options (attention_common.cuh `AuxOperands`; dQ writes dbias
// where aux->dbias is not null), or null for none; at head_dim 64 or 128.
// Returns kErrTensorMap when cuTensorMapEncodeTiled refuses a TMA map.
int mfa_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dterm,
                     void* dq, int batch, int q_heads, int kv_heads,
                     int q_len, int kv_len, int head_dim, float scale,
                     float softcap, int causal, int window, int is_fp16,
                     const AuxOperands* aux, void* stream) {
  if (batch == 0 || q_len == 0) return 0;
  const Operands x{q, k, v, dout, dq, nullptr, nullptr, head_dim};
  return run(false, x, lse, dterm, aux, batch, q_heads, kv_heads, q_len,
             kv_len, head_dim, scale, softcap, causal, window, is_fp16,
             stream);
}

// dk/dv like k, the GQA group summed in the kernel.
int mfa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dterm,
                      void* dk, void* dv, int batch, int q_heads,
                      int kv_heads, int q_len, int kv_len, int head_dim,
                      float scale, float softcap, int causal, int window,
                      int is_fp16, const AuxOperands* aux, void* stream) {
  if (batch == 0 || kv_len == 0) return 0;
  const Operands x{q, k, v, dout, nullptr, dk, dv, head_dim};
  return run(true, x, lse, dterm, aux, batch, q_heads, kv_heads, q_len,
             kv_len, head_dim, scale, softcap, causal, window, is_fp16,
             stream);
}

const char* mfa_cuda_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a TMA map of the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
