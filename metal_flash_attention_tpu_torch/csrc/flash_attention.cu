// Fused flash-attention forward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces two TPU kernels of metal_flash_attention_tpu/ops/flash_attention.py:
//   _make_fwd_kernel          (pallas_call at :1253), the grid kernel that
//                             skips invisible KV blocks with a guard;
//   _make_fwd_kernel_dynamic  (pallas_call at :1097), the variant whose KV
//                             loop visits only the visible blocks.
// One kernel does both: each block's key loop runs over the key tiles its
// rows can see and no others, which is row 3's design and makes row 2's
// skip guard and index clamps unnecessary.
//
// O = softmax(Q K^T * scale) V and the natural-log row logsumexp, for
// q [b, q_heads, q_len, D] and k/v [b, kv_heads, kv_len, D] (GQA: q head
// h reads kv head h / group), D = 64 or 128, bf16 or fp16.  Causal masking
// is aligned bottom-right (offset = kv_len - q_len); a window w keeps keys
// > qpos - w.  A row that sees no key gives o = 0 and lse = -inf.
//
// Bound: at the training shapes (causal, q_len = kv_len = 8192, D = 128)
// the work is 4 * D FLOPs per visible (row, key) pair against ~170 MB of
// HBM traffic, so the tensor cores bound it.  The design (warp-specialised,
// after FlashAttention-3):
// - A block takes kBQ group-major query rows of one kv head (row
//   g * q_len + t is query t of q head h * group + g), so one K/V tile
//   serves the whole group.  Three warpgroups.  Warpgroup 0 gives up its
//   registers (setmaxnreg 24) and one of its threads issues the TMA loads:
//   Q once, then each visible key tile's K and V into a ring of stages.
//   K and V have their own full and empty barriers: QK^T starts before V
//   lands, and a K slot is free again once its QK^T is done, when each of
//   the 8 consumer warps has arrived.  Warpgroups 1 and 2 (setmaxnreg
//   240) take 64 rows each.
// - S = Q K^T is an SS wgmma (Q and K both K-major, in 128-byte swizzled
//   panels of 64 columns).  The online softmax runs on the accumulators
//   in fp32 in the exp2 domain, scale * log2(e) folded into the scores.
//   P is packed to 16 bits in registers, where the accumulator layout of
//   a k16 column slice is the A operand's, and O += P V is an RS wgmma
//   with V as an MN-major B: no score leaves registers.  One warpgroup's
//   softmax runs beside the other's products.  FlashAttention-3's
//   overlaps (tile i's QK^T issued before tile i - 1's PV, and the
//   warpgroups taking turns on named barriers) keep S, P and O live at
//   once: about 195 registers a thread at D 128.  ptxas holds a wgmma
//   kernel to the budget of its block in whole warpgroups, 168 at three,
//   whatever setmaxnreg asks, so they spilled at 128 keys a tile and at
//   64 keys ran slower than this loop (tools/flash_fwd_ablation.py).
// - The key loop runs from the last visible tile down.  The tiles that
//   cross the causal diagonal or kv_len come first and test each key;
//   then the tiles every row sees whole, with no test; then those at a
//   window's edge, tested.
// - Causal grids take the heaviest row tiles first, so the light ones
//   fill the tail.
// - The epilogue stages a 16-bit O in the warpgroup's own rows of Q's
//   buffer and writes it with TMA stores, clipped to the head's rows (the
//   maps' row extent is the head's); a float32 O is stored from the
//   fragments.
//
// Every function returns cudaGetLastError() after its launch.

#include <type_traits>

#include "attention_common.cuh"
#include "flash_tiles.cuh"
#include "hopper_common.cuh"

namespace {

using namespace mfa;

constexpr int kBQ = MFA_FWD90_BLOCK_Q;    // query rows per block
constexpr int kBKV = MFA_FWD90_BLOCK_KV;  // keys per tile
constexpr int kThreads = 384;
constexpr int kConsumers = 256;
constexpr int kErrTensorMap = 10000;  // cuTensorMapEncodeTiled refused
static_assert(kBQ == 2 * 64, "two consumer warpgroups of 64 rows");
static_assert(kBKV == 64 || kBKV == 128 || kBKV == 256,
              "the N of an SS wgmma");

struct FwdParams {
  float* o32;   // O when it is float32 (stored from the fragments)
  float* lse;   // [b, q_heads, q_len], natural log
  int rows;     // group * q_len: the rows of one kv head
  int q_len, kv_len;
  float scale_log2e;
  int causal, window;
};

// Shared memory of a block at head dim D: Q, the K and V stages, the
// barriers, and room to align the whole to 1024 bytes.  Each operand is
// D / 64 panels of 64 columns (128-byte rows), 128-byte swizzled.
template <int D>
struct Smem {
  static constexpr int kPanels = D / 64;
  static constexpr int kQPanel = kBQ * 128;
  static constexpr int kKVPanel = kBKV * 128;
  static constexpr int kQ = kPanels * kQPanel;
  static constexpr int kTile = kPanels * kKVPanel;  // one K or V tile
  static constexpr int kStages = MFA_FWD90_STAGES;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + (1 + 4 * kStages) * 8 + 1024;
  static_assert(kStages >= 2, "a ring");
  static_assert(kBytes <= 232448, "an H100 block's shared memory");
};

// The row tile that block x of a row of `tiles` takes.  Causal work grows
// with a row's position t, so the heaviest tiles go first: when the tiles
// align with the q heads, by descending t across the group's heads;
// otherwise in reverse order.
__device__ __forceinline__ int row_tile(const FwdParams& p, int x,
                                        int tiles) {
  if (!p.causal) return x;
  if (p.q_len % kBQ) return tiles - 1 - x;
  const int per = p.q_len / kBQ, group = p.rows / p.q_len;
  return x % group * per + per - 1 - x / group;
}

// S = Q K^T over one key tile, issued and committed: 64 rows of Q (this
// warpgroup's) and the tile's keys, both K-major.
template <int D, bool kFp16>
__device__ __forceinline__ void issue_qk(float (&sc)[kBKV / 2],
                                         const uint8_t* q, const uint8_t* k) {
  using namespace sm90;
  fence_operands(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<kBKV, 0, kFp16>(
        sc, smem_desc(q + kk / 4 * Smem<D>::kQPanel + kk % 4 * 32, 16, 1024),
        smem_desc(k + kk / 4 * Smem<D>::kKVPanel + kk % 4 * 32, 16, 1024),
        kk > 0);
  wgmma_commit();
}

// O += P V over one key tile, issued and committed: P from registers, V
// as an MN-major B (its D axis contiguous).
template <int D, bool kFp16>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&pa)[kBKV / 16][4],
                                         const uint8_t* v) {
  using namespace sm90;
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBKV / 16; ++kk)
    wgmma_rs<D, 1, kFp16>(o, pa[kk],
                          smem_desc(v + kk * 2048, Smem<D>::kKVPanel, 1024));
  wgmma_commit();
}

// One key tile's online softmax for a thread's two rows: the scores sc
// scaled into the exp2 domain (keys outside [lo, hi] to -inf when kMask;
// this thread's columns are col0 + 8 j + {0, 1}), the running max m, the
// factor alpha by which the sums so far shrink, and P = exp2(s - m) in
// place of sc, summed into l.  A row that has seen no key keeps m = -inf
// and P = 0.
template <bool kMask>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBKV / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             float scale_log2e, int col0,
                                             const int (&lo)[2],
                                             const int (&hi)[2]) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBKV / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * j + e] * scale_log2e;
      if constexpr (kMask) {
        const int col = col0 + 8 * j + e % 2;
        if (col < lo[e / 2] || col > hi[e / 2]) x = -INFINITY;
      }
      sc[4 * j + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  float base[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float mn = fmaxf(m[h], quad_max(mx[h]));
    base[h] = mn == -INFINITY ? 0.f : mn;
    alpha[h] = exp2_approx(m[h] - base[h]);
    m[h] = mn;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int e = 0; e < kBKV / 2; ++e) {
    sc[e] = exp2_approx(sc[e] - base[e % 4 / 2]);
    l[e % 4 / 2] += sc[e];
  }
}

// Grid (row tiles, kv_heads, batch), kThreads threads, Smem<D>::kBytes of
// dynamic shared memory.  The maps are over [b * kv_heads][rows][D] (q,
// o) and [b * kv_heads][kv_len][D] (k, v), 16-bit elements, boxes of 64
// columns by kBQ rows (q), kBKV rows (k, v) and 64 rows (o).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd90_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o, FwdParams p) {
  using namespace sm90;
  using L = Smem<D>;
  constexpr bool kFp16 = std::is_same<T, __half>::value;
  constexpr int kS = L::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kS;
  uint64_t* k_empty = v_full + kS;
  uint64_t* v_empty = k_empty + kS;

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int r0 = row_tile(p, blockIdx.x, gridDim.x) * kBQ;
  const int offset = p.kv_len - p.q_len;
  const bool causal = p.causal != 0;

  // Keys any row of this tile can see, [col_lo, col_hi], as key tiles
  // [n_lo, n_hi); of those, every row sees tiles [u_lo, u_hi) whole.
  // Loop step i takes tile n_hi - 1 - i: steps [0, open_begin) and
  // [open_end, n_tiles) test each key, the rest do not.
  const int r_last = min(r0 + kBQ, p.rows) - 1;
  int t_min = 0, t_max = p.q_len - 1;
  if (r0 / p.q_len == r_last / p.q_len) {
    t_min = r0 % p.q_len;
    t_max = r_last % p.q_len;
  }
  const int col_hi =
      causal ? min(p.kv_len - 1, offset + t_max) : p.kv_len - 1;
  const int col_lo = p.window > 0 ? max(0, offset + t_min - p.window + 1) : 0;
  const int n_lo = col_lo / kBKV;
  const int n_hi = col_hi >= col_lo ? col_hi / kBKV + 1 : n_lo;
  const int n_tiles = n_hi - n_lo;
  int u_hi = p.kv_len / kBKV;
  if (causal) u_hi = min(u_hi, max(0, offset + t_min + 1) / kBKV);
  u_hi = max(n_lo, min(u_hi, n_hi));
  int u_lo = 0;
  if (p.window > 0)
    u_lo = (max(0, offset + t_max - p.window + 1) + kBKV - 1) / kBKV;
  u_lo = max(n_lo, min(u_lo, u_hi));
  const int open_begin = n_hi - u_hi, open_end = n_hi - u_lo;

  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kS; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], kConsumers / 32);
      mbar_init(&v_empty[s], kConsumers / 32);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // The warpgroup, read through a shuffle so that ptxas sees it uniform
  // across each warp: wgmma in a path it cannot prove uniform is
  // serialised.
  const int role = __shfl_sync(0xffffffff, tid / 128, 0);
  if (role == 0) {
    // Producer: Q, then K and V of loop step i (tile n_hi - 1 - i) into
    // stage i % kS; K of step i beside V of step i - 1, since a K slot
    // frees a step's softmax and PV before its V slot does.
    setmaxnreg_dec<24>();
    if (tid == 0 && n_tiles > 0) {
      prefetch_tensor_map(&map_q);
      prefetch_tensor_map(&map_k);
      prefetch_tensor_map(&map_v);
      mbar_arrive_expect_tx(q_full, L::kQ);
#pragma unroll
      for (int c = 0; c < L::kPanels; ++c)
        tma_load_3d(smem + c * L::kQPanel, &map_q, q_full, 64 * c, r0, bh);
      for (int i = 0; i <= n_tiles; ++i)
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {  // K of step i, V of step i - 1
          const int t = i - kv;
          if (t < 0 || t >= n_tiles) continue;
          const int s = t % kS, j0 = (n_hi - 1 - t) * kBKV;
          uint64_t* full = (kv ? v_full : k_full) + s;
          if (t >= kS) mbar_wait((kv ? v_empty : k_empty) + s,
                                 (t / kS - 1) & 1);
          uint8_t* dst = smem + (kv ? L::kV : L::kK) + s * L::kTile;
          mbar_arrive_expect_tx(full, L::kTile);
#pragma unroll
          for (int c = 0; c < L::kPanels; ++c)
            tma_load_3d(dst + c * L::kKVPanel, kv ? &map_v : &map_k, full,
                        64 * c, j0, bh);
        }
    }
  } else {
    // Consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile;
    // this thread rows ra and ra + 8 of them (the accumulator layout).
    setmaxnreg_inc<240>();
    const int wg = role - 1, warp = tid / 32 % 4, t4 = lane % 4;
    const int ra = r0 + 64 * wg + 16 * warp + lane / 4;
    const int row[2] = {ra, ra + 8};
    // Each row's visible keys [lo, hi].
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qpos = row[h] % p.q_len + offset;
      hi[h] = causal ? min(qpos, p.kv_len - 1) : p.kv_len - 1;
      lo[h] = p.window > 0 ? qpos - p.window + 1 : 0;
    }
    const uint8_t* q_wg = smem + wg * 64 * 128;

    float o[D / 2], sc[kBKV / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];
    uint32_t pa[kBKV / 16][4];

    // One arrival a warp frees a stage (256 on one barrier would
    // serialise).
    auto release = [&](uint64_t* empty, int i) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[i % kS]);
    };

    // Every warpgroup issues its products, also where its rows lie past
    // the head (their outputs are not stored): a wgmma under a branch is
    // serialised.  One key tile (loop step i), with or without the test
    // on keys.
    auto step = [&](int i, auto masked) {
      const int s = i % kS;
      const uint32_t phase = (i / kS) & 1;
      mbar_wait(&k_full[s], phase);
      issue_qk<D, kFp16>(sc, q_wg, smem + L::kK + s * L::kTile);
      wgmma_wait<0>();
      fence_operands(sc);
      release(k_empty, i);
      softmax_tile<decltype(masked)::value>(
          sc, m, l, alpha, p.scale_log2e, (n_hi - 1 - i) * kBKV + 2 * t4, lo,
          hi);
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[e % 4 / 2];
      pack_rs<T, kBKV>(pa, sc);
      mbar_wait(&v_full[s], phase);
      issue_pv<D, kFp16>(o, pa, smem + L::kV + s * L::kTile);
      wgmma_wait<0>();
      fence_operands(o);
      release(v_empty, i);
    };

    if (n_tiles > 0) mbar_wait(q_full, 0);
    int i = 0;
    for (; i < open_begin; ++i) step(i, std::true_type());
    for (; i < open_end; ++i) step(i, std::false_type());
    for (; i < n_tiles; ++i) step(i, std::true_type());

    // Epilogue: normalise; lse; O.
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] = quad_sum(l[h]);
      inv[h] = l[h] > 0.f ? 1.f / l[h] : 0.f;
      if (t4 == 0 && row[h] < p.rows)
        p.lse[(size_t)bh * p.rows + row[h]] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : -INFINITY;
    }
    if (p.o32) {
      float* out = p.o32 + (size_t)bh * p.rows * D;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] >= p.rows) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(out + (size_t)row[h] * D + 8 * j +
                                     2 * t4) =
              make_float2(o[4 * j + 2 * h] * inv[h],
                          o[4 * j + 2 * h + 1] * inv[h]);
      }
    } else if (r0 + 64 * wg < p.rows) {
      // This warpgroup's rows of Q's buffer are free after its last QK^T:
      // stage O there in the same swizzled panels, then TMA-store them.
      uint8_t* stage = smem + wg * 64 * 128;
      const int r = 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          *reinterpret_cast<uint32_t*>(stage + j / 8 * L::kQPanel +
                                       swizzle128(r + 8 * h, j % 8) + 4 * t4) =
              pack2<T>(o[4 * j + 2 * h] * inv[h],
                       o[4 * j + 2 * h + 1] * inv[h]);
      fence_proxy_async();
      named_barrier_sync(1 + wg, 128);
      if (tid % 128 == 0) {
#pragma unroll
        for (int c = 0; c < L::kPanels; ++c)
          tma_store_3d(&map_o, stage + c * L::kQPanel, 64 * c,
                       r0 + 64 * wg, bh);
        tma_store_wait();
      }
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const FwdParams& p, int batch, int kv_heads, cudaStream_t s) {
  using L = Smem<D>;
  const long long heads = (long long)batch * kv_heads;
  const auto u16 = CU_TENSOR_MAP_DATA_TYPE_UINT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // With no keys nothing is loaded; the K/V maps then cover q, so that
  // cuTensorMapEncodeTiled accepts them.
  const int kv_rows = p.kv_len > 0 ? p.kv_len : 1;
  const void* kb = p.kv_len > 0 ? k : q;
  const void* vb = p.kv_len > 0 ? v : q;
  CUtensorMap mq, mk, mv, mo;
  const bool ok =
      sm90::tensor_map(&mq, q, u16, 2, D, p.rows, heads, D,
                       (long long)p.rows * D, 64, kBQ, sw) &&
      sm90::tensor_map(&mk, kb, u16, 2, D, kv_rows, heads, D,
                       (long long)kv_rows * D, 64, kBKV, sw) &&
      sm90::tensor_map(&mv, vb, u16, 2, D, kv_rows, heads, D,
                       (long long)kv_rows * D, 64, kBKV, sw) &&
      sm90::tensor_map(&mo, p.o32 ? q : o, u16, 2, D, p.rows, heads, D,
                       (long long)p.rows * D, 64, 64, sw);
  if (!ok) return kErrTensorMap;
  if (cudaFuncSetAttribute(flash_fwd90_kernel<T, D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kBytes) != cudaSuccess)
    return (int)cudaGetLastError();
  const dim3 grid((p.rows + kBQ - 1) / kBQ, kv_heads, batch);
  flash_fwd90_kernel<T, D><<<grid, kThreads, L::kBytes, s>>>(mq, mk, mv, mo,
                                                             p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const FwdParams& p, int batch, int kv_heads, int head_dim,
             cudaStream_t s) {
  if (head_dim == 64) return launch<T, 64>(q, k, v, o, p, batch, kv_heads, s);
  if (head_dim == 128)
    return launch<T, 128>(q, k, v, o, p, batch, kv_heads, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v contiguous, 16-byte aligned.  o: q's dtype, or float32 when
// o_f32; lse: float32.  is_fp16 selects fp16 inputs (else bf16).
// window <= 0: none.  Returns kErrTensorMap when cuTensorMapEncodeTiled
// refuses a TMA map.
int mfa_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int batch, int q_heads, int kv_heads, int q_len,
                  int kv_len, int head_dim, float scale, int causal,
                  int window, int is_fp16, int o_f32, void* stream) {
  if (batch == 0 || q_len == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads || kv_len < 0)
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.o32 = o_f32 ? static_cast<float*>(o) : nullptr;
  p.lse = static_cast<float*>(lse);
  p.rows = q_heads / kv_heads * q_len;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.scale_log2e = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_fp16
             ? launch_d<__half>(q, k, v, o, p, batch, kv_heads, head_dim, s)
             : launch_d<__nv_bfloat16>(q, k, v, o, p, batch, kv_heads,
                                       head_dim, s);
}

const char* mfa_cuda_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a TMA map of the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
