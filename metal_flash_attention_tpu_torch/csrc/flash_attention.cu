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
// h reads kv head h / group), D = 32, 64, 128 or 256, bf16 or fp16.  Causal
// masking is aligned bottom-right (offset = kv_len - q_len); a window w
// keeps keys > qpos - w.  A row that sees no key gives o = 0 and lse =
// -inf.
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
// - Quantized K/V (INT8, FP8-E4M3, FP8-E5M2, NF4 split-half along D; one
//   scale per (batch, kv head), ops/quantization.py's layout) replaces the
//   TPU kernels' in-kernel `dequant_block` (:272-273, :309-326 and
//   :617-618, :680-686 of the JAX file).  The producer's TMA loads each
//   tile in its storage type ([b * kv_heads][kv_len][D or D / 2] bytes)
//   into a ring of raw stages; its warpgroup (all 128 threads) decodes a
//   stage into the bf16 K and V ring slots, in the swizzled panels the SS
//   and RS wgmma read, and one thread arrives on the slot's full barrier
//   after a named barrier of the warpgroup.  Every INT8 and FP8 value is
//   a bf16, so no scale enters the tiles: the block's K scale joins the
//   softmax scale (lse is that of the scaled logits) and its V scale
//   multiplies O in the epilogue.  NF4's codebook is rounded to bf16 (a
//   256-entry byte table in shared memory).  The kernel is templated on
//   the precision (a branch around wgmma would serialise it); queries are
//   bf16.
//
// - Gemma-2 (the TPU kernels' `logit_softcap`, :243, :250, :339-340 and
//   :567, :601, :746-747, and head_dim 256).  softcap > 0 soft-caps each
//   scaled logit in the exp2 domain before the mask (`softcap` in
//   attention_common.cuh); the running max, P and lse are the capped
//   logits'.  The cap is a template flag (kCap), so the uncapped kernels
//   are unchanged.  At D 256 a consumer's O is 128 floats a thread: with
//   S and P of a 128-key tile it would not fit the 168 registers ptxas
//   gives a thread of a three-warpgroup block, and two consumer
//   warpgroups with 64-key tiles still come to ~176 plus addresses.  So
//   D 256 has its own tiles (FwdTiles<256>): one consumer warpgroup of 64
//   rows beside the producer (256 threads, up to 255 registers a thread,
//   no setmaxnreg), 64-key tiles (N of the SS wgmma), O += P V as an RS
//   m64n256k16; Q (32 KB) and two stages of K and V (128 KB) fit the
//   block's shared memory.  Quantized K/V stay at D 64 and 128.
//
// - The options (the TPU kernel's mask, mask2 and bias refs, :274-278,
//   added after the cap at :341-360 and gating p at :447; its segment
//   compare, :371-420 and :619-620, :671, :695-700 of the dynamic one; the
//   broadcast and repeat of mask and bias by b % B, h % H, :1166-1215).
//   A template flag (kAux) beside kCap, so the kernels without it are the
//   same code; inside it, null pointers in AuxOperands say which operands
//   are present.  D 64 and 128, bf16 and fp16, capped or not.  Each
//   consumer thread reads its fragment's mask and bias values straight
//   from global memory, its two side-by-side keys in one load, every load
//   unconditional so that a tile's loads issue together (attention_common
//   .cuh `aux_pair`), and adds them after the structural masks (a masked
//   key stays -inf): the bias joins the logit, a gated pair becomes -inf,
//   so a row with no live key keeps l = 0 (o = 0, lse = -inf) and a gated
//   logit never holds a row's running max.  A tile's segment ids load, 4 a
//   lane, while its QK^T runs; a warp shares them and their range through
//   shared memory (`SegTile`), so only a tile with a segment boundary in
//   it tests key by key.  No tile is
//   skipped for its segments: the ids need not be sorted.  The low
//   precision L residual is a cast of lse after the kernel
//   (ops/flash_attention.py).
//
// - Head dim 32 (the tiny configs': `entry()` and the small training
//   meshes; the TPU kernels take any head dim, :944-948 of the JAX file).
//   A 32-column bf16 row is 64 bytes, half a 128-byte swizzled panel, and
//   the SS / RS wgmma wrappers and every panel loop assume whole 64-column
//   panels.  So a D 32 call runs the D 64 kernel over TMA maps whose rows
//   are 32 columns: each load's 64-column box reaches 32 columns past the
//   row, which TMA fills with zeros (and counts in the barrier's bytes), so
//   Q and K carry zeros in columns 32..63, S = Q K^T is unchanged, and O's
//   columns 32..63 come out as P times V's zeros; each store's box is
//   clipped to the tensor, so only the 32 real columns are written (a
//   float32 O, stored from the fragments, skips them by `o_cols`).  Nothing
//   is padded on the host.  The cost is D 64's products and shared memory
//   at D 32's HBM bytes: simple first.
//
// Every function returns cudaGetLastError() after its launch.

#include <type_traits>

#include "attention_common.cuh"
#include "flash_tiles.cuh"
#include "hopper_common.cuh"
#include "quant_common.cuh"

namespace {

using namespace mfa;

constexpr int kErrTensorMap = 10000;  // cuTensorMapEncodeTiled refused

// The tiles at head dim D: query rows a block (64 a consumer warpgroup),
// keys a ring tile, and the block's threads (a producer warpgroup and the
// consumers).
template <int D>
struct FwdTiles {
  static constexpr bool kWide = D > 128;
  static constexpr int kBQ = kWide ? MFA_FWD90_D256_BLOCK_Q
                                   : MFA_FWD90_BLOCK_Q;
  static constexpr int kBKV = kWide ? MFA_FWD90_D256_BLOCK_KV
                                    : MFA_FWD90_BLOCK_KV;
  static constexpr int kStages = kWide ? MFA_FWD90_D256_STAGES
                                       : MFA_FWD90_STAGES;
  static constexpr int kConsumerGroups = kBQ / 64;
  static constexpr int kConsumers = 128 * kConsumerGroups;
  static constexpr int kThreads = 128 + kConsumers;
  static_assert(kBQ % 64 == 0 && kConsumerGroups <= 2,
                "one or two consumer warpgroups of 64 rows");
  static_assert(kBKV == 64 || kBKV == 128 || kBKV == 256,
                "the N of an SS wgmma");
  static_assert(D == 64 || D == 128 || D == 256, "D 64, 128 or 256");
};

struct FwdParams {
  float* o32;   // O when it is float32 (stored from the fragments)
  int o_cols;   // the columns of a stored row: D, or 32 run at D 64
  float* lse;   // [b, q_heads, q_len], natural log
  const float* k_scales;  // [b * kv_heads] (quantized K/V only)
  const float* v_scales;
  int rows;     // group * q_len: the rows of one kv head
  int q_len, kv_len;
  float scale_log2e;
  float cap2, inv_cap2;  // the soft cap in the exp2 domain (kCap kernels)
  int causal, window;
};

// Shared memory of a block at head dim D and K/V storage precision P: Q,
// the K and V stages, for quantized K/V the raw stages (K then V a stage,
// D or D / 2 bytes a key) and NF4's byte table, the barriers, and room to
// align the whole to 1024 bytes.  Each 16-bit operand is D / 64 panels of
// 64 columns (128-byte rows), 128-byte swizzled.
template <int D, int P = kUnquantized>
struct Smem {
  static constexpr int kBQ = FwdTiles<D>::kBQ;
  static constexpr int kBKV = FwdTiles<D>::kBKV;
  static constexpr bool kQuant = P != kUnquantized;
  static constexpr int kPanels = D / 64;
  static constexpr int kQPanel = kBQ * 128;
  static constexpr int kKVPanel = kBKV * 128;
  static constexpr int kQ = kPanels * kQPanel;
  static constexpr int kTile = kPanels * kKVPanel;  // one K or V tile
  static constexpr int kStages = FwdTiles<D>::kStages;
  static constexpr int kRawRow = P == kPrecNf4 ? D / 2 : D;  // bytes a key
  static constexpr int kRawTile = kQuant ? kBKV * kRawRow : 0;
  static constexpr int kRawStages = kQuant ? MFA_FWD90_RAW_STAGES : 0;
  static constexpr int kK = kQ;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kRaw = kV + kStages * kTile;
  static constexpr int kTable = kRaw + kRawStages * 2 * kRawTile;
  static constexpr int kBar = kTable + (P == kPrecNf4 ? 256 * 4 : 0);
  static constexpr int kBytes =
      kBar + (1 + 4 * kStages + kRawStages) * 8 + 1024;
  static_assert(kStages >= 2, "a ring");
  static_assert(!kQuant || kRawStages >= 2, "a raw ring");
  static_assert(kRawRow % 16 == 0, "16-byte pieces of a stored key");
  static_assert(kBytes <= 232448, "an H100 block's shared memory");
};

// The row tile that block x of a row of `tiles` (of kBQ rows) takes.
// Causal work grows with a row's position t, so the heaviest tiles go
// first: when the tiles align with the q heads, by descending t across the
// group's heads; otherwise in reverse order.
template <int kBQ>
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
__device__ __forceinline__ void issue_qk(float (&sc)[FwdTiles<D>::kBKV / 2],
                                         const uint8_t* q, const uint8_t* k) {
  using namespace sm90;
  fence_operands(sc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<FwdTiles<D>::kBKV, 0, kFp16>(
        sc, smem_desc(q + kk / 4 * Smem<D>::kQPanel + kk % 4 * 32, 16, 1024),
        smem_desc(k + kk / 4 * Smem<D>::kKVPanel + kk % 4 * 32, 16, 1024),
        kk > 0);
  wgmma_commit();
}

// O += P V over one key tile, issued and committed: P from registers, V
// as an MN-major B (its D axis contiguous).
template <int D, bool kFp16>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&pa)[FwdTiles<D>::kBKV / 16][4],
    const uint8_t* v) {
  using namespace sm90;
  fence_operands(o);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < FwdTiles<D>::kBKV / 16; ++kk)
    wgmma_rs<D, 1, kFp16>(o, pa[kk],
                          smem_desc(v + kk * 2048, Smem<D>::kKVPanel, 1024));
  wgmma_commit();
}

// One key tile's online softmax for a thread's two rows: the scores sc
// scaled into the exp2 domain (soft-capped when kCap: cap2 = softcap *
// log2(e), inv_cap2 its inverse; keys outside [lo, hi] to -inf when kMask,
// after the cap; this thread's columns are col0 + 8 j + {0, 1}), the
// running max m, the factor alpha by which the sums so far shrink, and P =
// exp2(s - m) in place of sc, summed into l.  A row that has seen no key
// keeps m = -inf and P = 0.  kAux: the options (`aux_tile_pair`'s
// arguments) in mode kMode, added after the structural masks (a masked
// key stays -inf).
template <bool kMask, bool kCap, int kBKV, bool kAux = false,
          typename T = __nv_bfloat16, int kMode = kAuxNone>
__device__ __forceinline__ void softmax_tile(float (&sc)[kBKV / 2],
                                             float (&m)[2], float (&l)[2],
                                             float (&alpha)[2],
                                             float scale_log2e, float cap2,
                                             float inv_cap2, int col0,
                                             const int (&lo)[2],
                                             const int (&hi)[2],
                                             const AuxRow (&ar)[2],
                                             const AuxOperands& aux,
                                             const int* seg,
                                             const int (&st)[2],
                                             const int (&q_seg)[2],
                                             int c_last) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < kBKV / 8; ++j) {
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = sc[4 * j + e] * scale_log2e;
      if constexpr (kCap) x[e] = softcap(x[e], cap2, inv_cap2);
      if constexpr (kMask) {
        const int col = col0 + 8 * j + e % 2;
        if (col < lo[e / 2] || col > hi[e / 2]) x[e] = -INFINITY;
      }
    }
    if constexpr (kAux)
      aux_tile_pair<T, kMode>(ar, aux, seg, st, q_seg, c_last, x,
                              col0 + 8 * j, j);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * j + e] = x[e];
      mx[e / 2] = fmaxf(mx[e / 2], x[e]);
    }
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

// One stored K or V tile (kBKV keys of L::kRawRow bytes) decoded into a
// bf16 ring slot in the swizzled panels the wgmma read, by thread `pt` of
// the producer warpgroup's 128: each 16 stored bytes of key r are 16
// values of columns [c, c + 16) (INT8, FP8), or NF4's low nibbles there
// and its high nibbles D / 2 columns on.
template <int D, int P>
__device__ __forceinline__ void decode_tile(const uint8_t* raw, uint8_t* tile,
                                            const uint32_t* table, int pt) {
  using L = Smem<D, P>;
  constexpr int kPerRow = L::kRawRow / 16;
  constexpr int kPieces = L::kBKV * kPerRow;
  static_assert(kPieces % 128 == 0, "whole pieces a producer thread");
  auto put = [&](int r, int col, const uint4 (&x)[2]) {
    uint8_t* panel = tile + col / 64 * L::kKVPanel;
    const int c = col % 64 / 8;
    *reinterpret_cast<uint4*>(panel + sm90::swizzle128(r, c)) = x[0];
    *reinterpret_cast<uint4*>(panel + sm90::swizzle128(r, c + 1)) = x[1];
  };
#pragma unroll 4
  for (int i = 0; i < kPieces / 128; ++i) {
    const int piece = pt + 128 * i;
    const int r = piece / kPerRow, col = piece % kPerRow * 16;
    const uint4 x =
        *reinterpret_cast<const uint4*>(raw + r * L::kRawRow + col);
    if constexpr (P == kPrecNf4) {
      uint4 lo[2], hi[2];
      nf4_to_bf16(x, table, lo, hi);
      put(r, col, lo);
      put(r, col + D / 2, hi);
    } else {
      uint4 out[2];
      bytes_to_bf16<P>(x, out);
      put(r, col, out);
    }
  }
}

// Grid (row tiles, kv_heads, batch), FwdTiles<D>::kThreads threads,
// Smem<D, P>::kBytes of dynamic shared memory.  The maps are over
// [b * kv_heads][rows][D] (q, o) and [b * kv_heads][kv_len][D] (k, v),
// 16-bit elements, boxes of 64 columns by kBQ rows (q), kBKV rows (k, v)
// and 64 rows (o); for quantized K/V (P a Precision, T bf16) k and v are
// bytes, [b * kv_heads][kv_len][L::kRawRow] in boxes of whole keys by
// kBKV.  kCap: soft-cap the logits (p.cap2).  kAux: the options in aux.
template <typename T, int D, int P = kUnquantized, bool kCap = false,
          bool kAux = false>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, 1)
flash_fwd90_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_o, FwdParams p,
                   const AuxOperands aux) {
  using namespace sm90;
  using L = Smem<D, P>;
  constexpr int kBQ = L::kBQ, kBKV = L::kBKV;
  constexpr int kConsumers = FwdTiles<D>::kConsumers;
  constexpr bool kFp16 = std::is_same<T, __half>::value;
  constexpr bool kQuant = L::kQuant;
  static_assert(!kQuant || !kFp16, "quantized K/V under bf16 queries");
  static_assert(!kQuant || D <= 128, "quantized K/V at D 64 and 128");
  static_assert(!kAux || (!kQuant && D <= 128),
                "the options over K/V in q's type at D 64 and 128");
  constexpr int kS = L::kStages;
  constexpr int kR = L::kRawStages;
  // Registers a thread after setmaxnreg: a block of three warpgroups holds
  // 168 a thread (ptxas's budget), so the producer's and the two consumer
  // warpgroups' budgets add up to at most 3 x 168.  A quantized producer
  // decodes tiles, and keeps more.  A block of two warpgroups (D 256) has
  // 255 a thread and moves none.
  constexpr bool kMoveRegs = FwdTiles<D>::kConsumerGroups == 2;
  constexpr int kProducerRegs = kQuant ? 120 : 24;
  constexpr int kConsumerRegs = kQuant ? 192 : 240;
  static_assert(kProducerRegs + 2 * kConsumerRegs <= 3 * 168,
                "setmaxnreg within the block's registers");
  extern __shared__ uint8_t smem_raw[];
  // kAux: each consumer warp's scratch of a key tile's segment ids.
  __shared__ __align__(16) int seg_scratch[kAux ? kConsumers / 32 : 1]
                                          [kAux ? kBKV : 1];
  uint8_t* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + kS;
  uint64_t* k_empty = v_full + kS;
  uint64_t* v_empty = k_empty + kS;
  uint64_t* raw_full = v_empty + kS;  // quantized K/V: a raw stage landed

  const int tid = threadIdx.x, lane = tid % 32;
  const int bh = blockIdx.z * gridDim.y + blockIdx.y;
  const int r0 = row_tile<kBQ>(p, blockIdx.x, gridDim.x) * kBQ;
  const int offset = p.kv_len - p.q_len;
  const bool causal = p.causal != 0;

  // Keys any row of this tile can see, [col_lo, col_hi], as key tiles
  // [n_lo, n_hi); of those, every row sees tiles [u_lo, u_hi) whole.
  // Loop step i takes tile n_hi - 1 - i: steps [0, open_begin) and
  // [open_end, n_tiles) test each key, the rest do not.
  const int r_last = min(r0 + kBQ, p.rows) - 1;
  int t_min, t_max, n_lo, n_hi;
  row_positions(r0, r_last, p.q_len, t_min, t_max);
  visible_key_tiles(t_min, t_max, p.q_len, p.kv_len, causal, p.window, kBKV,
                    n_lo, n_hi);
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
    for (int s = 0; s < kR; ++s) mbar_init(&raw_full[s], 1);
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
    // frees a step's softmax and PV before its V slot does.  Quantized
    // K/V: the stored tiles of step i land in raw stage i % kR, and the
    // whole warpgroup decodes them into the bf16 slots.
    if constexpr (kMoveRegs) setmaxnreg_dec<kProducerRegs>();
    if constexpr (!kQuant) {
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
      uint8_t* raw = smem + L::kRaw;
      uint32_t* table = reinterpret_cast<uint32_t*>(smem + L::kTable);
      if constexpr (P == kPrecNf4) fill_nf4_pairs(table, tid, 128);
      // The stored K and V tiles of step t into raw stage t % kR.
      auto load_raw = [&](int t) {
        const int rs = t % kR, j0 = (n_hi - 1 - t) * kBKV;
        uint8_t* dst = raw + rs * 2 * L::kRawTile;
        mbar_arrive_expect_tx(&raw_full[rs], 2 * L::kRawTile);
        tma_load_3d(dst, &map_k, &raw_full[rs], 0, j0, bh);
        tma_load_3d(dst + L::kRawTile, &map_v, &raw_full[rs], 0, j0, bh);
      };
      if (tid == 0 && n_tiles > 0) {
        prefetch_tensor_map(&map_q);
        prefetch_tensor_map(&map_k);
        prefetch_tensor_map(&map_v);
        mbar_arrive_expect_tx(q_full, L::kQ);
#pragma unroll
        for (int c = 0; c < L::kPanels; ++c)
          tma_load_3d(smem + c * L::kQPanel, &map_q, q_full, 64 * c, r0, bh);
        for (int t = 0; t < kR && t < n_tiles; ++t) load_raw(t);
      }
      named_barrier_sync(3, 128);  // the NF4 table is in
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kS, rs = t % kR;
        const uint8_t* stage = raw + rs * 2 * L::kRawTile;
        mbar_wait(&raw_full[rs], (t / kR) & 1);
#pragma unroll
        for (int kv = 0; kv < 2; ++kv) {
          if (t >= kS) mbar_wait((kv ? v_empty : k_empty) + s,
                                 (t / kS - 1) & 1);
          decode_tile<D, P>(stage + kv * L::kRawTile,
                            smem + (kv ? L::kV : L::kK) + s * L::kTile,
                            table, tid);
          // Each thread's writes reach the async proxy (wgmma) before
          // the slot is marked full.
          fence_proxy_async();
          named_barrier_sync(3, 128);
          if (tid == 0) mbar_arrive((kv ? v_full : k_full) + s);
        }
        // Every thread is done with the raw stage: refill it.
        if (tid == 0 && t + kR < n_tiles) load_raw(t + kR);
      }
    }
  } else {
    // Consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile;
    // this thread rows ra and ra + 8 of them (the accumulator layout).
    if constexpr (kMoveRegs) setmaxnreg_inc<kConsumerRegs>();
    const int wg = role - 1, warp = tid / 32 % 4, t4 = lane % 4;
    const int ra = r0 + 64 * wg + 16 * warp + lane / 4;
    const int row[2] = {ra, ra + 8};
    // Each row's visible keys [lo, hi].
    int lo[2], hi[2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      row_keys(row[h] % p.q_len + offset, p.kv_len, causal, p.window, lo[h],
               hi[h]);
    // kAux: each row's view of the planes and segment id (a row past the
    // head reads the last row's, and its outputs are not stored), and the
    // warp's scratch of a tile's segment ids.
    AuxRow ar[2] = {};
    int q_seg[2] = {0, 0};
    int* seg_warp = nullptr;
    if constexpr (kAux) {
      const int group = p.rows / p.q_len;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = min(row[h], p.rows - 1);
        ar[h] = aux_row(aux, blockIdx.z, blockIdx.y * group + r / p.q_len,
                        r % p.q_len, p.q_len);
        q_seg[h] = aux_q_seg(aux, blockIdx.z, r % p.q_len, p.q_len);
      }
      seg_warp = seg_scratch[tid / 32 - 4];
    }
    const int mode = kAux ? aux_mode(aux) : kAuxNone;
    const uint8_t* q_wg = smem + wg * 64 * 128;
    // Quantized K/V: the block's K scale joins the softmax scale, its V
    // scale the normalisation of O.
    float scale_log2e = p.scale_log2e, o_scale = 1.f;
    if constexpr (kQuant) {
      scale_log2e *= p.k_scales[bh];
      o_scale = p.v_scales[bh];
    }

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
      // kAux: the tile's segment ids load while QK^T runs.
      SegTile<kBKV> seg;
      if constexpr (kAux)
        if (aux.kv_seg)
          seg.load(aux.kv_seg + (size_t)blockIdx.z * p.kv_len,
                   (n_hi - 1 - i) * kBKV, p.kv_len, lane);
      wgmma_wait<0>();
      fence_operands(sc);
      release(k_empty, i);
      int st[2] = {0, 0};
      if constexpr (kAux)
        if (aux.kv_seg) {
          seg.publish(seg_warp, lane);
#pragma unroll
          for (int h = 0; h < 2; ++h) st[h] = seg.state(q_seg[h]);
        }
      // The options' mode is chosen here, once a tile (a branch on the
      // operands inside the unrolled loop over keys costs more than their
      // loads).
      auto softmax = [&](auto mode_c) {
        softmax_tile<decltype(masked)::value, kCap, kBKV, kAux, T,
                     decltype(mode_c)::value>(
            sc, m, l, alpha, scale_log2e, p.cap2, p.inv_cap2,
            (n_hi - 1 - i) * kBKV + 2 * t4, lo, hi, ar, aux,
            seg_warp + 2 * t4, st, q_seg, (p.kv_len - 1) & ~1);
      };
      if (!kAux || mode == kAuxNone)
        softmax(std::integral_constant<int, kAuxNone>());
      else if (mode == kAuxPlanes16)
        softmax(std::integral_constant<int, kAuxPlanes16>());
      else
        softmax(std::integral_constant<int, kAuxPlanes32>());
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
      inv[h] = l[h] > 0.f ? o_scale / l[h] : 0.f;
      if (t4 == 0 && row[h] < p.rows)
        p.lse[(size_t)bh * p.rows + row[h]] =
            l[h] > 0.f ? (m[h] + log2f(l[h])) * kLn2 : -INFINITY;
    }
    if (p.o32) {
      float* out = p.o32 + (size_t)bh * p.rows * p.o_cols;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (row[h] >= p.rows) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          if (8 * j < p.o_cols)
            *reinterpret_cast<float2*>(out + (size_t)row[h] * p.o_cols +
                                       8 * j + 2 * t4) =
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

template <typename T, int D, int P, bool kCap, bool kAux = false>
int launch(const void* q, const void* k, const void* v, void* o,
           const FwdParams& p, const AuxOperands& aux, int batch,
           int kv_heads, cudaStream_t s) {
  using L = Smem<D, P>;
  constexpr int kBQ = L::kBQ, kBKV = L::kBKV;
  const long long heads = (long long)batch * kv_heads;
  const auto u16 = CU_TENSOR_MAP_DATA_TYPE_UINT16;
  const auto sw = CU_TENSOR_MAP_SWIZZLE_128B;
  // With no keys nothing is loaded; the K/V maps then cover q, so that
  // cuTensorMapEncodeTiled accepts them.
  const int kv_rows = p.kv_len > 0 ? p.kv_len : 1;
  const void* kb = p.kv_len > 0 ? k : q;
  const void* vb = p.kv_len > 0 ? v : q;
  // A row of the tensors holds c columns: D, or 32 for the D 32 launch
  // of the D 64 kernel (TMA zero-fills the box past them, and clips the
  // stores).
  const int c = p.o_cols;
  CUtensorMap mq, mk, mv, mo;
  bool ok = sm90::tensor_map(&mq, q, u16, 2, c, p.rows, heads, c,
                             (long long)p.rows * c, 64, kBQ, sw) &&
            sm90::tensor_map(&mo, p.o32 ? q : o, u16, 2, c, p.rows, heads, c,
                             (long long)p.rows * c, 64, 64, sw);
  for (int kv = 0; kv < 2 && ok; ++kv) {
    const void* base = kv ? vb : kb;
    ok = L::kQuant
             ? sm90::tensor_map(kv ? &mv : &mk, base,
                                CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, L::kRawRow,
                                kv_rows, heads, L::kRawRow,
                                (long long)kv_rows * L::kRawRow, L::kRawRow,
                                kBKV, CU_TENSOR_MAP_SWIZZLE_NONE)
             : sm90::tensor_map(kv ? &mv : &mk, base, u16, 2, c, kv_rows,
                                heads, c, (long long)kv_rows * c, 64, kBKV,
                                sw);
  }
  if (!ok) return kErrTensorMap;
  if (cudaFuncSetAttribute(flash_fwd90_kernel<T, D, P, kCap, kAux>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           L::kBytes) != cudaSuccess)
    return (int)cudaGetLastError();
  const dim3 grid((p.rows + kBQ - 1) / kBQ, kv_heads, batch);
  flash_fwd90_kernel<T, D, P, kCap, kAux>
      <<<grid, FwdTiles<D>::kThreads, L::kBytes, s>>>(mq, mk, mv, mo, p,
                                                      aux);
  return (int)cudaGetLastError();
}

// Quantized K/V: D 64 and 128, no cap.  K/V in q's type: D 32 (the D 64
// kernel over 32-column rows), 64, 128 and 256, with or without the cap;
// with the options (aux non-null), D 64 and 128.
template <typename T, int P = kUnquantized>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const FwdParams& p, const AuxOperands* aux, int batch,
             int kv_heads, int head_dim, bool capped, cudaStream_t s) {
  const AuxOperands none{};
  const AuxOperands& a = aux ? *aux : none;
  if constexpr (P != kUnquantized) {
    if (capped || aux) return (int)cudaErrorInvalidValue;
    if (head_dim == 64)
      return launch<T, 64, P, false>(q, k, v, o, p, a, batch, kv_heads, s);
    if (head_dim == 128)
      return launch<T, 128, P, false>(q, k, v, o, p, a, batch, kv_heads, s);
  } else {
    if (aux) {
      if (head_dim == 64)
        return capped ? launch<T, 64, P, true, true>(q, k, v, o, p, a, batch,
                                                     kv_heads, s)
                      : launch<T, 64, P, false, true>(q, k, v, o, p, a,
                                                      batch, kv_heads, s);
      if (head_dim == 128)
        return capped ? launch<T, 128, P, true, true>(q, k, v, o, p, a,
                                                      batch, kv_heads, s)
                      : launch<T, 128, P, false, true>(q, k, v, o, p, a,
                                                       batch, kv_heads, s);
      return (int)cudaErrorInvalidValue;
    }
    if (head_dim == 32 || head_dim == 64)
      return capped
                 ? launch<T, 64, P, true>(q, k, v, o, p, a, batch, kv_heads,
                                          s)
                 : launch<T, 64, P, false>(q, k, v, o, p, a, batch, kv_heads,
                                           s);
    if (head_dim == 128)
      return capped
                 ? launch<T, 128, P, true>(q, k, v, o, p, a, batch, kv_heads,
                                           s)
                 : launch<T, 128, P, false>(q, k, v, o, p, a, batch,
                                            kv_heads, s);
    if (head_dim == 256)
      return capped
                 ? launch<T, 256, P, true>(q, k, v, o, p, a, batch, kv_heads,
                                           s)
                 : launch<T, 256, P, false>(q, k, v, o, p, a, batch,
                                            kv_heads, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, k, v contiguous, 16-byte aligned.  o: q's dtype, or float32 when
// o_f32; lse: float32.  is_fp16 selects fp16 inputs (else bf16).
// head_dim 32, 64, 128 or 256 (32 and 256 with K/V in q's type, 32
// without aux).  softcap > 0
// soft-caps the scaled logits (K/V in q's type); 0: none.
// window <= 0: none.  kv_precision 0: k and v in q's type; else a
// Precision of quant_common.cuh (INT8, FP8-E4M3, FP8-E5M2, NF4) with bf16
// queries: k, v [b, kv_heads, kv_len, D] bytes (NF4 [.., D / 2]) and
// k_scales, v_scales float32 [b, kv_heads].  aux: the options
// (attention_common.cuh `AuxOperands`; dbias unused), or null for none;
// with K/V in q's type at head_dim 64 or 128.  Returns kErrTensorMap when
// cuTensorMapEncodeTiled refuses a TMA map.
int mfa_flash_fwd(const void* q, const void* k, const void* v,
                  const void* k_scales, const void* v_scales, void* o,
                  void* lse, int batch, int q_heads, int kv_heads, int q_len,
                  int kv_len, int head_dim, float scale, float softcap,
                  int causal, int window, int is_fp16, int o_f32,
                  int kv_precision, const AuxOperands* aux, void* stream) {
  if (batch == 0 || q_len == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads || kv_len < 0 || softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  if (kv_precision && (is_fp16 || !k_scales || !v_scales))
    return (int)cudaErrorInvalidValue;
  if (head_dim == 32 && (kv_precision || aux))
    return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.o32 = o_f32 ? static_cast<float*>(o) : nullptr;
  p.o_cols = head_dim;
  p.lse = static_cast<float*>(lse);
  p.k_scales = static_cast<const float*>(k_scales);
  p.v_scales = static_cast<const float*>(v_scales);
  p.rows = q_heads / kv_heads * q_len;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.scale_log2e = scale * kLog2e;
  p.cap2 = softcap * kLog2e;
  p.inv_cap2 = softcap > 0.f ? 1.f / p.cap2 : 0.f;
  p.causal = causal;
  p.window = window;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  const int hd = head_dim;
  const bool cap = softcap > 0.f;
  switch (kv_precision) {
    case 0:
      return is_fp16 ? launch_d<__half>(q, k, v, o, p, aux, batch, kv_heads,
                                        hd, cap, s)
                     : launch_d<bf16>(q, k, v, o, p, aux, batch, kv_heads, hd,
                                      cap, s);
    case kPrecInt8:
      return launch_d<bf16, kPrecInt8>(q, k, v, o, p, aux, batch, kv_heads,
                                       hd, cap, s);
    case kPrecE4M3:
      return launch_d<bf16, kPrecE4M3>(q, k, v, o, p, aux, batch, kv_heads,
                                       hd, cap, s);
    case kPrecE5M2:
      return launch_d<bf16, kPrecE5M2>(q, k, v, o, p, aux, batch, kv_heads,
                                       hd, cap, s);
    case kPrecNf4:
      return launch_d<bf16, kPrecNf4>(q, k, v, o, p, aux, batch, kv_heads,
                                       hd, cap, s);
  }
  return (int)cudaErrorInvalidValue;
}

const char* mfa_cuda_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a TMA map of the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
