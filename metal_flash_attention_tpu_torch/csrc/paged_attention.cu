// Paged attention for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel built by
//   metal_flash_attention_tpu/ops/paged_attention.py::_make_paged_kernel
// (pallas_call at ops/paged_attention.py:730), in its two modes:
//
//  * decode: one query token per sequence; the rows of a block are the
//    GQA group of one kv head.  This is `flash_decode90_kernel` of
//    decode_common.cuh with the paged address policy: blocks (chunk, kv
//    head, sequence) each take a fixed chunk of keys from the row's first
//    live tile (the last `window` keys with a window) through a cp.async
//    ring gathered through the page table, QK^T and PV on tensor cores;
//    `merge_splits` merges the chunks' partials;
//  * chunked prefill: q_chunk query tokens per sequence, laid out
//    group-major (row g * q_chunk + t is query t of group member g) and
//    causal at position len - q_chunk + t.  `paged_prefill90_kernel`
//    below: 64 rows a block (16 a warp), the same ring and gather, and
//    split-KV over the block's visible keys, so that one engine chunk
//    fills the card; the partials merge through `merge_splits`, whose row
//    layout is the group-major one.
//
// What bounds them: decode reads every live page of K and V once (HBM
// bytes); each prefill key feeds up to group * q_chunk rows, so that mode
// is closer to compute.  The TPU kernel issued its successor program's
// first page DMAs across grid steps, which relies on a sequential grid.
// Blocks on the GPU run in parallel, so each block gathers its own pages:
// it reads its page-table entries once into shared memory, then keeps
// MFA_*_STAGES tiles of 16-byte cp.async copies in flight while it
// computes.  Without a window a block reads its chunk's entries while the
// sequence's length loads (entries past the live pages are read, never
// used); pages are copied from only for positions below the length.  A
// row that sees no key gives o = 0, lse = -inf.  The lse is natural-log
// at the interface.
//
// Both modes take bf16 pools or quantized ones (INT8, FP8-E4M3, FP8-E5M2:
// [pages, kv_heads, page, D] bytes; NF4: [pages, kv_heads, page / 2, D],
// two tokens a byte), with one float32 K and V scale per (page, kv head):
// the TPU kernel's `kv_precision`.  A quantized tile lands in the ring in
// its storage type and is decoded in shared memory into the bf16 tile the
// tensor cores read; its keys' K scales scale the columns of S and their V
// scales those of P (decode_common.cuh).  A decode whose GQA group is wider
// than one fragment (MFA_DECODE_MAX_GROUP: a serving chunk's positions
// folded into the head axis) runs as a prefill with q_chunk = 1: every row
// then sits at position len - 1, decode's semantics for any group.
//
// Every function returns cudaGetLastError() after its launches.

#include <climits>

#include "decode_common.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace mfa;
using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileM = MFA_PAGED_BLOCK_Q;   // query rows per block
constexpr int kTileN = MFA_PAGED_BLOCK_KV;  // keys per ring tile
static_assert(kTileM == 16 * kWarps, "16 rows a warp");
static_assert(kTileN % 16 == 0, "whole 16-key mma steps");

template <class KV>
struct PrefillParams {
  const bf16* q;    // [b, q_heads, q_chunk, D]
  bf16* o;          // like q
  float* lse;       // [b, q_heads, q_chunk], natural log
  float* part_o;    // [b, kv_heads, splits, group * q_chunk, D]
  float* part_lse;  // [b, kv_heads, splits, group * q_chunk], base 2
  KV kv;
  int q_heads, q_chunk, chunk, splits;
  float scale_log2e;
};

template <int D>
using PrefillRing = Ring<bf16, D, kTileN, MFA_PAGED_STAGES>;

// The prefill's ring: bf16 tiles, or (P a quantized Precision) stored tiles
// and the bf16 tile pair they decode into.
template <int D, class KV, int P>
struct PrefillSmem {
  static constexpr bool kQuant = P != kUnquantized;
  using QR = QRing<P, KV::kSplitRows, D, kTileN, MFA_PAGED_STAGES>;
  static constexpr size_t kRingBytes =
      kQuant ? QR::kBytes : PrefillRing<D>::kBytes;
  static_assert(!kQuant || QR::kStride == PrefillRing<D>::kStride,
                "one bf16 tile layout");
};

__device__ __forceinline__ bool visible(int col, int qpos, int window) {
  return col <= qpos && (window <= 0 || col > qpos - window);
}

// The rows [r0, r0 + 64) of (b, h) against the key tiles [t0, t1): writes
// o and lse when the call has one split, else this split's normalized
// float32 partial and base-2 lse.  Warp w owns rows r0 + 16w .. + 15; lane
// (g = lane / 4, t4 = lane % 4) holds rows g and g + 8 in the mma fragment
// layout.
template <int D, class KV, int P>
__device__ __forceinline__ void attend(const PrefillParams<KV>& p,
                                       unsigned char* smem, int* pages,
                                       bool prefetched, int b, int h, int r0,
                                       int rows, int q0, int col_lo,
                                       int col_hi, int t0, int t1,
                                       size_t row_base, size_t p_row) {
  using R = PrefillRing<D>;
  using QR = typename PrefillSmem<D, KV, P>::QR;
  using Rows = typename KV::Rows;
  constexpr int kStride = R::kStride;
  const int qc = p.q_chunk, window = p.kv.window;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int k_lo = max(col_lo, t0 * kTileN);
  const int k_hi = min(col_hi + 1, t1 * kTileN);
  const auto kv_rows = p.kv.rows(b, h, pages, k_lo, k_hi, prefetched);
  uint32_t* table =
      reinterpret_cast<uint32_t*>(smem + QR::kRingBytes + QR::kWorkBytes);
  fill_nf4_table<QR>(table);

  // This lane's two rows, their query positions, and Q as A fragments.
  const int wr = r0 + 16 * warp;
  const bool warp_live = wr < rows;
  const int ra = wr + g, rb = wr + g + 8;
  const int qpos_a = q0 + ra % qc, qpos_b = q0 + rb % qc;
  uint32_t qf[D / 16][4];
  {
    const bf16* qa = p.q + (row_base + ra) * D;
    const bf16* qb = p.q + (row_base + rb) * D;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + 2 * t4;
      qf[kk][0] = ra < rows ? ld_u32(qa + c) : 0u;
      qf[kk][1] = rb < rows ? ld_u32(qb + c) : 0u;
      qf[kk][2] = ra < rows ? ld_u32(qa + c + 8) : 0u;
      qf[kk][3] = rb < rows ? ld_u32(qb + c + 8) : 0u;
    }
  }
  // The warp's nearest and farthest query positions: a tile past the
  // farthest (or, with a window, before the nearest's window) is skipped;
  // only tiles that cross one of its rows' edges are masked.
  const int q_near = __reduce_min_sync(
      kFull, min(ra < rows ? qpos_a : INT_MAX, rb < rows ? qpos_b : INT_MAX));
  const int q_far = __reduce_max_sync(
      kFull, max(ra < rows ? qpos_a : INT_MIN, rb < rows ? qpos_b : INT_MIN));

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  const float scale = p.scale_log2e;
  // ldmatrix rows: K as [key][dim] (two key octets of one 16-dim step), V
  // transposed (both key octets of a 16-key step, one 16-column pair).
  const int mi = lane >> 3, r8 = lane & 7;
  const int k_off = ((mi >> 1) * 8 + r8) * kStride + (mi & 1) * 8;
  const int v_off = ((mi & 1) * 8 + r8) * kStride + (mi >> 1) * 8;

  __syncthreads();  // the page entries (and the NF4 table) are in
  // One tile: ks / vs the bf16 tiles, ksc / vsc a quantized pool's per-key
  // scales (slot order).
  auto step = [&](int t, const bf16* ks, const bf16* vs, const float* ksc,
                  const float* vsc) {
    int pmin, pmax;  // the tile's least and greatest key position
    tile_span<kTileN>(kv_rows, t, pmin, pmax);
    if (!warp_live || pmin > q_far ||
        (window > 0 && pmax <= q_near - window))
      return;
    const bool edge = pmax > q_near ||
                      (window > 0 && pmin <= q_far - window);

    // S = Q K^T for this warp's 16 rows x kTileN keys.
    float s[kTileN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kTileN / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, ks + k_off + np * 16 * kStride + kk * 16);
        mma_16816(s[2 * np], qf[kk], kb[0], kb[1]);
        mma_16816(s[2 * np + 1], qf[kk], kb[2], kb[3]);
      }

    // Mask (edge tiles only), scale into the exp2 domain, online
    // softmax update.
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int o = nt * 8 + 2 * t4 + e;
        const int col = slot_pos<kTileN>(kv_rows, t, o);
        float sa = s[nt][e] * scale, sb = s[nt][2 + e] * scale;
        if constexpr (Rows::kSlotScales) {
          sa *= ksc[o];
          sb *= ksc[o];
        }
        s[nt][e] = !edge || visible(col, qpos_a, window) ? sa
                                                         : -INFINITY;
        s[nt][2 + e] = !edge || visible(col, qpos_b, window)
                           ? sb : -INFINITY;
        mx_a = fmaxf(mx_a, s[nt][e]);
        mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float base_a = mn_a == -INFINITY ? 0.f : mn_a;
    const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
    const float alpha_a = exp2f(m_a - base_a);
    const float alpha_b = exp2f(m_b - base_b);
    m_a = mn_a;
    m_b = mn_b;
    l_a *= alpha_a;
    l_b *= alpha_b;
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base_a);
        s[nt][2 + e] = exp2f(s[nt][2 + e] - base_b);
        l_a += s[nt][e];
        l_b += s[nt][2 + e];
      }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha_a;
      acc[dn][1] *= alpha_a;
      acc[dn][2] *= alpha_b;
      acc[dn][3] *= alpha_b;
    }

    // P's columns take V's scales (after l: the sums are of P).
    if constexpr (Rows::kSlotScales) {
#pragma unroll
      for (int nt = 0; nt < kTileN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float vsc_o = vsc[nt * 8 + 2 * t4 + e];
          s[nt][e] *= vsc_o;
          s[nt][2 + e] *= vsc_o;
        }
    }
    // acc += P V: the S accumulators of two adjacent key octets are
    // the A fragment of one 16-key step.
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) {
      const uint32_t a[4] = {pack2(s[2 * kk][0], s[2 * kk][1]),
                             pack2(s[2 * kk][2], s[2 * kk][3]),
                             pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, vs + v_off + kk * 16 * kStride + dp * 16);
        mma_16816(acc[2 * dp], a, vb[0], vb[1]);
        mma_16816(acc[2 * dp + 1], a, vb[2], vb[3]);
      }
    }
  };
  if constexpr (PrefillSmem<D, KV, P>::kQuant) {
    qring_loop<QR, kThreads>(smem, table, kv_rows, t0, t1, col_lo,
                             col_hi + 1, step);
  } else {
    ring_loop<bf16, D, kTileN, R::kStages, kThreads>(
        reinterpret_cast<bf16*>(smem), kv_rows, t0, t1, k_lo, k_hi,
        [&](int j0, const bf16* ks, const bf16* vs) {
          step(j0 / kTileN, ks, vs, nullptr, nullptr);
        });
  }

  if (!warp_live) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const float lse2_a = l_a > 0.f ? m_a + log2f(l_a) : -INFINITY;
  const float lse2_b = l_b > 0.f ? m_b + log2f(l_b) : -INFINITY;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? rb : ra;
    if (r >= rows) continue;
    const float inv = half ? inv_b : inv_a;
    const float lse2 = half ? lse2_b : lse2_a;
    if (p.splits == 1) {
      bf16* orow = p.o + (row_base + r) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[dn][2 * half] * inv,
                                  acc[dn][2 * half + 1] * inv);
      if (t4 == 0) p.lse[row_base + r] = lse2 * kLn2;
    } else {
      float* po = p.part_o + (p_row + r) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(po + dn * 8 + 2 * t4) =
            make_float2(acc[dn][2 * half] * inv,
                        acc[dn][2 * half + 1] * inv);
      if (t4 == 0) p.part_lse[p_row + r] = lse2;
    }
  }
}

// One block: rows [64 r, 64 r + 64) of one (sequence, kv head) against the
// key tiles of split s of their visible range, for blockIdx.x = r * splits
// + s.
template <int D, class KV, int P>
__global__ void __launch_bounds__(kThreads)
paged_prefill90_kernel(PrefillParams<KV> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  int* pages =
      reinterpret_cast<int*>(smem + PrefillSmem<D, KV, P>::kRingBytes);

  const int row_tile = blockIdx.x / p.splits, split = blockIdx.x % p.splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int qc = p.q_chunk, kvh = p.kv.kv_heads;
  const int group = p.q_heads / kvh, rows = group * qc;
  const int window = p.kv.window;
  const bool prefetched = p.kv.prefetch(b, split * p.chunk,
                                        (split + 1) * p.chunk, pages);
  const int kv_len = p.kv.lengths[b];
  const int tid = threadIdx.x;

  // Key range any row of this block can see.
  const int r0 = row_tile * kTileM;
  const int r_last = min(r0 + kTileM, rows) - 1;
  int t_min = 0, t_max = qc - 1;
  if (r0 / qc == r_last / qc) {
    t_min = r0 % qc;
    t_max = r_last % qc;
  }
  const int q0 = kv_len - qc;  // position of query t = 0
  const int col_hi = q0 + t_max;
  const int col_lo = window > 0 ? max(0, q0 + t_min - window + 1) : 0;
  int first, last;
  tile_range<kTileN>(p.kv, col_lo, col_hi + 1, first, last);
  const int t0 = first + split * (p.chunk / kTileN);
  const int t1 = min(last, t0 + p.chunk / kTileN);

  const size_t row_base = ((size_t)b * p.q_heads + (size_t)h * group) * qc;
  const size_t p_row = (((size_t)b * kvh + h) * p.splits + split) * rows;
  if (t0 >= t1) {  // no visible key in this split
    for (int r = r0 + tid; r <= r_last; r += kThreads) {
      if (p.splits > 1) {
        for (int d = 0; d < D; ++d) p.part_o[(p_row + r) * D + d] = 0.f;
        p.part_lse[p_row + r] = -INFINITY;
      } else {
        for (int d = 0; d < D; ++d)
          p.o[(row_base + r) * D + d] = __float2bfloat16(0.f);
        p.lse[row_base + r] = -INFINITY;
      }
    }
  } else {
    attend<D, KV, P>(p, smem, pages, prefetched, b, h, r0, rows, q0,
                     col_lo, col_hi, t0, t1, row_base, p_row);
  }
}

template <int D, class KV, int P>
int launch_prefill(const PrefillParams<KV>& p, int batch,
                   cudaStream_t stream) {
  const int rows = p.q_heads / p.kv.kv_heads * p.q_chunk;
  const size_t smem =
      PrefillSmem<D, KV, P>::kRingBytes +
      sizeof(int) * pages_capacity(p.chunk, p.kv.page_size);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_prefill90_kernel<D, KV, P>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(((rows + kTileM - 1) / kTileM) * p.splits, p.kv.kv_heads,
                  batch);
  paged_prefill90_kernel<D, KV, P><<<grid, kThreads, smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return (int)e;
  merge_splits<bf16, D>(p.part_o, p.part_lse, p.o, p.lse, rows,
                        p.kv.kv_heads, batch, p.splits, stream);
  return (int)cudaGetLastError();
}

// The interface's pointers and sizes, untyped.
struct Args {
  const void *q, *k_pool, *v_pool, *k_scales, *v_scales, *table, *lengths;
  void *o, *lse, *part_o, *part_lse;
  int batch, q_heads, kv_heads, q_chunk, head_dim, page_size, max_pages;
  float scale;
  int window, splits, chunk;
};

// The pools as the address policy of storage S (bf16, or the bytes of a
// quantized pool; an NF4 pool's pages hold page_size / 2 rows).
template <typename S, bool kSplit>
PagedKV<S, kSplit> make_kv(const Args& a) {
  PagedKV<S, kSplit> kv;
  kv.k = static_cast<const S*>(a.k_pool);
  kv.v = static_cast<const S*>(a.v_pool);
  kv.k_scales = static_cast<const float*>(a.k_scales);
  kv.v_scales = static_cast<const float*>(a.v_scales);
  kv.table = static_cast<const int*>(a.table);
  kv.lengths = static_cast<const int*>(a.lengths);
  kv.kv_heads = a.kv_heads;
  kv.head_dim = a.head_dim;
  kv.page_size = a.page_size;
  kv.page_rows = kSplit ? a.page_size / 2 : a.page_size;
  kv.max_pages = a.max_pages;
  kv.window = a.window;
  return kv;
}

// The two modes, each at one head dim, storage and precision.
template <int D, typename S, bool kSplit, int P>
struct Prefill {
  static int run(const Args& a, cudaStream_t stream) {
    PrefillParams<PagedKV<S, kSplit>> p;
    p.q = static_cast<const bf16*>(a.q);
    p.o = static_cast<bf16*>(a.o);
    p.lse = static_cast<float*>(a.lse);
    p.part_o = static_cast<float*>(a.part_o);
    p.part_lse = static_cast<float*>(a.part_lse);
    p.kv = make_kv<S, kSplit>(a);
    p.q_heads = a.q_heads;
    p.q_chunk = a.q_chunk;
    p.chunk = a.chunk;
    p.splits = a.splits;
    p.scale_log2e = a.scale * kLog2e;
    return launch_prefill<D, PagedKV<S, kSplit>, P>(p, a.batch, stream);
  }
};

template <int D, typename S, bool kSplit, int P>
struct Decode {
  static int run(const Args& a, cudaStream_t stream) {
    DecodeIO<bf16> io;
    io.q = static_cast<const bf16*>(a.q);
    io.o = static_cast<bf16*>(a.o);
    io.lse = static_cast<float*>(a.lse);
    io.part_o = static_cast<float*>(a.part_o);
    io.part_lse = static_cast<float*>(a.part_lse);
    io.q_heads = a.q_heads;
    io.kv_heads = a.kv_heads;
    io.chunk = a.chunk;
    io.splits = a.splits;
    io.scale_log2e = a.scale * kLog2e;
    return launch_decode<bf16, D, PagedKV<S, kSplit>, P>(
        io, make_kv<S, kSplit>(a), a.batch,
        pages_capacity(a.chunk, a.page_size), stream);
  }
};

// One mode at the pools' precision and head dim.
template <template <int, typename, bool, int> class Mode>
int dispatch(const Args& a, int precision, cudaStream_t s) {
  if (a.head_dim != 64 && a.head_dim != 128)
    return (int)cudaErrorInvalidValue;
  const bool d64 = a.head_dim == 64;
  switch (precision) {
    case kPrecBf16:
      return d64 ? Mode<64, bf16, false, kUnquantized>::run(a, s)
                 : Mode<128, bf16, false, kUnquantized>::run(a, s);
    case kPrecInt8:
      return d64 ? Mode<64, uint8_t, false, kPrecInt8>::run(a, s)
                 : Mode<128, uint8_t, false, kPrecInt8>::run(a, s);
    case kPrecE4M3:
      return d64 ? Mode<64, uint8_t, false, kPrecE4M3>::run(a, s)
                 : Mode<128, uint8_t, false, kPrecE4M3>::run(a, s);
    case kPrecE5M2:
      return d64 ? Mode<64, uint8_t, false, kPrecE5M2>::run(a, s)
                 : Mode<128, uint8_t, false, kPrecE5M2>::run(a, s);
    case kPrecNf4:
      if (a.page_size % 2) return (int)cudaErrorInvalidValue;
      return d64 ? Mode<64, uint8_t, true, kPrecNf4>::run(a, s)
                 : Mode<128, uint8_t, true, kPrecNf4>::run(a, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Both modes: `splits` blocks a (row tile,) kv head and sequence, each
// taking `chunk` keys (a multiple of the mode's tile: MFA_DECODE_BLOCK_KV,
// MFA_PAGED_BLOCK_KV) of its rows' visible range; part_o [b, kv_heads,
// splits, rows, D] and part_lse [..., rows] float32 hold their partials
// (unused when splits is 1), which `merge_splits` merges.  precision: the
// pools' Precision (quant_common.cuh): kPrecBf16, or kPrecInt8 / kPrecE4M3
// / kPrecE5M2 / kPrecNf4 with k_scales and v_scales [pages, kv_heads]
// float32 (null for bf16 pools); q and o are bf16 either way.
int mfa_paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                      const void* k_scales, const void* v_scales,
                      const void* table, const void* lengths, void* o,
                      void* lse, int batch, int q_heads, int kv_heads,
                      int q_chunk, int head_dim, int page_size,
                      int max_pages, float scale, int window, void* part_o,
                      void* part_lse, int splits, int chunk, int precision,
                      void* stream) {
  if (batch == 0 || q_chunk == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads || page_size <= 0 || splits < 1 ||
      chunk <= 0 || chunk % kTileN ||
      (precision != kPrecBf16 && (!k_scales || !v_scales)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scales, v_scales, table, lengths,
               o, lse, part_o, part_lse, batch, q_heads, kv_heads, q_chunk,
               head_dim, page_size, max_pages, scale, window, splits, chunk};
  return dispatch<Prefill>(a, precision, static_cast<cudaStream_t>(stream));
}

int mfa_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                     const void* k_scales, const void* v_scales,
                     const void* table, const void* lengths, void* o,
                     void* lse, int batch, int q_heads, int kv_heads,
                     int q_chunk, int head_dim, int page_size, int max_pages,
                     float scale, int window, void* part_o, void* part_lse,
                     int splits, int chunk, int precision, void* stream) {
  if (batch == 0) return 0;
  if (q_chunk != 1 || kv_heads <= 0 || q_heads % kv_heads ||
      q_heads / kv_heads > kDecodeMaxGroup || page_size <= 0 ||
      splits < 1 || chunk <= 0 || chunk % kDecodeTile ||
      (precision != kPrecBf16 && (!k_scales || !v_scales)))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, k_scales, v_scales, table, lengths,
               o, lse, part_o, part_lse, batch, q_heads, kv_heads, q_chunk,
               head_dim, page_size, max_pages, scale, window, splits, chunk};
  return dispatch<Decode>(a, precision, static_cast<cudaStream_t>(stream));
}

const char* mfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
