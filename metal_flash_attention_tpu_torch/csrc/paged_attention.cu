// Paged attention for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel built by
//   metal_flash_attention_tpu/ops/paged_attention.py::_make_paged_kernel
// (pallas_call at ops/paged_attention.py:730), in its two modes:
//
//  * decode: one query token per sequence; the rows of a block are the
//    GQA group of one kv head.  Decode is bound by HBM bytes: every live
//    page of K and V is read once and each key feeds only `group` rows.
//    At small batch there are few (sequence, kv head) pairs for 132 SMs,
//    so the key range is split across blocks (split-KV) and a second
//    kernel merges the partials by their log-sum-exp;
//  * chunked prefill: q_chunk query tokens per sequence, laid out
//    group-major (row g * q_chunk + t is query t of group member g) and
//    causal at position len - q_chunk + t.  Each key feeds up to
//    group * q_chunk rows, so this mode is closer to compute; the block's
//    key loop stops at its last visible key.
//
// The TPU kernel issued its successor program's first page DMAs across
// grid steps, which relies on a sequential grid.  Blocks on the GPU run
// in parallel, so each block here gathers its own pages: a tile of
// kTileN keys is copied row by row through the page table into shared
// memory, then QK^T and PV run on tensor cores (mma.sync m16n8k16, bf16
// in, fp32 accumulate) with the online softmax (m, l, acc) in fp32 in
// the exp2 domain.  Table entries are read only for positions below the
// sequence's length.  A row that sees no key gives o = 0, lse = -inf.
// The lse is natural-log at the interface.
//
// Every function returns cudaGetLastError() after its launches.

#include "attention_common.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace mfa;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileM = 16 * kWarps;  // query rows per block (16 per warp)
constexpr int kTileN = MFA_PAGED_BLOCK_KV;  // keys per iteration
constexpr int kPad = 8;              // bf16 padding per shared-memory row

struct Params {
  const __nv_bfloat16* q;       // [b, q_heads, q_chunk, D]
  const __nv_bfloat16* k_pool;  // [pages, kv_heads, page_size, D]
  const __nv_bfloat16* v_pool;
  const int* table;             // [b, max_pages]
  const int* lengths;           // [b]
  __nv_bfloat16* o;             // like q
  float* lse;                   // [b, q_heads, q_chunk], natural log
  float* part_o;                // [b, kv_heads, splits, rows, D]
  float* part_lse;              // [b, kv_heads, splits, rows], base 2
  int q_heads, kv_heads, q_chunk, page_size, max_pages;
  float scale_log2e;
  int window;  // <= 0: none
  int splits;
};

__device__ __forceinline__ bool visible(int col, int qpos, int window) {
  return col <= qpos && (window <= 0 || col > qpos - window);
}

// One block: kTileM rows of one (sequence, kv head) against the key
// tiles [tile_begin, tile_end) of its visible range (a share of them
// when kSplit).  Warp w owns rows 16w .. 16w + 15 of the tile; lane
// (g = lane / 4, t4 = lane % 4) holds rows g and g + 8 in the mma
// fragment layout.
template <int D, bool kSplit>
__device__ __forceinline__ void attend(const Params& p, int row_tile,
                                       int split) {
  __shared__ __align__(16) uint16_t ks[kTileN][D + kPad];
  __shared__ __align__(16) uint16_t vs[kTileN][D + kPad];

  const int b = blockIdx.z, h = blockIdx.y;
  const int group = p.q_heads / p.kv_heads;
  const int rows = group * p.q_chunk;
  const int kv_len = p.lengths[b];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  // Key range any row of this tile can see.
  const int r0 = row_tile * kTileM;
  const int r_last = min(r0 + kTileM, rows) - 1;
  int t_min = 0, t_max = p.q_chunk - 1;
  if (r0 / p.q_chunk == r_last / p.q_chunk) {
    t_min = r0 % p.q_chunk;
    t_max = r_last % p.q_chunk;
  }
  const int q0 = kv_len - p.q_chunk;  // position of query t = 0
  const int col_hi = q0 + t_max;
  const int col_lo = p.window > 0 ? max(0, q0 + t_min - p.window + 1) : 0;
  int tile_begin = col_lo / kTileN;
  int tile_end = col_hi >= col_lo ? col_hi / kTileN + 1 : tile_begin;
  if (kSplit) {
    const int per = (tile_end - tile_begin + p.splits - 1) / p.splits;
    const int first = tile_begin + split * per;
    tile_end = min(tile_end, first + per);
    tile_begin = min(first, tile_end);
  }

  // This lane's two rows, their query positions, and Q as A fragments.
  const int row_base = (b * p.q_heads + h * group) * p.q_chunk;
  const int wr = r0 + 16 * warp;
  const bool warp_live = wr < rows;
  const int ra = wr + g, rb = wr + g + 8;
  const int qpos_a = q0 + ra % p.q_chunk, qpos_b = q0 + rb % p.q_chunk;
  uint32_t qf[D / 16][4];
  {
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(
        p.q + (size_t)(row_base + ra) * D);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(
        p.q + (size_t)(row_base + rb) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 8 + t4;  // 32-bit word of column kk*16 + 2*t4
      qf[kk][0] = ra < rows ? qa[c] : 0u;
      qf[kk][1] = rb < rows ? qb[c] : 0u;
      qf[kk][2] = ra < rows ? qa[c + 4] : 0u;
      qf[kk][3] = rb < rows ? qb[c + 4] : 0u;
    }
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int j0 = tile * kTileN;
    __syncthreads();  // the previous tile is consumed
    // Gather kTileN key rows through the page table, 16 bytes a thread;
    // rows past the sequence's length are zero and never looked up.
    constexpr int kPieces = D / 8;
    for (int c = threadIdx.x; c < kTileN * kPieces; c += kThreads) {
      const int j = c / kPieces, part = c % kPieces;
      const int pos = j0 + j;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (pos < kv_len) {
        const int page = p.table[b * p.max_pages + pos / p.page_size];
        const size_t off =
            (((size_t)page * p.kv_heads + h) * p.page_size +
             pos % p.page_size) * D + part * 8;
        kv = *reinterpret_cast<const uint4*>(p.k_pool + off);
        vv = *reinterpret_cast<const uint4*>(p.v_pool + off);
      }
      *reinterpret_cast<uint4*>(&ks[j][part * 8]) = kv;
      *reinterpret_cast<uint4*>(&vs[j][part * 8]) = vv;
    }
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T for this warp's 16 rows x kTileN keys.
    float s[kTileN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kTileN / 8; ++nt) {
        const uint16_t* kr = &ks[nt * 8 + g][kk * 16 + 2 * t4];
        mma_16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(kr),
                  *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    // Mask, scale into the exp2 domain, online softmax update.
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + nt * 8 + 2 * t4 + e;
        s[nt][e] = visible(col, qpos_a, p.window)
                       ? s[nt][e] * p.scale_log2e : -INFINITY;
        s[nt][2 + e] = visible(col, qpos_b, p.window)
                           ? s[nt][2 + e] * p.scale_log2e : -INFINITY;
        mx_a = fmaxf(mx_a, s[nt][e]);
        mx_b = fmaxf(mx_b, s[nt][2 + e]);
      }
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
    for (int nt = 0; nt < kTileN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[nt][e] = exp2f(s[nt][e] - base_a);
        s[nt][2 + e] = exp2f(s[nt][2 + e] - base_b);
        l_a += s[nt][e];
        l_b += s[nt][2 + e];
      }
    }
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha_a;
      acc[dn][1] *= alpha_a;
      acc[dn][2] *= alpha_b;
      acc[dn][3] *= alpha_b;
    }

    // acc += P V: the S accumulators of two adjacent key octets are the
    // A fragment of one 16-key step; V's B fragment pairs two key rows.
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int tok = kk * 16 + 2 * t4;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + g;
        const uint32_t b0 = (uint32_t)vs[tok][col] |
                            ((uint32_t)vs[tok + 1][col] << 16);
        const uint32_t b1 = (uint32_t)vs[tok + 8][col] |
                            ((uint32_t)vs[tok + 9][col] << 16);
        mma_16816(acc[dn], a, b0, b1);
      }
    }
  }

  if (!warp_live) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = l_a > 0.f ? 1.f / l_a : 0.f;
  const float inv_b = l_b > 0.f ? 1.f / l_b : 0.f;
  const float lse2_a = l_a > 0.f ? m_a + log2f(l_a) : -INFINITY;
  const float lse2_b = l_b > 0.f ? m_b + log2f(l_b) : -INFINITY;

  if (!kSplit) {
    if (ra < rows) {
      __nv_bfloat16* orow = p.o + (size_t)(row_base + ra) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
      if (t4 == 0) p.lse[row_base + ra] = lse2_a * kLn2;
    }
    if (rb < rows) {
      __nv_bfloat16* orow = p.o + (size_t)(row_base + rb) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8 + 2 * t4) =
            __floats2bfloat162_rn(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
      if (t4 == 0) p.lse[row_base + rb] = lse2_b * kLn2;
    }
  } else {
    const size_t prow =
        (((size_t)b * p.kv_heads + h) * p.splits + split) * rows;
    if (ra < rows) {
      float* po = p.part_o + (prow + ra) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(po + dn * 8 + 2 * t4) =
            make_float2(acc[dn][0] * inv_a, acc[dn][1] * inv_a);
      if (t4 == 0) p.part_lse[prow + ra] = lse2_a;
    }
    if (rb < rows) {
      float* po = p.part_o + (prow + rb) * D;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn)
        *reinterpret_cast<float2*>(po + dn * 8 + 2 * t4) =
            make_float2(acc[dn][2] * inv_b, acc[dn][3] * inv_b);
      if (t4 == 0) p.part_lse[prow + rb] = lse2_b;
    }
  }
}

// Chunked prefill: grid (row tiles, kv_heads, batch); writes o and lse.
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_prefill_kernel(Params p) {
  attend<D, false>(p, blockIdx.x, 0);
}

// Split-KV decode: grid (row tiles * splits, kv_heads, batch); writes
// one normalized partial and its base-2 lse per split.
template <int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(Params p) {
  attend<D, true>(p, blockIdx.x / p.splits, blockIdx.x % p.splits);
}

Params make_params(const void* q, const void* k_pool, const void* v_pool,
                   const void* table, const void* lengths, void* o,
                   void* lse, int q_heads, int kv_heads, int q_chunk,
                   int page_size, int max_pages, float scale, int window) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k_pool = static_cast<const __nv_bfloat16*>(k_pool);
  p.v_pool = static_cast<const __nv_bfloat16*>(v_pool);
  p.table = static_cast<const int*>(table);
  p.lengths = static_cast<const int*>(lengths);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.part_o = nullptr;
  p.part_lse = nullptr;
  p.q_heads = q_heads;
  p.kv_heads = kv_heads;
  p.q_chunk = q_chunk;
  p.page_size = page_size;
  p.max_pages = max_pages;
  p.scale_log2e = scale * kLog2e;
  p.window = window;
  p.splits = 1;
  return p;
}

}  // namespace

extern "C" {

int mfa_paged_prefill(const void* q, const void* k_pool, const void* v_pool,
                      const void* table, const void* lengths, void* o,
                      void* lse, int batch, int q_heads, int kv_heads,
                      int q_chunk, int head_dim, int page_size,
                      int max_pages, float scale, int window,
                      void* stream) {
  const Params p = make_params(q, k_pool, v_pool, table, lengths, o, lse,
                               q_heads, kv_heads, q_chunk, page_size,
                               max_pages, scale, window);
  const int rows = q_heads / kv_heads * q_chunk;
  if (batch == 0 || rows == 0) return 0;
  const dim3 grid((rows + kTileM - 1) / kTileM, kv_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64)
    paged_prefill_kernel<64><<<grid, kThreads, 0, s>>>(p);
  else if (head_dim == 128)
    paged_prefill_kernel<128><<<grid, kThreads, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

int mfa_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                     const void* table, const void* lengths, void* o,
                     void* lse, int batch, int q_heads, int kv_heads,
                     int q_chunk, int head_dim, int page_size, int max_pages,
                     float scale, int window, void* part_o, void* part_lse,
                     int splits, void* stream) {
  Params p = make_params(q, k_pool, v_pool, table, lengths, o, lse, q_heads,
                         kv_heads, q_chunk, page_size, max_pages, scale,
                         window);
  p.part_o = static_cast<float*>(part_o);
  p.part_lse = static_cast<float*>(part_lse);
  p.splits = splits;
  const int rows = q_heads / kv_heads * q_chunk;
  if (batch == 0 || rows == 0) return 0;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(((rows + kTileM - 1) / kTileM) * splits, kv_heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 64) {
    paged_decode_split_kernel<64><<<grid, kThreads, 0, s>>>(p);
    merge_splits<__nv_bfloat16, 64>(p.part_o, p.part_lse, p.o, p.lse, rows,
                                    kv_heads, batch, splits, s);
  } else if (head_dim == 128) {
    paged_decode_split_kernel<128><<<grid, kThreads, 0, s>>>(p);
    merge_splits<__nv_bfloat16, 128>(p.part_o, p.part_lse, p.o, p.lse, rows,
                                     kv_heads, batch, splits, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* mfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
