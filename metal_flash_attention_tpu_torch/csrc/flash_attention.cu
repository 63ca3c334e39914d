// Fused flash-attention forward for NVIDIA Hopper (sm_90a), plain C
// interface.
//
// Replaces two TPU kernels of metal_flash_attention_tpu/ops/flash_attention.py:
//   _make_fwd_kernel          (pallas_call at :1253), the grid kernel that
//                             skips invisible KV blocks with a guard;
//   _make_fwd_kernel_dynamic  (pallas_call at :1097), the variant whose KV
//                             loop visits only the visible blocks.
// One kernel does both: each block's key loop runs from its first to its
// last visible key tile, which is row 3's design and makes row 2's skip
// guard and index clamps unnecessary.
//
// O = softmax(Q K^T * scale) V and the natural-log row logsumexp, for
// q [b, q_heads, q_len, D] and k/v [b, kv_heads, kv_len, D] (GQA: q head
// h reads kv head h / group).  Causal masking is aligned bottom-right
// (offset = kv_len - q_len); a window w keeps keys > qpos - w.  A row
// that sees no key gives o = 0 and lse = -inf.
//
// Bound: at the training shapes (causal, q_len = kv_len = 8192, D = 128)
// the work is 4 * D FLOPs per visible (row, key) pair against ~170 MB of
// HBM traffic, so the tensor cores bound it.  The design keeps every
// score in registers: a block owns 64 query rows of one kv head, laid
// out group-major (row g * q_len + t is query t of group member g), so
// one K/V tile in shared memory serves all the group's heads; QK^T and
// PV run on mma.sync m16n8k16 (16-bit in, fp32 accumulate) with the
// online softmax (m, l, acc) in fp32 in the exp2 domain, scale * log2(e)
// folded into the scores.  Simple, not fast yet: no cp.async/TMA
// pipelining of the K/V tiles, no wgmma.
//
// Every function returns cudaGetLastError() after its launch.

#include "attention_common.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace mfa;

constexpr int kTileM = MFA_FWD_BLOCK_Q;   // query rows per block (16 a warp)
constexpr int kTileN = MFA_FWD_BLOCK_KV;  // keys per iteration
constexpr int kWarps = kTileM / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;              // 16-bit padding per shared row

struct FwdParams {
  const void* q;  // [b, q_heads, q_len, D]
  const void* k;  // [b, kv_heads, kv_len, D]
  const void* v;
  void* o;        // like q, T or float
  float* lse;     // [b, q_heads, q_len], natural log
  int q_heads, kv_heads, q_len, kv_len;
  float scale_log2e;
  int causal, window, o_f32;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdParams p) {
  constexpr int S = D + kPad;
  __shared__ __align__(16) uint16_t ks[kTileN * S];
  __shared__ __align__(16) uint16_t vs[kTileN * S];

  const int b = blockIdx.z, h = blockIdx.y;
  const int group = p.q_heads / p.kv_heads;
  const int rows = group * p.q_len;
  const int offset = p.kv_len - p.q_len;
  const bool causal = p.causal != 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  // Keys any row of this tile can see: [col_lo, col_hi].
  const int r0 = blockIdx.x * kTileM;
  const int r_last = min(r0 + kTileM, rows) - 1;
  int t_min = 0, t_max = p.q_len - 1;
  if (r0 / p.q_len == r_last / p.q_len) {
    t_min = r0 % p.q_len;
    t_max = r_last % p.q_len;
  }
  const int col_hi =
      causal ? min(p.kv_len - 1, offset + t_max) : p.kv_len - 1;
  const int col_lo = p.window > 0 ? max(0, offset + t_min - p.window + 1) : 0;
  const int tile_begin = col_lo / kTileN;
  const int tile_end = col_hi >= col_lo ? col_hi / kTileN + 1 : tile_begin;

  const size_t row_base =
      ((size_t)b * p.q_heads + (size_t)h * group) * p.q_len;
  const size_t kv_base = ((size_t)b * p.kv_heads + h) * p.kv_len * D;
  const T* kp = static_cast<const T*>(p.k) + kv_base;
  const T* vp = static_cast<const T*>(p.v) + kv_base;

  // This lane's two rows, their query positions, and Q as A fragments.
  const int wr = r0 + 16 * warp;
  const bool warp_live = wr < rows;
  const int ra = wr + g, rb = wr + g + 8;
  const int qpos_a = ra % p.q_len + offset, qpos_b = rb % p.q_len + offset;
  uint32_t qf[D / 16][4];
  {
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(p.q) + (row_base + ra) * D);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(p.q) + (row_base + rb) * D);
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
    load_rows<D, kPad>(ks, kp, j0, kTileN, p.kv_len, threadIdx.x, kThreads);
    load_rows<D, kPad>(vs, vp, j0, kTileN, p.kv_len, threadIdx.x, kThreads);
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
      for (int nt = 0; nt < kTileN / 8; ++nt)
        mma_16816<T>(s[nt], qf[kk],
                     cols_pair(ks, S, nt * 8 + g, kk * 16 + 2 * t4),
                     cols_pair(ks, S, nt * 8 + g, kk * 16 + 2 * t4 + 8));
    }

    // Mask, scale into the exp2 domain, online softmax update.
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + nt * 8 + 2 * t4 + e;
        s[nt][e] = key_visible(col, qpos_a, p.kv_len, causal, p.window)
                       ? s[nt][e] * p.scale_log2e : -INFINITY;
        s[nt][2 + e] = key_visible(col, qpos_b, p.kv_len, causal, p.window)
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

    // acc += P V: two adjacent score octets are one 16-key A fragment.
#pragma unroll
    for (int kk = 0; kk < kTileN / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int tok = kk * 16 + 2 * t4;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + g;
        mma_16816<T>(acc[dn], a, rows_pair(vs, S, tok, col),
                     rows_pair(vs, S, tok + 8, col));
      }
    }
  }

  if (!warp_live) return;
  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv[2] = {l_a > 0.f ? 1.f / l_a : 0.f,
                        l_b > 0.f ? 1.f / l_b : 0.f};
  const float lse2[2] = {l_a > 0.f ? m_a + log2f(l_a) : -INFINITY,
                         l_b > 0.f ? m_b + log2f(l_b) : -INFINITY};
  const int row[2] = {ra, rb};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row[half] >= rows) continue;
    const size_t orow = (row_base + row[half]) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      const float x0 = acc[dn][2 * half] * inv[half];
      const float x1 = acc[dn][2 * half + 1] * inv[half];
      const size_t at = orow + dn * 8 + 2 * t4;
      if (p.o_f32)
        *reinterpret_cast<float2*>(static_cast<float*>(p.o) + at) =
            make_float2(x0, x1);
      else
        *reinterpret_cast<uint32_t*>(static_cast<T*>(p.o) + at) =
            pack2<T>(x0, x1);
    }
    if (t4 == 0) p.lse[row_base + row[half]] = lse2[half] * kLn2;
  }
}

template <typename T>
int launch(const FwdParams& p, int batch, int head_dim, cudaStream_t s) {
  const int rows = p.q_heads / p.kv_heads * p.q_len;
  const dim3 grid((rows + kTileM - 1) / kTileM, p.kv_heads, batch);
  if (head_dim == 64)
    flash_fwd_kernel<T, 64><<<grid, kThreads, 0, s>>>(p);
  else if (head_dim == 128)
    flash_fwd_kernel<T, 128><<<grid, kThreads, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// o: q's dtype, or float32 when o_f32; lse: float32.  is_fp16 selects
// fp16 inputs (else bf16).  window <= 0: none.
int mfa_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int batch, int q_heads, int kv_heads, int q_len,
                  int kv_len, int head_dim, float scale, int causal,
                  int window, int is_fp16, int o_f32, void* stream) {
  if (batch == 0 || q_len == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads) return (int)cudaErrorInvalidValue;
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.q_heads = q_heads;
  p.kv_heads = kv_heads;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.scale_log2e = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  p.o_f32 = o_f32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_fp16 ? launch<__half>(p, batch, head_dim, s)
                 : launch<__nv_bfloat16>(p, batch, head_dim, s);
}

const char* mfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
