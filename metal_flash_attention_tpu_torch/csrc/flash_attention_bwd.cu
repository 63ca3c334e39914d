// Atomic-free flash-attention backward for NVIDIA Hopper (sm_90a), plain C
// interface: two kernels, each owning its output tiles.
//
// Replaces the two TPU kernels of
// metal_flash_attention_tpu/ops/flash_attention_bwd.py:
//   _make_dq_kernel   (pallas_call at :587), backwardQuery;
//   _make_dkv_kernel  (pallas_call at :700), backwardKeyValue, which sums
//                     the GQA group inside the kernel (:613-618).
//
// Both recompute the scores from Q, K and the forward's lse L, in the
// exp2 domain: P = exp2(S * scale * log2(e) - L * log2(e)).  A row that
// saw no key has L = -inf; it is read as 0 so that its P, masked
// everywhere, is exactly 0 and never NaN.  D = rowsum(dO * O) comes in
// precomputed (fp32).  Then dP = dO V^T and dS = P * (dP - D), and
//   flash_bwd_dq:  dQ = scale * dS K, one block per 64 query rows of one
//                  kv head (group-major, as in the forward: with q_len a
//                  multiple of 64, one (batch, q head, q tile)), looping
//                  over its visible key tiles;
//   flash_bwd_dkv: dV = P^T dO and dK = scale * dS^T Q, one block per
//                  (batch, kv head, 64-key tile), looping over the group's
//                  q heads and their visible query tiles.  Each block owns
//                  its dK/dV rows, so there are no atomics; the scale is
//                  applied at the store, then the cast to K's dtype.
//
// Bound: 3 (dQ) and 4 (dK/dV) products of 2 * D FLOPs per visible (row,
// key) pair, against a few hundred MB of traffic at the training shapes:
// the tensor cores bound both.  mma.sync m16n8k16 (16-bit in, fp32
// accumulate) throughout; P and dS are rounded to the input type before
// the products that consume them.  The dK/dV kernel computes the
// transposed scores S^T = K Q^T so that its accumulators are rows of keys:
// two fp32 [16, D] accumulators a warp plus the [16, 32] S^T and dP^T
// tiles fit the register file at D = 128, which sets its 32-row query
// tile.  Simple, not fast yet: no cp.async/TMA pipelining, no wgmma.
//
// Every function returns cudaGetLastError() after its launch.

#include "attention_common.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace mfa;

constexpr int kTileM = MFA_DQ_BLOCK_Q;     // dQ: query rows per block
constexpr int kTileN = MFA_DQ_BLOCK_KV;    // dQ: keys per iteration
constexpr int kTileKV = MFA_DKV_BLOCK_KV;  // dK/dV: keys per block
constexpr int kTileQ = MFA_DKV_BLOCK_Q;    // dK/dV: query rows per iteration
constexpr int kWarps = kTileM / 16;
constexpr int kThreads = 32 * kWarps;
static_assert(kTileKV == kTileM, "both backward kernels run kThreads");
constexpr int kPad = 8;               // 16-bit padding per shared row

struct BwdParams {
  const void* q;      // [b, q_heads, q_len, D]
  const void* k;      // [b, kv_heads, kv_len, D]
  const void* v;
  const void* dout;   // like q
  const float* lse;   // [b, q_heads, q_len], natural log
  const float* dterm; // [b, q_heads, q_len], rowsum(dO * O)
  void* dq;           // like q
  void* dk;           // like k
  void* dv;
  int q_heads, kv_heads, q_len, kv_len;
  float scale, scale_log2e;
  int causal, window;
};

__device__ __forceinline__ float lse_base2(float lse) {
  return lse == -INFINITY ? 0.f : lse * kLog2e;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
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

  const int wr = r0 + 16 * warp;
  const bool warp_live = wr < rows;
  const int ra = wr + g, rb = wr + g + 8;
  const int qpos_a = ra % p.q_len + offset, qpos_b = rb % p.q_len + offset;
  // Q and dO as A fragments; this lane's rows' L (base 2) and D.
  uint32_t qf[D / 16][4], of[D / 16][4];
  {
    const uint32_t* qa = reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(p.q) + (row_base + ra) * D);
    const uint32_t* qb = reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(p.q) + (row_base + rb) * D);
    const uint32_t* oa = reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(p.dout) + (row_base + ra) * D);
    const uint32_t* ob = reinterpret_cast<const uint32_t*>(
        static_cast<const T*>(p.dout) + (row_base + rb) * D);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 8 + t4;
      qf[kk][0] = ra < rows ? qa[c] : 0u;
      qf[kk][1] = rb < rows ? qb[c] : 0u;
      qf[kk][2] = ra < rows ? qa[c + 4] : 0u;
      qf[kk][3] = rb < rows ? qb[c + 4] : 0u;
      of[kk][0] = ra < rows ? oa[c] : 0u;
      of[kk][1] = rb < rows ? ob[c] : 0u;
      of[kk][2] = ra < rows ? oa[c + 4] : 0u;
      of[kk][3] = rb < rows ? ob[c + 4] : 0u;
    }
  }
  const float l2_a = ra < rows ? lse_base2(p.lse[row_base + ra]) : 0.f;
  const float l2_b = rb < rows ? lse_base2(p.lse[row_base + rb]) : 0.f;
  const float d_a = ra < rows ? p.dterm[row_base + ra] : 0.f;
  const float d_b = rb < rows ? p.dterm[row_base + rb] : 0.f;

  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int j0 = tile * kTileN;
    __syncthreads();
    load_rows<D, kPad>(ks, kp, j0, kTileN, p.kv_len, threadIdx.x, kThreads);
    load_rows<D, kPad>(vs, vp, j0, kTileN, p.kv_len, threadIdx.x, kThreads);
    __syncthreads();
    if (!warp_live) continue;

    // S = Q K^T and dP = dO V^T for this warp's 16 rows x kTileN keys.
    float s[kTileN / 8][4], dp[kTileN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt)
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = dp[nt][0] = dp[nt][1] =
          dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nt = 0; nt < kTileN / 8; ++nt) {
        const int r = nt * 8 + g, c = kk * 16 + 2 * t4;
        mma_16816<T>(s[nt], qf[kk], cols_pair(ks, S, r, c),
                     cols_pair(ks, S, r, c + 8));
        mma_16816<T>(dp[nt], of[kk], cols_pair(vs, S, r, c),
                     cols_pair(vs, S, r, c + 8));
      }
    }

    // dS = P * (dP - D), with P = 0 wherever the key is not visible.
#pragma unroll
    for (int nt = 0; nt < kTileN / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + nt * 8 + 2 * t4 + e;
        const float pa =
            key_visible(col, qpos_a, p.kv_len, causal, p.window)
                ? exp2f(s[nt][e] * p.scale_log2e - l2_a) : 0.f;
        const float pb =
            key_visible(col, qpos_b, p.kv_len, causal, p.window)
                ? exp2f(s[nt][2 + e] * p.scale_log2e - l2_b) : 0.f;
        s[nt][e] = pa * (dp[nt][e] - d_a);
        s[nt][2 + e] = pb * (dp[nt][2 + e] - d_b);
      }
    }

    // dQ += dS K.
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
        mma_16816<T>(acc[dn], a, rows_pair(ks, S, tok, col),
                     rows_pair(ks, S, tok + 8, col));
      }
    }
  }

  if (!warp_live) return;
  const int row[2] = {ra, rb};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (row[half] >= rows) continue;
    T* out = static_cast<T*>(p.dq) + (row_base + row[half]) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      *reinterpret_cast<uint32_t*>(out + dn * 8 + 2 * t4) =
          pack2<T>(acc[dn][2 * half] * p.scale,
                   acc[dn][2 * half + 1] * p.scale);
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  return (2 * kTileKV + 2 * kTileQ) * (D + kPad) * 2 + 2 * kTileQ * 4;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(BwdParams p) {
  constexpr int S = D + kPad;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;                 // [kTileKV][S], this block's keys
  uint16_t* vs = ks + kTileKV * S;
  uint16_t* qs = vs + kTileKV * S;     // [kTileQ][S], the current q tile
  uint16_t* dos = qs + kTileQ * S;
  float* l2s = reinterpret_cast<float*>(dos + kTileQ * S);  // [kTileQ]
  float* ds = l2s + kTileQ;                                 // [kTileQ]

  const int b = blockIdx.z, h = blockIdx.y;
  const int j0 = blockIdx.x * kTileKV;
  const int group = p.q_heads / p.kv_heads;
  const int offset = p.kv_len - p.q_len;
  const bool causal = p.causal != 0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;

  const size_t kv_base = ((size_t)b * p.kv_heads + h) * p.kv_len * D;
  load_rows<D, kPad>(ks, static_cast<const T*>(p.k) + kv_base, j0, kTileKV,
                     p.kv_len, threadIdx.x, kThreads);
  load_rows<D, kPad>(vs, static_cast<const T*>(p.v) + kv_base, j0, kTileKV,
                     p.kv_len, threadIdx.x, kThreads);

  // Query rows t that see any key of [j0, j_last]: causal needs
  // t + offset >= j0, the window t + offset - window < j_last.
  const int j_last = min(j0 + kTileKV, p.kv_len) - 1;
  const int t_lo = causal ? max(0, j0 - offset) : 0;
  const int t_hi = p.window > 0
                       ? min(p.q_len - 1, j_last - offset + p.window - 1)
                       : p.q_len - 1;

  const int kw = 16 * warp;  // this warp's first key row in the tile
  const int key_a = j0 + kw + g, key_b = key_a + 8;
  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
    dk[dn][0] = dk[dn][1] = dk[dn][2] = dk[dn][3] = dv[dn][0] = dv[dn][1] =
        dv[dn][2] = dv[dn][3] = 0.f;

  for (int gm = 0; gm < group; ++gm) {
    const size_t qrow0 =
        ((size_t)b * p.q_heads + (size_t)h * group + gm) * p.q_len;
    const T* qh = static_cast<const T*>(p.q) + qrow0 * D;
    const T* doh = static_cast<const T*>(p.dout) + qrow0 * D;
    for (int i0 = (t_lo / kTileQ) * kTileQ; t_lo <= t_hi && i0 <= t_hi;
         i0 += kTileQ) {
      __syncthreads();  // the previous q tile is consumed
      load_rows<D, kPad>(qs, qh, i0, kTileQ, p.q_len, threadIdx.x, kThreads);
      load_rows<D, kPad>(dos, doh, i0, kTileQ, p.q_len, threadIdx.x,
                         kThreads);
      for (int i = threadIdx.x; i < kTileQ; i += kThreads) {
        const bool live = i0 + i < p.q_len;
        l2s[i] = live ? lse_base2(p.lse[qrow0 + i0 + i]) : 0.f;
        ds[i] = live ? p.dterm[qrow0 + i0 + i] : 0.f;
      }
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x kTileQ rows.
      float s[kTileQ / 8][4], dp[kTileQ / 8][4];
#pragma unroll
      for (int nt = 0; nt < kTileQ / 8; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = dp[nt][0] =
            dp[nt][1] = dp[nt][2] = dp[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t4;
        const uint32_t ka[4] = {
            cols_pair(ks, S, kw + g, c), cols_pair(ks, S, kw + g + 8, c),
            cols_pair(ks, S, kw + g, c + 8),
            cols_pair(ks, S, kw + g + 8, c + 8)};
        const uint32_t va[4] = {
            cols_pair(vs, S, kw + g, c), cols_pair(vs, S, kw + g + 8, c),
            cols_pair(vs, S, kw + g, c + 8),
            cols_pair(vs, S, kw + g + 8, c + 8)};
#pragma unroll
        for (int nt = 0; nt < kTileQ / 8; ++nt) {
          const int r = nt * 8 + g;
          mma_16816<T>(s[nt], ka, cols_pair(qs, S, r, c),
                       cols_pair(qs, S, r, c + 8));
          mma_16816<T>(dp[nt], va, cols_pair(dos, S, r, c),
                       cols_pair(dos, S, r, c + 8));
        }
      }

      // P^T, and dS^T = P^T * (dP^T - D), zero where not visible.
#pragma unroll
      for (int nt = 0; nt < kTileQ / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = nt * 8 + 2 * t4 + e;
          const int t = i0 + i;
          const int qpos = t + offset;
          const bool live = t < p.q_len;
          const float pa =
              live && key_visible(key_a, qpos, p.kv_len, causal, p.window)
                  ? exp2f(s[nt][e] * p.scale_log2e - l2s[i]) : 0.f;
          const float pb =
              live && key_visible(key_b, qpos, p.kv_len, causal, p.window)
                  ? exp2f(s[nt][2 + e] * p.scale_log2e - l2s[i]) : 0.f;
          s[nt][e] = pa;
          s[nt][2 + e] = pb;
          dp[nt][e] = pa * (dp[nt][e] - ds[i]);
          dp[nt][2 + e] = pb * (dp[nt][2 + e] - ds[i]);
        }
      }

      // dV += P^T dO and dK += dS^T Q.
#pragma unroll
      for (int kk = 0; kk < kTileQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        da[0] = pack2<T>(dp[2 * kk][0], dp[2 * kk][1]);
        da[1] = pack2<T>(dp[2 * kk][2], dp[2 * kk][3]);
        da[2] = pack2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
        da[3] = pack2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
        const int tok = kk * 16 + 2 * t4;
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const int col = dn * 8 + g;
          mma_16816<T>(dv[dn], pa, rows_pair(dos, S, tok, col),
                       rows_pair(dos, S, tok + 8, col));
          mma_16816<T>(dk[dn], da, rows_pair(qs, S, tok, col),
                       rows_pair(qs, S, tok + 8, col));
        }
      }
    }
  }

  const int key[2] = {key_a, key_b};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    if (key[half] >= p.kv_len) continue;
    const size_t at = kv_base + (size_t)key[half] * D;
    T* dko = static_cast<T*>(p.dk) + at;
    T* dvo = static_cast<T*>(p.dv) + at;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(dko + dn * 8 + 2 * t4) =
          pack2<T>(dk[dn][2 * half] * p.scale,
                   dk[dn][2 * half + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvo + dn * 8 + 2 * t4) =
          pack2<T>(dv[dn][2 * half], dv[dn][2 * half + 1]);
    }
  }
}

BwdParams make_params(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dterm,
                      int q_heads, int kv_heads, int q_len, int kv_len,
                      float scale, int causal, int window) {
  BwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.dterm = static_cast<const float*>(dterm);
  p.dq = p.dk = p.dv = nullptr;
  p.q_heads = q_heads;
  p.kv_heads = kv_heads;
  p.q_len = q_len;
  p.kv_len = kv_len;
  p.scale = scale;
  p.scale_log2e = scale * kLog2e;
  p.causal = causal;
  p.window = window;
  return p;
}

template <typename T>
int launch_dq(const BwdParams& p, int batch, int head_dim, cudaStream_t s) {
  const int rows = p.q_heads / p.kv_heads * p.q_len;
  const dim3 grid((rows + kTileM - 1) / kTileM, p.kv_heads, batch);
  if (head_dim == 64)
    flash_bwd_dq_kernel<T, 64><<<grid, kThreads, 0, s>>>(p);
  else if (head_dim == 128)
    flash_bwd_dq_kernel<T, 128><<<grid, kThreads, 0, s>>>(p);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv_d(const BwdParams& p, int batch, cudaStream_t s) {
  constexpr int bytes = dkv_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.kv_len + kTileKV - 1) / kTileKV, p.kv_heads, batch);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, s>>>(p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const BwdParams& p, int batch, int head_dim, cudaStream_t s) {
  if (head_dim == 64) return launch_dkv_d<T, 64>(p, batch, s);
  if (head_dim == 128) return launch_dkv_d<T, 128>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dq like q; is_fp16 selects fp16 (else bf16) for q, k, v, dout and dq.
int mfa_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* dterm,
                     void* dq, int batch, int q_heads, int kv_heads,
                     int q_len, int kv_len, int head_dim, float scale,
                     int causal, int window, int is_fp16, void* stream) {
  if (batch == 0 || q_len == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, dterm, q_heads, kv_heads,
                            q_len, kv_len, scale, causal, window);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_fp16 ? launch_dq<__half>(p, batch, head_dim, s)
                 : launch_dq<__nv_bfloat16>(p, batch, head_dim, s);
}

// dk/dv like k, the GQA group summed in the kernel.
int mfa_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* dterm,
                      void* dk, void* dv, int batch, int q_heads,
                      int kv_heads, int q_len, int kv_len, int head_dim,
                      float scale, int causal, int window, int is_fp16,
                      void* stream) {
  if (batch == 0 || kv_len == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads) return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(q, k, v, dout, lse, dterm, q_heads, kv_heads,
                            q_len, kv_len, scale, causal, window);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_fp16 ? launch_dkv<__half>(p, batch, head_dim, s)
                 : launch_dkv<__nv_bfloat16>(p, batch, head_dim, s);
}

const char* mfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
