// Dense decode attention for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel built by
//   metal_flash_attention_tpu/ops/flash_decode.py::_make_decode_kernel
// (pallas_call at ops/flash_decode.py:590) for unquantized K/V: one query
// token per sequence against a dense cache [batch, kv_heads, S, D]; the
// GQA group of a kv head are the rows of one block; row b attends the
// keys start[b] <= col < end[b] (end = kv_lens[b], or S; with max_span,
// at most start + max_span).  A row that sees no key gives o = 0 and
// lse = -inf; the lse is natural-log at the interface.
//
// What bounds it: HBM bytes.  Every live K and V row is read once and
// feeds only the `group` rows of its kv head: about 4 FLOP per byte of
// K/V (group 4, D 128, bf16), a fifth of what the H100's fp32 CUDA cores
// give at the full HBM rate.  So the arithmetic runs on CUDA cores in
// fp32 (fp32 inputs in true fp32, as the JAX package's Precision.HIGHEST
// does), and the design is about keeping enough K/V bytes in flight.
//
// The TPU grid walked the key blocks of one (sequence, kv head) in order
// on one core, padded the group to 8 sublanes and D to 128 lanes, clamped
// dead steps through its index map and, with max_span, shortened its
// sequential grid.  None of that applies here.  Blocks run in parallel,
// one per (split, kv head, sequence); each computes its loop bounds from
// its row's own [start, end) and walks an even share of the row's live
// kTileN-key tiles (split-KV, so that a small batch still fills the 132
// SMs).  A tile of K and of V is staged in shared memory with 16-byte
// loads, all started before the first is used; rows outside [start, end)
// are zero and never read.  The online softmax (m, l, acc) runs in fp32
// in the exp2 domain.  Each block writes a float32 partial (o, base-2
// lse); a second kernel, the paged decode's (`merge_splits` in
// attention_common.cuh), merges the splits by lse and writes o in q's
// type.  A split that sees no key has lse = -inf and weight 0.  The tile
// and the largest group are in flash_tiles.cuh, which the wrapper reads.
//
// K and V are addressed through their batch, head and sequence strides
// (in elements), so a slice of a cache along the sequence axis needs no
// copy; only the last axis must be contiguous.
//
// Every entry point returns cudaGetLastError() after its launches.

#include "attention_common.cuh"
#include "flash_tiles.cuh"

namespace {

using namespace mfa;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = MFA_DECODE_BLOCK_KV;     // keys per tile
constexpr int kMaxGroup = MFA_DECODE_MAX_GROUP; // q heads per kv head
static_assert(kThreads == 2 * kTileN, "scores: two threads per key");

template <typename T>
struct Params {
  const T* q;        // [b, q_heads, D], contiguous
  const T* k;        // [b, kv_heads, S, D] at the strides below
  const T* v;
  const int* lens;   // [b] or null (S)
  const int* starts; // [b] or null (0)
  T* o;              // [b, q_heads, D]
  float* lse;        // [b, q_heads], natural log
  float* part_o;     // [b, kv_heads, splits, group, D]
  float* part_lse;   // [b, kv_heads, splits, group], base 2
  long long k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  int q_heads, kv_heads, seq, max_span, splits;
  float scale_log2e;
};

// 16 bytes of T as floats, two adjacent values as a float2, one as a
// float.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static constexpr int kPerVec = 8;
  __device__ static void unpack(const uint4& x, float* f) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static float2 pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  __device__ static float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
};

template <>
struct Elem<__half> {
  static constexpr int kPerVec = 8;
  __device__ static void unpack(const uint4& x, float* f) {
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static float2 pair(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
  }
  __device__ static float to_float(__half x) { return __half2float(x); }
};

template <>
struct Elem<float> {
  static constexpr int kPerVec = 4;
  __device__ static void unpack(const uint4& x, float* f) {
    f[0] = __uint_as_float(x.x);
    f[1] = __uint_as_float(x.y);
    f[2] = __uint_as_float(x.z);
    f[3] = __uint_as_float(x.w);
  }
  __device__ static float2 pair(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  __device__ static float to_float(float x) { return x; }
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, s));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(kFull, x, s);
  return x;
}

// Shared memory: the float arrays first, then the K and V tiles.
template <typename T, int D>
struct Smem {
  static constexpr int kPad = 16 / sizeof(T);  // 16 bytes a row: no bank
  static constexpr int kStride = D + kPad;     // conflicts across rows
  static size_t bytes(int group) {
    return sizeof(float) * (3 * kMaxGroup + group * D + group * kTileN) +
           2 * sizeof(T) * kTileN * kStride;
  }
};

// The row's live key range [lo, hi) and this split's tiles.
template <typename T>
__device__ __forceinline__ void key_range(const Params<T>& p, int b,
                                          int split, int& lo, int& hi,
                                          int& tile_begin, int& tile_end) {
  lo = p.starts ? max(p.starts[b], 0) : 0;
  hi = p.lens ? min(p.lens[b], p.seq) : p.seq;
  if (p.max_span > 0) hi = min(hi, lo + p.max_span);
  tile_begin = lo / kTileN;
  tile_end = hi > lo ? (hi + kTileN - 1) / kTileN : tile_begin;
  const int per = (tile_end - tile_begin + p.splits - 1) / p.splits;
  const int first = tile_begin + split * per;
  tile_end = min(tile_end, first + per);
  tile_begin = min(first, tile_end);
}

// One block: the group's rows of (sequence b, kv head h) against the key
// tiles of one split; writes the normalized float32 partial and its
// base-2 lse.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_decode_split_kernel(Params<T> p) {
  using E = Elem<T>;
  using S = Smem<T, D>;
  constexpr int kPerVec = E::kPerVec;
  constexpr int kChunks = D / kPerVec;  // 16-byte chunks per row
  constexpr int kLoads = kTileN * kChunks / kThreads;
  constexpr int kRowStep = kThreads / (D / 2);  // PV: rows between a
  constexpr int kRowsPV = kMaxGroup / kRowStep; // thread's rows
  constexpr int kRowsS = kMaxGroup / 2;
  static_assert(kTileN * kChunks % kThreads == 0, "whole loads");

  extern __shared__ __align__(16) unsigned char smem[];
  float* ms = reinterpret_cast<float*>(smem);  // running max, base 2
  float* ls = ms + kMaxGroup;                  // running sum
  float* alphas = ls + kMaxGroup;              // this tile's rescale
  float* qs = alphas + kMaxGroup;              // [group][D], scaled
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int group = p.q_heads / p.kv_heads;
  float* ps = qs + group * D;                  // [group][kTileN]
  T* ks = reinterpret_cast<T*>(ps + group * kTileN);
  T* vs = ks + kTileN * S::kStride;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int lo, hi, tile_begin, tile_end;
  key_range(p, b, split, lo, hi, tile_begin, tile_end);

  const T* q = p.q + ((size_t)b * p.q_heads + (size_t)h * group) * D;
  for (int i = tid; i < group * D; i += kThreads)
    qs[i] = E::to_float(q[i]) * p.scale_log2e;
  if (tid < group) {
    ms[tid] = -INFINITY;
    ls[tid] = 0.f;
  }
  const T* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const T* vbase = p.v + b * p.v_sb + h * p.v_sh;

  // Scores: thread -> key j of the tile, rows rs, rs + 2, ...
  const int j_s = tid % kTileN, rs = tid / kTileN;
  // PV: thread -> columns 2cp, 2cp + 1, rows rp, rp + kRowStep, ...
  const int cp = tid % (D / 2), rp = tid / (D / 2);
  float acc[kRowsPV][2];
#pragma unroll
  for (int i = 0; i < kRowsPV; ++i) acc[i][0] = acc[i][1] = 0.f;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int j0 = tile * kTileN;
    __syncthreads();  // the previous tile is consumed (and qs is written)
    {
      uint4 kr[kLoads], vr[kLoads];
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int c = tid + i * kThreads;
        const int pos = j0 + c / kChunks, part = c % kChunks;
        kr[i] = vr[i] = make_uint4(0, 0, 0, 0);
        if (pos >= lo && pos < hi) {
          kr[i] = __ldg(reinterpret_cast<const uint4*>(
              kbase + pos * p.k_ss + part * kPerVec));
          vr[i] = __ldg(reinterpret_cast<const uint4*>(
              vbase + pos * p.v_ss + part * kPerVec));
        }
      }
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int c = tid + i * kThreads;
        const int off = (c / kChunks) * S::kStride + (c % kChunks) * kPerVec;
        *reinterpret_cast<uint4*>(ks + off) = kr[i];
        *reinterpret_cast<uint4*>(vs + off) = vr[i];
      }
    }
    __syncthreads();

    // S = (q * scale * log2 e) K^T, masked outside [lo, hi).
    {
      float s[kRowsS];
#pragma unroll
      for (int i = 0; i < kRowsS; ++i) s[i] = 0.f;
      const T* krow = ks + j_s * S::kStride;
#pragma unroll
      for (int part = 0; part < kChunks; ++part) {
        float kf[kPerVec];
        E::unpack(*reinterpret_cast<const uint4*>(krow + part * kPerVec), kf);
#pragma unroll
        for (int i = 0; i < kRowsS; ++i) {
          const int r = rs + 2 * i;
          if (r >= group) break;
          const float4* qr =
              reinterpret_cast<const float4*>(qs + r * D + part * kPerVec);
#pragma unroll
          for (int e = 0; e < kPerVec / 4; ++e) {
            const float4 qv = qr[e];
            s[i] += qv.x * kf[4 * e] + qv.y * kf[4 * e + 1] +
                    qv.z * kf[4 * e + 2] + qv.w * kf[4 * e + 3];
          }
        }
      }
      const int pos = j0 + j_s;
      const bool live = pos >= lo && pos < hi;
#pragma unroll
      for (int i = 0; i < kRowsS; ++i) {
        const int r = rs + 2 * i;
        if (r >= group) break;
        ps[r * kTileN + j_s] = live ? s[i] : -INFINITY;
      }
    }
    __syncthreads();

    // Online softmax, one warp per row: P = exp2(S - m_new) in place.
    for (int r = warp; r < group; r += kWarps) {
      float* pr = ps + r * kTileN;
      const float m_old = ms[r], l_old = ls[r];
      const float s0 = pr[lane], s1 = pr[lane + 32];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float base = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_old - base);
      const float p0 = exp2f(s0 - base), p1 = exp2f(s1 - base);
      const float sum = warp_sum(p0 + p1);
      pr[lane] = p0;
      pr[lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        ms[r] = m_new;
        ls[r] = l_old * alpha + sum;
        alphas[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V.
#pragma unroll
    for (int i = 0; i < kRowsPV; ++i) {
      const int r = rp + kRowStep * i;
      if (r >= group) break;
      acc[i][0] *= alphas[r];
      acc[i][1] *= alphas[r];
    }
#pragma unroll 8
    for (int j = 0; j < kTileN; ++j) {
      const float2 vv = E::pair(vs + j * S::kStride + 2 * cp);
#pragma unroll
      for (int i = 0; i < kRowsPV; ++i) {
        const int r = rp + kRowStep * i;
        if (r >= group) break;
        const float pj = ps[r * kTileN + j];
        acc[i][0] += pj * vv.x;
        acc[i][1] += pj * vv.y;
      }
    }
  }
  __syncthreads();

  const size_t prow = (((size_t)b * p.kv_heads + h) * p.splits + split) *
                      group;
#pragma unroll
  for (int i = 0; i < kRowsPV; ++i) {
    const int r = rp + kRowStep * i;
    if (r >= group) break;
    const float l = ls[r];
    const float inv = l > 0.f ? 1.f / l : 0.f;
    *reinterpret_cast<float2*>(p.part_o + (prow + r) * D + 2 * cp) =
        make_float2(acc[i][0] * inv, acc[i][1] * inv);
  }
  if (tid < group) {
    const float l = ls[tid];
    p.part_lse[prow + tid] = l > 0.f ? ms[tid] + log2f(l) : -INFINITY;
  }
}

template <typename T, int D>
int launch(const Params<T>& p, int batch, cudaStream_t stream) {
  const int group = p.q_heads / p.kv_heads;
  const size_t smem = Smem<T, D>::bytes(group);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_decode_split_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid(p.splits, p.kv_heads, batch);
  flash_decode_split_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  merge_splits<T, D>(p.part_o, p.part_lse, p.o, p.lse, group, p.kv_heads,
                     batch, p.splits, stream);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* lens,
             const void* starts, void* o, void* lse, void* part_o,
             void* part_lse, int batch, int q_heads, int kv_heads, int seq,
             int head_dim, const long long* strides, int max_span,
             float scale, int splits, cudaStream_t stream) {
  Params<T> p;
  p.q = static_cast<const T*>(q);
  p.k = static_cast<const T*>(k);
  p.v = static_cast<const T*>(v);
  p.lens = static_cast<const int*>(lens);
  p.starts = static_cast<const int*>(starts);
  p.o = static_cast<T*>(o);
  p.lse = static_cast<float*>(lse);
  p.part_o = static_cast<float*>(part_o);
  p.part_lse = static_cast<float*>(part_lse);
  p.k_sb = strides[0];
  p.k_sh = strides[1];
  p.k_ss = strides[2];
  p.v_sb = strides[3];
  p.v_sh = strides[4];
  p.v_ss = strides[5];
  p.q_heads = q_heads;
  p.kv_heads = kv_heads;
  p.seq = seq;
  p.max_span = max_span;
  p.splits = splits;
  p.scale_log2e = scale * kLog2e;
  if (head_dim == 64) return launch<T, 64>(p, batch, stream);
  if (head_dim == 128) return launch<T, 128>(p, batch, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 bf16, 1 fp16, 2 fp32 (q, K, V and o alike).  strides: the
// batch, head and sequence strides of K, then of V, in elements.
int mfa_flash_decode(const void* q, const void* k, const void* v,
                     const void* lens, const void* starts, void* o,
                     void* lse, void* part_o, void* part_lse, int batch,
                     int q_heads, int kv_heads, int seq, int head_dim,
                     const long long* strides, int max_span, float scale,
                     int splits, int dtype, void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads || q_heads / kv_heads > kMaxGroup ||
      splits < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return dispatch<__nv_bfloat16>(q, k, v, lens, starts, o, lse, part_o,
                                     part_lse, batch, q_heads, kv_heads, seq,
                                     head_dim, strides, max_span, scale,
                                     splits, s);
    case 1:
      return dispatch<__half>(q, k, v, lens, starts, o, lse, part_o,
                              part_lse, batch, q_heads, kv_heads, seq,
                              head_dim, strides, max_span, scale, splits, s);
    case 2:
      return dispatch<float>(q, k, v, lens, starts, o, lse, part_o, part_lse,
                             batch, q_heads, kv_heads, seq, head_dim,
                             strides, max_span, scale, splits, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* mfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
