// Row softmax and its derivative over a materialized matrix, for NVIDIA
// Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernels of
//   metal_flash_attention_tpu/ops/softmax.py::scaled_softmax
//     (kernel at ops/softmax.py:60, pallas_call :73):
//     o = exp2(x - max x) / sum exp2(x - max x), x = s * scale * log2(e);
//   metal_flash_attention_tpu/ops/softmax.py::derivative_softmax
//     (kernel at ops/softmax.py:115, pallas_call :121):
//     dS = P * (dP - sum P * dP) * scale.
// Both compute in float32 and write the first input's type; x is rounded
// before the max is taken off (no fused multiply-add), as in the JAX
// kernel.
//
// What bounds them: bytes.  A row is read and written once in the
// algorithm (softmax 4 bytes an element in bf16, the derivative 6) for a
// few operations an element, far below the card's 295 FLOP a byte.  The
// TPU kernels took strips of 512 whole rows into VMEM, padded the columns
// to 128 lanes and masked the padding to -inf.  Here one block takes one
// row of any length: a first walk reduces it (the running max and the sum
// of exp2 rescaled to it; the dot of P and dP), a second walk writes the
// result.  The second walk reads the row again, from L2 for the rows in
// flight (an 8,192-column bf16 row is 16 KB).  Loads and stores are 16
// bytes a thread where the row's start and length allow, else one element.
// No padding: the row's length is the loop bound.
//
// Every entry point returns cudaGetLastError() after its launch.

#include <type_traits>

#include "attention_common.cuh"

namespace {

using namespace mfa;

constexpr int kThreads = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

// 16 bytes of T as kN floats, and back.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  __device__ static void load(const T* p, float* f) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int i = 0; i < kN; ++i) f[i] = to_float(e[i]);
  }
  __device__ static void store(T* p, const float* f) {
    uint4 v;
    T* e = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int i = 0; i < kN; ++i) e[i] = from_float<T>(f[i]);
    *reinterpret_cast<uint4*>(p) = v;
  }
};

// The running (max, sum of exp2(x - max)) of one stream of x, merged with
// another's.  A max of -inf (nothing but -inf seen) keeps a sum of 0.
__device__ __forceinline__ void merge(float& m, float& l, float m2,
                                      float l2) {
  const float mx = fmaxf(m, m2);
  l = mx == -INFINITY ? 0.f : l * exp2f(m - mx) + l2 * exp2f(m2 - mx);
  m = mx;
}

__device__ __forceinline__ void push(float& m, float& l, float x) {
  if (x > m) {
    l = l * exp2f(m - x) + 1.f;
    m = x;
  } else if (m != -INFINITY) {
    l += exp2f(x - m);
  }
}

// Every thread's (m, l) merged over the block; every thread gets the
// result.
__device__ __forceinline__ void block_merge(float& m, float& l) {
  __shared__ float ms[kThreads / 32], ls[kThreads / 32];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1)
    merge(m, l, __shfl_xor_sync(kFull, m, s), __shfl_xor_sync(kFull, l, s));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    ms[warp] = m;
    ls[warp] = l;
  }
  __syncthreads();
  m = ms[0];
  l = ls[0];
  for (int w = 1; w < kThreads / 32; ++w) merge(m, l, ms[w], ls[w]);
}

__device__ __forceinline__ float block_sum(float x) {
  __shared__ float part[kThreads / 32];
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) x += __shfl_xor_sync(kFull, x, s);
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = x;
  __syncthreads();
  float total = 0.f;
  for (int w = 0; w < kThreads / 32; ++w) total += part[w];
  return total;
}

// One block a row.  `vec`: the rows of s and o start 16-byte aligned and
// cols is a multiple of Vec<T>::kN.
template <typename T>
__global__ void __launch_bounds__(kThreads)
scaled_softmax_kernel(const T* s, T* o, long long s_row, long long o_row,
                      int cols, float scale_log2e, bool vec) {
  using V = Vec<T>;
  const T* x = s + blockIdx.x * s_row;
  T* y = o + blockIdx.x * o_row;
  float m = -INFINITY, l = 0.f;
  if (vec) {
    for (int c = threadIdx.x * V::kN; c < cols; c += kThreads * V::kN) {
      float f[V::kN];
      V::load(x + c, f);
#pragma unroll
      for (int i = 0; i < V::kN; ++i)
        push(m, l, __fmul_rn(f[i], scale_log2e));
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += kThreads)
      push(m, l, __fmul_rn(to_float(x[c]), scale_log2e));
  }
  block_merge(m, l);
  if (vec) {
    for (int c = threadIdx.x * V::kN; c < cols; c += kThreads * V::kN) {
      float f[V::kN];
      V::load(x + c, f);
#pragma unroll
      for (int i = 0; i < V::kN; ++i)
        f[i] = exp2f(__fmul_rn(f[i], scale_log2e) - m) / l;
      V::store(y + c, f);
    }
  } else {
    for (int c = threadIdx.x; c < cols; c += kThreads)
      y[c] = from_float<T>(
          exp2f(__fmul_rn(to_float(x[c]), scale_log2e) - m) / l);
  }
}

// One block a row; out takes P's type.  `vec` as above, and only where P
// and dP share a type.
template <typename TP, typename TD>
__global__ void __launch_bounds__(kThreads)
derivative_softmax_kernel(const TP* p, const TD* dp, TP* o, long long p_row,
                          long long dp_row, long long o_row, int cols,
                          float scale, bool vec) {
  const TP* pr = p + blockIdx.x * p_row;
  const TD* dr = dp + blockIdx.x * dp_row;
  TP* y = o + blockIdx.x * o_row;
  float d = 0.f;
  if constexpr (std::is_same_v<TP, TD>) {
    using V = Vec<TP>;
    if (vec) {
      for (int c = threadIdx.x * V::kN; c < cols; c += kThreads * V::kN) {
        float a[V::kN], b[V::kN];
        V::load(pr + c, a);
        V::load(dr + c, b);
#pragma unroll
        for (int i = 0; i < V::kN; ++i) d += a[i] * b[i];
      }
      d = block_sum(d);
      for (int c = threadIdx.x * V::kN; c < cols; c += kThreads * V::kN) {
        float a[V::kN], b[V::kN];
        V::load(pr + c, a);
        V::load(dr + c, b);
#pragma unroll
        for (int i = 0; i < V::kN; ++i) a[i] = a[i] * (b[i] - d) * scale;
        V::store(y + c, a);
      }
      return;
    }
  }
  for (int c = threadIdx.x; c < cols; c += kThreads)
    d += to_float(pr[c]) * to_float(dr[c]);
  d = block_sum(d);
  for (int c = threadIdx.x; c < cols; c += kThreads)
    y[c] = from_float<TP>(to_float(pr[c]) * (to_float(dr[c]) - d) * scale);
}

// dtype: 0 bf16, 1 fp16, 2 fp32.
template <typename F>
int with_type(int dtype, F&& f) {
  switch (dtype) {
    case 0: return f(__nv_bfloat16{});
    case 1: return f(__half{});
    case 2: return f(float{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// s, o: [rows, cols] at row strides s_row, o_row (elements), last axis
// contiguous; o of s's type.  vec: 16-byte loads are allowed.
int mfa_scaled_softmax(const void* s, void* o, long long s_row,
                       long long o_row, int rows, int cols,
                       float scale_log2e, int vec, int dtype, void* stream) {
  if (rows == 0 || cols == 0) return 0;
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(dtype, [&](auto t) {
    using T = decltype(t);
    scaled_softmax_kernel<T><<<rows, kThreads, 0, st>>>(
        static_cast<const T*>(s), static_cast<T*>(o), s_row, o_row, cols,
        scale_log2e, vec != 0);
    return (int)cudaGetLastError();
  });
}

// p, dp, o: [rows, cols] at their row strides, last axis contiguous; o
// of p's type.  vec: 16-byte loads are allowed (p and dp of one type).
int mfa_derivative_softmax(const void* p, const void* dp, void* o,
                           long long p_row, long long dp_row,
                           long long o_row, int rows, int cols, float scale,
                           int vec, int p_dtype, int dp_dtype,
                           void* stream) {
  if (rows == 0 || cols == 0) return 0;
  if (rows < 0 || cols < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_type(p_dtype, [&](auto tp) {
    return with_type(dp_dtype, [&](auto td) {
      using TP = decltype(tp);
      using TD = decltype(td);
      derivative_softmax_kernel<TP, TD><<<rows, kThreads, 0, st>>>(
          static_cast<const TP*>(p), static_cast<const TD*>(dp),
          static_cast<TP*>(o), p_row, dp_row, o_row, cols, scale, vec != 0);
      return (int)cudaGetLastError();
    });
  });
}

const char* mfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
