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
// What bounds it: HBM bytes (every live K and V row read once, about 4
// FLOP a byte at group 4).  The TPU grid walked the key blocks of one
// (sequence, kv head) in order on one core, padded the group to 8
// sublanes and D to 128 lanes, clamped dead steps through its index map
// and, with max_span, shortened its sequential grid.  None of that
// applies here.  The kernel is `flash_decode90_kernel` of
// decode_common.cuh with the dense address policy: blocks (chunk, kv head,
// sequence) each take a fixed chunk of keys from the row's first live
// tile through a cp.async ring, bf16 and fp16 on tensor cores, fp32 in
// true fp32 on CUDA cores; `merge_splits` merges the chunks' partials.
//
// K and V are addressed through their batch, head and sequence strides
// (in elements), so a slice of a cache along the sequence axis needs no
// copy; only the last axis must be contiguous.
//
// Every entry point returns cudaGetLastError() after its launches.

#include "decode_common.cuh"

namespace {

using namespace mfa;

// The interface's pointers and sizes, untyped.
struct Args {
  const void *q, *k, *v, *lens, *starts;
  void *o, *lse, *part_o, *part_lse;
  int batch, q_heads, kv_heads, seq, head_dim, max_span, splits, chunk;
  const long long* strides;
  float scale;
};

template <typename T>
int dispatch(const Args& a, cudaStream_t stream) {
  DecodeIO<T> io;
  io.q = static_cast<const T*>(a.q);
  io.o = static_cast<T*>(a.o);
  io.lse = static_cast<float*>(a.lse);
  io.part_o = static_cast<float*>(a.part_o);
  io.part_lse = static_cast<float*>(a.part_lse);
  io.q_heads = a.q_heads;
  io.kv_heads = a.kv_heads;
  io.chunk = a.chunk;
  io.splits = a.splits;
  io.scale_log2e = a.scale * kLog2e;
  DenseKV<T> kv;
  kv.k = static_cast<const T*>(a.k);
  kv.v = static_cast<const T*>(a.v);
  kv.lens = static_cast<const int*>(a.lens);
  kv.starts = static_cast<const int*>(a.starts);
  kv.k_sb = a.strides[0];
  kv.k_sh = a.strides[1];
  kv.k_ss = a.strides[2];
  kv.v_sb = a.strides[3];
  kv.v_sh = a.strides[4];
  kv.v_ss = a.strides[5];
  kv.seq = a.seq;
  kv.max_span = a.max_span;
  if (a.head_dim == 64)
    return launch_decode<T, 64>(io, kv, a.batch, 0, stream);
  if (a.head_dim == 128)
    return launch_decode<T, 128>(io, kv, a.batch, 0, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 bf16, 1 fp16, 2 fp32 (q, K, V and o alike).  strides: the
// batch, head and sequence strides of K, then of V, in elements.  Each of
// the `splits` blocks of a (sequence, kv head) takes `chunk` keys (a
// multiple of MFA_DECODE_BLOCK_KV) from the row's first live tile; part_o
// [batch, kv_heads, splits, group, D] and part_lse [..., group] float32
// hold their partials (unused when splits is 1), which `merge_splits`
// merges.
int mfa_flash_decode(const void* q, const void* k, const void* v,
                     const void* lens, const void* starts, void* o,
                     void* lse, void* part_o, void* part_lse, int batch,
                     int q_heads, int kv_heads, int seq, int head_dim,
                     const long long* strides, int max_span, float scale,
                     int splits, int chunk, int dtype, void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads ||
      q_heads / kv_heads > kDecodeMaxGroup || splits < 1 || chunk <= 0 ||
      chunk % kDecodeTile)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, lens, starts, o, lse, part_o, part_lse,
               batch, q_heads, kv_heads, seq, head_dim, max_span,
               splits, chunk, strides, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<__nv_bfloat16>(a, s);
    case 1: return dispatch<__half>(a, s);
    case 2: return dispatch<float>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* mfa_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
