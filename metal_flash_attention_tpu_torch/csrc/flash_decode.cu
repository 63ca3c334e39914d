// Dense decode attention for NVIDIA Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel built by
//   metal_flash_attention_tpu/ops/flash_decode.py::_make_decode_kernel
// (pallas_call at ops/flash_decode.py:590), for K/V in the queries' type
// and quantized (below): one query token per sequence against a dense
// cache [batch, kv_heads, S, D]; the GQA group of a kv head are the rows
// of one block; row b attends the
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
// Quantized K/V (the TPU kernel's `kv_precision`, a `QuantizedTensor`):
// INT8 / FP8-E4M3 / FP8-E5M2 payloads [batch, kv_heads, S, D] of one byte
// a value, or NF4 [batch, kv_heads, S, D / 2] (byte j of a row holds
// elements j and j + D/2), with one float32 scale per (sequence, kv head)
// for K and for V; bf16 queries.  A tile lands in the ring in its storage
// type and is decoded in shared memory (decode_common.cuh); the K scale
// folds into the softmax scale and the V scale into the output.  The TPU
// package decodes NF4 at some head dims through its prefill kernel, a lane
// rule of the TPU; here every precision runs in this kernel at D 32, 64
// and 128.
//
// Gemma-2 (the TPU kernel's `logit_softcap` and head_dim 256): softcap > 0
// soft-caps every scaled logit before the mask (`softcap` in
// attention_common.cuh), in kernels instantiated with the cap (kCap), so
// the uncapped ones are unchanged; bf16, fp16 and fp32 at D 32, 64 and 128,
// bf16 and fp16 at D 256 (Q's fragments from shared memory there), K/V
// in the queries' type.  A quantized cache takes no cap.
//
// K and V are addressed through their batch, head and sequence strides
// (in elements of their storage: bytes for a quantized cache), so a slice
// of a cache along the sequence axis needs no copy; only the last axis
// must be contiguous.
//
// Head dim 32 (the tiny configs' heads) is a real D = 32 instantiation of
// the core, for every type, the cap and every quantized precision: the
// cache stays [.., max_seq, 32] in memory (padding it would double the
// bytes this bytes-bound kernel reads).  fp32 at D 32 gives each lane one
// column of PV; an NF4 tile's 64 pieces take one guarded pass of the
// block's 128 threads.
//
// Every entry point returns cudaGetLastError() after its launches.

#include "decode_common.cuh"

namespace {

using namespace mfa;

// The interface's pointers and sizes, untyped.
struct Args {
  const void *q, *k, *v, *k_scales, *v_scales, *lens, *starts;
  void *o, *lse, *part_o, *part_lse;
  int batch, q_heads, kv_heads, seq, head_dim, max_span, splits, chunk;
  const long long* strides;
  float scale, softcap;
};

template <typename T, int D, class KV, int P>
int launch_capped(const DecodeIO<T>& io, const KV& kv, int batch,
                  bool capped, cudaStream_t stream) {
  return capped ? launch_decode<T, D, KV, P, true>(io, kv, batch, 0, stream)
                : launch_decode<T, D, KV, P>(io, kv, batch, 0, stream);
}

// T: the queries' (and o's) type; S: K/V's storage (T, or the bytes of a
// quantized cache of precision P).
template <typename T, typename S = T, int P = kUnquantized>
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
  io.cap2 = a.softcap * kLog2e;
  io.inv_cap2 = a.softcap > 0.f ? 1.f / io.cap2 : 0.f;
  DenseKV<S> kv;
  kv.k = static_cast<const S*>(a.k);
  kv.v = static_cast<const S*>(a.v);
  kv.k_scales = static_cast<const float*>(a.k_scales);
  kv.v_scales = static_cast<const float*>(a.v_scales);
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
  const bool capped = a.softcap > 0.f;
  if constexpr (P != kUnquantized) {
    if (capped) return (int)cudaErrorInvalidValue;
    if (a.head_dim == 32)
      return launch_decode<T, 32, DenseKV<S>, P>(io, kv, a.batch, 0, stream);
    if (a.head_dim == 64)
      return launch_decode<T, 64, DenseKV<S>, P>(io, kv, a.batch, 0, stream);
    if (a.head_dim == 128)
      return launch_decode<T, 128, DenseKV<S>, P>(io, kv, a.batch, 0,
                                                  stream);
  } else {
    if (a.head_dim == 32)
      return launch_capped<T, 32, DenseKV<S>, P>(io, kv, a.batch, capped,
                                                 stream);
    if (a.head_dim == 64)
      return launch_capped<T, 64, DenseKV<S>, P>(io, kv, a.batch, capped,
                                                 stream);
    if (a.head_dim == 128)
      return launch_capped<T, 128, DenseKV<S>, P>(io, kv, a.batch, capped,
                                                  stream);
    if constexpr (!std::is_same<T, float>::value) {
      if (a.head_dim == 256)
        return launch_capped<T, 256, DenseKV<S>, P>(io, kv, a.batch, capped,
                                                    stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 bf16, 1 fp16, 2 fp32 (q and o; K and V too unless quantized).
// head_dim: 32, 64 or 128, and 256 for bf16 and fp16 over K/V in that type.
// softcap > 0: soft-cap the scaled logits (not over a quantized cache);
// 0: none.
// kv_precision: 0 for K and V in q's dtype, else the Precision of their
// payload (quant_common.cuh: kPrecInt8, kPrecE4M3, kPrecE5M2, kPrecNf4;
// dtype 0), with k_scales and v_scales [batch, kv_heads] float32 (null
// otherwise).  strides: the batch, head and sequence strides of K, then of
// V, in elements of their storage.  Each of
// the `splits` blocks of a (sequence, kv head) takes `chunk` keys (a
// multiple of MFA_DECODE_BLOCK_KV) from the row's first live tile; part_o
// [batch, kv_heads, splits, group, D] and part_lse [..., group] float32
// hold their partials (unused when splits is 1), which `merge_splits`
// merges.
int mfa_flash_decode(const void* q, const void* k, const void* v,
                     const void* k_scales, const void* v_scales,
                     const void* lens, const void* starts, void* o,
                     void* lse, void* part_o, void* part_lse, int batch,
                     int q_heads, int kv_heads, int seq, int head_dim,
                     const long long* strides, int max_span, float scale,
                     float softcap, int splits, int chunk, int dtype,
                     int kv_precision, void* stream) {
  if (batch == 0) return 0;
  if (kv_heads <= 0 || q_heads % kv_heads ||
      q_heads / kv_heads > kDecodeMaxGroup || splits < 1 || chunk <= 0 ||
      chunk % kDecodeTile ||
      (kv_precision != 0 && (dtype != 0 || !k_scales || !v_scales)) ||
      softcap < 0.f)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, k_scales, v_scales, lens, starts, o, lse, part_o,
               part_lse, batch, q_heads, kv_heads, seq, head_dim, max_span,
               splits, chunk, strides, scale, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  switch (kv_precision) {
    case 0: break;
    case kPrecInt8: return dispatch<bf16, uint8_t, kPrecInt8>(a, s);
    case kPrecE4M3: return dispatch<bf16, uint8_t, kPrecE4M3>(a, s);
    case kPrecE5M2: return dispatch<bf16, uint8_t, kPrecE5M2>(a, s);
    case kPrecNf4: return dispatch<bf16, uint8_t, kPrecNf4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
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
