// Dequantization helpers shared by the port's kernels (sm_90a): INT8, IEEE
// FP8 (E4M3, E5M2) and NF4 payloads to float, and 16 stored bytes at a
// time to bf16 (the attention kernels' tile decoders), without the scale
// (each kernel applies the scale where it commutes: the GEMM on its
// output, attention on the scores and on O).
//
// They replace the TPU vector-unit code of
//   metal_flash_attention_tpu/ops/quantization.py
// (fp8_expand_bits, dequant_block, nf4_codebook_lookup, nf4_unpack_groups):
// there FP8 was expanded by integer shifts into the float32 bit fields
// because the v5e has no FP8 datapath, and FP8 subnormals flushed to zero
// in the scale multiply.  Here the conversions are cuda_fp8.h's, exact for
// every finite FP8 value, subnormals included (as the JAX package computes
// on the CPU).
//
// NF4 GEMM layout: logical contraction element k lies in group g = k / 512
// at j = k % 512, in byte g * 256 + j % 256 of the packed axis, in the low
// nibble when j < 256 and the high nibble otherwise.

#pragma once

#include <cuda_fp8.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "attention_common.cuh"

namespace mfa {

// Operand memory precisions at the C interface (ops/gemm.py's table).
enum Precision : int {
  kPrecFp32 = 0,
  kPrecBf16 = 1,
  kPrecInt8 = 2,
  kPrecE4M3 = 3,
  kPrecE5M2 = 4,
  kPrecNf4 = 5,
};

constexpr int kNf4Group = 512;

// The storage precision of K/V tiles that are in the queries' own type.
constexpr int kUnquantized = -1;

// The NF4 codebook as float32 (ops/quantization.py NF4_CODEBOOK).
__device__ __constant__ float kNf4Codebook[16] = {
    -1.0f, -0.6961928009986877f, -0.5250730514526367f,
    -0.39491748809814453f, -0.28444138169288635f, -0.18477343022823334f,
    -0.09105003625154495f, 0.0f, 0.07958029955625534f,
    0.16093020141124725f, 0.24611230194568634f, 0.33791524171829224f,
    0.44070982933044434f, 0.5626170039176941f, 0.7229568362236023f, 1.0f};

__device__ __forceinline__ float int8_to_float(int8_t v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float fp8_e4m3_to_float(uint8_t bits) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(bits, __NV_E4M3)));
}

__device__ __forceinline__ float fp8_e5m2_to_float(uint8_t bits) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(bits, __NV_E5M2)));
}

// Where logical contraction element k of a group-packed NF4 operand lies:
// its byte along the packed axis, and the shift of its nibble.
struct Nf4Position {
  int byte;
  int shift;
};

__device__ __forceinline__ Nf4Position nf4_position(int k) {
  const int g = k / kNf4Group, j = k % kNf4Group;
  return {g * (kNf4Group / 2) + j % (kNf4Group / 2),
          j >= kNf4Group / 2 ? 4 : 0};
}

// The codebook value of the nibble at `shift` of `byte`; `table` is the
// codebook (in shared memory where the index varies across a warp).
__device__ __forceinline__ float nf4_value(uint8_t byte, int shift,
                                           const float* table) {
  return table[(byte >> shift) & 0x0F];
}

// The NF4 byte table: entry b holds the codebook values of b's low and
// high nibbles as bf16, low | high << 16.  Threads `thread` of `threads`
// fill their share.
__device__ __forceinline__ void fill_nf4_pairs(uint32_t* table, int thread,
                                               int threads) {
  for (int i = thread; i < 256; i += threads)
    table[i] = pack2<__nv_bfloat16>(kNf4Codebook[i & 15],
                                    kNf4Codebook[i >> 4]);
}

// 16 stored values of a 1-byte format as 16 bf16 (exact: every INT8 and
// finite FP8 value is a bf16).  INT8 x becomes the float 2^23 + (x + 128)
// by a byte permute (its biased byte as the low mantissa byte), less
// 2^23 + 128: two full-rate operations, where an integer-to-float
// conversion runs at a quarter of the rate and made INT8 tiles slower to
// decode than FP8's.
template <int P>
__device__ __forceinline__ void bytes_to_bf16(const uint4& x,
                                              uint4 (&out)[2]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t r[8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t two = (w[i] >> (16 * h)) & 0xffffu;
      float a, b;
      if constexpr (P == kPrecInt8) {
        const uint32_t biased = w[i] ^ 0x80808080u;
        a = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                        0x7650u + 2 * h)) - 8388736.f;
        b = __uint_as_float(__byte_perm(biased, 0x4B000000u,
                                        0x7651u + 2 * h)) - 8388736.f;
      } else {
        const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
            (__nv_fp8x2_storage_t)two, P == kPrecE4M3 ? __NV_E4M3 : __NV_E5M2);
        const float2 f = __half22float2(__half2(hr));
        a = f.x;
        b = f.y;
      }
      r[2 * i + h] = pack2<__nv_bfloat16>(a, b);
    }
  out[0] = make_uint4(r[0], r[1], r[2], r[3]);
  out[1] = make_uint4(r[4], r[5], r[6], r[7]);
}

// 16 NF4 bytes as the 16 low-nibble values (lo) and the 16 high-nibble
// values (hi), bf16.
__device__ __forceinline__ void nf4_to_bf16(const uint4& x,
                                            const uint32_t* table,
                                            uint4 (&lo)[2], uint4 (&hi)[2]) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
  uint32_t l[8], h[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t p[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) p[k] = table[(w[i] >> (8 * k)) & 0xffu];
    l[2 * i] = __byte_perm(p[0], p[1], 0x5410);
    l[2 * i + 1] = __byte_perm(p[2], p[3], 0x5410);
    h[2 * i] = __byte_perm(p[0], p[1], 0x7632);
    h[2 * i + 1] = __byte_perm(p[2], p[3], 0x7632);
  }
  lo[0] = make_uint4(l[0], l[1], l[2], l[3]);
  lo[1] = make_uint4(l[4], l[5], l[6], l[7]);
  hi[0] = make_uint4(h[0], h[1], h[2], h[3]);
  hi[1] = make_uint4(h[4], h[5], h[6], h[7]);
}

}  // namespace mfa
