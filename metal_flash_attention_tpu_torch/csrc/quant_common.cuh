// Dequantization helpers shared by the port's kernels (sm_90a): INT8, IEEE
// FP8 (E4M3, E5M2) and NF4 payloads to float, without the scale (each
// kernel applies the scale where it commutes: the GEMM on its output).
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

}  // namespace mfa
