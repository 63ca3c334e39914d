// GEMM with in-kernel dequantization for NVIDIA Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the TPU kernel built by
//   metal_flash_attention_tpu/ops/gemm.py::_make_gemm_kernel
// (pallas_call at ops/gemm.py:372): out = op(A) op(B) [+ C] over a leading
// batch, where each operand is float32, bf16 or a quantized payload (INT8,
// FP8-E4M3, FP8-E5M2, NF4) dequantized on its way into shared memory, and
// the scales and, for quantized operands, C are applied to the float32
// result: out = ((acc * scale_a[m]) * scale_b[n]) + C, then the cast.  For
// dense operands C seeds the accumulator instead.
//
// Registers are bf16 or float32 (ops/gemm.py's truth table).  bf16
// registers: each element is dequantized, rounded to bf16 (INT8 and FP8
// exactly; the NF4 codebook as the JAX package rounds it) and multiplied
// on the tensor cores with float32 accumulators.  float32 registers: fp32
// FMA on CUDA cores, true fp32 as the JAX package's Precision.HIGHEST.
//
// What bounds it: operations at a large M (a prefill: 9.6e11 FLOP per
// Llama-3-8B MLP product at 8,192 tokens), the weight's bytes at a small M
// (a decode batch of 8 reads a 4096 x 14336 weight for 0.9 GFLOP).  When
// the output tiles cannot fill the card (a decode batch), K is split over
// blocks, which write float32 partials that a second kernel sums in split
// order before the epilogue.
//
// Two routes, chosen by ops/gemm.py `_route` from the operands' types and
// layouts before the launch:
// - sm90 (`mfa_gemm_sm90`, `gemm90_kernel`): bf16 registers, A dense bf16
//   with K contiguous, B bf16 or quantized as [K, N] with N contiguous,
//   every base and non-unit stride a 16-byte multiple (what TMA can
//   describe).  Every call of the quantized MLP and the dense bf16 product
//   takes it: a TMA ring, B decoded in shared memory, wgmma from shared
//   memory (the section "The sm90 route" below).  Three fetch classes of
//   B (bf16, the byte formats, NF4) over three tile shapes: 6 kernels.
// - mma (`mfa_gemm`, `gemm_kernel`): everything else, that is fp32
//   registers, a quantized A, quantized x quantized, and strides TMA
//   cannot describe.  A 128 x 128 output tile per block of 8 warps, a
//   32-deep K step staged in shared memory, the next step's raw 16-byte
//   chunks fetched into registers while mma.sync m16n8k16 works on this
//   one, and dequantized when they are stored to shared memory.
//
// The TPU kernel padded every operand on the host to whole blocks, took
// transposes through dot_general's dimension numbers and read NF4 one
// whole 512-group a block.  Here each operand is read in place through its
// batch, row and contraction strides (in payload elements), so ragged M, N
// and K need no copy: elements outside the problem are zero (on the mma
// route all four transpose layouts too).  A K step (32 or 64 deep) lies
// inside one 256-element half of an NF4 group, so it reads one nibble
// plane (quant_common.cuh has the layout).  The mma kernel is a template
// on the register type and on each operand's fetch class (float32, bf16,
// the three byte formats, NF4): 32 kernels, so that each holds only its
// own operands' chunks in flight.  Within the byte class the precision is
// an argument.
//
// Every entry point returns cudaGetLastError() after its launches.

#include "attention_common.cuh"
#include "flash_tiles.cuh"
#include "hopper_common.cuh"
#include "quant_common.cuh"

namespace {

using namespace mfa;

constexpr int kBM = MFA_GEMM_BLOCK_M;
constexpr int kBN = MFA_GEMM_BLOCK_N;
constexpr int kBK = MFA_GEMM_BLOCK_K;
constexpr int kThreads = 256;
constexpr int kRows = kBM;                     // operand tile rows (m or n)
constexpr int kPer = kRows * kBK / kThreads;   // elements a thread fetches
constexpr int kStrideH = kBK + 8;              // bf16 [row][k] tile: 80 B
constexpr int kStrideR = kRows + 8;            // bf16 [k][row] tile: 272 B
constexpr int kStrideF = kRows + 4;            // fp32 [k][row] tile
static_assert(kBM == kBN, "one fetch shape for both operands");
static_assert(kRows * kBK % kThreads == 0, "whole fetches");
static_assert((kNf4Group / 2) % kBK == 0, "a K step reads one nibble plane");
static_assert(kBM == 128 && kBN == 128 && kBK % 16 == 0,
              "the warp layouts below assume a 128 x 128 tile");

enum OutType { kOutFp32 = 0, kOutBf16 = 1, kOutFp16 = 2 };
enum CMode { kCNone = 0, kCSeed = 1, kCAfterScale = 2 };

struct Params {
  const void* a;          // A payload: element (b, m, k) at the strides
  const void* b;          // B payload: element (b, k, n)
  const float* c;         // [batch or 1, M, N] float32, rows contiguous
  const float* scale_a;   // null, [batch] or [batch, M]
  const float* scale_b;   // null, [batch] or [batch, N]
  void* out;              // [batch, M, N] contiguous, out_type
  float* partial;         // [splits, batch, M, N] when splits > 1
  long long a_sb, a_sm, a_sk, b_sb, b_sk, b_sn, c_sb, sa_b, sa_m, sb_b, sb_n;
  int m, n, k, batch, splits, k_per_split;
  int prec_a, prec_b, out_type, c_mode;
  int box_m;              // sm90: rows of A one TMA load brings
  bool vec_a, vec_b;      // 16-byte loads allowed (contiguous, aligned)
};

// Fetch classes: how an operand's payload is addressed.  The byte
// formats (INT8, FP8-E4M3, FP8-E5M2) share one; NF4 maps k to its byte.
enum FetchClass { kF32 = 0, kB16 = 1, kByte = 2, kNf4 = 3 };

__host__ __device__ constexpr int class_bytes(int f) {
  return f == kF32 ? 4 : f == kB16 ? 2 : 1;
}
// Elements in a 16-byte chunk (NF4: the 16 nibbles of one plane).
__host__ __device__ constexpr int class_elems(int f) {
  return 16 / class_bytes(f);
}

inline int class_of(int prec) {
  return prec == kPrecFp32 ? kF32
         : prec == kPrecBf16 ? kB16
         : prec == kPrecNf4  ? kNf4
                             : kByte;
}

// One operand element's raw bits (an NF4 element's whole byte).  `row` is
// the offset of its non-contracted index (batch and m or n), `sk` the
// contraction stride; an NF4 payload's packed axis is the contraction's.
template <int F>
__device__ __forceinline__ uint32_t element_bits(const void* base,
                                                 long long row, long long sk,
                                                 int k) {
  const long long at = row + (F == kNf4 ? nf4_position(k).byte : k) * sk;
  if constexpr (F == kF32)
    return static_cast<const uint32_t*>(base)[at];
  else if constexpr (F == kB16)
    return static_cast<const uint16_t*>(base)[at];
  else
    return static_cast<const uint8_t*>(base)[at];
}

// The E elements of one 16-byte chunk of precision P, dequantized without
// the scale; NF4 reads the nibble at `shift`.
template <int P>
__device__ __forceinline__ void decode_chunk(const uint4& v, int shift,
                                             const float* nf4, float* out) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (P == kPrecFp32) {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = __uint_as_float(w[i]);
  } else if constexpr (P == kPrecBf16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const uint8_t byte = (w[i / 4] >> (8 * (i % 4))) & 0xFF;
      if constexpr (P == kPrecInt8)
        out[i] = int8_to_float(static_cast<int8_t>(byte));
      else if constexpr (P == kPrecE4M3)
        out[i] = fp8_e4m3_to_float(byte);
      else if constexpr (P == kPrecE5M2)
        out[i] = fp8_e5m2_to_float(byte);
      else
        out[i] = nf4_value(byte, shift, nf4);
    }
  }
}

// Thread `tid`'s chunk c of a kRows x kBK operand tile of E-element
// chunks along the operand's contiguous axis: its first element (rr, kk).
// With k_fast the chunk is E neighbouring k of row rr, else E
// neighbouring rows at kk; neighbouring threads take neighbouring chunks.
template <int E>
__device__ __forceinline__ void chunk_slot(int c, int tid, bool k_fast,
                                           int& rr, int& kk) {
  const int q = tid + c * kThreads;
  if (k_fast) {
    rr = q / (kBK / E);
    kk = q % (kBK / E) * E;
  } else {
    kk = q / (kRows / E);
    rr = q % (kRows / E) * E;
  }
}

// One operand: where it lies and how to walk it.
struct Operand {
  const void* base;
  long long off, s_row, sk;  // batch offset, row and contraction strides
  int row0, rows, prec;
  bool k_fast, vec;          // contiguous along k; 16-byte loads allowed
};

// A thread's raw share of one operand tile, in flight between its fetch
// and its stash: kPer elements as 16-byte chunks.
template <int F>
struct Staged {
  uint4 v[kPer / class_elems(F)];
};

// Fetch this thread's chunks of the tile at k0: one 16-byte load a chunk
// where the chunk lies whole inside the problem (and the operand allows
// it), element by element at the ragged edges, where an element outside
// is zero (NF4: the code of 0.0, 7).
template <int F>
__device__ __forceinline__ void fetch_tile(Staged<F>& st, const Operand& o,
                                           int k0, int k_end, int tid) {
  constexpr int E = class_elems(F), B = class_bytes(F);
#pragma unroll
  for (int c = 0; c < kPer / E; ++c) {
    int rr, kk;
    chunk_slot<E>(c, tid, o.k_fast, rr, kk);
    const int row = o.row0 + rr, k = k0 + kk;
    const bool whole = o.k_fast ? (row < o.rows && k + E <= k_end)
                                : (k < k_end && row + E <= o.rows);
    if (o.vec && whole) {
      const long long at =
          o.off + row * o.s_row +
          (F == kNf4 ? nf4_position(k).byte : k) * o.sk;
      st.v[c] = __ldg(reinterpret_cast<const uint4*>(
          static_cast<const char*>(o.base) + at * B));
    } else {
      const uint32_t fill = F == kNf4 ? 0x77777777u : 0u;
      uint32_t w[4] = {fill, fill, fill, fill};
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const int re = o.k_fast ? row : row + e;
        const int ke = o.k_fast ? k + e : k;
        if (re < o.rows && ke < k_end) {
          const uint32_t bits =
              element_bits<F>(o.base, o.off + re * o.s_row, o.sk, ke);
          const int bit = (e * B * 8) % 32;
          const uint32_t mask =
              B == 4 ? 0xFFFFFFFFu : (1u << (B * 8 % 32)) - 1;
          w[e * B / 4] = (w[e * B / 4] & ~(mask << bit)) | (bits << bit);
        }
      }
      st.v[c] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// One chunk's E elements as floats: the class's precisions.
template <int F>
__device__ __forceinline__ void decode(const uint4& v, int prec, int shift,
                                       const float* nf4, float* out) {
  if constexpr (F == kF32)
    decode_chunk<kPrecFp32>(v, shift, nf4, out);
  else if constexpr (F == kB16)
    decode_chunk<kPrecBf16>(v, shift, nf4, out);
  else if constexpr (F == kNf4)
    decode_chunk<kPrecNf4>(v, shift, nf4, out);
  else if (prec == kPrecInt8)
    decode_chunk<kPrecInt8>(v, shift, nf4, out);
  else if (prec == kPrecE4M3)
    decode_chunk<kPrecE4M3>(v, shift, nf4, out);
  else
    decode_chunk<kPrecE5M2>(v, shift, nf4, out);
}

// The staged chunks, decoded, into shared memory in the register type.
// bf16 tiles keep the operand's contiguous axis: [row][k] (stride
// kStrideH) when it is k, [k][row] (stride kStrideR) otherwise, so a
// chunk lands in neighbouring halves and goes in 8- or 16-byte stores.
// fp32 tiles are [k][row] (stride kStrideF).  `shift`: the NF4 plane of
// this K step.
template <typename Reg, int F>
__device__ __forceinline__ void stash(void* tile, const Staged<F>& st,
                                      const Operand& o, int shift,
                                      const float* nf4, int tid) {
  constexpr int E = class_elems(F);
#pragma unroll
  for (int c = 0; c < kPer / E; ++c) {
    int rr, kk;
    chunk_slot<E>(c, tid, o.k_fast, rr, kk);
    float in[E];
    decode<F>(st.v[c], o.prec, shift, nf4, in);
    if constexpr (sizeof(Reg) == 2) {
      uint32_t h[E / 2];
#pragma unroll
      for (int i = 0; i < E / 2; ++i) h[i] = pack2(in[2 * i], in[2 * i + 1]);
      uint16_t* dst = static_cast<uint16_t*>(tile) +
                      (o.k_fast ? rr * kStrideH + kk : kk * kStrideR + rr);
      if constexpr (E == 4) {
        *reinterpret_cast<uint2*>(dst) = make_uint2(h[0], h[1]);
      } else {
#pragma unroll
        for (int i = 0; i < E / 8; ++i)
          reinterpret_cast<uint4*>(dst)[i] =
              make_uint4(h[4 * i], h[4 * i + 1], h[4 * i + 2], h[4 * i + 3]);
      }
    } else {
      float* t = static_cast<float*>(tile);
      if (o.k_fast) {
#pragma unroll
        for (int e = 0; e < E; ++e) t[(kk + e) * kStrideF + rr] = in[e];
      } else {
#pragma unroll
        for (int i = 0; i < E / 4; ++i)
          reinterpret_cast<float4*>(t + kk * kStrideF + rr)[i] = make_float4(
              in[4 * i], in[4 * i + 1], in[4 * i + 2], in[4 * i + 3]);
      }
    }
  }
}

// A bf16 fragment register: elements (row, k) and (row, k + 1) of a tile
// in either layout.
__device__ __forceinline__ uint32_t frag_pair(const uint16_t* tile,
                                              bool k_fast, int row, int k) {
  return k_fast ? cols_pair(tile, kStrideH, row, k)
                : rows_pair(tile, kStrideR, k, row);
}

__device__ __forceinline__ size_t out_index(const Params& p, int bt, int row,
                                            int col) {
  return ((size_t)bt * p.m + row) * p.n + col;
}

__device__ __forceinline__ float c_at(const Params& p, int bt, int row,
                                      int col) {
  return p.c[bt * p.c_sb + (size_t)row * p.n + col];
}

// The epilogue's arithmetic on one finished sum: scales, then C
// (quantized operands).
__device__ __forceinline__ float epilogue_value(const Params& p, int bt,
                                                int row, int col, float v) {
  if (p.scale_a) v *= p.scale_a[bt * p.sa_b + row * p.sa_m];
  if (p.scale_b) v *= p.scale_b[bt * p.sb_b + col * p.sb_n];
  if (p.c_mode == kCAfterScale) v += c_at(p, bt, row, col);
  return v;
}

// The epilogue of one finished sum: scales, C (quantized operands), cast.
__device__ __forceinline__ void store_result(const Params& p, int bt, int row,
                                             int col, float v) {
  v = epilogue_value(p, bt, row, col, v);
  const size_t o = out_index(p, bt, row, col);
  if (p.out_type == kOutFp32)
    static_cast<float*>(p.out)[o] = v;
  else if (p.out_type == kOutBf16)
    static_cast<__nv_bfloat16*>(p.out)[o] = __float2bfloat16_rn(v);
  else
    static_cast<__half*>(p.out)[o] = __float2half_rn(v);
}

// A block's share of one output element: the finished result, or a
// float32 partial when K is split.
__device__ __forceinline__ void emit(const Params& p, int bt, int split,
                                     int row, int col, float acc) {
  if (row >= p.m || col >= p.n) return;
  if (p.splits > 1)
    p.partial[((size_t)split * p.batch + bt) * p.m * p.n +
              (size_t)row * p.n + col] = acc;
  else
    store_result(p, bt, row, col, acc);
}

__device__ __forceinline__ float seed(const Params& p, int bt, int row,
                                      int col) {
  return (p.c_mode == kCSeed && p.splits == 1 && row < p.m && col < p.n)
             ? c_at(p, bt, row, col)
             : 0.f;
}

// `emit` of eight neighbouring columns from `col` (a multiple of 8), C
// seeding the sum first where it does: one or two 16-byte stores where
// all eight lie inside the row and the row length keeps them aligned,
// else element by element.
__device__ __forceinline__ void emit8(const Params& p, int bt, int split,
                                      int row, int col, float (&v)[8]) {
  if (row >= p.m || col >= p.n) return;
  const bool whole = col + 8 <= p.n;
  if (p.c_mode == kCSeed && p.splits == 1) {
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (col + e < p.n) v[e] += c_at(p, bt, row, col + e);
  }
  if (p.splits > 1 || p.out_type == kOutFp32) {
    float* dst = p.splits > 1
                     ? p.partial + ((size_t)split * p.batch + bt) * p.m * p.n +
                           (size_t)row * p.n + col
                     : static_cast<float*>(p.out) + out_index(p, bt, row, col);
    if (p.splits == 1) {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < p.n) v[e] = epilogue_value(p, bt, row, col + e, v[e]);
    }
    if (whole && p.n % 4 == 0) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (col + e < p.n) dst[e] = v[e];
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 8; ++e)
    if (col + e < p.n) v[e] = epilogue_value(p, bt, row, col + e, v[e]);
  const size_t o = out_index(p, bt, row, col);
  if (whole && p.n % 8 == 0) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (p.out_type == kOutBf16) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      } else {
        const __half2 h = __floats2half2_rn(v[2 * i], v[2 * i + 1]);
        w[i] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(static_cast<uint16_t*>(p.out) + o) =
        make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      if (col + e >= p.n) break;
      if (p.out_type == kOutBf16)
        static_cast<__nv_bfloat16*>(p.out)[o + e] = __float2bfloat16_rn(v[e]);
      else
        static_cast<__half*>(p.out)[o + e] = __float2half_rn(v[e]);
    }
  }
}

// Grid (N tiles, M tiles, batch x splits), kThreads threads; FA and FB
// are the operands' fetch classes.  A bf16 kernel fits 128 registers, so
// that two blocks share an SM (a few spills, and still faster on an H100
// than one block an SM without them); an fp32 kernel, whose accumulators
// and operand values are all float, keeps one.
template <typename Reg, int FA, int FB>
__global__ void __launch_bounds__(kThreads, sizeof(Reg) == 2 ? 2 : 1)
gemm_kernel(Params p) {
  constexpr bool kHalf = sizeof(Reg) == 2;
  constexpr int kTileBytes =
      kHalf ? kRows * kStrideH * 2 : kBK * kStrideF * 4;
  static_assert(kBK * kStrideR * 2 <= kRows * kStrideH * 2, "tile room");
  __shared__ float nf4[16];
  __shared__ __align__(16) unsigned char a_tile[kTileBytes];
  __shared__ __align__(16) unsigned char b_tile[kTileBytes];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int bt = blockIdx.z / p.splits, split = blockIdx.z % p.splits;
  const int k_begin = split * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  if (tid < 16) nf4[tid] = kNf4Codebook[tid];
  const Operand oa{p.a, bt * p.a_sb, p.a_sm, p.a_sk, m0, p.m, p.prec_a,
                   p.a_sk == 1, p.vec_a};
  const Operand ob{p.b, bt * p.b_sb, p.b_sn, p.b_sk, n0, p.n, p.prec_b,
                   p.b_sk == 1, p.vec_b};

  // bf16: warp w holds rows 32 (w / 2) .. +32 and columns 64 (w % 2) ..
  // +64 as 2 x 8 mma tiles.  fp32: thread (tx, ty) holds rows ty * 4 + i
  // and 64 + ty * 4 + i, columns tx * 4 + j and 64 + tx * 4 + j.
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;
  const int tx = tid % 16, ty = tid / 16;
  constexpr int kMT = kHalf ? 2 : 8, kNT = 8, kE = kHalf ? 4 : 1;
  float acc[kMT][kNT][kE];

  auto row_of = [&](int mt, int e) {
    return kHalf ? m0 + wm + mt * 16 + g + (e >= 2 ? 8 : 0)
                 : m0 + (mt < 4 ? ty * 4 + mt : 64 + ty * 4 + mt - 4);
  };
  auto col_of = [&](int nt, int e) {
    return kHalf ? n0 + wn + nt * 8 + 2 * t4 + (e & 1)
                 : n0 + (nt < 4 ? tx * 4 + nt : 64 + tx * 4 + nt - 4);
  };
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < kE; ++e)
        acc[mt][nt][e] = seed(p, bt, row_of(mt, e), col_of(nt, e));

  Staged<FA> ra;
  Staged<FB> rb;
  __syncthreads();  // the NF4 table
  if (k_begin < k_end) {
    fetch_tile<FA>(ra, oa, k_begin, k_end, tid);
    fetch_tile<FB>(rb, ob, k_begin, k_end, tid);
  }
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int shift = k0 % kNf4Group >= kNf4Group / 2 ? 4 : 0;
    __syncthreads();  // the previous step's tiles are consumed
    stash<Reg, FA>(a_tile, ra, oa, shift, nf4, tid);
    stash<Reg, FB>(b_tile, rb, ob, shift, nf4, tid);
    __syncthreads();
    if (k0 + kBK < k_end) {  // the next step's chunks, in flight
      fetch_tile<FA>(ra, oa, k0 + kBK, k_end, tid);
      fetch_tile<FB>(rb, ob, k0 + kBK, k_end, tid);
    }
    if constexpr (kHalf) {
      const uint16_t* as = reinterpret_cast<const uint16_t*>(a_tile);
      const uint16_t* bs = reinterpret_cast<const uint16_t*>(b_tile);
#pragma unroll
      for (int kb = 0; kb < kBK; kb += 16) {
        uint32_t af[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          const int r0 = wm + mt * 16 + g;
          af[mt][0] = frag_pair(as, oa.k_fast, r0, kb + 2 * t4);
          af[mt][1] = frag_pair(as, oa.k_fast, r0 + 8, kb + 2 * t4);
          af[mt][2] = frag_pair(as, oa.k_fast, r0, kb + 2 * t4 + 8);
          af[mt][3] = frag_pair(as, oa.k_fast, r0 + 8, kb + 2 * t4 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          if (n0 + wn + nt * 8 >= p.n) continue;  // warp-uniform
          const int c0 = wn + nt * 8 + g;
          const uint32_t b0 = frag_pair(bs, ob.k_fast, c0, kb + 2 * t4);
          const uint32_t b1 = frag_pair(bs, ob.k_fast, c0, kb + 2 * t4 + 8);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt)
            if (m0 + wm + mt * 16 < p.m)  // warp-uniform
              mma_16816<__nv_bfloat16>(acc[mt][nt], af[mt], b0, b1);
        }
      }
    } else {
      const float* as = reinterpret_cast<const float*>(a_tile);
      const float* bs = reinterpret_cast<const float*>(b_tile);
#pragma unroll 4
      for (int kk = 0; kk < kBK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(
            as + kk * kStrideF + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(
            as + kk * kStrideF + 64 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(
            bs + kk * kStrideF + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(
            bs + kk * kStrideF + 64 + tx * 4);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j][0] = fmaf(av[i], bv[j], acc[i][j][0]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < kE; ++e)
        emit(p, bt, split, row_of(mt, e), col_of(nt, e), acc[mt][nt][e]);
}

// The splits' partials summed in split order (after C where C seeds the
// sum), then the epilogue.  Grid-stride over batch x M x N.
__global__ void __launch_bounds__(256) gemm_reduce_kernel(Params p) {
  const size_t total = (size_t)p.batch * p.m * p.n;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int col = (int)(i % p.n);
    const size_t rest = i / p.n;
    const int row = (int)(rest % p.m), bt = (int)(rest / p.m);
    float v = p.c_mode == kCSeed ? c_at(p, bt, row, col) : 0.f;
    for (int s = 0; s < p.splits; ++s) v += p.partial[s * total + i];
    store_result(p, bt, row, col, v);
  }
}

// ---- The sm90 route ------------------------------------------------------
//
// One BM x BN output tile a block of three warpgroups (384 threads), in
// one of three shapes (ops/gemm.py picks it, `kernel_config`):
// - 128 x 256 for a bf16 B: two consumer warpgroups of 64 rows;
// - 256 x 128 for a quantized B: two consumer warpgroups of 128 rows
//   (two m64 tiles each), so each decoded element feeds 256 rows;
// - 128 x 128 at a decode batch (M <= MFA_GEMM90_DECODE_M), where
//   narrow tiles give more blocks to stream the weight.
// Warpgroup 0 gives up its registers (setmaxnreg 40) and one of its
// threads issues the TMA loads of each 64-deep K step into a ring of
// stages (as many as shared memory holds, at most MFA_GEMM90_STAGES):
// A [BM rows][64 k] bf16, K-major and swizzled; a bf16 B as [64 k][BN n],
// MN-major, in 64-column panels each swizzled; a quantized B as its raw
// [64 k][BN] bytes (A's box holds only the rows that exist when there is
// one M tile).  A stage's full barrier completes when its bytes have
// landed; its empty barrier when all 8 consumer warps are done with it.
// Warpgroups 1 and 2 (setmaxnreg 232) issue BM / 128 x 4 m64nBNk16
// wgmmas a step, one group in flight.  For a quantized B they decode
// stage i + 1's raw bytes (16 a thread at a time) into one of k9Decoded
// bf16 tiles in the same swizzled panels, zeroing every k >= K (NF4's
// padding lies inside the payload), while the tensor cores run stage i;
// three tiles let a warpgroup overwrite one only after both have
// finished its products.  Tiles are walked in groups of kGroupM M tiles,
// so a wave of blocks shares its A and B tiles in L2.  The epilogue goes
// through shared memory (`emit8`).

constexpr int k9BK = MFA_GEMM90_BLOCK_K;
constexpr int k9Threads = 384;
constexpr int k9Consumers = 256;
constexpr int k9Decoded = 3;
constexpr int kGroupM = 16;
constexpr int k9Panel = k9BK * 64 * 2;      // 64 columns of bf16 B
constexpr int k9SmemBudget = 232448 - 2048; // an H100 block, less slack
static_assert(k9BK == 64, "a K step is one 128-byte swizzled bf16 row");
static_assert((kNf4Group / 2) % k9BK == 0, "a K step reads one plane");

// Shared memory of one block: the ring, the decoded tiles, the barriers,
// the NF4 table, and room to align the whole to 1024 bytes.
template <int FB, int BM, int BN>
struct Ring90 {
  static_assert((BM == 128 || BM == 256) && (BN == 128 || BN == 256) &&
                    BM * BN <= 128 * 256,
                "128 accumulators a consumer thread at most");
  static constexpr int kATile = BM * k9BK * 2;   // bf16, swizzled, K-major
  static constexpr int kBTile = BN * k9BK * 2;   // bf16 B, BN / 64 panels
  static constexpr int kRaw = BN * k9BK;         // a byte-format B stage
  static constexpr int kStage = kATile + (FB == kB16 ? kBTile : kRaw);
  static constexpr int kDecodedBytes = FB == kB16 ? 0 : k9Decoded * kBTile;
  static constexpr int kFit = (k9SmemBudget - kDecodedBytes) / kStage;
  static constexpr int kStages =
      kFit < MFA_GEMM90_STAGES ? kFit : MFA_GEMM90_STAGES;
  static constexpr int kBarriers = kStages * kStage + kDecodedBytes;
  static constexpr int kBytes = kBarriers + 2 * kStages * 8 + 32 + 1024;
  static constexpr int kLd = BN + 8;  // epilogue float rows: no conflicts
  static_assert(kStages >= 3, "a ring");
  static_assert(kBytes <= 232448, "an H100 block's shared memory");
  static_assert(BM * kLd * 4 <= kBarriers,
                "the epilogue's float tile fits in the ring");
  static_assert(kRaw / 16 % k9Consumers == 0, "whole decode chunks");
};

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// The top halves of two floats as one bf16 pair: exact where each value
// has at most 8 significant bits, as a decoded INT8 or FP8 value has.
__device__ __forceinline__ uint32_t bf16_pair_of(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// 16 payload bytes of one K row as 16 bf16 (8 words), without the
// scale, exactly, with no conversion instructions (an H100 SM converts 16
// values a clock, an eighth of its float32 rate):
// - INT8 b: the float with bits 0x4B000000 | (b + 128) is 2^23 + b + 128;
//   minus 2^23 + 128 it is b.
// - FP8: the sign, exponent and mantissa fields moved to bf16's places
//   read as bf16 with bf16's exponent bias; times 2^(127 - bias) (E4M3
//   2^120, E5M2 2^112) that is the value, subnormals included.  Codes
//   that are NaN or infinite in FP8 (quantize_matrix writes none) come
//   out finite.
// - NF4: the nibble at `shift` through the bf16 codebook `nf4`.
template <int FB>
__device__ __forceinline__ void decode16(const uint4& v, int prec, int shift,
                                         const uint16_t* nf4,
                                         uint32_t (&h)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (FB == kNf4) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t x = (w[i] >> shift) & 0x0F0F0F0Fu;
      h[2 * i] = nf4[x & 0xF] | (uint32_t)nf4[(x >> 8) & 0xF] << 16;
      h[2 * i + 1] =
          nf4[(x >> 16) & 0xF] | (uint32_t)nf4[(x >> 24) & 0xF] << 16;
    }
  } else if (prec == kPrecInt8) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t u = w[i] ^ 0x80808080u;
      float f[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f[e] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + e)) -
               8388736.f;
      h[2 * i] = bf16_pair_of(f[0], f[1]);
      h[2 * i + 1] = bf16_pair_of(f[2], f[3]);
    }
  } else {
    const bool e4m3 = prec == kPrecE4M3;
    const uint32_t bias = e4m3 ? 0x7B807B80u : 0x77807780u;  // 2^120, 2^112
    const __nv_bfloat162 scale =
        *reinterpret_cast<const __nv_bfloat162*>(&bias);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      // Bytes 2 (i % 2) and 2 (i % 2) + 1 of word i / 2 at bits 8 and 24.
      const uint32_t t =
          __byte_perm(w[i / 2], 0, i % 2 ? 0x3424 : 0x1404);
      const uint32_t bits =
          (t & 0x80008000u) |
          (e4m3 ? (t >> 4) & 0x07F007F0u : (t >> 3) & 0x0FE00FE0u);
      const __nv_bfloat162 x =
          __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&bits), scale);
      h[i] = bf2_bits(x);
    }
  }
}

// A consumer thread's share (`ct` of 256) of decoding one stage: raw
// [64 k][BN n] bytes into the MN-major swizzled bf16 panels, k >= K zero.
template <int FB, int BN>
__device__ __forceinline__ void dequant_stage(const uint8_t* raw,
                                              uint8_t* tile, int prec,
                                              int shift, int k0, int k,
                                              const uint16_t* nf4, int ct) {
#pragma unroll
  for (int j = 0; j < BN * k9BK / 16 / k9Consumers; ++j) {
    const int q = ct + j * k9Consumers;
    const int kr = q / (BN / 16), nc = q % (BN / 16) * 16;
    uint32_t h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (k0 + kr < k)
      decode16<FB>(*reinterpret_cast<const uint4*>(raw + kr * BN + nc), prec,
                   shift, nf4, h);
    uint8_t* panel = tile + (nc / 64) * k9Panel;
    const int c = nc % 64 / 8;
    *reinterpret_cast<uint4*>(panel + sm90::swizzle128(kr, c)) =
        make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(panel + sm90::swizzle128(kr, c + 1)) =
        make_uint4(h[4], h[5], h[6], h[7]);
  }
}

// Grid (tile groups, batch x splits), k9Threads threads,
// Ring90<FB, BM, BN>::kBytes of dynamic shared memory.  FB: B's fetch
// class (kB16, kByte, kNf4); map_a over A (k, m, batch), map_b over B's
// payload (n, k or NF4 byte row, batch).
template <int FB, int BM, int BN>
__global__ void __launch_bounds__(k9Threads, 1)
gemm90_kernel(const __grid_constant__ CUtensorMap map_a,
              const __grid_constant__ CUtensorMap map_b, Params p) {
  using namespace sm90;
  using R = Ring90<FB, BM, BN>;
  constexpr int kMT = BM / 128;  // m64 tiles a consumer warpgroup
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + (1024 - smem_u32(smem_raw) % 1024) % 1024;
  uint8_t* decoded = smem + R::kStages * R::kStage;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + R::kBarriers);
  uint64_t* empty = full + R::kStages;
  uint16_t* nf4 = reinterpret_cast<uint16_t*>(empty + R::kStages);

  const int tid = threadIdx.x, lane = tid % 32;
  const int tiles_m = (p.m + BM - 1) / BM;
  const int tiles_n = (p.n + BN - 1) / BN;
  const int per_group = kGroupM * tiles_n;
  const int id = blockIdx.x, first = id / per_group * kGroupM;
  const int group_rows = min(tiles_m - first, kGroupM);
  const int m0 = (first + id % per_group % group_rows) * BM;
  const int n0 = id % per_group / group_rows * BN;
  const int bt = blockIdx.y / p.splits, split = blockIdx.y % p.splits;
  const int k_begin = split * p.k_per_split;
  const int k_end = min(p.k, k_begin + p.k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + k9BK - 1) / k9BK : 0;

  if (tid == 0) {
    for (int s = 0; s < R::kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], k9Consumers / 32);
    }
    fence_barrier_init();
  }
  if (tid < 16) {
    const __nv_bfloat16 v = __float2bfloat16_rn(kNf4Codebook[tid]);
    nf4[tid] = *reinterpret_cast<const uint16_t*>(&v);
  }
  __syncthreads();

  // The warpgroup, read through a shuffle so that ptxas sees it uniform
  // across each warp: wgmma in a path it cannot prove uniform is
  // serialised.
  const int role = __shfl_sync(0xffffffff, tid / 128, 0);
  if (role == 0) {
    // Producer warpgroup.
    setmaxnreg_dec<40>();
    if (tid == 0 && steps > 0) {
      prefetch_tensor_map(&map_a);
      prefetch_tensor_map(&map_b);
      for (int i = 0; i < steps; ++i) {
        const int s = i % R::kStages;
        if (i >= R::kStages) mbar_wait(&empty[s], (i / R::kStages - 1) & 1);
        uint8_t* st = smem + s * R::kStage;
        const int k0 = k_begin + i * k9BK;
        mbar_arrive_expect_tx(&full[s], R::kStage - (BM - p.box_m) * 128);
        tma_load_3d(st, &map_a, &full[s], k0, m0, bt);
        if constexpr (FB == kB16) {
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_3d(st + R::kATile + c * k9Panel, &map_b, &full[s],
                        n0 + 64 * c, k0, bt);
        } else {
          const int row = FB == kNf4 ? nf4_position(k0).byte : k0;
          tma_load_3d(st + R::kATile, &map_b, &full[s], n0, row, bt);
        }
      }
    }
  } else {
    // Consumer warpgroups: rows BM / 2 wg .. + BM / 2 of the tile.
    setmaxnreg_inc<232>();
    const int ct = tid - (k9Threads - k9Consumers), wg = role - 1;
    // Stage i's raw bytes into decoded tile i % k9Decoded (quantized B).
    auto decode = [&](int i) {
      const int s = i % R::kStages, k0 = k_begin + i * k9BK;
      mbar_wait(&full[s], (i / R::kStages) & 1);
      dequant_stage<FB, BN>(smem + s * R::kStage + R::kATile,
                            decoded + i % k9Decoded * R::kBTile, p.prec_b,
                            nf4_position(k0).shift, k0, p.k, nf4, ct);
      fence_proxy_async();
      named_barrier_sync(1, k9Consumers);
    };
    float acc[kMT][BN / 2];
#pragma unroll
    for (int t = 0; t < kMT; ++t)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0.f;
    if constexpr (FB != kB16) {
      if (steps > 0) decode(0);
    }
    for (int i = 0; i < steps; ++i) {
      const int s = i % R::kStages;
      const uint8_t* st = smem + s * R::kStage;
      const uint8_t* b_tile = st + R::kATile;
      if constexpr (FB == kB16)
        mbar_wait(&full[s], (i / R::kStages) & 1);
      else
        b_tile = decoded + i % k9Decoded * R::kBTile;
      // Every warpgroup issues its products, also where its rows lie
      // past M (their outputs are not stored): a wgmma under a branch is
      // serialised.
#pragma unroll
      for (int t = 0; t < kMT; ++t) fence_operands(acc[t]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < k9BK / 16; ++kk)
#pragma unroll
        for (int t = 0; t < kMT; ++t)
          wgmma_bf16<BN, 1>(
              acc[t],
              smem_desc(st + (wg * kMT + t) * 64 * 128 + kk * 32, 16, 1024),
              smem_desc(b_tile + kk * 2048, k9Panel, 1024));
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int t = 0; t < kMT; ++t) fence_operands(acc[t]);
      // One arrival a warp (256 on one barrier would serialise): stage
      // i - 1's products are done, its raw bytes decoded a step ago.
      __syncwarp();
      if (i > 0 && lane == 0) mbar_arrive(&empty[(i - 1) % R::kStages]);
      if constexpr (FB != kB16) {
        if (i + 1 < steps) decode(i + 1);
      }
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < kMT; ++t) fence_operands(acc[t]);
    // The epilogue goes through shared memory, so that each warp writes
    // whole output rows in 16-byte stores: the fragment's own layout
    // (16 bytes of each of 8 rows a store) runs at a small fraction of
    // the memory's rate.  The ring is free once both warpgroups are done.
    named_barrier_sync(1, k9Consumers);
    const int row0 = m0 + wg * (BM / 2);
    if (row0 < p.m) {
      constexpr int kLd = R::kLd;
      float* tile = reinterpret_cast<float*>(smem) + wg * (BM / 2) * kLd;
      const int lt = ct % 128, r = lt / 32 * 16 + lane / 4;
#pragma unroll
      for (int t = 0; t < kMT; ++t)
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<float2*>(tile + (t * 64 + r + 8 * h) * kLd +
                                       8 * j + 2 * (lane % 4)) =
                make_float2(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
      named_barrier_sync(2 + wg, 128);
      constexpr int kPerRow = BN / 8;  // threads a row, 8 columns each
      const int c = lt % kPerRow * 8;
      for (int rr = lt / kPerRow; rr < BM / 2; rr += 128 / kPerRow) {
        float v[8];
        const float4 lo = *reinterpret_cast<const float4*>(tile + rr * kLd + c);
        const float4 hi =
            *reinterpret_cast<const float4*>(tile + rr * kLd + c + 4);
        v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
        v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
        emit8(p, bt, split, row0 + rr, n0 + c, v);
      }
    }
  }
}

// The kernel of the operands' fetch classes (a template each).
template <typename Reg, int FA>
void launch_b(int fb, dim3 grid, cudaStream_t s, const Params& p) {
  switch (fb) {
    case kF32: gemm_kernel<Reg, FA, kF32><<<grid, kThreads, 0, s>>>(p); break;
    case kB16: gemm_kernel<Reg, FA, kB16><<<grid, kThreads, 0, s>>>(p); break;
    case kByte: gemm_kernel<Reg, FA, kByte><<<grid, kThreads, 0, s>>>(p); break;
    default: gemm_kernel<Reg, FA, kNf4><<<grid, kThreads, 0, s>>>(p); break;
  }
}

template <typename Reg>
void launch_a(int fa, int fb, dim3 grid, cudaStream_t s, const Params& p) {
  switch (fa) {
    case kF32: launch_b<Reg, kF32>(fb, grid, s, p); break;
    case kB16: launch_b<Reg, kB16>(fb, grid, s, p); break;
    case kByte: launch_b<Reg, kByte>(fb, grid, s, p); break;
    default: launch_b<Reg, kNf4>(fb, grid, s, p); break;
  }
}

// The parameters shared by both routes' kernels and the split-K sum.
Params make_params(const void* a, const void* b, const void* c,
                   const void* scale_a, const void* scale_b, void* out,
                   void* partial, const long long* strides, int m, int n,
                   int k, int batch, int splits, int k_per_split, int prec_a,
                   int prec_b, int out_type, int c_mode) {
  Params p;
  p.a = a;
  p.b = b;
  p.c = static_cast<const float*>(c);
  p.scale_a = static_cast<const float*>(scale_a);
  p.scale_b = static_cast<const float*>(scale_b);
  p.out = out;
  p.partial = static_cast<float*>(partial);
  p.a_sb = strides[0];
  p.a_sm = strides[1];
  p.a_sk = strides[2];
  p.b_sb = strides[3];
  p.b_sk = strides[4];
  p.b_sn = strides[5];
  p.c_sb = strides[6];
  p.sa_b = strides[7];
  p.sa_m = strides[8];
  p.sb_b = strides[9];
  p.sb_n = strides[10];
  p.m = m;
  p.n = n;
  p.k = k;
  p.batch = batch;
  p.splits = splits;
  p.k_per_split = splits > 1 ? k_per_split : (k > 0 ? k : 1);
  p.prec_a = prec_a;
  p.prec_b = prec_b;
  p.out_type = out_type;
  p.c_mode = c_mode;
  p.vec_a = p.vec_b = false;
  p.box_m = 0;
  return p;
}

// Arguments neither route takes; `step` is the route's K step.
bool bad_args(const void* c, void* partial, int k, int batch, int splits,
              int k_per_split, int step, int prec_a, int prec_b,
              int out_type, int c_mode) {
  return k < 0 || splits < 1 ||
         (splits > 1 && (!partial || k_per_split <= 0 ||
                         k_per_split % step)) ||
         prec_a < kPrecFp32 || prec_a > kPrecNf4 || prec_b < kPrecFp32 ||
         prec_b > kPrecNf4 || out_type < kOutFp32 || out_type > kOutFp16 ||
         c_mode < kCNone || c_mode > kCAfterScale || (c_mode && !c) ||
         (long long)batch * splits > 65535;
}

// The split-K sum after the main kernel (nothing when K is not split).
int finish(const Params& p, cudaStream_t s) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return (int)e;
  const size_t total = (size_t)p.batch * p.m * p.n;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256
                                                       : 4096);
  gemm_reduce_kernel<<<blocks, 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <int FB, int BM, int BN>
void launch90(dim3 grid, cudaStream_t s, const CUtensorMap& map_a,
              const CUtensorMap& map_b, const Params& p) {
  constexpr int bytes = Ring90<FB, BM, BN>::kBytes;
  if (cudaFuncSetAttribute(gemm90_kernel<FB, BM, BN>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes) != cudaSuccess)
    return;  // the error stays for cudaGetLastError
  gemm90_kernel<FB, BM, BN><<<grid, k9Threads, bytes, s>>>(map_a, map_b, p);
}

// The kernel of B's fetch class and the tile: the tile shapes each class
// takes (module comment), or false for any other.
bool launch90_tile(int fb, int bm, int bn, dim3 grid, cudaStream_t s,
                   const CUtensorMap& map_a, const CUtensorMap& map_b,
                   const Params& p) {
  constexpr int kM = MFA_GEMM90_BLOCK_M, kN = MFA_GEMM90_BLOCK_N;
  constexpr int kQM = MFA_GEMM90_QUANT_BLOCK_M;
  constexpr int kQN = MFA_GEMM90_QUANT_BLOCK_N;
  constexpr int kDN = MFA_GEMM90_BLOCK_N_DECODE;
  const bool quant = fb != kB16;
  if (bm == kM && bn == kDN) {
    if (!quant) launch90<kB16, kM, kDN>(grid, s, map_a, map_b, p);
    else if (fb == kByte) launch90<kByte, kM, kDN>(grid, s, map_a, map_b, p);
    else launch90<kNf4, kM, kDN>(grid, s, map_a, map_b, p);
  } else if (!quant && bm == kM && bn == kN) {
    launch90<kB16, kM, kN>(grid, s, map_a, map_b, p);
  } else if (quant && bm == kQM && bn == kQN) {
    if (fb == kByte) launch90<kByte, kQM, kQN>(grid, s, map_a, map_b, p);
    else launch90<kNf4, kQM, kQN>(grid, s, map_a, map_b, p);
  } else {
    return false;
  }
  return true;
}

constexpr int kErrTensorMap = 10000;  // cuTensorMapEncodeTiled refused

bool aligned16(const void* ptr, long long bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && bytes % 16 == 0;
}

}  // namespace

extern "C" {

// a, b: payloads; c: float32 or null; scale_a, scale_b: float32 or null;
// out: [batch, m, n]; partial: [splits, batch, m, n] float32 (splits > 1).
// strides: a (batch, m, k), b (batch, k, n), c batch, scale_a (batch, m),
// scale_b (batch, n), in elements.  prec_*: 0 fp32, 1 bf16, 2 int8, 3
// fp8-e4m3, 4 fp8-e5m2, 5 nf4.  out_type: 0 fp32, 1 bf16, 2 fp16.
// c_mode: 0 none, 1 C seeds the sum, 2 C added after the scales.
// fp32_registers: 0 bf16 registers on tensor cores, 1 fp32 on CUDA cores.
// vec_a, vec_b: the operand may be read in 16-byte chunks (its contiguous
// axis has stride 1; its start and its other strides are 16-byte
// multiples).
int mfa_gemm(const void* a, const void* b, const void* c, const void* scale_a,
             const void* scale_b, void* out, void* partial,
             const long long* strides, int m, int n, int k, int batch,
             int splits, int k_per_split, int prec_a, int prec_b,
             int out_type, int c_mode, int fp32_registers, int vec_a,
             int vec_b, void* stream) {
  if (m <= 0 || n <= 0 || batch <= 0) return 0;
  if (bad_args(c, partial, k, batch, splits, k_per_split, kBK, prec_a, prec_b,
               out_type, c_mode))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(a, b, c, scale_a, scale_b, out, partial, strides, m,
                         n, k, batch, splits, k_per_split, prec_a, prec_b,
                         out_type, c_mode);
  p.vec_a = vec_a != 0;
  p.vec_b = vec_b != 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((n + kBN - 1) / kBN, (m + kBM - 1) / kBM, batch * splits);
  if (fp32_registers)
    launch_a<float>(class_of(prec_a), class_of(prec_b), grid, s, p);
  else
    launch_a<__nv_bfloat16>(class_of(prec_a), class_of(prec_b), grid, s, p);
  return finish(p, s);
}

// The sm90 route: bf16 registers, A dense bf16 (prec_a is bf16) with
// strides[2] (k) == 1, B bf16 or quantized with strides[5] (n) == 1;
// every base and every other stride of A and B a 16-byte multiple.
// b_rows: B's payload extent along k (K, or round_up(K, 512) / 2 packed
// bytes for NF4).  block_m, block_n: the tile (GEMMDescriptor's
// kernel_config for the route).  Other arguments as mfa_gemm.  Returns
// cudaErrorInvalidValue for what the route does not take, kErrTensorMap
// when the driver refuses a TMA map.
int mfa_gemm_sm90(const void* a, const void* b, const void* c,
                  const void* scale_a, const void* scale_b, void* out,
                  void* partial, const long long* strides, int m, int n,
                  int k, int batch, int splits, int k_per_split, int prec_b,
                  int b_rows, int block_m, int block_n, int out_type,
                  int c_mode, void* stream) {
  if (m <= 0 || n <= 0 || batch <= 0) return 0;
  if (bad_args(c, partial, k, batch, splits, k_per_split, k9BK, kPrecBf16,
               prec_b, out_type, c_mode) ||
      prec_b < kPrecBf16 || strides[2] != 1 || strides[5] != 1 ||
      b_rows < (prec_b == kPrecNf4 ? 1 : k) || block_m <= 0 || block_n <= 0)
    return (int)cudaErrorInvalidValue;
  const int eb = prec_b == kPrecBf16 ? 2 : 1;
  if (!aligned16(a, strides[1] * 2) || !aligned16(b, strides[4] * eb) ||
      (batch > 1 && (strides[0] * 2 % 16 || strides[3] * eb % 16)))
    return (int)cudaErrorInvalidValue;
  Params p = make_params(a, b, c, scale_a, scale_b, out, partial, strides, m,
                         n, k, batch, splits, k_per_split, kPrecBf16, prec_b,
                         out_type, c_mode);
  // A single M tile loads only the rows that exist (a decode batch's
  // few): rows past them stay as they were and give rows of the output
  // that are not stored.
  p.box_m = m < block_m ? (m + 7) / 8 * 8 : block_m;
  CUtensorMap map_a, map_b;
  const int fb = class_of(prec_b);
  const bool ok =
      sm90::tensor_map(&map_a, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, k, m,
                       batch, strides[1], strides[0], k9BK, p.box_m,
                       CU_TENSOR_MAP_SWIZZLE_128B) &&
      (fb == kB16
           ? sm90::tensor_map(&map_b, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                              n, k, batch, strides[4], strides[3], 64, k9BK,
                              CU_TENSOR_MAP_SWIZZLE_128B)
           : sm90::tensor_map(&map_b, b, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n,
                              b_rows, batch, strides[4], strides[3], block_n,
                              k9BK, CU_TENSOR_MAP_SWIZZLE_NONE));
  if (!ok) return kErrTensorMap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long tiles =
      (long long)((m + block_m - 1) / block_m) * ((n + block_n - 1) / block_n);
  if (tiles > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)tiles, batch * splits);
  if (!launch90_tile(fb, block_m, block_n, grid, s, map_a, map_b, p))
    return (int)cudaErrorInvalidValue;
  return finish(p, s);
}

const char* mfa_cuda_error_string(int code) {
  if (code == kErrTensorMap)
    return "cuTensorMapEncodeTiled refused a TMA map of the operands";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
