// Hopper (sm_90a) building blocks in inline PTX, shared by the port's
// TMA- and wgmma-fed kernels: mbarriers, TMA tensor loads and stores,
// wgmma shared-memory descriptors for the 128-byte swizzle, the wgmma
// fence / commit / wait and the products (SS m64n64k16, m64n128k16 and
// m64n256k16, RS m64n64k16 and m64n128k16, in bf16 and fp16), named barriers and
// setmaxnreg; and on the host, the TMA map encoder.  Raw PTX rather than
// CuTe keeps the build short.
//
// Conventions:
// - A shared-memory tile that TMA writes with CU_TENSOR_MAP_SWIZZLE_128B,
//   or that threads write in the same pattern (`swizzle128`), starts on a
//   1024-byte boundary: the swizzle XORs address bits [4, 7) with bits
//   [7, 10), so 16-byte chunk c of 128-byte row r lands at chunk
//   c ^ (r % 8).
// - K-major operand (the contraction contiguous, rows of 64 bf16 = 128
//   bytes): 8-row groups 1024 bytes apart (SBO); one k16 slice is 32
//   bytes further along the row.
// - MN-major operand (the rows or columns contiguous, 64 of them = 128
//   bytes a K row): 8-K-row groups 1024 bytes apart (SBO), 64-wide MN
//   groups LBO apart; one k16 slice is 16 K rows = 2048 bytes further.
// - An mbarrier wait that never completes traps after kSpinLimit polls
//   (seconds), so a pipeline fault ends the kernel with an error
//   instead of hanging the card.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mfa {
namespace sm90 {

constexpr long long kSpinLimit = 1ll << 31;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------

// One thread initialises; `count` arrivals complete a phase.
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Arrive and add `bytes` to the transaction count the phase waits for
// (the bytes the TMA loads of this phase will deliver).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` has completed: the first
// phase after init has parity 0, the next 1, and so on.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  for (long long i = 0; !mbar_try_wait(addr, parity); ++i)
    if (i > kSpinLimit) __trap();
}

// ---- TMA ------------------------------------------------------------

// Copy the box at coordinates (c0 innermost, c1) of the tensor map into
// shared memory at `dst`; completion adds the box's bytes to `bar`.
// `map` is a __grid_constant__ kernel parameter.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// As tma_load_2d with a third (outermost) coordinate, such as a batch.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void prefetch_tensor_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// Copy shared memory at `src` into the box at (c0, c1, c2) of the tensor
// map; elements outside the tensor are not written.  One thread issues
// it, after the writes to `src` are fenced (fence_proxy_async) and
// barrier-synchronised; tma_store_wait before `src` is reused or the
// block exits.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Commit the thread's TMA stores and wait until they have read shared
// memory.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

// Generic-proxy writes to shared memory (threads' stores) made visible to
// the async proxy (wgmma, TMA) that reads them after a barrier.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- swizzle, descriptors ---------------------------------------------

// Byte offset of 16-byte chunk `chunk` of 128-byte row `row` in a
// 1024-byte-aligned tile written with the 128-byte swizzle.
__device__ __forceinline__ int swizzle128(int row, int chunk) {
  return row * 128 + ((chunk ^ (row & 7)) << 4);
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units), layout type 1 (B128).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// ---- wgmma ------------------------------------------------------------

// Before the first wgmma, and whenever the accumulators were touched by
// other instructions.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous products.
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for 16-bit A operands in registers (an RS wgmma's), which the
// product reads until it has been waited for.
template <int K>
__device__ __forceinline__ void fence_operands(uint32_t (&a)[K][4]) {
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) asm volatile("" : "+r"(a[i][r])::"memory");
}

// Operand lists of the wgmma statements below: the accumulators d[0..R)
// as "+f" operands, and their register names in the instruction.
#define MFA_ACC4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define MFA_ACC16(i) MFA_ACC4(i), MFA_ACC4(i + 4), MFA_ACC4(i + 8), MFA_ACC4(i + 12)
#define MFA_ACC32(i) MFA_ACC16(i), MFA_ACC16(i + 16)
#define MFA_ACC64(i) MFA_ACC32(i), MFA_ACC32(i + 32)
#define MFA_ACC128 MFA_ACC64(0), MFA_ACC64(64)
#define MFA_REGS32 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31}"
#define MFA_REGS64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define MFA_REGS128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
  "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
  "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
  "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
  "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, " \
  "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, " \
  "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, " \
  "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, " \
  "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, " \
  "%127}"

// SS: A and B from shared memory.  N: "64", "128" or "256"; TY: "bf16" or
// "f16"; REGS, ACC: the accumulators; IA..IT: the numbers of the
// operands after them (IA the A registers' list in the RS form).
#define MFA_WGMMA_SS(N, TY, REGS, ACC, IA, IB, IS, IT)                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY  \
               " " REGS ", %" IA ", %" IB ", p, 1, 1, 0, %" IT ";\n}\n"    \
               : ACC                                                        \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(TransB))

// RS: A from four registers a thread, B from shared memory.
#define MFA_WGMMA_RS(N, TY, REGS, ACC, IA, IB, IS, IT)                      \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %" IS ", 0;\n"            \
               "wgmma.mma_async.sync.aligned.m64n" N "k16.f32." TY "." TY  \
               " " REGS ", " IA ", %" IB ", p, 1, 1, %" IT ";\n}\n"        \
               : ACC                                                        \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),   \
                 "r"(scale_d), "n"(TransB))

// D[64 x N] (+)= A[64 x 16] B[16 x N], N = 64, 128 or 256, 16-bit operands
// from shared memory (bf16, or fp16 when Fp16), float32 accumulators: a
// warpgroup's 128 threads each hold N / 2, thread t of warp w: d[4j + e]
// is row 16w + t/4 + 8 (e / 2), column 8j + 2 (t % 4) + e % 2.  A is
// K-major; B is MN-major when TransB (its N axis contiguous), K-major
// otherwise.  scale_d 0 overwrites D.
template <int N, int TransB, bool Fp16 = false>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d = 1) {
  static_assert(N == 64 || N == 128 || N == 256, "m64n{64,128,256}k16");
  if constexpr (N == 64 && Fp16)
    MFA_WGMMA_SS("64", "f16", MFA_REGS32, MFA_ACC32(0), "32", "33", "34",
                 "35");
  else if constexpr (N == 64)
    MFA_WGMMA_SS("64", "bf16", MFA_REGS32, MFA_ACC32(0), "32", "33", "34",
                 "35");
  else if constexpr (N == 128 && Fp16)
    MFA_WGMMA_SS("128", "f16", MFA_REGS64, MFA_ACC64(0), "64", "65", "66",
                 "67");
  else if constexpr (N == 128)
    MFA_WGMMA_SS("128", "bf16", MFA_REGS64, MFA_ACC64(0), "64", "65", "66",
                 "67");
  else if constexpr (Fp16)
    MFA_WGMMA_SS("256", "f16", MFA_REGS128, MFA_ACC128, "128", "129", "130",
                 "131");
  else
    MFA_WGMMA_SS("256", "bf16", MFA_REGS128, MFA_ACC128, "128", "129", "130",
                 "131");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], N = 64 or 128, A from registers:
// thread t of warp w holds a[0] = A[16w + t/4][2 (t % 4) + {0, 1}], a[1]
// the same columns 8 rows down, a[2] and a[3] the same 8 columns on (two
// 16-bit values a register, the lower column in the low half).  That is
// the accumulator layout of a k16 column slice packed in pairs, so a
// product's result feeds the next product without shared memory.  B and
// the rest as wgmma_ss.
template <int N, int TransB, bool Fp16 = false>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d = 1) {
  static_assert(N == 64 || N == 128, "m64n64k16 or m64n128k16");
  if constexpr (N == 64 && Fp16)
    MFA_WGMMA_RS("64", "f16", MFA_REGS32, MFA_ACC32(0),
                 "{%32, %33, %34, %35}", "36", "37", "38");
  else if constexpr (N == 64)
    MFA_WGMMA_RS("64", "bf16", MFA_REGS32, MFA_ACC32(0),
                 "{%32, %33, %34, %35}", "36", "37", "38");
  else if constexpr (Fp16)
    MFA_WGMMA_RS("128", "f16", MFA_REGS64, MFA_ACC64(0),
                 "{%64, %65, %66, %67}", "68", "69", "70");
  else
    MFA_WGMMA_RS("128", "bf16", MFA_REGS64, MFA_ACC64(0),
                 "{%64, %65, %66, %67}", "68", "69", "70");
}

// The bf16 SS products under their earlier names.
template <int TransB>
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b,
                                                      int scale_d = 1) {
  wgmma_ss<128, TransB>(d, desc_a, desc_b, scale_d);
}

template <int TransB>
__device__ __forceinline__ void wgmma_m64n256k16_bf16(float (&d)[128],
                                                      uint64_t desc_a,
                                                      uint64_t desc_b,
                                                      int scale_d = 1) {
  wgmma_ss<256, TransB>(d, desc_a, desc_b, scale_d);
}

// D[64 x N] (+)= A B for N = 128 or 256 (the two instructions above).
template <int N, int TransB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t desc_a,
                                           uint64_t desc_b) {
  wgmma_ss<N, TransB>(d, desc_a, desc_b);
}

// ---- warp specialisation ---------------------------------------------

// Barrier `id` (1..15; 0 is __syncthreads) over `count` threads, a
// multiple of 32.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Arrive at barrier `id` without waiting: with a named_barrier_sync of
// the same id and count elsewhere, a signal from one group of warps to
// another.
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// A warpgroup's per-thread register budget, lowered (a producer's) or
// raised (a consumer's).  All four warps execute it; the kernel's roles
// must sit in one if-else that never reconverges, or ptxas ignores it.
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

// ---- TMA maps (host) ------------------------------------------------

// cuTensorMapEncodeTiled, a libcuda entry point reached through the
// runtime (no link against libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A TMA map over a [batch][rows][inner] payload of `esize`-byte elements
// (strides in elements; the inner stride is 1), read in boxes of
// box_inner x box_rows; elements outside read as zero bytes.
inline bool tensor_map(CUtensorMap* map, const void* base,
                       CUtensorMapDataType type, int esize, long long inner,
                       long long rows, long long batch, long long row_stride,
                       long long batch_stride, uint32_t box_inner,
                       uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {
      (cuuint64_t)(row_stride * esize),
      (cuuint64_t)((batch > 1 ? batch_stride : rows * row_stride) * esize)};
  const cuuint32_t box[3] = {box_inner, box_rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace sm90
}  // namespace mfa
