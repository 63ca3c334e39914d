// Tiles of the kernels: the query rows and keys an attention block
// handles per step, the decode kernel's largest GQA group, and the GEMM's
// output tile and K step.  The Python wrappers read these lines
// (`native.build.tile_defines`): AttentionDescriptor.kernel_config the
// flash tiles, the decode wrappers their key tiles and chunks (the units
// of the split-KV splits) and group limit, GEMMDescriptor.kernel_config
// the GEMM's (each route's).
// So the kernels and their wrappers share this one source.  The flash
// kernels' blocks are two warpgroups of 64 rows (query rows, or keys for
// dK/dV); their tiles are the N of a wgmma (64, 128 or 256).

#pragma once

#define MFA_FWD90_BLOCK_Q 128   // flash_fwd: query rows per block (2 x 64)
#define MFA_FWD90_BLOCK_KV 128  // flash_fwd: keys per tile of the ring
#define MFA_FWD90_STAGES 2      // flash_fwd: K/V stages of the ring
#define MFA_BWD90_DQ_BLOCK_Q 128   // flash_bwd_dq: query rows per block
#define MFA_BWD90_DQ_BLOCK_KV 128  // flash_bwd_dq: keys per tile of the ring
#define MFA_BWD90_DKV_BLOCK_Q 64   // flash_bwd_dkv: query rows per step
#define MFA_BWD90_DKV_BLOCK_KV 128  // flash_bwd_dkv: keys per block
#define MFA_BWD90_STAGES 2         // both: stages of the ring
// The decode family (flash_decode and paged_decode share one kernel,
// paged_prefill has its own on the same ring): keys per tile of the
// cp.async ring, the ring's stages (flash_decode's; the paged kernels'),
// the most keys one split-KV block takes (the wrappers pick each call's
// chunk, a multiple of the tile, up to it), the largest GQA group, and
// whether 16-bit inputs run on tensor cores (1) or on CUDA cores (0, for
// the ablation).  Each may be set with -D when a variant is built.
#ifndef MFA_DECODE_BLOCK_KV
#define MFA_DECODE_BLOCK_KV 64
#endif
#ifndef MFA_DECODE_STAGES
#define MFA_DECODE_STAGES 2
#endif
#ifndef MFA_DECODE_CHUNK
#define MFA_DECODE_CHUNK 1024
#endif
#ifndef MFA_DECODE_MMA
#define MFA_DECODE_MMA 1
#endif
#define MFA_DECODE_MAX_GROUP 16
#define MFA_PAGED_BLOCK_Q 64      // paged_prefill: query rows per block
#ifndef MFA_PAGED_BLOCK_KV
#define MFA_PAGED_BLOCK_KV 64
#endif
#ifndef MFA_PAGED_STAGES
#define MFA_PAGED_STAGES 3
#endif
#ifndef MFA_PAGED_PREFILL_CHUNK
#define MFA_PAGED_PREFILL_CHUNK 512
#endif
// gemm: the output tile (rows x columns) one block computes and the K
// step it stages; the K step divides the NF4 half-group of 256, so a step
// never straddles two nibble planes.
#define MFA_GEMM_BLOCK_M 128
#define MFA_GEMM_BLOCK_N 128
#define MFA_GEMM_BLOCK_K 32
// gemm's sm90 route (TMA ring, wgmma): the output tile for a bf16 B, the
// taller one for a quantized B (each decoded element feeds 256 rows), the
// narrow one at a decode batch (M <= MFA_GEMM90_DECODE_M), the K step (one
// 128-byte swizzled bf16 row of A) and the most stages of the shared-
// memory ring (each tile takes as many as shared memory holds, up to it).
#define MFA_GEMM90_BLOCK_M 128
#define MFA_GEMM90_BLOCK_N 256
#define MFA_GEMM90_QUANT_BLOCK_M 256
#define MFA_GEMM90_QUANT_BLOCK_N 128
#define MFA_GEMM90_BLOCK_N_DECODE 128
#define MFA_GEMM90_DECODE_M 64
#define MFA_GEMM90_BLOCK_K 64
#define MFA_GEMM90_STAGES 6
