// Tiles of the kernels: the query rows and keys an attention block
// handles per step, the decode kernel's largest GQA group, and the GEMM's
// output tile and K step.  The Python wrappers read these lines
// (`native.build.tile_defines`): AttentionDescriptor.kernel_config the
// flash tiles, the decode wrappers their key tiles and chunks (the units
// of the split-KV splits) and group limit, GEMMDescriptor.kernel_config
// the GEMM's (each route's).
// So the kernels and their wrappers share this one source.  The flash
// kernels' blocks are warpgroups of 64 rows (query rows, or keys for
// dK/dV); their tiles are the N of a wgmma (64, 128 or 256).
// Every value may be set with -D: a library built so is a tile variant
// (`native.build.load_library(name, defines)`, under build/variants/),
// whose launchers size their grids and shared memory from these macros.
// The values here are the default tiles, the H100 table's rows
// (`descriptors.parameters`).

#pragma once

#ifndef MFA_FWD90_BLOCK_Q
#define MFA_FWD90_BLOCK_Q 128   // flash_fwd: query rows per block (2 x 64)
#endif
#ifndef MFA_FWD90_BLOCK_KV
#define MFA_FWD90_BLOCK_KV 128  // flash_fwd: keys per tile of the ring
#endif
// flash_fwd at head_dim 256 (Gemma-2): one consumer warpgroup, so that its
// 128 floats of O a thread fit the registers, and 64-key tiles.
#ifndef MFA_FWD90_D256_BLOCK_Q
#define MFA_FWD90_D256_BLOCK_Q 64
#endif
#ifndef MFA_FWD90_D256_BLOCK_KV
#define MFA_FWD90_D256_BLOCK_KV 64
#endif
#ifndef MFA_FWD90_D256_STAGES
#define MFA_FWD90_D256_STAGES 2
#endif
#ifndef MFA_FWD90_STAGES
#define MFA_FWD90_STAGES 2      // flash_fwd: K/V stages of the ring
#endif
#ifndef MFA_FWD90_RAW_STAGES
#define MFA_FWD90_RAW_STAGES 2  // flash_fwd: stored quantized K/V stages
#endif
#ifndef MFA_BWD90_DQ_BLOCK_Q
#define MFA_BWD90_DQ_BLOCK_Q 128   // flash_bwd_dq: query rows per block
#endif
#ifndef MFA_BWD90_DQ_BLOCK_KV
#define MFA_BWD90_DQ_BLOCK_KV 128  // flash_bwd_dq: keys per tile of the ring
#endif
#ifndef MFA_BWD90_DKV_BLOCK_Q
#define MFA_BWD90_DKV_BLOCK_Q 64   // flash_bwd_dkv: query rows per step
#endif
#ifndef MFA_BWD90_DKV_BLOCK_KV
#define MFA_BWD90_DKV_BLOCK_KV 128  // flash_bwd_dkv: keys per block
#endif
#ifndef MFA_BWD90_STAGES
#define MFA_BWD90_STAGES 2         // both: stages of the ring
#endif
// The backward pair at head_dim 256 (Gemma-2 training).  dQ: one
// warpgroup of 64 query rows and 64-key tiles (its 64 x 256 float32 dQ
// is 128 registers a thread; Q and dO kept, 64 KB, and two stages of K
// and V, 128 KB).  dK/dV: 64 keys a block, shared by two warpgroups that
// each own half of dK's and dV's columns, over 64-row Q/dO stages.
#ifndef MFA_BWD90_D256_DQ_BLOCK_Q
#define MFA_BWD90_D256_DQ_BLOCK_Q 64
#endif
#ifndef MFA_BWD90_D256_DQ_BLOCK_KV
#define MFA_BWD90_D256_DQ_BLOCK_KV 64
#endif
#ifndef MFA_BWD90_D256_DKV_BLOCK_Q
#define MFA_BWD90_D256_DKV_BLOCK_Q 64
#endif
#ifndef MFA_BWD90_D256_DKV_BLOCK_KV
#define MFA_BWD90_D256_DKV_BLOCK_KV 64
#endif
#ifndef MFA_BWD90_D256_STAGES
#define MFA_BWD90_D256_STAGES 2
#endif
// The true-fp32 kernels (flash_attention_f32.cu, CUDA cores, 256 threads
// a block): the forward and dQ take MFA_F32_BLOCK_Q query rows a block
// over key tiles of MFA_F32_BLOCK_KV keys; dK/dV MFA_F32_DKV_BLOCK_KV keys
// a block over steps of MFA_F32_DKV_BLOCK_Q query rows; MFA_F32_STAGES
// cp.async stages.  At head_dim 256 the key tiles shrink so that a
// block's float32 operands fit its shared memory.
#ifndef MFA_F32_BLOCK_Q
#define MFA_F32_BLOCK_Q 64
#endif
#ifndef MFA_F32_BLOCK_KV
#define MFA_F32_BLOCK_KV 64
#endif
#ifndef MFA_F32_D256_FWD_BLOCK_KV
#define MFA_F32_D256_FWD_BLOCK_KV 32
#endif
#ifndef MFA_F32_D256_DQ_BLOCK_KV
#define MFA_F32_D256_DQ_BLOCK_KV 16
#endif
#ifndef MFA_F32_DKV_BLOCK_KV
#define MFA_F32_DKV_BLOCK_KV 64
#endif
#ifndef MFA_F32_D256_DKV_BLOCK_KV
#define MFA_F32_D256_DKV_BLOCK_KV 32
#endif
#ifndef MFA_F32_DKV_BLOCK_Q
#define MFA_F32_DKV_BLOCK_Q 32
#endif
#ifndef MFA_F32_STAGES
#define MFA_F32_STAGES 2
#endif
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
#ifndef MFA_GEMM_BLOCK_M
#define MFA_GEMM_BLOCK_M 128
#endif
#ifndef MFA_GEMM_BLOCK_N
#define MFA_GEMM_BLOCK_N 128
#endif
#ifndef MFA_GEMM_BLOCK_K
#define MFA_GEMM_BLOCK_K 32
#endif
// gemm's sm90 route (TMA ring, wgmma): the output tile for a bf16 B, the
// taller one for a quantized B (each decoded element feeds 256 rows), the
// narrow one at a decode batch (M <= MFA_GEMM90_DECODE_M), the K step (one
// 128-byte swizzled bf16 row of A) and the most stages of the shared-
// memory ring (each tile takes as many as shared memory holds, up to it).
#ifndef MFA_GEMM90_BLOCK_M
#define MFA_GEMM90_BLOCK_M 128
#endif
#ifndef MFA_GEMM90_BLOCK_N
#define MFA_GEMM90_BLOCK_N 256
#endif
#ifndef MFA_GEMM90_QUANT_BLOCK_M
#define MFA_GEMM90_QUANT_BLOCK_M 256
#endif
#ifndef MFA_GEMM90_QUANT_BLOCK_N
#define MFA_GEMM90_QUANT_BLOCK_N 128
#endif
#ifndef MFA_GEMM90_BLOCK_N_DECODE
#define MFA_GEMM90_BLOCK_N_DECODE 128
#endif
#ifndef MFA_GEMM90_DECODE_M
#define MFA_GEMM90_DECODE_M 64
#endif
#ifndef MFA_GEMM90_BLOCK_K
#define MFA_GEMM90_BLOCK_K 64
#endif
#ifndef MFA_GEMM90_STAGES
#define MFA_GEMM90_STAGES 6
#endif
