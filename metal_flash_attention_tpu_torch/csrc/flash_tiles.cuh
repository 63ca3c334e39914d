// Tiles of the flash-attention kernels: the query rows and keys one block
// handles per step.  descriptors/attention_descriptor.py reads these lines
// for AttentionDescriptor.kernel_config, so the kernels and the descriptor
// share this one source.  Each is a multiple of 16 (the mma tile); a block
// has one warp per 16 rows of its block-sized axis.

#pragma once

#define MFA_FWD_BLOCK_Q 64    // flash_fwd: query rows per block
#define MFA_FWD_BLOCK_KV 64   // flash_fwd: keys per iteration
#define MFA_DQ_BLOCK_Q 64     // flash_bwd_dq: query rows per block
#define MFA_DQ_BLOCK_KV 32    // flash_bwd_dq: keys per iteration
#define MFA_DKV_BLOCK_Q 32    // flash_bwd_dkv: query rows per iteration
#define MFA_DKV_BLOCK_KV 64   // flash_bwd_dkv: keys per block
