"""Autotune CLI: fill the persistent kernel-config cache on this card.

    python -m metal_flash_attention_tpu_torch.runtime autotune
        [--kernel forward] [--head-dims 64,128,256] [--seq 4096]
        [--gemm] [--decode] [--paged]

The winners land in the config cache (`~/.cache/mfa_torch/autotune.json`,
or the directory MFA_TORCH_CACHE_DIR names) and the native store: run it
once on a card, and every later launch finds its tile by a lookup.  The
tile variants it builds go to the package's `build/variants/`.
"""

from __future__ import annotations

import argparse

import torch


def main() -> None:
    parser = argparse.ArgumentParser(
        description="metal_flash_attention_tpu_torch autotuner")
    parser.add_argument("command", nargs="?", default="autotune",
                        choices=["autotune"])
    parser.add_argument(
        "--kernel", default="all",
        choices=["all", "forward", "backward_query",
                 "backward_key_value"],
        help="attention kernel family to tune ('all' sweeps every "
             "kernel type, causal included)")
    parser.add_argument("--head-dims", default="64,128,256")
    parser.add_argument("--seq", type=int, default=4096)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--dtype", default="bfloat16")
    parser.add_argument("--causal", action="store_true")
    parser.add_argument("--gemm", action="store_true",
                        help="also tune GEMM at 1024^3 / 4096^3")
    parser.add_argument("--decode", action="store_true",
                        help="tune decode block_kv per KV precision")
    parser.add_argument("--paged", action="store_true",
                        help="tune paged pages_per_chunk per KV "
                             "precision")
    args = parser.parse_args()

    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.runtime.autotune import (
        autotune_attention,
        autotune_decode,
        autotune_gemm,
        autotune_paged,
    )
    from metal_flash_attention_tpu_torch.runtime.cache import (
        KernelConfigCache,
    )
    from metal_flash_attention_tpu_torch.runtime.context import DeviceContext

    ctx = DeviceContext.get()
    print(f"device: {ctx.device_kind} ({ctx.generation}), "
          f"roofline {ctx.roofline_ginstrs_per_s:,.0f} GINSTRS/s")
    print(f"cache: {KernelConfigCache.get().store_path}")

    dtype = getattr(torch, args.dtype)
    if args.kernel == "all":
        sweeps = [("forward", False), ("forward", True),
                  ("backward_query", False), ("backward_key_value", False)]
    else:
        sweeps = [(args.kernel, args.causal)]
    for kernel, causal in sweeps:
        for d in (int(x) for x in args.head_dims.split(",")):
            winner, results = autotune_attention(
                kernel_type=kernel, n=args.seq, head_dim=d,
                heads=args.heads, dtype=dtype, causal=causal,
                verbose=True)
            label = kernel + ("_causal" if causal else "")
            print(f"{label} D={d}: winner {winner} "
                  f"({min(results.values()) * 1e3:.3f} ms)")

    kv_precisions = (None, OperandPrecision.INT8,
                     OperandPrecision.FP8_E4M3, OperandPrecision.NF4)
    if args.decode:
        for prec in kv_precisions:
            name = prec.value if prec else "bf16"
            winner, _ = autotune_decode(precision=prec, verbose=True)
            print(f"decode [{name}]: winner block_kv={winner}")
    if args.paged:
        for prec in kv_precisions:
            name = prec.value if prec else "bf16"
            winner, _ = autotune_paged(precision=prec, verbose=True)
            print(f"paged [{name}]: winner pages_per_chunk={winner}")

    if args.gemm:
        for size in (1024, 4096):
            winner, _ = autotune_gemm(m=size, n=size, k=size, dtype=dtype,
                                      verbose=True)
            print(f"gemm {size}^3: winner {winner}")


if __name__ == "__main__":
    main()
