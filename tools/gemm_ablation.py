#!/usr/bin/env python3
"""Ablations of the GEMM kernel's sm90 route on one NVIDIA GPU: where its
time goes at the quantized Llama-3-8B MLP's shapes.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 tools/gemm_ablation.py

Each variant is `csrc/gemm.cu` with one piece of work taken out by a
text patch, built into `metal_flash_attention_tpu_torch/build/ablation/
<variant>/` (the mma route's launches are cut too, so that only the six
sm90 kernels are compiled), and timed through the port's own `gemm`
wrapper with the variant's library in place of the real one:

- `sm90`: the kernel as it is;
- `no_decode`: a quantized B's stage is not decoded (the wgmmas read
  whatever the decoded tile holds): the cost of the decode;
- `no_epilogue_stores`: nothing is written to the output: the cost of
  the epilogue's stores;
- `one_step`: each block runs one K step: the fixed cost of a tile.

Only `sm90` computes the product; the others are for their times.  A
time is `chip_smoke.timed`'s device time (torch.profiler, the card's
kernel durations per call), the median of REPEATS profiled loops.
Prints the card's name and power limit, then one JSON line a variant.
"""

from __future__ import annotations

import ctypes
import importlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REPEATS = 3
SEED = 0
# (tokens, K, N): the MLP's w_gate (w_up alike) and w_down at a prefill's
# 8,192 tokens and a decode batch of 8, and the dense 4096^3 product.
SHAPES = ((8192, 4096, 14336), (8192, 14336, 4096), (8, 4096, 14336),
          (8, 14336, 4096), (4096, 4096, 4096))
PRECISIONS = ("bf16", "int8", "fp8_e4m3", "nf4")
CUT_MMA = ("launch_a<float>(class_of(prec_a), class_of(prec_b), grid, s, p);",
           "launch_a<__nv_bfloat16>(class_of(prec_a), class_of(prec_b), "
           "grid, s, p);")
VARIANTS = {
    "sm90": [],
    "no_decode": [(
        "      dequant_stage<FB, BN>(smem + s * R::kStage + R::kATile,",
        "      if (p.k < 0) dequant_stage<FB, BN>(smem + s * R::kStage + "
        "R::kATile,")],
    "no_epilogue_stores": [(
        "        emit8(p, bt, split, row0 + rr, n0 + c, v);",
        "        if (p.k < 0) emit8(p, bt, split, row0 + rr, n0 + c, v);")],
    "one_step": [(
        "  const int steps = k_end > k_begin ? (k_end - k_begin + k9BK - 1) "
        "/ k9BK : 0;",
        "  const int steps = k_end > k_begin ? 1 : 0;")],
}


def build_variants() -> dict:
    """{variant: ctypes library}, one nvcc each, all started together."""
    from metal_flash_attention_tpu_torch.native import build as nb

    with open(os.path.join(nb.SRC_DIR, "gemm.cu")) as f:
        source = f.read()
    for line in CUT_MMA:
        if line not in source:
            raise RuntimeError(f"gemm.cu no longer holds {line!r}")
        source = source.replace(line, "(void)0;")
    procs = {}
    for name, patches in VARIANTS.items():
        out_dir = os.path.join(nb.BUILD_DIR, "ablation", name)
        os.makedirs(out_dir, exist_ok=True)
        for f in os.listdir(nb.SRC_DIR):
            if f.endswith(".cuh"):
                shutil.copy(os.path.join(nb.SRC_DIR, f), out_dir)
        text = source
        for old, new in patches:
            if old not in text:
                raise RuntimeError(f"variant {name}: gemm.cu no longer "
                                   f"holds {old!r}")
            text = text.replace(old, new)
        with open(os.path.join(out_dir, "gemm.cu"), "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nb._nvcc(), *nb.NVCC_FLAGS, "-o",
             os.path.join(out_dir, "libgemm.so"),
             os.path.join(out_dir, "gemm.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=nb.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        lib = ctypes.CDLL(os.path.join(nb.BUILD_DIR, "ablation", name,
                                       "libgemm.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mfa_gemm_sm90.argtypes = [ptr] * 8 + [i32] * 12 + [ptr]
        lib.mfa_gemm_sm90.restype = i32
        lib.mfa_cuda_error_string.argtypes = [i32]
        lib.mfa_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("gemm_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )
    from metal_flash_attention_tpu_torch.ops.quantization import (
        quantize_matrix,
    )

    tg = importlib.import_module("metal_flash_attention_tpu_torch.ops.gemm")
    libs = build_variants()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cases = []
    for t, k, n in SHAPES:
        w = torch.randn((k, n), generator=gen, device=dev).to(torch.bfloat16)
        x = torch.randn((t, k), generator=gen, device=dev).to(torch.bfloat16)
        for prec in PRECISIONS:
            if (t, k, n) == (4096, 4096, 4096) and prec != "bf16":
                continue
            b = w if prec == "bf16" else quantize_matrix(
                w, OperandPrecision(prec), contract_axis=0, per_channel=True)
            cases.append((f"T{t}_K{k}_N{n}_{prec}", x, b))
    print(chip_smoke.card_line(), flush=True)
    for name, lib in libs.items():
        tg._kernel_library = lambda lib=lib: lib
        row = {}
        for label, x, b in cases:
            kw = {"backend": "pallas"} if isinstance(b, torch.Tensor) else {}
            iters = 5 if x.shape[0] > 64 else 50
            row[label] = float(np.median([
                chip_smoke.timed(lambda: tg.gemm(x, b, **kw), iters)[0]
                for _ in range(REPEATS)]))
        print(json.dumps({"variant": name, "device_ms": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
