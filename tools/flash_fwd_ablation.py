#!/usr/bin/env python3
"""Variants of the flash-attention forward kernel on one NVIDIA GPU: where
its time goes at the training path's and the dense prefill's shapes, with
SDPA and, optionally, an earlier checkout's kernel beside it.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 tools/flash_fwd_ablation.py [--parent DIR]

Each variant is `csrc/flash_attention.cu` with text patches, built into
`metal_flash_attention_tpu_torch/build/ablation_fwd/<variant>/` (one nvcc
each, all started together), and timed through the port's own wrapper
with the variant's library in place of the real one:

- `sm90`: the kernel as it is;
- `stages3`: three K/V stages in the ring instead of MFA_FWD90_STAGES;
- `bkv64`: 64 keys a tile instead of MFA_FWD90_BLOCK_KV;
- `fa3`: FlashAttention-3's consumer loop in place of the kernel's:
  tile i's QK^T issued before tile i - 1's PV, whose softmax runs while
  that PV finishes, and the two warpgroups taking turns to issue their
  products (ping-pong); `fa3_no_pingpong` without the turns;
  `fa3_bkv64`, `fa3_bkv64_no_pingpong` the same at 64 keys a tile;
- `one_tile`: each block takes only its first key tile: a block's fixed
  cost (Q's load, the first tile, the epilogue).

Every variant but `one_tile` computes the forward (each is held against
`sm90` by the worst 64-row tile); `one_tile` is for its time.  With
--parent DIR, the forward of the checkout at DIR (for example the parent
commit, unpacked with `git archive`) runs in a process of its own before
and after the variants.  A time is
`chip_smoke.timed_spread`'s: the median, min and max device ms a call
over 5 profiled loops.  Prints the card's name and power limit, then one
JSON line a variant.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 0
# name: (batch, q heads, kv heads, tokens, loop length): the training
# path's forward and the dense prefill's, both causal, head_dim 128, bf16.
SHAPES = {"train": (1, 32, 8, 8192, 20), "prefill": (8, 32, 8, 8160, 5)}
# FlashAttention-3's consumer loop, in place of the kernel's: step i
# issues tile i's QK^T, rescales O while it runs, then issues tile i - 1's
# PV and runs tile i's softmax while the tensor cores finish that PV
# (intra-warpgroup overlap); the two warpgroups take turns to issue
# (ping-pong).
LOOP = ("    // Every warpgroup issues its products, also where its rows lie",
        "    // Epilogue: normalise; lse; O.")
FA3_LOOP = """\
    // The two warpgroups take turns to issue their products (ping-pong),
    // so that one's softmax runs while the other's products do: each
    // waits for its barrier before issuing and then opens the other's.
    // Warpgroup 0 goes first; warpgroup 1 does not open after its last
    // turn, which nobody waits for.
    auto turn_wait = [&]() { named_barrier_sync(3 + wg, kConsumers); };
    auto turn_pass = [&](int i) {
      if (wg == 0 || i + 1 < n_tiles)
        named_barrier_arrive(4 - wg, kConsumers);
    };

    // Every warpgroup issues its products, also where its rows lie past
    // the head (their outputs are not stored): a wgmma under a branch is
    // serialised.  Step i issues tile i's QK^T, rescales O while it runs,
    // then issues tile i - 1's PV and runs tile i's softmax while the
    // tensor cores finish that PV.
    if (n_tiles > 0) {
      if (wg == 0) named_barrier_arrive(3, kConsumers);
      mbar_wait(q_full, 0);
      mbar_wait(&k_full[0], 0);
      turn_wait();
      issue_qk<D, kFp16>(sc, q_wg, smem + L::kK);
      turn_pass(0);
      wgmma_wait<0>();
      fence_operands(sc);
      release(k_empty, 0);
      if (open_begin > 0 || open_end <= 0)
        softmax_tile<true>(sc, m, l, alpha, p.scale_log2e,
                           (n_hi - 1) * kBKV + 2 * t4, lo, hi);
      else
        softmax_tile<false>(sc, m, l, alpha, p.scale_log2e,
                            (n_hi - 1) * kBKV + 2 * t4, lo, hi);
      pack_rs<T, kBKV>(pa, sc);
      for (int i = 1; i < n_tiles; ++i) {
        const int s = i % kS, sp = (i - 1) % kS;
        mbar_wait(&k_full[s], (i / kS) & 1);
        turn_wait();
        issue_qk<D, kFp16>(sc, q_wg, smem + L::kK + s * L::kTile);
#pragma unroll
        for (int e = 0; e < D / 2; ++e) o[e] *= alpha[e % 4 / 2];
        mbar_wait(&v_full[sp], ((i - 1) / kS) & 1);
        issue_pv<D, kFp16>(o, pa, smem + L::kV + sp * L::kTile);
        turn_pass(i);
        wgmma_wait<1>();
        fence_operands(sc);
        release(k_empty, i);
        if (i < open_begin || i >= open_end)
          softmax_tile<true>(sc, m, l, alpha, p.scale_log2e,
                             (n_hi - 1 - i) * kBKV + 2 * t4, lo, hi);
        else
          softmax_tile<false>(sc, m, l, alpha, p.scale_log2e,
                              (n_hi - 1 - i) * kBKV + 2 * t4, lo, hi);
        wgmma_wait<0>();
        fence_operands(o);
        release(v_empty, i - 1);
        pack_rs<T, kBKV>(pa, sc);
      }
      const int last = (n_tiles - 1) % kS;
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[e % 4 / 2];
      mbar_wait(&v_full[last], ((n_tiles - 1) / kS) & 1);
      issue_pv<D, kFp16>(o, pa, smem + L::kV + last * L::kTile);
      wgmma_wait<0>();
      fence_operands(o);
    }


"""
FA3 = [(LOOP, FA3_LOOP)]
NO_PINGPONG = [
    ("named_barrier_sync(3 + wg, kConsumers);", ""),
    ("named_barrier_arrive(4 - wg, kConsumers);", "(void)0;"),
    ("if (wg == 0) named_barrier_arrive(3, kConsumers);", "")]
BKV64 = [("constexpr int kBKV = MFA_FWD90_BLOCK_KV;",
          "constexpr int kBKV = 64;")]
VARIANTS = {
    "sm90": [],
    "stages3": [("  static constexpr int kStages = MFA_FWD90_STAGES;",
                 "  static constexpr int kStages = 3;")],
    "bkv64": BKV64,
    "fa3": FA3,
    "fa3_no_pingpong": FA3 + NO_PINGPONG,
    "fa3_bkv64": FA3 + BKV64,
    "fa3_bkv64_no_pingpong": FA3 + BKV64 + NO_PINGPONG,
    "one_tile": [(
        "  const int n_lo = col_lo / kBKV;",
        "  const int n_lo = max(col_lo / kBKV, col_hi / kBKV);")],
}


def apply(text: str, patches: list, name: str) -> str:
    """Each patch replaces a string, or (a tuple of two strings) the text
    from the first up to the second."""
    for old, new in patches:
        if isinstance(old, tuple):
            a, b = text.find(old[0]), text.find(old[1])
            if a < 0 or b < a:
                raise RuntimeError(f"variant {name}: flash_attention.cu no "
                                   f"longer holds {old!r}")
            text = text[:a] + new + text[b:]
        elif old in text:
            text = text.replace(old, new)
        else:
            raise RuntimeError(f"variant {name}: flash_attention.cu no "
                               f"longer holds {old!r}")
    return text


# Times the forward of the package found from the working directory.
TIME_TREE = """
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from metal_flash_attention_tpu_torch.ops import flash_attention as fa
out = {}
for name, (b, qh, kvh, n, iters) in json.loads(sys.argv[1]).items():
    g = torch.Generator(device="cuda").manual_seed(int(sys.argv[2]))
    q, k, v = (torch.randn((b, h, n, 128), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (qh, kvh, kvh))
    out[name] = chip_smoke.timed_spread(
        lambda: fa.flash_attention_forward(q, k, v, causal=True), iters)
print(json.dumps(out))
"""


PTXAS: dict = {}


def kernel_label(mangled: str) -> str:
    return (("fp16" if "6__half" in mangled else "bf16")
            + (" D128" if "Li128E" in mangled else " D64"))


def ptxas_summary(log: str) -> dict:
    """ptxas's registers, spills and notes (C75xx) for each forward
    kernel of a build log."""
    rows, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = kernel_label(line.split("'")[1])
            rows[current] = {}
        elif "(C75" in line and "'" in line:
            rows.setdefault(kernel_label(line.split("'")[1]), {}).setdefault(
                "notes", []).append(line.split("(")[1].split(")")[0])
        elif current and "spill stores" in line:
            rows[current]["spills"] = line.strip()
        elif current and "Used" in line and "registers" in line:
            rows[current]["registers"] = int(
                line.split("Used ")[1].split()[0])
    return rows


def build_variants() -> dict:
    """{variant: ctypes library}, one nvcc each, all started together."""
    from metal_flash_attention_tpu_torch.native import build as nb

    with open(os.path.join(nb.SRC_DIR, "flash_attention.cu")) as f:
        source = f.read()
    procs = {}
    for name, patches in VARIANTS.items():
        out_dir = os.path.join(nb.BUILD_DIR, "ablation_fwd", name)
        os.makedirs(out_dir, exist_ok=True)
        text = apply(source, patches, name)
        src = os.path.join(out_dir, "flash_attention.cu")
        with open(src, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [nb._nvcc(), *nb.NVCC_FLAGS, "-I", nb.SRC_DIR, "-o",
             os.path.join(out_dir, "libflash_attention.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=nb.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        PTXAS[name] = ptxas_summary(log)
        lib = ctypes.CDLL(os.path.join(nb.BUILD_DIR, "ablation_fwd", name,
                                       "libflash_attention.so"))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.mfa_flash_fwd.argtypes = ([ptr] * 5 + [i32] * 6
                                      + [ctypes.c_float] + [i32] * 4 + [ptr])
        lib.mfa_flash_fwd.restype = i32
        lib.mfa_cuda_error_string.argtypes = [i32]
        lib.mfa_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def time_tree(path: str) -> dict:
    """The forward of the checkout at `path`, in a process of its own."""
    run = subprocess.run(
        [sys.executable, "-c", TIME_TREE, json.dumps(SHAPES), str(SEED)],
        cwd=path, capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"the forward of {path} failed:\n{run.stderr}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a checkout whose forward to time "
                        "before and after the variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_fwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa

    print(chip_smoke.card_line(), flush=True)
    if args.parent:
        print(json.dumps({"variant": "parent (first)",
                          "ms": time_tree(args.parent)}), flush=True)
    libs = build_variants()
    inputs = {}
    for name, (b, qh, kvh, n, iters) in SHAPES.items():
        g = torch.Generator(device="cuda").manual_seed(SEED)
        inputs[name] = tuple(
            torch.randn((b, h, n, 128), generator=g, device="cuda")
            .to(torch.bfloat16) for h in (qh, kvh, kvh)) + (iters,)
    ref = {}
    for name, lib in libs.items():
        fa._kernel_library = lambda lib=lib: lib
        row, err = {}, {}
        for shape, (q, k, v, iters) in inputs.items():
            row[shape] = chip_smoke.timed_spread(
                lambda: fa.flash_attention_forward(q, k, v, causal=True),
                iters)
            if shape == "train" and name != "one_tile":
                o, _ = fa.flash_attention_forward(q, k, v, causal=True)
                ref.setdefault(shape, o)
                err[shape] = chip_smoke.closeness(o, ref[shape])[
                    "tile_rel_rms"]
        print(json.dumps({"variant": name, "ms": row,
                          "tile_rel_rms_vs_sm90": err,
                          "ptxas": PTXAS[name]}), flush=True)
    row = {shape: chip_smoke.timed_spread(
        lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), iters)
        for shape, (q, k, v, iters) in inputs.items()}
    print(json.dumps({"variant": "sdpa", "ms": row}), flush=True)
    if args.parent:
        print(json.dumps({"variant": "parent (last)",
                          "ms": time_tree(args.parent)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
