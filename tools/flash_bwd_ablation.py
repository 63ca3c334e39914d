#!/usr/bin/env python3
"""Variants of the flash-attention backward kernels (dQ and dK/dV) on one
NVIDIA GPU: where their time goes at the training path's shape, with
SDPA's backward and, optionally, an earlier checkout's kernels beside
them.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 tools/flash_bwd_ablation.py [--parent DIR]

Each variant is `csrc/flash_attention_bwd.cu` with text patches, built
into `metal_flash_attention_tpu_torch/build/ablation_bwd/<variant>/` (one
nvcc each, all started together), and timed through the port's own
wrappers with the variant's library in place of the real one:

- `sm90`: the kernels as they are (256 threads: two consumer warpgroups,
  thread 0 issuing the TMA loads);
- `producer`: the other register structure, a third warpgroup that
  issues the ring's loads (setmaxnreg 24) beside two consumer
  warpgroups (setmaxnreg 240): 384 threads, as the forward;
  `producer_dq_bkv64` the same with dQ at 64 keys a tile;
- `dq_bkv64`: dQ at 64 keys a tile instead of MFA_BWD90_DQ_BLOCK_KV
  (dK/dV as `sm90`);
- `stages3_dq_bkv64`: three stages in the ring instead of
  MFA_BWD90_STAGES, dQ at 64 keys a tile (three stages of 128 keys do
  not fit its shared memory);
- `dkv_no_lse_reads`: dK/dV taking each column's L and D as 0 instead
  of reading them from the warp's scratch (which the compiler then drops
  with the loads that fill it): the cost of handing L and D to the
  threads that need them;
- `one_tile`: each dQ block takes only its last key tile, each dK/dV
  block only its first query tile of each q head: a block's fixed cost
  (the kept operands' load, the first steps, the epilogue).

Every variant but the last two computes the backward (each is held
against `sm90` by the worst 64-row tile); those two are for their
times.  With
--parent DIR, the backward of the checkout at DIR (for example the parent
commit, unpacked with `git archive`) runs in a process of its own before
and after the variants.  A time is `chip_smoke.timed_spread`'s: the
median, min and max device ms a call over 5 profiled loops.  Prints the
card's name and power limit, then one JSON line a variant with ptxas's
registers, spills and wgmma notes (C75xx) for each kernel.
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
# The training path's attention: batch, q heads, kv heads, tokens; causal,
# head_dim 128, bf16; calls a loop.
SHAPE = (1, 32, 8, 8192)
ITERS = 10
# The producer warpgroup: the third warpgroup's thread 256 refills the
# ring (steps kS on; thread 0 still loads the kept operands and the first
# kS steps), and the consumers stop refilling it themselves.
PRODUCER_BRANCH = """\
  if (__shfl_sync(0xffffffff, tid / 128, 0) == 2) {
    setmaxnreg_dec<24>();
    if (tid == 256)
      for (int i = kS; i < n_steps; ++i) {
        mbar_wait(&empty[i % kS], (i / kS - 1) & 1);
        load_step(i);
      }
    return;
  }
  setmaxnreg_inc<240>();
"""
WG = "  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);\n"
PRODUCER = [
    ("constexpr int kThreads = 256;  // two consumer warpgroups",
     "constexpr int kThreads = 384;"),
    ("constexpr int kWarps = kThreads / 32;", "constexpr int kWarps = 8;"),
    ("    if (tid == 0 && i >= 1 && i - 1 + kS < n_steps) {",
     "    if (false) {"),
    (WG, PRODUCER_BRANCH + WG)]
DQ_BKV64 = [("constexpr int kDqKeys = MFA_BWD90_DQ_BLOCK_KV;",
             "constexpr int kDqKeys = 64;")]
VARIANTS = {
    "sm90": [],
    "producer": PRODUCER,
    "producer_dq_bkv64": PRODUCER + DQ_BKV64,
    "dq_bkv64": DQ_BKV64,
    "stages3_dq_bkv64": DQ_BKV64 + [(
        "constexpr int kStages = MFA_BWD90_STAGES;",
        "constexpr int kStages = 3;")],
    "dkv_no_lse_reads": [
        ("scratch[tid / 32][0][4 * j + t4];", "make_float2(0.f, 0.f);"),
        ("scratch[tid / 32][1][4 * j + t4];", "make_float2(0.f, 0.f);")],
    "one_tile": [
        ("  const int n_lo = col_lo / kDqKeys;",
         "  const int n_lo = max(col_lo / kDqKeys, col_hi / kDqKeys);"),
        ("  const int m_hi = t_hi >= t_lo ? t_hi / kR + 1 : m_lo;",
         "  const int m_hi = t_hi >= t_lo ? m_lo + 1 : m_lo;")],
}


def apply(text: str, patches: list, name: str) -> str:
    """Each patch replaces every occurrence of a string."""
    for old, new in patches:
        if old not in text:
            raise RuntimeError(f"variant {name}: flash_attention_bwd.cu no "
                               f"longer holds {old!r}")
        text = text.replace(old, new)
    return text


# Times the backward pair of the package found from the working
# directory.
TIME_TREE = """
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke
from metal_flash_attention_tpu_torch.ops import flash_attention as fa
from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb
b, qh, kvh, n = json.loads(sys.argv[1])
g = torch.Generator(device="cuda").manual_seed(int(sys.argv[2]))
q, k, v, do = (torch.randn((b, h, n, 128), generator=g, device="cuda")
               .to(torch.bfloat16) for h in (qh, kvh, kvh, qh))
o, lse = fa.flash_attention_forward(q, k, v, causal=True)
d_term = (do.float() * o.float()).sum(dim=-1)
kw = dict(causal=True, window_size=None, scale=128 ** -0.5)
iters = int(sys.argv[3])
print(json.dumps({
    "dq": chip_smoke.timed_spread(
        lambda: fb._dq_cuda(q, k, v, do, lse, d_term, **kw), iters),
    "dkv": chip_smoke.timed_spread(
        lambda: fb._dkv_cuda(q, k, v, do, lse, d_term, **kw), iters)}))
"""


def kernel_label(mangled: str) -> str:
    return (("dkv " if "dkv90" in mangled else "dq ")
            + ("fp16" if "6__half" in mangled else "bf16")
            + (" D128" if "Li128E" in mangled else " D64"))


def ptxas_summary(log: str) -> dict:
    """ptxas's registers, spills and notes (C75xx) for each kernel of a
    build log."""
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


def build_variants() -> tuple[dict, dict]:
    """({variant: bound library}, {variant: ptxas summary}), one nvcc
    each, all started together."""
    from metal_flash_attention_tpu_torch.native import build as nb
    from metal_flash_attention_tpu_torch.ops.flash_attention_bwd import (
        bind_library,
    )

    with open(os.path.join(nb.SRC_DIR, "flash_attention_bwd.cu")) as f:
        source = f.read()
    procs = {}
    for name, patches in VARIANTS.items():
        out_dir = os.path.join(nb.BUILD_DIR, "ablation_bwd", name)
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(out_dir, "flash_attention_bwd.cu")
        with open(src, "w") as f:
            f.write(apply(source, patches, name))
        procs[name] = subprocess.Popen(
            [nb._nvcc(), *nb.NVCC_FLAGS, "-I", nb.SRC_DIR, "-o",
             os.path.join(out_dir, "libflash_attention_bwd.so"), src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, ptxas = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=nb.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} did not build:\n{log}")
        ptxas[name] = ptxas_summary(log)
        libs[name] = bind_library(ctypes.CDLL(os.path.join(
            nb.BUILD_DIR, "ablation_bwd", name, "libflash_attention_bwd.so")))
    return libs, ptxas


def time_tree(path: str) -> dict:
    """The backward pair of the checkout at `path`, in a process of its
    own."""
    run = subprocess.run(
        [sys.executable, "-c", TIME_TREE, json.dumps(SHAPE), str(SEED),
         str(ITERS)], cwd=path, capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"the backward of {path} failed:\n{run.stderr}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a checkout whose backward to time "
                        "before and after the variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from metal_flash_attention_tpu_torch.ops import flash_attention as fa
    from metal_flash_attention_tpu_torch.ops import flash_attention_bwd as fb

    print(chip_smoke.card_line(), flush=True)
    if args.parent:
        print(json.dumps({"variant": "parent (first)",
                          "ms": time_tree(args.parent)}), flush=True)
    libs, ptxas = build_variants()
    b, qh, kvh, n = SHAPE
    g = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, do = (torch.randn((b, h, n, 128), generator=g, device="cuda")
                   .to(torch.bfloat16) for h in (qh, kvh, kvh, qh))
    o, lse = fa.flash_attention_forward(q, k, v, causal=True)
    d_term = (do.float() * o.float()).sum(dim=-1)
    kw = dict(causal=True, window_size=None, scale=128 ** -0.5)
    ref = None
    for name, lib in libs.items():
        fb._kernel_library = lambda lib=lib: lib
        row = {"dq": chip_smoke.timed_spread(
                   lambda: fb._dq_cuda(q, k, v, do, lse, d_term, **kw),
                   ITERS),
               "dkv": chip_smoke.timed_spread(
                   lambda: fb._dkv_cuda(q, k, v, do, lse, d_term, **kw),
                   ITERS)}
        err = {}
        if name not in ("dkv_no_lse_reads", "one_tile"):
            grads = (fb._dq_cuda(q, k, v, do, lse, d_term, **kw),
                     *fb._dkv_cuda(q, k, v, do, lse, d_term, **kw))
            ref = ref or grads
            err = {key: chip_smoke.closeness(got, want)["tile_rel_rms"]
                   for key, got, want in zip(("dq", "dk", "dv"), grads, ref)}
        print(json.dumps({"variant": name, "ms": row,
                          "tile_rel_rms_vs_sm90": err,
                          "ptxas": ptxas[name]}), flush=True)
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    sdpa_o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                            enable_gqa=True)
    print(json.dumps({"variant": "sdpa backward", "ms": {
        "dq_dk_dv": chip_smoke.timed_spread(lambda: torch.autograd.grad(
            sdpa_o, leaves, do, retain_graph=True), ITERS)}}), flush=True)
    if args.parent:
        print(json.dumps({"variant": "parent (last)",
                          "ms": time_tree(args.parent)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
