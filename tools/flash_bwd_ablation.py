#!/usr/bin/env python3
"""Variants of the flash-attention backward kernels (dQ and dK/dV) on one
NVIDIA GPU: where their time goes at the two training paths' shapes
(Llama-3-8B's head_dim 128, uncapped; Gemma-2's head_dim 256 with the
soft cap), with SDPA's backward and, optionally, an earlier checkout's
kernels beside them.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 tools/flash_bwd_ablation.py [--parent DIR] [--variants A,B]

Each variant is `csrc/flash_attention_bwd.cu` with `-D` tile defines
(`csrc/flash_tiles.cuh`) and text patches, built with every
instantiation (head dims 64, 128 and 256, with and without the cap)
into `metal_flash_attention_tpu_torch/build/ablation_bwd/<variant>/` (one
nvcc each, all started together), and timed through the port's own
wrappers with the variant's library in place of the real one, at both
shapes:

- `sm90`: the kernels as they are (D 64 / 128: two consumer warpgroups
  of 64 rows, thread 0 issuing the TMA loads; D 256: dQ one warpgroup,
  dK/dV two over 64 keys splitting D);
- `dq_bkv64`: dQ at 64 keys a tile at D 64 / 128 instead of
  MFA_BWD90_DQ_BLOCK_KV (D 256 takes 64 already);
- `stages3_dq_bkv64`: three stages in the ring instead of
  MFA_BWD90_STAGES, dQ at 64 keys a tile (three stages of 128 keys do
  not fit its shared memory; D 256 keeps its two);
- `dkv_no_lse_reads`: dK/dV taking each column's L and D as 0 instead
  of reading them from the warp's scratch (which the compiler then drops
  with the loads that fill it): the cost of handing L and D to the
  threads that need them;
- `one_tile`: each dQ block takes only its last key tile, each dK/dV
  block only its first query tile of each q head: a block's fixed cost
  (the kept operands' load, the first steps, the epilogue).

Every variant but the last two computes the backward (each is held
against `sm90` by the worst 64-row tile); those two are for their
times.  (A third, producer warpgroup issuing the ring's loads was
slower and spilled at D 128, PERF.md §6; it has no variant here.)
--variants builds and times only the named ones.  With --parent DIR,
the backward of the checkout at DIR (for example the parent commit,
unpacked with `git archive`) runs at both shapes in a process of its
own before and after the variants.
A time is `chip_smoke.timed_spread`'s: the median, min and max device ms
a call over 5 profiled loops.  Prints the card's name and power limit,
then one JSON line a variant and shape with ptxas's registers, spills
and wgmma notes (C75xx) for each kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 0
# The training paths' attention: batch, q heads, kv heads, tokens,
# head_dim, soft cap; causal, bf16.  Llama-3-8B's (the parent's kernels
# are timed there too) and Gemma-2's (gemma2_2b, a global layer).
SHAPES = {"llama_d128": (1, 32, 8, 8192, 128, None),
          "gemma_d256_cap50": (1, 8, 4, 8192, 256, 50.0)}
ITERS = 10
DQ_BKV64 = ["-DMFA_BWD90_DQ_BLOCK_KV=64"]
# Each variant: (-D defines, text patches).
VARIANTS = {
    "sm90": ([], []),
    "dq_bkv64": (DQ_BKV64, []),
    "stages3_dq_bkv64": (DQ_BKV64 + ["-DMFA_BWD90_STAGES=3"], []),
    "dkv_no_lse_reads": ([], [
        ("scratch[tid / 32][0][4 * j + t4];", "make_float2(0.f, 0.f);"),
        ("scratch[tid / 32][1][4 * j + t4];", "make_float2(0.f, 0.f);")]),
    "one_tile": ([], [
        ("  const int n_lo = col_lo / kDqKeys;",
         "  const int n_lo = max(col_lo / kDqKeys, col_hi / kDqKeys);"),
        ("  const int m_hi = t_hi >= t_lo ? t_hi / kR + 1 : m_lo;",
         "  const int m_hi = t_hi >= t_lo ? m_lo + 1 : m_lo;")]),
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
out = {}
for name, (b, qh, kvh, n, d, cap) in json.loads(sys.argv[1]).items():
    g = torch.Generator(device="cuda").manual_seed(int(sys.argv[2]))
    q, k, v, do = (torch.randn((b, h, n, d), generator=g, device="cuda")
                   .to(torch.bfloat16) for h in (qh, kvh, kvh, qh))
    o, lse = fa.flash_attention_forward(q, k, v, causal=True,
                                        logit_softcap=cap)
    d_term = (do.float() * o.float()).sum(dim=-1)
    kw = dict(causal=True, window_size=None, scale=d ** -0.5, softcap=cap)
    iters = int(sys.argv[3])
    out[name] = {
        "dq": chip_smoke.timed_spread(
            lambda: fb._dq_cuda(q, k, v, do, lse, d_term, **kw), iters),
        "dkv": chip_smoke.timed_spread(
            lambda: fb._dkv_cuda(q, k, v, do, lse, d_term, **kw), iters)}
print(json.dumps(out))
"""


def kernel_label(mangled: str) -> str:
    d = next(f" D{d}" for d in (64, 128, 256) if f"Li{d}E" in mangled)
    # The last template arguments, kCap and kAux, mangle as Lb1E / Lb0E.
    cap, aux = re.search(r"Lb([01])ELb([01])EEEv", mangled).groups()
    return (("dkv " if "dkv90" in mangled else "dq ")
            + ("fp16" if "6__half" in mangled else "bf16") + d
            + (" cap" if cap == "1" else "") + (" aux" if aux == "1" else ""))


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


def build_variants(names) -> tuple[dict, dict]:
    """({variant: bound library}, {variant: ptxas summary}) of the named
    variants, one nvcc each, all started together."""
    from metal_flash_attention_tpu_torch.native import build as nb
    from metal_flash_attention_tpu_torch.ops.flash_attention_bwd import (
        bind_library,
    )

    with open(os.path.join(nb.SRC_DIR, "flash_attention_bwd.cu")) as f:
        source = f.read()
    jobs = {}
    for name in names:
        defines, patches = VARIANTS[name]
        out_dir = os.path.join(nb.BUILD_DIR, "ablation_bwd", name)
        os.makedirs(out_dir, exist_ok=True)
        src = os.path.join(out_dir, "flash_attention_bwd.cu")
        with open(src, "w") as f:
            f.write(apply(source, patches, name))
        jobs[name] = (src, os.path.join(out_dir, "libflash_attention_bwd.so"),
                      defines)
    logs = nb.compile_sources(jobs)
    libs, ptxas = {}, {}
    for name, (_, lib, _) in jobs.items():
        ptxas[name] = ptxas_summary(logs[name])
        libs[name] = bind_library(ctypes.CDLL(lib))
    return libs, ptxas


def time_tree(path: str) -> dict:
    """The backward pair of the checkout at `path`, in a process of its
    own."""
    run = subprocess.run(
        [sys.executable, "-c", TIME_TREE, json.dumps(SHAPES), str(SEED),
         str(ITERS)],
        cwd=path, capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"the backward of {path} failed:\n{run.stderr}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch
    import torch.nn.functional as F

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a checkout whose backward to time "
                        "before and after the variants")
    parser.add_argument("--variants", default=",".join(VARIANTS),
                        help="the variants to build and time, by name")
    args = parser.parse_args()
    names = args.variants.split(",")
    unknown = set(names) - set(VARIANTS)
    if unknown:
        parser.error(f"no variants {sorted(unknown)}")
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
    libs, ptxas = build_variants(names)
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for shape, (b, qh, kvh, n, d, cap) in SHAPES.items():
        q, k, v, do = (torch.randn((b, h, n, d), generator=g, device="cuda")
                       .to(torch.bfloat16) for h in (qh, kvh, kvh, qh))
        o, lse = fa.flash_attention_forward(q, k, v, causal=True,
                                            logit_softcap=cap)
        d_term = (do.float() * o.float()).sum(dim=-1)
        kw = dict(causal=True, window_size=None, scale=d ** -0.5,
                  softcap=cap)
        ref = None
        for name, lib in libs.items():
            fb._kernel_library = lambda *_, lib=lib: lib
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
                       for key, got, want in zip(("dq", "dk", "dv"), grads,
                                                 ref)}
            print(json.dumps({"variant": name, "shape": shape, "ms": row,
                              "tile_rel_rms_vs_sm90": err,
                              "ptxas": ptxas[name]}), flush=True)
        if cap is None:
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            sdpa_o = F.scaled_dot_product_attention(*leaves, is_causal=True,
                                                    enable_gqa=True)
            print(json.dumps({"variant": "sdpa backward", "shape": shape,
                              "ms": {"dq_dk_dv": chip_smoke.timed_spread(
                                  lambda: torch.autograd.grad(
                                      sdpa_o, leaves, do, retain_graph=True),
                                  ITERS)}}), flush=True)
            del leaves, sdpa_o
        del q, k, v, do, o, lse, d_term, ref
        torch.cuda.empty_cache()
    if args.parent:
        print(json.dumps({"variant": "parent (last)",
                          "ms": time_tree(args.parent)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
