#!/usr/bin/env python3
"""Variants of the decode-family kernels (`flash_decode`, and the paged
kernel's decode and chunked-prefill modes) on one NVIDIA GPU: where
their time goes at `chip_smoke.py`'s shapes, with SDPA and, optionally,
an earlier checkout's kernels beside them.

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit:

    python3 tools/decode_ablation.py [--parent DIR]

Each variant is `csrc/flash_decode.cu` and `csrc/paged_attention.cu`
built with `-D` defines (over those of `csrc/flash_tiles.cuh`) into
`metal_flash_attention_tpu_torch/build/ablation_decode/<variant>/` (one
nvcc a library, all started together), or the tree's own build with
other chunks forced on the wrappers:

- `ring`: the kernels as they are (a 2-stage decode ring and a 3-stage
  prefill ring, tensor cores, each call's chunk as `decode_splits` picks
  it);
- `stages2`, `stages3`, `stages4`: two, three or four stages in both
  rings;
- `chunk_small`, `chunk_large`, `chunk_mid`: fixed chunks beside the
  ones picked at these shapes (decode 512 / 2048 keys, paged decode 64 /
  256 / 192, prefill 128 / 512 / 384);
- `fma`: bf16 decode on CUDA cores in float32 (`MFA_DECODE_MMA=0`, the
  fp32 path) instead of tensor cores; the prefill kernel is unchanged.

Each variant runs in a process of its own, with its libraries bound in
place of the tree's; with --parent DIR, the checkout at DIR (for example
the parent commit, unpacked with `git archive`) runs the same script with
its own wrappers and kernels, before and after the variants.  Shapes (as
in `chip_smoke.py`): `flash_decode` at q [8, 32, 128], K/V [8, 8, 8192,
128] bf16 with the ragged `DECODE_LENS` and at full lengths; the paged
decode at q [4, 32, 128] with lengths 1132, 232, 677, 962 and the prefill
at q [1, 32, 128, 128] against 1,024 tokens (page size 128), both timed
cold over a rotation of pools whose reads exceed twice the L2.  A time is
`chip_smoke.timed_spread`'s: the median, min and max device ms a call
over 5 profiled loops.  Every variant's outputs are held against the plain
versions by `chip_smoke.closeness` (worst tile's relative rms), and one
more profiled loop of each op splits its time by kernel (the attention
kernel, the merge of its splits).  Prints the card's name and power
limit, then one JSON line a variant with ptxas's registers and spills
for each kernel.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SEED = 0
SOURCES = ("flash_decode", "paged_attention")
# name -> (-D defines, {op: forced chunk in keys})
VARIANTS = {
    "ring": ({}, {}),
    "stages2": ({"MFA_DECODE_STAGES": 2, "MFA_PAGED_STAGES": 2}, {}),
    "stages3": ({"MFA_DECODE_STAGES": 3, "MFA_PAGED_STAGES": 3}, {}),
    "stages4": ({"MFA_DECODE_STAGES": 4, "MFA_PAGED_STAGES": 4}, {}),
    "chunk_small": ({}, {"flash_decode": 512, "paged_decode": 64,
                         "paged_prefill": 128}),
    "chunk_large": ({}, {"flash_decode": 2048, "paged_decode": 256,
                         "paged_prefill": 512}),
    "chunk_mid": ({}, {"paged_decode": 192, "paged_prefill": 384}),
    "fma": ({"MFA_DECODE_MMA": 0}, {}),
}

# Times the three ops of the package found from the working directory.
# argv: a JSON object {"libs": dir or null, "chunks": {op: keys},
# "seed": int}.  With "libs", the libraries there replace the tree's.
TIME_TREE = r'''
import ctypes, itertools, json, os, sys
import torch
import torch.nn.functional as F
sys.path.insert(0, ".")
import chip_smoke as cs
from metal_flash_attention_tpu_torch.ops import flash_decode as fd
from metal_flash_attention_tpu_torch.ops import paged_attention as pa
from metal_flash_attention_tpu_torch.utils.shapes import cdiv

args = json.loads(sys.argv[1])
if args["libs"]:
    fd._kernel_library = lambda: fd.bind_library(ctypes.CDLL(
        os.path.join(args["libs"], "libflash_decode.so")))
    pa._kernel_library = lambda: pa.bind_library(ctypes.CDLL(
        os.path.join(args["libs"], "libpaged_attention.so")))
picked = {}
real_splits = pa.decode_splits
# A tree from before the fixed chunks (its decode_splits takes a split
# count, not a chunk) runs as it is.
chunked = hasattr(pa, "split_scratch")


def forced(op):
    """decode_splits with op's chunk forced (when the variant sets one);
    records the chunk each op runs with."""
    def pick(pairs, max_tokens, sm_count, tile, max_chunk, **kw):
        chunk = args["chunks"].get(op)
        if chunk is None:
            chunk, splits = real_splits(pairs, max_tokens, sm_count, tile,
                                        max_chunk, **kw)
        else:
            splits = max(1, cdiv(cdiv(max_tokens, tile), chunk // tile))
        picked[op] = [chunk, splits]
        return chunk, splits
    return pick


dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(args["seed"])
d, kvh, qh, page = 128, 8, 32, 128


def randn(*shape):
    return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)


def pools(lengths):
    max_pages = -(-max(lengths) // page)
    n = len(lengths) * max_pages + 1
    k, v = randn(n, kvh, page, d), randn(n, kvh, page, d)
    perm = torch.randperm(n - 1, generator=gen, device=dev).int() + 1
    return pa.PagedKVCache(k, v, perm.reshape(len(lengths), max_pages),
                           torch.tensor(lengths, dtype=torch.int32,
                                        device=dev))


def rotation(lengths):
    per_call = sum(lengths) * kvh * d * 4
    return [pools(lengths) for _ in range(-(-2 * 50 * 2**20 // per_call))]


def cycling(fn, q, caches):
    turn = itertools.cycle(caches)
    return lambda: fn(q, next(turn))


def by_kernel(fn, iters):
    """Device ms a call of each kernel `fn` launches, over one profiled
    loop."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in cs.device_kernels(prof):
        name = e.name.split("<")[0].split("::")[-1].split("(")[0]
        out[name] = out.get(name, 0.0) + e.device_time_total / 1e3 / iters
    return out


out = {}
# flash_decode at the generate shape.
q, k, v = randn(8, qh, d), randn(8, kvh, 8192, d), randn(8, kvh, 8192, d)
lens = torch.tensor(cs.DECODE_LENS, dtype=torch.int32, device=dev)
full = torch.full((8,), 8192, dtype=torch.int32, device=dev)
if chunked:
    fd.decode_splits = forced("flash_decode")
o = fd.flash_decode(q, k, v, kv_lens=lens)
po, _ = fd._flash_decode_plain(q, k, v, kv_lens=lens, kv_starts=None,
                               max_span=None, scale=d ** -0.5)
out["flash_decode"] = {
    "ragged": cs.timed_spread(lambda: fd.flash_decode(q, k, v, kv_lens=lens),
                              50),
    "full": cs.timed_spread(lambda: fd.flash_decode(q, k, v, kv_lens=full),
                            50),
    "by_kernel": by_kernel(lambda: fd.flash_decode(q, k, v, kv_lens=lens),
                           50),
    "tile_rel_rms": cs.closeness(o[:, :, None], po[:, :, None])[
        "tile_rel_rms"]}
if args.get("sdpa"):
    mask = (torch.arange(8192, device=dev)[None, :]
            < lens[:, None].long())[:, None, None, :]
    out["sdpa"] = {
        "ragged": cs.timed_spread(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True), 20),
        "full": cs.timed_spread(lambda: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=torch.ones_like(mask),
            enable_gqa=True), 20)}
del q, k, v, o, po
torch.cuda.empty_cache()
# The paged modes, cold.
for op, fn, lengths, qshape in (
        ("paged_decode", pa.paged_decode, [1132, 232, 677, 962],
         (4, qh, d)),
        ("paged_prefill", pa.paged_prefill, [1024], (1, qh, page, d))):
    if chunked:
        pa.decode_splits = forced(op)
    q = randn(*qshape)
    caches = rotation(lengths)
    o = fn(q, caches[0])
    q4 = q if q.dim() == 4 else q[:, :, None]
    po, _ = pa._paged_attention_plain(q4, caches[0], scale=d ** -0.5,
                                      window_size=None)
    out[op] = {"cold": cs.timed_spread(cycling(fn, q, caches),
                                       4 * len(caches)),
               "warm": cs.timed_spread(lambda: fn(q, caches[0]), 50),
               "by_kernel": by_kernel(cycling(fn, q, caches),
                                      4 * len(caches)),
               "pools": len(caches),
               "tile_rel_rms": cs.closeness(o, po.reshape(o.shape))[
                   "tile_rel_rms"]}
    del caches
    torch.cuda.empty_cache()
out["chunks"] = picked
print(json.dumps(out))
'''


def ptxas_summary(log: str) -> dict:
    """ptxas's registers and spills for each kernel of a build log."""
    rows, current = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            current = line.split("'")[1]
            rows[current] = {}
        elif current and "spill stores" in line:
            rows[current]["spills"] = line.split(":")[-1].strip()
        elif current and "Used" in line and "registers" in line:
            rows[current]["registers"] = int(
                line.split("Used ")[1].split()[0])
    return rows


def build_variants() -> tuple[dict, dict]:
    """({variant: library directory or None}, {variant: ptxas summary}):
    one nvcc a library of each variant with defines, all started
    together; the others use the tree's own build."""
    from metal_flash_attention_tpu_torch.native import build as nb

    nb.build_all(list(SOURCES))
    procs, dirs, ptxas = {}, {}, {}
    for name, (defines, _) in VARIANTS.items():
        if not defines:
            dirs[name] = None
            ptxas[name] = {src: ptxas_summary(open(os.path.join(
                nb.BUILD_DIR, f"lib{src}.log")).read()) for src in SOURCES}
            continue
        out_dir = os.path.join(nb.BUILD_DIR, "ablation_decode", name)
        os.makedirs(out_dir, exist_ok=True)
        dirs[name] = out_dir
        flags = [f"-D{key}={value}" for key, value in defines.items()]
        for src in SOURCES:
            procs[name, src] = subprocess.Popen(
                [nb._nvcc(), *nb.NVCC_FLAGS, *flags, "-o",
                 os.path.join(out_dir, f"lib{src}.so"),
                 os.path.join(nb.SRC_DIR, f"{src}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (name, src), proc in procs.items():
        log, _ = proc.communicate(timeout=nb.NVCC_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} ({src}.cu) did not "
                               f"build:\n{log}")
        ptxas.setdefault(name, {})[src] = ptxas_summary(log)
    return dirs, ptxas


def time_tree(path: str, libs=None, chunks=None, sdpa=False) -> dict:
    """The three ops of the checkout at `path`, in a process of its own."""
    arg = json.dumps({"libs": libs, "chunks": chunks or {}, "seed": SEED,
                      "sdpa": sdpa})
    run = subprocess.run([sys.executable, "-c", TIME_TREE, arg], cwd=path,
                         capture_output=True, text=True, timeout=900)
    if run.returncode != 0:
        raise RuntimeError(f"timing {path} failed:\n{run.stderr[-4000:]}")
    return json.loads(run.stdout.strip().splitlines()[-1])


def main() -> int:
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--parent", help="a checkout whose decode kernels "
                        "to time before and after the variants")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("decode_ablation: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke

    print(chip_smoke.card_line(), flush=True)
    if args.parent:
        print(json.dumps({"variant": "parent (first)",
                          "ms": time_tree(args.parent)}), flush=True)
    dirs, ptxas = build_variants()
    for name, (_, chunks) in VARIANTS.items():
        print(json.dumps({"variant": name, "ms": time_tree(
            ROOT, dirs[name], chunks, sdpa=name == "ring"),
            "ptxas": ptxas[name]}), flush=True)
    if args.parent:
        print(json.dumps({"variant": "parent (last)",
                          "ms": time_tree(args.parent)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
