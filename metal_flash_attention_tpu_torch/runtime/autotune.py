"""Tile autotuner.

The port of the JAX package's `runtime/autotune.py`: a sweep builds the
candidates, runs each on the card, and keeps the fastest in the config
cache (`KernelConfigCache`), where `select_block_sizes`,
`GEMMDescriptor.kernel_config` and the decode wrappers find it.

On the card a candidate is a tile variant: a library built by nvcc with
`-D` tile values (`native.build.build_variants`; all of a sweep's
variants build together, one nvcc each), so the candidates are the
card's legal tiles (`descriptors.parameters.legal_tiles`), not the
TPU's blocks:

- the forward at head_dim 64/128: the four tiles of {64, 128}^2;
- the backward pair: dQ x dK/dV tile pairs, judged together (both
  kernels' outputs consumed), as the JAX package judges them; at head_dim
  64/128 dK/dV has one legal tile, so the pairs vary dQ's;
- the GEMM's sm90 route: the tiles of {128, 256}^2 it takes;
- the decode kernels: the cap on the split-KV chunk (``block_kv`` for
  `flash_decode`, ``pages_per_chunk`` for `paged_decode`), which needs
  no rebuild.

Every candidate's output is first held against the plain version on the
same inputs (``check``; by default the worst 64-row tile's relative rms
within KERNEL_TILE_REL_RMS and lse within MIXED_TOL): a candidate that
fails is an error, never a winner, and so is a launch on the card that
took another tile than the one asked for.  Then `_loop_timed` times it
with CUDA events, after one untimed launch.  A CPU tensor builds
nothing (its calls run the plain versions; tests time them with a fake
timer).
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence

import torch

from metal_flash_attention_tpu_torch.runtime.cache import KernelConfigCache
from metal_flash_attention_tpu_torch.utils.device import resolve_device
from metal_flash_attention_tpu_torch.utils.tolerances import (
    KERNEL_TILE_REL_RMS,
    MIXED_TOL,
    max_abs_err,
    worst_tile_rel_rms,
)

# Tiles a forward sweep tries at head_dim 64/128, and dQ tiles of a
# backward sweep (the legal ones of each at the call's head dim).
FORWARD_CANDIDATES: tuple[tuple[int, int], ...] = (
    (128, 128), (64, 128), (128, 64), (64, 64))
DQ_CANDIDATES = FORWARD_CANDIDATES
GEMM_CANDIDATES: tuple[tuple[int, int], ...] = (
    (128, 256), (256, 128), (128, 128))
DECODE_CANDIDATES: tuple[int, ...] = (1024, 2048, 4096, 8192)
PAGED_CANDIDATES: tuple[int, ...] = (4, 8, 16, 32, 64)
# Bytes of float32 scores one chunk of heads of the plain versions holds.
PLAIN_CHUNK_BYTES = 2 ** 31


def _loop_timed(fn: Callable, args, *, iters: int, repeats: int) -> float:
    """Seconds a call of fn(*args): one untimed call, then the best of
    ``repeats`` runs of ``iters`` back-to-back calls between CUDA events
    (host clock on the CPU)."""
    fn(*args)
    cuda = torch.cuda.is_available() and any(
        isinstance(a, torch.Tensor) and a.is_cuda for a in args)
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn(*args)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn(*args)
            best = min(best, time.perf_counter() - t0)
    return best / iters


def _build_variants(variants) -> float:
    """Build the (name, defines) libraries together; returns seconds."""
    from metal_flash_attention_tpu_torch.native.build import build_variants

    t0 = time.perf_counter()
    build_variants(variants)
    return time.perf_counter() - t0


def build_candidates(variants, device, verbose: bool = False) -> float:
    """Build a sweep's variant libraries on the card, one nvcc each, all
    started together (nothing on the CPU); returns the seconds."""
    variants = [v for v in dict.fromkeys(variants) if v[1]]
    if device.type != "cuda" or not variants:
        return 0.0
    seconds = _build_variants(variants)
    if verbose:
        print(f"  build: {len(variants)} variant libraries in "
              f"{seconds:.1f} s", flush=True)
    return seconds


def default_check(got: dict, ref: dict) -> dict:
    """The kernel's tier against the plain version: every output's worst
    64-row tile within KERNEL_TILE_REL_RMS, lse within MIXED_TOL.lse.
    Returns the readings; raises AssertionError on a failure."""
    readings = {}
    for name, t in got.items():
        if name == "lse":
            readings[name] = max_abs_err(t, ref[name])
            ok = readings[name] <= MIXED_TOL.lse
        else:
            readings[name] = worst_tile_rel_rms(t, ref[name])
            ok = readings[name] <= KERNEL_TILE_REL_RMS
        if not ok:
            raise AssertionError(f"{name}: {readings[name]:.4g} beyond the "
                                 "kernel's tier")
    return readings


def _checked(check, candidate, got: dict, ref: dict) -> None:
    """Hold one candidate to its plain version; raise RuntimeError naming
    it otherwise."""
    try:
        check(got, ref)
    except AssertionError as e:
        raise RuntimeError(f"autotune candidate {candidate} failed its "
                           f"check against the plain version: {e}") from e


def _launched(counts: dict, before: dict, name: str, tile,
              candidate) -> None:
    """On the card: raise unless ``name`` launched ``tile`` once, and
    nothing else, since ``before`` (a copy of its tile counts)."""
    new = {t: n - before.get(t, 0) for t, n in counts[name].items()
           if n != before.get(t, 0)}
    if new != {tuple(tile): 1}:
        raise RuntimeError(f"autotune candidate {candidate}: {name} "
                           f"launched {new}, not {tile} once")


def _plain_attention(kernel_type, q, k, v, do, causal) -> dict:
    """The plain versions of the forward (o, lse) or the backward (dq,
    dk, dv), a chunk of heads at a time so that float32 scores stay
    within PLAIN_CHUNK_BYTES."""
    from metal_flash_attention_tpu_torch.ops.flash_attention import (
        _forward_plain,
    )
    from metal_flash_attention_tpu_torch.ops.flash_attention_bwd import (
        _backward_plain,
    )

    n, kv = q.shape[2], k.shape[2]
    per = 4 if kernel_type == "forward" else 8
    step = max(1, PLAIN_CHUNK_BYTES // (per * n * kv * 4))
    names = ("o", "lse") if kernel_type == "forward" else ("dq", "dk", "dv")
    parts = {name: [] for name in names}
    scale = q.shape[-1] ** -0.5
    for h in range(0, q.shape[1], step):
        sl = slice(h, h + step)
        if kernel_type == "forward":
            out = _forward_plain(q[:, sl], k[:, sl], v[:, sl], causal=causal,
                                 window_size=None, scale=scale,
                                 out_dtype=q.dtype)
        else:
            out = _backward_plain(q[:, sl], k[:, sl], v[:, sl], do[:, sl],
                                  causal=causal, window_size=None,
                                  scale=scale)
        for name, t in zip(names, out):
            parts[name].append(t)
    return {name: torch.cat(ts, dim=1) for name, ts in parts.items()}


def attention_candidates(kernel_type: str, head_dim: int) -> list:
    """The default candidates: legal forward tiles, or (dQ tile, dK/dV
    tile) pairs over dQ's legal tiles beside dK/dV's table tile (its one
    legal tile at every head dim the kernels take), the table's first."""
    from metal_flash_attention_tpu_torch.descriptors import parameters as P

    base = P.select_block_sizes(kernel_type, head_dim, "bfloat16")
    if kernel_type == "forward":
        legal = P.legal_tiles("forward", head_dim)
        return [base] + [t for t in FORWARD_CANDIDATES
                         if t in legal and t != base]
    dq0 = P.select_block_sizes("backward_query", head_dim, "bfloat16")
    dkv0 = P.select_block_sizes("backward_key_value", head_dim, "bfloat16")
    dq_legal = P.legal_tiles("backward_query", head_dim)
    return [(dq0, dkv0)] + [(t, dkv0) for t in DQ_CANDIDATES
                            if t in dq_legal and t != dq0]


def autotune_attention(
    *,
    kernel_type: str = "forward",
    n: int = 4096,
    head_dim: int = 128,
    heads: int = 8,
    dtype=torch.bfloat16,
    causal: bool = False,
    candidates: Optional[Sequence] = None,
    iters: int = 20,
    repeats: int = 3,
    cache: Optional[KernelConfigCache] = None,
    verbose: bool = False,
    device=None,
    generation: Optional[str] = None,
    check: Callable = default_check,
):
    """Measure candidate tiles of the attention kernels on ``device``
    (None: the card) at q/k/v [1, heads, n, head_dim]; returns (winner,
    {candidate: seconds a call}) and records the winner in the config
    cache under the kernel type's key (the "_causal" one for a causal
    sweep, which never overwrites the dense winner).

    ``kernel_type`` "forward": a candidate is a (block_q, block_kv) tile.
    "backward_query" / "backward_key_value": a candidate is a (dQ tile,
    dK/dV tile) pair, timed as `flash_attention_backward` (both kernels)
    on the forward's residuals; the winner is the pair's tile of
    ``kernel_type``, and each kernel's tile lands under its own key."""
    from metal_flash_attention_tpu_torch.ops import (
        flash_attention as fa,
        flash_attention_bwd as fb,
    )

    device = resolve_device(device)
    if kernel_type not in ("forward", "backward_query",
                           "backward_key_value"):
        raise ValueError(f"unknown kernel type {kernel_type!r}")
    backward = kernel_type != "forward"
    if candidates is None:
        candidates = attention_candidates(kernel_type, head_dim)
    candidates = [tuple(map(tuple, c)) if backward else tuple(c)
                  for c in candidates]
    from metal_flash_attention_tpu_torch.descriptors import parameters as P
    variants = []
    for c in candidates:
        for kind, tile in ((("backward_query", c[0]),
                            ("backward_key_value", c[1])) if backward
                           else (("forward", c),)):
            lib = P.tile_library(kind, *tile, head_dim)
            name = "flash_attention_bwd" if backward else "flash_attention"
            variants.append((name, lib))
    build_candidates(variants, device, verbose)

    g = torch.Generator(device=device).manual_seed(0)
    q, k, v = (torch.randn((1, heads, n, head_dim), generator=g,
                           device=device).to(dtype) for _ in range(3))
    do = o0 = lse0 = None
    if backward:
        do = torch.randn((1, heads, n, head_dim), generator=g,
                         device=device).to(dtype)
        o0, lse0 = fa.flash_attention_forward(q, k, v, causal=causal)
    ref = _plain_attention("backward" if backward else "forward", q, k, v,
                           do, causal)
    on_card = device.type == "cuda"

    results = {}
    for c in candidates:
        if backward:
            tiles = dict(backward_query=c[0], backward_key_value=c[1])

            def one(q, k, v, tiles=tiles):
                return fb._backward(q, k, v, do, o0, lse0, causal=causal,
                                    window_size=None, scale=None,
                                    tiles=tiles)[:3]
            before = {n: dict(t) for n, t in fb.LAUNCH_TILES.items()}
            dq, dk, dv = one(q, k, v)
            _checked(check, c, dict(dq=dq, dk=dk, dv=dv), ref)
            if on_card:
                for name, tile in zip(("flash_bwd_dq", "flash_bwd_dkv"), c):
                    _launched(fb.LAUNCH_TILES, before[name], name, tile, c)
            del dq, dk, dv
        else:
            def one(q, k, v, c=c):
                return fa.flash_attention_forward(
                    q, k, v, causal=causal, block_q=c[0], block_kv=c[1])
            before = dict(fa.LAUNCH_TILES["flash_fwd"])
            o, lse = one(q, k, v)
            _checked(check, c, dict(o=o, lse=lse), ref)
            if on_card:
                _launched(fa.LAUNCH_TILES, before, "flash_fwd", c, c)
            del o, lse
        results[c] = _loop_timed(one, (q, k, v), iters=iters,
                                 repeats=repeats)
        if verbose:
            print(f"  {c}: {results[c] * 1e3:.4f} ms", flush=True)

    winner = min(results, key=results.get)
    cache = KernelConfigCache.get() if cache is None else cache
    bucket = 1 << (n - 1).bit_length()
    suffix = "_causal" if causal else ""
    if backward:
        for kind, tile in zip(("backward_query", "backward_key_value"),
                              winner):
            cache.insert(cache.attention_key(
                kind + suffix, head_dim, dtype, q_len_bucket=bucket,
                generation=generation), tile)
        return winner[0 if kernel_type == "backward_query" else 1], results
    cache.insert(cache.attention_key(kernel_type + suffix, head_dim, dtype,
                                     q_len_bucket=bucket,
                                     generation=generation), winner)
    return winner, results


def _gemm_sweep(desc, a, b, candidates, *, iters, repeats, cache, verbose,
                device, check, generation=None):
    """Shared body of the GEMM sweeps: build, check against `_gemm_plain`,
    time, record under ``desc.cache_key()``."""
    import importlib

    gm = importlib.import_module("metal_flash_attention_tpu_torch.ops.gemm")
    ops = gm._Operands(*gm._operand_info(a)[:3], *gm._operand_info(b)[:3],
                       desc.m, desc.n, desc.k, desc.transpose_a,
                       desc.transpose_b, False)
    reg = gm._resolve_register_dtype(ops.a.dtype, ops.b.dtype, ops.quant_a,
                                     ops.quant_b, None)
    route = gm._route(ops, reg) if device.type == "cuda" else "sm90"
    configs = {c: desc.kernel_config(route, block_m=c[0], block_n=c[1])
               for c in map(tuple, candidates)}
    build_candidates([("gemm", cfg.library) for cfg in configs.values()],
                     device, verbose)
    kw = dict(transpose_a=desc.transpose_a, transpose_b=desc.transpose_b)
    ref = {"out": gm._gemm_plain(a, b, **kw)}
    results = {}
    for c, cfg in configs.items():
        def one(a, b, c=c):
            return gm.gemm(a, b, block_m=c[0], block_n=c[1],
                           block_k=cfg.block_k, **kw)
        before = dict(gm.LAUNCH_TILES["gemm"])
        _checked(check, c, {"out": one(a, b)}, ref)
        if device.type == "cuda":
            _launched(gm.LAUNCH_TILES, before, "gemm",
                      (cfg.block_m, cfg.block_n, cfg.block_k), c)
        results[c] = _loop_timed(one, (a, b), iters=iters, repeats=repeats)
        if verbose:
            print(f"  {c}: {results[c] * 1e3:.4f} ms", flush=True)
    winner = min(results, key=results.get)
    cache = KernelConfigCache.get() if cache is None else cache
    cache.insert(desc.cache_key(generation), winner)
    return winner, results


def autotune_gemm(
    *,
    m: int = 1024,
    n: int = 1024,
    k: int = 1024,
    dtype=torch.bfloat16,
    transpose_a: bool = False,
    transpose_b: bool = False,
    candidates: Sequence[tuple[int, int]] = GEMM_CANDIDATES,
    iters: int = 20,
    repeats: int = 3,
    cache: Optional[KernelConfigCache] = None,
    verbose: bool = False,
    device=None,
    check: Callable = default_check,
):
    """Measure candidate (block_m, block_n) tiles of the GEMM kernel on
    dense ``dtype`` operands (the K step is the route's); record the
    winner under the problem's key."""
    from metal_flash_attention_tpu_torch.descriptors.gemm_descriptor import (
        GEMMDescriptor,
    )
    from metal_flash_attention_tpu_torch.descriptors.precision import (
        OperandPrecision,
    )

    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((k, m) if transpose_a else (m, k), generator=g,
                    device=device).to(dtype)
    b = torch.randn((n, k) if transpose_b else (k, n), generator=g,
                    device=device).to(dtype)
    prec = OperandPrecision.from_dtype(dtype)
    desc = GEMMDescriptor(m=m, n=n, k=k, precision_a=prec, precision_b=prec,
                          transpose_a=transpose_a, transpose_b=transpose_b)
    return _gemm_sweep(desc, a, b, candidates, iters=iters, repeats=repeats,
                       cache=cache, verbose=verbose, device=device,
                       check=check)


def autotune_gemm_descriptor(
    desc,
    candidates: Sequence[tuple[int, int]],
    *,
    iters: int = 20,
    repeats: int = 2,
    cache: Optional[KernelConfigCache] = None,
    verbose: bool = False,
    device=None,
    generation: Optional[str] = None,
    check: Callable = default_check,
):
    """The sweep for one `GEMMDescriptor`, quantized operands included
    (`GEMMDescriptor.kernel_config`'s on a miss): operands made in the
    descriptor's memory precisions (a quantized one per channel, by
    `quantize_matrix`), so that the kernel measured is the one that
    dispatches."""
    from metal_flash_attention_tpu_torch.ops.quantization import (
        quantize_matrix,
    )

    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)

    def operand(shape, precision, contract_axis):
        x = torch.randn(shape, generator=g, device=device)
        if precision.is_quantized:
            return quantize_matrix(x, precision, contract_axis=contract_axis,
                                   per_channel=True)
        return x.to(precision.storage_dtype)

    a = operand((desc.k, desc.m) if desc.transpose_a else (desc.m, desc.k),
                desc.precision_a, 0 if desc.transpose_a else 1)
    b = operand((desc.n, desc.k) if desc.transpose_b else (desc.k, desc.n),
                desc.precision_b, 1 if desc.transpose_b else 0)
    return _gemm_sweep(desc, a, b, candidates, iters=iters, repeats=repeats,
                       cache=cache, verbose=verbose, device=device,
                       check=check, generation=generation)


def _precision_tag(precision) -> str:
    return precision.value if precision is not None else "bf16"


def autotune_decode(
    *,
    seq: int = 8192,
    head_dim: int = 128,
    batch: int = 8,
    kv_heads: int = 8,
    q_heads: int = 32,
    precision=None,
    candidates: Sequence[int] = DECODE_CANDIDATES,
    iters: int = 50,
    repeats: int = 3,
    cache: Optional[KernelConfigCache] = None,
    verbose: bool = False,
    device=None,
    check: Callable = default_check,
):
    """Sweep `flash_decode`'s ``block_kv`` (the cap on its split-KV chunk)
    per KV-storage precision; the winner lands under the
    ``decode_<precision>`` key that `flash_decode` consults."""
    from metal_flash_attention_tpu_torch.ops import flash_decode as fd
    from metal_flash_attention_tpu_torch.ops.quantization import quantize

    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)
    q = torch.randn((batch, q_heads, head_dim), generator=g,
                    device=device).to(torch.bfloat16)
    kf, vf = (torch.randn((batch, kv_heads, seq, head_dim), generator=g,
                          device=device) for _ in range(2))
    if precision is None:
        k, v = kf.to(torch.bfloat16), vf.to(torch.bfloat16)
    else:
        k, v = quantize(kf, precision), quantize(vf, precision)
    del kf, vf
    lens = torch.full((batch,), seq, dtype=torch.int32, device=device)
    o_ref, lse_ref = fd._flash_decode_plain(
        q, k, v, kv_lens=lens, kv_starts=None, max_span=None,
        scale=head_dim ** -0.5)
    ref = {"o": o_ref[:, :, None], "lse": lse_ref}
    results = {}
    for bkv in candidates:
        def one(q, bkv=bkv):
            return fd.flash_decode(q, k, v, kv_lens=lens, block_kv=bkv,
                                   return_residuals=True)
        o, lse = one(q)
        _checked(check, bkv, {"o": o[:, :, None], "lse": lse}, ref)
        results[bkv] = _loop_timed(one, (q,), iters=iters, repeats=repeats)
        if verbose:
            print(f"  block_kv={bkv}: {results[bkv] * 1e3:.4f} ms",
                  flush=True)
    winner = min(results, key=results.get)
    cache = KernelConfigCache.get() if cache is None else cache
    cache.insert(cache.attention_key(
        f"decode_{_precision_tag(precision)}", head_dim, torch.bfloat16,
        q_len_bucket=1 << (seq - 1).bit_length()), (1, winner))
    return winner, results


def autotune_paged(
    *,
    seq: int = 8192,
    head_dim: int = 128,
    batch: int = 8,
    kv_heads: int = 8,
    q_heads: int = 32,
    page_size: int = 128,
    precision=None,
    candidates: Sequence[int] = PAGED_CANDIDATES,
    iters: int = 50,
    repeats: int = 3,
    cache: Optional[KernelConfigCache] = None,
    verbose: bool = False,
    device=None,
    check: Callable = default_check,
):
    """Sweep `paged_decode`'s ``pages_per_chunk`` (the cap on its split-KV
    chunk, in pages) per KV-storage precision; the winner lands under
    ``paged_<precision>``."""
    import numpy as np

    from metal_flash_attention_tpu_torch.ops import paged_attention as pa

    device = resolve_device(device)
    g = torch.Generator(device=device).manual_seed(0)
    max_pages = seq // page_size
    num_pages = batch * max_pages
    q = torch.randn((batch, q_heads, head_dim), generator=g,
                    device=device).to(torch.bfloat16)
    kp, vp = (torch.randn((num_pages, kv_heads, page_size, head_dim),
                          generator=g, device=device).to(torch.bfloat16)
              for _ in range(2))
    perm = np.random.default_rng(7).permutation(num_pages)
    table = torch.as_tensor(perm.reshape(batch, max_pages), dtype=torch.int32,
                            device=device)
    pcache = pa.PagedKVCache(kp, vp, table, torch.full(
        (batch,), seq, dtype=torch.int32, device=device))
    if precision is not None:
        pcache = pa.quantize_paged(pcache, precision)
    o_ref, lse_ref = pa._paged_attention_plain(
        q[:, :, None], pcache, scale=head_dim ** -0.5, window_size=None)
    ref = {"o": o_ref, "lse": lse_ref}
    results = {}
    for ppc in candidates:
        if ppc > max_pages:
            continue

        def one(q, ppc=ppc):
            return pa.paged_decode(q, pcache, pages_per_chunk=ppc,
                                   return_residuals=True)
        o, lse = one(q)
        _checked(check, ppc, {"o": o[:, :, None], "lse": lse[:, :, None]},
                 ref)
        results[ppc] = _loop_timed(one, (q,), iters=iters, repeats=repeats)
        if verbose:
            print(f"  pages_per_chunk={ppc}: {results[ppc] * 1e3:.4f} ms",
                  flush=True)
    if not results:
        raise RuntimeError("no paged candidate fits the table")
    winner = min(results, key=results.get)
    cache = KernelConfigCache.get() if cache is None else cache
    cache.insert(cache.attention_key(
        f"paged_{_precision_tag(precision)}", head_dim, torch.bfloat16,
        q_len_bucket=1 << (seq - 1).bit_length()), (1, winner))
    return winner, results


def lookup_tuned_blocks(kernel_type: str, head_dim: int, dtype, n: int, *,
                        generation: Optional[str] = None
                        ) -> Optional[tuple[int, int]]:
    """A measured winner in the config cache for this problem, or None
    (the table serves then)."""
    cache = KernelConfigCache.get()
    key = cache.attention_key(kernel_type, head_dim, dtype,
                              q_len_bucket=1 << (max(n, 1) - 1).bit_length(),
                              generation=generation)
    return cache.lookup(key)

