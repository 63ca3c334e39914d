"""Profiling and roofline accounting.

The port of the JAX package's `utils/profiling.py`, with its names and
signatures: `measure_dispatch_floor`, `time_scalar_fn`, `RooflineReport`
(the same text), `attention_roofline` (GINSTRS = work / latency against
the device's FMA roofline, the reference's accounting) and `trace`.

Timing follows the arguments' device: CUDA events around back-to-back
calls on the card, `time.perf_counter` around them (and the scalar's
read-back) on the CPU.  A loop that has no tensor argument runs on the
card.  `trace` is a `torch.profiler` scope that writes a chrome trace.

Departure from the JAX package: `attention_roofline` reads the
`runtime.context.DeviceContext` of its arguments' device, where JAX reads
the default backend's; the port's `DeviceContext.get()` raises without a
card, where JAX's falls back to its cpu row.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from metal_flash_attention_tpu_torch.runtime.context import DeviceContext
from metal_flash_attention_tpu_torch.utils.device import resolve_device


def _device_of(args) -> torch.device:
    """The device of the first tensor among ``args``; the card where there
    is none."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(None)


def _loop_seconds(run: Callable, device: torch.device) -> float:
    """Seconds of ``run()``: CUDA events on the card, the host's clock on
    the CPU (``run`` reads its scalar back there)."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    run()
    return time.perf_counter() - t0


def measure_dispatch_floor(repeats: int = 10, device=None) -> float:
    """Best-case seconds of one minimal call and its scalar, timed as
    `time_scalar_fn` times a loop (subtracted from its timings), on
    ``device`` (None: the card)."""
    device = resolve_device(device)
    x = torch.zeros((8, 128), dtype=torch.float32, device=device)

    def run():
        return float((x * 1.0).sum()) if device.type == "cpu" else \
            (x * 1.0).sum()
    for _ in range(3):
        run()
    return min(_loop_seconds(run, device) for _ in range(repeats))


def time_scalar_fn(fn: Callable, args: tuple, *, iters: int = 128,
                   repeats: int = 4,
                   dispatch_floor: Optional[float] = None) -> float:
    """Seconds per call of ``fn(*args) -> scalar-reducible tensor``: the
    best of ``repeats`` loops of ``iters`` back-to-back calls, less the
    dispatch floor, over ``iters``.  (JAX perturbs the first argument by
    a carry so that its compiler cannot fold the loop; eager calls are
    never folded.)"""
    device = _device_of(args)
    if dispatch_floor is None:
        dispatch_floor = measure_dispatch_floor(device=device)

    def run():
        out = None
        for _ in range(iters):
            out = fn(*args)
        first = out[0] if isinstance(out, (tuple, list)) else out
        if device.type == "cpu":
            float(first.reshape(-1)[:1].float().sum())

    for _ in range(2):
        run()
    best = min(_loop_seconds(run, device) for _ in range(repeats))
    return max((best - dispatch_floor) / iters, 1e-12)


@dataclass(frozen=True)
class RooflineReport:
    """One measurement against the device's roofline (the reference's CSV
    perf rows, `SquareAttentionTest.swift:149-181`)."""
    seconds: float
    ginstrs: float
    ginstrs_per_s: float
    utilization: float

    def __str__(self) -> str:
        return (f"{self.ginstrs_per_s:,.0f} GINSTRS/s "
                f"({self.utilization:.1%} of roofline, "
                f"{self.seconds * 1e6:.1f} us)")


def attention_roofline(
    fn: Callable, args: tuple, *, n: int, d: int, heads: int = 1,
    batch: int = 1, with_backward: bool = False, causal: bool = False,
    iters: int = 128, dispatch_floor: Optional[float] = None,
) -> RooflineReport:
    """Measure ``fn`` and report it against the (2D+5)/(9D+15) work model
    and the FMA roofline of its arguments' device."""
    ctx = DeviceContext.get(_device_of(args))
    work = ctx.attention_ginstrs(
        n, d, heads=heads * batch, with_backward=with_backward,
        causal=causal)
    secs = time_scalar_fn(fn, args, iters=iters,
                          dispatch_floor=dispatch_floor)
    gps = work / secs / 1e9
    return RooflineReport(
        seconds=secs, ginstrs=work / 1e9, ginstrs_per_s=gps,
        utilization=gps / ctx.roofline_ginstrs_per_s)


@contextlib.contextmanager
def trace(path: Optional[str] = None):
    """A torch.profiler scope (the CPU, and the card where there is one)
    that writes a chrome trace to ``path`` (default: mfa_torch_trace.json
    in the temporary directory) when it closes; yields the path."""
    from torch.profiler import ProfilerActivity, profile

    path = path or os.path.join(tempfile.gettempdir(),
                                "mfa_torch_trace.json")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield path
    prof.export_chrome_trace(path)
