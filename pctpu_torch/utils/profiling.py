"""Profiling and timing utilities (port of `pctpu/utils/profiling.py`).

A timer that syncs (a CUDA synchronize, then every tensor fetched to the
host), a FLOP count from `torch.utils.flop_counter`, model-FLOPs
utilisation against the H100's published peaks, a `torch.profiler` trace
context, an accumulating host section timer, and the program's spans.

Spans. The main path opens `span(name)` around its stages (in
`register_pairs`: the clouds' copy to the card, the voxel grid, FPFH and
its parts, matching, RANSAC and its parts, the three ICP stages; in
`register_pair` the same front end and kernel 5's layout, windowed and
exact launches, then the stats). A span
costs one check of the profiler's state while no torch profiler records,
and does nothing else. While one records, a span opens the profiler
range `pct:<path>`, `path` being the open spans' names joined by "/" on
this thread (`register_pairs/ransac/score`), and at its close adds its
host seconds and a count of 1 under `path` in `TRACE`. A span never
synchronizes: its host time is the stage's dispatch plus whatever blocks
the host inside it (a pageable copy, a value read back). The profiler's
state is per thread, so spans record on the thread that started it.

To trace a call, run it under `profiler_trace` (or any
`torch.profiler.profile`) after a warm-up call:

    from pctpu_torch.utils import profiling
    register_pairs(src, dst, cfg)                  # warm-up
    profiling.TRACE.reset()
    with profiling.profiler_trace("build/trace"):
        register_pairs(src, dst, cfg)
    print(profiling.TRACE.report())

The Chrome trace (chrome://tracing, Perfetto) shows each `pct:` range on
the host's row above the kernels it launched, on the same clock, so an
idle gap on the device sits under the stage the host was in. `report()`
prints one line a path, parents before children: its total host ms, its
count, and its self ms, the total less its direct children's.
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, Dict

import torch

# One NVIDIA H100 SXM5 80GB at its full 700 W power limit: NVIDIA's data
# sheet, dense rates (no sparsity). "float32" is the CUDA cores' rate,
# outside the tensor cores; a card set below 700 W runs slower under load.
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12,
              "float16": 989e12, "float8": 1979e12, "int8": 1979e12}


def _map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, x) for x in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return tree


def sync(tree):
    """Wait for the card, then fetch every tensor of `tree` (nested lists,
    tuples, named tuples, dicts) to the host as numpy arrays."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return _map(lambda t: t.detach().cpu().numpy(), tree)


def time_fn(fn: Callable, *args, warmup: int = 1, reps: int = 5,
            **kwargs) -> Dict[str, float]:
    """Wall-time `fn` with warm-up and a true sync (host clock)."""
    for _ in range(warmup):
        sync(fn(*args, **kwargs))
    t0 = time.perf_counter()
    outs = [fn(*args, **kwargs) for _ in range(reps)]
    sync(outs)
    dt = (time.perf_counter() - t0) / reps
    return {"mean_s": dt, "per_sec": 1.0 / dt if dt > 0 else float("inf")}


def flops_of(fn: Callable, *args, **kwargs) -> float:
    """The FLOPs of one call of `fn` on these inputs, as
    `torch.utils.flop_counter.FlopCounterMode` counts them (matmuls,
    convolutions, attention: 2 per multiply-add)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


def mfu(flops: float, seconds: float, dtype: str = "float32",
        peak: float | None = None) -> float:
    """Model FLOPs Utilization: achieved FLOP/s over `peak` (default the
    H100's published peak for `dtype`, `PEAK_FLOPS`)."""
    if peak is None:
        peak = PEAK_FLOPS[dtype]
    return flops / max(seconds, 1e-12) / peak


def measure_mfu(fn: Callable, *args, dtype: str = "float32",
                warmup: int = 1, reps: int = 5, **kwargs) -> Dict[str, float]:
    """time_fn + flops_of + mfu in one call."""
    t = time_fn(fn, *args, warmup=warmup, reps=reps, **kwargs)
    fl = flops_of(fn, *args, **kwargs)
    t["flops"] = fl
    t["mfu"] = mfu(fl, t["mean_s"], dtype=dtype)
    return t


@contextlib.contextmanager
def profiler_trace(logdir: str):
    """`torch.profiler` over the block (CPU activity, and CUDA activity
    when a card is present); the trace is written into `logdir` as a
    Chrome trace JSON (chrome://tracing, Perfetto). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class Timer:
    """Accumulating host section timer. A key is a path of names joined by
    "/"; `report()` reads the paths as a tree. Safe to add to from several
    threads."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._lock = threading.Lock()

    def add(self, path: str, seconds: float) -> None:
        """One more occurrence of `path`, lasting `seconds`."""
        with self._lock:
            self.totals[path] = self.totals.get(path, 0.0) + seconds
            self.counts[path] = self.counts.get(path, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def self_time(self, path: str) -> float:
        """The path's total less the totals of its direct children."""
        with self._lock:
            totals = dict(self.totals)
        return _self_time(totals, path)

    def report(self) -> str:
        """One line a path, each parent before its children: total ms,
        count, self ms."""
        with self._lock:
            totals, counts = dict(self.totals), dict(self.counts)
        return "\n".join(
            f"{p}: {totals[p] * 1e3:.3f} ms ({counts[p]} calls, "
            f"self {_self_time(totals, p) * 1e3:.3f} ms)"
            for p in sorted(totals, key=lambda p: p.split("/")))


def _self_time(totals: Dict[str, float], path: str) -> float:
    depth = path.count("/") + 1
    return totals[path] - sum(
        t for p, t in totals.items()
        if p.startswith(path + "/") and p.count("/") == depth)


# the spans' record, filled only while a torch profiler records
TRACE = Timer()
_OFF = contextlib.nullcontext()
_profiler_on = torch._C._autograd._profiler_enabled


class _OpenSpans(threading.local):
    def __init__(self):
        self.names = []


_open = _OpenSpans()


class _Span:
    __slots__ = ("name", "path", "range", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _open.names.append(self.name)
        self.path = "/".join(_open.names)
        self.range = torch.profiler.record_function("pct:" + self.path)
        self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        self.range.__exit__(*exc)
        _open.names.pop()
        TRACE.add(self.path, dt)
        return False


def span(name: str):
    """A context for one stage of the program: the shared no-op while no
    torch profiler records, else a `pct:` profiler range whose host
    seconds go to `TRACE` (module docstring)."""
    if not _profiler_on():
        return _OFF
    return _Span(name)
