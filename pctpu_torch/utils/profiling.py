"""Profiling and timing utilities (port of `pctpu/utils/profiling.py`).

A timer that syncs (a CUDA synchronize, then every tensor fetched to the
host), a FLOP count from `torch.utils.flop_counter`, model-FLOPs
utilisation against the H100's published peaks, a `torch.profiler` trace
context, and an accumulating host section timer.
"""
from __future__ import annotations

import contextlib
import os
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
    """Accumulating section timer (host-side orchestration profiling)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=lambda n: -self.totals[n]):
            lines.append(f"{name}: {self.totals[name]*1e3:.1f} ms "
                         f"({self.counts[name]} calls)")
        return "\n".join(lines)
