"""The benchmark's harness: finds a cell's files by the names in
`BENCHMARK.json`, builds the cell, warms it up, runs the closed-loop
window, reads the metrics, and judges what the window produced.

Files, found by name under `portbench/`:
  configs/<config>.json    the configuration as it is run
  configs/<config>.py      its cell code: the pool, the entry call, the judge
  reference/<config>.py    the plain reference the judge compares with
  traffic/<traffic>.json   the traffic's parameters and `correct`'s limits
  spans/<entry>.json       the entry's module and the names each span wraps
  metrics/<metric>.py      one reader per metric: `read(run)` -> number
"""
from __future__ import annotations

import contextlib
import functools
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from portbench.common.generators import seed_sequence
from portbench.common.trace import CALL_SPAN, SPAN_PREFIX, TraceView

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pctpu")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _named(items, name, what):
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def cell_files(workload: str, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
    """Everything a cell needs, by name: (workload entry, config file,
    traffic, spans, cell module, reference module, metric entries)."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    wl = _named(bench["workloads"], workload, "workload")
    cfg_entry = _named(bench["configs"], wl["config"], "config")
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads(
        (bench_dir / "traffic" / f"{wl['traffic']}.json").read_text())
    spans = json.loads(
        (bench_dir / "spans" / f"{traffic['entry']}.json").read_text())
    tag = wl["config"].replace("-", "_").replace(".", "_")
    ref = load_module(bench_dir / "reference" / f"{wl['config']}.py",
                      f"portbench_reference_{tag}")
    drv = load_module(bench_dir / "configs" / f"{wl['config']}.py",
                      f"portbench_config_{tag}")

    def applies(m):
        return workload in m.get("workloads", [workload])
    e2e = [m for m in bench["end_to_end"] if applies(m)]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if applies(m) and m["moves"] in e2e_names]
    return wl, config, traffic, spans, drv, ref, e2e, per_layer


def _target(default_module: str, name: str):
    """`attr` (in the entry's module) or `module:attr` -> (module, attr)."""
    mod, _, attr = name.rpartition(":")
    return importlib.import_module(mod or default_module), attr


class Probe:
    """Rebinds names in the program's modules (`attr` in the entry's
    module, or `module:attr`): each wrapper keeps (args, kwargs, output)
    of the names the judge needs while `capturing` is a dict, and while
    `spans_on` it runs the call inside a profiler range
    `pb:<group>/<attr>` that closes after a synchronize, adding its host
    seconds to `span_wall[group]`. A name the program no longer has is
    reported and its group marked missing."""

    def __init__(self, module: str, capture, groups: dict, sync, log):
        self.sync = sync
        self.capturing = None
        self.spans_on = False
        self.span_wall = defaultdict(float)
        self.missing_groups, self.missing_capture = set(), []
        self._orig = []
        group_of = {a: g for g, names in groups.items() for a in names}
        for name in sorted(set(capture) | set(group_of)):
            mod, attr = _target(module, name)
            if not hasattr(mod, attr):
                if name in group_of:
                    self.missing_groups.add(group_of[name])
                if name in capture:
                    self.missing_capture.append(name)
                log(f"warning: {mod.__name__} has no {attr!r}; its "
                    f"span{' and capture' if name in capture else ''} "
                    "are missing")
                continue
            fn = getattr(mod, attr)
            self._orig.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(name, attr, fn,
                                          group_of.get(name),
                                          name in capture))

    def _wrap(self, name, attr, fn, group, capture):
        probe = self

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if probe.spans_on and group is not None:
                with torch.profiler.record_function(
                        f"{SPAN_PREFIX}{group}/{attr}"):
                    t = time.perf_counter()
                    out = fn(*args, **kwargs)
                    probe.sync()
                    probe.span_wall[group] += time.perf_counter() - t
            else:
                out = fn(*args, **kwargs)
            if capture and probe.capturing is not None:
                probe.capturing.setdefault(name, []).append(
                    (args, kwargs, out))
            return out
        return wrapper

    def restore(self):
        for mod, attr, fn in reversed(self._orig):
            setattr(mod, attr, fn)
        self._orig = []


class RunView:
    """What a metric reader sees: the window (`calls`, `units` of work,
    `latencies_s` of every call, `window_s`), `setup_s`, and in a traced
    run `trace` (a TraceView of the profiled calls), else None."""

    def __init__(self, unit, calls, units, latencies_s, window_s, setup_s,
                 trace):
        self.unit, self.calls, self.units = unit, calls, units
        self.latencies_s, self.window_s = latencies_s, window_s
        self.setup_s, self.trace = setup_s, trace


def _power_limit_w(device):
    """The card's power limit from nvidia-smi, or None where it cannot be
    read."""
    import subprocess
    try:
        idx = torch.device(device).index or 0
        out = subprocess.run(
            ["nvidia-smi", "-i", str(idx), "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=20, check=True).stdout.strip()
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: float = None, root: Path = ROOT,
             bench_dir: Path = BENCH_DIR, traffic_overrides: dict = None,
             config_overrides: dict = None, log=None,
             control: bool = False) -> dict:
    """One run of a cell -> the result object the command prints. The
    overrides shrink a cell for the CPU tests; runs of the benchmark
    pass none. With `control`, the judge is handed the control's stages
    for the judged calls in the program's place (the readings that
    `correct`'s limits are set from; runs of the benchmark never)."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda m: print(m, file=sys.stderr, flush=True))
    wl, config, traffic, spans, drv, ref, e2e, per_layer = cell_files(
        workload, root, bench_dir)
    traffic = {**traffic, **(traffic_overrides or {})}
    config = {**config, **(config_overrides or {})}
    dev = torch.device(device)
    on_cuda = dev.type == "cuda"

    def sync():
        if on_cuda:
            torch.cuda.synchronize(dev)

    log(f"setup: the cell's files loaded at "
        f"{time.perf_counter() - t0:.3f} s")
    cell = drv.Cell(config, traffic, seed, dev, ref)
    log(f"setup: traffic made at {time.perf_counter() - t0:.3f} s")
    probe = Probe(spans["module"], cell.capture, spans["groups"], sync, log)
    try:
        if probe.missing_capture:
            raise RuntimeError(f"{spans['module']} lacks "
                               f"{probe.missing_capture}: the judge cannot "
                               "reach those stages")
        for i in range(int(traffic["warmup_calls"])):
            cell.call(i)
            sync()
            log(f"setup: warm-up call {i} done at "
                f"{time.perf_counter() - t0:.3f} s")
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        setup_s = time.perf_counter() - t0
        res = _window(cell, probe, traffic, seed, seconds, trace, sync, log)
    finally:
        probe.restore()
    peak = torch.cuda.max_memory_allocated(dev) if on_cuda else 0

    tview = None
    if trace and res["profile"] is not None:
        pcalls = res["profiled_calls"]
        tview = TraceView.from_events(
            res["profile"].profiler.kineto_results.events(),
            units=pcalls * cell.units_per_call, span_wall=probe.span_wall,
            missing=probe.missing_groups,
            work=cell.work(range(pcalls)))
    run = RunView(cell.unit, res["calls"], res["calls"] * cell.units_per_call,
                  res["latencies"], res["window_s"], setup_s, tview)
    metrics = {}
    for m in (per_layer if trace else e2e):
        reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                             "portbench_metric_" + m["name"].replace(".", "_"))
        v = reader.read(run)
        if v is None:
            log(f"warning: metric {m['name']} found nothing to read; "
                "left out")
            continue
        metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    poses = {i: T.detach().cpu().numpy() for i, T in res["poses"].items()}
    raised = res["raised_units"]
    failed = raised + cell.failed(poses)
    samples = res["samples"]
    del res
    if on_cuda:
        torch.cuda.empty_cache()
    checks = {}
    tj = time.perf_counter()
    stages = cell.control_stages if control else cell.program_stages
    for i, cap, out in sorted(samples, key=lambda s: s[0]):
        for k, v in cell.judge(i, stages(i, cap, out)).items():
            checks[k] = v if k not in checks else max(checks[k], v)
    log(f"judge: {len(samples)} calls in {time.perf_counter() - tj:.3f} s")
    # the traffic's limits name the numbers compared; the judge's others
    # are reported beside them, under `not_compared`
    limits = traffic["limits"]
    others = {k: checks[k] for k in sorted(set(checks) - set(limits))}
    for k, v in others.items():
        log(f"not compared: {k} {v!r}")
    compared = {k: {"value": checks.get(k), "limit": v}
                for k, v in limits.items()}
    correct = (bool(samples) and raised == 0 and bool(limits)
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in compared.values()))
    devinfo = {"platform": "gpu" if on_cuda else "cpu",
               "kind": (torch.cuda.get_device_name(dev) if on_cuda
                        else "cpu"),
               "count": int(wl["chips"]),
               "memory_peak_bytes": int(peak),
               "power_limit_w": _power_limit_w(dev) if on_cuda else None}
    out = {"correct": correct,
           "attempted": run.units, "failed": int(failed),
           "metrics": metrics, "device": devinfo}
    if tview is not None:
        devinfo["busy_s"] = tview.busy_s
        devinfo["window_s"] = tview.window_s
        out["breakdown"] = tview.breakdown()
    out["not_compared"] = {k: (v if np.isfinite(v) else None)
                           for k, v in others.items()}
    out["checks"] = compared
    return out


def _window(cell, probe, traffic, seed, seconds, trace, sync, log) -> dict:
    """The closed loop: one caller, calls back to back until `seconds`
    have passed; the window ends with the last whole call. Keeps every
    call's latency and final pose, and the captured stages of
    `check_calls` calls drawn from the seed over the whole window
    (a reservoir)."""
    k = int(traffic["check_calls"])
    n_trace = int(traffic.get("trace_calls", 0)) if trace else 0
    rng = seed_sequence(seed, 3)
    lat, poses, samples = [], {}, []
    raised = ok = 0
    prof = None
    if n_trace:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False, profile_memory=False)
        prof.__enter__()
        probe.spans_on = True
    i = 0
    tw0 = t1 = time.perf_counter()
    while True:
        cap = {}
        probe.capturing = cap
        rec = (torch.profiler.record_function(CALL_SPAN) if i < n_trace
               else contextlib.nullcontext())
        t = time.perf_counter()
        try:
            with rec:
                out = cell.call(i)
                sync()
        except Exception as e:          # a call that raises counts failed
            log(f"call {i} raised {type(e).__name__}: {e}")
            raised += cell.units_per_call
            out = None
        t1 = time.perf_counter()
        lat.append(t1 - t)
        if out is not None:
            poses[i] = cell.final_pose(out)
            ok += 1
            if len(samples) < k:
                samples.append((i, cap, out))
            else:
                j = int(rng.integers(0, ok))
                if j < k:
                    samples[j] = (i, cap, out)
        i += 1
        if n_trace and i == n_trace:
            prof.__exit__(None, None, None)
            probe.spans_on = False
        if t1 - tw0 >= seconds and (not n_trace or i >= n_trace):
            break
    probe.capturing = None
    fifths = [float(np.median(part)) * 1e3 for part in
              np.array_split(np.asarray(lat), 5) if len(part)]
    log(f"window: {i} calls in {t1 - tw0:.3f} s; median ms a call by "
        f"fifth of the window: {[round(f, 2) for f in fifths]}")
    return dict(calls=i, latencies=lat, window_s=t1 - tw0, poses=poses,
                samples=samples, raised_units=raised,
                profile=prof, profiled_calls=min(i, n_trace))
