#!/usr/bin/env python3
"""The program's spans in `register_pairs` (or `register_pair`) on one
NVIDIA GPU, at the shapes of whole HDL-64E scans (`chip_smoke.py`'s
synthetic 124,668-point scan against its copy moved 35 deg),
`RegistrationConfig()` defaults:

1. what a span costs on the host: with no profiler recording (the shared
   no-op) and with one recording (a `pct:` range and a `TRACE` entry),
   microseconds a span over many spans;
2. outputs with the profiler on equal to those with it off, bit for bit;
3. one call under `profiler_trace`: each kernel of the Chrome trace put
   under the innermost `pct:` range that holds the host call which
   launched it (joined by the launch's correlation id), every K4
   (`icp_mega_kernel`) launch required inside `register_pairs/icp_voxel`
   or `register_pairs/icp_refine`, every K1 (`nn1_kernel`) launch of the
   stats inside `register_pairs/icp_stats`; the kernels launched inside
   `register_pairs/ransac/refine` (one: RANSAC's select-and-refine
   kernel) and the rise of its counter `ransac_refine.launches` over the
   call;
4. `TRACE.report()` over as many profiled calls as the benchmark's traced
   run profiles (12 calls of 16 pairs, 4 of 64), and the host ms a call
   with the spans recording against the same calls with them silenced,
   under the profiler both times, in turns.

    python3 tools/trace_register_pairs.py [--seed 0]
        [--entry register_pairs|register_pair] [--keypoints all|iss]

Prints one JSON line and writes it, with the reports, to
`chiprun_out/trace_register_pairs.json`; the Chrome traces of step 3 go
to `chiprun_out/trace_register_pairs/`.

With `--entry register_pair` the same for the single pair (one whole scan
against its moved copy a call): the span costs, outputs on = off, one call's
Chrome trace with every kernel-5 (`icp_mega_kernel`) launch required inside
`register_pair/icp/coarse` or `register_pair/icp/polish` and every K1
(`nn1_kernel`) launch inside `register_pair/icp_stats`, and over 12
profiled calls `TRACE.report()` and the launches a call that kernel 5's,
K1's and kernel V's counters (`icp_mega.launches`, `nn1.launches`,
`voxel_run_means.launches`: the voxel centroids of each cloud) count (2,
1 and 2 expected), and FPFH's graph counters (`fpfh_graph.captures`, 1 in
the process, made in the warm-up; `fpfh_graph.replays`, 2 a call
expected); written to `chiprun_out/trace_register_pair.json`.

With `--keypoints iss` the same for `register_pairs` with
`RegistrationConfig(keypoints="iss")` at B 16: outputs on = off, one
call's Chrome trace with every kernel launched inside
`register_pairs/sites` put under a child of `register_pairs/sites/iss`
(`radius`, `scatter`, `eig`, `nms`) but `keypoint_sites`' own mask and
stack, counted apart; over 12 profiled calls `TRACE.report()` and the
rise of `iss_keypoints.calls` (32 a call expected); and the ISS loop of
both sides' voxel clouds timed untraced (synchronized, 10 repeats) beside
its traced reading, and the whole call untraced; written to
`chiprun_out/trace_register_pairs_iss.json`.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "chiprun_out"
PROFILED = {16: 12, 64: 4}      # pairs a call: calls profiled


def span_costs(profiling, torch, n_off=1_000_000, n_on=20_000):
    """µs a span with no profiler recording, and with one recording
    (CPU and CUDA activity, as the benchmark's traced run)."""
    span = profiling.span
    t = time.perf_counter()
    for _ in range(n_off):
        with span("x"):
            pass
    off = (time.perf_counter() - t) / n_off * 1e6
    t = time.perf_counter()
    for _ in range(n_off):
        pass
    empty = (time.perf_counter() - t) / n_off * 1e6
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        t = time.perf_counter()
        for _ in range(n_on):
            with span("x"):
                pass
        on = (time.perf_counter() - t) / n_on * 1e6
    profiling.TRACE.reset()
    return {"off_us": off, "empty_loop_us": empty, "on_us": on}


def launch_map(trace_file):
    """Each kernel of a Chrome trace -> the innermost `pct:` range (by
    name, without the prefix) holding its launch on the host."""
    ev = json.loads(Path(trace_file).read_text())["traceEvents"]
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][4:])
                     for e in ev if e.get("ph") == "X"
                     and e.get("cat") == "user_annotation"
                     and e["name"].startswith("pct:")), key=lambda r: r[0])
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in ev
                 if e.get("ph") == "X"
                 and e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = []
    for e in ev:
        if e.get("ph") != "X" or e.get("cat") != "kernel":
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        inner = None
        if ts is not None:
            holding = [r for r in ranges if r[0] <= ts <= r[1]]
            if holding:
                inner = min(holding, key=lambda r: r[1] - r[0])[2]
        out.append((e["name"], inner))
    return out


def trace_single(args, res, torch, profiling, scan, rng):
    """`--entry register_pair`: res gains the single pair's readings; True
    when every check held."""
    import chip_smoke
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.features.fpfh import fpfh_graph
    from pctpu_torch.ops import pallas_icp_mega, pallas_nn, voxel
    from pctpu_torch.register.pipeline import (RegistrationConfig,
                                               register_pair)
    dev = torch.device("cuda")
    src, dst, _ = chip_smoke.make_pairs(scan, rng, 1, len(scan),
                                        chip_smoke.ROT_DEG)
    mask = torch.ones(src.shape[1], dtype=torch.bool)
    s_pc = PointCloud(torch.from_numpy(src[0]), mask)
    d_pc = PointCloud(torch.from_numpy(dst[0]), mask)
    cfg = RegistrationConfig()

    def call():
        out = register_pair(s_pc, d_pc, cfg, generator=torch.Generator(
            device=dev).manual_seed(args.seed), device=dev)
        torch.cuda.synchronize()
        return out

    for _ in range(2):
        off = call()
    profiling.TRACE.reset()
    logdir = OUT / "trace_register_pair"
    with profiling.profiler_trace(str(logdir)):
        on = call()
    equal = all(torch.equal(x, y) for x, y in zip(off, on))
    trace_file = max(logdir.glob("trace-*.json"),
                     key=lambda f: f.stat().st_mtime)
    kmap = launch_map(trace_file)
    k5 = Counter(r for n, r in kmap if "icp_mega_kernel" in n)
    k1 = Counter(r for n, r in kmap if "nn1_kernel" in n)
    in_place = (k5 == Counter({"register_pair/icp/coarse": 1,
                               "register_pair/icp/polish": 1})
                and k1 == Counter({"register_pair/icp_stats": 1}))
    calls = PROFILED[16]
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiling.TRACE.reset()
    n5, n1 = pallas_icp_mega.icp_mega.launches, pallas_nn.nn1.launches
    nvox = voxel.voxel_run_means.launches
    nrep = fpfh_graph.replays
    ms = []
    with torch.profiler.profile(activities=acts):
        for _ in range(calls):
            t = time.perf_counter()
            call()
            ms.append((time.perf_counter() - t) * 1e3)
    res["register_pair"] = {
        "calls_profiled": calls, "outputs_equal_on_off": equal,
        "kernels": len(kmap), "k5_ranges": dict(k5), "k1_ranges": dict(k1),
        "kernels_by_range": dict(Counter(r for _, r in kmap)),
        "launches_in_place": in_place,
        "k5_launches_a_call": (pallas_icp_mega.icp_mega.launches - n5)
        / calls,
        "k1_launches_a_call": (pallas_nn.nn1.launches - n1) / calls,
        "voxel_run_means_launches_a_call":
        (voxel.voxel_run_means.launches - nvox) / calls,
        "fpfh_graph_captures": fpfh_graph.captures,
        "fpfh_graph_replays_a_call": (fpfh_graph.replays - nrep) / calls,
        "call_ms": ms, "median_call_ms": statistics.median(ms),
        "spans_a_call": sum(profiling.TRACE.counts.values()) / calls,
        "ms_a_call": {k: v * 1e3 / calls for k, v in
                      profiling.TRACE.totals.items()},
        "report": profiling.TRACE.report()}
    r = res["register_pair"]
    print(f"register_pair, {calls} profiled calls: kernel 5 "
          f"{r['k5_launches_a_call']}, K1 {r['k1_launches_a_call']} and "
          f"voxel_run_means {r['voxel_run_means_launches_a_call']} "
          f"launches a call; fpfh_graph {r['fpfh_graph_captures']} "
          f"captures, {r['fpfh_graph_replays_a_call']} replays a call\n"
          + r["report"], file=sys.stderr)
    return (equal and in_place and r["k5_launches_a_call"] == 2
            and r["k1_launches_a_call"] == 1
            and r["voxel_run_means_launches_a_call"] == 2
            and r["fpfh_graph_captures"] == 1
            and r["fpfh_graph_replays_a_call"] == 2)


def trace_iss(args, res, torch, profiling, scan, rng):
    """`--keypoints iss`: res gains the ISS readings at B 16; True when
    every check held."""
    import chip_smoke
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.features import iss
    from pctpu_torch.ops.voxel import voxel_downsample_capped
    from pctpu_torch.register.pipeline import (RegistrationConfig,
                                               keypoint_sites,
                                               register_pairs)
    dev = torch.device("cuda")
    b, calls = 16, PROFILED[16]
    src, dst, _ = chip_smoke.make_pairs(scan, rng, b, len(scan),
                                        chip_smoke.ROT_DEG)
    mask = torch.ones(src.shape[:2], dtype=torch.bool)
    s_pc = PointCloud(torch.from_numpy(src), mask)
    d_pc = PointCloud(torch.from_numpy(dst), mask)
    cfg = RegistrationConfig(keypoints="iss")

    def call():
        out = register_pairs(s_pc, d_pc, cfg, generator=torch.Generator(
            device=dev).manual_seed(args.seed), device=dev)
        torch.cuda.synchronize()
        return out

    for _ in range(2):
        off = call()
    profiling.TRACE.reset()
    logdir = OUT / "trace_register_pairs_iss"
    with profiling.profiler_trace(str(logdir)):
        on = call()
    equal = all(torch.equal(x, y) for x, y in zip(off, on))
    trace_file = max(logdir.glob("trace-*.json"),
                     key=lambda f: f.stat().st_mtime)
    kmap = launch_map(trace_file)
    by_range = Counter(r for _, r in kmap)
    sites = {r: n for r, n in by_range.items()
             if r and r.startswith("register_pairs/sites")}
    children = {f"register_pairs/sites/iss/{c}"
                for c in ("radius", "scatter", "eig", "nms")}
    in_place = (set(sites) <= children | {"register_pairs/sites"}
                and set(sites) & children == children)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    profiling.TRACE.reset()
    before = iss.iss_keypoints.calls
    traced_ms = []
    with torch.profiler.profile(activities=acts):
        for _ in range(calls):
            t = time.perf_counter()
            call()
            traced_ms.append((time.perf_counter() - t) * 1e3)
    rise = (iss.iss_keypoints.calls - before) / calls
    totals = {k: v * 1e3 / calls for k, v in profiling.TRACE.totals.items()}
    report = profiling.TRACE.report()
    profiling.TRACE.reset()

    downs = [voxel_downsample_capped(pc.points.to(dev), pc.mask.to(dev),
                                     cfg.voxel_size,
                                     cfg.downsample_capacity)[0]
             for pc in (s_pc, d_pc)]
    loop_ms, call_ms = [], []
    for i in range(12):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for d in downs:
            keypoint_sites(d, cfg)
        torch.cuda.synchronize()
        if i >= 2:
            loop_ms.append((time.perf_counter() - t) * 1e3)
    for i in range(12):
        t = time.perf_counter()
        call()
        if i >= 2:
            call_ms.append((time.perf_counter() - t) * 1e3)
    res["register_pairs_iss"] = {
        "pairs_a_call": b, "calls_profiled": calls,
        "outputs_equal_on_off": equal, "kernels": len(kmap),
        "kernels_by_range": dict(by_range), "sites_kernels": sites,
        "launches_in_place": in_place,
        "iss_keypoints_calls_a_call": rise,
        "traced_call_ms": traced_ms,
        "traced_ms_a_call": totals,
        "iss_loop_ms_untraced": loop_ms,
        "median_iss_loop_ms_untraced": statistics.median(loop_ms),
        "median_iss_ms_traced": totals.get("register_pairs/sites/iss"),
        "call_ms_untraced": call_ms,
        "median_call_ms_untraced": statistics.median(call_ms),
        "report": report}
    r = res["register_pairs_iss"]
    print(f"register_pairs keypoints=iss, B {b}: kernels under sites "
          f"{sites}; iss_keypoints.calls +{rise} a call; the ISS loop "
          f"{r['median_iss_loop_ms_untraced']:.2f} ms untraced, "
          f"{r['median_iss_ms_traced']:.2f} ms traced; the call "
          f"{r['median_call_ms_untraced']:.2f} ms untraced\n"
          + report, file=sys.stderr)
    return equal and in_place and rise == 2 * b


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--entry", choices=("register_pairs", "register_pair"),
                   default="register_pairs")
    p.add_argument("--keypoints", choices=("all", "iss"), default="all")
    args = p.parse_args(argv)
    if args.keypoints == "iss" and args.entry != "register_pairs":
        p.error("--keypoints iss traces register_pairs")

    import torch
    import chip_smoke
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.register import ransac
    from pctpu_torch.register.pipeline import (RegistrationConfig,
                                               register_pairs)
    from pctpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("trace_register_pairs: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    res = {"device": gpu, "torch": torch.__version__,
           "cuda": torch.version.cuda,
           "spans": span_costs(profiling, torch)}
    rng = np.random.default_rng([args.seed, 9])
    scan = chip_smoke.lidar_scan(rng)
    if args.keypoints == "iss":
        ok = trace_iss(args, res, torch, profiling, scan, rng)
        OUT.mkdir(exist_ok=True)
        (OUT / "trace_register_pairs_iss.json").write_text(
            json.dumps(res, indent=1))
        print(json.dumps({k: ({f: x for f, x in v.items() if f != "report"}
                              if k == "register_pairs_iss" else v)
                          for k, v in res.items()}))
        return 0 if ok else 1
    if args.entry == "register_pair":
        ok = trace_single(args, res, torch, profiling, scan, rng)
        OUT.mkdir(exist_ok=True)
        (OUT / "trace_register_pair.json").write_text(
            json.dumps(res, indent=1))
        print(json.dumps({k: ({f: x for f, x in v.items() if f != "report"}
                              if k == "register_pair" else v)
                          for k, v in res.items()}))
        return 0 if ok else 1
    cfg = RegistrationConfig()

    for b, calls in PROFILED.items():
        src, dst, _ = chip_smoke.make_pairs(scan, rng, b, len(scan),
                                            chip_smoke.ROT_DEG)
        mask = torch.ones(src.shape[:2], dtype=torch.bool)
        s_pc = PointCloud(torch.from_numpy(src), mask)
        d_pc = PointCloud(torch.from_numpy(dst), mask)

        def call():
            out = register_pairs(
                s_pc, d_pc, cfg, generator=torch.Generator(
                    device=dev).manual_seed(args.seed), device=dev)
            torch.cuda.synchronize()
            return out

        for _ in range(2):
            off = call()
        profiling.TRACE.reset()
        logdir = OUT / "trace_register_pairs" / f"b{b}"
        counted = ransac.ransac_refine.launches
        with profiling.profiler_trace(str(logdir)):
            on = call()
        counted = ransac.ransac_refine.launches - counted
        equal = all(torch.equal(x, y) for x, y in zip(off, on))
        trace_file = max(logdir.glob("trace-*.json"),
                         key=lambda f: f.stat().st_mtime)
        kmap = launch_map(trace_file)
        k4 = Counter(r for n, r in kmap if "icp_mega_kernel" in n)
        k1 = Counter(r for n, r in kmap if "nn1_kernel" in n)
        by_range = Counter(r for _, r in kmap)
        in_refine = by_range.get("register_pairs/ransac/refine", 0)
        ok = (bool(k4) and bool(k1)
              and set(k4) <= {"register_pairs/icp_voxel",
                              "register_pairs/icp_refine"}
              and set(k1) == {"register_pairs/icp_stats"})

        # spans recording against spans silenced, profiler on both times
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        profiling.TRACE.reset()
        on_ms, silent_ms = [], []
        record = profiling._profiler_on
        with torch.profiler.profile(activities=acts):
            for i in range(2 * calls):
                silent = i % 4 in (1, 2)
                if silent:
                    profiling._profiler_on = lambda: False
                try:
                    t = time.perf_counter()
                    call()
                    dt = (time.perf_counter() - t) * 1e3
                finally:
                    profiling._profiler_on = record
                (silent_ms if silent else on_ms).append(dt)
        spans_a_call = sum(profiling.TRACE.counts.values()) / calls
        res[f"b{b}"] = {
            "calls_profiled": calls, "outputs_equal_on_off": equal,
            "kernels": len(kmap), "k4_ranges": dict(k4),
            "k1_ranges": dict(k1), "kernels_by_range": dict(by_range),
            "launches_in_place": ok,
            "refine_kernels": in_refine, "ransac_refine_launches": counted,
            "spans_a_call": spans_a_call,
            "call_ms_spans_on": on_ms, "call_ms_spans_silent": silent_ms,
            "median_on_ms": statistics.median(on_ms),
            "median_silent_ms": statistics.median(silent_ms),
            "ms_a_pair": {k: v * 1e3 / (calls * b) for k, v in
                          profiling.TRACE.totals.items()},
            "report": profiling.TRACE.report()}
        print(f"B {b}: {len(kmap)} kernels a call, {in_refine} inside "
              f"ransac/refine, ransac_refine.launches +{counted}",
              file=sys.stderr)
        print(f"B {b}, {calls} profiled calls:\n"
              + profiling.TRACE.report(), file=sys.stderr)
    OUT.mkdir(exist_ok=True)
    (OUT / "trace_register_pairs.json").write_text(json.dumps(res, indent=1))
    print(json.dumps({k: ({f: x for f, x in v.items() if f != "report"}
                          if k.startswith("b") else v)
                      for k, v in res.items()}))
    return 0 if all(res[f"b{b}"]["launches_in_place"]
                    and res[f"b{b}"]["outputs_equal_on_off"]
                    and res[f"b{b}"]["refine_kernels"] == 1
                    and res[f"b{b}"]["ransac_refine_launches"] == 1
                    for b in PROFILED) else 1


if __name__ == "__main__":
    sys.exit(main())
