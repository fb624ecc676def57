#!/usr/bin/env python3
"""RANSAC inside `register_pairs` timed untraced on one NVIDIA GPU, at
the shapes of whole HDL-64E scans (`chip_smoke.py`'s synthetic
124,668-point scan against its copy moved 35 deg), `RegistrationConfig()`
defaults, B 16 and 64. No profiler runs, so nothing inflates a launch.

For each batch size, one `register_pairs` call records the arguments of
its `ransac_registration_batch` call (and its draws, replayed on every
call after); then, in turns, each timed by the host clock between two
`torch.cuda.synchronize()`:
- `ransac_registration_batch(..., refine=True)`, as `register_pairs` runs it;
- the same with `refine=False` (no refine: the select and the result);
- the whole `register_pairs` call.
`refine_ms` is the first median less the second: the refine's host cost
a call. Where the checkout's `register/ransac.py` has `ransac_refine` (the
select-and-refine kernel), it also times that wrapper alone against the
plain chain `_select_refine_plain` on the same CUDA tensors, and the
kernel's device time a launch (20 launches in one CUDA graph,
replayed between CUDA events: `chip_smoke.graph_ms`).

    python3 tools/time_ransac.py [--seed 0] [--reps 40] [--root DIR]

`--root` imports `pctpu_torch` and `chip_smoke` from another checkout
(say an earlier commit unpacked under `build/`), so two versions can be
timed in one call. Prints one JSON line and writes it to
`chiprun_out/time_ransac[-<label>].json`.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
BATCHES = (16, 64)


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2],
            "n": len(xs)}


def timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=40)
    p.add_argument("--root", default=str(HERE))
    p.add_argument("--label", default="")
    args = p.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import torch
    import chip_smoke
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.register import pipeline, ransac

    if not torch.cuda.is_available():
        print("time_ransac: no CUDA device", file=sys.stderr)
        return 2
    assert Path(ransac.__file__).resolve().is_relative_to(root)
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    kernel = hasattr(ransac, "ransac_refine")
    res = {"device": gpu, "torch": torch.__version__, "root": str(root),
           "label": args.label, "has_kernel": kernel}
    rng = np.random.default_rng([args.seed, 9])
    scan = chip_smoke.lidar_scan(rng)
    cfg = pipeline.RegistrationConfig()

    for b in BATCHES:
        src, dst, _ = chip_smoke.make_pairs(scan, rng, b, len(scan),
                                            chip_smoke.ROT_DEG)
        mask = torch.ones(src.shape[:2], dtype=torch.bool)
        s_pc = PointCloud(torch.from_numpy(src), mask)
        d_pc = PointCloud(torch.from_numpy(dst), mask)
        seen = {}
        orig = pipeline.ransac_registration_batch

        def record(*a, **kw):
            draws = []

            def sampler(nv, H, inner=a[3]):
                draws.append(inner(nv, H))
                return draws[-1]
            out = orig(*a[:3], sampler, *a[4:], **kw)
            seen.update(args=a[:3], kw=kw, u=draws[0])
            return out

        pipeline.ransac_registration_batch = record
        try:
            call = lambda: pipeline.register_pairs(   # noqa: E731
                s_pc, d_pc, cfg, generator=torch.Generator(
                    device=dev).manual_seed(args.seed), device=dev)
            timed(torch, call)
        finally:
            pipeline.ransac_registration_batch = orig
        u = seen["u"]

        def run(refine):
            return lambda: ransac.ransac_registration_batch(
                *seen["args"], lambda nv, H: u,
                **{**seen["kw"], "refine": refine})

        refine_kernel = None
        if kernel:
            grab = {}
            wrapped = ransac._launch_refine

            def capture(*a):
                grab["args"] = a
                return wrapped(*a)
            ransac._launch_refine = capture
            try:
                run(True)()
            finally:
                ransac._launch_refine = wrapped
            refine_kernel = grab["args"]
        for f in (run(True), run(False), call):
            timed(torch, f)                       # warm
        on, off, whole, k_ms, plain_ms = [], [], [], [], []
        for i in range(args.reps):
            order = [(on, run(True)), (off, run(False))]
            for acc, f in (order if i % 2 == 0 else order[::-1]):
                acc.append(timed(torch, f)[0])
            whole.append(timed(torch, call)[0])
            if refine_kernel is not None:
                k_ms.append(timed(torch, lambda: ransac.ransac_refine(
                    *refine_kernel))[0])
                plain_ms.append(timed(torch, lambda: ransac._select_refine_plain(
                    *refine_kernel))[0])
        row = {"ransac_refine_ms": quartiles(on),
               "ransac_no_refine_ms": quartiles(off),
               "refine_ms": statistics.median(on) - statistics.median(off),
               "register_pairs_ms": quartiles(whole),
               "m": int(seen["args"][0].shape[1]),
               "m_cap": seen["kw"].get("m_cap"),
               "hypotheses": seen["kw"].get("num_hypotheses")}
        if refine_kernel is not None:
            n = 20
            row.update(kernel_call_ms=quartiles(k_ms),
                       plain_chain_ms=quartiles(plain_ms),
                       kernel_device_us=chip_smoke.graph_ms(
                           [lambda: ransac.ransac_refine(*refine_kernel)]
                           * n) / n * 1e3)
        res[f"b{b}"] = row
    out = HERE / "chiprun_out"
    out.mkdir(exist_ok=True)
    name = f"time_ransac-{args.label}.json" if args.label else \
        "time_ransac.json"
    (out / name).write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
