#!/usr/bin/env python3
"""Kernel V (`voxel_run_means`, `csrc/voxel.cu`) timed on one NVIDIA GPU
at the shapes of `register_pair` on whole HDL-64E scans: `chip_smoke.py`'s
synthetic 124,668-point scan and its copy moved 35 deg, voxel 2 m
(`RegistrationConfig()`).

One `voxel_downsample` of each cloud records the inputs it gives
`voxel_run_means`; on those inputs, beside the bound
(`chip_smoke.voxel_work` at the card's peaks):
- the kernel's device time: both launches in one CUDA graph, replayed
  between CUDA events (`chip_smoke.graph_ms`), and by CUDA events around
  eager launches;
- the plain version `_run_means_plain` (float64 cumsum differences) on
  the same CUDA tensors, CUDA events;
- the library route it replaced, one `torch.cumsum` over the clouds'
  [N,4] float64 values, CUDA events;
- the whole `voxel_downsample` of both clouds, with the kernel and with
  the plain version bound in its place, host clock between two
  synchronizes;
- each run's length, and the kernel's centroids against the plain
  version's (rows that differ, largest gap).

    python3 tools/time_voxel.py [--seed 0] [--reps 20]

Prints one JSON line and writes it to `chiprun_out/time_voxel.json`.
"""
import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "chiprun_out"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=20)
    args = p.parse_args(argv)

    import torch
    import chip_smoke
    from pctpu_torch.ops import voxel
    from pctpu_torch.register.pipeline import RegistrationConfig
    if not torch.cuda.is_available():
        print("time_voxel: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    rng = np.random.default_rng([args.seed, 9])
    scan = chip_smoke.lidar_scan(rng)
    src, dst, _ = chip_smoke.make_pairs(scan, rng, 1, len(scan),
                                        chip_smoke.ROT_DEG)
    leaf = RegistrationConfig().voxel_size
    clouds = [torch.from_numpy(c[0]).to(dev) for c in (src, dst)]
    mask = torch.ones(len(scan), dtype=torch.bool, device=dev)

    def downsample_both():
        return [voxel.voxel_downsample(c, mask, leaf) for c in clouds]

    with chip_smoke.Recorder(voxel, "voxel_run_means") as rec:
        downs = downsample_both()
        torch.cuda.synchronize()
    calls = rec.calls
    runs = []
    for (ps, ms, new_run, s_v, nv), d in zip(calls, downs):
        seg = torch.cumsum(new_run.long(), 0) - 1
        lens = torch.bincount(seg[ms], minlength=int(nv)).cpu().numpy()
        plain = voxel._run_means_plain(ps, ms, new_run, s_v)[:int(nv)]
        got = d.points[:int(nv)]
        runs.append(dict(
            voxels=int(nv), longest_run=int(lens.max()),
            mean_run=float(lens.mean()),
            rows_differing_from_plain=int((plain != got).any(1).sum()),
            max_gap_to_plain=float((plain - got).abs().max())))

    kernel_graph_ms = chip_smoke.graph_ms(
        [lambda a=a: voxel._launch_run_means(*a) for a in calls],
        reps=args.reps)
    kernel_ms = chip_smoke.cuda_ms(
        lambda: [voxel._launch_run_means(*a) for a in calls], reps=args.reps)
    plain_ms = chip_smoke.cuda_ms(
        lambda: [voxel._run_means_plain(*a[:4]) for a in calls],
        reps=args.reps)
    vals = [torch.cat([torch.where(a[1][:, None], a[0], 0.0),
                       a[1][:, None].float()], dim=1).double() for a in calls]
    library_ms = chip_smoke.cuda_ms(
        lambda: [torch.cumsum(v, dim=0) for v in vals], reps=args.reps)
    work = [chip_smoke.voxel_work(a) for a in calls]
    bound_ms, bound_by = chip_smoke.bound(sum(w[1] for w in work),
                                          sum(w[0] for w in work))

    def host_ms(fn):
        out = []
        for _ in range(args.reps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            out.append((time.perf_counter() - t) * 1e3)
        return statistics.median(out)
    whole_kernel_ms = host_ms(downsample_both)
    with chip_smoke.swapped(voxel, "_launch_run_means",
                            lambda *a: voxel._run_means_plain(*a[:4])):
        whole_plain_ms = host_ms(downsample_both)
    res = dict(device=gpu, torch=torch.__version__, points=len(scan),
               leaf=leaf, launches=len(calls), runs=runs,
               kernel_graph_ms=kernel_graph_ms, kernel_ms=kernel_ms,
               bound_ms=bound_ms, bound_by=bound_by, plain_ms=plain_ms,
               library_cumsum_ms=library_ms,
               voxel_downsample_both_ms=whole_kernel_ms,
               voxel_downsample_both_plain_ms=whole_plain_ms)
    OUT.mkdir(exist_ok=True)
    (OUT / "time_voxel.json").write_text(json.dumps(res, indent=1))
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
