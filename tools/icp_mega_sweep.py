#!/usr/bin/env python3
"""Times the whole-loop ICP kernel (K4 / kernel 5, `pctpu_torch/csrc/
icp_mega.cu`) on one NVIDIA GPU at the shapes of `chip_smoke.py`'s paths,
for every number of lanes per query, beside the lanes that
`unit_plan` picks; then the fixed cost of one iteration (the same launch
over a db of one 16-point block, 101 iterations against 1) at grids of 1
to 512 CTAs. Inputs are uniform synthetic pairs made from --seed (a 2%
rotation, a 0.2 m shift); each launch is held against the plain version
on a 3-iteration cut first.

    python3 tools/icp_mega_sweep.py [--seed 0]
"""
import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# name: (pairs, points, block, window blocks, query tile, iterations)
SHAPES = {
    "P2 workload 1, windowed": (1, 16384, 1024, 1, 1024, 47),
    "P2 workload 1, exact": (1, 16384, 1024, 16, 1024, 3),
    "P3 workload 4": (1, 131072, 2048, 2, 1024, 48),
    "P1 voxel stage": (16, 2048, 2048, 1, 2048, 14),
    "P4 workload 2, windowed": (16, 4096, 512, 1, 512, 28),
    "P14 closure batch": (118, 2048, 2048, 1, 2048, 32),
}


def case(torch, mega, icp, rng, dev, b, n, block, wb, tq, iters):
    """The argument tuple of `_launch_icp_mega` for b synthetic pairs."""
    src = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    src[..., 0] *= 3.0
    ang = rng.normal(scale=0.02, size=(b, 3))
    R = np.stack([np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]],
                            [-a[1], a[0], 1]]) for a in ang])
    dst = (np.einsum("bij,bnj->bni", R, src) + 0.2).astype(np.float32)
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    T0 = torch.eye(4, device=dev).repeat(b, 1, 1)
    bdb, src3, spen, centers = icp._mega_layout(
        torch.from_numpy(src).to(dev), mask, torch.from_numpy(dst).to(dev),
        mask, T0, block, tq)
    return mega._mega_args(mega.pack_dbt5(bdb), bdb.lut[:, None, :], bdb.lo,
                           bdb.hi, bdb.axis, src3, spen, centers, T0, iters,
                           5.0, block, wb, tq, 6)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("icp_mega_sweep: no CUDA device", file=sys.stderr)
        return 2
    from pctpu_torch.ops import pallas_icp_mega as mega
    from pctpu_torch.register import icp
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    sms, ctas = mega.card_capacity(dev)
    print(f"card: {card}; {sms} SMs, {ctas} CTAs of the kernel at once")
    rng = np.random.default_rng(args.seed)
    picked = mega.unit_plan

    def forced(lanes):
        def plan(bsz, mp, tq, sms_, ctas_):
            slc = mega.THREADS * mega.QUERIES_PER_THREAD // lanes
            spt = -(-tq // slc)
            units = bsz * (mp // tq) * spt
            return dict(lanes=lanes, slice=slc, slices=spt,
                        units_per_pair=(mp // tq) * spt, units=units,
                        grid=min(units, ctas_), sms=sms_)
        return plan

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(True), torch.cuda.Event(True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / reps

    ok = True
    for name, (b, n, block, wb, tq, iters) in SHAPES.items():
        a = case(torch, mega, icp, rng, dev, b, n, block, wb, tq, iters)
        cut = a[:6] + (3,) + a[7:]
        err = float((mega._launch_icp_mega(*cut)
                     - mega.icp_mega_plain(*cut)).abs().max())
        ok &= err <= 1e-4
        plan = mega.launch_plan(a)
        times = []
        for lanes in (1, 2, 4, 8, 16, 32):
            mega.unit_plan = forced(lanes)
            try:
                times.append((lanes, mega.launch_plan(a)["grid"],
                              ms(lambda: mega._launch_icp_mega(*a), 3)))
            finally:
                mega.unit_plan = picked
        print(f"{name} ({b} x {n} points, window {block * wb}, tile {tq}, "
              f"{iters} iterations): vs plain (3 iterations) {err:.1e}; "
              f"picked lanes {plan['lanes']} ({plan['units']} units); "
              + ", ".join(f"lanes {ln}: {t:.3f} ms on {g} CTAs"
                          for ln, g, t in times))
    for n, tq, lanes in ((512, 512, 1), (16384, 1024, 1), (16384, 1024, 4),
                         (16384, 1024, 16)):
        a = list(case(torch, mega, icp, rng, dev, 1, n, 512, 1, tq, 1))
        a[0], a[8], a[9] = a[0][:, :, :16].contiguous(), 16, 1
        mega.unit_plan = forced(lanes)
        try:
            t = []
            for iters in (1, 101):
                a[6] = iters
                t.append(ms(lambda: mega._launch_icp_mega(*a)))
            grid = mega.launch_plan(a)["grid"]
        finally:
            mega.unit_plan = picked
        print(f"fixed cost per iteration on {grid} CTAs: "
              f"{(t[1] - t[0]) / 100 * 1e3:.2f} us")
    print(card)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
