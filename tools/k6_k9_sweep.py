#!/usr/bin/env python3
"""Times K6 (the banded 1-NN `nearest_banded`, `pctpu_torch/csrc/banded.cu`)
and K9 (the radius-normals moments `moments`, `pctpu_torch/csrc/fpfh.cu`)
on one NVIDIA GPU at every launch that `chip_smoke.py`'s paths give them,
on inputs made from --seed. Every time is device time: a CUDA graph of
the launches (`chip_smoke.graph_ms`).

The launches, recorded with K6 and K9 swapped for their plain versions
(so recording runs none of this file's kernels): P5's 30 K6 launches
(`icp_fixed_iters_banded` on workload 1's pair of `chip_smoke.py`'s
synthetic scan, its BANDED settings: 16,384 queries in tiles of 512
against a window of 2 x 2,048 sorted columns), and the kernel-9 phase's
two K9 launches: (a) P13's 32 voxel frames [32, 4,096] at r 1.0,
unbanded; (b) P1's 32 capped voxel clouds [32, 2,048] at r 4.0,
x-banded.

K6: each launch alone (a graph of 10 of it), the 30 together (a graph of
the 30) at `nearest_banded_plan`'s plan and at every lane count, beside
the bound (`chip_smoke.banded_nn_work`); every launch's d2 and idx equal
to `nearest_banded_plain`'s. K9: each launch at `moments_plan`'s shape,
at every CTA width and queries a warp, and in a build that visits every
step of the band (no x window), beside its pairs (in the band, in the
x-slab, within the radius) and its bound (`chip_smoke.moments_work`);
every result within one f32 ulp of `moments_plain`, its count channel
equal, and bit for bit the same at every shape and on a repeat. Also
timed, from copies of the sources under build/: K6 with 8 and with 2
queries a thread at every lane count (equal to the plain version), and
K9 in parts (the step tables alone; the tables and the x-window scan
without the feature work: results not the kernel's).

With --baseline DIR (an unpacked checkout of an earlier commit whose K6
and K9 have their first designs' C signatures: K6 one CTA per query tile,
K9 one query a thread), that checkout's kernels are timed too, in turns
with this tree's (baseline, this tree, this tree, baseline); this tree's
K6 must equal the baseline's and its K9 the baseline's bit for bit.
--baseline-only times the baseline alone. --ptxas prints the registers
and spills of both sources' kernels. Results also go to
build/k6_k9_sweep.json.

    python3 tools/k6_k9_sweep.py [--seed 0] [--baseline DIR
        [--baseline-only]] [--ptxas]
"""
import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from tools.fpfh_sweep import ptxas  # noqa: E402
from tools.k7_k12_sweep import build, c_fn, in_turns, patched  # noqa: E402

# a build of this tree's fpfh.cu whose warps visit every step of their
# band: its K9 results must stay the kernel's
EVERY_STEP = (re.compile(r"const float a = xlo - R, b = xhi \+ R;"),
              "const float a = -INFINITY, b = INFINITY;")
# builds of this tree's K9 that leave out a part, timed only (their
# results are not the kernel's): name -> (pattern, replacement)
K9_PARTS = {
    "the step tables alone (no step visited)": (
        re.compile(r"(visit_range\(table, steps, xlo, xhi, window\(r2, "
                   r"qq_max, table\.pp\), first,\n\s*last\);)"),
        r"\1\n    last = first;"),
    "tables and the x-window scan (no feature work)": (
        re.compile(r"      if \(any == 0u\) continue;\n"),
        "      if ((any | (r2 > -1.f)) != 0u) continue;\n"),
}
# other builds of this tree's K6, timed at P5 at each lane count (their
# results must stay the kernel's): name -> (pattern, replacement)
K6_VARIANTS = {
    "8 queries a thread": (re.compile(r"constexpr int kNnQpt = 4;"),
                           "constexpr int kNnQpt = 8;"),
    "2 queries a thread": (re.compile(r"constexpr int kNnQpt = 4;"),
                           "constexpr int kNnQpt = 2;"),
}
LANES = (1, 2, 4, 8, 16, 32)
THREADS = (128, 256, 512, 1024)
WARP_QUERIES = (1, 2, 4)


def record(torch, seed, dev):
    """(K6's 30 argument tuples, {case: K9's argument tuple})."""
    from pctpu_torch.core.cloud import round_up
    from pctpu_torch.features import pallas_fpfh as pf
    from pctpu_torch.ops import pallas_banded as pb
    from pctpu_torch.ops import voxel
    from pctpu_torch.pipelines import odometry
    from pctpu_torch.register import icp, pipeline

    full = cs.lidar_scan(np.random.default_rng([seed, 9]))
    rng1 = np.random.default_rng([seed, 1])             # chip_smoke P2/P5
    src = full[rng1.choice(full.shape[0], cs.N_POINTS, replace=False)]
    dst, _ = cs.perturb(src, rng1, [0.01, 0.02, 0.05], [0.5, -0.3, 0.1])
    s1 = torch.from_numpy(np.ascontiguousarray(src)).to(dev)
    d1 = torch.from_numpy(np.ascontiguousarray(dst)).to(dev)
    m1 = torch.ones((cs.N_POINTS,), dtype=torch.bool, device=dev)
    k6 = []
    with cs.swapped(pb, "_launch_nearest_banded",
                    lambda *a: k6.append(a) or pb.nearest_banded_plain(*a)):
        icp.icp_fixed_iters_banded(s1, m1, d1, m1, **cs.BANDED)

    rng13 = np.random.default_rng(5)                    # bench.py:301
    world13 = cs.slam_world(rng13)
    scans13 = cs.render_scans(world13, cs.circle_poses(cs.ODO_FRAMES, 6.0),
                              rng13, 20.0)
    cfg13 = odometry.OdometryConfig(**cs.ODO_CFG)
    cap13 = round_up(max(len(x) for x in scans13), 2048)
    pc13 = [odometry._prep(x, cap13, cfg13.voxel_leaf, dev) for x in scans13]
    pts13 = torch.stack([c.points for c in pc13])
    msk13 = torch.stack([c.mask for c in pc13])

    src_np, dst_np, _ = cs.make_pairs(full, np.random.default_rng(seed),
                                      cs.BATCH, cs.N_POINTS, cs.ROT_DEG)
    mask = torch.ones((cs.BATCH, cs.N_POINTS), dtype=torch.bool, device=dev)
    cfg = pipeline.RegistrationConfig()
    vox = [voxel.voxel_downsample_capped(
        torch.from_numpy(x).to(dev), mask, cfg.voxel_size,
        cfg.downsample_capacity)[0] for x in (src_np, dst_np)]
    pts1 = torch.cat([v.points for v in vox]).contiguous()
    msk1 = torch.cat([v.mask for v in vox]).contiguous()
    k9 = []
    with cs.swapped(pf, "moments",
                    lambda *a: k9.append(a) or pf.moments_plain(*a)):
        pf.normals_radius_fused(pts13, msk13, radius=2.5 * cfg13.voxel_leaf)
        pf.normals_radius_fused(pts1, msk1, radius=cfg.normal_radius,
                                x_banded=True, x_slack=cfg.voxel_size)
    torch.cuda.synchronize()
    return k6, dict(zip(("(a) P13 frames", "(b) P1 voxels"), k9))


def old_launchers(torch, kernels, libs, dev):
    """K6 and K9 launchers of the first designs' C entries."""
    f6 = c_fn(libs["banded"], "pct_banded_nn", 6, 5)
    f9 = c_fn(libs["fpfh"], "pct_moments", 6, 4, 1)

    def k6(q, dbt, pen, offsets, block, wb, tq):
        mp, np_ = q.shape[0], dbt.shape[1]
        d2 = torch.empty((mp,), dtype=torch.float32, device=dev)
        idx = torch.empty((mp,), dtype=torch.int32, device=dev)
        kernels.check(f6(q.data_ptr(), dbt.data_ptr(), pen.data_ptr(),
                         offsets.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                         mp, np_, block, wb, tq, kernels.stream_ptr(dev)),
                      "baseline K6")
        return d2, idx

    def k9(amat, dbmat, cent, base, nt, q_tile, db_tile, r2):
        b, np_, _ = amat.shape
        out = torch.empty((b, np_, 10), dtype=torch.float32, device=dev)
        kernels.check(f9(amat.data_ptr(), dbmat.data_ptr(), cent.data_ptr(),
                         base.data_ptr(), nt.data_ptr(), out.data_ptr(), b,
                         np_, q_tile, db_tile, r2, kernels.stream_ptr(dev)),
                      "baseline K9")
        return out
    return k6, k9


def tree_k6(torch, kernels, pb, lib, dev):
    """A K6 launcher of this tree's C entry from another build of its
    source, at `lanes` lanes a query (the build's own queries a thread set
    its units)."""
    fn = c_fn(lib, "pct_banded_nn", 6, 6)

    def k6(q, dbt, pen, offsets, block, wb, tq, lanes=32):
        mp, np_ = q.shape[0], dbt.shape[1]
        d2 = torch.empty((mp,), dtype=torch.float32, device=dev)
        idx = torch.empty((mp,), dtype=torch.int32, device=dev)
        kernels.check(fn(q.data_ptr(), dbt.data_ptr(), pen.data_ptr(),
                         offsets.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                         mp, np_, block, wb, tq, lanes,
                         kernels.stream_ptr(dev)), "K6 variant")
        return d2, idx
    return k6


def tree_k9(torch, kernels, pf, lib, dev):
    """A K9 launcher of this tree's C entry from another build of its
    source, shaped by `moments_plan` as `_launch_moments` shapes it."""
    fn = c_fn(lib, "pct_moments", 6, 7, 1)

    def k9(amat, dbmat, cent, base, nt, q_tile, db_tile, r2):
        b, np_, _ = amat.shape
        p = pf.moments_plan(b, np_, q_tile, kernels.sm_count(dev))
        out = torch.empty((b, np_, 10), dtype=torch.float32, device=dev)
        kernels.check(fn(amat.data_ptr(), dbmat.data_ptr(), cent.data_ptr(),
                         base.data_ptr(), nt.data_ptr(), out.data_ptr(), b,
                         np_, q_tile, db_tile, p["threads"], p["cta_queries"],
                         p["warp_queries"], r2, kernels.stream_ptr(dev)),
                      "K9 variant")
        return out
    return k9


def us(fn, n=10):
    """Device us of one call of fn: a CUDA graph of n calls."""
    return cs.graph_ms([fn] * n) * 1e3 / n


def us_all(launch, calls):
    """Device us a launch of `calls`: one CUDA graph of all of them."""
    return cs.graph_ms([lambda a=a: launch(*a) for a in calls]) * 1e3 \
        / len(calls)


def sweep_k6(torch, kernels, pb, calls, dev, base, tree, variants):
    sms = kernels.sm_count(dev)
    q, dbt, _, _, block, wb, tq = calls[0]
    mp = q.shape[0]
    ops, byt = cs.banded_nn_work(calls[0])
    bnd = cs.bound(byt, ops)
    want = [pb.nearest_banded_plain(*a) for a in calls]
    row = dict(launches=len(calls), Mp=mp, Np=dbt.shape[1], block=block,
               wb=wb, tq=tq, pairs=mp * wb * block, bound_us=bnd[0] * 1e3,
               bound_by=bnd[1])
    print(f"K6 on P5 (Mp {mp}, Np {dbt.shape[1]}, block {block}, wb {wb}, "
          f"tq {tq}: {mp // tq} tiles, {mp * wb * block:,} pairs a launch; "
          f"{len(calls)} launches; bound {bnd[0] * 1e3:.2f} us a launch, "
          f"{bnd[1]}); us a launch, device time:")

    def held(launch):
        """d2 and idx equal to the plain version's on every launch (so
        two launchers that pass are equal to each other)."""
        for a, (d2p, ip) in zip(calls, want):
            d2k, ik = launch(*a)
            torch.cuda.synchronize()
            assert torch.equal(d2k, d2p) and torch.equal(ik, ip), "K6"

    def timed(launch, key, label):
        each = [us(lambda a=a: launch(*a)) for a in calls]
        row[key] = dict(all=us_all(launch, calls), each_mean=np.mean(each),
                        each_min=min(each), each_max=max(each))
        r = row[key]
        print(f"  {label}: {r['all']:.2f} (a graph of the {len(calls)}); "
              f"alone {r['each_mean']:.2f} on average, {r['each_min']:.2f}"
              f"-{r['each_max']:.2f}; equal to plain on every launch")
    old = None
    if base is not None:
        old = old_launchers(torch, kernels, base, dev)[0]
        held(old)
        timed(old, "baseline", f"baseline K6 ({mp // tq} CTAs of 256 "
                               "threads, 2 queries a thread)")
    if not tree:
        return row
    plan = pb.nearest_banded_plan(mp, tq, sms)
    held(pb._launch_nearest_banded)
    timed(pb._launch_nearest_banded, "tree",
          f"this tree's K6 ({plan['units']} units = {plan['tiles']} tiles x "
          f"{plan['slices']} slices of {plan['slice']} queries, "
          f"{plan['lanes']} lanes a query, {pb.NEAREST_QPT} queries a "
          "thread)")
    row["plan"] = plan
    if old is not None:
        tb, tt = in_turns(lambda: [old(*a) for a in calls],
                          lambda: [pb._launch_nearest_banded(*a)
                                   for a in calls],
                          lambda f: cs.graph_ms([f]) * 1e3 / len(calls))
        row["in_turns"] = dict(baseline=tb, tree=tt)
        print(f"  in turns: baseline {tb:.2f} vs this {tt:.2f}")
    by = {}
    for lanes in LANES:
        p = pb.nearest_banded_plan(mp, tq, sms, lanes=lanes)

        def launch(*a, p=p):
            return pb._launch_nearest_banded(*a, plan=p)
        held(launch)
        by[lanes] = dict(units=p["units"], us=us_all(launch, calls))
    row["by_lanes"] = by
    print("    by lanes a query: " + "; ".join(
        f"{k} ({v['units']} units) {v['us']:.2f}" for k, v in by.items()))
    for name, launch in variants.items():
        by = {}
        for lanes in LANES:
            def run(*a, lanes=lanes):
                return launch(*a, lanes=lanes)
            held(run)
            by[lanes] = us_all(run, calls)
        row.setdefault("variants", {})[name] = by
        print(f"    {name}, by lanes a query: " + "; ".join(
            f"{k} {v:.2f}" for k, v in by.items()))
    return row


def sweep_k9(torch, kernels, pf, cases, dev, base, tree, every_step,
             parts):
    sms = kernels.sm_count(dev)
    inf = torch.tensor(float("inf"), device=dev)
    rows = []
    for case, a in cases.items():
        amat = a[0]
        b, np_ = amat.shape[0], amat.shape[1]
        want = pf.moments_plain(*a)
        ops, byt, pairs = cs.moments_work(a, want)
        bnd = cs.bound(byt, ops)
        row = dict(case=case, B=b, Np=np_, q_tile=a[5], db_tile=a[6],
                   r2=a[7], bound_us=bnd[0] * 1e3, bound_by=bnd[1], **pairs)
        line = (f"K9 {case} (B {b}, Np {np_}, q_tile {a[5]}, db_tile "
                f"{a[6]}, r {a[7] ** 0.5:.2f}): {pairs['in_band']:,} pairs "
                f"in the band, {pairs['x_slab']:,} in the x-slab, "
                f"{pairs['within']:,.0f} within; bound {bnd[0] * 1e3:.2f} "
                f"us ({bnd[1]})")

        def held(out):
            torch.cuda.synchronize()
            assert bool(((out >= torch.nextafter(want, -inf))
                         & (out <= torch.nextafter(want, inf))).all()), \
                (case, "K9 beyond one ulp")
            assert torch.equal(out[..., 9], want[..., 9]), (case, "counts")
            return out
        old = got = None
        if base is not None:
            old = old_launchers(torch, kernels, base, dev)[1]
            got = held(old(*a))
            row["baseline_us"] = us(lambda: old(*a))
            line += f"\n  baseline K9: {row['baseline_us']:.2f} us"
        if tree:
            plan = pf.moments_plan(b, np_, a[5], sms)
            mine = held(pf._launch_moments(*a))
            again = pf._launch_moments(*a)
            torch.cuda.synchronize()
            assert torch.equal(mine, again), (case, "K9 repeat")
            if got is not None:
                assert torch.equal(mine, got), (case, "K9 vs baseline")
            row["plan"] = plan
            row["tree_us"] = us(lambda: pf._launch_moments(*a))
            line += (f"\n  this tree's K9 ({plan['ctas']} CTAs of "
                     f"{plan['threads']}, {plan['cta_queries']} queries a "
                     f"CTA, {plan['warp_queries']} a warp): "
                     f"{row['tree_us']:.2f} us; within one ulp of plain, "
                     "counts equal, bit for bit on a repeat"
                     + (" and against the baseline" if got is not None
                        else ""))
            if old is not None:
                tb, tt = in_turns(lambda: old(*a),
                                  lambda: pf._launch_moments(*a), us)
                row["in_turns"] = dict(baseline=tb, tree=tt)
                line += f"\n  in turns: baseline {tb:.2f} vs this {tt:.2f}"
            grid = {}
            for t in THREADS:
                for wq in WARP_QUERIES:
                    p = pf.moments_plan(b, np_, a[5], sms, threads=t,
                                        warp_queries=wq)
                    if p is None:
                        continue
                    assert torch.equal(
                        held(pf._launch_moments(*a, plan=p)), mine), \
                        (case, t, wq)
                    grid[f"{t}x{wq}"] = us(
                        lambda p=p: pf._launch_moments(*a, plan=p))
            row["by_shape"] = grid
            line += "\n  us by threads x queries a warp: " + "; ".join(
                f"{k} {v:.2f}" for k, v in grid.items())
            assert torch.equal(held(every_step(*a)), mine), (case, "every")
            row["every_step_us"] = us(lambda: every_step(*a))
            line += (f"\n  every step of the band (no x window): "
                     f"{row['every_step_us']:.2f} us")
            row["parts_us"] = {name: us(lambda f=f: f(*a))
                               for name, f in parts.items()}
            line += "".join(f"\n  {name}: {v:.2f} us"
                            for name, v in row["parts_us"].items())
        print(line, flush=True)
        rows.append(row)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="an unpacked checkout whose banded.cu and fpfh.cu "
                         "are timed beside this tree's")
    ap.add_argument("--baseline-only", action="store_true",
                    help="time the baseline's kernels alone")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's registers and spills")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k6_k9_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.baseline_only and not args.baseline:
        ap.error("--baseline-only needs --baseline")
    from pctpu_torch import kernels
    from pctpu_torch.features import pallas_fpfh as pf
    from pctpu_torch.ops import pallas_banded as pb
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    tree = not args.baseline_only
    bdir = kernels.BUILD_DIR / "k6_k9_sweep"
    srcs = {}
    if args.baseline:
        bsrc = Path(args.baseline).resolve() / "pctpu_torch" / "csrc"
        srcs.update(base_banded=bsrc / "banded.cu", base_fpfh=bsrc / "fpfh.cu")
    if tree:
        kernels.build_all(("banded.cu", "fpfh.cu"))
        srcs["every_step"] = patched(kernels.CSRC / "fpfh.cu",
                                     bdir / "every_step.cu", (EVERY_STEP,))
        for i, pr in enumerate(K9_PARTS.values()):
            srcs[f"k9part{i}"] = patched(kernels.CSRC / "fpfh.cu",
                                         bdir / f"k9part{i}.cu", (pr,))
        for i, pr in enumerate(K6_VARIANTS.values()):
            srcs[f"k6var{i}"] = patched(kernels.CSRC / "banded.cu",
                                        bdir / f"k6var{i}.cu", (pr,))
    if args.ptxas:
        kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        ptxas(kernels, {k: v for k, v in dict(
            srcs, tree_banded=kernels.CSRC / "banded.cu",
            tree_fpfh=kernels.CSRC / "fpfh.cu").items()
            if k in ("base_banded", "base_fpfh", "tree_banded",
                     "tree_fpfh")})
    libs = build(kernels, srcs, bdir)
    base = None
    if args.baseline:
        base = dict(banded=libs["base_banded"], fpfh=libs["base_fpfh"])
    dev = torch.device("cuda")
    every, parts, k6_vars = None, {}, {}
    if tree:
        every = tree_k9(torch, kernels, pf, libs["every_step"], dev)
        parts = {name: tree_k9(torch, kernels, pf, libs[f"k9part{i}"], dev)
                 for i, name in enumerate(K9_PARTS)}
        k6_vars = {name: tree_k6(torch, kernels, pb, libs[f"k6var{i}"], dev)
                   for i, name in enumerate(K6_VARIANTS)}
    k6, k9 = record(torch, args.seed, dev)
    out = dict(card=cs.gpu_line(),
               k6=sweep_k6(torch, kernels, pb, k6, dev, base, tree, k6_vars),
               k9=sweep_k9(torch, kernels, pf, k9, dev, base, tree, every,
                           parts))
    path = ROOT / "build" / "k6_k9_sweep.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps(out, indent=1, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
