#!/usr/bin/env python3
"""Times K2 (`spfh`) and K3 (`wsum`), the FPFH kernels of
`pctpu_torch/csrc/fpfh.cu`, on one NVIDIA GPU at every launch that
`chip_smoke.py`'s paths give them, on inputs made from --seed. Every time
is device time: a CUDA graph of 10 launches of one launch's arguments.

The launches, recorded with K2, K3 and K9 swapped for their plain
versions (so recording runs none of this file's kernels): P1
`register_pairs` (16 pairs of 16,384 points: 2 launches of each kernel,
B 16 x 2,048); P13's round-0 `register_pairs` in the SLAM loop (bench.py
workload 5); P15's batches of 8 pairs (the registration driver's
`register_pairs` calls on P1's pairs); the kernel-9 phase (`fpfh_fused` on
P1's 32 voxel clouds with `normals_radius_fused` normals); and two
unbanded ones: P1's first launch with every db tile in every band, and
the shape of the card test in tests/test_torch_cuda.py (2 clouds of
1,024, unbanded).

For each launch: the in-band pairs it visits and the pairs within the
radius (from the plain version's counts), its bound (`chip_smoke.bound`
on `chip_smoke.fpfh_ops`' counts), and us a launch of this tree's kernels
at `fpfh_plan`'s shape, then at every CTA width and queries a warp.
K2 is also timed in a build whose within pairs are only counted (the
distance scan and the ring, no Darboux angles: `SCAN_ONLY`). Every K2
launch must equal `spfh_plain` (histograms and counts); every K3 launch
must be within chip_smoke's bound of `wsum_plain` and repeat bit for bit.

With --baseline DIR (an unpacked checkout of an earlier commit whose K2
and K3 have the first design's C signatures: one query a thread, 256
threads a CTA), that checkout's `fpfh.cu` and its scan-only build are
timed too, in turns with this tree's (baseline, this tree, this tree,
baseline), and this tree's results must equal the baseline's bit for bit.
--baseline-only times the baseline alone. --ptxas prints the registers
and spills of both sources' kernels. Results also go to
build/fpfh_sweep.json.

    python3 tools/fpfh_sweep.py [--seed 0] [--baseline DIR
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
from tools.k7_k12_sweep import build, c_fn, in_turns, patched  # noqa: E402

# K2 with its within pairs counted and not binned: (pattern, replacement)
SCAN_ONLY = (
    # the first design: the Darboux work of a within pair, up to its count
    (re.compile(r"      const float v0 = sdb\[3\]\[c\](?:.*\n)*?"
                r"      cnt \+= 1\.f;\n"), "      cnt += 1.f;\n"),
    # this tree: a drained pair adds 1 to its query's first bin only
    (re.compile(r"    bin_pair\(qa \+ slot \* 11, dbb, Np, col, d2s\[e\], "
                r"hist \+ slot \* kH\);"),
     "    atomicAdd(hist + slot * kH, 1);"),
)
# other builds of this tree's source, timed at each launch: name ->
# (pattern, replacement); their results must stay the kernels'
VARIANTS = {
    "every step of the band (no x window)": (
        re.compile(r"const float a = xlo - R, b = xhi \+ R;"),
        "const float a = -INFINITY, b = INFINITY;"),
    "K3 batches of 4": (re.compile(r"constexpr int kBatch = 8;"),
                        "constexpr int kBatch = 4;"),
    "K3 batches of 16": (re.compile(r"constexpr int kBatch = 8;"),
                         "constexpr int kBatch = 16;"),
}
# builds whose results are not the kernels', timed only: name ->
# (pattern, replacement)
TIMING_ONLY = {
    "K3 without its within pairs (the scan, ballots and weights)": (
        re.compile(r"        tail\[s\] \+= __popc\(m\);\n"), ""),
}
WARP_QUERIES = (1, 2, 4)
THREADS = (128, 256, 512, 1024)


def record(torch, seed, dev):
    """{path: [(spfh args, wsum args), ...]} of the launches in
    chip_smoke.py's paths (see the module docstring)."""
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.features import pallas_fpfh as pf
    from pctpu_torch.ops import voxel
    from pctpu_torch.pipelines import odometry
    from pctpu_torch.register import pipeline

    def recorded(fn):
        """The (spfh, wsum) arguments of fn's launches. The paths run with
        K2, K3 and K9 swapped for their plain versions, so recording
        launches none of this file's kernels (K2's plain version equals the
        kernel, so K3's recorded inputs are the kernel's)."""
        calls = {"spfh": [], "wsum": []}

        def stand_in(name):
            plain = getattr(pf, name + "_plain")
            return lambda *a: calls[name].append(a) or plain(*a)
        with cs.swapped(pf, "spfh", stand_in("spfh")), \
                cs.swapped(pf, "wsum", stand_in("wsum")), \
                cs.swapped(pf, "moments", pf.moments_plain):
            fn()
        torch.cuda.synchronize()
        return list(zip(calls["spfh"], calls["wsum"]))

    full = cs.lidar_scan(np.random.default_rng([seed, 9]))
    src_np, dst_np, _ = cs.make_pairs(full, np.random.default_rng(seed),
                                      cs.BATCH, cs.N_POINTS, cs.ROT_DEG)
    mask = torch.ones((cs.BATCH, cs.N_POINTS), dtype=torch.bool, device=dev)
    src = PointCloud(torch.from_numpy(src_np).to(dev), mask)
    dst = PointCloud(torch.from_numpy(dst_np).to(dev), mask)
    cfg = pipeline.RegistrationConfig()
    out = {}
    out["P1 register_pairs"] = recorded(lambda: pipeline.register_pairs(
        src, dst, cfg=cfg, generator=torch.Generator(dev).manual_seed(0)))

    rng13 = np.random.default_rng(5)                    # bench.py:301
    world13 = cs.slam_world(rng13)
    scans13 = cs.render_scans(world13, cs.circle_poses(cs.ODO_FRAMES, 6.0),
                              rng13, 20.0)
    out["P13 round 0"] = recorded(lambda: odometry.run_odometry(
        scans13, odometry.OdometryConfig(**cs.ODO_CFG)))

    def p15():
        for b0 in range(0, cs.BATCH, 8):
            part = slice(b0, b0 + 8)
            pipeline.register_pairs(
                PointCloud(src.points[part], mask[part]),
                PointCloud(dst.points[part], mask[part]), cfg=cfg,
                generator=torch.Generator(dev).manual_seed(b0))
    out["P15 driver batches"] = recorded(p15)

    vox = [voxel.voxel_downsample_capped(pc.points, pc.mask, cfg.voxel_size,
                                         cfg.downsample_capacity)[0]
           for pc in (src, dst)]
    pts1 = torch.cat([v.points for v in vox]).contiguous()
    msk1 = torch.cat([v.mask for v in vox]).contiguous()
    kw = dict(x_banded=True, x_slack=cfg.voxel_size)
    out["kernel-9 phase"] = recorded(lambda: pf.fpfh_fused(
        pts1, msk1, normals=pf.normals_radius_fused(
            pts1, msk1, radius=cfg.normal_radius, **kw),
        radius=cfg.feature_radius, **kw))

    (a, w), = out["P1 register_pairs"][:1]
    out["P1 unbanded"] = [unbanded(torch, pf, a, w)]
    out["card test unbanded"] = [card_test_case(torch, pf, dev)]
    return out


def unbanded(torch, pf, a, w):
    """A launch's arguments with tables that visit every db tile."""
    amat, dbmat, base, nt, q_tile, db_tile, r2 = a
    base = torch.zeros_like(base)
    nt = torch.full_like(nt, amat.shape[1] // db_tile)
    s33, _ = pf.spfh_plain(amat, dbmat, base, nt, q_tile, db_tile, r2)
    return ((amat, dbmat, base, nt, q_tile, db_tile, r2),
            (amat, dbmat, base, nt, s33, q_tile, db_tile, r2))


def card_test_case(torch, pf, dev):
    """tests/test_torch_cuda.py's `_fpfh_inputs` (rng 7, 2 clouds of 4,096
    points voxelised to 1,024), with unbanded tables."""
    from pctpu_torch.features.fpfh_dense import normals_radius_dense
    from pctpu_torch.ops.voxel import voxel_downsample_capped
    gen = np.random.default_rng(7)
    g = gen.uniform(-20, 20, (2, 4096, 2))
    pts = np.concatenate([g, (0.1 * g[..., :1] + gen.normal(
        scale=0.3, size=(2, 4096, 1)))], axis=-1).astype(np.float32)
    down, _ = voxel_downsample_capped(
        torch.from_numpy(pts).to(dev),
        torch.ones((2, 4096), dtype=torch.bool, device=dev), 1.0, 1024)
    nrm = normals_radius_dense(down.points, down.mask, radius=2.0)
    amat, dbmat, _ = pf._pack(down.points, down.mask, nrm, 1024)
    nq = 1024 // 256
    base = torch.zeros((2, nq), dtype=torch.int32, device=dev)
    nt = torch.full((2, nq), 2, dtype=torch.int32, device=dev)
    a = (amat, dbmat, base, nt, 256, 512, 25.0)
    s33, _ = pf.spfh_plain(*a)
    return a, (amat, dbmat, base, nt, s33, 256, 512, 25.0)


def old_launchers(torch, kernels, lib, dev):
    """K2 and K3 launchers of the first design's C entries."""
    fs, fw = (c_fn(lib, n, 6, 4, 1) for n in ("pct_spfh", "pct_wsum"))

    def spfh(amat, dbmat, base, nt, q_tile, db_tile, r2):
        b, np_, _ = amat.shape
        hist = torch.empty((b, np_, 33), dtype=torch.float32, device=dev)
        cnt = torch.empty((b, np_), dtype=torch.float32, device=dev)
        kernels.check(fs(amat.data_ptr(), dbmat.data_ptr(), base.data_ptr(),
                         nt.data_ptr(), hist.data_ptr(), cnt.data_ptr(), b,
                         np_, q_tile, db_tile, r2, kernels.stream_ptr(dev)),
                      "baseline spfh")
        return hist, cnt

    def wsum(amat, dbmat, base, nt, s33, q_tile, db_tile, r2):
        b, np_, _ = amat.shape
        out = torch.empty((b, np_, 33), dtype=torch.float32, device=dev)
        kernels.check(fw(amat.data_ptr(), dbmat.data_ptr(), base.data_ptr(),
                         nt.data_ptr(), s33.data_ptr(), out.data_ptr(), b,
                         np_, q_tile, db_tile, r2, kernels.stream_ptr(dev)),
                      "baseline wsum")
        return out
    return spfh, wsum


def tree_from(torch, kernels, pf, lib, dev):
    """K2 and K3 launchers of this tree's C entries from another build of
    its source, shaped as `_launch_spfh` and `_launch_wsum` shape them."""
    fs, fw = (c_fn(lib, n, 6, 7, 1) for n in ("pct_spfh", "pct_wsum"))

    def shape(amat, kernel, threads):
        return pf.fpfh_plan(amat.shape[0], amat.shape[1],
                            kernels.sm_count(dev), threads=threads)[kernel]

    def spfh(amat, dbmat, base, nt, q_tile, db_tile, r2, threads=None):
        b, np_, _ = amat.shape
        p = shape(amat, "spfh", threads)
        hist = torch.empty((b, np_, 33), dtype=torch.float32, device=dev)
        cnt = torch.empty((b, np_), dtype=torch.float32, device=dev)
        kernels.check(fs(amat.data_ptr(), dbmat.data_ptr(), base.data_ptr(),
                         nt.data_ptr(), hist.data_ptr(), cnt.data_ptr(), b,
                         np_, q_tile, db_tile, p["threads"], p["cta_queries"],
                         p["warp_queries"], r2, kernels.stream_ptr(dev)),
                      "spfh variant")
        return hist, cnt

    def wsum(amat, dbmat, base, nt, s33, q_tile, db_tile, r2, threads=None):
        b, np_, _ = amat.shape
        p = shape(amat, "wsum", threads)
        out = torch.empty((b, np_, 33), dtype=torch.float32, device=dev)
        kernels.check(fw(amat.data_ptr(), dbmat.data_ptr(), base.data_ptr(),
                         nt.data_ptr(), s33.data_ptr(), out.data_ptr(), b,
                         np_, q_tile, db_tile, p["threads"], p["cta_queries"],
                         p["warp_queries"], r2, kernels.stream_ptr(dev)),
                      "wsum variant")
        return out
    return spfh, wsum


def us(fn):
    """Device us of one call of fn: a CUDA graph of 10 calls."""
    return cs.graph_ms([fn] * 10) * 1e2


def pairs(torch, pf, a):
    """(visited, within) pairs of one K2 launch: every in-band pair, and
    those within the radius (the plain version's counts where its
    histogram is not empty: a query without neighbours counts 1)."""
    amat, dbmat, base, nt, q_tile, db_tile, r2 = a
    hist, cnt = pf.spfh_plain(*a)
    visited = int(nt.sum()) * q_tile * db_tile
    within = float(torch.where(hist[..., :11].sum(-1) > 0, cnt, 0.0).sum())
    return visited, within, hist, cnt


def sweep(torch, kernels, pf, launches, dev, base_fns, scan_fns, tree,
          variants, timing_only):
    """Prints and returns one row per recorded launch."""
    sms = kernels.sm_count(dev)
    rows = []
    for path, calls in launches.items():
        for j, (a, w) in enumerate(calls):
            amat = a[0]
            b, np_ = amat.shape[0], amat.shape[1]
            visited, within, hp, cp = pairs(torch, pf, a)
            wp = pf.wsum_plain(*w[:4], hp, *w[5:])
            w = w[:4] + (hp,) + w[5:]
            ops2, ops3 = 10.0 * visited + 70.0 * within, \
                8.0 * visited + 68.0 * within
            b2 = cs.bound(cs.nbytes(*a[:4], hp, cp), ops2)
            b3 = cs.bound(cs.nbytes(*w[:5], wp), ops3)
            row = dict(path=path, launch=j, B=b, Np=np_, db_tile=a[5],
                       tiles_visited=int(a[3].sum()), visited=visited,
                       within=within, spfh_bound_us=b2[0] * 1e3,
                       spfh_bound_by=b2[1], wsum_bound_us=b3[0] * 1e3,
                       wsum_bound_by=b3[1])
            # within pairs a query and a CTA of the default plan: the
            # heaviest CTA bounds a launch whose CTAs fit one wave
            nq_ = torch.where(hp[..., :11].sum(-1) > 0, cp, 0.0)
            cq = pf.fpfh_plan(b, np_, kernels.sm_count(dev))["spfh"][
                "cta_queries"]
            per_cta = nq_.reshape(-1, cq).sum(-1)
            row.update(within_query_max=float(nq_.max()),
                       within_cta_mean=float(per_cta.mean()),
                       within_cta_max=float(per_cta.max()))
            line = (f"{path} #{j} (B {b}, Np {np_}, db_tile {a[5]}, "
                    f"{row['tiles_visited']} of {b * (np_ // 256) * np_ // a[5]}"
                    f" (query tile, db tile) visits): {visited:,} pairs, "
                    f"{within:,.0f} within ({within / max(visited, 1):.2%}; "
                    f"a query at most {row['within_query_max']:.0f}, a CTA "
                    f"{row['within_cta_mean']:.0f} on average and at most "
                    f"{row['within_cta_max']:.0f}); "
                    f"bound K2 {b2[0] * 1e3:.2f} us ({b2[1]}), K3 "
                    f"{b3[0] * 1e3:.2f} us ({b3[1]})")

            def held(hk, ck, wk):
                torch.cuda.synchronize()
                assert torch.equal(ck, cp) and torch.equal(hk, hp), \
                    (path, j, "spfh")
                diff = (wk - wp).abs()
                flips, mean, mx = (float((diff > 0.5).float().mean()),
                                   float(diff.mean()), float(diff.max()))
                assert flips < 2e-3 and mean < 0.02 and mx < 15.0, \
                    (path, j, "wsum", flips, mean, mx)
                return mx
            if base_fns is not None:
                bs, bw = base_fns
                hb, cb = bs(*a)
                wb = bw(*w)
                row["baseline_wsum_err"] = held(hb, cb, wb)
                row["baseline_spfh_us"] = us(lambda: bs(*a))
                row["baseline_spfh_scan_us"] = us(lambda: scan_fns[0](*a))
                row["baseline_wsum_us"] = us(lambda: bw(*w))
                line += (f"\n  baseline kernels: K2 {row['baseline_spfh_us']:.2f}"
                         f" us (scan alone {row['baseline_spfh_scan_us']:.2f}"
                         f"), K3 {row['baseline_wsum_us']:.2f} us")
            if tree:
                plan = pf.fpfh_plan(b, np_, sms)
                hk, ck = pf._launch_spfh(*a)
                wk = pf._launch_wsum(*w)
                row["wsum_err"] = held(hk, ck, wk)
                again = pf._launch_wsum(*w)
                torch.cuda.synchronize()
                assert torch.equal(again, wk), (path, j, "wsum repeat")
                if base_fns is not None:
                    assert torch.equal(wk, wb), (path, j, "wsum vs baseline")
                row["plan"] = plan["spfh"]
                row["spfh_us"] = us(lambda: pf._launch_spfh(*a))
                row["spfh_scan_us"] = us(lambda: scan_fns[-1](*a))
                row["wsum_us"] = us(lambda: pf._launch_wsum(*w))
                shp = plan["spfh"]
                line += (f"\n  this tree ({shp['ctas']} CTAs of "
                         f"{shp['threads']}, {shp['cta_queries']} queries a "
                         f"CTA, {shp['warp_queries']} a warp): K2 "
                         f"{row['spfh_us']:.2f} us (scan alone "
                         f"{row['spfh_scan_us']:.2f}), K3 "
                         f"{row['wsum_us']:.2f} us; K3 vs plain max |diff| "
                         f"{row['wsum_err']:.1e}")
                if base_fns is not None:
                    t2 = in_turns(lambda: base_fns[0](*a),
                                  lambda: pf._launch_spfh(*a), us)
                    t3 = in_turns(lambda: base_fns[1](*w),
                                  lambda: pf._launch_wsum(*w), us)
                    row["in_turns"] = dict(spfh=t2, wsum=t3)
                    line += (f"\n  in turns (baseline vs this): K2 {t2[0]:.2f} vs"
                             f" {t2[1]:.2f}, K3 {t3[0]:.2f} vs {t3[1]:.2f}")
                grid = {}
                for t in THREADS:
                    for wq in WARP_QUERIES:
                        p = pf.fpfh_plan(b, np_, sms, threads=t,
                                         warp_queries=wq)
                        if p is None:
                            continue
                        hk, ck = pf._launch_spfh(*a, plan=p)
                        wp_ = pf._launch_wsum(*w, plan=p)
                        held(hk, ck, wp_)
                        assert torch.equal(wp_, wk), (path, j, t, wq)
                        grid[f"{t}x{wq}"] = (
                            us(lambda p=p: pf._launch_spfh(*a, plan=p)),
                            us(lambda p=p: pf._launch_wsum(*w, plan=p)))
                row["by_shape"] = grid
                line += "\n  K2 / K3 us by threads x queries a warp: " + \
                    "; ".join(f"{k} {v[0]:.2f} / {v[1]:.2f}"
                              for k, v in grid.items())
                var = {}
                for name, (vs, vw) in variants.items():
                    hv, cv = vs(*a)
                    wv = vw(*w)
                    held(hv, cv, wv)
                    torch.cuda.synchronize()
                    assert torch.equal(wv, wk), (path, j, name)
                    var[name] = (us(lambda f=vs: f(*a)),
                                 us(lambda f=vw: f(*w)))
                    if name.startswith("K3"):
                        var[name + ", 1024 threads"] = (
                            us(lambda f=vs: f(*a, threads=1024)),
                            us(lambda f=vw: f(*w, threads=1024)))
                for name, (vs, vw) in timing_only.items():
                    var[name] = (us(lambda f=vs: f(*a)),
                                 us(lambda f=vw: f(*w)))
                row["variants"] = var
                if var:
                    line += "\n  variants (K2 / K3 us): " + "; ".join(
                        f"{k} {v[0]:.2f} / {v[1]:.2f}" for k, v in var.items())
            print(line, flush=True)
            rows.append(row)
    return rows


def ptxas(kernels, sources):
    for name, src in sources.items():
        out = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
             str(kernels.BUILD_DIR / "ptxas.so"), str(src)],
            capture_output=True, text=True)
        print(f"ptxas, {name}:")
        print("\n".join(ln for ln in out.stderr.splitlines()
                        if "registers" in ln or "spill" in ln
                        or "Compiling entry" in ln or "error" in ln))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="an unpacked checkout whose fpfh.cu is timed "
                         "beside this tree's")
    ap.add_argument("--baseline-only", action="store_true",
                    help="time the baseline's kernels alone")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's registers and spills")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fpfh_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.baseline_only and not args.baseline:
        ap.error("--baseline-only needs --baseline")
    from pctpu_torch import kernels
    from pctpu_torch.features import pallas_fpfh as pf
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    tree = not args.baseline_only
    bdir = kernels.BUILD_DIR / "fpfh_sweep"
    srcs = {}
    if args.baseline:
        srcs["base"] = Path(args.baseline).resolve() / "pctpu_torch" / \
            "csrc" / "fpfh.cu"
    if tree:
        srcs["tree"] = kernels.CSRC / "fpfh.cu"
    if args.ptxas:
        ptxas(kernels, dict(srcs, tree=kernels.CSRC / "fpfh.cu"))
    todo = dict(srcs)
    todo.update({f"{k}_scan": patched(s, bdir / f"{k}_scan.cu", SCAN_ONLY)
                 for k, s in srcs.items()})
    if tree:
        todo.update({f"variant{v}": patched(srcs["tree"],
                                            bdir / f"variant{v}.cu", (pr,))
                     for v, pr in enumerate(VARIANTS.values())})
        todo.update({f"timing{v}": patched(srcs["tree"],
                                           bdir / f"timing{v}.cu", (pr,))
                     for v, pr in enumerate(TIMING_ONLY.values())})
    libs = build(kernels, todo, bdir)
    dev = torch.device("cuda")
    base_fns = None if not args.baseline else old_launchers(
        torch, kernels, libs["base"], dev)
    scan_fns = []
    if args.baseline:
        scan_fns.append(old_launchers(torch, kernels, libs["base_scan"],
                                      dev)[0])
    variants, timing_only = {}, {}
    if tree:
        timing_only = {name: tree_from(torch, kernels, pf, libs[f"timing{v}"],
                                       dev)
                       for v, name in enumerate(TIMING_ONLY)}
        scan_fns.append(tree_from(torch, kernels, pf, libs["tree_scan"],
                                  dev)[0])
        variants = {name: tree_from(torch, kernels, pf, libs[f"variant{v}"],
                                    dev)
                    for v, name in enumerate(VARIANTS)}
    launches = record(torch, args.seed, dev)
    rows = sweep(torch, kernels, pf, launches, dev, base_fns, scan_fns, tree,
                 variants, timing_only)
    out = ROOT / "build" / "fpfh_sweep.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(dict(card=cs.gpu_line(), rows=rows), indent=1,
                              default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
