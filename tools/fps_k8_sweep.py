#!/usr/bin/env python3
"""Times kernels 10/11 (furthest-point sampling, `pctpu_torch/csrc/fps.cu`)
and K8 (the fused banded ICP moments, `pctpu_torch/csrc/banded.cu`) on one
NVIDIA GPU at the shapes of `chip_smoke.py`'s paths, on inputs made from
--seed.

FPS: at each shape, microseconds per step (device time of the launch,
a CUDA graph of 10, over its m - 1 steps) of the launch `fps_plan`
picks and of every other CTA width it allows, each idx held equal to
`fps_plain`; beside them the empty step at the same width
(`pct_fps_floor`: one barrier and the winner reduction, no distance
work) and the data-sheet bound per step.

K8: P5's 30 launches, recorded from `icp_fixed_iters_banded_fused_v2` on
workload 1's pair of `chip_smoke.py`'s synthetic scan, as device time (a
CUDA graph of the 30 launches); one query tile alone (the time of one
unit's CTAs); the launch with its tie handling removed from a copy of
the source (built under build/); and every lane count the plan takes.
Each launch's per-tile moments are held against
`icp_moments_banded_v2_plain` (1e-12 relative).

With --baseline DIR (an unpacked checkout of an earlier commit), that
checkout's `fps.cu` and `banded.cu` are built too and each shape is timed
in turns: baseline, this tree, this tree, baseline; the baseline's K8 is
also timed on one tile and without its tie branch.

    python3 tools/fps_k8_sweep.py [--seed 0] [--baseline DIR] [--ptxas]
"""
import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FP32_PEAK, HBM_RATE = 67e12, 3.35e12     # H100 SXM data sheet
# name: (B clouds, N points, m picks)
FPS_SHAPES = {
    "SA1 cls-msg/cls-ssg (P7, P8, P10, P11)": (32, 4096, 512),
    "SA2 cls-msg/cls-ssg": (32, 512, 128),
    "P9 kernel 10 (one cloud)": (1, 1024, 512),
    "P9 batched SA1": (4, 1024, 512),
    "P12 toy SA1 (N < m)": (8, 128, 512),
    "P12 toy SA2": (8, 512, 128),
}
WIDTHS = (32, 64, 128, 256, 512, 1024)
# the tie handling of K8's column loop, in the parent's source (a branch)
# and in this tree's (a flag per column): the variant without it keeps only
# the strict minimum
TIE_BRANCHES = (
    (re.compile(r"\} else if \(d2 == bmin\[s\]\) \{   // tie: average the "
                r"block's ties\n(?:.*\n){4}\s*\}"), "}"),
    (re.compile(r"teq\[s\] = teq\[s\] \|\| d2 == bmin\[s\];"), ""),
)


def surface_clouds(rng, b, n):
    """Points on spheres and box surfaces in the unit ball, [b,n,3] f32
    (the density of ModelNet-style clouds)."""
    p = rng.normal(size=(b, n, 3))
    p /= np.linalg.norm(p, axis=2, keepdims=True)
    p[1::2] /= np.abs(p[1::2]).max(axis=2, keepdims=True)
    p *= rng.uniform(0.5, 1.0, (b, 1, 3))
    return (p / np.linalg.norm(p, axis=2).max(axis=1)[:, None, None]
            ).astype(np.float32)


def graph_ms(torch, fns, reps=5):
    """Device ms of one pass over the thunks `fns`, captured in one CUDA
    graph and replayed `reps` times."""
    for f in fns:
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def build(kernels, sources, out_dir):
    """{stem: ctypes library} of `sources` (paths), built with this tree's
    flags, all nvcc processes at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = out_dir / f"{src.stem}.so"
        procs[src.stem] = (out, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for stem, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {stem}:\n"
                               + log.decode(errors="replace"))
        libs[stem] = ctypes.CDLL(str(out))
    return libs


def without_ties(src: Path, out: Path) -> Path:
    """A copy of banded.cu whose K8 column loop has no tie branch."""
    text = src.read_text()
    n = 0
    for pat, rep in TIE_BRANCHES:
        text, k = pat.subn(rep, text)
        n += k
    if n == 0:
        raise RuntimeError(f"no tie branch found in {src}")
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(text)
    return out


def c_fn(lib, name, n_ptr, n_int, n_float=0):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def in_turns(torch, base_fn, tree_fn, timer):
    """(baseline, tree) times, measured baseline, tree, tree, baseline."""
    t = [timer(f) for f in (base_fn, tree_fn, tree_fn, base_fn)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


# ---------------------------------------------------------------------------
# FPS
# ---------------------------------------------------------------------------

def fps_bound_us(b, n, m):
    """Data-sheet bound of one step in us: about 12 flops a point."""
    return max(12.0 * b * n / FP32_PEAK, (b * n * 13 + b * 4) / (m - 1)
               / HBM_RATE) * 1e6


def sweep_fps(torch, kernels, pf, rng, dev, base):
    print("FPS (us per step; floor = the empty step at the same CTA "
          "width; bound from 12 flops a point):")
    floor = kernels.entry("fps.cu", "pct_fps_floor", n_ptr=1, n_int=4)
    sms = kernels.sm_count(dev)
    for name, (b, n, m) in FPS_SHAPES.items():
        pts = torch.from_numpy(surface_clouds(rng, b, n)).to(dev)
        elig = torch.ones((b, n), dtype=torch.bool, device=dev)
        want = pf.fps_plain(pts, m, elig)
        steps = m - 1
        out = torch.empty((b, m), dtype=torch.int32, device=dev)

        def floor_us(threads):
            def run():
                kernels.check(floor(out.data_ptr(), b, n, m, threads,
                                    kernels.stream_ptr(dev)), "fps floor")
            return graph_ms(torch, [run] * 10) * 1e2 / steps
        line = (f"  {name} (B {b}, N {n}, m {m}): bound "
                f"{fps_bound_us(b, n, m):.4f}")
        if base is not None:
            old = c_fn(base["fps"], "pct_fps", 4, 3)
            idx = torch.empty((b, m), dtype=torch.int32, device=dev)
            scratch = torch.empty((b, n), dtype=torch.float32, device=dev)

            def run_old():
                kernels.check(old(pts.data_ptr(), elig.data_ptr(),
                                  idx.data_ptr(), scratch.data_ptr(), b, n, m,
                                  kernels.stream_ptr(dev)), "baseline fps")
            run_old()
            torch.cuda.synchronize()
            assert torch.equal(idx, want), name
            old_threads = min(1024, -(-n // 32) * 32)
            line += (f"; baseline ({old_threads} threads) "
                     f"{graph_ms(torch, [run_old] * 10) * 1e2 / steps:.3f}"
                     f", its floor {floor_us(old_threads):.3f}")
        plan = pf.fps_plan(b, n, m, sms)
        got = pf._launch_fps(pts, m, elig)
        torch.cuda.synchronize()
        assert torch.equal(got, want), name
        line += (f"; plan {plan['threads']} threads x {plan['per']} "
                 f"({plan['mode']})")
        if base is not None:
            tb, tt = in_turns(torch, run_old,
                              lambda: pf._launch_fps(pts, m, elig),
                              lambda f: graph_ms(torch, [f] * 10))
            line += (f": baseline {tb * 1e2 / steps:.3f} vs this "
                     f"{tt * 1e2 / steps:.3f}")
        print(line)
        rows = []
        for threads in WIDTHS:
            p = pf.fps_plan(b, n, m, sms, threads=threads)
            got = pf._launch_fps(pts, m, elig, plan=p)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, threads)
            t = graph_ms(torch, [lambda p=p: pf._launch_fps(
                pts, m, elig, plan=p)] * 10) * 1e2 / steps
            rows.append(f"{threads} x {p['per']} ({p['mode']}) {t:.3f} "
                        f"(floor {floor_us(threads):.3f})")
        print("    by width: " + "; ".join(rows))


# ---------------------------------------------------------------------------
# K8
# ---------------------------------------------------------------------------

def p5_launches(torch, seed, dev):
    """The argument tuples of P5's 30 K8 launches (workload 1's pair of
    chip_smoke.py's synthetic scan, `icp_fixed_iters_banded_fused_v2` with
    chip_smoke.py's BANDED settings)."""
    import chip_smoke as cs
    from pctpu_torch.ops import pallas_banded as pb
    from pctpu_torch.register import icp
    full = cs.lidar_scan(np.random.default_rng([seed, 9]))
    rng1 = np.random.default_rng([seed, 1])
    src = full[rng1.choice(full.shape[0], cs.N_POINTS, replace=False)]
    dst, _ = cs.perturb(src, rng1, [0.01, 0.02, 0.05], [0.5, -0.3, 0.1])
    s1 = torch.from_numpy(np.ascontiguousarray(src)).to(dev)
    d1 = torch.from_numpy(np.ascontiguousarray(dst)).to(dev)
    mask = torch.ones((cs.N_POINTS,), dtype=torch.bool, device=dev)
    calls = []
    launch = pb._launch_icp_moments_banded_v2

    def rec(*a):
        calls.append(a)
        return launch(*a)
    pb._launch_icp_moments_banded_v2 = rec
    try:
        icp.icp_fixed_iters_banded_fused_v2(s1, mask, d1, mask,
                                            **cs.BANDED)
    finally:
        pb._launch_icp_moments_banded_v2 = launch
    return calls


def one_tile(args):
    """The first query tile of a K8 argument tuple alone."""
    scal, lut, centers, src3, spen, dbt4, pen2t, block, wb, tq, th2 = args
    return (scal, lut, centers[:3].contiguous(),
            src3[:, :tq].contiguous(), spen[:tq].contiguous(), dbt4, pen2t,
            block, wb, tq, th2)


def old_k8(torch, kernels, lib, dev):
    """A launcher of the parent's K8 C entry (one CTA per query tile)."""
    fn = c_fn(lib, "pct_banded_moments_v2", 8, 5, 1)

    def launch(scal, lut, centers, src3, spen, dbt4, pen2t, block, wb, tq,
               th2):
        mp, np_ = src3.shape[1], dbt4.shape[1]
        out = torch.empty((mp // tq, 16), dtype=torch.float64, device=dev)
        kernels.check(fn(scal.data_ptr(), lut.data_ptr(), centers.data_ptr(),
                         src3.data_ptr(), spen.data_ptr(), dbt4.data_ptr(),
                         pen2t.data_ptr(), out.data_ptr(), mp, np_, block, wb,
                         tq, th2, kernels.stream_ptr(dev)), "baseline K8")
        return out
    return launch


def tree_k8(torch, kernels, pb, lib, dev):
    """A launcher of this tree's K8 C entry from another build of it (the
    variant without the tie branch), at the plan's lanes."""
    fn = c_fn(lib, "pct_banded_moments_v2", 10, 6, 1)
    sms = kernels.sm_count(dev)

    def launch(scal, lut, centers, src3, spen, dbt4, pen2t, block, wb, tq,
               th2):
        mp, np_ = src3.shape[1], dbt4.shape[1]
        plan = pb.moments_v2_plan(mp, tq, sms)
        out, part, tickets = pb._moments_scratch(dev, mp // tq, plan)
        kernels.check(fn(scal.data_ptr(), lut.data_ptr(), centers.data_ptr(),
                         src3.data_ptr(), spen.data_ptr(), dbt4.data_ptr(),
                         pen2t.data_ptr(), out.data_ptr(), part.data_ptr(),
                         tickets.data_ptr(), mp, np_, block, wb, tq,
                         plan["lanes"], th2,
                         kernels.stream_ptr(dev)), "K8 variant")
        return out
    return launch


def k8_bound_ms(args):
    scal, lut, centers, src3, spen, dbt4, pen2t, block, wb, tq, _ = args
    mp = src3.shape[1]
    byt = sum(t.numel() * t.element_size() for t in
              (scal, lut, centers, src3, spen, dbt4, pen2t)) + mp // tq * 128
    return max(8.0 * mp * wb * block / FP32_PEAK, byt / HBM_RATE) * 1e3


def sweep_k8(torch, kernels, pb, calls, dev, base, base_dir):
    sms = kernels.sm_count(dev)
    a0 = calls[0]
    block, wb, tq = a0[7], a0[8], a0[9]
    mp, np_ = a0[3].shape[1], a0[5].shape[1]
    tiles = mp // tq
    print(f"K8 on P5 (Mp {mp}, Np {np_}, block {block}, wb {wb}, tq {tq}: "
          f"{tiles} tiles; {len(calls)} launches; bound "
          f"{k8_bound_ms(a0) * 1e3:.2f} us a launch); us a launch, device "
          "time:")
    want = [pb.icp_moments_banded_v2_plain(*a) for a in calls]

    def rel(k, p):
        return float((k - p).abs().max() / p.abs().max())
    tile0 = one_tile(a0)
    if base is not None:
        launch = old_k8(torch, kernels, base["banded"], dev)
        err = max(rel(launch(*a), w) for a, w in zip(calls, want))
        assert err <= 1e-12, err
        t_all = graph_ms(torch, [lambda a=a: launch(*a) for a in calls])
        t_one = graph_ms(torch, [lambda: launch(*tile0)] * 20) / 20
        notie = build(kernels, [without_ties(
            base_dir / "pctpu_torch" / "csrc" / "banded.cu",
            kernels.BUILD_DIR / "sweep" / "base_notie" / "banded.cu")],
            kernels.BUILD_DIR / "sweep" / "base_notie")["banded"]
        launch_nt = old_k8(torch, kernels, notie, dev)
        err_nt = max(rel(launch_nt(*a), w) for a, w in zip(calls, want))
        t_nt = graph_ms(torch, [lambda a=a: launch_nt(*a) for a in calls])
        print(f"  baseline: {t_all * 1e3 / len(calls):.2f} ({tiles} CTAs of "
              f"256 threads, {min(tiles, sms)} of {sms} SMs busy); one tile "
              f"(one CTA) alone {t_one * 1e3:.2f}; without the tie branch "
              f"{t_nt * 1e3 / len(calls):.2f} (its max rel err "
            f"{err_nt:.1e}); max rel err {err:.1e}")
    plan = pb.moments_v2_plan(mp, tq, sms)
    err = max(rel(pb._launch_icp_moments_banded_v2(*a), w)
              for a, w in zip(calls, want))
    assert err <= 1e-12, err
    t_all = graph_ms(torch, [lambda a=a: pb._launch_icp_moments_banded_v2(*a)
                             for a in calls])
    t_one = graph_ms(torch, [lambda: pb._launch_icp_moments_banded_v2(
        *tile0)] * 20) / 20
    notie = build(kernels, [without_ties(
        kernels.CSRC / "banded.cu",
        kernels.BUILD_DIR / "sweep" / "tree_notie" / "banded.cu")],
        kernels.BUILD_DIR / "sweep" / "tree_notie")["banded"]
    launch_nt = tree_k8(torch, kernels, pb, notie, dev)
    err_nt = max(rel(launch_nt(*a), w) for a, w in zip(calls, want))
    t_nt = graph_ms(torch, [lambda a=a: launch_nt(*a) for a in calls])
    line = (f"  this tree: {t_all * 1e3 / len(calls):.2f} ({plan['units']} "
            f"units of {plan['slice']} queries, {plan['lanes']} lanes a "
            f"query, {pb.MOMENTS_QPT} queries a thread); one tile alone "
            f"({plan['slices']} units) {t_one * 1e3:.2f}; without the tie "
            f"branch {t_nt * 1e3 / len(calls):.2f} (its max rel err "
            f"{err_nt:.1e}); max rel err {err:.1e}")
    if base is not None:
        launch = old_k8(torch, kernels, base["banded"], dev)
        tb, tt = in_turns(torch, lambda: [launch(*a) for a in calls],
                          lambda: [pb._launch_icp_moments_banded_v2(*a)
                                   for a in calls],
                          lambda f: graph_ms(torch, [f]))
        line += (f"; in turns: baseline {tb * 1e3 / len(calls):.2f} vs this "
                 f"{tt * 1e3 / len(calls):.2f}")
    print(line)
    rows = []
    for lanes in (1, 2, 4, 8, 16, 32):
        p = pb.moments_v2_plan(mp, tq, sms, lanes=lanes)
        err = max(rel(pb._launch_icp_moments_banded_v2(*a, plan=p), w)
                  for a, w in zip(calls, want))
        assert err <= 1e-12, (lanes, err)
        t = graph_ms(torch, [lambda a=a, p=p: pb.
                             _launch_icp_moments_banded_v2(*a, plan=p)
                             for a in calls])
        rows.append(f"{lanes} lanes ({p['units']} units) "
                    f"{t * 1e3 / len(calls):.2f}")
    print("    by lanes a query: " + "; ".join(rows))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="an unpacked checkout whose fps.cu and banded.cu "
                         "are timed beside this tree's")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's registers and spills of both files")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fps_k8_sweep: no CUDA device", file=sys.stderr)
        return 2
    from pctpu_torch import kernels
    from pctpu_torch.ops import pallas_banded, pallas_fps
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    kernels.build_all(("fps.cu", "banded.cu"))
    if args.ptxas:
        for s in ("fps.cu", "banded.cu"):
            out = subprocess.run(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(kernels.BUILD_DIR / "ptxas.so"), str(kernels.CSRC / s)],
                capture_output=True, text=True)
            print("\n".join(ln for ln in out.stderr.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Function properties" in ln))
    base = base_dir = None
    if args.baseline:
        base_dir = Path(args.baseline).resolve()
        base = build(kernels, [base_dir / "pctpu_torch" / "csrc" / s
                               for s in ("fps.cu", "banded.cu")],
                     kernels.BUILD_DIR / "sweep" / "baseline")
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    sweep_fps(torch, kernels, pallas_fps, rng, dev, base)
    calls = p5_launches(torch, args.seed, dev)
    sweep_k8(torch, kernels, pallas_banded, calls, dev, base, base_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
