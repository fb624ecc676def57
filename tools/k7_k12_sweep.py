#!/usr/bin/env python3
"""Times K7 (the banded ICP moments, `pctpu_torch/csrc/banded.cu`) and
kernel 12 (the fused ball group, `pctpu_torch/csrc/ballgroup.cu`) on one
NVIDIA GPU at the shapes of `chip_smoke.py`'s paths, on inputs made from
--seed. Every time is device time: a CUDA graph of the launches.

K7: P5's 30 launches, recorded from `icp_fixed_iters_banded_fused` on
workload 1's pair of `chip_smoke.py`'s synthetic scan, us a launch, and
K8's on the 30 launches `icp_fixed_iters_banded_fused_v2` makes on the
same pair; then K7 at every lane count its plan takes. Each launch's
per-tile moments are held against the plain version (1e-12 relative).

Kernel 12: the launches of one `cls-msg` forward (P7: SA1 at r 0.1 /
0.2 / 0.4, SA2), one `cls-ssg` forward (P8) and the `entry()` forward
(P9), recorded from the models with `chip_smoke.py`'s clouds. For each:
us a launch; the same launch split into its two halves, built from
copies of the source under build/: the scan alone (idx written, no
rows) and the emission alone (rows from the given idx, no scan); the
candidates the scan must test (up to the nsample-th hit, or all N),
the output bytes and the launch's bound (bytes, or 10 flops a
candidate); `ball_group_plan`'s launch. Also each launch at every CTA
width, with the cloud read from device memory (the plan's "global"
mode), with 4-byte stores, and in two other builds: 8 groups of 32
candidates a scan step, and a scan that finds no hit (every candidate
tested; its rows are not the kernel's); the first launch of each path
also back to back for 1.5 s, with the SM clock nvidia-smi reads then.
idx and rows are held equal to `ball_group_plain`.

With --baseline DIR (an unpacked checkout of an earlier commit whose
K7 and kernel 12 have their first designs' C signatures: K7 one CTA per
query tile, kernel 12 one warp per centre reading device memory), that
checkout's kernels are built and timed too, in turns with this tree's:
baseline, this tree, this tree, baseline. --baseline-only times the
baseline alone (a tree whose own kernels have those signatures).

    python3 tools/k7_k12_sweep.py [--seed 0] [--baseline DIR
        [--baseline-only]] [--ptxas]
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

import chip_smoke as cs  # noqa: E402

# the halves of kernel 12, cut from a copy of its source: (pattern,
# replacement) pairs, for the first design (one warp per centre, the
# cloud read from device memory) and for this tree's
SCAN_ONLY = (
    # the first design: drop the row loop
    (re.compile(r"  for \(int e = lane; e < total; e \+= 32\) \{\n"
                r"(?:.*\n)*?  \}\n"), ""),
    # this tree: drop the call that writes the rows
    (re.compile(r"\n\s*emit_rows<[^;]*;"), ""),
)
EMIT_ONLY = (
    # the first design: the slots from the given idx instead of the scan
    (re.compile(r"  for \(int base = 0; base < N && count < K; base \+= 32\)"
                r" \{\n(?:.*\n)*?  \}\n"),
     "  for (int k = lane; k < K; k += 32) slots[k] = idx_out[cm * K + k];\n"
     "  count = K;\n"),
    # this tree: the same, in place of the call that scans
    (re.compile(r"\n(\s*)const int filled = scan_ball<[^;]*;"),
     r"\n\1for (int k = lane; k < a.K; k += 32) slots[k] = a.idx[cm * a.K + k];"
     r"\n\1__syncwarp();\n\1const int filled = a.K;"),
)

# other builds of this tree's kernel 12, timed at each shape: name ->
# (pattern, replacement, whether its results stay those of the kernel)
VARIANTS = {
    "8 groups a step": (re.compile(r"constexpr int kGroups = 4;"),
                        "constexpr int kGroups = 8;", True),
    "no hit (every candidate tested)": (
        re.compile(r"__ballot_sync\(0xffffffffu, d2 < r2\)"),
        "__ballot_sync(0xffffffffu, d2 < -r2)", False),
}

def patched(src: Path, out: Path, patterns) -> Path:
    """A copy of `src` with the first pattern of `patterns` that matches
    applied (exactly one must)."""
    text = src.read_text()
    for pat, rep in patterns:
        new, k = pat.subn(rep, text)
        if k:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(new)
            return out
    raise RuntimeError(f"no pattern matched in {src}")


def build(kernels, sources, out_dir):
    """{key: ctypes library} of `sources` ({key: path}), built with this
    tree's flags into out_dir/<key>.so, all nvcc processes at once."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, src in sources.items():
        out = out_dir / f"{key}.so"
        procs[key] = (out, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for key, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {key}:\n"
                               + log.decode(errors="replace"))
        libs[key] = ctypes.CDLL(str(out))
    return libs


def c_fn(lib, name, n_ptr, n_int, n_float=0):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_float] * n_float + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def busy_clock(torch, fn, seconds=1.5):
    """(us a call, the SM clock in MHz that nvidia-smi reads halfway)
    while `fn` runs back to back for about `seconds`: a CUDA graph of 10
    calls replayed."""
    import threading
    for _ in range(3):
        fn()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(10):
            fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    reps = max(1, int(seconds * 1e3 / ev[0].elapsed_time(ev[1])))
    clock = []
    probe = threading.Timer(seconds / 2, lambda: clock.append(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()))
    probe.start()
    ev[0].record()
    for _ in range(reps):
        graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    probe.join()
    return ev[0].elapsed_time(ev[1]) * 1e3 / (10 * reps), clock[0]


def in_turns(base_fn, tree_fn, timer):
    """(baseline, tree) times, measured baseline, tree, tree, baseline."""
    t = [timer(f) for f in (base_fn, tree_fn, tree_fn, base_fn)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def rel(k, p):
    return float((k - p).abs().max() / p.abs().max())


# ---------------------------------------------------------------------------
# K7 (and K8 on the same pair)
# ---------------------------------------------------------------------------

def p5_launches(torch, seed, dev):
    """{K7, K8: the argument tuples of P5's 30 launches} (workload 1's
    pair of chip_smoke.py's synthetic scan, the fused banded loops with
    chip_smoke.py's BANDED settings)."""
    from pctpu_torch.ops import pallas_banded as pb
    from pctpu_torch.register import icp
    full = cs.lidar_scan(np.random.default_rng([seed, 9]))
    rng1 = np.random.default_rng([seed, 1])
    src = full[rng1.choice(full.shape[0], cs.N_POINTS, replace=False)]
    dst, _ = cs.perturb(src, rng1, [0.01, 0.02, 0.05], [0.5, -0.3, 0.1])
    s1 = torch.from_numpy(np.ascontiguousarray(src)).to(dev)
    d1 = torch.from_numpy(np.ascontiguousarray(dst)).to(dev)
    mask = torch.ones((cs.N_POINTS,), dtype=torch.bool, device=dev)
    with cs.Recorder(pb, "_launch_icp_moments_banded") as r7, \
            cs.Recorder(pb, "_launch_icp_moments_banded_v2") as r8:
        icp.icp_fixed_iters_banded_fused(s1, mask, d1, mask, **cs.BANDED)
        icp.icp_fixed_iters_banded_fused_v2(s1, mask, d1, mask, **cs.BANDED)
    return r7.calls, r8.calls


def old_k7(torch, kernels, lib, dev):
    """A launcher of K7's first C entry (one CTA per query tile)."""
    fn = c_fn(lib, "pct_banded_moments", 6, 5, 1)

    def launch(q, qpen, dbt4, pen2, offsets, block, wb, tq, th2):
        mp, np_ = q.shape[0], dbt4.shape[1]
        out = torch.empty((mp // tq, 16), dtype=torch.float64, device=dev)
        kernels.check(fn(q.data_ptr(), qpen.data_ptr(), dbt4.data_ptr(),
                         pen2.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                         mp, np_, block, wb, tq, th2,
                         kernels.stream_ptr(dev)), "baseline K7")
        return out
    return launch


def sweep_k7(torch, kernels, pb, calls7, calls8, dev, base, tree):
    sms = kernels.sm_count(dev)
    q, block, wb, tq = calls7[0][0], *calls7[0][5:8]
    mp, np_ = q.shape[0], calls7[0][2].shape[1]
    ops = 8.0 * mp * wb * block
    print(f"K7 on P5 (Mp {mp}, Np {np_}, block {block}, wb {wb}, tq {tq}: "
          f"{mp // tq} tiles; {len(calls7)} launches; bound "
          f"{ops / cs.FP32_PEAK * 1e6:.2f} us a launch, operations); us a "
          "launch, device time:")
    want7 = [pb.icp_moments_banded_plain(*a) for a in calls7]
    want8 = [pb.icp_moments_banded_v2_plain(*a) for a in calls8]

    def per(launch, calls, want):
        err = max(rel(launch(*a), w) for a, w in zip(calls, want))
        assert err <= 1e-12, err
        return cs.graph_ms([lambda a=a: launch(*a) for a in calls]) \
            * 1e3 / len(calls), err
    k8, err8 = per(pb._launch_icp_moments_banded_v2, calls8, want8)
    line = f"  K8 on the same pair: {k8:.2f} (max rel err {err8:.1e})"
    if base is not None:
        launch = old_k7(torch, kernels, base["banded"], dev)
        t, err = per(launch, calls7, want7)
        line += (f"; baseline K7: {t:.2f} ({mp // tq} CTAs of 256 threads; "
                 f"max rel err {err:.1e})")
    print(line)
    if not tree:
        return
    plan = pb.moments_v2_plan(mp, tq, sms)
    t, err = per(pb._launch_icp_moments_banded, calls7, want7)
    line = (f"  this tree's K7: {t:.2f} ({plan['units']} units of "
            f"{plan['slice']} queries, {plan['lanes']} lanes a query; max "
            f"rel err {err:.1e})")
    if base is not None:
        launch = old_k7(torch, kernels, base["banded"], dev)
        tb, tt = in_turns(lambda: [launch(*a) for a in calls7],
                          lambda: [pb._launch_icp_moments_banded(*a)
                                   for a in calls7],
                          lambda f: cs.graph_ms([f]))
        line += (f"; in turns: baseline {tb * 1e3 / len(calls7):.2f} vs "
                 f"this {tt * 1e3 / len(calls7):.2f}")
    print(line)
    rows = []
    for lanes in (1, 2, 4, 8, 16, 32):
        p = pb.moments_v2_plan(mp, tq, sms, lanes=lanes)
        t, _ = per(lambda *a, p=p: pb._launch_icp_moments_banded(
            *a, plan=p), calls7, want7)
        rows.append(f"{lanes} lanes ({p['units']} units) {t:.2f}")
    print("    by lanes a query: " + "; ".join(rows))


# ---------------------------------------------------------------------------
# kernel 12
# ---------------------------------------------------------------------------

def forward_launches(torch, seed, dev):
    """{name: the argument tuples of kernel 12's launches} in one forward
    of P7 (`cls-msg`, B 32 x 4,096), P8 (`cls-ssg`) and P9 (`entry()`,
    B 4 x 1,024), with chip_smoke.py's clouds and port-initialised
    weights."""
    from pctpu_torch import entry as pentry
    from pctpu_torch.nn import config as nncfg
    from pctpu_torch.nn import train as T
    from pctpu_torch.ops import pallas_ballgroup as bg
    clouds, _ = cs.modelnet_like(np.random.default_rng([seed, 7]),
                                 cs.CLS_BATCH, cs.CLS_POINTS)
    pc = torch.from_numpy(clouds).to(dev)
    out = {}
    for path, preset in (("P7 cls-msg", nncfg.MODELNET40_CLS_MSG),
                         ("P8 cls-ssg", nncfg.MODELNET40_CLS_SSG)):
        model = T.build_model(preset, device=dev, generator=torch.Generator(
            ).manual_seed(seed))
        with cs.Recorder(bg, "_launch_ball_group") as r, torch.no_grad():
            model(pc)
        out[path] = r.calls
        del model
    fwd, (pc_e,) = pentry.entry()
    with cs.Recorder(bg, "_launch_ball_group") as r:
        fwd(pc_e)
    out["P9 entry"] = r.calls
    return out


def old_bg(torch, kernels, lib, dev):
    """A launcher of kernel 12's first C entry (one warp per centre)."""
    fn = c_fn(lib, "pct_ball_group", 5, 6, 1)

    def launch(centers, packed, radius, nsample, pmask, sub_xyz,
               idx_in=None):
        b, m, _ = centers.shape
        n, c = packed.shape[1], packed.shape[2]
        out = torch.empty((b, m, nsample, c), dtype=torch.float32,
                          device=dev)
        idx = (idx_in.clone() if idx_in is not None else
               torch.empty((b, m, nsample), dtype=torch.int32, device=dev))
        r2 = float(torch.tensor(radius, dtype=torch.float32) ** 2)
        kernels.check(fn(centers.data_ptr(), packed.data_ptr(),
                         None if pmask is None else pmask.data_ptr(),
                         out.data_ptr(), idx.data_ptr(), b, m, n, c, nsample,
                         int(sub_xyz), r2, kernels.stream_ptr(dev)),
                      "baseline ball_group")
        return out, idx
    return launch


def tree_bg(torch, kernels, bg, lib, dev):
    """A launcher of this tree's kernel-12 C entry from another build of
    its source (a half), as `_launch_ball_group` launches it; `idx_in`
    fills idx before the launch (the emission half reads it)."""
    fn = c_fn(lib, "pct_ball_group", 5, 10, 1)

    def launch(centers, packed, radius, nsample, pmask, sub_xyz,
               idx_in=None):
        b, m, _ = centers.shape
        n, c = packed.shape[1], packed.shape[2]
        plan = bg.ball_group_plan(b, m, n, c, nsample, kernels.sm_count(dev))
        out = torch.empty((b, m, nsample, c), dtype=torch.float32,
                          device=dev)
        idx = (idx_in.clone() if idx_in is not None else
               torch.empty((b, m, nsample), dtype=torch.int32, device=dev))
        kernels.check(fn(centers.data_ptr(), packed.data_ptr(),
                         None if pmask is None else pmask.data_ptr(),
                         out.data_ptr(), idx.data_ptr(), b, m, n, c, nsample,
                         int(sub_xyz), plan["threads"], plan["centres"],
                         bg.MODES.index(plan["mode"]),
                         plan["store_bytes"] // 4, bg.f32_square(radius),
                         kernels.stream_ptr(dev)), "ball_group half")
        return out, idx
    return launch


def bg_case(torch, bg, args):
    """(plain rows, plain idx, candidates scanned, output bytes, bound
    us) of one recorded launch."""
    centers, packed, radius, nsample, pmask, sub_xyz = args
    gp, ip = bg.ball_group_plain(*args)
    full = ip[..., -1] != ip[..., 0]
    scan = float(torch.where(full, ip[..., -1].long() + 1,
                             packed.shape[1]).sum())
    out_b = cs.nbytes(gp, ip)
    bms, by = cs.bound(cs.nbytes(centers, packed, pmask) + out_b,
                       10.0 * scan)
    return gp, ip, scan, out_b, bms * 1e3, by


def sweep_bg(torch, kernels, bg, launches, dev, base, base_dir, tree):
    sms = kernels.sm_count(dev)
    bdir = kernels.BUILD_DIR / "sweep"
    srcs = {}
    if base is not None:
        srcs["base"] = base_dir / "pctpu_torch" / "csrc" / "ballgroup.cu"
    if tree:
        srcs["tree"] = kernels.CSRC / "ballgroup.cu"
    halves = {f"{who}_{half}": patched(src, bdir / f"{who}_{half}.cu", pats)
              for who, src in srcs.items()
              for half, pats in (("scan", SCAN_ONLY), ("emit", EMIT_ONLY))}
    if tree:
        halves.update({f"variant{j}": patched(
            srcs["tree"], bdir / f"variant{j}.cu", ((pat, rep),))
            for j, (pat, rep, _) in enumerate(VARIANTS.values())})
    libs = build(kernels, halves, bdir)
    print("Kernel 12 (us a launch, device time: a CUDA graph of 10; scan = "
          "idx only, emit = rows from the given idx):")
    for path, calls in launches.items():
        for j, args in enumerate(calls):
            centers, packed, radius, nsample, pmask, sub_xyz = args
            b, m, _ = centers.shape
            n, c = packed.shape[1], packed.shape[2]
            gp, ip, scan, out_b, bus, by = bg_case(torch, bg, args)

            def timed(fn):
                return cs.graph_ms([fn] * 10) * 1e2

            def held(res):
                torch.cuda.synchronize()
                assert torch.equal(res[1], ip) and torch.equal(res[0], gp), \
                    (path, j)
            line = (f"  {path} #{j} (B {b}, M {m}, N {n}, C {c}, K "
                    f"{nsample}, r {radius}): {scan / (b * m):.0f} "
                    f"candidates a centre, out {out_b / 1e6:.1f} MB, bound "
                    f"{bus:.2f} ({by})")
            if base is not None:
                launch = old_bg(torch, kernels, base["ballgroup"], dev)
                held(launch(*args))
                sc = old_bg(torch, kernels, libs["base_scan"], dev)
                em = old_bg(torch, kernels, libs["base_emit"], dev)
                assert torch.equal(sc(*args)[1], ip)
                held(em(*args, idx_in=ip))
                line += (f"\n    baseline: {timed(lambda: launch(*args)):.2f}"
                         f" = scan {timed(lambda: sc(*args)):.2f} + emit "
                         f"{timed(lambda: em(*args, idx_in=ip)):.2f}")
            if tree:
                plan = bg.ball_group_plan(b, m, n, c, nsample, sms)
                held(bg._launch_ball_group(*args))
                sc = tree_bg(torch, kernels, bg, libs["tree_scan"], dev)
                em = tree_bg(torch, kernels, bg, libs["tree_emit"], dev)
                assert torch.equal(sc(*args)[1], ip)
                held(em(*args, idx_in=ip))
                gplan = bg.ball_group_plan(b, m, n, c, nsample, sms,
                                           mode="global")
                held(bg._launch_ball_group(*args, plan=gplan))
                line += (
                    f"\n    this tree: "
                    f"{timed(lambda: bg._launch_ball_group(*args)):.2f} = "
                    f"scan {timed(lambda: sc(*args)):.2f} + emit "
                    f"{timed(lambda: em(*args, idx_in=ip)):.2f}; plan "
                    f"{plan['ctas']} CTAs ({plan['ctas_per_cloud']} a "
                    f"cloud) of {plan['threads']} threads, {plan['centres']}"
                    f" centres a CTA, {plan['mode']}, {plan['store_bytes']}-B"
                    f" stores; global mode " + "{:.2f}".format(timed(
                        lambda: bg._launch_ball_group(*args, plan=gplan))))
                rows = []
                for t in (128, 256, 512, 1024):
                    tp = bg.ball_group_plan(b, m, n, c, nsample, sms,
                                            threads=t)
                    held(bg._launch_ball_group(*args, plan=tp))
                    rows.append(f"{t} ({tp['ctas']} CTAs, {tp['centres']} "
                                f"centres) " + "{:.2f}".format(
                        timed(lambda p=tp: bg._launch_ball_group(*args,
                                                                 plan=p))))
                line += "\n    by CTA width: " + "; ".join(rows)
                vrows = []
                for v, (name, (_, _, same)) in enumerate(VARIANTS.items()):
                    var = tree_bg(torch, kernels, bg, libs[f"variant{v}"],
                                  dev)
                    if same:
                        held(var(*args))
                    vrows.append(f"{name} " + "{:.2f}".format(timed(
                        lambda f=var: f(*args))))
                line += "\n    variants: " + "; ".join(vrows)
                if j == 0:
                    us, mhz = busy_clock(
                        torch, lambda: bg._launch_ball_group(*args))
                    line += (f"\n    back to back for 1.5 s: {us:.2f} us a "
                             f"launch, SM clock {mhz} halfway")
                if plan["store_bytes"] == 16:
                    p4 = dict(plan, store_bytes=4)
                    held(bg._launch_ball_group(*args, plan=p4))
                    line += "; 4-byte stores {:.2f}".format(timed(
                        lambda: bg._launch_ball_group(*args, plan=p4)))
                if base is not None:
                    launch = old_bg(torch, kernels, base["ballgroup"], dev)
                    tb, tt = in_turns(
                        lambda: launch(*args),
                        lambda: bg._launch_ball_group(*args),
                        lambda f: cs.graph_ms([f] * 10) * 1e2)
                    line += f"; in turns: baseline {tb:.2f} vs this {tt:.2f}"
            print(line)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="an unpacked checkout whose banded.cu and "
                         "ballgroup.cu are timed beside this tree's")
    ap.add_argument("--baseline-only", action="store_true",
                    help="time the baseline's kernels alone")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's registers and spills of both files")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k7_k12_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.baseline_only and not args.baseline:
        ap.error("--baseline-only needs --baseline")
    from pctpu_torch import kernels
    from pctpu_torch.ops import pallas_ballgroup, pallas_banded
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                          "clocks.sm,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    kernels.build_all()
    if args.ptxas:
        for s in ("banded.cu", "ballgroup.cu"):
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
        base = build(kernels, {s: base_dir / "pctpu_torch" / "csrc" / f"{s}.cu"
                               for s in ("banded", "ballgroup")},
                     kernels.BUILD_DIR / "sweep" / "baseline")
    tree = not args.baseline_only
    dev = torch.device("cuda")
    calls7, calls8 = p5_launches(torch, args.seed, dev)
    sweep_k7(torch, kernels, pallas_banded, calls7, calls8, dev, base, tree)
    sweep_bg(torch, kernels, pallas_ballgroup,
             forward_launches(torch, args.seed, dev), dev, base, base_dir,
             tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())
