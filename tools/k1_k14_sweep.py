#!/usr/bin/env python3
"""Times K1 (exact batched 1-NN, `pctpu_torch/csrc/nn1.cu`) and kernel 14
(the deterministic row scatter-add, `pctpu_torch/csrc/gather.cu`) on one
NVIDIA GPU at the shapes of `chip_smoke.py`'s paths, on synthetic inputs
made from --seed.

K1: at each shape, the launch `nn1_plan` picks and the other slice
counts beside it, each held against `nearest_plain` (d2 and idx equal)
and timed as device time (a CUDA graph of 20 launches). Kernel 14 on
ball-query indices (`ball_idx`): the whole launch, its bucket sort and
its row sum timed apart (CUDA events) beside `index_add_` and the bound,
the result equal to `scatter_add_rows_plain`. With --baseline DIR (an
unpacked checkout of an earlier commit), that checkout's `nn1.cu` and
`gather.cu` are built too, and each shape is timed in turns: baseline,
this tree, this tree, baseline.

    python3 tools/k1_k14_sweep.py [--seed 0] [--baseline DIR] [--ptxas]
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FP32_PEAK, HBM_RATE = 67e12, 3.35e12     # H100 SXM data sheet
# name: (B, M queries, N db points)
K1_SHAPES = {
    "P13 front end": (1, 4096, 4096),
    "P13 closure batch": (15, 4096, 4096),
    "P14 front end": (1, 2048, 2048),
    "P14 closure batch": (118, 2048, 2048),
    "P1 register_pairs": (16, 1024, 16384),
    "P3 exact refine": (1, 16384, 124668),
}
# name: (B, centres, nsample, C channels, n points, ball radius): kernel
# 12's backward at the paths' SA2 scales
K14_SHAPES = {
    "P10 cls-msg SA2 fused": (32, 128, 32, 323, 512, 0.2),
    "P11 cls-ssg SA2": (32, 128, 64, 131, 512, 0.4),
    "phase M 8192": (32, 128, 64, 320, 512, 0.4),
    "phase M 16384": (32, 128, 128, 320, 512, 0.8),
}


def ball_idx(rng, b, centres, nsample, n, radius):
    """Ball-query indices [b, centres * nsample] as kernel 12 emits them:
    n points on a unit sphere, the first `centres` of them as centres,
    each ball's hits in ascending index, padded with its first hit."""
    out = np.empty((b, centres, nsample), np.int32)
    for k in range(b):
        p = rng.normal(size=(n, 3))
        p /= np.linalg.norm(p, axis=1, keepdims=True)
        d2 = ((p[:centres, None] - p[None]) ** 2).sum(-1)
        for c in range(centres):
            hits = np.flatnonzero(d2[c] <= radius ** 2)[:nsample]
            out[k, c] = np.concatenate(
                [hits, np.full(nsample - len(hits), hits[0])])
    return out.reshape(b, centres * nsample)


def graph_ms(torch, fn, copies=20, reps=5):
    """Device ms of one fn() call: `copies` calls in one CUDA graph,
    replayed `reps` times between CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(copies):
            fn()
    graph.replay()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        graph.replay()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / (reps * copies)


def events_ms(torch, fn, reps=10):
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(reps):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / reps


def build_baseline(kernels, src_dir, out_dir, sources):
    """Build `sources` of another checkout's csrc with this tree's flags;
    returns {source: ctypes library}."""
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for s in sources:
        procs[s] = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o",
             str(out_dir / f"{Path(s).stem}.so"), str(src_dir / s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    libs = {}
    for s, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on the baseline's {s}:\n"
                               + log.decode(errors="replace"))
        libs[s] = ctypes.CDLL(str(out_dir / f"{Path(s).stem}.so"))
    return libs


def c_fn(lib, name, n_ptr, n_int):
    fn = getattr(lib, name)
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def k1_variant(torch, kernels, nn, q, db, pen, slices):
    """A thunk launching K1 with up to `slices` db slices (rounded as
    nn1_plan rounds), and that launch's shape."""
    b, m, _ = q.shape
    n = db.shape[1]
    dev = q.device
    tiles = -(-m // (nn.THREADS * nn.QPT))
    slice_len = -(-n // slices)
    slices = -(-n // slice_len)
    d2 = torch.empty((b, m), dtype=torch.float32, device=dev)
    idx = torch.empty((b, m), dtype=torch.int32, device=dev)
    part = torch.empty((2, slices, b, m), dtype=torch.int32, device=dev)
    tickets = nn._ticket_buffer(dev, b * tiles)
    fn = kernels.entry("nn1.cu", "pct_nn1", n_ptr=8, n_int=6)

    def run():      # the current stream: a graph capture's, when capturing
        kernels.check(fn(q.data_ptr(), db.data_ptr(), pen.data_ptr(),
                         d2.data_ptr(), idx.data_ptr(), part[0].data_ptr(),
                         part[1].data_ptr(), tickets.data_ptr(), b, m, n,
                         tiles, slices, slice_len,
                         kernels.stream_ptr(dev)), "nn1")
        return d2, idx
    return run, dict(slices=slices, grid=b * tiles * slices)


def sweep_k1(torch, kernels, nn, rng, dev, base):
    print("K1 (us per launch, device time; bound from 8 flops a pair):")
    for name, (b, m, n) in K1_SHAPES.items():
        db_np = rng.uniform(-20, 20, (b, n, 3)).astype(np.float32)
        q_np = (db_np[:, rng.integers(0, n, m)]
                + rng.normal(scale=0.05, size=(b, m, 3))).astype(np.float32)
        q = torch.from_numpy(q_np).to(dev)
        db = torch.from_numpy(db_np).to(dev)
        pen = torch.where(torch.from_numpy(rng.uniform(size=(b, n)) > 0.05)
                          .to(dev), 0.0, 1e30).float()
        want = nn.nearest_plain(q, db, pen)
        plan = nn.nn1_plan(b, m, n, kernels.sm_count(dev))
        got = nn.nn1(q, db, pen)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        t_plan = graph_ms(torch, lambda: nn.nn1(q, db, pen))
        bound = max(8.0 * b * m * n / FP32_PEAK,
                    (q.numel() + db.numel() + pen.numel() + 2 * b * m) * 4
                    / HBM_RATE) * 1e3
        line = (f"  {name} ({b}x{m}x{n}): plan {plan['slices']} slices = "
                f"{plan['grid']} CTAs: "
                f"{t_plan * 1e3:.1f} (bound {bound * 1e3:.2f})")
        if base is not None:
            d2o = torch.empty((b, m), dtype=torch.float32, device=dev)
            io = torch.empty((b, m), dtype=torch.int32, device=dev)
            old = c_fn(base["nn1.cu"], "pct_nn1", 5, 3)

            def run_old():
                kernels.check(old(q.data_ptr(), db.data_ptr(), pen.data_ptr(),
                                  d2o.data_ptr(), io.data_ptr(), b, m, n,
                                  kernels.stream_ptr(dev)), "baseline nn1")
            run_old()
            assert torch.equal(d2o, want[0]) and torch.equal(io, want[1])
            t = [graph_ms(torch, f) for f in (run_old, lambda: nn.nn1(
                q, db, pen), lambda: nn.nn1(q, db, pen), run_old)]
            line += (f"; baseline {(t[0] + t[3]) / 2 * 1e3:.1f} vs this "
                     f"{(t[1] + t[2]) / 2 * 1e3:.1f}")
        print(line)
        rows = []
        for slices in (1, 2, 4, 8, 16, 32, 64):
            if slices > max(1, n // 32):
                continue
            run, shape = k1_variant(torch, kernels, nn, q, db, pen, slices)
            d2, idx = run()
            assert torch.equal(d2, want[0]) and torch.equal(idx, want[1])
            rows.append((graph_ms(torch, run), shape))
        print("    by slices: " + "; ".join(
            f"{s['slices']} ({s['grid']} CTAs) {t * 1e3:.1f}"
            for t, s in rows))


def sweep_k14(torch, kernels, pg, rng, dev, base):
    print("kernel 14 (ms):")
    sort = kernels.entry("gather.cu", "pct_scatter_sort", n_ptr=4, n_int=3)
    summ = kernels.entry("gather.cu", "pct_scatter_sum", n_ptr=4, n_int=4)
    for name, (b, centres, ns, c, n, radius) in K14_SHAPES.items():
        m = centres * ns
        g = torch.from_numpy(rng.normal(size=(b, m, c)).astype(
            np.float32)).to(dev)
        idx = torch.from_numpy(ball_idx(rng, b, centres, ns, n, radius)
                               ).to(dev)
        want = pg.scatter_add_rows_plain(g, idx, n)
        got = pg._launch_scatter_add_rows(g, idx, n)
        assert torch.equal(got, want)
        assert torch.equal(pg._launch_scatter_add_rows(g, idx, n), want)
        start = torch.empty((b, n + 1), dtype=torch.int32, device=dev)
        order = torch.empty((b, m), dtype=torch.int32, device=dev)
        scratch = torch.empty((b, n + m), dtype=torch.int32, device=dev)
        out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
        st = kernels.stream_ptr(dev)

        def run_sort():
            kernels.check(sort(idx.data_ptr(), start.data_ptr(),
                               order.data_ptr(), scratch.data_ptr(), b, m,
                               n, st), "sort")

        def run_sum():
            kernels.check(summ(g.data_ptr(), start.data_ptr(),
                               order.data_ptr(), out.data_ptr(), b, m, n, c,
                               st), "sum")
        run_sort()
        run_sum()
        assert torch.equal(out, want)
        fi = (idx.long() + n * torch.arange(b, device=dev)[:, None]
              ).reshape(-1)
        gf = g.reshape(-1, c)

        def lib():
            return torch.zeros((b * n, c), device=dev).index_add_(0, fi, gf)
        bound = (g.numel() + idx.numel() + b * n * c) * 4 / HBM_RATE * 1e3
        t_all = events_ms(torch, lambda: pg._launch_scatter_add_rows(
            g, idx, n))
        longest = int(torch.bincount(idx[0].long(), minlength=n).max())
        line = (f"  {name} (B {b}, M {m}, C {c}, n {n}; longest bucket "
                f"{longest}): {t_all:.3f} = sort "
                f"{events_ms(torch, run_sort):.3f} + sum "
                f"{events_ms(torch, run_sum):.3f}; index_add_ "
                f"{events_ms(torch, lib):.3f}; bound {bound:.4f}")
        if base is not None:
            old = c_fn(base["gather.cu"], "pct_scatter_add_rows", 6, 4)

            def run_old():
                kernels.check(old(g.data_ptr(), idx.data_ptr(),
                                  start.data_ptr(), order.data_ptr(),
                                  scratch.data_ptr(), out.data_ptr(), b, m,
                                  n, c, st), "baseline scatter")
            run_old()
            assert torch.equal(out, want)
            t = [events_ms(torch, f) for f in (run_old, lambda: pg.
                 _launch_scatter_add_rows(g, idx, n), lambda: pg.
                 _launch_scatter_add_rows(g, idx, n), run_old)]
            line += (f"; baseline {(t[0] + t[3]) / 2:.3f} vs this "
                     f"{(t[1] + t[2]) / 2:.3f}")
        print(line)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline", default=None,
                    help="an unpacked checkout whose nn1.cu and gather.cu "
                         "are timed beside this tree's")
    ap.add_argument("--ptxas", action="store_true",
                    help="print ptxas's registers and spills of both files")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("k1_k14_sweep: no CUDA device", file=sys.stderr)
        return 2
    from pctpu_torch import kernels
    from pctpu_torch.ops import pallas_gather, pallas_nn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    kernels.build_all(("nn1.cu", "gather.cu"))
    if args.ptxas:
        for s in ("nn1.cu", "gather.cu"):
            out = subprocess.run(
                [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o",
                 str(kernels.BUILD_DIR / "ptxas.so"), str(kernels.CSRC / s)],
                capture_output=True, text=True)
            print("\n".join(ln for ln in out.stderr.splitlines()
                            if "registers" in ln or "spill" in ln
                            or "Function properties" in ln))
    base = None
    if args.baseline:
        base = build_baseline(kernels,
                              Path(args.baseline) / "pctpu_torch" / "csrc",
                              kernels.BUILD_DIR / "baseline",
                              ("nn1.cu", "gather.cu"))
    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)
    sweep_k1(torch, kernels, pallas_nn, rng, dev, base)
    sweep_k14(torch, kernels, pallas_gather, rng, dev, base)
    return 0


if __name__ == "__main__":
    sys.exit(main())
