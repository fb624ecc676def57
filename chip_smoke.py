#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pctpu_torch`) on one NVIDIA GPU.

Drives the port's main path, `register_pairs` (voxel downsample -> radius
normals -> fused FPFH -> mutual matching -> batched RANSAC -> voxel ICP ->
exact refine -> stats), at the full-pipeline shapes of `bench.py`
(16 pairs x 16,384 points, 35 degree rotation, default config), and holds
each hand-written kernel against its plain PyTorch version:

  1. environment: versions, the card's name and power limit, precision
     checks, the kernels' build (nvcc, all sources at once);
  2. a warm-up run of the main path that records each kernel's inputs;
     on those inputs each kernel against its plain version, with the
     stated tolerance, and timed (CUDA events) beside its bound;
  3. the main path, with every launch counter set to 0 just before and
     read just after: every kernel must have launched; every pair must
     pass RTE < 2 m and RRE < 5 deg; a small input must give the same
     pose through the kernels and through the plain versions (CPU);
     then pairs/s (CUDA events, after the warm-up);
  4. one JSON line of per-kernel numbers, the card's line, and last the
     line {"ok": true, "device": {...}}.

Any failure raises: the exit code is nonzero and no result line is
printed. Without CUDA, or outside a checkout of the repo, it exits with 2.
Full results (profile included) are also written to build/chip_smoke.json.

    python3 chip_smoke.py [--seed 0] [--scan velodyne.bin]
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FP32_PEAK = 67e12      # H100 SXM FP32 CUDA-core FLOP/s (NVIDIA data sheet)
HBM_RATE = 3.35e12     # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
RTE_BOUND, RRE_BOUND = 2.0, 5.0     # bench.py:51-52 (evaluate_rt.py:16-18)
BATCH, N_POINTS, ROT_DEG = 16, 16384, 35.0


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def lidar_scene(rng, n=120_000):
    """A structured LiDAR-like scene over about +-40 m: undulating ground,
    box buildings, walls and pillars (points spread by surface area)."""
    parts = []
    g = rng.uniform(-40, 40, (n // 2, 2))
    z = (0.3 * np.sin(g[:, 0] / 7.0) * np.cos(g[:, 1] / 9.0)
         + rng.normal(scale=0.03, size=len(g)))
    parts.append(np.column_stack([g, z]))
    per = n // 2 // 40
    for _ in range(14):                         # boxes: 4 side walls + roof
        c = rng.uniform(-35, 35, 2)
        w = rng.uniform(2, 8, 2)
        h = rng.uniform(3, 10)
        f = rng.uniform(-1, 1, (per * 2, 3))
        side = rng.integers(0, 5, len(f))
        x = np.where(side == 0, 1.0, np.where(side == 1, -1.0, f[:, 0]))
        y = np.where(side == 2, 1.0, np.where(side == 3, -1.0, f[:, 1]))
        zz = np.where(side == 4, h, h * (f[:, 2] + 1) / 2)
        parts.append(np.column_stack([c[0] + w[0] * x, c[1] + w[1] * y, zz]))
    for _ in range(4):                          # long thin walls
        a = rng.uniform(-35, 35, 2)
        d = rng.normal(size=2)
        d /= np.linalg.norm(d)
        s = rng.uniform(0, rng.uniform(10, 25), per)
        parts.append(np.column_stack([a[0] + s * d[0], a[1] + s * d[1],
                                      rng.uniform(0, 3, per)]))
    for _ in range(24):                         # pillars / poles
        c = rng.uniform(-38, 38, 2)
        r = rng.uniform(0.2, 0.6)
        t = rng.uniform(0, 2 * np.pi, per // 3)
        parts.append(np.column_stack([c[0] + r * np.cos(t),
                                      c[1] + r * np.sin(t),
                                      rng.uniform(0, rng.uniform(4, 9),
                                                  per // 3)]))
    return np.concatenate(parts).astype(np.float32)


def make_pairs(scan, rng, batch, n_points, rot_deg):
    """bench.py:200-247: each pair is a random subsample of the scan and
    its copy moved by a 35 deg yaw (+ small tilt), [3,-2,0.5] m, 2 cm
    noise. Returns src, dst [B,N,3] and the ground truth [B,4,4]."""
    from scipy.spatial.transform import Rotation
    srcs, dsts, gts = [], [], []
    for _ in range(batch):
        sel = rng.choice(scan.shape[0], n_points, replace=False)
        src = scan[sel]
        R = Rotation.from_rotvec([0.05, -0.03, np.radians(rot_deg)]
                                 ).as_matrix().astype(np.float32)
        t = np.array([3.0, -2.0, 0.5], np.float32)
        dst = (src @ R.T + t + rng.normal(scale=0.02, size=src.shape)
               ).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, t
        srcs.append(src)
        dsts.append(dst)
        gts.append(T)
    return np.stack(srcs), np.stack(dsts), np.stack(gts)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps=5, warmup=1):
    """Mean milliseconds of fn() on the current stream, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, ops):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = nbytes / HBM_RATE * 1e3, ops / FP32_PEAK * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


class Recorder:
    """Stands in for a kernel wrapper in its module while a run records
    the inputs of each call. A wrapper counts its launches on the name it
    is bound to in its module, so `launches` passes through to it."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def need(ok, *what):
    """A check that holds under `python -O` too."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0]


def check_nn1(mods, args, torch):
    """K1 vs plain: d2 rtol 1e-6; idx equal unless the two choices are a
    near-tie (their distances within 1e-5 relative)."""
    nn = mods["pallas_nn"]
    q, db, pen = args
    d2k, ik = nn.nn1(q, db, pen)
    d2p, ip = nn.nearest_plain(q, db, pen)
    torch.cuda.synchronize()
    need(torch.allclose(d2k, d2p, rtol=1e-6, atol=0), "nn1 d2")
    diff = ik != ip
    if diff.any():
        def dist(idx):
            p = torch.gather(db, 1, idx.long()[..., None].expand(-1, -1, 3))
            return ((q - p) ** 2).sum(-1)
        a, b = dist(ik)[diff], dist(ip)[diff]
        need(torch.all((a - b).abs() <= 1e-5 * b.abs()), "nn1 idx")
    err = float((d2k - d2p).abs().max())
    b_, m, _ = q.shape
    n = db.shape[1]
    ms = cuda_ms(lambda: nn.nn1(q, db, pen), reps=20)
    plain = cuda_ms(lambda: nn.nearest_plain(q, db, pen), reps=3)
    lib = cuda_ms(lambda: torch.cdist(q, db).square().min(dim=2), reps=5)
    bms, by = bound(nbytes(q, db, pen) + b_ * m * 8, 8.0 * b_ * m * n)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib,
                detail=f"{b_}x{m} queries vs {n} db, {int(diff.sum())} "
                       "near-tie idx differences")


def _flip_ok(k, p, name):
    diff = (k - p).abs()
    flips, mean, mx = (float((diff > 0.5).float().mean()),
                       float(diff.mean()), float(diff.max()))
    need(flips < 2e-3 and mean < 0.02 and mx < 15.0,
         (name, flips, mean, mx))
    return mx


def check_fpfh(mods, spfh_calls, wsum_calls, torch):
    """K2, K3 vs plain on the main path's inputs (both cloud batches):
    bin-flip fraction < 2e-3, mean |diff| < 0.02, max |diff| < 15."""
    f = mods["pallas_fpfh"]
    res = {}
    for name, calls in (("spfh", spfh_calls), ("wsum", wsum_calls)):
        kern, plain = getattr(f, name), getattr(f, name + "_plain")
        err = 0.0
        visited = byt = 0
        for args in calls:
            outk, outp = kern(*args), plain(*args)
            torch.cuda.synchronize()
            if name == "spfh":
                need(torch.equal(outk[1], outp[1]), "spfh counts")
                outk, outp = outk[0], outp[0]
                byt += nbytes(*args[:4], outk, outp[:, :, 0])
            else:
                byt += nbytes(*args[:5], outk)
            err = max(err, _flip_ok(outk, outp, name))
            q_tile, db_tile = args[-3], args[-2]
            visited += int(args[3].sum()) * q_tile * db_tile
        res[name] = dict(max_abs_err=err, visited=visited, bytes=byt,
                         ms=sum(cuda_ms(lambda a=a: kern(*a)) for a in calls),
                         plain_ms=sum(cuda_ms(lambda a=a: plain(*a), reps=2)
                                      for a in calls))
    return res


def fpfh_ops(mods, spfh_calls, res):
    """Operation counts of K2/K3 for this run's data: every in-band pair
    costs the distance test (~10 flops for K2, ~8 for K3); every pair
    within the radius adds the Darboux angles and binning (~70 flops, K2)
    or the 33-wide weighted row sum (~68 flops, K3)."""
    f = mods["pallas_fpfh"]
    within = 0.0
    for args in spfh_calls:
        _, cnt = f.spfh_plain(*args)
        # cnt is max(count, 1) per query row: a row with no neighbour
        # counts as one within pair (a slight overcount)
        within += float(cnt.sum())
    res["spfh"]["ops"] = 10.0 * res["spfh"]["visited"] + 70.0 * within
    res["wsum"]["ops"] = 8.0 * res["wsum"]["visited"] + 68.0 * within
    return within


def check_icp(mods, calls, torch):
    """K4 vs plain on the main path's inputs (the voxel stage and the
    exact refine), and on the voxel stage's inputs re-tiled so the LUT
    window path runs (window_blocks < nb): T within 1e-4."""
    m = mods["pallas_icp_mega"]
    runs = list(calls)
    (dbt5, lut, scal, src3, spen, cen, iters, th2, block, wb, tq, newton) = \
        calls[0]
    tq_w, block_w = 512, 512
    cen_w = src3[:, :, tq_w // 2::tq_w].transpose(1, 2).reshape(
        src3.shape[0], -1).contiguous()
    runs.append((dbt5, lut, scal, src3, spen, cen_w, iters, th2, block_w, 2,
                 tq_w, newton))
    out = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, ops=0.0, bytes=0,
               window_path_err=None, per_launch_ms=[])
    for k, args in enumerate(runs):
        pk, pp = m.icp_mega(*args), m.icp_mega_plain(*args)
        torch.cuda.synchronize()
        err = float((pk - pp).abs().max())
        need(err <= 1e-4, ("icp_mega", k, err))
        if k == len(runs) - 1:
            out["window_path_err"] = err
            continue
        out["max_abs_err"] = max(out["max_abs_err"], err)
        b_, _, mp = args[3].shape
        ms = cuda_ms(lambda a=args: m.icp_mega(*a), reps=3)
        out["ms"] += ms
        out["per_launch_ms"].append(ms)
        out["plain_ms"] += cuda_ms(lambda a=args: m.icp_mega_plain(*a),
                                   reps=1)
        # ~8 flops per (query, window column) pair and iteration: the
        # d2 dot (3 mul + 3 add), the compare and the tie update
        out["ops"] += 8.0 * b_ * args[6] * mp * args[9] * args[8]
        out["bytes"] += nbytes(*args[:6]) + b_ * 64
    return out


def profile(run, torch, top=12):
    """Device time by kernel over one main-path call (torch.profiler), and
    the device's busy share of the call's wall time. Returns a dict, or
    {"note": ...} when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        t0 = time.perf_counter()
        run(2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        # kernel and copy events only: an operator's CPU row and its
        # annotation on the GPU timeline (`aten::mul` ...) repeat the time
        # of the kernels they cover, as torch's own table counts them
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, ev.count, ev.key))
    if not rows:
        return {"note": "the profiler recorded no device time"}
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"profile of one call (profiler on): wall {wall_ms:.1f} ms, device busy "
          f"{busy:.1f} ms ({100 * busy / wall_ms:.0f}%)")
    for ms, n, key in rows[:top]:
        print(f"  {ms:9.3f} ms  x{n:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "by_kernel": [{"ms": ms, "count": n, "name": key}
                          for ms, n, key in rows[:40]]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan", default=None,
                    help="KITTI velodyne .bin to sample pairs from "
                         "(default: a synthetic LiDAR-like scene)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import pctpu_torch  # noqa: F401
        from pctpu_torch import device as pdevice
        from pctpu_torch import kernels
        from pctpu_torch.core import se3
        from pctpu_torch.core.cloud import PointCloud
        from pctpu_torch.features import pallas_fpfh
        from pctpu_torch.ops import pallas_icp_mega, pallas_nn
        from pctpu_torch.register import pipeline
        from pctpu_torch.register.ransac import generator_sampler
    except ImportError as e:
        print(f"chip_smoke: the pctpu_torch package is missing ({e}); run "
              "from a checkout of the repo", file=sys.stderr)
        return 2
    mods = dict(pallas_nn=pallas_nn, pallas_fpfh=pallas_fpfh,
                pallas_icp_mega=pallas_icp_mega)
    counted = {"nn1": pallas_nn.nn1, "spfh": pallas_fpfh.spfh,
               "wsum": pallas_fpfh.wsum, "icp_mega": pallas_icp_mega.icp_mega}
    report = {}

    # ---- 1. environment --------------------------------------------------
    t_all = time.perf_counter()
    card = gpu_line()
    dev = pdevice.resolve_device()
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"python {sys.version.split()[0]}")
    print(f"card: {card}  ({torch.cuda.device_count()} visible)")
    need(torch.get_float32_matmul_precision() == "highest")
    need(not torch.backends.cuda.matmul.allow_tf32)
    need(not torch.backends.cudnn.allow_tf32)
    build_s = kernels.build_all()
    print(f"kernels built in {build_s:.1f} s ({', '.join(kernels.SOURCES)})")
    report["build_s"] = build_s

    # ---- data --------------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    if args.scan:
        scan = np.fromfile(args.scan, np.float32).reshape(-1, 4)[:, :3]
    else:
        scan = lidar_scene(rng)
    src_np, dst_np, gts = make_pairs(scan, rng, BATCH, N_POINTS, ROT_DEG)
    mask = torch.ones((BATCH, N_POINTS), dtype=torch.bool, device=dev)
    src = PointCloud(torch.from_numpy(src_np).to(dev), mask)
    dst = PointCloud(torch.from_numpy(dst_np).to(dev), mask)
    cfg = pipeline.RegistrationConfig()

    def run(seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pipeline.register_pairs(src, dst, cfg=cfg, generator=gen)

    # ---- 2. warm-up run recording each kernel's inputs; kernel vs plain ---
    with Recorder(pallas_nn, "nn1") as r_nn, \
            Recorder(pallas_fpfh, "spfh") as r_spfh, \
            Recorder(pallas_fpfh, "wsum") as r_wsum, \
            Recorder(pallas_icp_mega, "icp_mega") as r_icp:
        run()
        torch.cuda.synchronize()
    rows = {}
    rows["nn1"] = check_nn1(mods, r_nn.calls[0], torch)
    fp = check_fpfh(mods, r_spfh.calls, r_wsum.calls, torch)
    within = fpfh_ops(mods, r_spfh.calls, fp)
    for name in ("spfh", "wsum"):
        bms, by = bound(fp[name]["bytes"], fp[name]["ops"])
        rows[name] = dict(max_abs_err=fp[name]["max_abs_err"],
                          ms=fp[name]["ms"], plain_ms=fp[name]["plain_ms"],
                          bound_ms=bms, bound_by=by, library_ms=None)
    icp = check_icp(mods, r_icp.calls, torch)
    bms, by = bound(icp["bytes"], icp["ops"])
    rows["icp_mega"] = dict(max_abs_err=icp["max_abs_err"], ms=icp["ms"],
                            plain_ms=icp["plain_ms"], bound_ms=bms,
                            bound_by=by, library_ms=None,
                            window_path_err=icp["window_path_err"],
                            per_launch_ms=icp["per_launch_ms"])
    report["fpfh_pairs"] = {k: fp[k]["visited"] for k in ("spfh", "wsum")}
    report["fpfh_within"] = within
    print("kernel vs plain: all within tolerance")

    # ---- 3. main path: counted run, accuracy, small-input parity, speed --
    for fn in counted.values():
        fn.launches = 0
    out = run()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in counted.items()}
    expected = {"nn1": 1, "spfh": 2, "wsum": 2, "icp_mega": 2}
    need(launches == expected, (launches, expected))
    need(out.T.shape == (BATCH, 4, 4) and torch.isfinite(out.T).all())
    rte, rre = se3.pose_diff_rte_rre(out.T.cpu(), torch.from_numpy(gts))
    worst = int(torch.argmax(rte / RTE_BOUND + rre / RRE_BOUND))
    print(f"register_pairs {BATCH}x{N_POINTS} @ {ROT_DEG} deg: worst pair "
          f"{worst} RTE {float(rte[worst]):.4f} m RRE "
          f"{float(rre[worst]):.4f} deg; max RTE {float(rte.max()):.4f} m, "
          f"max RRE {float(rre.max()):.4f} deg; matches "
          f"{out.num_matches.min().item()}..{out.num_matches.max().item()}")
    need(bool((rte < RTE_BOUND).all()) and bool((rre < RRE_BOUND).all()),
         (rte.tolist(), rre.tolist()))

    # the same small input through the kernels and through the plain
    # versions (device='cpu'): the poses agree
    small = (PointCloud(src.points[:2, ::4].contiguous(), mask[:2, ::4]),
             PointCloud(dst.points[:2, ::4].contiguous(), mask[:2, ::4]))

    def sampler(nv, H):     # the same draws on both sides
        gen = torch.Generator().manual_seed(args.seed)
        return generator_sampler(gen)(nv.cpu(), H).to(nv.device)
    on_card = pipeline.register_pairs(*small, cfg=cfg, sampler=sampler)
    on_cpu = pipeline.register_pairs(small[0].to("cpu"), small[1].to("cpu"),
                                     cfg=cfg, sampler=sampler, device="cpu")
    drte, drre = se3.pose_diff_rte_rre(on_card.T.cpu(), on_cpu.T)
    print(f"small input, kernels vs plain: max dRTE {float(drte.max()):.2e} m"
          f", max dRRE {float(drre.max()):.2e} deg")
    # FPFH bins may flip between kernel and plain (rsqrt, sum order), so
    # matches and RANSAC may differ slightly; ICP lands on the same pose
    need(float(drte.max()) < 0.05 and float(drre.max()) < 0.5)

    pair_ms = cuda_ms(lambda: run(1), reps=3, warmup=1)
    pairs_s = BATCH / (pair_ms / 1e3)
    print(f"register_pairs: {pair_ms:.2f} ms per {BATCH}-pair batch = "
          f"{pairs_s:.1f} pairs/s")

    report["profile"] = profile(run, torch)

    # ---- 4. kernels line, card, result -----------------------------------
    meta = {
        "nn1": ("pctpu_torch/csrc/nn1.cu",
                "pctpu/ops/pallas_nn.py:27 _nn_kernel"),
        "spfh": ("pctpu_torch/csrc/fpfh.cu",
                 "pctpu/features/pallas_fpfh.py:88 _spfh_kernel"),
        "wsum": ("pctpu_torch/csrc/fpfh.cu",
                 "pctpu/features/pallas_fpfh.py:147 _wsum_kernel"),
        "icp_mega": ("pctpu_torch/csrc/icp_mega.cu",
                     "pctpu/ops/pallas_icp_mega.py:308 "
                     "_icp_mega_kernel_batch"),
    }
    kern_rows = []
    for name, (source, replaces) in meta.items():
        r = rows[name]
        kern_rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], kernel_ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"],
            **{k: r[k] for k in ("window_path_err", "per_launch_ms")
               if k in r}))
    report.update(card=card, kernels=kern_rows, pairs_per_s=pairs_s,
                  batch_ms=pair_ms, worst_rte=float(rte.max()),
                  worst_rre=float(rre.max()), launches=launches,
                  seconds=time.perf_counter() - t_all,
                  note="ms/plain_ms/bound_ms/library_ms: summed over the "
                       "kernel's launches in one register_pairs call")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "chip_smoke.json").write_text(
        json.dumps(report, indent=1))
    print(json.dumps({"kernels": kern_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
