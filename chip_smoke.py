#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pctpu_torch`) on one NVIDIA GPU.

Drives the port's paths at the shapes of `bench.py` and holds each
hand-written kernel against its plain PyTorch version:

  P1 `register_pairs`: 16 pairs x 16,384 points at 35 degrees, default
     config (voxel -> radius normals -> fused FPFH -> mutual matching ->
     batched RANSAC -> voxel ICP -> exact refine -> stats): K1-K4;
  P2 workload 1: ICP of one 16,384-point pair, 47 windowed + 3 exact
     iterations (`icp_fixed_iters_banded_mega`): kernel 5;
  P3 workload 4: the whole 124,668-point scan, 48 windowed iterations of
     kernel 5, then 3 exact iterations (`icp_refine_exact`, K1);
  P4 workload 2: 16 pairs x 4,096 points (`batched_icp_mega`): K4;
  P5 the three banded ICP loops on workload 1's pair, 30 iterations each:
     K6 `nearest_banded`, K7 `icp_moments_banded`, K8
     `icp_moments_banded_v2`;
  P6 `register_pair` on one 35 degree pair of P1, default config:
     kernel 5 and K1;
  P7 `cls-msg` serving at the MODELNET40_CLS_MSG shapes (B 32, 4,096
     points x 6 channels, 40 classes): `evaluate` over 4 batches
     ("requests"), port-initialised weights from --seed; per forward
     kernel 11 `fps_pallas_batched` x2 and kernel 12 `ball_group` x4;
  P8 `cls-ssg` serving, the same data: kernel 11 x2, kernel 12 x2;
  P9 `entry()`, the flagship `cls-msg` forward at B 4 x 1,024 points,
     then kernel 10 `fps_pallas` on each of its 4 clouds.

P1-P6 take their clouds from one scan: a synthetic 124,668-point ray-cast
LiDAR scan made from --seed, or the velodyne file given by --scan. P7 and
P8 take synthetic ModelNet-style clouds made from --seed: points and
normals sampled on the surface of a random box, cylinder or sphere.

Phases:
  1. environment: versions, the card's name and power limit, precision
     checks, the kernels' build (nvcc, all sources at once);
  2. each path, with every launch counter set to 0 just before it and
     read just after: each must launch exactly its kernels; its result
     must pass its gate (RTE < 2 m and RRE < 5 deg, workload 4 also
     RTE < 0.05 m; the classifiers: finite logits of the right shape,
     cls-ssg's within 1e-4 of the CPU's on 2 clouds); its speed (CUDA
     events);
  3. on the inputs each path gave its kernels (recorded in a run before
     the counted one, or in the counted run itself), each kernel against
     its plain version with the stated tolerance, timed beside its bound;
     and each ICP path run once more with its kernels swapped for their
     plain versions: the poses agree within 1e-4 (the classifiers' logits
     within 1e-5);
  4. one JSON line of per-kernel numbers, the card's line, and last the
     line {"ok": true, "device": {...}}.

Any failure raises: the exit code is nonzero and no result line is
printed. Without CUDA, or outside a checkout of the repo, it exits with 2.
Full results (profile included) are also written to build/chip_smoke.json.

    python3 chip_smoke.py [--seed 0] [--scan velodyne.bin]
"""
import argparse
import contextlib
import copy
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
SCAN_POINTS = 124_668               # the reference's KITTI scan (bench.py)
W1 = dict(coarse_iters=47, polish_iters=3, dist_thresh=5.0, block=1024,
          window_blocks=1, query_tile=1024)             # bench.py:44-50
W2_BATCH, W2_POINTS = 16, 4096                          # bench.py:54-56
W2 = dict(coarse_iters=28, polish_iters=2, dist_thresh=5.0, block=512,
          window_blocks=1, query_tile=512)              # bench.py:187-189
BANDED = dict(iters=30, dist_thresh=5.0, block=2048, window_blocks=2,
              query_tile=512)
KERNELS = ("nn1", "spfh", "wsum", "icp_mega_batch", "icp_mega",
           "nearest_banded", "icp_moments_banded", "icp_moments_banded_v2",
           "fps_pallas", "fps_pallas_batched", "ball_group")
CLS_REQUESTS, CLS_BATCH, CLS_POINTS = 4, 32, 4096   # MODELNET40_CLS_*
ENTRY_FPS_M = 512                   # SA1 of the entry forward


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def lidar_scan(rng, n_points=SCAN_POINTS, height=1.73, max_range=80.0):
    """One scan of a street scene by a spinning 64-beam LiDAR (the
    elevations of a Velodyne HDL-64E, -24.8..+2 deg, 0.09 deg azimuth
    steps), the stand-in for the reference's KITTI scan: rays from 1.73 m
    above flat ground cast against the ground, yawed box buildings and
    cars, and poles; the nearest hit within 80 m with 1 cm range noise;
    `n_points` of the hits drawn without replacement. Points crowd near
    the sensor, as in a real scan."""
    elev = np.radians(np.linspace(-24.8, 2.0, 64))
    azim = np.radians(np.arange(0.0, 360.0, 0.09))
    el, az = np.meshgrid(elev, azim, indexing="ij")
    d = np.stack([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az),
                  np.sin(el)], axis=-1).reshape(-1, 3)
    o = np.array([0.0, 0.0, height])
    t = np.full(len(d), np.inf)
    down = d[:, 2] < -1e-6
    t[down] = height / -d[down, 2]                      # the ground, z = 0
    boxes = []
    for k in range(54):                 # 24 buildings, then 30 cars
        c = rng.uniform(-60, 60, 2) if k < 24 else rng.uniform(-35, 35, 2)
        near = 12.0 if k < 24 else 4.0  # keep the sensor outside
        if np.hypot(*c) < near:
            c *= near / np.hypot(*c)
        size = ((rng.uniform(3, 10, 2), rng.uniform(4, 12)) if k < 24
                else (np.array([2.2, 0.9]), 1.5))
        boxes.append((c, size[0], size[1], rng.uniform(0, np.pi)))
    for c, half, h, yaw in boxes:       # slab test in the box's frame
        cs_, sn = np.cos(yaw), np.sin(yaw)
        ox, oy = o[0] - c[0], o[1] - c[1]
        lo = np.array([cs_ * ox + sn * oy, -sn * ox + cs_ * oy, o[2]])
        ld = np.stack([cs_ * d[:, 0] + sn * d[:, 1],
                       -sn * d[:, 0] + cs_ * d[:, 1], d[:, 2]], 1)
        with np.errstate(divide="ignore", invalid="ignore"):
            t1 = (np.array([-half[0], -half[1], 0.0]) - lo) / ld
            t2 = (np.array([half[0], half[1], h]) - lo) / ld
        tn = np.nanmax(np.minimum(t1, t2), axis=1)
        tf = np.nanmin(np.maximum(t1, t2), axis=1)
        t = np.where((tn <= tf) & (tn > 0) & (tn < t), tn, t)
    for _ in range(40):                 # poles
        c = rng.uniform(-40, 40, 2)
        r, h = rng.uniform(0.15, 0.4), rng.uniform(4, 9)
        px, py = o[0] - c[0], o[1] - c[1]
        a = d[:, 0] ** 2 + d[:, 1] ** 2
        b = 2 * (px * d[:, 0] + py * d[:, 1])
        disc = b * b - 4 * a * (px * px + py * py - r * r)
        with np.errstate(invalid="ignore", divide="ignore"):
            tc = (-b - np.sqrt(disc)) / (2 * a)
        z = o[2] + tc * d[:, 2]
        hit = (disc > 0) & (tc > 0) & (z >= 0) & (z <= h) & (tc < t)
        t = np.where(hit, tc, t)
    keep = t <= max_range
    rng_m = t[keep] + rng.normal(scale=0.01, size=int(keep.sum()))
    pts = o + d[keep] * rng_m[:, None]
    sel = rng.choice(len(pts), n_points, replace=False)
    return pts[sel].astype(np.float32)


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


def perturb(pts, rng, rotvec, trans, noise=0.01):
    """bench.py:63-72: dst = R pts + t + noise; returns (dst, T)."""
    from scipy.spatial.transform import Rotation
    R = Rotation.from_rotvec(rotvec).as_matrix().astype(np.float32)
    t = np.asarray(trans, np.float32)
    dst = (pts @ R.T + t + rng.normal(scale=noise, size=pts.shape)).astype(
        np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return dst, T


def modelnet_like(rng, count, n_points):
    """Synthetic ModelNet-style clouds: (clouds [count,N,6] f32 of xyz and
    unit normals, labels [count] int). Each is the surface of a random box,
    cylinder or sphere (label 0, 1, 2) with random extents, sampled by
    area and randomly rotated, its xyz normalised by `pc_normalize_np`."""
    from scipy.spatial.transform import Rotation

    from pctpu_torch.nn.data import pc_normalize_np
    clouds, labels = [], rng.integers(0, 3, count)
    for kind in labels:
        a = rng.uniform(0.3, 1.0, 3)
        u = rng.uniform(-1, 1, (n_points, 3))
        if kind == 0:           # box: a face per point, by area
            area = np.array([a[1] * a[2], a[0] * a[2], a[0] * a[1]])
            ax = rng.choice(3, n_points, p=area / area.sum())
            sgn = rng.choice([-1.0, 1.0], n_points)
            p = u * a
            p[np.arange(n_points), ax] = sgn * a[ax]
            nrm = np.zeros_like(p)
            nrm[np.arange(n_points), ax] = sgn
        elif kind == 1:         # cylinder along z: side or caps, by area
            r, h = a[0], a[2]
            side = rng.uniform(size=n_points) < h / (h + r)
            th = rng.uniform(0, 2 * np.pi, n_points)
            rad = np.where(side, r, r * np.sqrt(rng.uniform(size=n_points)))
            z = np.where(side, h * u[:, 2], h * np.sign(u[:, 2]))
            p = np.stack([rad * np.cos(th), rad * np.sin(th), z], 1)
            nrm = np.where(side[:, None],
                           np.stack([np.cos(th), np.sin(th), 0 * th], 1),
                           np.stack([0 * th, 0 * th, np.sign(u[:, 2])], 1))
        else:                   # sphere
            nrm = rng.normal(size=(n_points, 3))
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            p = a[0] * nrm
        R = Rotation.random(random_state=rng).as_matrix()
        clouds.append(np.concatenate([pc_normalize_np(p @ R.T), nrm @ R.T],
                                     axis=1))
    return np.stack(clouds).astype(np.float32), labels


# ---------------------------------------------------------------------------
# timing, bounds, recording
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
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "numel"))


@contextlib.contextmanager
def swapped(module, name, fn):
    """Bind `name` in `module` to `fn` for the duration."""
    old = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, old)


class Recorder:
    """Stands in for a function in its module while a run records the
    inputs of each call. A kernel wrapper counts its launches on the name
    it is bound to in its module, so `launches` passes through to it."""

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


def gate(name, T, gt, se3, torch, rte_max=RTE_BOUND):
    """RTE < rte_max and RRE < 5 deg for every pose of T [...,4,4]."""
    need(torch.isfinite(T).all(), name, "non-finite pose")
    rte, rre = se3.pose_diff_rte_rre(T.cpu().reshape(-1, 4, 4),
                                     torch.as_tensor(gt).reshape(-1, 4, 4))
    need(bool((rte < rte_max).all()) and bool((rre < RRE_BOUND).all()),
         name, rte.tolist(), rre.tolist())
    return float(rte.max()), float(rre.max())


class Paths:
    """Runs each path with every launch counter set to 0 just before it
    and read just after, and checks that it launched exactly `expect`."""

    def __init__(self, counted, torch):
        self.counted, self.torch = counted, torch
        self.launches = {}

    def run(self, name, fn, expect):
        for k in self.counted.values():
            k.launches = 0
        out = fn()
        self.torch.cuda.synchronize()
        got = {k: f.launches for k, f in self.counted.items()}
        want = {k: expect.get(k, 0) for k in self.counted}
        need(got == want, name, got, want)
        self.launches[name] = {k: v for k, v in got.items() if v}
        return out

    def total(self, kernel):
        return sum(p.get(kernel, 0) for p in self.launches.values())


# ---------------------------------------------------------------------------
# kernel against plain version
# ---------------------------------------------------------------------------

def check_nn1(mods, args, torch, timed=True):
    """K1 vs plain: d2 rtol 1e-6; idx equal unless the two choices are a
    near-tie (their distances within 1e-5 relative). `timed` adds the
    kernel's, the plain version's and the library's times and the bound."""
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
    detail = (f"{b_}x{m} queries vs {n} db, {int(diff.sum())} near-tie idx "
              "differences")
    if not timed:
        return dict(max_abs_err=err, detail=detail)
    ms = cuda_ms(lambda: nn.nn1(q, db, pen), reps=20)
    plain = cuda_ms(lambda: nn.nearest_plain(q, db, pen), reps=3)
    lib = cuda_ms(lambda: torch.cdist(q, db).square().min(dim=2), reps=5)
    bms, by = bound(nbytes(q, db, pen) + b_ * m * 8, 8.0 * b_ * m * n)
    return dict(max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, detail=detail)


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


def mega_work(args):
    """(ops, bytes) of one K4 / kernel-5 launch: ~8 flops per (query,
    window column) pair and iteration (the d2 dot: 3 mul + 3 add, the
    compare, the tie update); each input read once, the pose written."""
    b_, _, mp = args[3].shape
    return 8.0 * b_ * args[6] * mp * args[9] * args[8], nbytes(*args[:6]) \
        + b_ * 64


def check_mega(m, calls, torch, retile=False):
    """K4 / kernel 5 (`_launch_icp_mega`) vs `icp_mega_plain` on recorded
    launches: the pose within 1e-4. `retile` adds the first launch's
    inputs re-tiled so the LUT window path runs (2 of the blocks)."""
    runs = list(calls)
    if retile:
        (dbt5, lut, scal, src3, spen, cen, iters, th2, block, wb, tq,
         newton) = calls[0]
        tq_w, block_w = 512, 512
        cen_w = src3[:, :, tq_w // 2::tq_w].transpose(1, 2).reshape(
            src3.shape[0], -1).contiguous()
        runs.append((dbt5, lut, scal, src3, spen, cen_w, iters, th2, block_w,
                     2, tq_w, newton))
    errs = []
    for k, args in enumerate(runs):
        pk, pp = m._launch_icp_mega(*args), m.icp_mega_plain(*args)
        torch.cuda.synchronize()
        errs.append(float((pk - pp).abs().max()))
        need(errs[-1] <= 1e-4, ("icp_mega", k, errs[-1]))
    return errs


def time_mega(m, calls):
    """Kernel, plain and bound time of the recorded launches together."""
    ms = cuda_ms(lambda: [m._launch_icp_mega(*a) for a in calls], reps=3)
    plain = cuda_ms(lambda: [m.icp_mega_plain(*a) for a in calls], reps=1,
                    warmup=0)
    ops = sum(mega_work(a)[0] for a in calls)
    byt = sum(mega_work(a)[1] for a in calls)
    bms, by = bound(byt, ops)
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                per_launch_ms=[cuda_ms(lambda a=a: m._launch_icp_mega(*a),
                                       reps=2) for a in calls])


def check_banded(b, calls, torch):
    """K6, K7, K8 vs plain on every recorded launch of P5. K6: d2 and idx
    equal. K7, K8: the moments rounded to [4,4], max |diff| <= 1e-6 of
    max |m44| (f64 per-tile sums in another order; rounded once)."""
    out = {}
    for name, launch, plain in (
            ("nearest_banded", b._launch_nearest_banded,
             b.nearest_banded_plain),
            ("icp_moments_banded", b._launch_icp_moments_banded,
             b.icp_moments_banded_plain),
            ("icp_moments_banded_v2", b._launch_icp_moments_banded_v2,
             b.icp_moments_banded_v2_plain)):
        err = 0.0
        for args in calls[name]:
            k, p = launch(*args), plain(*args)
            torch.cuda.synchronize()
            if name == "nearest_banded":
                need(torch.equal(k[0], p[0]) and torch.equal(k[1], p[1]),
                     name)
            else:
                mk, mp_ = b._sum_partials(k), b._sum_partials(p)
                rel = float((mk - mp_).abs().max() / mp_.abs().max())
                need(rel <= 1e-6, name, rel)
                err = max(err, float((mk - mp_).abs().max()))
        cl = calls[name]
        ms = cuda_ms(lambda cl=cl, f=launch: [f(*a) for a in cl], reps=3)
        plain_ms = cuda_ms(lambda cl=cl, f=plain: [f(*a) for a in cl],
                           reps=1, warmup=0)
        ops = byt = 0.0
        for a in cl:
            if name == "nearest_banded":
                q, dbt, pen, off, block, wb, tq = a
                mp_, flops = q.shape[0], 10.0   # 3 sub, 3 mul, 3 add, cmp
                byt += nbytes(q, dbt, pen, off) + mp_ * 8
            else:
                block, wb, tq = a[-4], a[-3], a[-2]
                mp_ = (a[0].shape[0] if name == "icp_moments_banded"
                       else a[3].shape[1])
                flops = 8.0                     # 4 mul, 2 add, sub, cmp
                byt += nbytes(*a[:-4]) + mp_ // tq * 128
            ops += flops * mp_ * wb * block
        bms, by = bound(byt, ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None)
    return out


def fps_work(args):
    """(ops, bytes) of one FPS launch (kernels 10, 11): about 12 flops per
    point and step (3 sub, 3 mul, 2 add, the min, the score select and the
    argmax's two compares) over the m - 1 steps; the cloud and its mask read
    once, the picks written once."""
    pts, m, elig = args
    b, n, _ = pts.shape
    return 12.0 * b * n * (m - 1), nbytes(pts, elig) + b * m * 4


def check_fps(pf, calls, torch):
    """Kernels 10, 11 (`_launch_fps`) vs `fps_plain` on recorded
    launches: idx identical."""
    for args in calls:
        k, p = pf._launch_fps(*args), pf.fps_plain(*args)
        torch.cuda.synchronize()
        need(torch.equal(k, p), "fps idx", tuple(args[0].shape), args[1])


def check_ball_group(bg, bq, gather, calls, torch):
    """Kernel 12 (`_launch_ball_group`) vs `ball_group_plain` on recorded
    launches: idx equal, grouped max |err| <= 1e-6. Also vs the unfused
    composition group_points(packed, ball_query(...)) - centre: equal at
    every centre, except where the two distance formulas (ball_query's is
    a matmul, the kernel's an elementwise expansion) round a point within
    1e-6 of r^2 to opposite sides; such centres are counted. Returns (max
    err, boundary centres, per-launch (ops, bytes)): ~10 flops per
    candidate the scan must test (up to the nsample-th hit, or all N), the
    inputs read once, grouped rows and idx written once."""
    err, boundary, work = 0.0, 0, []
    for args in calls:
        centers, packed, radius, nsample, pmask, sub_xyz = args
        gk, ik = bg._launch_ball_group(*args)
        gp, ip = bg.ball_group_plain(*args)
        torch.cuda.synchronize()
        need(torch.equal(ik, ip), "ball_group idx", tuple(packed.shape))
        e = float((gk - gp).abs().max())
        need(e <= 1e-6, "ball_group rows", e)
        err = max(err, e)
        idx_u, _ = bq.ball_query(centers, packed[..., :3], radius, nsample,
                                 pmask)
        comp = gather.group_points(packed, idx_u)
        if sub_xyz:
            comp[..., :3] -= centers[:, :, None]
        same = (idx_u == ik).all(-1)
        need(torch.equal(gk[same], comp[same]), "ball_group vs composition")
        if not bool(same.all()):
            bi, mi = torch.nonzero(~same, as_tuple=True)
            d2 = ((packed[bi, :, :3].double()
                   - centers[bi, mi, None].double()) ** 2).sum(-1)
            r2 = float(torch.tensor(radius, dtype=torch.float32)) ** 2
            need(bool(((d2 - r2).abs() <= 1e-6).any(-1).all()),
                 "ball_group vs composition away from the boundary")
            boundary += int(bi.numel())
        full = ik[..., -1] != ik[..., 0]        # nsample hits were found
        scanned = float(torch.where(full, ik[..., -1].long() + 1,
                                    packed.shape[1]).sum())
        work.append((10.0 * scanned, nbytes(centers, packed, pmask, gk, ik)))
    return err, boundary, work


def time_launches(launch, plain, calls, work):
    """Kernel, plain and bound time of recorded launches together; `work`
    holds each launch's (ops, bytes)."""
    ms = cuda_ms(lambda: [launch(*a) for a in calls], reps=5)
    plain_ms = cuda_ms(lambda: [plain(*a) for a in calls], reps=1, warmup=0)
    bms, by = bound(sum(w[1] for w in work), sum(w[0] for w in work))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


def profile(name, fn, torch, top=12):
    """Device time by kernel over one call of a path (torch.profiler), and
    the device's busy share of the call's wall time. Returns a dict, or
    {"note": ...} when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA],
                                acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
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
    print(f"   profile of one {name} call (profiler on): wall {wall_ms:.1f} "
          f"ms, device busy {busy:.1f} ms ({100 * busy / wall_ms:.0f}%)")
    for ms, n, key in rows[:top]:
        print(f"  {ms:9.3f} ms  x{n:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "by_kernel": [{"ms": ms, "count": n, "name": key}
                          for ms, n, key in rows[:40]]}


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scan", default=None,
                    help="KITTI velodyne .bin to take every path's clouds "
                         "from (default: a synthetic 124,668-point scan "
                         "from --seed)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import pctpu_torch  # noqa: F401
        from pctpu_torch import device as pdevice
        from pctpu_torch import kernels
        from pctpu_torch.core import io, se3
        from pctpu_torch.core.cloud import PointCloud
        from pctpu_torch import entry as pentry
        from pctpu_torch.features import pallas_fpfh
        from pctpu_torch.models import pointnet2
        from pctpu_torch.nn import config as nncfg
        from pctpu_torch.nn import fit
        from pctpu_torch.nn import train as T
        from pctpu_torch.ops import (ball_query, gather, pallas_ballgroup,
                                     pallas_banded, pallas_fps,
                                     pallas_icp_mega, pallas_nn)
        from pctpu_torch.parallel import pair_sweep
        from pctpu_torch.register import icp, pipeline
        from pctpu_torch.register.ransac import generator_sampler
    except ImportError as e:
        print(f"chip_smoke: the pctpu_torch package is missing ({e}); run "
              "from a checkout of the repo", file=sys.stderr)
        return 2
    mods = dict(pallas_nn=pallas_nn, pallas_fpfh=pallas_fpfh,
                pallas_icp_mega=pallas_icp_mega)
    mega, banded = pallas_icp_mega, pallas_banded
    counted = {"nn1": pallas_nn.nn1, "spfh": pallas_fpfh.spfh,
               "wsum": pallas_fpfh.wsum, "icp_mega_batch": mega.icp_mega_batch,
               "icp_mega": mega.icp_mega,
               "nearest_banded": banded.nearest_banded,
               "icp_moments_banded": banded.icp_moments_banded,
               "icp_moments_banded_v2": banded.icp_moments_banded_v2,
               "fps_pallas": pallas_fps.fps_pallas,
               "fps_pallas_batched": pallas_fps.fps_pallas_batched,
               "ball_group": pallas_ballgroup.ball_group}
    paths = Paths(counted, torch)
    report, rows, metrics = {}, {}, {}

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
    full = (io.read_velodyne_bin(args.scan) if args.scan
            else lidar_scan(np.random.default_rng([args.seed, 9])))
    src_np, dst_np, gts = make_pairs(full, rng, BATCH, N_POINTS, ROT_DEG)
    mask = torch.ones((BATCH, N_POINTS), dtype=torch.bool, device=dev)
    src = PointCloud(torch.from_numpy(src_np).to(dev), mask)
    dst = PointCloud(torch.from_numpy(dst_np).to(dev), mask)
    cfg = pipeline.RegistrationConfig()

    def on_dev(*xs):
        return [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in xs]

    # ---- P1 register_pairs (K1-K4) ---------------------------------------
    def run(seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pipeline.register_pairs(src, dst, cfg=cfg, generator=gen)

    with Recorder(pallas_nn, "nn1") as r_nn, \
            Recorder(pallas_fpfh, "spfh") as r_spfh, \
            Recorder(pallas_fpfh, "wsum") as r_wsum, \
            Recorder(mega, "_launch_icp_mega") as r_k4:
        run()
        torch.cuda.synchronize()
    out = paths.run("register_pairs", run,
                    {"nn1": 1, "spfh": 2, "wsum": 2, "icp_mega_batch": 2})
    need(out.T.shape == (BATCH, 4, 4))
    rte, rre = gate("register_pairs", out.T, gts, se3, torch)
    print(f"P1 register_pairs {BATCH}x{N_POINTS} @ {ROT_DEG} deg: max RTE "
          f"{rte:.4f} m, max RRE {rre:.4f} deg; matches "
          f"{out.num_matches.min().item()}..{out.num_matches.max().item()}")
    metrics["register_pairs"] = dict(worst_rte=rte, worst_rre=rre)

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
    print(f"   small input, kernels vs plain: max dRTE "
          f"{float(drte.max()):.2e} m, max dRRE {float(drre.max()):.2e} deg")
    # FPFH bins may flip between kernel and plain (rsqrt, sum order), so
    # matches and RANSAC may differ slightly; ICP lands on the same pose
    need(float(drte.max()) < 0.05 and float(drre.max()) < 0.5)

    pair_ms = cuda_ms(lambda: run(1), reps=3, warmup=1)
    pairs_s = BATCH / (pair_ms / 1e3)
    print(f"   {pair_ms:.2f} ms per {BATCH}-pair batch = {pairs_s:.1f} "
          "pairs/s")
    metrics["register_pairs"].update(batch_ms=pair_ms, pairs_per_s=pairs_s)
    report["profile"] = profile("register_pairs", lambda: run(2), torch)

    rows["nn1"] = check_nn1(mods, r_nn.calls[0], torch)
    fp = check_fpfh(mods, r_spfh.calls, r_wsum.calls, torch)
    report["fpfh_within"] = fpfh_ops(mods, r_spfh.calls, fp)
    report["fpfh_pairs"] = {k: fp[k]["visited"] for k in ("spfh", "wsum")}
    for name in ("spfh", "wsum"):
        bms, by = bound(fp[name]["bytes"], fp[name]["ops"])
        rows[name] = dict(max_abs_err=fp[name]["max_abs_err"],
                          ms=fp[name]["ms"], plain_ms=fp[name]["plain_ms"],
                          bound_ms=bms, bound_by=by, library_ms=None)
    errs = check_mega(mega, r_k4.calls, torch, retile=True)
    rows["icp_mega_batch"] = dict(max_abs_err=max(errs[:-1]),
                                  window_path_err=errs[-1], library_ms=None,
                                  **time_mega(mega, r_k4.calls))

    # ---- P2 workload 1: one 16,384-point pair, kernel 5 ------------------
    rng1 = np.random.default_rng([args.seed, 1])
    w1_src = full[rng1.choice(full.shape[0], N_POINTS, replace=False)]
    w1_dst, w1_gt = perturb(w1_src, rng1, [0.01, 0.02, 0.05],
                            [0.5, -0.3, 0.1])
    w1_mask = torch.ones((N_POINTS,), dtype=torch.bool, device=dev)
    s1, d1 = on_dev(w1_src, w1_dst)

    def w1_run():
        return icp.icp_fixed_iters_banded_mega(s1, w1_mask, d1, w1_mask,
                                               **W1)
    with Recorder(mega, "_launch_icp_mega") as r_k5:
        w1_run()
        torch.cuda.synchronize()
    T1 = paths.run("workload1", w1_run, {"icp_mega": 2})
    rte, rre = gate("workload1", T1, w1_gt, se3, torch)
    w1_ms = cuda_ms(w1_run, reps=5)
    metrics["workload1"] = dict(rte=rte, rre=rre, call_ms=w1_ms,
                                iters_per_s=50 / (w1_ms / 1e3))
    print(f"P2 workload 1 ({N_POINTS} pts, 47+3 iters): RTE {rte:.4f} m, "
          f"RRE {rre:.4f} deg; {w1_ms:.2f} ms per call = "
          f"{metrics['workload1']['iters_per_s']:.1f} iters/s")
    report["profile_workload1"] = profile("workload1", w1_run, torch, top=4)
    with swapped(mega, "_launch_icp_mega", mega.icp_mega_plain):
        T1p = w1_run()
    metrics["workload1"]["loop_err_vs_plain"] = float(
        (T1 - T1p).abs().max())
    need(metrics["workload1"]["loop_err_vs_plain"] <= 1e-4, "workload1 T")

    # ---- P3 workload 4: the full scene, kernel 5 then the exact polish ---
    rng4 = np.random.default_rng([args.seed, 4, 1])
    w4_dst, w4_gt = perturb(full, rng4, [0.01, 0.02, 0.05], [0.5, -0.3, 0.1])
    s4, d4 = on_dev(full, w4_dst)
    m4 = torch.ones((full.shape[0],), dtype=torch.bool, device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def w4_run():           # bench.py:270-281
        ev[0].record()
        T = icp.icp_fixed_iters_banded_mega(
            s4, m4, d4, m4, coarse_iters=48, polish_iters=0, dist_thresh=5.0,
            block=2048, window_blocks=2, query_tile=1024)
        ev[1].record()
        T = icp.icp_refine_exact(s4, m4, d4, m4, T, iters=1, subsample=16384,
                                 dist_thresh=5.0)
        T = icp.icp_refine_exact(s4, m4, d4, m4, T, iters=2, subsample=16384,
                                 dist_thresh=0.5)
        ev[2].record()
        return T
    with Recorder(mega, "_launch_icp_mega") as r_k5w4, \
            Recorder(pallas_nn, "nn1") as r_nn_w4:
        T4 = paths.run("workload4", w4_run, {"icp_mega": 1, "nn1": 3})
    rte, rre = gate("workload4", T4, w4_gt, se3, torch, rte_max=0.05)
    w4_ms = ev[0].elapsed_time(ev[2])
    metrics["workload4"] = dict(
        points=int(full.shape[0]), rte=rte, rre=rre, call_ms=w4_ms,
        kernel5_ms=ev[0].elapsed_time(ev[1]),
        refine_ms=ev[1].elapsed_time(ev[2]), iters_per_s=51 / (w4_ms / 1e3))
    print(f"P3 workload 4 ({full.shape[0]} pts, 48+3 iters): RTE {rte:.4f} "
          f"m, RRE {rre:.4f} deg; {w4_ms:.1f} ms per call (kernel 5 "
          f"{metrics['workload4']['kernel5_ms']:.1f} ms) = "
          f"{metrics['workload4']['iters_per_s']:.2f} iters/s")
    # the whole workload with kernel 5 and K1 swapped for their plain
    # versions: the same pose
    t0 = time.perf_counter()
    with swapped(mega, "_launch_icp_mega", mega.icp_mega_plain), \
            swapped(pallas_nn, "nn1", pallas_nn.nearest_plain):
        T4p = w4_run()
    metrics["workload4"].update(
        loop_err_vs_plain=float((T4 - T4p).abs().max()),
        plain_call_s=time.perf_counter() - t0)
    need(metrics["workload4"]["loop_err_vs_plain"] <= 1e-4, "workload4 T",
         metrics["workload4"]["loop_err_vs_plain"])
    print(f"   plain versions: T vs kernels "
          f"{metrics['workload4']['loop_err_vs_plain']:.1e} "
          f"({metrics['workload4']['plain_call_s']:.1f} s)")

    # ---- P4 workload 2: 16 pairs x 4,096 points, K4 ----------------------
    rng2 = np.random.default_rng([args.seed, 2])
    w2 = []
    for _ in range(W2_BATCH):
        s_ = full[rng2.choice(full.shape[0], W2_POINTS, replace=False)]
        d_, g_ = perturb(s_, rng2, rng2.uniform(-0.05, 0.05, 3),
                         rng2.uniform(-0.5, 0.5, 3))
        w2.append((s_, d_, g_))
    s2, d2 = on_dev(np.stack([w[0] for w in w2]), np.stack([w[1] for w in w2]))
    m2 = torch.ones((W2_BATCH, W2_POINTS), dtype=torch.bool, device=dev)

    def w2_run():
        return pair_sweep.batched_icp_mega(s2, m2, d2, m2, **W2)
    with Recorder(mega, "_launch_icp_mega") as r_k4w2:
        T2 = paths.run("workload2", w2_run, {"icp_mega_batch": 2})
    rte, rre = gate("workload2", T2, np.stack([w[2] for w in w2]), se3, torch)
    w2_ms = cuda_ms(w2_run, reps=5)
    metrics["workload2"] = dict(worst_rte=rte, worst_rre=rre, call_ms=w2_ms,
                                pairs_per_s=W2_BATCH / (w2_ms / 1e3))
    print(f"P4 workload 2 ({W2_BATCH}x{W2_POINTS}, 28+2 iters): max RTE "
          f"{rte:.4f} m, max RRE {rre:.4f} deg; {w2_ms:.2f} ms per call = "
          f"{metrics['workload2']['pairs_per_s']:.1f} pairs/s")
    check_mega(mega, r_k4w2.calls, torch)
    with swapped(mega, "_launch_icp_mega", mega.icp_mega_plain):
        T2p = w2_run()
    metrics["workload2"]["loop_err_vs_plain"] = float(
        (T2 - T2p).abs().max())
    need(metrics["workload2"]["loop_err_vs_plain"] <= 1e-4, "workload2 T")

    # ---- P5 the banded ICP loops on workload 1's pair (K6, K7, K8) ---------
    loops = {"nearest_banded": icp.icp_fixed_iters_banded,
               "icp_moments_banded": icp.icp_fixed_iters_banded_fused,
               "icp_moments_banded_v2": icp.icp_fixed_iters_banded_fused_v2}
    launchers = {"nearest_banded": "_launch_nearest_banded",
                 "icp_moments_banded": "_launch_icp_moments_banded",
                 "icp_moments_banded_v2": "_launch_icp_moments_banded_v2"}
    plains = {"nearest_banded": banded.nearest_banded_plain,
              "icp_moments_banded": banded.icp_moments_banded_plain,
              "icp_moments_banded_v2": banded.icp_moments_banded_v2_plain}

    def p5_run():
        return {k: fn(s1, w1_mask, d1, w1_mask, **BANDED)
                for k, fn in loops.items()}
    with Recorder(banded, launchers["nearest_banded"]) as r6, \
            Recorder(banded, launchers["icp_moments_banded"]) as r7, \
            Recorder(banded, launchers["icp_moments_banded_v2"]) as r8:
        Tb = paths.run("banded_loops", p5_run,
                       {k: BANDED["iters"] for k in loops})
    metrics["banded_loops"] = {}
    for k, fn in loops.items():
        rte, rre = gate(fn.__name__, Tb[k], w1_gt, se3, torch)
        ms = cuda_ms(lambda fn=fn: fn(s1, w1_mask, d1, w1_mask, **BANDED),
                     reps=3)
        report["profile_" + fn.__name__] = profile(
            fn.__name__, lambda fn=fn: fn(s1, w1_mask, d1, w1_mask, **BANDED),
            torch, top=4)
        with swapped(banded, launchers[k], plains[k]):
            Tp = fn(s1, w1_mask, d1, w1_mask, **BANDED)
        err = float((Tb[k] - Tp).abs().max())
        need(err <= 1e-4, fn.__name__, "T vs plain", err)
        metrics["banded_loops"][fn.__name__] = dict(
            rte=rte, rre=rre, call_ms=ms, iters_per_s=30 / (ms / 1e3),
            loop_err_vs_plain=err)
        print(f"P5 {fn.__name__}: RTE {rte:.4f} m, RRE {rre:.4f} deg; "
              f"{ms:.2f} ms per 30 iterations; T vs plain {err:.1e}")

    # ---- P6 register_pair: one 35 degree pair of P1 ----------------------
    one = (PointCloud(src.points[0], mask[0]), PointCloud(dst.points[0],
                                                          mask[0]))

    def p6_run():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return pipeline.register_pair(*one, cfg=cfg, generator=gen)
    p6_run()
    with Recorder(mega, "_launch_icp_mega") as r_k5p6, \
            Recorder(pallas_nn, "nn1") as r_nn_p6:
        out6 = paths.run("register_pair", p6_run, {"icp_mega": 2, "nn1": 1})
    need(out6.T.shape == (4, 4) and torch.isfinite(out6.icp_rmse))
    rte, rre = gate("register_pair", out6.T, gts[0], se3, torch)
    p6_ms = cuda_ms(p6_run, reps=3, warmup=0)
    report["profile_register_pair"] = profile("register_pair", p6_run, torch,
                                              top=6)
    with swapped(mega, "_launch_icp_mega", mega.icp_mega_plain), \
            swapped(pallas_nn, "nn1", pallas_nn.nearest_plain):
        out6p = p6_run()
    metrics["register_pair"] = dict(
        rte=rte, rre=rre, call_ms=p6_ms, num_matches=int(out6.num_matches),
        loop_err_vs_plain=float((out6.T - out6p.T).abs().max()))
    need(metrics["register_pair"]["loop_err_vs_plain"] <= 1e-4,
         "register_pair T", metrics["register_pair"]["loop_err_vs_plain"])
    print(f"P6 register_pair ({N_POINTS} pts @ {ROT_DEG} deg): RTE {rte:.4f} "
          f"m, RRE {rre:.4f} deg; {p6_ms:.1f} ms per call; T vs plain "
          f"{metrics['register_pair']['loop_err_vs_plain']:.1e}")

    # ---- P7, P8 classification serving: kernels 11, 12 -------------------
    clouds, labels = modelnet_like(np.random.default_rng([args.seed, 7]),
                                   CLS_REQUESTS * CLS_BATCH, CLS_POINTS)
    dataset = list(zip(clouds, labels))
    pc0, lab0 = on_dev(clouds[:CLS_BATCH], labels[:CLS_BATCH])
    r_fps, r_bg = {}, {}
    for name, preset, n_bg in (("cls_msg", nncfg.MODELNET40_CLS_MSG, 4),
                               ("cls_ssg", nncfg.MODELNET40_CLS_SSG, 2)):
        model = T.build_model(preset, device=dev, generator=torch.Generator(
            ).manual_seed(args.seed))
        ev = T.make_eval_step(model, dev)
        ev(pc0, lab0)                                           # warm-up
        with Recorder(pallas_fps, "_launch_fps") as rf, \
                Recorder(pallas_ballgroup, "_launch_ball_group") as rg:
            res = paths.run(name, lambda: fit.evaluate(
                model, dataset, CLS_BATCH, device=dev),
                {"fps_pallas_batched": 2 * CLS_REQUESTS,
                 "ball_group": n_bg * CLS_REQUESTS})
        r_fps[name], r_bg[name] = rf.calls, rg.calls
        need(np.isfinite(res["loss"]) and 0.0 <= res["acc"] <= 1.0, name, res)
        logits = ev(pc0, lab0)["logits"]
        need(logits.shape == (CLS_BATCH, preset.num_classes)
             and bool(torch.isfinite(logits).all()), name, "logits")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: ev(pc0, lab0), reps=5)
        peak = torch.cuda.max_memory_allocated()
        # the same batch with both kernels swapped for their plain versions
        with swapped(pallas_fps, "_launch_fps", pallas_fps.fps_plain), \
                swapped(pallas_ballgroup, "_launch_ball_group",
                        pallas_ballgroup.ball_group_plain):
            dlog = float((ev(pc0, lab0)["logits"] - logits).abs().max())
        need(dlog <= 1e-5, name, "logits vs plain versions", dlog)
        # 2 clouds on the card and on the CPU, every scale through kernel
        # 12 / its plain version (so both select the same neighbours): the
        # logits within 1e-4 (cuBLAS and the CPU's BLAS sum in other orders)
        cpu_model = copy.deepcopy(model).cpu()
        with swapped(pointnet2, "fused_ok", lambda *a: True), \
                torch.no_grad():
            dcpu = float((model(pc0[:2]).cpu() - cpu_model(pc0[:2].cpu())
                          ).abs().max())
        need(dcpu <= 1e-4, name, "logits vs the CPU", dcpu)
        metrics[name] = dict(
            requests=CLS_REQUESTS, batch=CLS_BATCH, points=CLS_POINTS,
            loss=res["loss"], acc=res["acc"], batch_ms=ms,
            clouds_per_s=CLS_BATCH / (ms / 1e3), peak_mem_bytes=peak,
            logits_err_vs_plain=dlog, logits_err_vs_cpu=dcpu)
        print(f"P{7 if name == 'cls_msg' else 8} {name} {CLS_REQUESTS} x "
              f"{CLS_BATCH} x {CLS_POINTS} pts: loss {res['loss']:.4f}, acc "
              f"{res['acc']:.4f} (random weights); {ms:.2f} ms per batch = "
              f"{metrics[name]['clouds_per_s']:.1f} clouds/s; peak "
              f"{peak / 2**30:.2f} GiB; logits vs plain {dlog:.1e}, vs CPU "
              f"{dcpu:.1e}")
        report["profile_" + name] = profile(name, lambda: ev(pc0, lab0),
                                            torch)
        del model, cpu_model, ev

    # ---- P9 entry(): the flagship forward, then kernel 10 ----------------
    fwd, (pc_e,) = pentry.entry()
    with Recorder(pallas_fps, "_launch_fps") as rf9, \
            Recorder(pallas_ballgroup, "_launch_ball_group") as rg9:
        logits9 = paths.run("entry", lambda: fwd(pc_e),
                            {"fps_pallas_batched": 2, "ball_group": 4})
    need(logits9.shape == (4, 40) and bool(torch.isfinite(logits9).all()),
         "entry logits")
    entry_ms = cuda_ms(lambda: fwd(pc_e), reps=5)
    xyz_e = pc_e[..., :3].contiguous()
    with Recorder(pallas_fps, "_launch_fps") as rf10:
        singles = paths.run("fps_pallas", lambda: [
            pallas_fps.fps_pallas(xyz_e[i], ENTRY_FPS_M) for i in range(4)],
            {"fps_pallas": 4})
    need(rf9.calls[0][1] == ENTRY_FPS_M, "entry SA1 FPS", rf9.calls[0][1])
    rows_b = pallas_fps._launch_fps(*rf9.calls[0])
    need(all(torch.equal(singles[i], rows_b[i]) for i in range(4)),
         "fps_pallas vs the batched rows")
    metrics["entry"] = dict(call_ms=entry_ms)
    print(f"P9 entry (cls-msg, 4 x 1024 pts): {entry_ms:.2f} ms per forward; "
          f"fps_pallas on its 4 clouds = the batched rows")

    # ---- kernels 10-12 against their plain versions -----------------------
    check_fps(pallas_fps, r_fps["cls_msg"] + r_fps["cls_ssg"] + rf9.calls
              + rf10.calls, torch)
    bg_err, bg_boundary, bg_work = check_ball_group(
        pallas_ballgroup, ball_query, gather,
        r_bg["cls_msg"] + r_bg["cls_ssg"] + rg9.calls, torch)
    print(f"kernels 10-12 vs plain: FPS idx identical on "
          f"{sum(map(len, r_fps.values())) + len(rf9.calls) + 4} launches; "
          f"ball_group max |err| {bg_err:.1e}, {bg_boundary} centres with "
          f"a boundary point vs ball_query")
    per_fwd = slice(0, 2)       # one cls-msg forward's launches
    rows["fps_pallas_batched"] = dict(max_abs_err=0.0, **time_launches(
        pallas_fps._launch_fps, pallas_fps.fps_plain,
        r_fps["cls_msg"][per_fwd], [fps_work(a) for a in
                                    r_fps["cls_msg"][per_fwd]]))
    rows["fps_pallas"] = dict(max_abs_err=0.0, **time_launches(
        pallas_fps._launch_fps, pallas_fps.fps_plain, rf10.calls,
        [fps_work(a) for a in rf10.calls]))
    rows["ball_group"] = dict(
        max_abs_err=bg_err, boundary_centres=bg_boundary, **time_launches(
            pallas_ballgroup._launch_ball_group,
            pallas_ballgroup.ball_group_plain, r_bg["cls_msg"][:4],
            bg_work[:4]))
    rows["ball_group"]["per_launch_ms"] = [
        cuda_ms(lambda a=a: pallas_ballgroup._launch_ball_group(*a), reps=5)
        for a in r_bg["cls_msg"][:4]]

    # ---- kernel 5, K6-K8 against their plain versions --------------------
    w4_cut = [a[:6] + (2,) + a[7:] for a in r_k5w4.calls]   # iters cut to 2
    errs = check_mega(mega, r_k5.calls + w4_cut + r_k5p6.calls, torch)
    # K1 at the shapes of P3 (16,384 queries against the whole scan: the
    # db ends in a partial tile) and P6 (one pair)
    nn_other = [check_nn1(mods, a, torch, timed=False)
                for a in r_nn_w4.calls + r_nn_p6.calls]
    rows["nn1"]["other_paths"] = nn_other
    rows["nn1"]["max_abs_err"] = max(
        [rows["nn1"]["max_abs_err"]] + [r["max_abs_err"] for r in nn_other])
    rows["icp_mega"] = dict(max_abs_err=max(errs), library_ms=None,
                            workload4_launch_ms=metrics["workload4"][
                                "kernel5_ms"],
                            workload4_bound=bound(
                                mega_work(r_k5w4.calls[0])[1],
                                mega_work(r_k5w4.calls[0])[0]),
                            **time_mega(mega, r_k5.calls))
    rows.update(check_banded(banded, {"nearest_banded": r6.calls,
                                      "icp_moments_banded": r7.calls,
                                      "icp_moments_banded_v2": r8.calls},
                             torch))
    print("kernel vs plain: all within tolerance")

    # ---- kernels line, card, result --------------------------------------
    meta = {
        "nn1": ("pctpu_torch/csrc/nn1.cu",
                "pctpu/ops/pallas_nn.py:27 _nn_kernel"),
        "spfh": ("pctpu_torch/csrc/fpfh.cu",
                 "pctpu/features/pallas_fpfh.py:88 _spfh_kernel"),
        "wsum": ("pctpu_torch/csrc/fpfh.cu",
                 "pctpu/features/pallas_fpfh.py:147 _wsum_kernel"),
        "icp_mega_batch": ("pctpu_torch/csrc/icp_mega.cu",
                           "pctpu/ops/pallas_icp_mega.py:308 "
                           "_icp_mega_kernel_batch"),
        "icp_mega": ("pctpu_torch/csrc/icp_mega.cu",
                     "pctpu/ops/pallas_icp_mega.py:297 _icp_mega_kernel"),
        "nearest_banded": ("pctpu_torch/csrc/banded.cu",
                           "pctpu/ops/pallas_banded.py:104 _banded_kernel"),
        "icp_moments_banded": ("pctpu_torch/csrc/banded.cu",
                               "pctpu/ops/pallas_banded.py:179 "
                               "_moments_kernel"),
        "icp_moments_banded_v2": ("pctpu_torch/csrc/banded.cu",
                                  "pctpu/ops/pallas_banded.py:321 "
                                  "_moments_kernel_v2"),
        "fps_pallas": ("pctpu_torch/csrc/fps.cu",
                       "pctpu/ops/pallas_fps.py:29 _fps_kernel"),
        "fps_pallas_batched": ("pctpu_torch/csrc/fps.cu",
                               "pctpu/ops/pallas_fps.py:80 "
                               "_fps_kernel_batched"),
        "ball_group": ("pctpu_torch/csrc/ballgroup.cu",
                       "pctpu/ops/pallas_ballgroup.py:34 _ballgroup_kernel"),
    }
    kern_rows = []
    for name in KERNELS:
        source, replaces = meta[name]
        r = rows[name]
        launches = paths.total(name)
        need(launches > 0, name, "never launched on a path")
        kern_rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches, max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    report.update(card=card, kernels=kern_rows, kernel_detail=rows,
                  metrics=metrics, launches=paths.launches,
                  seconds=time.perf_counter() - t_all,
                  note="ms/plain_ms/bound_ms/library_ms: summed over the "
                       "kernel's recorded launches in one call of its path "
                       "(K1-K4: register_pairs; icp_mega: workload 1; "
                       "K6-K8: one 30-iteration call; fps_pallas_batched "
                       "and ball_group: one cls-msg forward at B 32; "
                       "fps_pallas: its 4 launches in P9); launches: "
                       "summed over the paths")
    print(f"total {report['seconds']:.1f} s")
    (ROOT / "build").mkdir(exist_ok=True)
    (ROOT / "build" / "chip_smoke.json").write_text(
        json.dumps(report, indent=1, default=str))
    print(json.dumps({"kernels": kern_rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
