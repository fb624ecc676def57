"""Traffic generators: the synthetic HDL-64E scan and the registration
pairs, as host numpy arrays drawn from one seed.

Frozen copies of the generators the port's smoke script uses
(`lidar_scan`, `make_pairs`), with scipy's rotation-vector map written out
(Rodrigues' formula in float64, then rounded to float32). The same seed
gives the same arrays."""
from __future__ import annotations

import numpy as np

SCAN_POINTS = 124_668           # the reference's KITTI scan


def seed_sequence(seed: int, *salt: int) -> np.random.Generator:
    """A numpy generator for `seed` (any non-negative integer, also past
    64 bits) and a salt that separates the streams of one run."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), *salt]))


def rotvec_matrix(rotvec) -> np.ndarray:
    """Rotation vector -> [3,3] float32 matrix (Rodrigues, in float64)."""
    v = np.asarray(rotvec, np.float64)
    th = np.linalg.norm(v)
    if th == 0.0:
        return np.eye(3, dtype=np.float32)
    k = v / th
    K = np.array([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                  [-k[1], k[0], 0.0]])
    R = np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)
    return R.astype(np.float32)


def lidar_scan(rng: np.random.Generator, n_points: int = SCAN_POINTS,
               height: float = 1.73, max_range: float = 80.0) -> np.ndarray:
    """One scan of a street scene by a spinning 64-beam LiDAR (the
    elevations of a Velodyne HDL-64E, -24.8..+2 deg, 0.09 deg azimuth
    steps): rays from 1.73 m above flat ground cast against the ground,
    24 yawed box buildings, 30 cars and 40 poles; the nearest hit within
    80 m with 1 cm range noise; `n_points` of the hits drawn without
    replacement. [n_points, 3] float32."""
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


def make_pairs(scan: np.ndarray, rng: np.random.Generator, batch: int,
               n_points: int, rotvec, trans, noise: float):
    """Each pair is a random `n_points` subsample of the scan and its copy
    moved by `rotvec` (rad) and `trans` (m), with `noise` (m) of Gaussian
    noise. Returns src, dst [B,N,3] float32 and the truth [B,4,4]."""
    R = rotvec_matrix(rotvec)
    t = np.asarray(trans, np.float32)
    srcs, dsts = [], []
    for _ in range(batch):
        sel = rng.choice(scan.shape[0], n_points, replace=False)
        src = scan[sel]
        dst = (src @ R.T + t + rng.normal(scale=noise, size=src.shape)
               ).astype(np.float32)
        srcs.append(src)
        dsts.append(dst)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return np.stack(srcs), np.stack(dsts), np.repeat(T[None], batch, 0)


def rte_rre(T_pred: np.ndarray, T_gt: np.ndarray):
    """Relative translation (m) and rotation (deg, the sum of the
    extrinsic-xyz Euler angles' magnitudes) errors of [...,4,4] poses, as
    the reference's evaluator (`evaluate_rt.py`) computes them, in
    float64."""
    P = np.linalg.inv(T_pred.astype(np.float64)) @ T_gt.astype(np.float64)
    rte = np.linalg.norm(P[..., :3, 3], axis=-1)
    m = P[..., :3, :3]
    y = np.arcsin(np.clip(-m[..., 2, 0], -1.0, 1.0))
    locked = np.hypot(m[..., 2, 1], m[..., 2, 2]) < 1e-7
    x = np.where(locked, 0.0, np.arctan2(m[..., 2, 1], m[..., 2, 2]))
    z = np.where(locked, np.arctan2(-m[..., 0, 1], m[..., 1, 1]),
                 np.arctan2(m[..., 1, 0], m[..., 0, 0]))
    rre = np.degrees(np.abs(x) + np.abs(y) + np.abs(z))
    return rte, rre
