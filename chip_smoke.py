#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`pctpu_torch`) on one NVIDIA GPU.

Drives the port's paths at the shapes of `bench.py` and holds each
hand-written kernel against its plain PyTorch version:

  P1 `register_pairs`: 16 pairs x 16,384 points at 35 degrees, default
     config (voxel -> radius normals -> fused FPFH -> mutual matching ->
     batched RANSAC, its select and refine in one launch -> voxel ICP ->
     exact refine -> stats): K1-K4 and `ransac_refine`;
  P2 workload 1: ICP of one 16,384-point pair, 47 windowed + 3 exact
     iterations (`icp_fixed_iters_banded_mega`): kernel 5;
  P3 workload 4: the whole 124,668-point scan, 48 windowed iterations of
     kernel 5, then 3 exact iterations (`icp_refine_exact`, K1);
  P4 workload 2: 16 pairs x 4,096 points (`batched_icp_mega`): K4;
  P5 the three banded ICP loops on workload 1's pair, 30 iterations each:
     K6 `nearest_banded`, K7 `icp_moments_banded`, K8
     `icp_moments_banded_v2`;
  P6 `register_pair` on one 35 degree pair of P1, default config:
     kernel 5, K1 and kernel V `voxel_run_means` (the voxel centroids,
     once a cloud; also timed on P3's two whole scans, the benchmark's
     single-pair shapes);
  P7 `cls-msg` serving at the MODELNET40_CLS_MSG shapes (B 32, 4,096
     points x 6 channels, 40 classes): `evaluate` over 4 batches
     ("requests"), port-initialised weights from --seed; per forward
     kernel 11 `fps_pallas_batched` x2 and kernel 12 `ball_group` x4;
  P8 `cls-ssg` serving, the same data: kernel 11 x2, kernel 12 x2;
  P9 `entry()`, the flagship `cls-msg` forward at B 4 x 1,024 points,
     then kernel 10 `fps_pallas` on each of its 4 clouds;
  P10 `cls-msg` training at MODELNET40_CLS_MSG (B 32 x 4,096 x 6, 40
     classes; Adam, the lr and BN-momentum schedules, dropout 0.5, the
     default augmentation on the card): `make_train_step`, 1 warm-up and
     5 timed steps; per step kernel 11 x2, kernel 12 x4 and kernel 14
     `scatter_add_rows` x1 (kernel 12's backward at SA2's fused scale);
  P11 `cls-ssg` training, the same at MODELNET40_CLS_SSG: kernel 11 x2,
     kernel 12 x2, kernel 14 x1 per step;
  P12 `fit` on the toy disk/column task (cls-ssg, 2 classes, 128 points,
     B 8, 3 epochs, no augmentation): val acc > 0.9, a checkpoint, and a
     resumed run that carries on from it;
  `group_points_pallas` forward and backward (kernels 13
  `gather_rows` and 14) on the unfused SA2 `group_points` inputs P10
  recorded;
  P13 the SLAM loop, `bench.py` workload 5 (`run_odometry`: 32 frames of a
     6 m circle through a ground-and-pillars world, point-to-plane scan
     matching, closures initialised by `register_pairs`, the dense pose
     graph): K1 per association, K2-K4 in round 0's global closures;
  P14 a 128-frame figure-eight with a keyframe per frame
     (`tests/test_odometry.py:88-115`): the block-sparse pose graph on the
     card, and its float64 solve against the float32 one;
  P15 the registration-dataset driver (`registration_driver.main`) on P1's
     16 pairs written as oxford .bin files, batch 8: K1-K4, no kernel 5;
  and kernel 9 `moments` through `normals_radius_fused` on P13's frames
  (unbanded) and on P1's voxel clouds (x-banded, then `fpfh_fused` with
  those normals: K9 -> K2 -> K3);
  P16 `semseg-ssg` serving at S3DIS_SEMSEG_SSG (B 24, 4,096 points x 9
     channels, 13 classes): `evaluate` over 4 batches of synthetic
     indoor blocks; per forward kernel 11 x4 and kernel 12 x4 (packed 9,
     67, 131, 259 channels, nsample 32);
  P17 `semseg-msg` serving, the same data: kernel 11 x4, kernel 12 x7
     (SA4's nsample-32 scale, 515 channels, takes ball_query +
     group_points, as the reference's rule says);
  P18 `semseg-ssg` training, the preset's recipe on P16's first batch, 1
     + 5 steps: per step kernel 11 x4, kernel 12 x4, kernel 14 x3 (kernel
     12's backward at SA2-SA4);
  P19 `bench.py` workload 6: `cls-ssg` at B 32 x 4,096 x 6 with window
     grouping and compute_dtype bfloat16 (P10's clouds), and `semseg-ssg`
     at B 16 x 4,096 x 9 with window grouping (P16's blocks, Morton-sorted
     with their labels; float32, as the segmenters take no dtype), 1 + 5
     train steps each; no kernel runs there;
  P20 `segment_ground_and_objects` (k-NN normals, plane RANSAC, DBSCAN;
     default config) on P1's 124,668-point scan: no kernel; the stages
     timed apart, a second run with the same draws bit for bit, and one
     mini-world frame on the card equal to the CPU with the same draws;
  P21 the mini-world task loop (`pipelines/miniworld.py`: 10 train and 4
     eval frames written under build/chip_smoke_mini/, extract, training
     set, `fit` of `cls-ssg` on 64-point clusters for 4 epochs, held-out
     `evaluate`, `detect_frame`, easy-BEV AP): kernels 11 and 12 (2 each
     a forward) and 14 (1 a train step);
  P22 the clustering harness: `K_Means`, `GMM`, `spetral_clustering`
     and `DBSCAN` on numpy versions of `cluster_compare`'s six datasets
     (500 points), on the card and on the CPU: kernel 14 in k-means'
     centre sums;
  P23 registration's two options on P1's pairs: `register_pairs` with
     keypoints="iss" (ISS keypoints of each voxel cloud as the matching
     sites: K1-K4) and with feature_backend="dense" (`fpfh_dense`: K1 and
     K4, no K2/K3; its features against `fpfh_fused`'s on two pairs), and
     `register_pair` with keypoints="iss" on one pair (kernel 5, K1);
  P24 PointRCNN (no kernel): the reference test's recipe (B 4 x 512,
     npoints (128, 32), Adam 3e-3 for 120 steps, then `extract_proposals`
     and `RefineNet(cap=32)`), then `ProposalNet` at its defaults on B 16
     synthetic KITTI-style scenes of 16,384 points x 4 (x, y, z,
     intensity): serving, training, proposals and refinement per scene;
  P25 keypoints and descriptors on P1's first cloud and its voxel cloud:
     ISS, Harris3D (both measures), Harris6D, SIFT3D, SHOT-352 at the ISS
     keypoints, PCA, timed on the card on the whole cloud and held against
     the CPU on every other point of it;
  P26 the grid hash (`ops.grid_hash`: build_grid, grid_nearest, grid_knn,
     grid_radius) on a 16,384-point cut of P1's scan, card against CPU and
     against K1, and on points on the faces of 0.1 m cells; then
     `icp_fixed_iters_grid` on the whole scan offset by 6 deg and 0.4 m
     (`tests/test_register.py:189`), 30 iterations, and on a 16,384-point
     pair card against CPU: no kernel (the reference's grid search reaches
     no Pallas kernel);
  P27 the host code: the native loader (`native.batch_read_velodyne`,
     `voxel_count`) on 4 scans written under build/chip_smoke_host/, the
     C++ KD-tree and octree on the scan against brute force, the
     neighbour-search CLI (`pipelines.nn_benchmark`: K1 in its 1-NN row),
     `utils.profiling` (`measure_mfu`, `profiler_trace`) and the
     `utils.viz` PLY writers;
  P28 distribution over `torch.distributed` (`parallel.launch.run_world`:
     one process a rank; NCCL refuses two ranks on one card, so a gloo
     world of 2 ranks shares it, its transfers staged through host
     memory, and an NCCL world of 1 proves the NCCL path): data-parallel
     `cls-ssg` training on P11's clouds and recipe (kernels 11, 12, 14)
     in both worlds, its first step against `make_train_step` on all 32;
     the full-pipeline sweep (K1-K4) and the ICP pair sweep (K1) on P1's
     16 pairs; the point-sharded ICP on P3's pair (K1) in both worlds; the
     halo 1-NN of P3's scan in 2 x-slabs (K1); the edge-sharded dense and
     sparse pose-graph steps on P14's graph; `entry.dryrun_multichip(2)`.
     Each rank counts its own launches around each path and holds each
     recorded launch against its plain version.

P13-P14 build their worlds and scans from fixed seeds as `bench.py` and
the test do (rng 5 and 0); P15 writes its files under
build/chip_smoke_reg/.

P1-P6 take their clouds from one scan: a synthetic 124,668-point ray-cast
LiDAR scan made from --seed, or the velodyne file given by --scan. P7 and
P8 take synthetic ModelNet-style clouds made from --seed: points and
normals sampled on the surface of a random box, cylinder or sphere; P10
and P11 train on the first 32 of them, P12 on the toy task of
`tests/test_fit.py`. P16-P18 take synthetic S3DIS-style blocks made from
--seed (`indoor_rooms`: floor, ceiling, walls and furniture boxes, 13
labels, indoor3d's channels).

Phases:
  1. environment: versions, the card's name and power limit, precision
     checks, the kernels' build (nvcc, all sources at once);
  2. each path, with every launch counter set to 0 just before it and
     read just after: each must launch exactly its kernels; its result
     must pass its gate (RTE < 2 m and RRE < 5 deg, workload 4 also
     RTE < 0.05 m; the classifiers: finite logits of the right shape,
     cls-ssg's within 1e-4 of the CPU's on 2 clouds; training: a finite
     loss at every step, every parameter moved, one BN's running
     statistics moved by the schedule's momentum, loss and gradients
     against the plain versions and against the CPU; fit: val acc > 0.9
     and a resume; P23: every pair within the bound, dense against fused
     features as `tests/test_features.py:594-618` bounds them (mean |diff|
     < 0.02, under 0.2% of entries above 0.5, max < 15); P24: the
     reference test's gates (a valid first proposal with 3D IoU >= 0.25,
     RefineNet residuals finite of shape (8, 8)), finite outputs and
     losses at full width, logits and residuals within 1e-4 of the CPU's
     on 2 scenes, `nms_rotated` equal to the CPU's; P25: ISS and Harris
     masks equal where no decision hinges on rounding (`decidable`),
     SIFT3D masks equal but for at most 0.1% of the points, SHOT within
     1e-5 given the same normals where its frame is decided
     (`shot_decided`), PCA within 1e-5; the segmenters: logits within
     1e-5 of the plain
     versions' and 1e-4 of the CPU's on 4 clouds, P18's gradients within
     5e-2 of their norms of the CPU's; workload 6: finite losses, the
     logits of 2 clouds within 1e-2 of the largest (bf16) and 1e-4
     (float32) of the CPU's; P20: a plane with |n_z| > 0.99 and (the
     synthetic scan) |d| < 0.1 m, >= 90% of the points below 5 cm ground,
     >= 1 object; P21: the reference test's gates, 10 frames extracted,
     val and held-out accuracy >= 0.9, easy-BEV AP >= 0.7 for Car,
     Pedestrian and Cyclist; P22: k-means labels and centres (1e-5), GMM
     (1e-4, the CPU run for as many EM steps as the card's), spectral and
     DBSCAN partitions equal to the CPU's; SLAM:
     bench.py's gates, >= 1 closure and an optimized
     ATE below the raw one and 0.8 m; the figure-eight: the test's gates;
     the driver: no failed pair, every pair within the bound); its speed
     (CUDA events, or the host clock around a synchronised call);
  3. on the inputs each path gave its kernels (recorded in a run before
     the counted one, or in the counted run itself), each kernel against
     its plain version with the stated tolerance, timed beside its bound
     (P13-P15 and the kernel-9 phase: K1-K4 on every launch;
     `ransac_refine` on every launch of P1, P13-P15, P23 and P28's full
     sweep: R within 1e-5 a term, t within 1e-4 m, the mask equal where no
     residual lies within 1e-4 m of the threshold, on every pair (of
     P13's and P14's closure candidates, on those that float32 resolves:
     `check_refine`);
     `voxel_run_means` on every launch of P6, P13, P14 and P23: equal bit
     for bit to a host float64 in-order sum of each run, rounded once,
     repeating bit for bit, and within one float32 ulp of its plain version
     (near 0, the float64 ulp its prefixes carry: `check_voxel`);
     K2 equal to
     its plain version and K3 repeating bit for bit on every launch of
     P1, P13-P15 and the kernel-9 phase, each launch's device time from a
     CUDA graph beside the pairs it visits, those within the radius and
     the bound);
     and each ICP path run once more with its kernels swapped for their
     plain versions: the poses agree within 1e-4 (the classifiers' logits
     within 1e-5); every recorded K4 / kernel-5 launch timed alone beside
     its bound, the CTAs it launched (P1-P3: at least one per SM) and the
     one-CTA-per-pair design's time, and that kernel's fixed cost per
     iteration; kernels 10/11 per launch shape (SA1, SA2, P9's kernel 10,
     P12's toy SA1 and SA2: `fps_plan`'s launch, us per step, the empty
     step at the same CTA width, the bound), K6, K7 and K8 per P5 launch
     (device time, `nearest_banded_plan`'s and `moments_v2_plan`'s units
     and lanes; every K6 launch's d2 and idx equal to the plain
     version's, every K7/K8 launch's per-tile moments within 1e-12 of
     it), kernel 9 per launch (device time beside CUDA events, its
     `moments_plan` shape, the pairs in its band, in its x-slab and
     within the radius; within one f32 ulp of the plain version, the
     count channel equal, a repeat bit for bit) and kernel 12
     per launch of one P7 and one P8 forward (device time beside the
     launch's bound, the candidates its scan tests, `ball_group_plan`'s
     launch; every recorded launch's idx and rows equal to the plain
     version's);
  4. one JSON line of per-kernel numbers (the 14 kernels, `ransac_refine`,
     `voxel_run_means` and kernel 12's backward, `ball_group_vjp`, kernel
     14's entry on the training paths), the card's line, and last the
     line {"ok": true, "device": {...}}.

Any failure raises: the exit code is nonzero and no result line is
printed. Without CUDA, or outside a checkout of the repo, it exits with 2.
Full results (profile included) are also written to build/chip_smoke.json.

    python3 chip_smoke.py [--seed 0] [--scan velodyne.bin]
"""
import argparse
import contextlib
import copy
import dataclasses
import json
import shutil
import subprocess
import sys
import time
import types
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
           "moments", "fps_pallas", "fps_pallas_batched", "ball_group",
           "gather_rows", "scatter_add_rows", "ransac_refine",
           "voxel_run_means")
# K4 / kernel 5: ms of each path's recorded launches in the kernel's first
# design, one CTA per pair (PERF.md §6; H100 80GB HBM3, 700 W), None where
# that design was not timed on the path; and the paths whose every launch
# must put at least one CTA on each SM
MEGA_ONE_CTA_MS = {"P1 register_pairs": 29.39, "P2 workload 1": 305.1,
               "P3 workload 4": 4764.0, "P4 workload 2": None,
               "P6 register_pair": 304.4, "P13 SLAM": 27.1,
               "P14 figure-eight": None, "P15 driver": None}
MEGA_SPREAD = ("P1 register_pairs", "P2 workload 1", "P3 workload 4")
CLS_REQUESTS, CLS_BATCH, CLS_POINTS = 4, 32, 4096   # MODELNET40_CLS_*
ENTRY_FPS_M = 512                   # SA1 of the entry forward
TRAIN_STEPS = 5                     # timed train steps, after 1 warm-up
SEM_REQUESTS, SEM_BATCH, SEM_POINTS = 4, 24, 4096   # S3DIS_SEMSEG_*
SEM_CPU = 4                         # clouds held against the CPU
W6_SEM_BATCH = 16                   # bench.py:375 semseg-ssg batch
MW_TRAIN, MW_EVAL, MW_EPOCHS = 10, 4, 4   # tests/test_pipelines.py:297
# the JAX package's figures for that loop on CPU devices (README.md:600-604)
MW_JAX_CPU = dict(val_acc=1.00, ap_easy_bev=dict(Car=1.00, Cyclist=1.00,
                                                 Pedestrian=0.75))
CLUSTER_N = 500                     # cluster_compare.py's n_samples
ODO_FRAMES = 32                     # bench.py ODO_FRAMES
ODO_CFG = dict(voxel_leaf=0.4, icp_iters=30, icp_dist_thresh=3.0,
               keyframe_every=4, closure_radius=13.0, closure_min_gap=3,
               query_chunk=1024, frontend="scan")      # bench.py:336-339


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


def indoor_rooms(rng, count, n_points):
    """Synthetic S3DIS-style blocks: (clouds [count,N,9] f32, labels
    [count,N] int) with indoor3d's channels, xyz in a 1 x 1 m block of a
    room 3 m high, rgb in [0, 1] and xyz divided by the room's extent,
    and 13 labels: ceiling 0, floor 1, wall 2 (the planes x = 0 and
    y = 1) and boxes of the furniture classes 3-12 (their five visible
    faces, by area); colours per class plus noise, 2 mm jitter."""
    extent = np.array([1.0, 1.0, 3.0])
    base = rng.uniform(size=(13, 3))
    clouds, labels = [], []
    for _ in range(count):
        part = rng.choice(4, n_points, p=[0.15, 0.25, 0.3, 0.3])
        p = rng.uniform(size=(n_points, 3)) * extent
        lab = np.array([0, 1, 2, 0])[part]
        p[part == 0, 2] = 3.0
        p[part == 1, 2] = 0.0
        wall = np.flatnonzero(part == 2)
        on_y = rng.uniform(size=wall.size) < 0.5
        p[wall[on_y], 1], p[wall[~on_y], 0] = 1.0, 0.0
        boxes = np.flatnonzero(part == 3)
        which = rng.integers(0, 3, boxes.size)
        for j in range(3):
            lo = rng.uniform([0.1, 0.1, 0.0], [0.6, 0.6, 0.0])
            size = rng.uniform([0.1, 0.1, 0.3], [0.4, 0.4, 1.8])
            sel = boxes[which == j]
            q = lo + rng.uniform(size=(sel.size, 3)) * size
            face = rng.integers(0, 5, sel.size)      # no bottom face
            side = np.flatnonzero(face < 4)
            ax, hi = face[side] // 2, face[side] % 2
            q[side, ax] = lo[ax] + hi * size[ax]
            q[face == 4, 2] = lo[2] + size[2]
            p[sel] = q
            lab[sel] = rng.integers(3, 13)
        p += rng.normal(scale=0.002, size=p.shape)
        rgb = np.clip(base[lab] + rng.normal(scale=0.05, size=p.shape), 0, 1)
        clouds.append(np.concatenate([p, rgb, p / extent], axis=1))
        labels.append(lab)
    return np.stack(clouds).astype(np.float32), np.stack(labels)


def toy_dataset(n, num_points=128, seed=0):
    """The toy task of `tests/test_fit.py:9-31`: items (cloud [N,6],
    label), flat disks (label 0) and tall columns (label 1) in turn."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        label = i % 2
        pts = np.zeros((num_points, 6), np.float32)
        if label == 0:
            pts[:, :2] = rng.uniform(-1, 1, (num_points, 2))
            pts[:, 2] = rng.normal(scale=0.02, size=num_points)
        else:
            pts[:, 2] = rng.uniform(-1, 1, num_points)
            pts[:, :2] = rng.normal(scale=0.05, size=(num_points, 2))
        pts[:, 3:] = rng.normal(scale=0.1, size=(num_points, 3))
        items.append((pts, label))
    return items


def slam_world(rng, n_ground=3000, n_pillar=250):
    """The world of `bench.py:302-315` (and `tests/test_odometry.py:
    8-24`): flat ground over 60 x 60 m (2 cm height noise) and 12 pillars,
    0.4 m cylinders 4 m tall, as one point set."""
    pts = [np.concatenate([rng.uniform(-30, 30, (n_ground, 2)),
                           rng.normal(scale=0.02, size=(n_ground, 1))], axis=1)]
    for _ in range(12):
        c = rng.uniform(-25, 25, 2)
        ang = rng.uniform(0, 2 * np.pi, n_pillar)
        pts.append(np.stack([c[0] + 0.4 * np.cos(ang),
                             c[1] + 0.4 * np.sin(ang),
                             rng.uniform(0, 4, n_pillar)], axis=1))
    return np.concatenate(pts).astype(np.float32)


def circle_poses(n_frames, radius):
    """`bench.py:317-326`: a circular drive, heading along the circle."""
    gt = []
    for i in range(n_frames):
        th = 2 * np.pi * i / n_frames
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(th), np.sin(th)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        T[:3, 3] = [radius * c, radius * s, 0.0]
        gt.append(T)
    return np.stack(gt)


def figure_eight_poses(n_frames, radius=6.0):
    """`tests/test_odometry.py:71-87`: a 1:2 Lissajous figure-eight,
    heading along the velocity."""
    poses = []
    for i in range(n_frames):
        t = i / n_frames
        x = radius * np.sin(2 * np.pi * t)
        y = 0.5 * radius * np.sin(4 * np.pi * t)
        yaw = np.arctan2(0.5 * radius * 4 * np.pi * np.cos(4 * np.pi * t),
                         radius * 2 * np.pi * np.cos(2 * np.pi * t))
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(yaw), np.sin(yaw)
        T[:3, :3] = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        T[:3, 3] = [x, y, 0.0]
        poses.append(T)
    return np.stack(poses)


def render_scans(world, gt, rng, max_range, noise=0.01):
    """Each pose's scan: the world in the sensor frame, cropped to
    `max_range` in the plane, with `noise` m Gaussian noise
    (`bench.py:324-329`)."""
    scans = []
    for T in gt:
        inv = np.linalg.inv(T)
        local = world @ inv[:3, :3].T + inv[:3, 3]
        keep = np.linalg.norm(local[:, :2], axis=1) < max_range
        scans.append((local[keep] + rng.normal(
            scale=noise, size=(int(keep.sum()), 3))).astype(np.float32))
    return scans


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


def graph_ms(fns, reps=5):
    """Milliseconds of one pass over the thunks `fns`, captured into one
    CUDA graph and replayed `reps` times between CUDA events: the device
    time of their launches, without the host's time to enqueue them."""
    import torch
    for f in fns:                               # warm-up, not captured
        f()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for f in fns:
            f()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
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
        """`expect` is a dict of launches, or a function of fn's result
        returning one (for a path whose work depends on its data)."""
        for k in self.counted.values():
            k.launches = 0
        out = fn()
        self.torch.cuda.synchronize()
        if callable(expect):
            expect = expect(out)
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

def nn1_work(q, db, pen):
    """(ops, bytes) of one K1 launch: 8 flops per (query, db) pair (3 sub,
    3 mul, 2 add; the penalty add and the compare uncounted); the inputs
    read once, (d2, idx) written once."""
    b_, m, _ = q.shape
    return 8.0 * b_ * m * db.shape[1], nbytes(q, db, pen) + b_ * m * 8


def banded_nn_work(args):
    """(ops, bytes) of one K6 launch (`_launch_nearest_banded`'s args):
    10 flops per (query, window column) pair (3 sub, 3 mul, 3 add, the
    compare: a 1-NN tests every column of its window); the inputs read
    once, (d2, idx) written once."""
    q, dbt, pen, off, block, wb, tq = args
    mp = q.shape[0]
    return 10.0 * mp * wb * block, nbytes(q, dbt, pen, off) + mp * 8


def moments_work(args, plain):
    """(ops, bytes, pairs) of one K9 launch (`moments`' args; `plain` its
    plain version's [B,Np,10] result). The pairs it needs: every pair of
    a query and a live column (pen < 1e20) of its band whose x lies
    within r of the query's, since no x-ordered scan can skip one (10
    flops each: 3 mul and 2 add of q.p, |q|^2 + |p|^2, 2 q.p, the
    difference, the penalty, the compare), and each pair within the
    radius (the count channel) 10 adds more (f64, counted at the FP32
    rate); the inputs read once, the result written once. `pairs`: the
    band's pairs, the x-slab's and those within the radius."""
    import torch
    amat, dbmat, cent, base, nt, q_tile, db_tile, r2 = args
    b, np_, _ = amat.shape
    cols = torch.arange(np_, device=amat.device)
    slab = 0
    for i in range(b):
        lo = base[i].long()[:, None] * db_tile
        band = (cols >= lo) & (cols < lo + nt[i].long()[:, None] * db_tile)
        near = ((amat[i, :, 0, None] - dbmat[i, 0][None, :]).abs()
                <= r2 ** 0.5) & (dbmat[i, 4] < 1e20)[None, :]
        slab += int((near.reshape(-1, q_tile, np_) & band[:, None, :]).sum())
    within = float(plain[..., 9].double().sum())
    pairs = dict(in_band=int(nt.sum()) * q_tile * db_tile, x_slab=slab,
                 within=within)
    return (10.0 * slab + 10.0 * within, nbytes(*args[:5], plain), pairs)


def check_nn1(mods, args, torch, timed=True):
    """K1 vs plain: d2 and idx exactly equal (the kernel keeps the plain
    version's rounding order and lowest-index ties). `timed` adds the
    kernel's, the plain version's and the library's times and the bound."""
    nn = mods["pallas_nn"]
    q, db, pen = args
    d2k, ik = nn.nn1(q, db, pen)
    d2p, ip = nn.nearest_plain(q, db, pen)
    need(torch.equal(d2k, d2p) and torch.equal(ik, ip), "nn1 vs plain",
         tuple(q.shape), tuple(db.shape))
    b_, m, _ = q.shape
    detail = f"{b_}x{m} queries vs {db.shape[1]} db, d2 and idx equal"
    if not timed:
        return dict(max_abs_err=0.0, detail=detail)
    ms = graph_ms([lambda: nn.nn1(q, db, pen)] * 20) / 20
    plain = cuda_ms(lambda: nn.nearest_plain(q, db, pen), reps=3)
    lib = cuda_ms(lambda: torch.cdist(q, db).square().min(dim=2), reps=5)
    bms, by = bound(nn1_work(*args)[1], nn1_work(*args)[0])
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, detail=detail)


def _flip_ok(k, p, name):
    diff = (k - p).abs()
    flips, mean, mx = (float((diff > 0.5).float().mean()),
                       float(diff.mean()), float(diff.max()))
    need(flips < 2e-3 and mean < 0.02 and mx < 15.0,
         (name, flips, mean, mx))
    return mx


def check_fpfh(mods, spfh_calls, wsum_calls, torch, timed=True):
    """K2, K3 vs plain on a path's recorded inputs: K2's histograms and
    counts equal to the plain version's (integer bins, scaled once); K3
    within the bin-boundary bound of its plain version (flip fraction <
    2e-3, mean |diff| < 0.02, max |diff| < 15: the plain version sums
    through a matmul, the kernel in column order) and the same bits on a
    second launch. Per launch: its device time (a CUDA graph of 10), the
    in-band pairs it visits and the pairs within the radius; per kernel
    the bound for this data (K2 ~10 flops an in-band pair and ~70 a pair
    within the radius, K3 ~8 and ~68). `timed` adds the plain versions'
    times."""
    f = mods["pallas_fpfh"]
    res = {}
    within = []
    for args in spfh_calls:
        hist, cnt = f.spfh_plain(*args)
        within.append(float(torch.where(hist[..., :11].sum(-1) > 0, cnt,
                                        0.0).sum()))
    for name, calls in (("spfh", spfh_calls), ("wsum", wsum_calls)):
        kern, plain = getattr(f, name), getattr(f, name + "_plain")
        err = 0.0
        visited, byt, launch_us = [], 0, []
        for args in calls:
            outk, outp = kern(*args), plain(*args)
            torch.cuda.synchronize()
            if name == "spfh":
                need(torch.equal(outk[0], outp[0])
                     and torch.equal(outk[1], outp[1]), "spfh vs plain",
                     tuple(args[0].shape))
                byt += nbytes(*args[:4], *outk)
            else:
                again = kern(*args)
                torch.cuda.synchronize()
                need(torch.equal(again, outk), "wsum repeat",
                     tuple(args[0].shape))
                err = max(err, _flip_ok(outk, outp, name))
                byt += nbytes(*args[:5], outk)
            q_tile, db_tile = args[-3], args[-2]
            visited.append(int(args[3].sum()) * q_tile * db_tile)
            launch_us.append(graph_ms([lambda a=args: kern(*a)] * 10) * 1e2)
        per_pair, per_within = (10.0, 70.0) if name == "spfh" else (8.0, 68.0)
        ops = per_pair * sum(visited) + per_within * sum(within)
        bms, by = bound(byt, ops)
        res[name] = dict(max_abs_err=err, visited=visited, within=within,
                         bytes=byt, ops=ops, bound_ms=bms, bound_by=by,
                         launch_us=launch_us, ms=sum(launch_us) / 1e3)
        if timed:
            res[name]["plain_ms"] = sum(cuda_ms(lambda a=a: plain(*a), reps=2)
                                        for a in calls)
    return res


def fpfh_line(path, fp):
    """One line of K2's and K3's device times on a path's launches."""
    return (f"   K2, K3 on {path}'s {len(fp['spfh']['launch_us'])} launches "
            "(device time, us each; bound): K2 "
            + ", ".join(f"{t:.2f}" for t in fp["spfh"]["launch_us"])
            + f" ({fp['spfh']['ms'] * 1e3:.2f} in all; "
            f"{fp['spfh']['bound_ms'] * 1e3:.2f}), K3 "
            + ", ".join(f"{t:.2f}" for t in fp["wsum"]["launch_us"])
            + f" ({fp['wsum']['ms'] * 1e3:.2f}; "
            f"{fp['wsum']['bound_ms'] * 1e3:.2f}); pairs "
            + ", ".join(f"{v:,}" for v in fp["spfh"]["visited"])
            + ", within " + ", ".join(f"{w:,.0f}" for w in fp["spfh"]["within"])
            + "; K2 equal to plain, K3 repeats bit for bit, max |err| "
            f"{fp['wsum']['max_abs_err']:.1e}")


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


def refine_work(args):
    """(ops, bytes) of one `ransac_refine` launch: per pair and row, 13
    flops of the weighted sums, 27 of the centred moments and 26 of the
    re-score, and some 2,000 of the 3x3 algebra; the scores, one inlier
    row, the points, the valid flags and n_valid read once, T, the mask,
    the count and the fitness written once."""
    scores, inl, src, dst, valid, n_valid, _ = args
    b, h, m = inl.shape
    return (b * (66.0 * m + 2000.0),
            nbytes(scores, src, dst, valid, n_valid) + b * m
            + b * (64 + m + 8))


def procrustes64(args, torch):
    """The weighted Procrustes problem that each pair of a `ransac_refine`
    launch (`args`) refits (the first maximum score's inlier row as
    weights), in float64: R [B,3,3] from H's SVD with the determinant's
    correction, and H's singular values over its largest, [B,3]
    descending."""
    scores, inl, src, dst = (x.cpu() for x in args[:4])
    b = scores.shape[0]
    w = inl[torch.arange(b), torch.argmax(scores, 1)].double()
    p, q = src.double(), dst.double()
    ws = w.sum(1).clamp_min(1e-12)[:, None]
    pc, qc = (w[..., None] * p).sum(1) / ws, (w[..., None] * q).sum(1) / ws
    H = torch.einsum("bmi,bmj->bij", q - qc[:, None],
                     (p - pc[:, None]) * w[..., None])
    U, sv, Vt = torch.linalg.svd(H)
    d = torch.ones((b, 3), dtype=torch.float64)
    d[:, 2] = torch.sign(torch.det(U @ Vt))
    return (U @ torch.diag_embed(d) @ Vt,
            sv / sv[:, :1].clamp_min(1e-300))


def check_refine(ransac, calls, torch, strict=False):
    """`ransac_refine` (`_launch_refine`) vs `_select_refine_plain` on
    recorded launches, the same CUDA tensors: R within 1e-5 a term, t
    within 1e-4 m, the inlier masks equal wherever no residual under
    either pose lies within 1e-4 m of the threshold (`unsure_rows`).
    Unless `strict` (the SLAM loops, whose closure candidates may hold 3
    inliers), that holds on the pairs whose H float32 resolves:
    singular values over the largest (`procrustes64`) of at least 0.01
    (the least; five times `rotation_polar3`'s 2e-3 switch to its
    fallback) and 0.05 (the middle; so sigma_1 / (sigma_2 + sigma_3), by
    which the polar factor scales a rounding of H, is at most 20). A few
    inliers in a line or a plane (the SLAM loops' closure candidates)
    leave R to the order of float32's sums on either side: on 132 pairs
    of P13's and P14's launches replayed on a CPU, six reorderings of the
    plain version's sums moved R by at most 1.8e-7 inside these limits
    and by up to 0.52 outside them. Every pair: R a rotation within 1e-4
    a term, T's last row [0 0 0 1], the mask that of the kernel's own
    pose off the threshold's 1e-4 m, the count and fitness from the mask.
    Returns the worst errors, and on the other pairs the worst gap
    between the sides and of each side from the float64 R."""
    from ransac_cases import unsure_rows

    def worst(x):
        return float(x.max()) if x.numel() else 0.0
    out = dict(checked=0, pairs=0, max_abs_err=0.0, t_err=0.0,
               unsure_rows=0, ill_posed=0, ill_gap=0.0, ill_plain_err=0.0,
               ill_kernel_err=0.0, orth_err=0.0)
    eye = torch.eye(3, dtype=torch.float64)
    for k, args in enumerate(calls):
        got = ransac._launch_refine(*args)
        ref = ransac._select_refine_plain(*args)
        torch.cuda.synchronize()
        Tk, Tp = got.T.cpu().double(), ref.T.cpu().double()
        need(bool(torch.isfinite(Tk).all()), "ransac_refine finite", k)
        R64, sv = procrustes64(args, torch)
        Rk, Rp = Tk[:, :3, :3], Tp[:, :3, :3]
        ep = (Rp - R64).abs().amax((1, 2))
        well = torch.ones_like(ep, dtype=torch.bool) if strict else \
            (sv[:, 2] >= 0.01) & (sv[:, 1] >= 0.05)
        dR = (Rk - Rp).abs().amax((1, 2))
        dt = (Tk[:, :3, 3] - Tp[:, :3, 3]).abs().amax(1)
        need(bool((dR[well] <= 1e-5).all() and (dt[well] <= 1e-4).all()),
             "ransac_refine R, t", k, worst(dR[well]), worst(dt[well]))
        need(torch.equal(got.T[:, 3], ref.T[:, 3]), "ransac_refine T row", k)
        orth = float((Rk.transpose(1, 2) @ Rk - eye).abs().max())
        need(orth <= 1e-4 and bool((torch.det(Rk) > 0).all()),
             "ransac_refine rotation", k, orth)
        src, dst = args[2].cpu().double().numpy(), args[3].cpu().double()
        dist = args[6] ** 0.5
        unsure = unsure_rows([Tk.numpy(), Tp.numpy()], src, dst.numpy(),
                             dist=dist)
        sure = torch.from_numpy(~unsure) & well[:, None]
        mk, mp = got.inlier_mask.cpu(), ref.inlier_mask.cpu()
        need(torch.equal(mk[sure], mp[sure]), "ransac_refine mask", k)
        own = torch.linalg.vector_norm(
            torch.from_numpy(src) @ Rk.transpose(1, 2) + Tk[:, None, :3, 3]
            - dst, dim=-1)
        off = (own - dist).abs() > 1e-4
        need(torch.equal(mk[off], ((own < dist) & args[4].cpu())[off]),
             "ransac_refine mask vs its own pose", k)
        need(torch.equal(got.inliers,
                         got.inlier_mask.sum(1, dtype=torch.int32))
             and torch.equal(got.fitness, got.inliers / args[5]),
             "ransac_refine count, fitness", k)
        ill = ~well
        ek = (Rk - R64).abs().amax((1, 2))
        out.update(
            checked=k + 1, pairs=out["pairs"] + len(ep),
            max_abs_err=max(out["max_abs_err"], worst(dR[well])),
            t_err=max(out["t_err"], worst(dt[well])),
            unsure_rows=out["unsure_rows"] + int(unsure.sum()),
            ill_posed=out["ill_posed"] + int(ill.sum()),
            orth_err=max(out["orth_err"], orth))
        out.update(ill_gap=max(out["ill_gap"], worst(dR[ill])),
                   ill_plain_err=max(out["ill_plain_err"], worst(ep[ill])),
                   ill_kernel_err=max(out["ill_kernel_err"], worst(ek[ill])))
    return out


def check_voxel(voxel, calls, torch):
    """`voxel_run_means` (kernel V) on recorded launches: each voxel's
    centroid equal bit for bit to a host float64 sum of its run in row
    order, rounded once (`tests/voxel_runs.py:in_order_means`), a second
    launch equal bit for bit, and the plain version (`_run_means_plain`,
    float64 cumsum differences) on the same CUDA tensors within one
    float32 ulp, near 0 within the float64 ulp of the column's sum of |x|
    that its prefixes carry (`plain_gap_ok`). Returns the launches
    checked, the voxels, the rows that differ from the plain version and
    the largest gap to it."""
    from voxel_runs import in_order_means, plain_gap_ok
    out = dict(checked=0, voxels=0, rows_differing=0, max_abs_err=0.0)
    for k, args in enumerate(calls):
        got = voxel._launch_run_means(*args)
        again = voxel._launch_run_means(*args)
        plain = voxel._run_means_plain(*args[:4])
        torch.cuda.synchronize()
        nv = int(args[4])
        g, p = got[:nv].cpu().numpy(), plain[:nv].cpu().numpy()
        need(torch.equal(got, again), "voxel_run_means repeat", k)
        need(bool((g == in_order_means(*args)).all()),
             "voxel_run_means vs the in-order sums", k)
        need(plain_gap_ok(p, g, args[0], args[1]), "voxel_run_means vs plain",
             k, float(np.abs(g - p).max()) if nv else 0.0)
        out.update(checked=k + 1, voxels=out["voxels"] + nv,
                   rows_differing=out["rows_differing"]
                   + int((g != p).any(1).sum()),
                   max_abs_err=max(out["max_abs_err"], float(
                       np.abs(g - p).max()) if nv else 0.0))
    return out


def voxel_work(args):
    """(ops, bytes) of one `voxel_run_means` launch: 3 adds and a count a
    valid row, 3 divisions a voxel; each valid row's point and two flags
    read once, the nv run starts read once, N rows written."""
    ps, ms = args[0], args[1]
    valid, nv = int(ms.sum()), int(args[4])
    return (4.0 * valid + 3.0 * nv,
            valid * (12 + 2) + nv * 8 + ps.shape[0] * 12)


@contextlib.contextmanager
def recording_k1_k4(pallas_nn, pallas_fpfh, mega):
    """Records the inputs of every K1-K4, `ransac_refine` and
    `voxel_run_means` launch of a run (`Recorder`)."""
    from pctpu_torch.ops import voxel
    from pctpu_torch.register import ransac
    with Recorder(pallas_nn, "nn1") as r_nn, \
            Recorder(pallas_fpfh, "spfh") as r_spfh, \
            Recorder(pallas_fpfh, "wsum") as r_wsum, \
            Recorder(mega, "_launch_icp_mega") as r_k4, \
            Recorder(ransac, "ransac_refine") as r_rr, \
            Recorder(voxel, "voxel_run_means") as r_v:
        yield dict(nn1=r_nn, spfh=r_spfh, wsum=r_wsum, icp_mega=r_k4,
                   ransac_refine=r_rr, voxel_run_means=r_v)


def check_path_kernels(mods, rec, torch, strict=True):
    """K1-K4, `ransac_refine` and `voxel_run_means` vs plain on every
    launch of one path's run, at check_nn1's, check_fpfh's, check_mega's,
    check_refine's and check_voxel's tolerances (`strict`: check_refine's
    on every pair). Returns what was checked and the worst errors."""
    calls = rec["nn1"].calls
    for a in calls:
        check_nn1(mods, a, torch, timed=False)
    out = {"nn1": dict(
        checked=len(calls), launches=len(calls),
        batch_sizes=sorted({int(a[0].shape[0]) for a in calls}),
        max_abs_err=0.0)}
    if rec["spfh"].calls:
        fp = check_fpfh(mods, rec["spfh"].calls, rec["wsum"].calls, torch,
                        timed=False)
        for k in ("spfh", "wsum"):
            out[k] = dict(checked=len(rec[k].calls),
                          max_abs_err=fp[k]["max_abs_err"])
        out["fpfh"] = fp
    if rec["icp_mega"].calls:
        errs = check_mega(mods["pallas_icp_mega"], rec["icp_mega"].calls,
                          torch)
        out["icp_mega_batch"] = dict(checked=len(errs), max_abs_err=max(errs))
    if rec["ransac_refine"].calls:
        from pctpu_torch.register import ransac
        out["ransac_refine"] = check_refine(ransac, rec["ransac_refine"].calls,
                                            torch, strict)
    if rec["voxel_run_means"].calls:
        from pctpu_torch.ops import voxel
        out["voxel_run_means"] = check_voxel(
            voxel, rec["voxel_run_means"].calls, torch)
    return out


def kernels_line(name, res):
    return (f"   {name} kernels vs plain on this run's launches: K1 "
            f"{res['nn1']['checked']} of {res['nn1']['launches']} (batch "
            f"sizes {res['nn1']['batch_sizes']}) max |err| "
            f"{res['nn1']['max_abs_err']:.1e}" + "".join(
                f", {k} {res[k]['checked']} max |err| "
                f"{res[k]['max_abs_err']:.1e}"
                for k in ("spfh", "wsum", "icp_mega_batch", "ransac_refine",
                          "voxel_run_means")
                if k in res))


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


def mega_launch_table(m, path_calls):
    """Every recorded K4 / kernel-5 launch of each path, timed alone
    (CUDA events), beside its bound (`mega_work`), the CTAs it launched
    and the card's SMs (`launch_plan`), and the one-CTA-per-pair design's
    time of the path (MEGA_ONE_CTA_MS). On the MEGA_SPREAD paths every
    launch must put a CTA on each SM."""
    table = {}
    for path, calls in path_calls.items():
        rows_ = []
        for a in calls:
            plan = m.launch_plan(a)
            ops, byt = mega_work(a)
            bms, by = bound(byt, ops)
            rows_.append(dict(
                ms=cuda_ms(lambda a=a: m._launch_icp_mega(*a), reps=3),
                bound_ms=bms, bound_by=by, ctas=plan["grid"],
                sms=plan["sms"], lanes=plan["lanes"], units=plan["units"],
                pairs=int(a[3].shape[0]), queries=int(a[3].shape[2]),
                window=a[8] * a[9], query_tile=a[10], iters=a[6]))
            if path in MEGA_SPREAD:
                need(plan["grid"] >= plan["sms"], path, "CTAs", plan)
        table[path] = dict(launches=rows_, ms=sum(r["ms"] for r in rows_),
                           bound_ms=sum(r["bound_ms"] for r in rows_),
                           one_cta_ms=MEGA_ONE_CTA_MS[path])
        old = MEGA_ONE_CTA_MS[path]
        print(f"   {path}: {len(rows_)} launch(es) "
              + " + ".join(f"{r['ms']:.3f}" for r in rows_)
              + f" = {table[path]['ms']:.3f} ms (bound "
              + " + ".join(f"{r['bound_ms']:.4f}" for r in rows_)
              + f" ms, {rows_[0]['bound_by']}); CTAs "
              + ", ".join(f"{r['ctas']}" for r in rows_)
              + f" on {rows_[0]['sms']} SMs (lanes "
              + ", ".join(f"{r['lanes']}" for r in rows_) + "; pairs x "
              "queries x window x iters "
              + ", ".join(f"{r['pairs']}x{r['queries']}x{r['window']}x"
                          f"{r['iters']}" for r in rows_)
              + "); one CTA per pair: "
              + (f"{old} ms" if old else "not timed"))
    return table


def mega_fixed_cost(m, args):
    """ms per iteration that does not grow with the window, at the grid of
    the launch `args`: the same launch over a db of one 16-point block,
    101 iterations against 1 (the grid barrier, the last unit's reduction
    and solve, a unit's load latency)."""
    a = list(args)
    a[0], a[8], a[9] = args[0][:, :, :16].contiguous(), 16, 1
    t = []
    for iters in (1, 101):
        a[6] = iters
        t.append(cuda_ms(lambda: m._launch_icp_mega(*a), reps=5))
    return (t[1] - t[0]) / 100, m.launch_plan(a)["grid"]


def index_add_ms(calls, torch):
    """`index_add_` (one call into a zeroed [B*n, C]) on the inputs of
    each recorded kernel-14 launch (grads [B,M,C], idx [B,M], n)."""
    out = []
    for g_, i_, n_ in calls:
        dev = g_.device
        fi = (i_.long() + n_ * torch.arange(g_.shape[0], device=dev)[:, None]
              ).reshape(-1)
        gf = g_.reshape(-1, g_.shape[2])
        rn = g_.shape[0] * n_
        out.append(cuda_ms(lambda fi=fi, gf=gf, rn=rn: torch.zeros(
            (rn, gf.shape[1]), device=dev).index_add_(0, fi, gf), reps=5))
    return out


def nn1_table(nn, cases, sms, torch):
    """K1 at each path's shapes: per launch, its device time (`graph_ms`
    over the case's recorded launches), its bound (`nn1_work`) and
    `cdist`^2 + `min` on the same inputs (CUDA events), with the shapes and
    `nn1_plan`'s grids and db slices."""
    table = {}
    for name, calls in cases.items():
        k = len(calls)
        ms = graph_ms([lambda a=a: nn.nn1(*a) for a in calls]
                      * max(1, 20 // k)) / (k * max(1, 20 // k))
        lib = cuda_ms(lambda: [torch.cdist(q, db).square().min(dim=2)
                               for q, db, _ in calls], reps=3) / k
        bms, by = bound(sum(nn1_work(*a)[1] for a in calls),
                        sum(nn1_work(*a)[0] for a in calls))
        shapes, plans = {}, {}      # "BxMxN" and "grid x slices": launches
        for q, db, _ in calls:
            sh = (int(q.shape[0]), int(q.shape[1]), int(db.shape[1]))
            key = "x".join(map(str, sh))
            shapes[key] = shapes.get(key, 0) + 1
            p = nn.nn1_plan(*sh, sms)
            key = f"{p['grid']} x {p['slices']}"
            plans[key] = plans.get(key, 0) + 1
        table[name] = dict(launches=k, ms=ms, bound_ms=bms / k, bound_by=by,
                           library_ms=lib, shapes=shapes, plans=plans)

        def top(d):
            items = sorted(d.items(), key=lambda kv: -kv[1])
            return ", ".join(f"{key} ({c})" for key, c in items[:3]) + (
                f" and {len(items) - 3} more" if len(items) > 3 else "")
        print(f"   K1 {name}: {k} launch(es), {ms * 1e3:.1f} us per launch "
              f"(bound {bms / k * 1e3:.2f} us, {by}; cdist^2 + min "
              f"{lib * 1e3:.1f} us); B x M x N {top(shapes)}; grid x slices "
              f"{top(plans)}")
    return table


def scatter_table(pg, kernels, cases, torch):
    """Kernel 14 at each recorded shape: the whole launch, its bucket sort
    (`pct_scatter_sort`) and its row sum (`pct_scatter_sum`) timed apart
    (CUDA events), beside `index_add_` and the bound (`scatter_work`);
    each half's result equal to the plain version, and two runs equal."""
    sort = kernels.entry("gather.cu", "pct_scatter_sort", n_ptr=4, n_int=3)
    summ = kernels.entry("gather.cu", "pct_scatter_sum", n_ptr=4, n_int=4)
    table = {}
    for name, (g, idx, n) in cases.items():
        b_, m, c = g.shape
        dev = g.device
        start = torch.empty((b_, n + 1), dtype=torch.int32, device=dev)
        order = torch.empty((b_, m), dtype=torch.int32, device=dev)
        scratch = torch.empty((b_, n + m), dtype=torch.int32, device=dev)
        out = torch.empty((b_, n, c), dtype=torch.float32, device=dev)
        st = kernels.stream_ptr(dev)

        def run_sort():
            kernels.check(sort(idx.data_ptr(), start.data_ptr(),
                               order.data_ptr(), scratch.data_ptr(), b_, m,
                               n, st), "scatter sort")

        def run_sum():
            kernels.check(summ(g.data_ptr(), start.data_ptr(),
                               order.data_ptr(), out.data_ptr(), b_, m, n, c,
                               st), "scatter sum")
        run_sort()
        run_sum()
        plain = pg.scatter_add_rows_plain(g, idx, n)
        need(torch.equal(out, plain), "scatter sort + sum vs plain", name)
        need(torch.equal(pg._launch_scatter_add_rows(g, idx, n), plain)
             and torch.equal(pg._launch_scatter_add_rows(g, idx, n), plain),
             "scatter_add_rows: two runs vs plain", name)
        ops, byt = scatter_work((g, idx, n))
        bms, by = bound(byt, ops)
        row = dict(
            shape=dict(B=b_, M=m, C=c, n=n),
            ms=cuda_ms(lambda: pg._launch_scatter_add_rows(g, idx, n),
                       reps=10),
            sort_ms=cuda_ms(run_sort, reps=10),
            sum_ms=cuda_ms(run_sum, reps=10),
            library_ms=index_add_ms([(g, idx, n)], torch)[0],
            bound_ms=bms, bound_by=by)
        table[name] = row
        print(f"   kernel 14 {name} (B {b_}, M {m}, C {c}, n {n}): "
              f"{row['ms']:.3f} ms = sort {row['sort_ms']:.3f} + sum "
              f"{row['sum_ms']:.3f} ms; index_add_ {row['library_ms']:.3f} "
              f"ms; bound {bms:.4f} ms ({by})")
    return table


def check_banded(b, calls, torch):
    """K6, K7, K8 vs plain on every recorded launch of P5. K6: d2 and idx
    equal. K7, K8: each tile's f64 moments within 1e-12 of the plain
    version's, and the moments rounded to [4,4], max |diff| <= 1e-6 of
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
                rel = float((k - p).abs().max() / p.abs().max())
                need(rel <= 1e-12, name, "per tile", rel)
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
                o, n_ = banded_nn_work(a)
                ops, byt = ops + o, byt + n_
            else:
                block, wb, tq = a[-4], a[-3], a[-2]
                mp_ = (a[0].shape[0] if name == "icp_moments_banded"
                       else a[3].shape[1])
                byt += nbytes(*a[:-4]) + mp_ // tq * 128
                ops += 8.0 * mp_ * wb * block   # 4 mul, 2 add, sub, cmp
        bms, by = bound(byt, ops)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=None)
    # K6, K7 and K8 per launch (units, lanes and ring of one design):
    # device time (a CUDA graph of the 30 launches), their units and lanes,
    # beside the bound of one launch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, label, launch, plan_of, mp_of in (
            ("nearest_banded", "K6", b._launch_nearest_banded,
             b.nearest_banded_plan, lambda a: a[0].shape[0]),
            ("icp_moments_banded", "K7", b._launch_icp_moments_banded,
             b.moments_v2_plan, lambda a: a[0].shape[0]),
            ("icp_moments_banded_v2", "K8", b._launch_icp_moments_banded_v2,
             b.moments_v2_plan, lambda a: a[3].shape[1])):
        cl = calls[name]
        plan = plan_of(mp_of(cl[0]), cl[0][-2 if label != "K6" else -1],
                       sms)
        row = out[name]
        row.update(per_launch_ms=graph_ms([
            lambda a=a, f=launch: f(*a) for a in cl]) / len(cl), plan=plan)
        print(f"{label} per P5 launch: {row['per_launch_ms'] * 1e3:.2f} us "
              f"device time ({plan['units']} units = {plan['tiles']} tiles "
              f"x {plan['slices']} slices of {plan['slice']} queries, "
              f"{plan['lanes']} lanes a query, {plan['qpt']} queries a "
              f"thread); bound {row['bound_ms'] / len(cl) * 1e3:.2f} us; "
              f"{len(cl)} launches {row['ms']:.3f} ms (CUDA events)")
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


def fps_table(pf, kernels, cases, torch):
    """Kernels 10/11 per recorded launch shape: `fps_plan`'s launch, us
    per step (device time: a CUDA graph of 10 launches, / (m - 1)), the
    empty step at the same CTA width (`pct_fps_floor`: one barrier and
    the winner reduction, no distance work) and the bound per step."""
    floor = kernels.entry("fps.cu", "pct_fps_floor", n_ptr=1, n_int=4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    table = {}
    for name, args in cases.items():
        pts, m, elig = args
        b, n, _ = pts.shape
        plan = pf.fps_plan(b, n, m, sms)
        steps = m - 1
        out = torch.empty((b, m), dtype=torch.int32, device=pts.device)
        us = graph_ms([lambda: pf._launch_fps(*args)] * 10) * 1e2 / steps
        floor_us = graph_ms([lambda: kernels.check(floor(
            out.data_ptr(), b, n, m, plan["threads"],
            kernels.stream_ptr(pts.device)), "fps floor")] * 10
            ) * 1e2 / steps
        ops, byt = fps_work(args)
        bus = bound(byt, ops)[0] * 1e3 / steps
        table[name] = dict(shape=[b, n, m], plan=plan, us_per_step=us,
                           floor_us_per_step=floor_us,
                           bound_us_per_step=bus)
        print(f"   FPS {name} (B {b}, N {n}, m {m}): {plan['threads']} "
              f"threads x {plan['per']} ({plan['mode']}), {b} CTAs: "
              f"{us:.3f} us per step, empty step {floor_us:.3f}, bound "
              f"{bus:.4f}; {us * steps / 1e3:.4f} ms a launch")
    return table


def check_ball_group(bg, bq, gather, calls, torch):
    """Kernel 12 (`_launch_ball_group`) vs `ball_group_plain` on recorded
    launches: idx equal, grouped rows bit-equal. Also vs the unfused
    composition group_points(packed, ball_query(...)) - centre: equal at
    every centre, except where the two distance formulas (ball_query's is
    a matmul, the kernel's an elementwise expansion) round a point within
    1e-6 of r^2 to opposite sides; such centres are counted. Both
    expansions cancel |p|^2 + |c|^2 down to d^2, so the 1e-6 holds for
    points within the unit sphere (the classifiers' clouds) and grows
    with (|p|^2 + |c|^2) / 2 past it (the segmenters' rooms, 3 m high).
    Returns (max
    err, boundary centres, per-launch (ops, bytes, candidates)): ~10 flops
    per candidate the scan must test (up to the nsample-th hit, or all N),
    the inputs read once, grouped rows and idx written once."""
    err, boundary, work = 0.0, 0, []
    for args in calls:
        centers, packed, radius, nsample, pmask, sub_xyz = args
        gk, ik = bg._launch_ball_group(*args)
        gp, ip = bg.ball_group_plain(*args)
        torch.cuda.synchronize()
        need(torch.equal(ik, ip), "ball_group idx", tuple(packed.shape))
        e = float((gk - gp).abs().max())
        need(torch.equal(gk, gp), "ball_group rows", e)
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
            p, c = packed[bi, :, :3].double(), centers[bi, mi, None].double()
            d2 = ((p - c) ** 2).sum(-1)
            r2 = float(torch.tensor(radius, dtype=torch.float32)) ** 2
            near = 1e-6 * torch.clamp_min(
                ((p * p).sum(-1) + (c * c).sum(-1)) / 2, 1.0)
            need(bool(((d2 - r2).abs() <= near).any(-1).all()),
                 "ball_group vs composition away from the boundary")
            boundary += int(bi.numel())
        full = ik[..., -1] != ik[..., 0]        # nsample hits were found
        scanned = float(torch.where(full, ik[..., -1].long() + 1,
                                    packed.shape[1]).sum())
        work.append((10.0 * scanned, nbytes(centers, packed, pmask, gk, ik),
                     scanned))
    return err, boundary, work


def ball_group_table(bg, launches, sms):
    """Kernel 12 per recorded launch ({name: (args, (ops, bytes,
    candidates))}): device time (a CUDA graph of 10 launches) beside the
    launch's own bound, the candidates its scan must test and
    `ball_group_plan`'s launch."""
    table = {}
    for name, (args, (ops, byt, scanned)) in launches.items():
        centers, packed, radius, nsample = args[:4]
        b, m, _ = centers.shape
        n, c = packed.shape[1], packed.shape[2]
        plan = bg.ball_group_plan(b, m, n, c, nsample, sms)
        ms = graph_ms([lambda a=args: bg._launch_ball_group(*a)] * 10) / 10
        bms, by = bound(byt, ops)
        table[name] = dict(shape=[b, m, n, c, nsample, radius], ms=ms,
                           bound_ms=bms, bound_by=by,
                           candidates_per_centre=scanned / (b * m),
                           out_bytes=b * m * nsample * c * 4, plan=plan)
        print(f"   kernel 12 {name} (B {b}, M {m}, N {n}, C {c}, K "
              f"{nsample}, r {radius}): {ms * 1e3:.2f} us, bound "
              f"{bms * 1e3:.2f} us ({by}), {scanned / (b * m):.0f} "
              f"candidates a centre; {plan['ctas']} CTAs of "
              f"{plan['threads']} threads, {plan['centres']} centres a "
              f"CTA, {plan['mode']}, {plan['store_bytes']}-B stores")
    return table


def time_launches(launch, plain, calls, work):
    """Kernel, plain and bound time of recorded launches together; `work`
    holds each launch's (ops, bytes)."""
    ms = cuda_ms(lambda: [launch(*a) for a in calls], reps=5)
    plain_ms = cuda_ms(lambda: [plain(*a) for a in calls], reps=1, warmup=0)
    bms, by = bound(sum(w[1] for w in work), sum(w[0] for w in work))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                library_ms=None)


def grad_err(got, ref):
    """max over parameters of max |got - ref| / max(|ref|, 1e-3 |all of
    ref|): each gradient against its own norm, floored at 1e-3 of the
    whole gradient's norm, since a gradient that is zero in exact
    arithmetic (the bias of the BN ahead of group-all's max-pool: BN's
    batch mean removes any shift) is rounding noise on both sides."""
    ref = [r.detach().double().cpu() for r in ref]
    total = float(sum((r ** 2).sum() for r in ref)) ** 0.5
    worst = 0.0
    for g, r in zip(got, ref):
        scale = max(float(r.norm()), 1e-3 * total)
        worst = max(worst, float((g.detach().double().cpu() - r).abs().max())
                    / scale)
    return worst


def gather_work(args):
    """(ops, bytes) of one kernel-13 launch: no arithmetic; the table read
    once, the indices read, the gathered rows written."""
    table, idx = args
    b, m = idx.shape
    return 0.0, nbytes(table, idx) + b * m * table.shape[2] * 4


def scatter_work(args):
    """(ops, bytes) of one kernel-14 launch: one add per gradient float;
    the gradient rows and indices read once, the [B, n, C] sums written."""
    g, idx, n = args
    b, m, c = g.shape
    return float(b * m * c), nbytes(g, idx) + b * n * c * 4


@contextlib.contextmanager
def timed_calls(module, name, bucket, torch):
    """Bind `name` in `module` to a wrapper that adds each call's seconds
    (synchronised on both sides) to bucket[name]."""
    fn = getattr(module, name)

    def wrapper(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        bucket[name] = bucket.get(name, 0.0) + time.perf_counter() - t0
        return out
    with swapped(module, name, wrapper):
        yield


def odometry_launches(out, cfg, n_frames):
    """The launches one `run_odometry` call must make, from its result:
    K1 once per front-end iteration, and per closure round with
    candidates once per ICP iteration (all candidates in lockstep) and
    once for the fitness; round 0's global inits add `register_pairs`
    (K1 for its stats, K2 and K3 per cloud batch, RANSAC's select and
    refine, K4 for the voxel ICP and the exact refine); kernel V once a
    frame, for its voxel centroids."""
    cands = out["closure_candidates"]
    nn = (n_frames - 1) * cfg.icp_iters + sum(
        cfg.icp_iters + 1 for c in cands if c)
    want = {"nn1": nn, "voxel_run_means": n_frames}
    if cands[0] and cfg.closure_init == "global":
        want["nn1"] += 1
        want.update(spfh=2, wsum=2, icp_mega_batch=2, ransac_refine=1)
    return want


def ulp_check(k, p, torch):
    """(max |k - p|, entries that differ, whether every entry of k is
    within one float32 ulp of p)."""
    inf = torch.tensor(float("inf"), device=p.device)
    within = bool(((k >= torch.nextafter(p, -inf))
                   & (k <= torch.nextafter(p, inf))).all())
    return float((k - p).abs().max()), int((k != p).sum()), within


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
# P20-P22: segmentation, the mini-world task loop, the clustering harness
# ---------------------------------------------------------------------------

def events_ms(fn, torch):
    """(milliseconds of one call of fn between CUDA events, its result)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def cpu_gumbel_sampler(seed, torch, gumbel_sampler):
    """The plane's triples as the Gumbel top-3 of noise drawn on the CPU
    from `seed` at every call, whatever device the vote mask is on: one
    sampler for the card and the CPU."""
    def sample(vote_mask, h):
        draw = gumbel_sampler(torch.Generator().manual_seed(seed))
        return draw(vote_mask.cpu(), h).to(vote_mask.device)
    return sample


def cluster_datasets(rng, n=CLUSTER_N):
    """Numpy versions of the reference's six datasets
    (`pctpu/pipelines/cluster_compare.py:19-41`: noisy circles and moons,
    blobs of varied spread, anisotropic blobs, blobs, uniform noise), each
    standardised: [(name, X [n,2] f32, clusters)]."""
    def blobs(std, centres=3):
        c = rng.uniform(-10, 10, (centres, 2))
        lab = rng.integers(0, centres, n)
        return c[lab] + rng.normal(size=(n, 2)) * np.asarray(std)[lab, None]

    t = np.linspace(0, 2 * np.pi, n // 2, endpoint=False)
    circles = np.concatenate([np.stack([np.cos(t), np.sin(t)], 1),
                              0.5 * np.stack([np.cos(t), np.sin(t)], 1)])
    u = np.linspace(0, np.pi, n // 2)
    moons = np.concatenate([np.stack([np.cos(u), np.sin(u)], 1),
                            np.stack([1 - np.cos(u), 0.5 - np.sin(u)], 1)])
    sets = [
        ("noisy_circles", circles + rng.normal(scale=0.05, size=(n, 2)), 2),
        ("noisy_moons", moons + rng.normal(scale=0.05, size=(n, 2)), 2),
        ("varied", blobs([1.0, 2.5, 0.5]), 3),
        ("aniso", blobs([1.0] * 3) @ np.array([[0.6, -0.6], [-0.4, 0.8]]),
         3),
        ("blobs", blobs([1.0] * 3), 3),
        ("no_structure", rng.random((n, 2)), 3),
    ]
    return [(name, ((x - x.mean(0)) / x.std(0)).astype(np.float32), k)
            for name, x, k in sets]


def same_partition(a, b):
    """Labels a and b split the points alike (a bijection of ids)."""
    a, b = np.asarray(a).tolist(), np.asarray(b).tolist()
    return len(set(zip(a, b))) == len(set(a)) == len(set(b))


# ---------------------------------------------------------------------------
# P23-P25: registration's two options, PointRCNN, keypoints and descriptors
# ---------------------------------------------------------------------------

def registration_options(paths, mods, src, dst, gts, pm, torch):
    """P23: `register_pairs` with keypoints="iss" (K1-K4) and with
    feature_backend="dense" (K1, K4), and `register_pair` with
    keypoints="iss" (kernel 5, K1), on P1's pairs; every launch of each
    counted run held against its plain version. `pm`: the port's
    modules by name. Returns the metrics."""
    pipeline, voxel, se3 = pm["pipeline"], pm["voxel"], pm["se3"]
    cfg_iss = pipeline.RegistrationConfig(keypoints="iss")
    cfg_dense = pipeline.RegistrationConfig(feature_backend="dense")
    dev = src.points.device

    def pairs_run(cfg, seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pipeline.register_pairs(src, dst, cfg=cfg, generator=gen)

    out, checks = {}, {}
    for key, cfg, expect in (
            ("iss", cfg_iss, {"nn1": 1, "spfh": 2, "wsum": 2,
                              "icp_mega_batch": 2, "ransac_refine": 1}),
            ("dense", cfg_dense, {"nn1": 1, "icp_mega_batch": 2,
                                  "ransac_refine": 1})):
        pairs_run(cfg)                                          # warm-up
        with recording_k1_k4(mods["pallas_nn"], mods["pallas_fpfh"],
                             mods["pallas_icp_mega"]) as rec:
            res = paths.run(f"register_pairs_{key}", lambda: pairs_run(cfg),
                            expect)
        rte, rre = gate(f"P23 register_pairs {key}", res.T, gts, se3, torch)
        checks[key] = check_path_kernels(mods, rec, torch)
        ms = cuda_ms(lambda: pairs_run(cfg, 1), reps=3, warmup=0)
        out[f"register_pairs_{key}"] = dict(
            worst_rte=rte, worst_rre=rre, batch_ms=ms,
            pairs_per_s=src.points.shape[0] / (ms / 1e3),
            matches=[int(res.num_matches.min()),
                     int(res.num_matches.max())])

    # the ISS sites of the 2B voxel clouds, one cloud at a time on the host
    downs = [voxel.voxel_downsample_capped(
        pc.points, pc.mask, cfg_iss.voxel_size,
        cfg_iss.downsample_capacity)[0] for pc in (src, dst)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sites = torch.cat([pipeline.keypoint_sites(d, cfg_iss) for d in downs])
    torch.cuda.synchronize()
    iss_ms = (time.perf_counter() - t0) * 1e3
    out["register_pairs_iss"].update(
        iss_loop_ms=iss_ms, keypoints=sites.sum(1).tolist(),
        voxels=torch.cat([d.mask for d in downs]).sum(1).tolist())

    # dense features against fpfh_fused's on two pairs (their 4 voxel
    # clouds), the same normals
    pts = torch.cat([downs[0].points[:2], downs[1].points[:2]])
    msk = torch.cat([downs[0].mask[:2], downs[1].mask[:2]])
    nrm = pm["fpfh_dense"].normals_radius_dense(
        pts, msk, radius=cfg_dense.normal_radius)
    dense = pm["fpfh_dense"].fpfh_dense(pts, mask=msk, normals=nrm,
                                        radius=cfg_dense.feature_radius)
    fused = pm["pallas_fpfh"].fpfh_fused(
        pts, mask=msk, normals=nrm, radius=cfg_dense.feature_radius,
        x_banded=True, x_slack=cfg_dense.voxel_size)
    diff = (dense - fused)[msk].abs()
    out["register_pairs_dense"]["vs_fused"] = dict(
        mean=float(diff.mean()), above_half=float((diff > 0.5).float().mean()),
        max=_flip_ok(dense[msk], fused[msk], "P23 dense vs fused"))

    one = (pm["PointCloud"](src.points[0], src.mask[0]),
           pm["PointCloud"](dst.points[0], dst.mask[0]))

    def pair_run():
        gen = torch.Generator(device=dev).manual_seed(0)
        return pipeline.register_pair(*one, cfg=cfg_iss, generator=gen)
    pair_run()
    with recording_k1_k4(mods["pallas_nn"], mods["pallas_fpfh"],
                         mods["pallas_icp_mega"]) as rec:
        res = paths.run("register_pair_iss", pair_run,
                        {"icp_mega": 2, "nn1": 1, "ransac_refine": 1,
                         "voxel_run_means": 2})
    rte, rre = gate("P23 register_pair iss", res.T, gts[0], se3, torch)
    checks["pair"] = check_path_kernels(mods, rec, torch)
    out["register_pair_iss"] = dict(
        rte=rte, rre=rre, call_ms=cuda_ms(pair_run, reps=3, warmup=0),
        matches=int(res.num_matches))
    out["kernels_vs_plain"] = checks
    r = out["register_pairs_iss"]
    print(f"P23 register_pairs keypoints=iss ({len(r['keypoints'])} clouds): "
          f"max RTE {r['worst_rte']:.4f} m, RRE {r['worst_rre']:.4f} deg; "
          f"{r['batch_ms']:.2f} ms a batch ({r['pairs_per_s']:.1f} pairs/s);"
          f" matches {r['matches'][0]}..{r['matches'][1]}; ISS keypoints a "
          f"cloud {min(r['keypoints'])}..{max(r['keypoints'])} of "
          f"{min(r['voxels'])}..{max(r['voxels'])} voxels; the ISS loop "
          f"over the {len(r['keypoints'])} clouds {iss_ms:.1f} ms (host "
          "clock)")
    r = out["register_pairs_dense"]
    print(f"    feature_backend=dense: max RTE {r['worst_rte']:.4f} m, RRE "
          f"{r['worst_rre']:.4f} deg; {r['batch_ms']:.2f} ms a batch "
          f"({r['pairs_per_s']:.1f} pairs/s); vs fpfh_fused on 2 pairs: "
          f"mean |diff| {r['vs_fused']['mean']:.2e}, "
          f"{r['vs_fused']['above_half']:.2e} above 0.5, max "
          f"{r['vs_fused']['max']:.2f}")
    r = out["register_pair_iss"]
    print(f"    register_pair keypoints=iss: RTE {r['rte']:.4f} m, RRE "
          f"{r['rre']:.4f} deg, {r['call_ms']:.1f} ms, {r['matches']} "
          "matches")
    for key, name in (("iss", "P23 iss"), ("dense", "P23 dense"),
                      ("pair", "P23 pair")):
        print(kernels_line(name, checks[key]))
    return out


def detector_scenes(rng, batch, n, cars=6):
    """[batch,n,4] synthetic KITTI-style scenes (x, y, z, intensity) and
    their car boxes [batch,cars,7]: ground over 70 x 80 m (60% of the
    points), car-sized boxes (PointRCNN's anchor, jittered) on it, their
    points on the box surfaces and inside."""
    scenes, boxes = [], []
    for _ in range(batch):
        g = int(0.6 * n)
        ground = np.stack([rng.uniform(0, 70, g), rng.uniform(-40, 40, g),
                           rng.normal(scale=0.05, size=g)], 1)
        per = np.diff(np.linspace(0, n - g, cars + 1).astype(int))
        objs, bx = [ground], []
        for k in range(cars):
            ext = np.array([3.9, 1.6, 1.56]) * rng.uniform(0.9, 1.1, 3)
            c = np.array([rng.uniform(5, 65), rng.uniform(-35, 35),
                          ext[2] / 2])
            yaw = rng.uniform(-np.pi, np.pi)
            local = rng.uniform(-0.5, 0.5, (per[k], 3)) * ext
            cs_, sn = np.cos(yaw), np.sin(yaw)
            objs.append(local @ np.array([[cs_, sn, 0], [-sn, cs_, 0],
                                          [0, 0, 1]]) + c)
            bx.append(np.concatenate([c, ext, [yaw]]))
        xyz = np.concatenate(objs)
        inten = rng.uniform(size=(n, 1))
        scenes.append(np.concatenate([xyz, inten], 1))
        boxes.append(np.stack(bx))
    return (np.stack(scenes).astype(np.float32),
            np.stack(boxes).astype(np.float32))


def pointrcnn_phase(paths, dev, seed, pm, torch):
    """P24: the reference test's recipe as the gate (B 4 x 512, npoints
    (128, 32), Adam 3e-3 for 120 steps: a valid first proposal with 3D IoU
    >= 0.25, RefineNet residuals finite of shape (8, 8)); then ProposalNet
    at its defaults on B 16 x 16,384 x 4 synthetic scenes: serving and
    training timed, proposals and refinement per scene, the card against
    the CPU. No kernel runs. Returns the metrics."""
    import copy
    R, box3d = pm["pointrcnn"], pm["box3d"]
    sort = pm["pointnet2"].morton_sort_packed
    out = {}

    # -- the reference test's recipe (tests/test_models.py:315-386)
    B, N = 4, 512
    gt = np.array([1.5, -0.8, 0.8, 3.9, 1.6, 1.6, 0.4], np.float32)

    def scene(r):
        ground = np.stack([r.uniform(-8, 8, 350), r.uniform(-8, 8, 350),
                           r.normal(scale=0.05, size=350)], 1)
        c, s = np.cos(gt[6]), np.sin(gt[6])
        local = r.uniform(-0.5, 0.5, (N - 350, 3)) * gt[3:6]
        obj = local @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]],
                               np.float32) + gt[:3]
        return np.concatenate([ground, obj]).astype(np.float32)
    pc = sort(torch.from_numpy(np.stack([scene(np.random.default_rng(i))
                                         for i in range(B)])).to(dev))
    gt_t = torch.from_numpy(gt)[None].to(dev)
    # the recipe's initialisation is pinned, as the reference test pins
    # its PRNG key (PRNGKey(0)), apart from --seed: whether 120 steps
    # reach the box depends on it
    model = R.ProposalNet(npoints=(128, 32), in_channels=3,
                          generator=torch.Generator().manual_seed(0)
                          ).to(dev).train()
    fg, regt = map(torch.stack, zip(*[R.proposal_targets(pc[b], gt_t)
                                      for b in range(B)]))
    need(50 < int(fg.sum()) < B * N, "P24 targets", int(fg.sum()))
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)

    def recipe():
        for _ in range(120):
            opt.zero_grad()
            s, r = model(pc, 0.1)
            loss, _ = R.rpn_loss(s, r, fg, regt)
            loss.backward()
            opt.step()
        return loss
    t0 = time.perf_counter()
    loss = paths.run("pointrcnn_recipe", recipe, {}).item()
    recipe_s = time.perf_counter() - t0
    model.eval()
    with torch.no_grad():
        s, r = model(pc)
        boxes = R.decode_proposals(pc[..., :3], r)
        prop, ps, valid = R.extract_proposals(boxes[0], s[0], post_nms=8)
        iou = float(box3d.iou3d(prop[:1], gt_t).max())
        refine = R.RefineNet(in_features=4, cap=32,
                             generator=torch.Generator().manual_seed(1)
                             ).to(dev).eval()
        res, conf = refine(pc[0], torch.ones((N, 4), device=dev), prop)
    need(bool(valid[0]) and iou >= 0.25, "P24 recipe proposal", iou, loss)
    need(res.shape == (8, 8) and conf.shape == (8,)
         and bool(torch.isfinite(res).all()), "P24 RefineNet")
    out["recipe"] = dict(loss=loss, best_iou=iou, seconds=recipe_s,
                         valid=int(valid.sum()))

    # -- full width: ProposalNet's defaults on KITTI-sized scenes
    FB, FN = 16, 16384
    pcs, gtb = detector_scenes(np.random.default_rng([seed, 24]), FB, FN)
    pc = sort(torch.from_numpy(pcs).to(dev))
    gtb = torch.from_numpy(gtb).to(dev)
    model = R.ProposalNet(generator=torch.Generator().manual_seed(seed)
                          ).to(dev)
    model_cpu = copy.deepcopy(model).cpu().eval()
    model.eval()

    def serve():
        with torch.no_grad():
            return model(pc)
    serve()
    torch.cuda.reset_peak_memory_stats()
    s, r = paths.run("pointrcnn_serve", serve, {})
    serve_ms = cuda_ms(serve, reps=5, warmup=0)
    serve_mem = torch.cuda.max_memory_allocated() / 2**30
    need(s.shape == (FB, FN) and r.shape == (FB, FN, 8)
         and bool(torch.isfinite(s).all()) and bool(torch.isfinite(r).all()),
         "P24 serving output")
    with torch.no_grad():
        cs, cr = model_cpu(pc[:2].cpu())
    err_s = float((s[:2].cpu() - cs).abs().max())
    err_r = float((r[:2].cpu() - cr).abs().max())
    need(torch.allclose(s[:2].cpu(), cs, rtol=1e-4, atol=1e-4)
         and torch.allclose(r[:2].cpu(), cr, rtol=1e-4, atol=1e-4),
         "P24 card vs CPU", err_s, err_r)

    fg, regt = map(torch.stack, zip(*[R.proposal_targets(pc[b, :, :3],
                                                          gtb[b])
                                      for b in range(FB)]))
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=3e-3)
    losses = []

    def step():
        opt.zero_grad()
        sc, rg = model(pc, 0.1)
        loss, _ = R.rpn_loss(sc, rg, fg, regt)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    step()
    torch.cuda.reset_peak_memory_stats()
    paths.run("pointrcnn_train", step, {})
    train_ms = cuda_ms(step, reps=TRAIN_STEPS, warmup=0)
    train_mem = torch.cuda.max_memory_allocated() / 2**30
    need(all(bool(torch.isfinite(v)) for v in losses), "P24 train loss")

    model.eval()
    with torch.no_grad():
        s, r = model(pc)
        boxes = R.decode_proposals(pc[..., :3], r)
    refine = R.RefineNet(in_features=1, cap=64,
                         generator=torch.Generator().manual_seed(seed + 1)
                         ).to(dev).eval()

    def stage2():
        props = []
        with torch.no_grad():
            for b in range(FB):
                prop, _, valid = R.extract_proposals(boxes[b], s[b])
                res, conf = refine(pc[b, :, :3], pc[b, :, 3:], prop)
                props.append((prop, valid, res, conf))
        return props
    stage2()
    stage2_ms, props = events_ms(
        lambda: paths.run("pointrcnn_stage2", stage2, {}), torch)
    need(all(bool(torch.isfinite(p[2]).all()) for p in props),
         "P24 RefineNet residuals")
    # the rotated NMS of scene 0's top-256 candidates: card = CPU
    top = torch.sort(s[0], descending=True, stable=True).indices[:256]
    k_idx, k_val = box3d.nms_rotated(boxes[0][top], s[0][top], 0.7, 32)
    c_idx, c_val = box3d.nms_rotated(boxes[0][top].cpu(), s[0][top].cpu(),
                                     0.7, 32)
    need(torch.equal(k_idx.cpu(), c_idx) and torch.equal(k_val.cpu(), c_val),
         "P24 nms_rotated card vs CPU")
    nms_ms = cuda_ms(lambda: box3d.nms_rotated(boxes[0][top], s[0][top],
                                               0.7, 32), reps=3)
    out["full"] = dict(
        batch=FB, points=FN, npoints=list(model.npoints),
        serve_ms=serve_ms, scenes_per_s=FB / (serve_ms / 1e3),
        serve_peak_gib=serve_mem, train_ms=train_ms,
        train_scenes_per_s=FB / (train_ms / 1e3), train_peak_gib=train_mem,
        losses=[float(v) for v in losses], stage2_ms=stage2_ms,
        nms_ms=nms_ms, proposals=sum(int(p[1].sum()) for p in props),
        card_vs_cpu=dict(score=err_s, reg=err_r))
    f = out["full"]
    print(f"P24 PointRCNN: the reference test's recipe (B {B} x {N}, 120 "
          f"Adam steps, {recipe_s:.1f} s): loss {loss:.4f}, first "
          f"proposal 3D IoU {iou:.3f} (gate 0.25), RefineNet (8, 8) finite")
    print(f"    ProposalNet npoints {f['npoints']} at B {FB} x {FN} x 4: "
          f"serving {serve_ms:.2f} ms a batch ({f['scenes_per_s']:.1f} "
          f"scenes/s, peak {serve_mem:.2f} GiB), training {train_ms:.2f} ms "
          f"a step (peak {train_mem:.2f} GiB); proposals + RefineNet of the "
          f"{FB} scenes {stage2_ms:.1f} ms ({f['proposals']} proposals), "
          f"one nms_rotated of 256 {nms_ms:.2f} ms; card vs CPU on 2 "
          f"scenes: logits {err_s:.1e}, residuals {err_r:.1e}; NMS equal")
    return out


def keypoints_phase(paths, cloud, voxel_cloud, pm, torch):
    """P25: ISS (PCL defaults, on the cloud and on its voxel cloud),
    Harris3D (both measures), Harris6D (a synthetic intensity), SIFT3D
    (field y), SHOT-352 at the ISS keypoints and PCA. Each is timed on the
    card on the whole cloud, and held against the CPU on every other
    point of it (8,192 of 16,384: the CPU's stable sorts over
    [1,024, N] row blocks cost N^2) and on the whole voxel cloud, by
    `pctpu_torch.features.margins`, which bounds each result from the
    CPU's values and the geometry alone:
    - ISS: every valid point's eigenvalues within their `iss_bounds`;
      masks equal where `iss_decided`.
    - Harris3D and Harris6D, at the reference's threshold for a LiDAR
      scan (tests/test_features.py:353: 1e-4 on the noble measure, and
      1e-4 - k for the harris measure, det - k tr^2, whose trace is 1 on
      unit normals): responses within 1e-6 where their neighbourhoods are
      sure (Harris6D: and no gradient solve within the radius has a
      tangent conditioning of 1e3 or more); masks equal where
      `threshold_decided` with a 1e-5 margin. Harris6D is held on both
      halves of the cloud: its keypoints gather by the scan's ill-
      conditioned solves, where they are not settled.
    - ISS and Harris: the decided share of the valid points above 0.5,
      and at least 5 decided keypoints; Harris: the sure share above 0.5.
    - SIFT3D masks equal but for at most 0.1% of the points (its strict
      extremum over 25 neighbours at 9 levels can meet a rounding tie).
    - SHOT (radius 1 and 3, the same normals): within `shot_bounds` (1e-5
      plus the bin-edge moves) at the settled keypoints, which are more
      than half of those with 5 neighbours or more, and at least 5.
    - PCA eigenvalues within 1e-5 relative, eigenvectors within 1e-5 up
      to sign.
    Returns the metrics."""
    F, normals, M = pm["features"], pm["normals"], pm["margins"]
    (vp, vm) = voxel_cloud
    cpu = torch.device("cpu")
    inten = torch.from_numpy(np.random.default_rng(25).uniform(
        size=cloud.shape[0]).astype(np.float32)).to(cloud.device)
    # (points, kNN normals, normals facing the centroid, intensity) of the
    # whole cloud and of the half held against the CPU
    clouds = {}
    for part, sel in (("whole", slice(None)), ("half", slice(None, None, 2)),
                      ("other", slice(1, None, 2))):
        q = cloud[sel]
        clouds[part] = (q, normals.estimate_normals(q, k=16),
                        normals.estimate_normals(q, k=16,
                                                 viewpoint=q.mean(0)),
                        inten[sel])
    out = {}

    def both(name, fn, whole, half):
        """fn(*whole) on the card, timed by CUDA events after a warm-up;
        fn(*half) on the card and on the CPU (host clock)."""
        fn(*whole)
        ms, _ = events_ms(lambda: paths.run(f"p25_{name}",
                                            lambda: fn(*whole), {}), torch)
        card = fn(*half)
        t0 = time.perf_counter()
        host = fn(*[a.to(cpu) if hasattr(a, "to") else a for a in half])
        out[name] = dict(card_ms=ms, cpu_ms=(time.perf_counter() - t0) * 1e3)
        return card, host

    def masks(name, card, host, decided, valid):
        """Masks equal where decided; the floors."""
        dec = decided.cpu()
        same = card.keypoint_mask.cpu()[dec] == host.keypoint_mask[dec]
        share = float(dec[valid.cpu()].float().mean())
        kept = int(host.keypoint_mask[dec].sum())
        need(bool(same.all()), f"P25 {name} masks where decided",
             int((~same).sum()))
        need(share > 0.5 and kept >= 5, f"P25 {name} decided share, "
             "decided keypoints", share, kept)
        out[name].update(keypoints=int(host.keypoint_mask.sum()),
                         keypoints_card=int(card.keypoint_mask.sum()),
                         masks_differ=int((card.keypoint_mask.cpu()
                                           != host.keypoint_mask).sum()),
                         decided=share, keypoints_decided=kept)

    p, nrm, nrm_c, its = clouds["half"]
    w_p, w_nrm, w_nrm_c, w_its = clouds["whole"]
    ones = torch.ones(p.shape[0], dtype=torch.bool, device=p.device)
    iss_host = None
    for name, whole, half in (("iss_voxel", (vp, vm), (vp, vm)),
                              ("iss", (w_p, None), (p, None))):
        card, host = both(name, F.iss_keypoints, whole, half)
        pts, msk = half
        valid = ones if msk is None else msk
        ev = host.eigvals.to(pts.device)
        decided, bound = M.iss_decided(pts, ev, msk)
        ratio = ((card.eigvals - ev).abs().amax(1) / bound)[valid]
        need(bool((ratio <= 1).all()), f"P25 {name} eigenvalues within "
             "their bounds", float(ratio.max()))
        out[name]["eigvals_err_over_bound"] = float(ratio.max())
        masks(name, card, host, decided, valid)
        iss_host = host
    nb_unsure = M.neighbourhoods(p, 0.5, 64)[1]
    o_p, o_nrm, _, o_its = clouds["other"]
    for name, thr in (("harris3d_noble", 1e-4), ("harris3d_harris", -0.0399),
                      ("harris6d", 1e-4)):
        if name == "harris6d":
            def fn(q, n, i):
                return F.harris6d_keypoints(q, i, normals=n, threshold=1e-4)
            card, host = both(name, fn, (w_p, w_nrm, w_its), (p, nrm, its))
            # its keypoints gather by the scan's ill-conditioned gradient
            # solves (single-ring neighbourhoods), where they are not
            # settled: the other half of the cloud too
            runs = [(p, card, host, M.harris6d_unsure(p, nrm, 0.5)),
                    (o_p, fn(o_p, o_nrm, o_its),
                     fn(o_p.cpu(), o_nrm.cpu(), o_its.cpu()),
                     M.harris6d_unsure(o_p, o_nrm, 0.5))]
        else:
            def fn(q, n, measure=name.split("_")[1], thr=thr):
                return F.harris3d_keypoints(q, normals=n, measure=measure,
                                            threshold=thr)
            card, host = both(name, fn, (w_p, w_nrm), (p, nrm))
            runs = [(p, card, host, nb_unsure)]
        unsure = torch.cat([u for *_, u in runs]).cpu()
        err = torch.cat([(c.response.cpu() - h.response).abs()
                         for _, c, h, _ in runs])[~unsure]
        sure = float((~unsure).float().mean())
        need(bool((err <= 1e-6).all()) and sure > 0.5, f"P25 {name} "
             "responses within 1e-6 where sure, sure share",
             float(err.max()), sure)
        out[name].update(response_err_sure=float(err.max()), sure=sure,
                         points_compared=int(unsure.shape[0]))
        decided = torch.cat([M.threshold_decided(
            q, h.response.to(q.device), thr, 0.5, unsure=u).cpu()
            for q, _, h, u in runs])
        masks(name, *(types.SimpleNamespace(keypoint_mask=torch.cat(
            [r[i].keypoint_mask.cpu() for r in runs])) for i in (1, 2)),
            decided, torch.ones_like(decided))
    card, host = both("sift3d", F.sift3d_keypoints, (w_p,), (p,))
    differ = int((card.keypoint_mask.cpu() != host.keypoint_mask).sum())
    need(differ <= 1e-3 * p.shape[0], "P25 sift3d masks", differ)
    out["sift3d"].update(keypoints=int(host.keypoint_mask.sum()),
                         masks_differ=differ)
    kp = p[iss_host.keypoint_mask.to(p.device)]
    w_kp = w_p[F.iss_keypoints(w_p).keypoint_mask]
    for radius in (1.0, 3.0):
        name = f"shot352_r{radius:g}"

        def fn(q, k, n, radius=radius):
            return F.shot352(q, k, normals=n, radius=radius)
        card, host = both(name, fn, (w_p, w_kp, w_nrm_c), (p, kp, nrm_c))
        settled, bound = M.shot_bounds(p, kp, nrm_c, radius)
        err = (card - host.to(p.device)).abs().amax(dim=1)
        populated = pm["knn"].radius_search(kp, p, radius, 128).count >= 5
        share = float(settled[populated].float().mean())
        need(bool((err[settled] <= bound[settled]).all()), f"P25 {name} "
             "within its bound where settled",
             float((err / bound)[settled].max()))
        need(share > 0.5 and int(settled.sum()) >= 5, f"P25 {name} "
             "settled share of the keypoints with 5 neighbours or more, "
             "settled keypoints", share, int(settled.sum()))
        out[name].update(keypoints=int(kp.shape[0]),
                         populated=int(populated.sum()),
                         settled=int(settled.sum()), settled_share=share,
                         max_abs_err_settled=float(err[settled].max()),
                         max_abs_err=float(err.max()))
    (cv, cV), (hv, hV) = both("pca", normals.pca, (w_p,), (p,))
    sign = torch.sign((cV.cpu() * hV).sum(0))
    need(torch.allclose(cv.cpu(), hv, rtol=1e-5, atol=0)
         and bool(((cV.cpu() * sign - hV).abs() <= 1e-5).all()), "P25 pca")
    print(f"P25 keypoints and descriptors: ms on the card by CUDA events on "
          f"one {w_p.shape[0]}-point cloud (ISS also on its "
          f"{int(vm.sum())}-point voxel cloud) / on the CPU on every other "
          f"point ({p.shape[0]}), card against CPU there:")
    for name, r in out.items():
        extra = {k: v for k, v in r.items() if k not in ("card_ms", "cpu_ms")}
        print(f"    {name:16s} {r['card_ms']:8.2f} / {r['cpu_ms']:9.1f}  "
              + ", ".join(f"{k} {v:.3g}" if isinstance(v, float)
                          else f"{k} {v}" for k, v in extra.items()))
    return out


# ---------------------------------------------------------------------------
# P26, P27: the grid hash and grid ICP, host spatial code, CLI, utilities
# ---------------------------------------------------------------------------

GRID_CELL, GRID_CAP = 1.0, 64       # chosen in a CPU rehearsal (PERF.md §5)
GRID_CUT_CAP = 8                    # the same cell occupancy on the 16k cut
GRID_ICP = dict(iters=30, dist_thresh=5.0, cell_size=GRID_CELL)
F32_U = 2.0 ** -24                  # float32 unit roundoff


def grid_pair(full, rng, n=None):
    """`tests/test_register.py:189`'s offset (6 deg about a random axis,
    a 0.4 m-scaled normal translation) on the scan or an n-point cut of
    it, with 1 cm noise. Returns (src, dst, T)."""
    from scipy.spatial.transform import Rotation
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    t = rng.normal(size=3) * 0.4
    src = full if n is None else full[rng.choice(full.shape[0], n,
                                                 replace=False)]
    rotvec = np.radians(6.0) * axis
    dst, T = perturb(src, rng, rotvec, t)
    return src, dst, T


def grid_phase(paths, mods, full, seed, gm, dev, torch,
               k5_ms_per_iter=None):
    """P26: `build_grid` and `grid_nearest` / `grid_knn` / `grid_radius`
    on the scan, and `icp_fixed_iters_grid` (no kernel: the reference's
    grid search reaches no Pallas kernel).
    - On a 16,384-point cut (8 a cell: the full scan's occupancy at 64),
      every output equal to the CPU's (idx, d2, valid, count, found).
      With a cap above the cut's densest cell, every query whose K1
      neighbour lies within the cell size found, its d2 within 4 float32
      units of K1's `nearest` (the grid's d2 rounds as a chain of fused
      multiply-adds, as the reference's XLA CPU program does; K1 rounds
      each product and sum); K1's launch there equal to its plain
      version.
    - Points on the faces of 0.1 cells: the card's keys equal the CPU's.
    - The grid ICP on the whole scan offset by 6 deg and 0.4 m, 30
      iterations, cell 1 m, 64 a cell: RTE < 0.05 m (`bench.py:288`) and
      RRE < 0.5 deg; ms per iteration by CUDA events; the loop again step
      by step, its pose within 1e-6, printing the candidates the cap
      drops each iteration (`_gather_candidates`' third output). On a
      16,384-point pair (8 a cell: the full scan's occupancy) the card's
      pose within 1e-4 of the CPU's.
    Returns the metrics."""
    from pctpu_torch.device import f32_square
    G, icp, se3, knn = gm["grid_hash"], gm["icp"], gm["se3"], gm["knn"]
    faces_cloud = gm["faces_cloud"]
    cpu = torch.device("cpu")
    out = {}
    rng = np.random.default_rng([seed, 26])

    # the grid functions on a 16,384-point cut, card against CPU
    cut = full[rng.choice(full.shape[0], N_POINTS, replace=False)]
    qs = (cut + rng.normal(scale=0.2, size=cut.shape)).astype(np.float32)
    qs[-1] = [500.0, 500.0, 500.0]                     # no point near
    kw = dict(cap_per_cell=GRID_CUT_CAP, query_chunk=2048)
    res = []
    for d in (dev, cpu):
        g = G.build_grid(torch.from_numpy(cut).to(d), cell_size=GRID_CELL)
        q = torch.from_numpy(qs).to(d)
        res.append((g, G.grid_nearest(g, q, **kw), G.grid_knn(g, q, 8, **kw),
                    G.grid_radius(g, q, GRID_CELL, 64, **kw)))
    for a, b in zip(*res):
        for x, y in zip(a, b):
            need(torch.equal(x.cpu(), y), "P26 grid card vs CPU")
    found = res[0][1][2]
    need(not bool(found[-1]) and float(found.float().mean()) > 0.9,
         "P26 found", float(found.float().mean()))
    # against K1, the cap above the densest cell: nothing is dropped
    cells = np.floor((cut - cut.min(0)) / np.float32(GRID_CELL))
    densest = int(np.unique(cells, axis=0, return_counts=True)[1].max())
    g = res[0][0]
    q = torch.from_numpy(qs).to(dev)
    dropped = int(G._gather_candidates(g, q, densest)[2].sum())
    need(dropped == 0, "P26 overflow at the densest cap", dropped)
    gd2, gidx, gfound = G.grid_nearest(g, q, cap_per_cell=densest,
                                       query_chunk=512)
    with recording_k1_k4(mods["pallas_nn"], mods["pallas_fpfh"],
                         mods["pallas_icp_mega"]) as rec:
        kd2, kidx = paths.run("grid_vs_k1", lambda: knn.nearest(
            q, torch.from_numpy(cut).to(dev)), {"nn1": 1})
    out["kernels_vs_plain"] = check_path_kernels(mods, rec, torch)
    # K1's neighbour within the cell size lies in the query's stencil
    within = kd2 < f32_square(GRID_CELL)
    need(bool(gfound[within].all()), "P26 found within the cell")
    gap = (gd2 - kd2).abs()[within]
    rel = float((gap / kd2[within].clamp_min(1e-30)).max())
    need(bool((gap <= 4 * F32_U * kd2[within]).all()), "P26 d2 vs K1", rel)
    out["grid_vs_k1"] = dict(
        found=int(gfound.sum()), within_cell=int(within.sum()),
        densest_cell=densest,
        d2_equal_share=float((gd2 == kd2)[within].float().mean()),
        idx_equal_share=float((gidx == kidx)[within].float().mean()),
        max_rel_d2_gap=rel)

    # points on cell faces at cell size 0.1
    fp = faces_cloud()
    gc = G.build_grid(torch.from_numpy(fp), cell_size=0.1)
    gg = G.build_grid(torch.from_numpy(fp).to(dev), cell_size=0.1)
    need(torch.equal(gg.keys.cpu(), gc.keys)
         and torch.equal(gg.order.cpu(), gc.order), "P26 face keys")
    recip = torch.floor(torch.from_numpy(fp).to(dev) / 0.1).int()
    moved = int((recip != G._cells(torch.from_numpy(fp).to(dev), gg.origin,
                                   gg.cell_size)).any(1).sum())
    out["faces"] = dict(points=int(fp.shape[0]), moved_by_reciprocal=moved)

    # the grid ICP on the whole scan
    src, dst, T_gt = grid_pair(full, rng)
    s, d_ = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
             for x in (src, dst))
    m = torch.ones((src.shape[0],), dtype=torch.bool, device=dev)

    def run():
        return icp.icp_fixed_iters_grid(s, m, d_, m, cap_per_cell=GRID_CAP,
                                        device=dev, **GRID_ICP)
    T = paths.run("grid_icp", run, {})
    rte, rre = gate("P26 grid ICP", T, T_gt, se3, torch, rte_max=0.05)
    need(rre < 0.5, "P26 grid ICP RRE", rre)
    ms = cuda_ms(run, reps=1, warmup=0)
    # the same call in 16,384-query chunks (the same result): how much of
    # it is the host launching 61 chunks' passes an iteration
    big_ms = cuda_ms(lambda: icp.icp_fixed_iters_grid(
        s, m, d_, m, cap_per_cell=GRID_CAP, query_chunk=16384, device=dev,
        **GRID_ICP), reps=1, warmup=0)
    # the loop again step by step (icp_fixed_iters_grid's body): the
    # candidates the cap drops each iteration, and the same pose
    grid = G.build_grid(d_, m, cell_size=GRID_CELL)
    thresh2 = f32_square(min(GRID_ICP["dist_thresh"], GRID_CELL))
    Ti, overflow = torch.eye(4, device=dev), []
    for _ in range(GRID_ICP["iters"]):
        st = se3.apply_transform(Ti, s)
        overflow.append(int(G._gather_candidates(grid, st, GRID_CAP)[2]
                            .sum()))
        gd, gi, gf = G.grid_nearest(grid, st, cap_per_cell=GRID_CAP)
        R, t = icp.weighted_procrustes(st, icp.gather_points(d_, gi),
                                       (m & gf & (gd < thresh2)).float())
        Ti = se3.make_transform(R, t) @ Ti
    steps_err = float((Ti - T).abs().max())
    need(steps_err <= 1e-6, "P26 grid ICP step by step", steps_err)
    out["grid_icp"] = dict(points=int(src.shape[0]), rte=rte, rre=rre,
                           call_ms=ms, ms_per_iter=ms / GRID_ICP["iters"],
                           iters_per_s=GRID_ICP["iters"] / (ms / 1e3),
                           chunk16384_ms_per_iter=big_ms / GRID_ICP["iters"],
                           p3_kernel5_ms_per_iter=k5_ms_per_iter,
                           overflow_per_iter=overflow,
                           step_by_step_err=steps_err, **GRID_ICP,
                           cap_per_cell=GRID_CAP)
    out["profile_grid_nearest"] = profile(
        "grid_nearest (full scan)", lambda: G.grid_nearest(
            grid, s, cap_per_cell=GRID_CAP), torch, top=6)

    # a 16,384-point pair: the card's pose against the CPU's
    ps, pd, pT = grid_pair(full, rng, N_POINTS)
    pm_ = torch.ones((N_POINTS,), dtype=torch.bool)
    poses = {}
    for name, d in (("card", dev), ("cpu", cpu)):
        t0 = time.perf_counter()
        poses[name] = icp.icp_fixed_iters_grid(
            torch.from_numpy(ps), pm_, torch.from_numpy(pd), pm_,
            cap_per_cell=GRID_CUT_CAP, device=d, **GRID_ICP).cpu()
        out[f"pair_{name}_s"] = time.perf_counter() - t0
    err = float((poses["card"] - poses["cpu"]).abs().max())
    need(err <= 1e-4, "P26 grid ICP card vs CPU", err)
    prte, prre = gate("P26 grid ICP pair", poses["card"], pT, se3, torch,
                      rte_max=0.05)
    out["pair"] = dict(points=N_POINTS, err_vs_cpu=err, rte=prte, rre=prre,
                       cap_per_cell=GRID_CUT_CAP)
    print(f"P26 grid ICP on {src.shape[0]} pts, {GRID_ICP['iters']} iters "
          f"(cell {GRID_CELL} m, {GRID_CAP} a cell): RTE {rte:.5f} m, RRE "
          f"{rre:.5f} deg; {ms:.1f} ms per call = {ms / GRID_ICP['iters']:.2f}"
          f" ms per iteration ({GRID_ICP['iters'] / (ms / 1e3):.1f} iters/s;"
          f" {big_ms / GRID_ICP['iters']:.2f} in 16,384-query chunks; P3's "
          f"kernel 5 {k5_ms_per_iter or float('nan'):.3f} an iteration)")
    print(f"    candidates the per-cell cap dropped, per iteration: "
          f"{overflow[0]} (first) .. {overflow[-1]} (last), "
          f"{overflow[-1] / src.shape[0]:.0f} a query (the loop step by "
          f"step: pose within {steps_err:.1e})")
    print(f"    16,384-pt cut, card = CPU (nearest, knn, radius); vs K1: "
          f"d2 equal {out['grid_vs_k1']['d2_equal_share']:.4f}, idx equal "
          f"{out['grid_vs_k1']['idx_equal_share']:.4f}, max rel gap "
          f"{out['grid_vs_k1']['max_rel_d2_gap']:.2e}; face keys equal "
          f"({moved} of {fp.shape[0]} points moved by 1/0.1); pair card vs "
          f"CPU {err:.1e} (CPU {out['pair_cpu_s']:.1f} s)")
    print(kernels_line("P26", out["kernels_vs_plain"]))
    return out


def host_phase(paths, mods, full, workdir, hm, dev, torch):
    """P27: the native loader and trees, the neighbour-search CLI and the
    host utilities.
    - 4 scans written as velodyne .bin files (x, y, z, intensity):
      `batch_read_velodyne` equal to `np.fromfile` for each, None for a
      missing path; `voxel_count` of the scan at 0.5 m equal to the count
      of unique floored cells.
    - `KDTree` and `Octree` on the scan: `knn` (k 8: the neighbours) and
      `radius` (1 m, cap 64: the count, and the neighbours where they fit)
      on 8,192 of its points equal to brute force (float64 on the card)
      but where a point lies within 1e-6 of the k-th distance or of the
      radius; the comparison counters printed.
    - `nn_benchmark.main` on one written scan: every row printed, and
      K1 launched (its 1-NN row, warm-up and timed call), each launch
      equal to its plain version.
    - `measure_mfu` of a 4,096^3 float32 matmul: 0 < mfu <= 1.05 against
      `PEAK_FLOPS["float32"]`; `profiler_trace` writes a trace; the `viz`
      writers write non-empty PLYs.
    Returns the metrics."""
    import io as pyio
    native, spatial = hm["native"], hm["spatial"]
    nn_benchmark, profiling, viz = (hm["nn_benchmark"], hm["profiling"],
                                    hm["viz"])
    out = {}
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    t0 = time.perf_counter()
    for name in native.LIBS:                     # g++, before any timing
        native.load(name)
    out["native_build_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(27)
    paths_ = []
    for i in range(4):
        pts = full if i == 0 else full[rng.choice(full.shape[0],
                                                  full.shape[0] // (i + 1),
                                                  replace=False)]
        scan = np.concatenate([pts, rng.uniform(size=(len(pts), 1))],
                              1).astype(np.float32)
        p = workdir / f"{i:06d}.bin"
        scan.tofile(p)
        paths_.append(str(p))
    t0 = time.perf_counter()
    read = native.batch_read_velodyne(paths_ + [str(workdir / "none.bin")])
    out["batch_read_ms"] = (time.perf_counter() - t0) * 1e3
    for p, got in zip(paths_, read):
        need(np.array_equal(got, np.fromfile(p, np.float32).reshape(-1, 4)
                            [:, :3]), "P27 batch_read_velodyne", p)
    need(read[-1] is None, "P27 missing path")
    cells = np.floor((full - full.min(0)) / np.float32(0.5)).astype(np.int64)
    want = len(np.unique(cells, axis=0))
    got = native.voxel_count(full, 0.5)
    need(got == want, "P27 voxel_count", got, want)
    out["voxel_count"] = got

    # the trees against brute force on the card
    q = full[rng.choice(full.shape[0], 8192, replace=False)]
    k, r, cap = 8, 1.0, 64
    qd, fd = (torch.from_numpy(x).to(dev).double() for x in (q, full))
    bd, bi, bc, br, edge_r = [], [], [], [], []
    for s0 in range(0, q.shape[0], 1024):
        d2 = ((qd[s0:s0 + 1024, None, :] - fd[None]) ** 2).sum(-1)
        v, i = torch.topk(d2, k + 1, largest=False)
        bd.append(v)
        bi.append(i)
        near = d2 <= r * r
        bc.append(near.sum(1))
        v, i = torch.topk(torch.where(near, d2, float("inf")), cap,
                          largest=False)
        br.append(torch.where(torch.isinf(v), 1 << 30, i))
        edge_r.append(((d2 - r * r).abs() <= 1e-6 * (r * r)).any(1))
    bd, bi, bc, br, edge_r = (torch.cat(x).cpu()
                              for x in (bd, bi, bc, br, edge_r))
    ref_radius = np.sort(br.numpy(), 1)
    # a query is ambiguous where the k-th and (k+1)-th lie within 1e-6
    tie = (bd[:, k] - bd[:, k - 1]) <= 1e-6 * bd[:, k].clamp_min(1e-12)
    ref_knn = np.sort(bi[:, :k].numpy(), 1)
    out["trees"] = {}
    for name, cls in (("kdtree", spatial.KDTree), ("octree", spatial.Octree)):
        t0 = time.perf_counter()
        tree = cls(full)
        build_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        idx, d2, cmp = tree.knn(q, k)
        knn_ms = (time.perf_counter() - t0) * 1e3
        ok = (np.sort(idx, 1) == ref_knn).all(1) | tie.numpy()
        need(bool(ok.all()), f"P27 {name} knn", int((~ok).sum()))
        t0 = time.perf_counter()
        ridx, _, cnt, rcmp = tree.radius(q, r, cap=cap)
        radius_ms = (time.perf_counter() - t0) * 1e3
        okc = (cnt == bc.numpy()) | edge_r.numpy()
        need(bool(okc.all()), f"P27 {name} radius count", int((~okc).sum()))
        # every neighbour within the radius, where they fit in the cap
        sets = ((np.sort(np.where(ridx < 0, 1 << 30, ridx), 1) == ref_radius)
                .all(1) | edge_r.numpy() | (cnt > cap))
        need(bool(sets.all()), f"P27 {name} radius sets", int((~sets).sum()))
        out["trees"][name] = dict(
            nodes=tree.node_count, build_ms=build_ms, knn_ms=knn_ms,
            radius_ms=radius_ms, knn_cmp_mean=float(cmp.mean()),
            radius_cmp_mean=float(rcmp.mean()), ties=int(tie.sum()),
            radius_edges=int(edge_r.sum()))

    # the CLI on one written scan: every row, K1 launched
    buf = pyio.StringIO()
    with contextlib.redirect_stdout(buf), \
            recording_k1_k4(mods["pallas_nn"], mods["pallas_fpfh"],
                            mods["pallas_icp_mega"]) as rec:
        paths.run("nn_benchmark", lambda: nn_benchmark.main(
            ["--bin", paths_[0], "--device", dev.type]), {"nn1": 2})
    out["kernels_vs_plain"] = check_path_kernels(mods, rec, torch)
    text = buf.getvalue()
    rows = ("pctpu_torch knn:", "pctpu_torch radius:", "pctpu_torch 1-NN:",
            "c++ kd build:", "c++ kd knn:", "c++ kd radius:",
            "c++ oct build:", "c++ oct knn:", "c++ oct radius:",
            "scipy build:", "scipy knn:", "scipy radius:", "numpy brute:")
    need(all(r_ in text for r_ in rows) and "note:" not in text,
         "P27 nn_benchmark rows", text)
    out["nn_benchmark"] = text

    # the utilities
    a = torch.randn(4096, 4096, device=dev)
    b = torch.randn(4096, 4096, device=dev)
    mm = profiling.measure_mfu(torch.matmul, a, b)
    need(0 < mm["mfu"] <= 1.05, "P27 mfu", mm)
    ev_ms = cuda_ms(lambda: torch.matmul(a, b), reps=5)
    out["mfu"] = dict(mm, events_ms=ev_ms,
                      events_mfu=profiling.mfu(mm["flops"], ev_ms / 1e3))
    with profiling.profiler_trace(str(workdir / "trace")):
        torch.matmul(a, b)
        torch.cuda.synchronize()
    traces = list((workdir / "trace").iterdir())
    need(len(traces) == 1 and traces[0].stat().st_size > 0, "P27 trace")
    out["trace_bytes"] = traces[0].stat().st_size
    labels = np.arange(full.shape[0]) % 7 - 1
    plys = {"clusters": (viz.write_clusters_ply, (full, labels)),
            "registration": (viz.write_registration_ply,
                             (full[:1000], full[1000:2000], np.eye(4))),
            "keypoints": (viz.write_keypoints_ply,
                          (full[:2000], labels[:2000] > 3)),
            "detections": (viz.write_detections_ply, (full[:2000], [
                {"center": [5, 0, 0.8], "dims": [3.9, 1.6, 1.5], "R": None,
                 "class_id": 0}])),
            "trajectory": (viz.write_trajectory_ply,
                           (np.tile(np.eye(4), (8, 1, 1)),))}
    for name, (fn, args) in plys.items():
        p = workdir / f"{name}.ply"
        fn(str(p), *args)
        need(p.stat().st_size > 0, "P27 ply", name)
    print(f"P27 host code: g++ of both libraries {out['native_build_s']:.1f}"
          f" s; batch_read_velodyne of 4 scans {out['batch_read_ms']:.1f} ms,"
          f" voxel_count {got} (0.5 m); trees on the scan, 8,192 queries = "
          "brute force:")
    for name, t in out["trees"].items():
        print(f"    {name}: {t['nodes']} nodes, build {t['build_ms']:.1f} "
              f"ms, knn {t['knn_ms']:.1f} ms ({t['knn_cmp_mean']:.0f} "
              f"cmp/query), radius {t['radius_ms']:.1f} ms "
              f"({t['radius_cmp_mean']:.0f} cmp/query)")
    print("    nn_benchmark on the written scan:")
    for line in text.strip().splitlines():
        print("      " + line)
    print(f"    measure_mfu 4096^3 f32: {mm['mean_s'] * 1e3:.2f} ms (host "
          f"clock, outputs fetched) mfu {mm['mfu']:.3f}; CUDA events "
          f"{ev_ms:.2f} ms, mfu {out['mfu']['events_mfu']:.3f}; trace "
          f"{out['trace_bytes']} bytes; {len(plys)} PLYs written")
    print(kernels_line("P27", out["kernels_vs_plain"]))
    return out


# ---------------------------------------------------------------------------
# P28 distribution
# ---------------------------------------------------------------------------

P28_WORLD = 2                       # gloo ranks sharing the card
P28_ICP_ITERS = 30
P28_CG_ITERS = 400                  # P14's, max(400, 3 * 128 poses)
# cls-ssg train step launches a rank (P11's): SA1, SA2 FPS and grouping,
# kernel 12's backward at SA2
P28_STEP = {"fps_pallas_batched": 2, "ball_group": 2, "scatter_add_rows": 1}


def p28_rank(job):
    """One P28 world's paths in one of its ranks (spawned by
    `parallel.launch.run_world`, which imports this file afresh without
    running `main`). Each path in job["tasks"] runs with every launch
    counter set to 0 just before it and read just after, must launch
    exactly its kernels on this rank, and has every launch it recorded
    held against the kernel's plain version here (K1 and kernel 11 equal,
    kernel 12's idx and rows equal, kernel 14 equal, K2-K4 at
    `check_path_kernels`' bounds). Returns rank 0's results, with the
    launch counts summed over the ranks."""
    import torch
    import torch.distributed as dist
    from pctpu_torch import parallel as P
    from pctpu_torch.core import se3
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.features import pallas_fpfh
    from pctpu_torch.nn import augment, fit, config as nncfg, train as T
    from pctpu_torch.ops import (ball_query, gather, pallas_ballgroup,
                                 pallas_fps, pallas_gather, pallas_icp_mega,
                                 pallas_nn)
    from pctpu_torch.parallel import mesh as M
    from pctpu_torch.register import pipeline, ransac
    dev = torch.device("cuda", torch.cuda.current_device())
    mods = dict(pallas_nn=pallas_nn, pallas_fpfh=pallas_fpfh,
                pallas_icp_mega=pallas_icp_mega)
    counted = {"nn1": pallas_nn.nn1, "spfh": pallas_fpfh.spfh,
               "wsum": pallas_fpfh.wsum,
               "icp_mega_batch": pallas_icp_mega.icp_mega_batch,
               "fps_pallas_batched": pallas_fps.fps_pallas_batched,
               "ball_group": pallas_ballgroup.ball_group,
               "scatter_add_rows": pallas_gather.scatter_add_rows_pallas,
               "ransac_refine": ransac.ransac_refine}
    mesh = P.make_mesh((("data", -1),))
    world = dist.get_world_size()
    out = {"world": world, "backend": dist.get_backend(), "launches": {},
           "ms": {}}

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x)).to(dev)

    def run(name, fn, expect):
        for k in counted.values():
            k.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        out["ms"][name] = (time.perf_counter() - t0) * 1e3
        got = {k: f.launches for k, f in counted.items()}
        need(got == {k: expect.get(k, 0) for k in counted}, "P28", name,
             "launches on rank", dist.get_rank(), got, expect)
        total = M.all_reduce(torch.tensor(list(got.values()), device=dev))
        out["launches"][name] = {k: int(v) for k, v in zip(got,
                                                             total.tolist())
                                 if v}
        return res

    def k1_equal(calls):
        """K1 equal to its plain version on a loop's first, middle and
        last launch (each of 30 is a full-scan plain pass)."""
        pick = sorted({0, len(calls) // 2, len(calls) - 1})
        for i in pick:
            check_nn1(mods, calls[i], torch, timed=False)
        return len(pick)

    tasks = job["tasks"]
    if "dp_train" in tasks:
        d = job["dp"]
        preset = nncfg.MODELNET40_CLS_SSG
        model = T.build_model(preset, device=dev)
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in d["state"].items()})
        state = T.TrainState(model, T.make_optimizer(preset).init(
            list(model.parameters())), 0)
        step = T.make_data_parallel_train_step(model, preset, mesh,
                                               device=dev)
        pc, lab = t(d["pc"]), t(d["labels"])

        def one_step():
            x = augment.augment_batch(
                fit.step_generator(d["seed"], state.step, 0, dev), pc)
            return step(state, x, lab, fit.step_generator(
                d["seed"], state.step, 1, dev))
        m0 = one_step()                     # the step held against P11's
        first = dict(metrics={k: float(v) for k, v in m0.items()},
                     grads=[(mu / 0.1).cpu() for mu in state.opt_state.mu],
                     state={k: v.detach().cpu().clone()
                            for k, v in model.state_dict().items()})
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def timed():
            ev[0].record()
            res = [one_step() for _ in range(TRAIN_STEPS)]
            ev[1].record()
            return res
        with Recorder(pallas_fps, "_launch_fps") as rf, \
                Recorder(pallas_ballgroup, "_launch_ball_group") as rg, \
                Recorder(pallas_gather, "_launch_scatter_add_rows") as rs:
            ms = run("dp_train", timed, {k: v * TRAIN_STEPS
                                         for k, v in P28_STEP.items()})
        with torch.no_grad():
            check_fps(pallas_fps, rf.calls, torch)
            bg_err, _, _ = check_ball_group(pallas_ballgroup, ball_query,
                                            gather, rg.calls, torch)
            for a in rs.calls:
                need(torch.equal(pallas_gather._launch_scatter_add_rows(*a),
                                 pallas_gather.scatter_add_rows_plain(*a)),
                     "P28 kernel 14 vs plain", tuple(a[0].shape))
        out["dp"] = dict(first=first, losses=[float(m["loss"]) for m in
                                              [m0] + ms],
                         step_ms=ev[0].elapsed_time(ev[1]) / TRAIN_STEPS,
                         checked=dict(fps=len(rf.calls), ball_group=len(
                             rg.calls), scatter=len(rs.calls)),
                         ball_group_err=bg_err,
                         names=[n for n, _ in model.named_parameters()])
        del model, state, step
        torch.cuda.empty_cache()

    if "sweeps" in tasks:
        f = job["pairs"]
        mask = t(np.ones(f["src"].shape[:2], bool))
        src, dst = PointCloud(t(f["src"]), mask), PointCloud(t(f["dst"]), mask)
        sweep = P.make_full_pipeline_sweep(mesh, device=dev)
        sweep(src, dst)                                     # warm-up
        with recording_k1_k4(pallas_nn, pallas_fpfh, pallas_icp_mega) as rec:
            reg = run("full_sweep", lambda: sweep(src, dst),
                      {"nn1": 1, "spfh": 2, "wsum": 2, "icp_mega_batch": 2,
                       "ransac_refine": 1})
        out["full"] = dict(T=reg.T, checked=check_path_kernels(mods, rec,
                                                               torch))
        moved = se3.apply_transform(reg.T, src.points)
        icp_sweep = P.make_pair_sweep(mesh, iters=P28_ICP_ITERS, device=dev)
        with Recorder(pallas_nn, "nn1") as r1:
            Ts = run("pair_sweep", lambda: icp_sweep(moved, mask, dst.points,
                                                     mask),
                     {"nn1": P28_ICP_ITERS})
        out["pair"] = dict(T=Ts, checked=k1_equal(r1.calls))

    if "point_icp" in tasks:
        c = job["icp"]
        s_, d_ = t(c["src"]), t(c["dst"])
        m_ = t(np.ones(c["src"].shape[0], bool))
        f = P.make_point_sharded_icp(mesh, point_axis="data",
                                     iters=P28_ICP_ITERS, device=dev)
        f(s_, m_, d_, m_)                                   # warm-up
        with Recorder(pallas_nn, "nn1") as r1:
            T_ = run("point_icp", lambda: f(s_, m_, d_, m_),
                     {"nn1": P28_ICP_ITERS})
        out["icp"] = dict(T=T_, checked=k1_equal(r1.calls))

    if "halo" in tasks:
        h = job["halo"]
        f = P.make_halo_nearest(mesh, h["width"], point_axis="data",
                                device=dev)
        hin = [t(h[k]) for k in ("src", "src_mask", "dst", "dst_mask")]
        f(*hin)                                             # warm-up
        with Recorder(pallas_nn, "nn1") as r1:
            d2, idx = run("halo", lambda: f(*hin), {"nn1": 1})
        out["halo"] = dict(d2=d2, idx=idx, checked=k1_equal(r1.calls))

    if "posegraph" in tasks:
        g = job["pg"]
        args = [t(g[k]) for k in ("poses", "ei", "ej", "Tm_inv", "w")]
        dense = P.make_sharded_pose_graph_step(mesh, device=dev)
        sparse = P.make_sharded_pose_graph_step_sparse(
            mesh, cg_iters=P28_CG_ITERS, device=dev)
        dense(*args)          # warm-up: torch.func, cuSOLVER, the staging
        out["pg"] = dict(dense=run("posegraph_dense", lambda: dense(*args),
                                   {}),
                         sparse=run("posegraph_sparse", lambda: sparse(*args),
                                    {}))
    return out


def distribution_phase(paths, rows, d, dev, pm, torch):
    """P28: the distributed paths through `torch.distributed`, on the card.
    A gloo world of P28_WORLD ranks sharing the card (NCCL refuses two
    ranks on one card; gloo's transfers of CUDA tensors go through host
    memory, `parallel/mesh.py`), and an NCCL world of one rank:

    - data-parallel `cls-ssg` training (`make_data_parallel_train_step`)
      at B 32 x 4,096 x 6 on P11's clouds and recipe, 1 + 5 steps, in
      both worlds: the first step against the one-process `make_train_step`
      on all 32 at `tests/torch_ranks.py:dp_mismatches`' bounds (those of
      `tests/test_torch_dp_train.py`, at the card's float32 floor: the
      gradients 1e-2 of a norm, P10-P11's card-vs-CPU bound, the loss 1e-5
      relative), finite losses;
      kernels 11, 12, 14;
    - the full-pipeline sweep on P1's 16 pairs (gloo): every pair within
      the bound and within 1e-3 (the dry run's bound) of the one-process
      `register_pairs` with the same draws (a generator seeded 0 over the
      whole batch): at 8 pairs a rank the card's batched passes round
      otherwise than at 16; K1-K4;
    - the pair sweep (30 ICP iterations, K1) on those pairs with the
      source moved by the sweep's poses: the composed poses within the
      bound, within 1e-4 of the one-process `batched_icp`;
    - the point-sharded ICP on P3's pair, 30 iterations, in both worlds:
      within 1e-4 of the one-process `icp_fixed_iters`, RTE and RRE within
      the bound; K1;
    - the halo 1-NN of P3's perturbed scan against the scan, both in 2
      x-slabs, the halo width the least that reaches every query's true
      neighbour: d2 and index equal to K1 over the whole scan;
    - the edge-sharded dense and sparse pose-graph steps on P14's graph
      (edges padded to the world size with weight 0 at (0, 0)), within
      1e-3 of `optimize_pose_graph` / `_sparse` at one iteration (the
      dry run's bound);
    - `entry.dryrun_multichip(2)` over gloo on the card.
    Every figure prints before a failed gate fails the phase. Returns the
    metrics."""
    from pctpu_torch.entry import dryrun_multichip
    from pctpu_torch.parallel.launch import run_world
    import torch_ranks
    se3, pipeline, pair_sweep, icp, posegraph, pallas_nn, T, fit, augment = (
        pm[k] for k in ("se3", "pipeline", "pair_sweep", "icp", "posegraph",
                        "pallas_nn", "T", "fit", "augment"))
    PointCloud, halo, preset = pm["PointCloud"], pm["halo"], pm["preset"]
    out, fails = {}, []

    def check(ok, *what):
        """A P28 gate: a failure is reported at the end of the phase."""
        if not ok:
            fails.append(what)
            print("   P28 gate failed:", what)

    # the one-process references and the inputs
    model, state = T.create_train_state(
        preset, torch.Generator().manual_seed(d["seed"]), d["pc"], device=dev)
    dp = dict(state={k: v.cpu().numpy().copy() for k, v in
                     model.state_dict().items()},
              pc=d["pc"].cpu().numpy(), labels=d["labels"].cpu().numpy(),
              seed=d["seed"])
    step = T.make_train_step(model, preset, device=dev)
    x0 = augment.augment_batch(fit.step_generator(d["seed"], 0, 0, dev),
                               d["pc"])
    m0 = step(state, x0, d["labels"], fit.step_generator(d["seed"], 0, 1,
                                                          dev))
    one = dict(metrics={k: float(v) for k, v in m0.items()},
               grads=[(mu / 0.1).cpu() for mu in state.opt_state.mu],
               state={k: v.detach().cpu().clone()
                      for k, v in model.state_dict().items()})
    names = [n for n, _ in model.named_parameters()]
    del model, state, step
    torch.cuda.empty_cache()

    icp_job = dict(src=d["w4_src"], dst=d["w4_dst"])
    q_p, q_m = halo.partition_by_axis(d["w4_dst"], P28_WORLD)
    db_p, db_m = halo.partition_by_axis(d["w4_src"], P28_WORLD)
    qd, dbd, dbm = (torch.from_numpy(x).to(dev) for x in (q_p, db_p, db_m))
    ref_d2, ref_idx = pallas_nn.nearest_batch(qd[None], dbd[None], dbm[None])
    ref_d2, ref_idx = ref_d2[0], ref_idx[0].long()
    s = q_p.shape[0] // P28_WORLD
    slab = torch.arange(q_p.shape[0], device=dev) // s
    reach = torch.maximum(slab * s - ref_idx, ref_idx - (slab + 1) * s + 1)
    width = max(int(reach.max()), 1)
    need(width <= s, "P28 halo width", width, s)
    halo_job = dict(src=q_p, src_mask=q_m, dst=db_p, dst_mask=db_m,
                    width=width)
    poses14, (ei, ej, Tm) = d["pg"]
    pad = (-len(ei)) % P28_WORLD
    pg = dict(poses=poses14.astype(np.float32),
              ei=np.concatenate([ei, np.zeros(pad, ei.dtype)]).astype(
                  np.int64),
              ej=np.concatenate([ej, np.zeros(pad, ej.dtype)]).astype(
                  np.int64),
              Tm=np.concatenate([Tm, np.tile(np.eye(4, dtype=np.float32),
                                             (pad, 1, 1))]),
              w=np.concatenate([np.ones(len(ei), np.float32),
                                np.zeros(pad, np.float32)]))
    pg["Tm_inv"] = se3.invert_transform(torch.from_numpy(pg["Tm"])).numpy()

    # the two worlds
    worlds = {}
    t0 = time.perf_counter()
    worlds["gloo"] = run_world(p28_rank, P28_WORLD, "gloo", dev, dict(
        tasks=("dp_train", "sweeps", "point_icp", "halo", "posegraph"),
        dp=dp, pairs=dict(src=d["src"], dst=d["dst"]), icp=icp_job,
        halo=halo_job, pg=pg), timeout=600)
    out["gloo_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    worlds["nccl"] = run_world(p28_rank, 1, "nccl", dev, dict(
        tasks=("dp_train", "point_icp"), dp=dp, icp=icp_job), timeout=600)
    out["nccl_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(P28_WORLD, backend="gloo", device=dev)
    out["dryrun_s"] = time.perf_counter() - t0
    for wname, w in worlds.items():
        for task, counts in w["launches"].items():
            paths.launches[f"P28 {task} ({wname} x{w['world']})"] = counts

    # data-parallel training against the one-process step
    for wname, w in worlds.items():
        bad = torch_ranks.dp_mismatches(w["dp"]["first"], one, names,
                                        grad_tol=1e-2, loss_rtol=1e-5)
        check(bad == [] and w["dp"]["names"] == names, "dp_train vs "
              "make_train_step", wname, bad)
        check(all(np.isfinite(w["dp"]["losses"])), "dp losses", wname)
        out["dp_" + wname] = dict(
            step_ms=w["dp"]["step_ms"], losses=w["dp"]["losses"],
            loss_vs_one=abs(w["dp"]["first"]["metrics"]["loss"]
                            - one["metrics"]["loss"]),
            grad_err=grad_err(w["dp"]["first"]["grads"], one["grads"]),
            checked=w["dp"]["checked"], launches=w["launches"]["dp_train"])
        print(f"P28 dp_train cls-ssg {d['pc'].shape[0]} x "
              f"{d['pc'].shape[1]} ({wname}, {w['world']} rank(s)): "
              f"{w['dp']['step_ms']:.2f} ms per step = "
              f"{d['pc'].shape[0] / w['dp']['step_ms'] * 1e3:.1f} clouds/s;"
              f" first step vs make_train_step: loss "
              f"{out['dp_' + wname]['loss_vs_one']:.1e}, grads "
              f"{out['dp_' + wname]['grad_err']:.1e} of a norm; losses "
              + ", ".join(f"{v:.4f}" for v in w["dp"]["losses"]))

    # the sweeps against the one-process runs on all 16 pairs
    g = worlds["gloo"]
    mask = torch.ones(d["src"].shape[:2], dtype=torch.bool, device=dev)
    src = PointCloud(torch.from_numpy(d["src"]).to(dev), mask)
    dst = PointCloud(torch.from_numpy(d["dst"]).to(dev), mask)
    ref = pipeline.register_pairs(src, dst, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    T_full = g["full"]["T"].to(dev)
    rte, rre = gate("P28 full_sweep", T_full, d["gts"], se3, torch)
    dfull = float((T_full - ref.T).abs().max())
    check(dfull <= 1e-3, "full_sweep vs register_pairs", dfull)
    moved = se3.apply_transform(T_full, src.points)
    ref_pair = pair_sweep.batched_icp(moved, mask, dst.points, mask,
                                      iters=P28_ICP_ITERS, device=dev)
    T_pair = g["pair"]["T"].to(dev)
    prte, prre = gate("P28 pair_sweep", T_pair @ T_full, d["gts"], se3,
                      torch)
    dpair = float((T_pair - ref_pair).abs().max())
    check(dpair <= 1e-4, "pair_sweep vs batched_icp", dpair)
    out["sweeps"] = dict(full_ms=g["ms"]["full_sweep"],
                         pair_ms=g["ms"]["pair_sweep"], full_rte=rte,
                         full_rre=rre, full_vs_one=dfull, pair_rte=prte,
                         pair_rre=prre, pair_vs_one=dpair)
    print(f"P28 sweeps ({P28_WORLD} gloo ranks, {d['src'].shape[0]} x "
          f"{d['src'].shape[1]}): full pipeline {g['ms']['full_sweep']:.1f}"
          f" ms, max RTE {rte:.4f} m, RRE {rre:.4f} deg, vs register_pairs "
          f"{dfull:.1e}; ICP sweep {g['ms']['pair_sweep']:.1f} ms, max RTE "
          f"{prte:.4f} m, RRE {prre:.4f} deg, vs batched_icp {dpair:.1e}")
    print(kernels_line("P28 full sweep", g["full"]["checked"]))

    # the point-sharded ICP
    s4, d4 = (torch.from_numpy(x).to(dev) for x in (d["w4_src"],
                                                    d["w4_dst"]))
    m4 = torch.ones(s4.shape[0], dtype=torch.bool, device=dev)
    T_one = icp.icp_fixed_iters(s4, m4, d4, m4, iters=P28_ICP_ITERS,
                                device=dev)
    for wname, w in worlds.items():
        T_ = w["icp"]["T"].to(dev)
        dT = float((T_ - T_one).abs().max())
        irte, irre = gate("P28 point_icp", T_, d["w4_gt"], se3, torch)
        check(dT <= 1e-4, "point_icp vs icp_fixed_iters", wname, dT)
        out["point_icp_" + wname] = dict(ms=w["ms"]["point_icp"], dT=dT,
                                         rte=irte, rre=irre)
        print(f"P28 point-sharded ICP ({wname}, {w['world']} rank(s), "
              f"{s4.shape[0]} pts, {P28_ICP_ITERS} iters): "
              f"{w['ms']['point_icp']:.1f} ms, RTE {irte:.5f} m, RRE "
              f"{irre:.5f} deg; max |dT| vs icp_fixed_iters {dT:.1e}")

    # the halo 1-NN
    hd2, hidx = g["halo"]["d2"].to(dev), g["halo"]["idx"].to(dev).long()
    check(torch.equal(hd2, ref_d2) and torch.equal(hidx, ref_idx),
          "halo vs K1 over the whole scan",
          int((hd2 != ref_d2).sum()), int((hidx != ref_idx).sum()))
    out["halo"] = dict(width=width, slab=s, ms=g["ms"]["halo"])
    print(f"P28 halo 1-NN ({P28_WORLD} slabs of {s:,} points, halo width "
          f"{width}): {g['ms']['halo']:.1f} ms; d2 and index = K1 over the "
          "whole scan")

    # the pose-graph steps
    ref_dense = posegraph.optimize_pose_graph(
        pg["poses"], pg["ei"], pg["ej"], pg["Tm"], weights=pg["w"], iters=1,
        device=dev)
    ref_sparse = posegraph.optimize_pose_graph_sparse(
        pg["poses"], pg["ei"], pg["ej"], pg["Tm"], weights=pg["w"], iters=1,
        cg_iters=P28_CG_ITERS, device=dev)
    dd = float((g["pg"]["dense"].to(dev) - ref_dense.poses).abs().max())
    ds = float((g["pg"]["sparse"].to(dev) - ref_sparse.poses).abs().max())
    check(dd <= 1e-3 and ds <= 1e-3, "sharded pose graph", dd, ds)
    out["posegraph"] = dict(poses=len(pg["poses"]), edges=len(pg["ei"]),
                            dense_dP=dd, sparse_dP=ds,
                            dense_ms=g["ms"]["posegraph_dense"],
                            sparse_ms=g["ms"]["posegraph_sparse"])
    print(f"P28 sharded pose-graph steps (P14's {len(pg['poses'])} poses, "
          f"{len(pg['ei'])} edges): dense {g['ms']['posegraph_dense']:.1f}"
          f" ms, max |dP| {dd:.1e}; sparse {g['ms']['posegraph_sparse']:.1f}"
          f" ms, max |dP| {ds:.1e}")
    k1_checked = sum(w[k]["checked"] for w in worlds.values()
                     for k in ("pair", "icp", "halo") if k in w)
    print(f"   P28 kernels vs plain in the ranks: K1 equal on {k1_checked} "
          "launches (each loop's first, middle and last, the halo's one); "
          "kernels 11, 12, 14 on every dp_train launch equal ("
          + "; ".join(f"{n} {w['dp']['checked']}" for n, w in worlds.items())
          + f"); worlds: gloo {out['gloo_s']:.1f} s, nccl "
          f"{out['nccl_s']:.1f} s, dryrun_multichip({P28_WORLD}) "
          f"{out['dryrun_s']:.1f} s")
    for name in ("nn1", "spfh", "wsum", "icp_mega_batch"):
        if name in g["full"]["checked"]:
            rows[name]["max_abs_err"] = max(
                rows[name]["max_abs_err"],
                g["full"]["checked"][name]["max_abs_err"])
    rows["ball_group"]["max_abs_err"] = max(
        rows["ball_group"]["max_abs_err"],
        *(w["dp"]["ball_group_err"] for w in worlds.values()))
    need(not fails, "P28", fails)
    return out


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
        from pctpu_torch.core.cloud import PointCloud, round_up
        from pctpu_torch import entry as pentry
        from pctpu_torch import features
        from pctpu_torch.features import fpfh_dense, margins, pallas_fpfh
        from pctpu_torch.models import pointrcnn
        from pctpu_torch.models import pointnet2
        from pctpu_torch.nn import augment
        from pctpu_torch.nn import checkpoint as ckpt
        from pctpu_torch.nn import config as nncfg
        from pctpu_torch.nn import fit
        from pctpu_torch.nn import train as T
        from pctpu_torch.ops import (ball_query, box3d, gather, knn, normals,
                                     pallas_ballgroup,
                                     pallas_banded, pallas_fps,
                                     pallas_gather, pallas_icp_mega,
                                     pallas_nn, voxel)
        from pctpu_torch.parallel import halo, pair_sweep, posegraph
        from pctpu_torch.pipelines import odometry, registration_driver
        from pctpu_torch import cluster
        from pctpu_torch.cluster.dbscan import dbscan
        from pctpu_torch.cluster.plane_ransac import (gumbel_sampler,
                                                      segment_ground)
        from pctpu_torch.nn.data import KITTIResampledDataset
        from pctpu_torch.ops.normals import estimate_normals
        from pctpu_torch.pipelines import (detect, kitti_etl, kitti_eval,
                                           miniworld, segmentation, trainset)
        from pctpu_torch.register import icp, pipeline, ransac
        from pctpu_torch.register.ransac import generator_sampler
        from pctpu_torch import native
        from pctpu_torch.native import spatial
        from pctpu_torch.ops import grid_hash
        from pctpu_torch.pipelines import nn_benchmark
        from pctpu_torch.utils import profiling, viz
        sys.path.insert(0, str(ROOT / "tests"))
        from grid_faces import faces_cloud
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
               "ball_group": pallas_ballgroup.ball_group,
               "gather_rows": pallas_gather.gather_rows_pallas,
               "scatter_add_rows": pallas_gather.scatter_add_rows_pallas,
               "moments": pallas_fpfh.moments,
               "ransac_refine": ransac.ransac_refine,
               "voxel_run_means": voxel.voxel_run_means}
    paths = Paths(counted, torch)
    report, rows, metrics = {}, {}, {}

    # ---- 1. environment --------------------------------------------------
    t_all = time.perf_counter()
    marks = []

    def mark(name):
        """Starts the wall clock of the next phase (None: the end)."""
        marks.append((name, time.perf_counter()))
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
    mark("data")
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
    mark("P1 register_pairs (K1-K4)")
    def run(seed=0):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return pipeline.register_pairs(src, dst, cfg=cfg, generator=gen)

    with Recorder(pallas_nn, "nn1") as r_nn, \
            Recorder(pallas_fpfh, "spfh") as r_spfh, \
            Recorder(pallas_fpfh, "wsum") as r_wsum, \
            Recorder(mega, "_launch_icp_mega") as r_k4, \
            Recorder(ransac, "ransac_refine") as r_rr:
        run()
        torch.cuda.synchronize()
    out = paths.run("register_pairs", run,
                    {"nn1": 1, "spfh": 2, "wsum": 2, "icp_mega_batch": 2,
                     "ransac_refine": 1})
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
    # K3 sums in column order, its plain version through a matmul, so
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
    print(fpfh_line("P1", fp))
    metrics["fpfh_launches"] = {"P1 register_pairs": fp}
    for name in ("spfh", "wsum"):
        rows[name] = dict(max_abs_err=fp[name]["max_abs_err"],
                          ms=fp[name]["ms"], plain_ms=fp[name]["plain_ms"],
                          bound_ms=fp[name]["bound_ms"],
                          bound_by=fp[name]["bound_by"], library_ms=None,
                          launch_us=fp[name]["launch_us"])
    errs = check_mega(mega, r_k4.calls, torch, retile=True)
    rows["icp_mega_batch"] = dict(max_abs_err=max(errs[:-1]),
                                  window_path_err=errs[-1], library_ms=None,
                                  **time_mega(mega, r_k4.calls))
    rr = check_refine(ransac, r_rr.calls, torch, strict=True)
    rows["ransac_refine"] = dict(**rr, **time_launches(
        ransac._launch_refine, ransac._select_refine_plain, r_rr.calls,
        [refine_work(a) for a in r_rr.calls]))
    rr = rows["ransac_refine"]
    rr["shape"] = list(r_rr.calls[0][1].shape)
    print(f"   ransac_refine on P1's launch (B, H, M {rr['shape']}): R max "
          f"|err| {rr['max_abs_err']:.1e}, t {rr['t_err']:.1e} m "
          f"({rr['unsure_rows']} rows within 1e-4 m of the threshold); "
          f"{rr['ms']:.3f} ms, plain chain {rr['plain_ms']:.3f} ms, bound "
          f"{rr['bound_ms'] * 1e3:.2f} us (CUDA events)")

    # ---- P2 workload 1: one 16,384-point pair, kernel 5 ------------------
    mark("P2 workload 1")
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
    mark("P3 workload 4")
    rng4 = np.random.default_rng([args.seed, 4, 1])
    w4_dst, w4_gt = perturb(full, rng4, [0.01, 0.02, 0.05], [0.5, -0.3, 0.1])
    s4, d4 = on_dev(full, w4_dst)
    m4 = torch.ones((full.shape[0],), dtype=torch.bool, device=dev)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    w4_coarse = 48

    def w4_run():           # bench.py:270-281
        ev[0].record()
        T = icp.icp_fixed_iters_banded_mega(
            s4, m4, d4, m4, coarse_iters=w4_coarse, polish_iters=0,
            dist_thresh=5.0, block=2048, window_blocks=2, query_tile=1024)
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
        refine_ms=ev[1].elapsed_time(ev[2]), coarse_iters=w4_coarse,
        iters_per_s=(w4_coarse + 3) / (w4_ms / 1e3))
    print(f"P3 workload 4 ({full.shape[0]} pts, {w4_coarse}+3 iters): RTE "
          f"{rte:.4f} m, RRE {rre:.4f} deg; {w4_ms:.1f} ms per call (kernel 5 "
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
    mark("P4 workload 2")
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
    mark("P5 the banded ICP loops on workload 1's pair (K6, K7, K8)")
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
    mark("P6 register_pair")
    one = (PointCloud(src.points[0], mask[0]), PointCloud(dst.points[0],
                                                          mask[0]))

    def p6_run():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        return pipeline.register_pair(*one, cfg=cfg, generator=gen)
    p6_run()
    with Recorder(mega, "_launch_icp_mega") as r_k5p6, \
            Recorder(pallas_nn, "nn1") as r_nn_p6, \
            Recorder(voxel, "voxel_run_means") as r_v6:
        out6 = paths.run("register_pair", p6_run,
                         {"icp_mega": 2, "nn1": 1, "ransac_refine": 1,
                          "voxel_run_means": 2})
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
    v6 = check_voxel(voxel, r_v6.calls, torch)
    # kernel V at the benchmark's single-pair shapes: P3's two whole scans
    # at RegistrationConfig's 2 m leaf
    with Recorder(voxel, "voxel_run_means") as r_vs:
        for c in (s4, d4):
            voxel.voxel_downsample(c, m4, cfg.voxel_size)
        torch.cuda.synchronize()
    vs = check_voxel(voxel, r_vs.calls, torch)
    vals = [torch.cat([torch.where(a[1][:, None], a[0], 0.0),
                       a[1][:, None].float()], dim=1).double()
            for a in r_vs.calls]
    work = [voxel_work(a) for a in r_vs.calls]
    bms, by = bound(sum(w[1] for w in work), sum(w[0] for w in work))
    rows["voxel_run_means"] = dict(
        max_abs_err=max(v6["max_abs_err"], vs["max_abs_err"]),
        ms=graph_ms([lambda a=a: voxel._launch_run_means(*a)
                     for a in r_vs.calls]),
        plain_ms=cuda_ms(lambda: [voxel._run_means_plain(*a[:4])
                                  for a in r_vs.calls], reps=3),
        bound_ms=bms, bound_by=by,
        library_ms=cuda_ms(lambda: [torch.cumsum(v, dim=0) for v in vals],
                           reps=3),
        p6=v6, whole_scans=vs)
    rv = rows["voxel_run_means"]
    print(f"   voxel_run_means: P6's 2 launches ({v6['voxels']} voxels, "
          f"{v6['rows_differing']} rows differ from plain, max |err| "
          f"{v6['max_abs_err']:.1e}); at P3's two whole scans "
          f"({vs['voxels']} voxels) {rv['ms']:.4f} ms as device time, "
          f"plain {rv['plain_ms']:.3f} ms, the cumsum alone "
          f"{rv['library_ms']:.3f} ms, bound {rv['bound_ms'] * 1e3:.2f} us")

    # ---- P7, P8 classification serving: kernels 11, 12 -------------------
    mark("P7, P8 classification serving")
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
    mark("P9 entry()")
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
    mark("kernels 10-12 against their plain versions")
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
    print(f"   kernel 11, one cls-msg forward (SA1 + SA2): "
          f"{rows['fps_pallas_batched']['ms']:.4f} ms; kernel 10, P9's 4 "
          f"launches: {rows['fps_pallas']['ms']:.4f} ms")
    rows["ball_group"] = dict(
        max_abs_err=bg_err, boundary_centres=bg_boundary, **time_launches(
            pallas_ballgroup._launch_ball_group,
            pallas_ballgroup.ball_group_plain, r_bg["cls_msg"][:4],
            bg_work[:4]))
    # one P7 forward's 4 launches and one P8 forward's 2, each alone
    n_msg = len(r_bg["cls_msg"])
    per_launch = {f"P7 #{j}": (r_bg["cls_msg"][j], bg_work[j])
                  for j in range(4)}
    per_launch.update({f"P8 #{j}": (r_bg["cls_ssg"][j], bg_work[n_msg + j])
                       for j in range(2)})
    table = ball_group_table(
        pallas_ballgroup, per_launch,
        torch.cuda.get_device_properties(0).multi_processor_count)
    rows["ball_group"]["per_launch"] = table
    p7 = sum(table[f"P7 #{j}"]["ms"] for j in range(4))
    p8 = sum(table[f"P8 #{j}"]["ms"] for j in range(2))
    rows["ball_group"].update(p7_forward_device_ms=p7,
                              p8_forward_device_ms=p8)
    print(f"   kernel 12, one forward as device time: cls-msg {p7:.4f} ms, "
          f"cls-ssg {p8:.4f} ms; cls-msg's 4 launches in a host loop "
          f"{rows['ball_group']['ms']:.4f} ms (CUDA events)")

    # ---- kernel 5, K6-K8 against their plain versions --------------------
    mark("kernel 5, K6-K8 against their plain versions")
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

    # ---- P10, P11 classification training: kernels 11, 12, 14 ------------
    mark("P10, P11 classification training")
    pc_tr, lab_tr = on_dev(clouds[:CLS_BATCH], labels[:CLS_BATCH])

    def train_path(label, name, preset, pc_tr, lab_tr, expect, keep_shape,
                   cpu_grad_tol=1e-2, record=None):
        """1 warm-up and TRAIN_STEPS timed steps of the preset's recipe
        (augmentation on the card, then `make_train_step`) on the batch
        pc_tr, lab_tr, with the gates of P10; `expect` holds one step's
        launches, `keep_shape` the head's dropout mask. Returns the
        warm-up step's recorded kernel-14 launches and unfused
        `group_points` inputs; with a dict `record`, fills it with the
        inputs of every kernel 11, 12 and 14 launch of all the steps."""
        batch = pc_tr.shape[0]
        model, state = T.create_train_state(
            preset, torch.Generator().manual_seed(args.seed), pc_tr,
            device=dev)
        step = T.make_train_step(model, preset, device=dev)

        def one_step():
            x = augment.augment_batch(
                fit.step_generator(args.seed, state.step, 0, dev), pc_tr)
            return step(state, x, lab_tr, fit.step_generator(
                args.seed, state.step, 1, dev))

        # one step's loss and gradients from the initial state, with
        # kernels 11, 12 and 14 and with their plain versions: the forward
        # is the same arithmetic (the loss within 1e-5); the gradients
        # within 1e-4 of their norms, as the unfused scales' torch.gather
        # backward adds with atomics in a varying order
        snap = copy.deepcopy(model.state_dict())
        x = augment.augment_batch(fit.step_generator(args.seed, 99, 0, dev),
                                  pc_tr)
        keep = torch.rand(keep_shape, generator=torch.Generator(
            device=dev).manual_seed(args.seed), device=dev) < 0.5
        bnm = T.bn_momentum_schedule(preset, 0)
        lk, _, gk = T.loss_and_grads(model, x, lab_tr, bnm, dropout_mask=keep)
        model.load_state_dict(snap)
        with swapped(pallas_fps, "_launch_fps", pallas_fps.fps_plain), \
                swapped(pallas_ballgroup, "_launch_ball_group",
                        pallas_ballgroup.ball_group_plain), \
                swapped(pallas_gather, "_launch_scatter_add_rows",
                        pallas_gather.scatter_add_rows_plain):
            lp, _, gp = T.loss_and_grads(model, x, lab_tr, bnm,
                                         dropout_mask=keep)
        model.load_state_dict(snap)
        dloss, dgrad = abs(float(lk) - float(lp)), grad_err(gk, gp)
        need(dloss <= 1e-5 and dgrad <= 1e-4, name, "vs plain", dloss, dgrad)

        # 2 clouds on the card and on the CPU, every scale through kernel
        # 12 / its plain version (the same neighbours on both sides): the
        # loss within 1e-4 relative and each gradient within cpu_grad_tol
        # of its norm. cuBLAS and the CPU's BLAS sum in other orders, and
        # train-mode BN over 2 clouds amplifies rounding (the port's own
        # float32 gradients are 1e-3 of a norm from float64 there for
        # cls-ssg, 8.4e-3 for semseg-ssg, `tests/test_torch_semseg.py`).
        cpu_model = copy.deepcopy(model).cpu()
        with swapped(pointnet2, "fused_ok", lambda *a: True):
            lk2, _, gk2 = T.loss_and_grads(model, x[:2], lab_tr[:2], bnm,
                                           dropout_mask=keep[:2])
            lc2, _, gc2 = T.loss_and_grads(cpu_model, x[:2].cpu(),
                                           lab_tr[:2].cpu(), bnm,
                                           dropout_mask=keep[:2].cpu())
        model.load_state_dict(snap)
        dcpu = abs(float(lk2) - float(lc2)) / abs(float(lc2))
        gcpu = grad_err(gk2, gc2)
        need(dcpu <= 1e-4 and gcpu <= cpu_grad_tol, name, "vs the CPU",
             dcpu, gcpu)

        before = [p.detach().clone() for p in model.parameters()]
        bn, seen = model.sa[0].mlps[0].bn[0], {}

        def bn_hook(mod, inputs):        # the old and the batch statistics
            x = inputs[0].detach().double()
            dims = tuple(range(x.dim() - 1))
            seen.update(mean=mod.mean.double(), var=mod.var.double(),
                        bmean=x.mean(dims), bvar=x.var(dims, unbiased=False))
        every = contextlib.ExitStack()
        for mod, fn in ((pallas_fps, "_launch_fps"),
                        (pallas_ballgroup, "_launch_ball_group"),
                        (pallas_gather, "_launch_scatter_add_rows")):
            if record is not None:
                record[fn] = every.enter_context(Recorder(mod, fn)).calls
        hook = bn.register_forward_pre_hook(bn_hook)
        with Recorder(pallas_gather, "_launch_scatter_add_rows") as rs, \
                Recorder(pointnet2, "group_points") as rgp:
            out0 = one_step()                                # step 0
            torch.cuda.synchronize()
        hook.remove()
        m = T.bn_momentum_schedule(preset, 0)
        need(m == 0.5, name, "BN momentum at step 0", m)
        bn_err = 0.0
        for k in ("mean", "var"):       # the f64 batch statistics: rtol 1e-5
            want = (1.0 - m) * seen[k] + m * seen["b" + k]
            err = float((getattr(bn, k).double() - want).abs().max()
                        / want.abs().max().clamp_min(1.0))
            need(err <= 1e-5, name, "BN running", k, err)
            bn_err = max(bn_err, err)

        ev2 = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def timed():
            ev2[0].record()
            outs = [one_step() for _ in range(TRAIN_STEPS)]
            ev2[1].record()
            return outs
        torch.cuda.reset_peak_memory_stats()
        outs = paths.run(name, timed, {k: v * TRAIN_STEPS
                                       for k, v in expect.items()})
        every.close()
        step_ms = ev2[0].elapsed_time(ev2[1]) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated()
        losses = [float(o["loss"]) for o in [out0] + outs]
        need(all(np.isfinite(losses)), name, "loss", losses)
        still = sum(torch.equal(a, p) for a, p in zip(before,
                                                      model.parameters()))
        need(still == 0, name, "parameters that did not move", still)
        aug_ms = cuda_ms(lambda: augment.augment_batch(
            fit.step_generator(args.seed, 0, 0, dev), pc_tr), reps=5)

        metrics[name] = dict(
            batch=batch, points=pc_tr.shape[1], steps=TRAIN_STEPS,
            step_ms=step_ms, clouds_per_s=batch / (step_ms / 1e3),
            augment_ms=aug_ms, peak_mem_bytes=peak, losses=losses,
            bn_momentum_err=bn_err, loss_err_vs_plain=dloss,
            grad_err_vs_plain=dgrad, loss_err_vs_cpu=dcpu,
            grad_err_vs_cpu=gcpu)
        print(f"{label} {name} {batch} x {pc_tr.shape[1]} pts: "
              f"{step_ms:.2f} ms per step "
              f"= {metrics[name]['clouds_per_s']:.1f} clouds/s trained "
              f"(augmentation {aug_ms:.2f} ms); peak {peak / 2**30:.2f} GiB;"
              f" losses {', '.join(f'{v:.4f}' for v in losses)}; BN "
              f"momentum {m} (err {bn_err:.1e}); vs plain: loss {dloss:.1e}"
              f", grads {dgrad:.1e}; vs CPU: loss {dcpu:.1e}, grads "
              f"{gcpu:.1e}")
        report["profile_" + name] = profile(name + " step", one_step, torch)
        return rs.calls, [(p.detach(), i) for p, i in rgp.calls]

    r_sc, r_gp = {}, {}
    for label, name, preset, n_bg in (
            ("P10", "train_cls_msg", nncfg.MODELNET40_CLS_MSG, 4),
            ("P11", "train_cls_ssg", nncfg.MODELNET40_CLS_SSG, 2)):
        r_sc[name], r_gp[name] = train_path(
            label, name, preset, pc_tr, lab_tr,
            {"fps_pallas_batched": 2, "ball_group": n_bg,
             "scatter_add_rows": 1}, (CLS_BATCH, 256))
        torch.cuda.empty_cache()

    # ---- P12 fit on the toy task, checkpoint and resume --------------------
    mark("P12 fit on the toy task, checkpoint and resume")
    toy = nncfg.TrainConfig(model="cls-ssg", num_classes=2, num_points=128,
                            batch_size=8, epochs=3, lr=1e-3, decay_step=1e9,
                            seed=args.seed)
    toy_train, toy_val = toy_dataset(32, seed=0), toy_dataset(16, seed=1)
    workdir = ROOT / "build" / "chip_smoke_fit"
    shutil.rmtree(workdir, ignore_errors=True)
    n_steps, n_evals = toy.epochs * (32 // 8), toy.epochs * (16 // 8)
    t0 = time.perf_counter()
    with Recorder(pallas_fps, "_launch_fps") as rf12:
        out12 = paths.run("fit", lambda: fit.fit(
            toy, toy_train, toy_val, workdir=str(workdir),
            augment_pipeline=(), device=dev),
            {"fps_pallas_batched": 2 * (n_steps + n_evals),
             "ball_group": 2 * (n_steps + n_evals),
             "scatter_add_rows": n_steps})
    fit_s = time.perf_counter() - t0
    need(out12["steps"] == n_steps and out12["best_val_acc"] > 0.9, "fit",
         out12["steps"], out12["best_val_acc"])
    latest = ckpt.latest_checkpoint(str(workdir))
    need(latest is not None and latest[1] == out12["best_epoch"] + 1,
         "fit checkpoint", latest)
    more = dataclasses.replace(toy, epochs=toy.epochs + 1)
    out12b = fit.fit(more, toy_train, toy_val, workdir=str(workdir),
                     resume=True, augment_pipeline=(), device=dev)
    per_epoch = 32 // 8
    need(out12b["steps"] == per_epoch * (more.epochs - latest[1])
         and out12b["state"].step == per_epoch * more.epochs, "fit resume",
         out12b["steps"], out12b["state"].step)
    metrics["fit"] = dict(best_val_acc=out12["best_val_acc"],
                          best_epoch=out12["best_epoch"], seconds=fit_s,
                          checkpoint=latest[1],
                          resumed_steps=out12b["steps"],
                          resumed_best_val_acc=out12b["best_val_acc"])
    print(f"P12 fit (toy, cls-ssg, {toy.epochs} epochs): best val acc "
          f"{out12['best_val_acc']:.4f} @ epoch {out12['best_epoch']} in "
          f"{fit_s:.1f} s; checkpoint {latest[1]}; resumed for "
          f"{out12b['steps']} steps to step {out12b['state'].step}")
    check_fps(pallas_fps, rf12.calls, torch)
    toy_sa = [a for a in rf12.calls if a[0].shape[1] < a[1]][:1] + [
        a for a in rf12.calls if a[0].shape[1] > a[1]][:1]
    need(len(toy_sa) == 2, "P12 FPS shapes",
         sorted({(tuple(a[0].shape), a[1]) for a in rf12.calls}))
    print(f"   kernel 11 on P12's {len(rf12.calls)} launches = fps_plain; "
          f"per launch shape:")
    rows["fps_pallas_batched"]["shapes"] = fps_table(pallas_fps, kernels, {
        "SA1 (P7 cls-msg)": r_fps["cls_msg"][0],
        "SA2 (P7 cls-msg)": r_fps["cls_msg"][1],
        "P9 kernel 10": rf10.calls[0],
        "P12 toy SA1 (N < m)": toy_sa[0], "P12 toy SA2": toy_sa[1]},
        torch)

    # ---- kernels 13, 14: group_points_pallas on P10's unfused SA2 inputs --
    mark("kernels 13, 14")
    feats = [(p_, i_) for p_, i_ in r_gp["train_cls_msg"]
             if p_.shape[-1] == 320]
    need([tuple(i_.shape) for _, i_ in feats] == [
        (CLS_BATCH, 128, 64), (CLS_BATCH, 128, 128)], "SA2 group_points",
        [tuple(i_.shape) for _, i_ in feats])
    g_ct = torch.Generator(device=dev).manual_seed(args.seed)
    cts = [torch.randn(tuple(i_.shape) + (320,), generator=g_ct, device=dev)
           for _, i_ in feats]

    def gp_run():
        res = []
        for (p_, i_), ct in zip(feats, cts):
            leaf = p_.clone().requires_grad_()
            out = pallas_gather.group_points_pallas(leaf, i_)
            out.backward(ct)
            res.append((out.detach(), leaf.grad))
        return res
    with Recorder(pallas_gather, "_launch_gather_rows") as r13, \
            Recorder(pallas_gather, "_launch_scatter_add_rows") as r14:
        gp_res = paths.run("group_points_pallas", gp_run,
                           {"gather_rows": 2, "scatter_add_rows": 2})
    gp_err = 0.0
    for (p_, i_), ct, (out, grad) in zip(feats, cts, gp_res):
        # kernel 13 == torch.gather exactly; kernel 14 == its plain version
        # bit for bit and torch.gather's (atomic) backward within 1e-5 of
        # the largest row sum
        need(torch.equal(out, gather.group_points(p_, i_)), "gather_rows")
        b_, m_, k_ = i_.shape
        plain = pallas_gather.scatter_add_rows_plain(
            ct.reshape(b_, m_ * k_, 320), i_.reshape(b_, m_ * k_),
            p_.shape[1])
        need(torch.equal(grad, plain), "scatter_add_rows vs plain")
        q = p_.clone().requires_grad_()
        gather.group_points(q, i_).backward(ct)
        err = float((grad - q.grad).abs().max() / q.grad.abs().max())
        need(err <= 1e-5, "scatter_add_rows vs torch.gather's backward", err)
        gp_err = max(gp_err, err)
    # kernel 12's backward launches of P10 and P11 against the plain version
    for args14 in r_sc["train_cls_msg"] + r_sc["train_cls_ssg"]:
        need(torch.equal(pallas_gather._launch_scatter_add_rows(*args14),
                         pallas_gather.scatter_add_rows_plain(*args14)),
             "ball_group backward vs plain", tuple(args14[0].shape))
    print(f"kernels 13, 14: group_points_pallas on {len(feats)} SA2 inputs "
          f"equal to torch.gather, its backward to the plain version (bit "
          f"for bit; vs torch.gather's backward {gp_err:.1e}); "
          f"{len(r_sc['train_cls_msg']) + len(r_sc['train_cls_ssg'])} "
          "recorded ball_group backward launches equal to the plain version")

    lib13 = [(t_, i_.long()[..., None].expand(-1, -1, t_.shape[2]))
             for t_, i_ in r13.calls]
    rows["gather_rows"] = dict(max_abs_err=0.0, **time_launches(
        pallas_gather._launch_gather_rows, pallas_gather.gather_rows_plain,
        r13.calls, [gather_work(a) for a in r13.calls]))
    rows["gather_rows"]["library_ms"] = cuda_ms(
        lambda: [torch.gather(t_, 1, e_) for t_, e_ in lib13], reps=5)
    main14 = r_sc["train_cls_msg"]          # one P10 step's launch
    flat14 = [(g_.reshape(-1, g_.shape[2]), (
        i_.long() + n_ * torch.arange(g_.shape[0], device=dev)[:, None]
    ).reshape(-1), g_.shape[0] * n_) for g_, i_, n_ in main14]
    rows["scatter_add_rows"] = dict(max_abs_err=0.0, **time_launches(
        pallas_gather._launch_scatter_add_rows,
        pallas_gather.scatter_add_rows_plain, main14,
        [scatter_work(a) for a in main14]))
    rows["scatter_add_rows"]["library_ms"] = cuda_ms(lambda: [
        torch.zeros((rn, g_.shape[1]), device=dev).index_add_(0, fi, g_)
        for g_, fi, rn in flat14], reps=5)
    rows["scatter_add_rows"]["shapes"] = scatter_table(
        pallas_gather, kernels, {
            "P10 cls-msg SA2 fused": r_sc["train_cls_msg"][0],
            "P11 cls-ssg SA2": r_sc["train_cls_ssg"][0],
            "phase M 8192": r14.calls[0], "phase M 16384": r14.calls[1]},
        torch)
    rows["gather_rows"]["per_launch_ms"] = [
        cuda_ms(lambda a=a: pallas_gather._launch_gather_rows(*a), reps=5)
        for a in r13.calls]

    # ---- P16, P17 segmentation serving: kernels 11, 12 --------------------
    mark("P16, P17 segmentation serving")
    rooms, room_labels = indoor_rooms(np.random.default_rng([args.seed, 16]),
                                      SEM_REQUESTS * SEM_BATCH, SEM_POINTS)
    room_set = list(zip(rooms, room_labels))
    pc_s, lab_s = on_dev(rooms[:SEM_BATCH], room_labels[:SEM_BATCH])
    r_sfps, r_sbg = {}, {}
    for label, name, preset, n_bg in (
            ("P16", "semseg_ssg", nncfg.S3DIS_SEMSEG_SSG, 4),
            ("P17", "semseg_msg", nncfg.S3DIS_SEMSEG_MSG, 7)):
        model = T.build_model(preset, device=dev, generator=torch.Generator(
            ).manual_seed(args.seed))
        ev = T.make_eval_step(model, dev)
        ev(pc_s, lab_s)                                         # warm-up
        with Recorder(pallas_fps, "_launch_fps") as rf, \
                Recorder(pallas_ballgroup, "_launch_ball_group") as rg:
            res = paths.run(name, lambda: fit.evaluate(
                model, room_set, SEM_BATCH, device=dev),
                {"fps_pallas_batched": 4 * SEM_REQUESTS,
                 "ball_group": n_bg * SEM_REQUESTS})
        r_sfps[name], r_sbg[name] = rf.calls, rg.calls
        need(np.isfinite(res["loss"]) and 0.0 <= res["acc"] <= 1.0, name, res)
        logits = ev(pc_s, lab_s)["logits"]
        need(logits.shape == (SEM_BATCH, SEM_POINTS, preset.num_classes)
             and bool(torch.isfinite(logits).all()), name, "logits")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: ev(pc_s, lab_s), reps=5)
        peak = torch.cuda.max_memory_allocated()
        with swapped(pallas_fps, "_launch_fps", pallas_fps.fps_plain), \
                swapped(pallas_ballgroup, "_launch_ball_group",
                        pallas_ballgroup.ball_group_plain):
            dlog = float((ev(pc_s, lab_s)["logits"] - logits).abs().max())
        need(dlog <= 1e-5, name, "logits vs plain versions", dlog)
        # SEM_CPU clouds on the card and on the CPU, every scale through
        # kernel 12 / its plain version: within 1e-4 (three-NN's distances
        # round alike on both, tests/test_torch_cuda.py)
        cpu_model = copy.deepcopy(model).cpu()
        with swapped(pointnet2, "fused_ok", lambda *a: True), \
                torch.no_grad():
            dcpu = float((model(pc_s[:SEM_CPU]).cpu() - cpu_model(
                pc_s[:SEM_CPU].cpu())).abs().max())
        need(dcpu <= 1e-4, name, "logits vs the CPU", dcpu)
        metrics[name] = dict(
            requests=SEM_REQUESTS, batch=SEM_BATCH, points=SEM_POINTS,
            loss=res["loss"], acc=res["acc"], batch_ms=ms,
            clouds_per_s=SEM_BATCH / (ms / 1e3), peak_mem_bytes=peak,
            logits_err_vs_plain=dlog, logits_err_vs_cpu=dcpu,
            kernel12_scales=n_bg)
        print(f"{label} {name} {SEM_REQUESTS} x {SEM_BATCH} x {SEM_POINTS} "
              f"pts x 9: loss {res['loss']:.4f}, acc {res['acc']:.4f} "
              f"(random weights); {ms:.2f} ms per batch = "
              f"{metrics[name]['clouds_per_s']:.1f} clouds/s; peak "
              f"{peak / 2**30:.2f} GiB; logits vs plain {dlog:.1e}, vs CPU "
              f"({SEM_CPU} clouds) {dcpu:.1e}")
        report["profile_" + name] = profile(name, lambda: ev(pc_s, lab_s),
                                            torch)
        del model, cpu_model, ev
        torch.cuda.empty_cache()

    # ---- P18 semseg-ssg training: kernels 11, 12, 14 ----------------------
    mark("P18 semseg-ssg training")
    rec18 = {}
    r_sc["train_semseg_ssg"], _ = train_path(
        "P18", "train_semseg_ssg", nncfg.S3DIS_SEMSEG_SSG, pc_s, lab_s,
        {"fps_pallas_batched": 4, "ball_group": 4, "scatter_add_rows": 3},
        (SEM_BATCH, SEM_POINTS, 128), cpu_grad_tol=5e-2, record=rec18)
    torch.cuda.empty_cache()

    # every kernel 11, 12 and 14 launch of P16-P18 against its plain version
    sem_fps = r_sfps["semseg_ssg"] + r_sfps["semseg_msg"] + rec18["_launch_fps"]
    sem_bg = (r_sbg["semseg_ssg"] + r_sbg["semseg_msg"]
              + rec18["_launch_ball_group"])
    with torch.no_grad():
        check_fps(pallas_fps, sem_fps, torch)
        sbg_err, sbg_boundary, sbg_work = check_ball_group(
            pallas_ballgroup, ball_query, gather, sem_bg, torch)
    for args14 in rec18["_launch_scatter_add_rows"]:
        need(torch.equal(pallas_gather._launch_scatter_add_rows(*args14),
                         pallas_gather.scatter_add_rows_plain(*args14)),
             "P18 ball_group backward vs plain", tuple(args14[0].shape))
    need(len(rec18["_launch_scatter_add_rows"]) == 3 * (TRAIN_STEPS + 1),
         "P18 kernel 14 launches", len(rec18["_launch_scatter_add_rows"]))
    fwd16 = slice(0, 4)             # one P16 forward's launches
    sem_rows = dict(
        fps=time_launches(pallas_fps._launch_fps, pallas_fps.fps_plain,
                          r_sfps["semseg_ssg"][fwd16],
                          [fps_work(a) for a in r_sfps["semseg_ssg"][fwd16]]),
        ball_group=time_launches(
            pallas_ballgroup._launch_ball_group,
            pallas_ballgroup.ball_group_plain, r_sbg["semseg_ssg"][fwd16],
            sbg_work[:4]),
        ball_group_shapes=[[list(a[0].shape), list(a[1].shape), a[2], a[3]]
                           for a in r_sbg["semseg_ssg"][fwd16]
                           + r_sbg["semseg_msg"][:7]])
    rows["fps_pallas_batched"]["semseg_ssg_forward"] = sem_rows["fps"]
    rows["ball_group"]["semseg_ssg_forward"] = sem_rows["ball_group"]
    rows["ball_group"]["semseg_shapes"] = sem_rows["ball_group_shapes"]
    rows["ball_group"]["max_abs_err"] = max(rows["ball_group"]["max_abs_err"],
                                            sbg_err)
    print(f"kernels 11, 12, 14 vs plain on P16-P18: FPS idx identical on "
          f"{len(sem_fps)} launches, ball_group equal on {len(sem_bg)} "
          f"({sbg_boundary} centres with a boundary point vs ball_query), "
          f"kernel 14 bit-equal on "
          f"{len(rec18['_launch_scatter_add_rows'])}; one semseg-ssg "
          f"forward: kernel 11 {sem_rows['fps']['ms']:.4f} ms (bound "
          f"{sem_rows['fps']['bound_ms']:.4f}), kernel 12 "
          f"{sem_rows['ball_group']['ms']:.4f} ms (bound "
          f"{sem_rows['ball_group']['bound_ms']:.4f})")

    # ---- P19 bench.py workload 6: window grouping and bf16, no kernel ----
    mark("P19 bench.py workload 6")
    w6_rooms = pointnet2.morton_sort_packed(torch.cat(
        [pc_s[:W6_SEM_BATCH], lab_s[:W6_SEM_BATCH, :, None].float()], -1))
    for name, model_name, pc_w, lab_w, classes, tol in (
            ("w6_cls_ssg", "cls-ssg", pc_tr, lab_tr, 40, 1e-2),
            ("w6_semseg_ssg", "semseg-ssg", w6_rooms[..., :9].contiguous(),
             w6_rooms[..., 9].long(), 13, 1e-4)):
        # bench.py:375-377: the configuration workload 6 trains
        w6 = nncfg.TrainConfig(model=model_name, num_classes=classes,
                               num_points=pc_w.shape[1],
                               batch_size=pc_w.shape[0], grouping="window",
                               compute_dtype="bfloat16", seed=args.seed)
        model, state = T.create_train_state(
            w6, torch.Generator().manual_seed(args.seed), pc_w, device=dev)
        dtypes = {m.dtype for m in model.modules()
                  if isinstance(m, pointnet2.SharedMLP)}
        step = T.make_train_step(model, w6, device=dev)

        def w6_step():
            return step(state, pc_w, lab_w, fit.step_generator(
                args.seed, state.step, 1, dev))
        out0 = w6_step()                                        # warm-up
        ev2 = [torch.cuda.Event(enable_timing=True) for _ in range(2)]

        def w6_timed():
            ev2[0].record()
            outs = [w6_step() for _ in range(TRAIN_STEPS)]
            ev2[1].record()
            return outs
        torch.cuda.reset_peak_memory_stats()
        outs = paths.run(name, w6_timed, {})            # no kernel runs
        step_ms = ev2[0].elapsed_time(ev2[1]) / TRAIN_STEPS
        peak = torch.cuda.max_memory_allocated()
        losses = [float(o["loss"]) for o in [out0] + outs]
        need(all(np.isfinite(losses)), name, "loss", losses)
        # 2 clouds on the card and on the CPU, eval mode: bf16 products
        # within 1e-2 of the largest logit (at least 1;
        # tests/test_torch_window.py's bf16 bound), float32 within 1e-4
        cpu_model = copy.deepcopy(model).cpu().eval()
        model.eval()
        with torch.no_grad():
            ref_w = cpu_model(pc_w[:2].cpu())
            dcpu = float((model(pc_w[:2]).cpu() - ref_w).abs().max())
        if w6.compute_dtype == "bfloat16" and model_name.startswith("cls"):
            tol *= max(1.0, float(ref_w.abs().max()))
        need(dcpu <= tol, name, "logits vs the CPU", dcpu, tol)
        metrics[name] = dict(
            batch=pc_w.shape[0], points=pc_w.shape[1], steps=TRAIN_STEPS,
            step_ms=step_ms, clouds_per_s=pc_w.shape[0] / (step_ms / 1e3),
            peak_mem_bytes=peak, losses=losses, logits_err_vs_cpu=dcpu,
            mlp_dtypes=sorted(str(d) for d in dtypes))
        print(f"P19 workload 6 {model_name} {pc_w.shape[0]} x "
              f"{pc_w.shape[1]} pts, window grouping, compute_dtype "
              f"bfloat16 (MLPs in {', '.join(sorted(map(str, dtypes)))}): "
              f"{step_ms:.2f} ms per step = "
              f"{metrics[name]['clouds_per_s']:.1f} clouds/s trained; peak "
              f"{peak / 2**30:.2f} GiB; losses "
              f"{', '.join(f'{v:.4f}' for v in losses)}; logits vs CPU "
              f"{dcpu:.1e} (limit {tol}); no kernel launched")
        report["profile_" + name] = profile(name + " step", w6_step, torch)
        del model, cpu_model, state, step
        torch.cuda.empty_cache()

    # ---- P13 the SLAM loop: bench.py workload 5 (K1, then K2-K4) ----------
    mark("P13 the SLAM loop")
    rng13 = np.random.default_rng(5)                    # bench.py:301
    world13 = slam_world(rng13)
    gt13 = circle_poses(ODO_FRAMES, 6.0)
    scans13 = render_scans(world13, gt13, rng13, 20.0)
    cfg13 = odometry.OdometryConfig(**ODO_CFG)

    def p13_run():
        return odometry.run_odometry(scans13, cfg13)
    p13_run()                                           # warm-up
    with recording_k1_k4(pallas_nn, pallas_fpfh, mega) as rec13:
        t0 = time.perf_counter()
        out13 = paths.run("slam", p13_run,
                          lambda o: odometry_launches(o, cfg13, ODO_FRAMES))
        p13_s = time.perf_counter() - t0
    ate_raw, ate_opt = (odometry.ate(out13[k], gt13)
                        for k in ("poses", "poses_optimized"))
    # bench.py:347-354: the closed loop, not the front end's chain
    need(len(out13["closures"]) >= 1, "slam: no closure accepted",
         out13["closures_rejected"])
    need(ate_opt < ate_raw and ate_opt < 0.8, "slam ATE", ate_raw, ate_opt)
    split13 = {}
    with timed_calls(odometry, "odometry_deltas_scan", split13, torch), \
            timed_calls(pipeline, "register_pairs", split13, torch), \
            timed_calls(odometry, "_closure_validate_batch", split13, torch), \
            timed_calls(odometry, "optimize_pose_graph", split13, torch):
        t0 = time.perf_counter()
        p13_run()
        split13["total"] = time.perf_counter() - t0
    report["profile_slam"] = profile("slam", p13_run, torch)
    # the front end alone, on run_odometry's own inputs, with K1 and with
    # its plain version: the same deltas; and the same poses as P13's run
    cap13 = round_up(max(len(x) for x in scans13), 2048)
    pc13 = [odometry._prep(x, cap13, cfg13.voxel_leaf, dev) for x in scans13]
    pts13 = torch.stack([c.points for c in pc13])
    msk13 = torch.stack([c.mask for c in pc13])
    nrm13 = fpfh_dense.normals_radius_dense(pts13, msk13,
                                            radius=2.5 * cfg13.voxel_leaf)
    fe_kw = dict(iters=cfg13.icp_iters, dist_thresh=cfg13.icp_dist_thresh,
                 query_chunk=cfg13.query_chunk)
    deltas13 = odometry.odometry_deltas_scan(pts13, msk13, nrm13, **fe_kw)
    fe_ms = cuda_ms(lambda: odometry.odometry_deltas_scan(
        pts13, msk13, nrm13, **fe_kw), reps=3)
    with swapped(pallas_nn, "nn1", pallas_nn.nearest_plain):
        deltas13p = odometry.odometry_deltas_scan(pts13, msk13, nrm13, **fe_kw)
    fe_err = float((deltas13 - deltas13p).abs().max())
    need(fe_err <= 1e-4, "slam front end vs plain K1", fe_err)
    chain_err = float(np.abs(odometry.compose_deltas(deltas13).cpu().numpy()
                             - out13["poses"]).max())
    need(chain_err <= 1e-6, "slam front end vs run_odometry", chain_err)
    k13 = check_path_kernels(mods, rec13, torch, strict=False)
    need(max(k13["nn1"]["batch_sizes"]) > 1 and "icp_mega_batch" in k13,
         "slam: no closure batch among the checked launches", k13)
    metrics["slam"] = dict(
        frames=ODO_FRAMES, seconds=p13_s, frames_per_s=ODO_FRAMES / p13_s,
        ate_raw=ate_raw, ate_optimized=ate_opt,
        closures=len(out13["closures"]),
        closures_rejected=len(out13["closures_rejected"]),
        closure_candidates=out13["closure_candidates"],
        points_per_frame=int(msk13.sum(1).float().mean()), capacity=cap13,
        frontend_ms=fe_ms, frontend_frames_per_s=ODO_FRAMES / (fe_ms / 1e3),
        frontend_err_vs_plain=fe_err, split_s=split13,
        launches=paths.launches["slam"], kernels_vs_plain=k13)
    print(f"P13 SLAM (bench.py workload 5, {ODO_FRAMES} frames, "
          f"{metrics['slam']['points_per_frame']} voxels a frame): "
          f"{p13_s:.3f} s = {ODO_FRAMES / p13_s:.2f} frames/s; ATE raw "
          f"{ate_raw:.4f} m, optimized {ate_opt:.4f} m; closures "
          f"{len(out13['closures'])} accepted, "
          f"{len(out13['closures_rejected'])} rejected (candidates "
          f"{out13['closure_candidates']}); launches "
          f"{paths.launches['slam']}; front end {fe_ms:.1f} ms = "
          f"{ODO_FRAMES / (fe_ms / 1e3):.1f} frames/s, deltas vs plain K1 "
          f"{fe_err:.1e}; split (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in split13.items()))
    print(kernels_line("P13", k13))
    if "fpfh" in k13:
        print(fpfh_line("P13", k13["fpfh"]))
        metrics["fpfh_launches"]["P13 round 0"] = k13["fpfh"]

    # ---- P14 the >100-keyframe graph: sparse PCG on the card ----------------
    mark("P14 the >100-keyframe graph")
    rng14 = np.random.default_rng(0)                    # the test's rng
    world14 = slam_world(rng14, 1500, 125)
    gt14 = figure_eight_poses(128)
    scans14 = render_scans(world14, gt14, rng14, 12.0)
    path_len = float(np.linalg.norm(np.diff(gt14[:, :3, 3], axis=0),
                                    axis=1).sum())
    cfg14 = odometry.OdometryConfig(
        voxel_leaf=0.5, icp_iters=15, icp_dist_thresh=3.0, keyframe_every=1,
        closure_radius=2.0, closure_min_gap=24, query_chunk=1024,
        closure_reg_capacity=1024)                  # tests/test_odometry.py
    split14 = {}
    t0 = time.perf_counter()
    with timed_calls(odometry, "odometry_deltas_scan", split14, torch), \
            timed_calls(pipeline, "register_pairs", split14, torch), \
            timed_calls(odometry, "_closure_validate_batch", split14, torch), \
            timed_calls(odometry, "optimize_pose_graph_sparse", split14,
                        torch), \
            recording_k1_k4(pallas_nn, pallas_fpfh, mega) as rec14:
        out14 = paths.run("slam_figure_eight",
                          lambda: odometry.run_odometry(scans14, cfg14),
                          lambda o: odometry_launches(o, cfg14, 128))
    p14_s = time.perf_counter() - t0
    cl14 = out14["closures"]
    raw14, opt14 = (odometry.ate(out14[k], gt14)
                    for k in ("poses", "poses_optimized"))
    need(len(out14["keyframes"]) > 100 and len(cl14) >= 2
         and max(b - a for a, b in cl14) >= 24, "figure-eight closures",
         len(out14["keyframes"]), cl14)
    need(opt14 <= max(raw14, 0.02 * path_len) and opt14 < 0.02 * path_len,
         "figure-eight ATE", raw14, opt14, path_len)
    # the final graph once more, in float32 and in float64
    kf14 = out14["poses"][out14["keyframes"]]
    gkw = dict(iters=cfg14.pose_graph_iters, cg_iters=max(400, 3 * len(kf14)),
               robust_delta=cfg14.robust_delta,
               robust_warmup=cfg14.robust_warmup)
    ev14 = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev14[0].record()
    g32 = posegraph.optimize_pose_graph_sparse(kf14, *out14["edges"], **gkw)
    ev14[1].record()
    g64 = posegraph.optimize_pose_graph_sparse_f64(kf14, *out14["edges"],
                                                   **gkw)
    ev14[2].record()
    torch.cuda.synchronize()
    d64 = float((g32.poses - g64.poses)[:, :3, 3].norm(dim=-1).max())
    need(bool(torch.isfinite(g64.poses).all()) and d64 < 1e-2,
         "figure-eight f64 vs f32 solve", d64)
    k14 = check_path_kernels(mods, rec14, torch, strict=False)
    need(max(k14["nn1"]["batch_sizes"]) > 1 and "icp_mega_batch" in k14,
         "figure-eight: no closure batch among the checked launches", k14)
    metrics["slam_figure_eight"] = dict(
        frames=128, seconds=p14_s, keyframes=len(out14["keyframes"]),
        closures=len(cl14), max_closure_gap=max(b - a for a, b in cl14),
        closure_candidates=out14["closure_candidates"], ate_raw=raw14,
        ate_optimized=opt14, path_length=path_len, split_s=split14,
        sparse_f32_ms=ev14[0].elapsed_time(ev14[1]),
        sparse_f64_ms=ev14[1].elapsed_time(ev14[2]),
        f64_vs_f32_max_translation=d64,
        launches=paths.launches["slam_figure_eight"], kernels_vs_plain=k14)
    m14 = metrics["slam_figure_eight"]
    print(f"P14 figure-eight (128 frames, {m14['keyframes']} keyframes, "
          f"sparse graph): {p14_s:.2f} s; closures {len(cl14)} (max gap "
          f"{m14['max_closure_gap']}, candidates "
          f"{out14['closure_candidates']}); ATE raw {raw14:.4f} m, "
          f"optimized {opt14:.4f} m (< {0.02 * path_len:.4f}); f64 vs f32 "
          f"solve {d64:.2e} m ({m14['sparse_f32_ms']:.0f} / "
          f"{m14['sparse_f64_ms']:.0f} ms); split (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in split14.items()))
    print(kernels_line("P14", k14))
    if "fpfh" in k14:
        print(fpfh_line("P14", k14["fpfh"]))
        metrics["fpfh_launches"]["P14 round 0"] = k14["fpfh"]

    # ---- P15 the registration-dataset driver on P1's pairs -----------------
    mark("P15 the registration-dataset driver on P1's pairs")
    reg_dir = ROOT / "build" / "chip_smoke_reg"
    shutil.rmtree(reg_dir, ignore_errors=True)
    (reg_dir / "point_clouds").mkdir(parents=True)
    clouds15 = torch.cat([dst.points, src.points])          # 2i dst, 2i+1 src
    nrm15 = fpfh_dense.normals_radius_dense(
        clouds15, torch.ones(clouds15.shape[:2], dtype=torch.bool,
                             device=dev), radius=cfg.normal_radius)
    rows15 = torch.cat([clouds15, nrm15], dim=-1).cpu().numpy()
    pairs15 = [(2 * i, 2 * i + 1) for i in range(BATCH)]
    for i in range(BATCH):
        rows15[i].tofile(reg_dir / "point_clouds" / f"{2 * i}.bin")
        rows15[BATCH + i].tofile(reg_dir / "point_clouds" / f"{2 * i + 1}.bin")
    (reg_dir / "pairs.txt").write_text(
        "idx1,idx2\n" + "".join(f"{a},{b}\n" for a, b in pairs15))
    io.write_reg_results(str(reg_dir / "gt.txt"), [
        pipeline.result_row(a, b, gts[i]) for i, (a, b) in enumerate(pairs15)])
    with recording_k1_k4(pallas_nn, pallas_fpfh, mega) as rec15:
        t0 = time.perf_counter()
        res15 = paths.run(
            "registration_driver", lambda: registration_driver.main(
                ["--dataset", str(reg_dir), "--pairs",
                 str(reg_dir / "pairs.txt"), "--output",
                 str(reg_dir / "result.txt"), "--gt", str(reg_dir / "gt.txt"),
                 "--batch-size", "8"]),
            {"nn1": 2, "spfh": 4, "wsum": 4, "icp_mega_batch": 4,
             "ransac_refine": 2})
        p15_s = time.perf_counter() - t0
    # every pair within the bound; the reference's success rate divides
    # by the row count with its header (evaluate_rt.py:106), so 16 of 16
    # reads 16/17
    need(res15["n_failed"] == 0 and res15["eval"]["n_success"] == BATCH,
         "registration driver", res15["n_failed"], res15["eval"])
    k15 = check_path_kernels(mods, rec15, torch)
    metrics["registration_driver"] = dict(
        pairs=res15["n_pairs"], failed=res15["n_failed"], seconds=p15_s,
        kernels_vs_plain=k15, **res15["eval"])
    print(f"P15 registration driver ({BATCH} pairs of oxford .bin files, "
          f"batch 8): {res15['n_failed']} failed, "
          f"{res15['eval']['n_success']} of {BATCH} within the bound "
          f"(success_rate {res15['eval']['success_rate']:.4f} with the "
          f"header row), avg RTE {res15['eval']['avg_rte']:.4f} m; "
          f"{p15_s:.2f} s")
    print(kernels_line("P15", k15))
    if "fpfh" in k15:
        print(fpfh_line("P15", k15["fpfh"]))
        metrics["fpfh_launches"]["P15 driver"] = k15["fpfh"]
    for name in ("nn1", "spfh", "wsum", "icp_mega_batch"):
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]]
            + [k[name]["max_abs_err"] for k in (k13, k14, k15) if name in k])

    # ---- K1 per launch at every path's shapes ------------------------------
    mark("K1 per launch at every path's shapes")
    print("K1 per launch at the paths' shapes (device time, CUDA graph):")
    metrics["nn1_launches"] = nn1_table(pallas_nn, {
        "P1 register_pairs": r_nn.calls[:1],
        "P3 exact refine": r_nn_w4.calls[:1],
        "P13 front end": [next(a for a in rec13["nn1"].calls
                               if a[0].shape[0] == 1)],
        "P13 all launches": rec13["nn1"].calls,
        "P14 all launches": rec14["nn1"].calls}, kernels.sm_count(dev), torch)
    prof13 = {r["name"].replace("(anonymous namespace)::", "").split("(")[0]:
              r for r in report["profile_slam"].get("by_kernel", [])
              if "nn1" in r["name"]}
    metrics["nn1_launches"]["P13 profiler"] = dict(
        ms=sum(r["ms"] for r in prof13.values()),
        kernels={k: r["count"] for k, r in prof13.items()})
    print(f"   K1 in P13's profiled call: "
          f"{metrics['nn1_launches']['P13 profiler']['ms']:.2f} ms ("
          + ", ".join(f"{k} x{r['count']}" for k, r in prof13.items()) + ")")

    # ---- K4 / kernel 5: every recorded launch of every path ----------------
    mark("K4 / kernel 5")
    print("K4 / kernel 5, each recorded launch timed alone:")
    metrics["icp_mega_launches"] = mega_launch_table(mega, {
        "P1 register_pairs": r_k4.calls, "P2 workload 1": r_k5.calls,
        "P3 workload 4": r_k5w4.calls, "P4 workload 2": r_k4w2.calls,
        "P6 register_pair": r_k5p6.calls, "P13 SLAM": rec13["icp_mega"].calls,
        "P14 figure-eight": rec14["icp_mega"].calls,
        "P15 driver": rec15["icp_mega"].calls})
    fixed = {}
    for name, calls in (("P2 workload 1", r_k5.calls),
                        ("P1 register_pairs", r_k4.calls)):
        fixed[name] = mega_fixed_cost(mega, calls[0])
        print(f"   fixed cost per iteration at {name}'s first launch "
              f"({fixed[name][1]} CTAs): {fixed[name][0] * 1e3:.2f} us")
    metrics["icp_mega_fixed_ms_per_iter"] = fixed

    # ---- kernel 9: normals_radius_fused on P13's frames and P1's clouds -----
    mark("kernel 9")
    vox = [voxel.voxel_downsample_capped(pc.points, pc.mask, cfg.voxel_size,
                                         cfg.downsample_capacity)[0]
           for pc in (src, dst)]
    pts1 = torch.cat([v.points for v in vox]).contiguous()
    msk1 = torch.cat([v.mask for v in vox]).contiguous()
    k9_cases = {"slam_frames": (pts13, msk13, 2.5 * cfg13.voxel_leaf, {}),
                "register_pairs_voxels": (
                    pts1, msk1, cfg.normal_radius,
                    dict(x_banded=True, x_slack=cfg.voxel_size))}

    def k9_run():
        nf = {k: pallas_fpfh.normals_radius_fused(p_, m_, radius=r_, **kw_)
              for k, (p_, m_, r_, kw_) in k9_cases.items()}
        # the reference's opt-in: K9's normals into the banded descriptor
        feats = pallas_fpfh.fpfh_fused(
            pts1, msk1, normals=nf["register_pairs_voxels"],
            radius=cfg.feature_radius, x_banded=True, x_slack=cfg.voxel_size)
        return nf, feats
    with Recorder(pallas_fpfh, "moments") as r9, \
            Recorder(pallas_fpfh, "spfh") as r9s, \
            Recorder(pallas_fpfh, "wsum") as r9w:
        nf9, feats9 = paths.run("normals_fused", k9_run,
                                {"moments": 2, "spfh": 1, "wsum": 1})
    need(bool(torch.isfinite(feats9).all()), "fpfh with fused normals")
    fp9 = check_fpfh(mods, r9s.calls, r9w.calls, torch, timed=False)
    for name in ("spfh", "wsum"):
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"],
                                        fp9[name]["max_abs_err"])
    print(fpfh_line("the kernel-9 phase", fp9))
    metrics["fpfh_launches"]["kernel-9 phase"] = fp9
    k9 = {}
    for (case, (p_, m_, r_, kw_)), a9 in zip(k9_cases.items(), r9.calls):
        amat, dbmat, cent, base, nt, q_tile, db_tile, r2 = a9
        mk, mp_ = pallas_fpfh.moments(*a9), pallas_fpfh.moments_plain(*a9)
        torch.cuda.synchronize()
        err, unequal, ulp1 = ulp_check(mk, mp_, torch)
        need(ulp1, "moments vs plain beyond one ulp", case, err)
        # the count channel equal: no pair within the radius was pruned
        need(torch.equal(mk[..., 9], mp_[..., 9]), "moments counts", case)
        need(torch.equal(pallas_fpfh.moments(*a9), mk), "moments repeat",
             case)
        # normals against the dense reference default where the least
        # eigenvector is well defined: at least 3 neighbours, lambda1 >
        # 10 lambda0, and a gap lambda1 - lambda0 above 1000 eps_f32
        # E|p|^2, the cancellation error of the dense path's raw moments
        mom = mp_[:, :p_.shape[1]].double()
        cnt = mom[..., 9].clamp_min(1.0)
        mu, exx = mom[..., :3] / cnt[..., None], mom[..., 3:9] / cnt[..., None]
        cov = torch.stack([
            exx[..., 0] - mu[..., 0] ** 2, exx[..., 3] - mu[..., 0] * mu[..., 1],
            exx[..., 4] - mu[..., 0] * mu[..., 2],
            exx[..., 3] - mu[..., 0] * mu[..., 1], exx[..., 1] - mu[..., 1] ** 2,
            exx[..., 5] - mu[..., 1] * mu[..., 2],
            exx[..., 4] - mu[..., 0] * mu[..., 2],
            exx[..., 5] - mu[..., 1] * mu[..., 2],
            exx[..., 2] - mu[..., 2] ** 2], dim=-1).reshape(
                mom.shape[:2] + (3, 3))
        lam = torch.linalg.eigvalsh(cov.cpu()).to(dev)   # a check only
        rows_c = torch.arange(mom.shape[1], device=dev) // q_tile
        p2 = ((mu + cent[:, rows_c].double()) ** 2).sum(-1) + lam.sum(-1)
        well = (m_ & (mom[..., 9] >= 3)
                & (lam[..., 1] > 10 * lam[..., 0].clamp_min(0.0))
                & (lam[..., 1] - lam[..., 0] > 1e3 * 2.0 ** -23 * p2))
        dense = fpfh_dense.normals_radius_dense(p_, m_, radius=r_)
        dots = (nf9[case] * dense).sum(-1).abs()[well]
        # 1 - |dot| < 1e-4 (about 0.8 degrees): 25x the largest value
        # measured on these inputs (4e-6, H100), far below what a wrong
        # centroid shift gives
        gap = 1.0 - float(dots.min())
        need(gap < 1e-4, "fused vs dense normals", case, gap)
        ops, byt, pairs = moments_work(a9, mp_)
        bms, by = bound(byt, ops)
        plan = pallas_fpfh.moments_plan(
            amat.shape[0], amat.shape[1], q_tile,
            torch.cuda.get_device_properties(0).multi_processor_count)
        k9[case] = dict(
            shape=list(amat.shape), max_abs_err=err, unequal=unequal,
            checked_normals=int(well.sum()),
            excluded_normals=int((m_ & ~well).sum()),
            min_dot_vs_dense=float(dots.min()), plan=plan,
            ms=graph_ms([lambda a=a9: pallas_fpfh.moments(*a)] * 10) / 10,
            events_ms=cuda_ms(lambda a=a9: pallas_fpfh.moments(*a),
                              reps=10),
            plain_ms=cuda_ms(lambda a=a9: pallas_fpfh.moments_plain(*a),
                             reps=2),
            dense_ms=cuda_ms(lambda: fpfh_dense.normals_radius_dense(
                p_, m_, radius=r_), reps=5),
            fused_normals_ms=cuda_ms(lambda: pallas_fpfh.normals_radius_fused(
                p_, m_, radius=r_, **kw_), reps=5),
            bound_ms=bms, bound_by=by, **pairs)
        print(f"kernel 9 on {case} {list(amat.shape)}: vs plain max |err| "
              f"{err:.1e}, {unequal} of {mk.numel()} entries unequal (all "
              f"within 1 ulp), counts equal, a repeat bit for bit; normals "
              f"vs dense max 1 - |dot| {gap:.1e} "
              f"(limit 1e-4, margin {1e-4 / max(gap, 1e-12):.0f}x) on "
              f"{int(well.sum())} well-conditioned points "
              f"({k9[case]['excluded_normals']} excluded); "
              f"{k9[case]['ms'] * 1e3:.2f} us device time "
              f"({plan['ctas']} CTAs of {plan['threads']}, "
              f"{plan['warp_queries']} queries a warp; "
              f"{k9[case]['events_ms']:.3f} ms by CUDA events); pairs: "
              f"{pairs['in_band']:,} in the band, {pairs['x_slab']:,} in "
              f"the x-slab, {pairs['within']:,.0f} within; bound "
              f"{bms * 1e3:.2f} us ({by}); plain "
              f"{k9[case]['plain_ms']:.1f} ms; normals: fused "
              f"{k9[case]['fused_normals_ms']:.3f} ms, dense "
              f"{k9[case]['dense_ms']:.3f} ms")
    metrics["normals_fused"] = k9
    rows["moments"] = dict(
        max_abs_err=max(v["max_abs_err"] for v in k9.values()),
        ms=sum(v["ms"] for v in k9.values()),
        plain_ms=sum(v["plain_ms"] for v in k9.values()),
        bound_ms=sum(v["bound_ms"] for v in k9.values()),
        bound_by="operations" if all(v["bound_by"] == "operations"
                                     for v in k9.values()) else "bytes",
        library_ms=None, per_case=k9)

    # ---- P20 segmentation of the full scan (no kernel) --------------------
    mark("P20 segmentation of the full scan (no kernel)")
    seg_cfg = segmentation.SegmentationConfig()
    pc20 = PointCloud.from_numpy(full, device=dev)

    def seg_full():
        return segmentation.segment_ground_and_objects(
            pc20.points, pc20.mask,
            generator=torch.Generator(device=dev).manual_seed(args.seed),
            cfg=seg_cfg)

    seg_full()                                                  # warm-up
    t0 = time.perf_counter()
    out20 = paths.run("segmentation", seg_full, {})
    seg_s = time.perf_counter() - t0
    again = seg_full()
    need(all(torch.equal(a, b) for a, b in zip(out20, again)),
         "P20 a second run with the same draws")
    # the stages apart: normals (k-NN), the plane (RANSAC), DBSCAN
    n_ms, normals20 = events_ms(lambda: estimate_normals(
        pc20.points, mask=pc20.mask, k=seg_cfg.normal_k), torch)
    r_ms, (ground20, plane20) = events_ms(lambda: segment_ground(
        pc20.points, mask=pc20.mask, dist_thresh=seg_cfg.ground_dist,
        num_hypotheses=seg_cfg.ransac_hypotheses,
        generator=torch.Generator(device=dev).manual_seed(args.seed),
        normals=normals20, z_cos_thresh=seg_cfg.z_cos_thresh), torch)
    fg20 = pc20.mask & ~ground20 & segmentation.in_fov(pc20.points, seg_cfg)
    d_ms, ids20 = events_ms(lambda: dbscan(
        pc20.points, seg_cfg.dbscan_eps, seg_cfg.dbscan_min_pts, mask=fg20,
        k_cap=seg_cfg.dbscan_k_cap), torch)
    need(torch.equal(ground20, out20.ground_mask)
         and torch.equal(torch.where(fg20, ids20, -1), out20.object_ids),
         "P20 stages apart = segment_ground_and_objects")
    nz, off = abs(float(plane20.normal[2])), float(plane20.offset)
    low = pc20.mask & (pc20.points[:, 2] < 0.05)
    low_ground = float((out20.ground_mask & low).sum() / low.sum())
    obj20 = out20.object_ids[out20.object_ids >= 0]
    n_obj20 = int(torch.unique(obj20).numel())
    need(nz > 0.99 and n_obj20 >= 1, "P20 plane, objects", nz, n_obj20)
    if not args.scan:       # the synthetic scan: ground z = 0, sensor 1.73 m
        need(abs(off) < 0.1 and low_ground >= 0.9, "P20 ground", off,
             low_ground)
    # one mini-world frame on the card and on the CPU, the same draws
    seg_dir = ROOT / "build" / "chip_smoke_seg"
    shutil.rmtree(seg_dir, ignore_errors=True)
    fid = miniworld.generate_dataset(str(seg_dir), 1, seed=0)[0]
    mw_pts = io.read_velodyne_bin(str(seg_dir / "velodyne" / (fid + ".bin")))
    mw = []
    for d in (dev, torch.device("cpu")):
        pc = PointCloud.from_numpy(mw_pts, device=d)
        mw.append(segmentation.segment_ground_and_objects(
            pc.points, pc.mask, sampler=cpu_gumbel_sampler(
                args.seed, torch, gumbel_sampler), cfg=miniworld.seg_config()))
    for name in ("ground_mask", "object_ids", "foreground"):
        need(torch.equal(getattr(mw[0], name).cpu(), getattr(mw[1], name)),
             "P20 mini-world frame, card vs CPU", name)
    mw_obj = int(torch.unique(mw[1].object_ids[mw[1].object_ids >= 0]).numel())
    metrics["segmentation"] = dict(
        points=len(full),
        entry_s=seg_s, normals_ms=n_ms, ransac_ms=r_ms, dbscan_ms=d_ms,
        plane_normal=plane20.normal.tolist(), plane_offset=off,
        ground_points=int(out20.ground_mask.sum()),
        low_points_ground_share=low_ground,
        foreground_points=int(out20.foreground.sum()), objects=n_obj20,
        miniworld_frame_points=len(mw_pts), miniworld_frame_objects=mw_obj)
    print(f"P20 segmentation of the {len(full):,}-point scan (default "
          f"config): {seg_s:.2f} s; normals (k-NN 9) {n_ms:.1f} ms, RANSAC "
          f"({seg_cfg.ransac_hypotheses} planes) {r_ms:.1f} ms, DBSCAN "
          f"{d_ms:.1f} ms (CUDA events); plane n_z {nz:.5f}, d {off:.4f} m; "
          f"{100 * low_ground:.1f}% of the points below 5 cm are ground; "
          f"{int(out20.foreground.sum()):,} foreground points, {n_obj20} "
          f"objects; a repeat bit for bit; a {len(mw_pts):,}-point "
          f"mini-world frame ({mw_obj} objects) equal on the card and the CPU")
    report["profile_segmentation"] = profile("P20 segmentation", seg_full,
                                             torch)
    del pc20, out20, again, normals20, ground20, fg20, ids20
    torch.cuda.empty_cache()

    # ---- P21 the mini-world task loop: kernels 11, 12, 14 -----------------
    mark("P21 the mini-world task loop")
    mw_dir = ROOT / "build" / "chip_smoke_mini"
    shutil.rmtree(mw_dir, ignore_errors=True)
    raw = mw_dir / "kitti"
    mw_ids = miniworld.generate_dataset(str(raw), MW_TRAIN + MW_EVAL, seed=0)
    mw_cfg = nncfg.TrainConfig(model="cls-ssg", num_classes=4, num_points=64,
                               batch_size=16, epochs=MW_EPOCHS, lr=1e-3,
                               grad_clip=1.0, decay_step=1e9, seed=0)
    det_cfg = detect.DetectConfig(batch_size=8)
    stage21 = {}

    def task_loop():
        """run_task_loop's stages, with fit.evaluate in place of
        test_report (the card's machine has no scikit-learn)."""
        t = time.perf_counter()
        stats = kitti_etl.extract_dataset(
            str(raw), str(mw_dir / "extracted"), frame_ids=mw_ids[:MW_TRAIN],
            seg_cfg=miniworld.seg_config(), seed=0, device=dev)
        stage21["extract_s"] = time.perf_counter() - t
        t = time.perf_counter()
        counts = trainset.generate_training_set(
            str(mw_dir / "extracted"), str(mw_dir / "resampled"),
            num_sample_points=64, seed=0)
        trainset.generate_train_test_split(str(mw_dir / "resampled"), seed=0)
        train_ds = KITTIResampledDataset(str(mw_dir / "resampled"),
                                         "train.txt")
        val_ds = KITTIResampledDataset(str(mw_dir / "resampled"), "test.txt")
        stage21["trainset_s"] = time.perf_counter() - t
        t = time.perf_counter()
        out = fit.fit(mw_cfg, train_ds, val_ds, workdir=str(mw_dir / "run"),
                      augment_pipeline=(), eval_interval=1,
                      early_stop_patience=MW_EPOCHS, device=dev)
        torch.cuda.synchronize()
        stage21["fit_s"] = time.perf_counter() - t
        held = fit.evaluate(out["model"], val_ds, mw_cfg.batch_size,
                            device=dev)
        t = time.perf_counter()
        det_dir = mw_dir / "detections"
        det_dir.mkdir(parents=True, exist_ok=True)
        gt_files, det_files = [], []
        for f in mw_ids[MW_TRAIN:]:
            rows_ = detect.detect_frame(
                io.read_velodyne_bin(str(raw / "velodyne" / (f + ".bin"))),
                io.read_kitti_calib(str(raw / "calib" / (f + ".txt"))),
                out["model"], out["state"], cfg=det_cfg,
                seg_cfg=miniworld.seg_config(), seed=0, device=dev)
            (det_dir / (f + ".txt")).write_text(
                "\n".join(rows_) + ("\n" if rows_ else ""))
            det_files.append(str(det_dir / (f + ".txt")))
            gt_files.append(str(raw / "label_2" / (f + ".txt")))
        torch.cuda.synchronize()
        stage21["detect_s"] = time.perf_counter() - t
        ap = kitti_eval.evaluate_detections(gt_files, det_files, metric="bev")
        return dict(stats=stats, counts=counts, n_train=len(train_ds),
                    n_val=len(val_ds), fit=out, held=held, ap=ap)

    def task_launches(res):
        b = mw_cfg.batch_size
        forwards = (res["fit"]["steps"] + (MW_EPOCHS + 1) * (res["n_val"] // b)
                    + sum(-(-a[2].shape[0] // det_cfg.batch_size)
                          for a in r_pred.calls))
        return {"fps_pallas_batched": 2 * forwards, "ball_group": 2 * forwards,
                "scatter_add_rows": res["fit"]["steps"]}

    t0 = time.perf_counter()
    with Recorder(detect, "predict_clusters") as r_pred, \
            Recorder(pallas_fps, "_launch_fps") as rf21, \
            Recorder(pallas_ballgroup, "_launch_ball_group") as rg21, \
            Recorder(pallas_gather, "_launch_scatter_add_rows") as rs21:
        res21 = paths.run("miniworld", task_loop, task_launches)
    mw_s = time.perf_counter() - t0
    ap_easy = {c: res21["ap"][c]["easy"] for c in ("Car", "Pedestrian",
                                                  "Cyclist")}
    val_acc, held_acc = res21["fit"]["best_val_acc"], res21["held"]["acc"]
    print(f"P21 mini-world task loop ({MW_TRAIN} train + {MW_EVAL} eval "
          f"frames, cls-ssg at 64 points, {MW_EPOCHS} epochs, seed 0) in "
          f"{mw_s:.1f} s: extract {stage21['extract_s']:.1f} s "
          f"({res21['stats'].frames_ok} frames ok), training set "
          f"{stage21['trainset_s']:.1f} s ({res21['n_train']} train / "
          f"{res21['n_val']} held-out clouds), fit {stage21['fit_s']:.1f} s "
          f"({res21['fit']['steps']} steps), detect "
          f"{stage21['detect_s']:.1f} s; val-acc {val_acc:.4f} (JAX on CPU "
          f"{MW_JAX_CPU['val_acc']:.2f}), held-out acc {held_acc:.4f}; easy "
          f"BEV AP " + ", ".join(
              f"{c} {v:.4f} (JAX {MW_JAX_CPU['ap_easy_bev'][c]:.2f})"
              for c, v in ap_easy.items()))
    need(res21["stats"].frames_ok == MW_TRAIN, "P21 frames", res21["stats"])
    need(val_acc >= 0.9 and held_acc >= 0.9, "P21 accuracy", val_acc,
         held_acc)
    need(all(v >= 0.7 for v in ap_easy.values()), "P21 easy BEV AP", ap_easy)
    # every kernel 11, 12, 14 launch of the loop against its plain version
    with torch.no_grad():
        check_fps(pallas_fps, rf21.calls, torch)
        bg21_err, bg21_boundary, _ = check_ball_group(
            pallas_ballgroup, ball_query, gather, rg21.calls, torch)
    for args14 in rs21.calls:
        need(torch.equal(pallas_gather._launch_scatter_add_rows(*args14),
                         pallas_gather.scatter_add_rows_plain(*args14)),
             "P21 ball_group backward vs plain", tuple(args14[0].shape))
    # one predict_clusters call (the first eval frame's clusters), its
    # launches recorded apart and timed beside their bounds
    with Recorder(pallas_fps, "_launch_fps") as rfp, \
            Recorder(pallas_ballgroup, "_launch_ball_group") as rgp:
        detect.predict_clusters(*r_pred.calls[0])
        torch.cuda.synchronize()
    with torch.no_grad():
        check_fps(pallas_fps, rfp.calls, torch)
        _, _, bgp_work = check_ball_group(pallas_ballgroup, ball_query,
                                          gather, rgp.calls, torch)
    pred_rows = dict(
        fps=time_launches(pallas_fps._launch_fps, pallas_fps.fps_plain,
                          rfp.calls, [fps_work(a) for a in rfp.calls]),
        ball_group=time_launches(pallas_ballgroup._launch_ball_group,
                                 pallas_ballgroup.ball_group_plain,
                                 rgp.calls, bgp_work))
    rows["fps_pallas_batched"]["kitti_predict"] = pred_rows["fps"]
    rows["ball_group"]["kitti_predict"] = pred_rows["ball_group"]
    rows["ball_group"]["max_abs_err"] = max(rows["ball_group"]["max_abs_err"],
                                            bg21_err)
    metrics["miniworld"] = dict(
        seconds=mw_s, **stage21, frames_ok=res21["stats"].frames_ok,
        objects=res21["stats"].objects, class_counts=res21["counts"],
        train_clouds=res21["n_train"], held_out_clouds=res21["n_val"],
        steps=res21["fit"]["steps"], val_acc=val_acc, held_out_acc=held_acc,
        ap_bev=res21["ap"], jax_cpu=MW_JAX_CPU,
        predict_clusters_clouds=int(r_pred.calls[0][2].shape[0]),
        predict_launches=dict(fps=len(rfp.calls), ball_group=len(rgp.calls)),
        predict_kernel11_ms=pred_rows["fps"]["ms"],
        predict_kernel12_ms=pred_rows["ball_group"]["ms"])
    print(f"   kernels 11, 12, 14 vs plain on P21: FPS idx identical on "
          f"{len(rf21.calls)} launches, ball_group equal on "
          f"{len(rg21.calls)} ({bg21_boundary} centres with a boundary point "
          f"vs ball_query), kernel 14 bit-equal on {len(rs21.calls)}; one "
          f"predict_clusters call ({metrics['miniworld']['predict_clusters_clouds']}"
          f" clusters): kernel 11 {pred_rows['fps']['ms']:.4f} ms (bound "
          f"{pred_rows['fps']['bound_ms']:.4f}), kernel 12 "
          f"{pred_rows['ball_group']['ms']:.4f} ms (bound "
          f"{pred_rows['ball_group']['bound_ms']:.4f})")
    f0 = mw_ids[MW_TRAIN]
    report["profile_detect_frame"] = profile(
        "P21 detect_frame", lambda: detect.detect_frame(
            io.read_velodyne_bin(str(raw / "velodyne" / (f0 + ".bin"))),
            io.read_kitti_calib(str(raw / "calib" / (f0 + ".txt"))),
            res21["fit"]["model"], res21["fit"]["state"], cfg=det_cfg,
            seg_cfg=miniworld.seg_config(), seed=0, device=dev), torch)
    del res21, rf21, rg21, rs21, r_pred
    torch.cuda.empty_cache()

    # ---- P22 the clustering harness: kernel 14 in k-means -----------------
    mark("P22 the clustering harness")
    sets22 = cluster_datasets(np.random.default_rng([args.seed, 22]))
    shims = (("KMeans", lambda k, d: cluster.K_Means(k, device=d)),
             ("GMM", lambda k, d: cluster.GMM(k, device=d)),
             ("Spectral", lambda k, d: cluster.spetral_clustering(
                 k, nnk=10, device=d)),
             ("DBSCAN", lambda k, d: cluster.DBSCAN(radius=0.3, Min_Pts=5,
                                                    device=d)))
    fits22 = {}

    def fit_all():
        for ds, x, k in sets22:
            for name, make in shims:
                t = time.perf_counter()
                fits22[ds, name] = make(k, dev).fit(x)
                fits22[ds, name, "ms"] = (time.perf_counter() - t) * 1e3

    fit_all()                                                   # warm-up
    with Recorder(pallas_gather, "_launch_scatter_add_rows") as rs22:
        paths.run("clusters", fit_all,
                  lambda _: {"scatter_add_rows": len(rs22.calls)})
    need(len(rs22.calls) > 0, "P22 kernel 14 launches")
    for args14 in rs22.calls:
        need(torch.equal(pallas_gather._launch_scatter_add_rows(*args14),
                         pallas_gather.scatter_add_rows_plain(*args14)),
             "P22 k-means centre sums vs plain", tuple(args14[0].shape))
    table22 = {}
    for ds, x, k in sets22:
        cpu = {name: make(k, "cpu").fit(x) for name, make in shims}
        km, kc = fits22[ds, "KMeans"], cpu["KMeans"]
        need(np.array_equal(km.labels_, kc.labels_)
             and np.abs(km.cluster_centers_ - kc.cluster_centers_).max()
             <= 1e-5, "P22 k-means card vs CPU", ds)
        # EM's stop rule (prev_nll - nll >= tol) reads a float32 nll of
        # ~1e3, whose ulp is a tenth of tol, so where the decrease nears
        # tol the two devices may stop iterations apart: the CPU runs as
        # many EM steps as the card did before the two are compared
        g = fits22[ds, "GMM"].state
        gc = cluster.GMM(k, max_iter=g.n_iter, tol=float("-inf"),
                         device="cpu").fit(x).state
        gmm_err = max(float((getattr(g, f).cpu() - getattr(gc, f)).abs().max())
                      for f in ("means", "covs", "weights"))
        need(gmm_err <= 1e-4, "P22 GMM card vs CPU", ds, gmm_err)
        for name in ("Spectral", "DBSCAN"):
            need(same_partition(fits22[ds, name].labels_, cpu[name].labels_),
                 "P22 partition card vs CPU", ds, name)
        table22[ds] = {name: fits22[ds, name, "ms"] for name, _ in shims}
        table22[ds]["gmm_err_vs_cpu"] = gmm_err
        table22[ds]["gmm_iters"] = [g.n_iter, cpu["GMM"].state.n_iter]
        table22[ds]["dbscan_clusters"] = int(
            len(set(fits22[ds, "DBSCAN"].labels_.tolist()) - {-1}))
    metrics["clusters"] = dict(n=CLUSTER_N, fit_ms=table22,
                               kernel14_launches=len(rs22.calls))
    print(f"P22 clustering harness ({len(sets22)} datasets x {CLUSTER_N} "
          f"points, standardised): card = CPU (k-means labels, centres "
          f"within 1e-5; GMM within 1e-4 after as many EM steps; spectral "
          f"and DBSCAN partitions); "
          f"kernel 14 bit-equal on its {len(rs22.calls)} launches; ms a fit "
          f"(host clock, warm):")
    for ds, t in table22.items():
        print(f"   {ds:14s} " + "  ".join(
            f"{name} {t[name]:.1f}" for name, _ in shims)
            + f"  (GMM {t['gmm_iters'][0]} EM steps, the CPU alone "
            f"{t['gmm_iters'][1]}; vs the CPU at the card's count "
            f"{t['gmm_err_vs_cpu']:.1e})")

    # ---- P23 registration's two options: ISS keypoints, dense FPFH --------
    mark("P23 registration's two options")
    pm = dict(pipeline=pipeline, voxel=voxel, se3=se3, PointCloud=PointCloud,
              fpfh_dense=fpfh_dense, pallas_fpfh=pallas_fpfh,
              pointrcnn=pointrcnn, box3d=box3d, pointnet2=pointnet2,
              features=features, normals=normals, knn=knn, margins=margins)
    metrics["registration_options"] = reg23 = registration_options(
        paths, mods, src, dst, gts, pm, torch)
    k23 = reg23["kernels_vs_plain"]
    for name in ("nn1", "spfh", "wsum", "icp_mega_batch"):
        rows[name]["max_abs_err"] = max(
            [rows[name]["max_abs_err"]]
            + [k[name]["max_abs_err"] for k in (k23["iss"], k23["dense"])
               if name in k])
    rows["nn1"]["max_abs_err"] = max(rows["nn1"]["max_abs_err"],
                                     k23["pair"]["nn1"]["max_abs_err"])
    rows["icp_mega"]["max_abs_err"] = max(
        rows["icp_mega"]["max_abs_err"],
        k23["pair"]["icp_mega_batch"]["max_abs_err"])
    torch.cuda.empty_cache()

    # ---- P24 PointRCNN: the reference test's recipe, then full width -------
    mark("P24 PointRCNN")
    metrics["pointrcnn"] = pointrcnn_phase(paths, dev, args.seed, pm, torch)
    torch.cuda.empty_cache()

    # ---- P25 keypoints and descriptors on P1's first cloud -----------------
    mark("P25 keypoints and descriptors on P1's first cloud")
    vdown, _ = voxel.voxel_downsample_capped(
        src.points[:1], mask[:1], cfg.voxel_size, cfg.downsample_capacity)
    metrics["keypoints"] = keypoints_phase(
        paths, src.points[0], (vdown.points[0], vdown.mask[0]), pm, torch)

    mark("P26 the grid hash and grid ICP (no kernel)")
    metrics["grid"] = grid_phase(
        paths, mods, full, args.seed, dict(
            grid_hash=grid_hash, icp=icp, se3=se3, knn=knn,
            faces_cloud=faces_cloud), dev, torch,
        metrics["workload4"]["kernel5_ms"]
        / metrics["workload4"]["coarse_iters"])
    mark("P27 host code, the neighbour-search CLI, utilities (K1)")
    metrics["host"] = host_phase(
        paths, mods, full, ROOT / "build" / "chip_smoke_host",
        dict(native=native, spatial=spatial, nn_benchmark=nn_benchmark,
             profiling=profiling, viz=viz), dev, torch)
    rows["nn1"]["max_abs_err"] = max(
        rows["nn1"]["max_abs_err"],
        *(metrics[p]["kernels_vs_plain"]["nn1"]["max_abs_err"]
          for p in ("grid", "host")))
    torch.cuda.empty_cache()

    mark("P28 distribution (gloo x2, nccl x1)")
    metrics["distribution"] = distribution_phase(
        paths, rows, dict(seed=args.seed, pc=pc_tr, labels=lab_tr,
                          src=src_np, dst=dst_np, gts=gts, w4_src=full,
                          w4_dst=w4_dst, w4_gt=w4_gt,
                          pg=(kf14, out14["edges"])), dev,
        dict(se3=se3, pipeline=pipeline, pair_sweep=pair_sweep, icp=icp,
             posegraph=posegraph, pallas_nn=pallas_nn, T=T, fit=fit,
             augment=augment, PointCloud=PointCloud, halo=halo,
             preset=nncfg.MODELNET40_CLS_SSG), torch)

    # ---- kernels line, card, result --------------------------------------
    mark(None)
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
        "moments": ("pctpu_torch/csrc/fpfh.cu",
                    "pctpu/features/pallas_fpfh.py:177 _moments_kernel"),
        "fps_pallas": ("pctpu_torch/csrc/fps.cu",
                       "pctpu/ops/pallas_fps.py:29 _fps_kernel"),
        "fps_pallas_batched": ("pctpu_torch/csrc/fps.cu",
                               "pctpu/ops/pallas_fps.py:80 "
                               "_fps_kernel_batched"),
        "ball_group": ("pctpu_torch/csrc/ballgroup.cu",
                       "pctpu/ops/pallas_ballgroup.py:34 _ballgroup_kernel"),
        "gather_rows": ("pctpu_torch/csrc/gather.cu",
                        "pctpu/ops/pallas_gather.py:29 _gather_kernel"),
        "scatter_add_rows": ("pctpu_torch/csrc/gather.cu",
                             "pctpu/ops/pallas_gather.py:84 "
                             "_scatter_add_kernel"),
        "ransac_refine": ("pctpu_torch/csrc/ransac.cu",
                          "no kernel: pctpu/register/ransac.py's select "
                          "and refine, XLA ops"),
        "voxel_run_means": ("pctpu_torch/csrc/voxel.cu",
                            "no kernel: pctpu/ops/voxel.py:66 segment_sum, "
                            "XLA"),
    }
    # kernel 12's backward is kernel 14's entry (`_bg_bwd`): its launches
    # are kernel 14's on the training paths, its times P10's launch
    meta["ball_group_vjp"] = ("pctpu_torch/csrc/gather.cu",
                              "pctpu/ops/pallas_ballgroup.py:201 _bgb_bwd")
    rows["ball_group_vjp"] = rows["scatter_add_rows"]
    vjp_launches = sum(paths.launches[p].get("scatter_add_rows", 0)
                       for p in ("train_cls_msg", "train_cls_ssg", "fit",
                                 "train_semseg_ssg", "miniworld"))
    kern_rows = []
    for name in KERNELS + ("ball_group_vjp",):
        source, replaces = meta[name]
        r = rows[name]
        launches = (vjp_launches if name == "ball_group_vjp"
                    else paths.total(name))
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
                       "(K1-K4: register_pairs, K2/K3 as device time; "
                       "icp_mega: workload 1; "
                       "K6-K8: one 30-iteration call; fps_pallas_batched "
                       "and ball_group: one cls-msg forward at B 32; "
                       "fps_pallas: its 4 launches in P9; gather_rows: "
                       "its 2 launches in the group_points_pallas phase; "
                       "scatter_add_rows: one P10 step's launch, kernel "
                       "12's backward; moments: its 2 launches in the "
                       "kernel-9 phase, as device time; ransac_refine: "
                       "P1's launch; voxel_run_means: P3's two whole "
                       "scans' launches, as device time); launches: summed "
                       "over the paths")
    phases = {name: round(t1 - t0, 1)
              for (name, t0), (_, t1) in zip(marks, marks[1:])}
    report["phase_s"] = phases
    print("phases, wall s (host clock): " + "; ".join(
        f"{name} {s:.1f}" for name, s in phases.items()))
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
