"""Host-side point-cloud / dataset IO (numpy, vectorized): the port's own
copy of `pctpu/core/io.py`, which imports nothing of JAX.

Capability parity with the reference's scattered readers (SURVEY.md L0):
  * Velodyne 'ffff' bins  — `Final_Project/scripts/extract.py:23-47`
  * Oxford  'ffffff' bins — `Registration/registration_dataset/evaluate_rt.py:44-50`
  * ModelNet40 CSV        — `Keypoint_detection_ISS/ISS.py:7-13`
  * KITTI calib / label   — `Final_Project/scripts/extract.py:49-84,203-262`
  * registration result rows — `evaluate_rt.py:53-74`

All readers use `np.fromfile` instead of the reference's per-point
`struct.iter_unpack` Python loops (orders of magnitude faster on 100k+ point
scans).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

KITTI_CALIB_SHAPES = {
    "P0": (3, 4), "P1": (3, 4), "P2": (3, 4), "P3": (3, 4),
    "R0_rect": (3, 3), "Tr_velo_to_cam": (3, 4), "Tr_imu_to_velo": (3, 4),
}


def read_velodyne_bin(path: str, return_intensity: bool = False) -> np.ndarray:
    """KITTI velodyne scan: packed float32 (x,y,z,intensity). Returns (N,3)
    xyz (or (N,4) with intensity)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return raw if return_intensity else np.ascontiguousarray(raw[:, :3])


def read_oxford_bin(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Course registration-dataset scan: packed float32
    (x,y,z,nx,ny,nz). Returns (points (N,3), normals (N,3))."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 6)
    return np.ascontiguousarray(raw[:, :3]), np.ascontiguousarray(raw[:, 3:])


def read_modelnet_txt(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """ModelNet40 normal-resampled CSV row = x,y,z,nx,ny,nz. Returns
    (points, normals)."""
    raw = np.loadtxt(path, delimiter=",", dtype=np.float32)
    return np.ascontiguousarray(raw[:, :3]), np.ascontiguousarray(raw[:, 3:6])


def read_freiburg_dat(path: str, max_points: Optional[int] = None,
                      seed: int = 0) -> np.ndarray:
    """Freiburg/Wachtberg '.dat' scan: whitespace rows whose columns 3-5 are
    xyz (`PCLKeypoints/src/utils.hpp:22-63` semantics, incl. its optional
    random subsampling). Returns (N,3)."""
    raw = np.loadtxt(path, dtype=np.float32, ndmin=2)
    pts = np.ascontiguousarray(raw[:, 3:6])
    if max_points is not None and pts.shape[0] > max_points:
        rng = np.random.default_rng(seed)
        pts = pts[rng.choice(pts.shape[0], max_points, replace=False)]
    return pts


def read_csv_points(path: str) -> np.ndarray:
    """Comma-separated x,y,z[,...] text cloud
    (`PCLKeypoints/src/utils.hpp:66-98`). Returns (N,3)."""
    raw = np.loadtxt(path, delimiter=",", dtype=np.float32, ndmin=2)
    return np.ascontiguousarray(raw[:, :3])


def read_kitti_calib(path: str) -> Dict[str, np.ndarray]:
    """KITTI 3D-object calib file -> dict of named matrices."""
    out = {}
    with open(path, "rt") as f:
        for line in f.read().strip().splitlines():
            if ":" not in line:
                continue
            name, value = line.split(":", 1)
            name = name.strip()
            vals = np.asarray([float(v) for v in value.split()], dtype=np.float64)
            out[name] = vals.reshape(KITTI_CALIB_SHAPES.get(name, (-1,)))
    return out


# KITTI label columns (space-separated), standard devkit order.
KITTI_LABEL_FIELDS = [
    "type", "truncated", "occluded", "alpha",
    "left", "top", "right", "bottom",
    "height", "width", "length",
    "cx", "cy", "cz", "ry",
]


def read_kitti_label(path: str) -> List[dict]:
    """KITTI 3D-object label file -> list of dicts (one per object).

    Adds the derived fields the detection pipeline needs (velodyne-frame
    center `v{x,y,z}` with half-height lift and extraction `radius`), matching
    `extract.py:242-262` — computed here without pandas.
    """
    objs = []
    with open(path, "rt") as f:
        for line in f:
            parts = line.strip().split()
            if len(parts) < 15:
                continue
            o = {"type": parts[0]}
            for k, v in zip(KITTI_LABEL_FIELDS[1:], parts[1:15]):
                o[k] = float(v)
            if o["height"] < 0.0 or o["width"] < 0.0 or o["length"] < 0.0:
                continue
            o["radius"] = 0.5 * float(
                np.linalg.norm([o["height"], o["width"], o["length"]]))
            objs.append(o)
    return objs


def kitti_labels_to_velo(objs: List[dict], calib: Dict[str, np.ndarray]) -> None:
    """In-place: add velodyne-frame centers vx,vy,vz (cam center unrectified
    and mapped through inv(Tr_velo_to_cam), then lifted by height/2 — the
    KITTI label center sits at the bbox bottom)."""
    if not objs:
        return
    R0 = calib["R0_rect"]
    Tr = calib["Tr_velo_to_cam"]
    Rvc, tvc = Tr[:, :3], Tr[:, 3]
    centers_cam = np.asarray([[o["cx"], o["cy"], o["cz"]] for o in objs])
    unrect = centers_cam @ R0  # R0^T @ x, row-vector form
    velo = (unrect - tvc) @ Rvc  # Rvc^T @ (x - t)
    for o, c in zip(objs, velo):
        o["vx"], o["vy"] = float(c[0]), float(c[1])
        o["vz"] = float(c[2]) + o["height"] / 2.0


def read_reg_results(path: str, splitter: str = ",") -> List[List[str]]:
    """Registration pair/result list; row = idx1,idx2[,tx,ty,tz,qw,qx,qy,qz].
    First row is a header."""
    rows = []
    with open(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([x.strip() for x in line.split(splitter)])
    return rows


def write_reg_results(path: str, rows: List[Tuple[int, int, np.ndarray, np.ndarray]],
                      header: str = "idx1,idx2,t_x,t_y,t_z,q_w,q_x,q_y,q_z") -> None:
    """Write result rows (idx1, idx2, t[3], q_wxyz[4]) in the reference's
    output format (`Registration/main.py:220-222`)."""
    with open(path, "wt") as f:
        f.write(header + "\n")
        for idx1, idx2, t, q in rows:
            vals = ",".join(f"{v:.8f}" for v in list(t) + list(q))
            f.write(f"{idx1},{idx2},{vals}\n")


def write_ply(path: str, points: np.ndarray,
              colors: Optional[np.ndarray] = None) -> None:
    """Minimal ASCII PLY writer (replaces the reference's interactive Open3D
    windows for headless visualization)."""
    points = np.asarray(points, dtype=np.float32)
    n = points.shape[0]
    with open(path, "wt") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        if colors is None:
            for p in points:
                f.write(f"{p[0]} {p[1]} {p[2]}\n")
        else:
            cols = np.asarray(colors)
            if cols.dtype != np.uint8:
                cols = (np.clip(cols, 0, 1) * 255).astype(np.uint8)
            for p, c in zip(points, cols):
                f.write(f"{p[0]} {p[1]} {p[2]} {c[0]} {c[1]} {c[2]}\n")
