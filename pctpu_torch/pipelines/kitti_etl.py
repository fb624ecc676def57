"""KITTI 3D-object ETL: extract per-object classification samples.

Re-design of `Final_Project/scripts/extract.py:472-661` (C40): per frame —
read velodyne/calib/label; segment ground + cluster objects (device);
for each KITTI label: radius-gather points around the velodyne-frame center,
map to the object frame, bounding-box filter, dominant-cluster-id NMS
association (`extract.py:166-201`); write per-object CSV (xyz + normals) and
per-class metadata; then sample unlabeled clusters as 'misc'
(`:579-599`). Per-frame try/except error isolation (`:641-645`).

The port's copy: the segmentation runs on the port (`device=`, CUDA
unless "cpu" is asked for); each frame's plane triples come from a
generator seeded 0 on that device (the reference's `PRNGKey(0)` a frame),
or from an injected `sampler` (`cluster.plane_ransac`). The host numpy
rng is the reference's.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from pctpu_torch.cluster.plane_ransac import PlaneSampler
from pctpu_torch.core import io
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.pipelines import kitti_frames
from pctpu_torch.pipelines.segmentation import (SegmentationConfig,
                                                segment_ground_and_objects)

CLASS_MAP = {"Car": "vehicle", "Van": "vehicle", "Truck": "vehicle",
             "Pedestrian": "pedestrian", "Person_sitting": "pedestrian",
             "Cyclist": "cyclist"}
CATEGORIES = ("vehicle", "pedestrian", "cyclist", "misc")


@dataclasses.dataclass
class ExtractStats:
    frames_ok: int = 0
    frames_failed: int = 0
    objects: int = 0
    failed_frames: List[str] = dataclasses.field(default_factory=list)


def associate_label(points_obj: np.ndarray, cluster_ids: np.ndarray,
                    dims: np.ndarray) -> Optional[int]:
    """Bounding-box filter + dominant-id vote (extract.py:166-201)."""
    inside = np.all((points_obj >= -dims / 2) & (points_obj <= dims / 2),
                    axis=1)
    if inside.sum() == 0:
        return None
    ids, counts = np.unique(cluster_ids[inside], return_counts=True)
    return int(ids[np.argmax(counts)])


def process_frame(frame_id: str, velo_dir: str, calib_dir: str,
                  label_dir: str, output_dir: str,
                  counters: Dict[str, int],
                  metadata: Dict[str, list],
                  seg_cfg: SegmentationConfig = SegmentationConfig(),
                  rng: Optional[np.random.Generator] = None,
                  misc_per_frame: int = 3, device: DeviceLike = None,
                  sampler: Optional[PlaneSampler] = None) -> int:
    """Extract one frame on `device` (CUDA unless "cpu" is asked for);
    returns the number of objects written."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    pts = io.read_velodyne_bin(os.path.join(velo_dir, frame_id + ".bin"))
    calib = io.read_kitti_calib(os.path.join(calib_dir, frame_id + ".txt"))
    objs = io.read_kitti_label(os.path.join(label_dir, frame_id + ".txt"))
    io.kitti_labels_to_velo(objs, calib)

    pc = PointCloud.from_numpy(pts, device=dev)
    seg = segment_ground_and_objects(
        pc.points, pc.mask, generator=torch.Generator(device=dev).manual_seed(0),
        sampler=sampler, cfg=seg_cfg)
    points = pc.points.cpu().numpy()
    ids = seg.object_ids.cpu().numpy()
    normals = seg.normals.cpu().numpy()
    valid = pc.mask.cpu().numpy()

    n_written = 0
    used_cluster_ids = set()
    for label in objs:
        if label["type"] == "DontCare":
            continue
        category = CLASS_MAP.get(label["type"])
        if category is None:
            continue
        center = np.array([label["vx"], label["vy"], label["vz"]])
        d = np.linalg.norm(points - center, axis=1)
        near = (d <= label["radius"]) & valid & (ids >= 0)
        if near.sum() == 0:
            continue
        dims = np.array([label["length"], label["height"], label["width"]])
        # object frame: x=length(cam x), y=height(cam y), z=width? KITTI
        # object frame axes follow extract.py: dims order (l, h, w) with
        # velo_to_obj mapping (cam frame rotated by ry about y)
        t_obj_cam = np.array([label["cx"], label["cy"] - label["height"] / 2,
                              label["cz"]])
        pts_obj = kitti_frames.velo_to_obj(points[near], calib, t_obj_cam,
                                           label["ry"])
        obj_id = associate_label(pts_obj, ids[near], dims)
        if obj_id is None or obj_id in used_cluster_ids:
            continue
        used_cluster_ids.add(obj_id)
        sel = (ids == obj_id) & valid
        if sel.sum() == 0:
            continue
        _write_object(output_dir, category, counters, metadata,
                      points[sel], normals[sel], frame_id, label)
        n_written += 1

    # unlabeled clusters -> 'misc' (extract.py:579-599)
    all_ids = np.unique(ids[ids >= 0])
    unused = [i for i in all_ids if i not in used_cluster_ids]
    rng.shuffle(unused)
    for obj_id in unused[:misc_per_frame]:
        sel = (ids == obj_id) & valid
        if sel.sum() < 4:
            continue
        _write_object(output_dir, "misc", counters, metadata,
                      points[sel], normals[sel], frame_id, None)
        n_written += 1
    return n_written


def _write_object(output_dir, category, counters, metadata, pts, normals,
                  frame_id, label):
    os.makedirs(os.path.join(output_dir, category), exist_ok=True)
    idx = counters.get(category, 0) + 1
    counters[category] = idx
    arr = np.hstack([pts, normals]).astype(np.float32)
    path = os.path.join(output_dir, category, f"{idx:06d}.txt")
    header = "vx,vy,vz,nx,ny,nz"
    np.savetxt(path, arr, delimiter=",", header=header, comments="")
    center = pts.mean(axis=0)
    metadata.setdefault(category, []).append({
        "frame": frame_id, "num_measurements": int(pts.shape[0]),
        "vx": float(center[0]), "vy": float(center[1]),
        "vz": float(center[2]),
        "type": label["type"] if label else "misc",
    })


def extract_dataset(kitti_root: str, output_dir: str,
                    frame_ids: Optional[List[str]] = None,
                    seg_cfg: SegmentationConfig = SegmentationConfig(),
                    seed: int = 0, device: DeviceLike = None,
                    sampler: Optional[PlaneSampler] = None) -> ExtractStats:
    """Run the full ETL on `device` (CUDA unless "cpu" is asked for; a
    missing card raises here, before the per-frame error isolation)."""
    dev = resolve_device(device)
    velo_dir = os.path.join(kitti_root, "velodyne")
    calib_dir = os.path.join(kitti_root, "calib")
    label_dir = os.path.join(kitti_root, "label_2")
    if frame_ids is None:
        frame_ids = sorted(os.path.splitext(f)[0]
                           for f in os.listdir(label_dir))
    os.makedirs(output_dir, exist_ok=True)
    stats = ExtractStats()
    counters: Dict[str, int] = {}
    metadata: Dict[str, list] = {}
    rng = np.random.default_rng(seed)
    for fid in frame_ids:
        try:
            stats.objects += process_frame(
                fid, velo_dir, calib_dir, label_dir, output_dir,
                counters, metadata, seg_cfg, rng, device=dev,
                sampler=sampler)
            stats.frames_ok += 1
        except Exception:  # per-frame isolation (extract.py:641-645)
            stats.frames_failed += 1
            stats.failed_frames.append(fid)
    # per-class metadata CSVs
    for category, rows in metadata.items():
        import csv
        with open(os.path.join(output_dir, f"{category}.csv"), "w",
                  newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            w.writeheader()
            w.writerows(rows)
    return stats
