"""KITTI detection pipeline: segment -> classify clusters -> KITTI labels.

Re-design of `Final_Project/scripts/detect.py:269-541` (C44): per frame —
segment ground/objects; per cluster: >=5-point and <=25 m filters
(`:286-292`), distance-weighted resample to 64 points + zero-center
(`:296-312`), pad to batch (`:327-347`); batched PointNet++ softmax predict
(`:357-412`); per-object oriented bbox via camera-frame PCA yaw (`:37-54`),
axis-aligned extent in the object frame, velo->cam->pixel 2D box, KITTI
label rows with score (`to_kitti_eval_format:56-194`).

The port's copy: the filters, the resample, the PCA yaw and the label
rows are numpy as in the reference; the segmentation and the classifier
(the port's PointNet++ from `nn/train.py:build_model`, in eval mode, with
softmax) run on the port, on the model's device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from pctpu_torch.cluster.plane_ransac import PlaneSampler
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.nn.data import distance_weighted_resample
from pctpu_torch.pipelines import kitti_frames
from pctpu_torch.pipelines.segmentation import (SegmentationConfig,
                                                segment_ground_and_objects)

DECODER = {0: "vehicle", 1: "pedestrian", 2: "cyclist", 3: "misc"}
KITTI_TYPE = {"vehicle": "Car", "pedestrian": "Pedestrian",
              "cyclist": "Cyclist", "misc": "Misc"}


@dataclasses.dataclass(frozen=True)
class DetectConfig:
    num_sample_points: int = 64
    batch_size: int = 8
    max_radius_distance: float = 25.0
    min_points: int = 5


def preprocess_clusters(points: np.ndarray, normals: np.ndarray,
                        object_ids: np.ndarray, cfg: DetectConfig,
                        rng: np.random.Generator):
    """Cluster filters + resample (detect.py:269-354). Returns
    (X [M,64,6], kept_object_ids [M])."""
    X, kept = [], []
    for oid in np.unique(object_ids[object_ids >= 0]):
        sel = object_ids == oid
        if sel.sum() < cfg.min_points:
            continue
        center = points[sel].mean(axis=0)[:2]
        if np.linalg.norm(center) > cfg.max_radius_distance:
            continue
        p, n = distance_weighted_resample(
            points[sel], cfg.num_sample_points, rng, extra=normals[sel])
        X.append(np.hstack([p, n]))
        kept.append(int(oid))
    if not X:
        return np.zeros((0, cfg.num_sample_points, 6), np.float32), []
    return np.stack(X).astype(np.float32), kept


def predict_clusters(model, state, X: np.ndarray, cfg: DetectConfig):
    """Batched softmax prediction with pad-to-batch (detect.py:327-412):
    the port's `model` (its weights and BN statistics; `state`, the
    `TrainState` that holds it, may be None) in eval mode on its own
    device. Returns probs [M, num_classes]."""
    m = X.shape[0]
    if m == 0:
        return np.zeros((0, 4), np.float32)
    if state is not None and state.model is not model:
        raise ValueError("predict_clusters: the state holds another model")
    pad = (-m) % cfg.batch_size
    Xp = np.concatenate([X, np.repeat(X[:1], pad, axis=0)]) if pad else X
    dev = next(model.parameters()).device
    model.eval()
    probs = []
    with torch.no_grad():
        for s in range(0, Xp.shape[0], cfg.batch_size):
            pc = torch.as_tensor(Xp[s:s + cfg.batch_size], device=dev)
            probs.append(torch.softmax(model(pc), dim=-1).cpu().numpy())
    return np.concatenate(probs)[:m]


def camera_yaw_pca(X_cam_centered: np.ndarray) -> float:
    """Heading from PCA of the x-z footprint (detect.py:37-54)."""
    xz = X_cam_centered[:, [0, 2]]
    H = np.cov(xz, rowvar=False, bias=True)
    vals, vecs = np.linalg.eigh(H)
    v = vecs[:, np.argmax(vals)]
    return float(np.arctan2(-v[1], v[0]))


def to_kitti_rows(points: np.ndarray, object_ids: np.ndarray,
                  calib: dict, predictions: Dict[int, Dict[int, float]]
                  ) -> List[str]:
    """KITTI label lines with score (to_kitti_eval_format parity: skips
    'misc'; truncated/occluded = -1, alpha = -10)."""
    rows = []
    for class_id, objs in predictions.items():
        class_name = DECODER[class_id]
        if class_name == "misc":
            continue
        ktype = KITTI_TYPE[class_name]
        for oid, conf in objs.items():
            X_velo = points[object_ids == oid]
            X_cam = kitti_frames.velo_to_cam(X_velo, calib)
            X_pix = kitti_frames.cam_to_pixel(X_cam, calib)
            left, top = X_pix.min(axis=0)
            right, bottom = X_pix.max(axis=0)
            c = X_cam.mean(axis=0)
            centered = X_cam - c
            ry = camera_yaw_pca(centered)
            # de-rotate the heading onto +x: row vectors need R(-ry)^T,
            # which is ry_rotation(ry)
            R = kitti_frames.ry_rotation(ry)
            X_obj = centered @ R
            ext = X_obj.max(axis=0) - X_obj.min(axis=0)
            # KITTI label order h,w,l = (y, z, x) extents in the object
            # frame (length lies along the heading = x after de-rotation);
            # location is the BOTTOM-face center (cam y points down)
            f = lambda x: f"{x:.2f}"
            rows.append(" ".join([
                ktype, "-1", "-1", "-10",
                f(left), f(top), f(right), f(bottom),
                f(ext[1]), f(ext[2]), f(ext[0]),      # h, w, l
                f(c[0]), f(X_cam[:, 1].max()), f(c[2]), f(ry),
                f(100.0 * conf)]))
    return rows


def detect_frame(points: np.ndarray, calib: dict, model, state,
                 cfg: DetectConfig = DetectConfig(),
                 seg_cfg: SegmentationConfig = SegmentationConfig(),
                 seed: int = 0, device: DeviceLike = None,
                 sampler: Optional[PlaneSampler] = None) -> List[str]:
    """Full single-frame detection -> KITTI label lines, on `device`
    (CUDA unless "cpu" is asked for), where the model must live. The
    plane triples come from a generator seeded `seed` on that device (the
    reference's `PRNGKey(seed)`), or from `sampler`."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"detect_frame: the model is on {model_dev}, the "
                         f"frame on {dev}")
    pc = PointCloud.from_numpy(points, device=dev)
    seg = segment_ground_and_objects(
        pc.points, pc.mask,
        generator=torch.Generator(device=dev).manual_seed(seed),
        sampler=sampler, cfg=seg_cfg)
    pts = pc.points.cpu().numpy()
    ids_arr = seg.object_ids.cpu().numpy()
    normals = seg.normals.cpu().numpy()
    rng = np.random.default_rng(seed)
    X, kept = preprocess_clusters(pts, normals, ids_arr, cfg, rng)
    probs = predict_clusters(model, state, X, cfg)
    predictions: Dict[int, Dict[int, float]] = {}
    for oid, p in zip(kept, probs):
        cid = int(np.argmax(p))
        predictions.setdefault(cid, {})[oid] = float(p[cid])
    return to_kitti_rows(pts, ids_arr, calib, predictions)
