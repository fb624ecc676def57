"""Synthetic KITTI mini-world: close the train -> detect -> AP task loop.

The reference's one recorded learned-model outcome is 0.92 validation
accuracy on the KITTI 4-class task, produced by the chain
extract -> generate-trainset -> train -> detect -> kitti_eval
(`Final_Project/README.md:96,232-239`). The real KITTI dataset is not
shipped, so this module builds a small procedurally-generated world in the
exact KITTI on-disk format (velodyne/*.bin + calib/*.txt + label_2/*.txt)
and drives the repo's full pipeline over it end-to-end, reporting held-out
validation accuracy AND detection AP — the repo's counterpart of the
reference number, reproducible with one command:

    python -m pctpu_torch.pipelines.miniworld --workdir W [--device cpu]

Objects are class-distinct box shells sitting on a noisy ground plane:
vehicles (large, flat), pedestrians (small, tall), cyclists (elongated,
narrow) — geometry a PointNet++ classifier must separate by shape, not by a
trivial point-count cue. GT labels are exact by construction (cam-frame
location/dims/yaw chosen first, points generated from them through the
inverse calib transform), so the KITTI eval exercises the real
velo->cam->pixel chain (`pipelines.kitti_frames`).

The port's copy: the world is written by the reference's numpy code; the
task loop runs on the port (`device=`, CUDA unless "cpu" is asked for):
its segmentation, `fit`, `test_report` (which needs scikit-learn),
`KITTIResampledDataset`, the ETL, the training set, detection and
`evaluate_detections`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

# (h, w, l) in meters — KITTI label order, cam frame (y down = height axis)
CLASS_DIMS = {
    "Car": (1.5, 1.7, 3.9),
    "Pedestrian": (1.75, 0.55, 0.55),
    "Cyclist": (1.6, 0.55, 1.8),
}
GROUND_Z = -1.7


@dataclasses.dataclass(frozen=True)
class WorldConfig:
    n_ground: int = 6000
    ground_x: Tuple[float, float] = (2.0, 40.0)
    ground_y: Tuple[float, float] = (-18.0, 18.0)
    ground_noise: float = 0.03
    objects_per_frame: int = 4
    misc_per_frame: int = 2
    points_per_object: int = 260
    surface_noise: float = 0.02
    place_x: Tuple[float, float] = (5.0, 22.0)
    place_y: Tuple[float, float] = (-10.0, 10.0)
    min_separation: float = 4.5     # center spacing: keeps clusters distinct


def make_calib() -> Dict[str, np.ndarray]:
    """KITTI-style calib: velo (x fwd, y left, z up) -> cam (x right,
    y down, z fwd), f=700 px."""
    return {
        "P2": np.array([[700.0, 0.0, 600.0, 0.0],
                        [0.0, 700.0, 180.0, 0.0],
                        [0.0, 0.0, 1.0, 0.0]]),
        "R0_rect": np.eye(3),
        "Tr_velo_to_cam": np.array([[0.0, -1.0, 0.0, 0.0],
                                    [0.0, 0.0, -1.0, 0.0],
                                    [1.0, 0.0, 0.0, 0.0]]),
    }


def _write_calib(path: str, calib: Dict[str, np.ndarray]) -> None:
    with open(path, "w") as f:
        for k, v in calib.items():
            f.write(k + ": " + " ".join(f"{x:.12e}" for x in
                                        np.asarray(v).ravel()) + "\n")


def _box_surface_points(rng: np.random.Generator, dims_hwl, n: int
                        ) -> np.ndarray:
    """Uniform samples on the surface of an axis-aligned box centered at the
    origin; returns [n,3] in VELO-like object axes (x=length, y=width,
    z=height)."""
    h, w, l = dims_hwl
    ext = np.array([l, w, h])
    faces = []       # (fixed axis, sign), area-weighted
    areas = []
    for ax in range(3):
        o1, o2 = [a for a in range(3) if a != ax]
        area = ext[o1] * ext[o2]
        for sign in (-1.0, 1.0):
            faces.append((ax, sign))
            areas.append(area)
    probs = np.asarray(areas) / np.sum(areas)
    face_idx = rng.choice(len(faces), size=n, p=probs)
    pts = (rng.random((n, 3)) - 0.5) * ext
    for i, (ax, sign) in enumerate(faces):
        sel = face_idx == i
        pts[sel, ax] = sign * ext[ax] / 2.0
    return pts


def _velo_yaw(ry: float) -> float:
    """Cam-frame ry -> velo-frame yaw about +z (for the calib above:
    x_c = -y_v, z_c = x_v)."""
    return -ry - np.pi / 2.0


def _project_box(calib, loc_cam, dims_hwl, ry) -> np.ndarray:
    """2D bbox [left, top, right, bottom] of the 3D box's projected corners."""
    h, w, l = dims_hwl
    xs = np.array([l, l, -l, -l, l, l, -l, -l]) / 2.0
    ys = np.array([0.0, 0.0, 0.0, 0.0, -h, -h, -h, -h])
    zs = np.array([w, -w, -w, w, w, -w, -w, w]) / 2.0
    c, s = np.cos(ry), np.sin(ry)
    corners = np.stack([c * xs + s * zs + loc_cam[0],
                        ys + loc_cam[1],
                        -s * xs + c * zs + loc_cam[2]], axis=1)
    P2 = calib["P2"]
    hom = np.hstack([corners, np.ones((8, 1))]) @ P2.T
    pix = hom[:, :2] / hom[:, 2:3]
    return np.array([pix[:, 0].min(), pix[:, 1].min(),
                     pix[:, 0].max(), pix[:, 1].max()])


def write_frame(root: str, frame_id: str, rng: np.random.Generator,
                cfg: WorldConfig = WorldConfig()) -> List[dict]:
    """Write one frame (velodyne + calib + label_2); returns the GT objects."""
    calib = make_calib()
    pts = []
    g = np.zeros((cfg.n_ground, 3), np.float32)
    g[:, 0] = rng.uniform(*cfg.ground_x, cfg.n_ground)
    g[:, 1] = rng.uniform(*cfg.ground_y, cfg.n_ground)
    g[:, 2] = GROUND_Z + rng.normal(scale=cfg.ground_noise, size=cfg.n_ground)
    pts.append(g)

    # rejection-sample well-separated centers; restart the whole layout if
    # a greedy placement paints itself into a corner (bounded, no spin)
    n_centers = cfg.objects_per_frame + cfg.misc_per_frame
    centers: List[np.ndarray] = []
    for attempt in range(10_000):
        if attempt and attempt % 2_000 == 0:
            centers = []        # greedy dead-end: restart the layout
        c = np.array([rng.uniform(*cfg.place_x), rng.uniform(*cfg.place_y)])
        if all(np.linalg.norm(c - p) >= cfg.min_separation for p in centers):
            centers.append(c)
            if len(centers) == n_centers:
                break
    else:
        raise RuntimeError(
            f"could not place {n_centers} centers with separation "
            f"{cfg.min_separation} in {cfg.place_x}x{cfg.place_y}")

    labels = []
    classes = list(CLASS_DIMS)
    for i in range(cfg.objects_per_frame):
        cls = classes[int(rng.integers(len(classes)))]
        h, w, l = CLASS_DIMS[cls]
        cx, cy = centers[i]
        yaw = rng.uniform(-np.pi, np.pi)
        ry = -yaw - np.pi / 2.0   # inverse of _velo_yaw
        body = _box_surface_points(rng, (h, w, l), cfg.points_per_object)
        cz, sz = np.cos(yaw), np.sin(yaw)
        Rz = np.array([[cz, -sz, 0.0], [sz, cz, 0.0], [0.0, 0.0, 1.0]])
        world = body @ Rz.T + np.array([cx, cy, GROUND_Z + h / 2.0])
        world += rng.normal(scale=cfg.surface_noise, size=world.shape)
        pts.append(world.astype(np.float32))
        loc_cam = np.array([-cy, -GROUND_Z, cx])   # bottom center, cam frame
        bbox = _project_box(calib, loc_cam, (h, w, l), ry)
        labels.append({"type": cls, "bbox": bbox, "dims": (h, w, l),
                       "loc": loc_cam, "ry": ry})

    # unlabeled blobs -> the ETL's 'misc' class
    for i in range(cfg.misc_per_frame):
        cx, cy = centers[cfg.objects_per_frame + i]
        m = cfg.points_per_object // 2
        blob = rng.normal(scale=0.35, size=(m, 3)) * np.array([1.0, 1.0, 0.5])
        blob += np.array([cx, cy, GROUND_Z + 0.6])
        pts.append(blob.astype(np.float32))

    cloud = np.concatenate(pts).astype(np.float32)
    for sub in ("velodyne", "calib", "label_2"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    raw = np.hstack([cloud, np.zeros((cloud.shape[0], 1), np.float32)])
    raw.astype(np.float32).tofile(
        os.path.join(root, "velodyne", frame_id + ".bin"))
    _write_calib(os.path.join(root, "calib", frame_id + ".txt"), calib)
    with open(os.path.join(root, "label_2", frame_id + ".txt"), "w") as f:
        for o in labels:
            h, w, l = o["dims"]
            b = o["bbox"]
            x, y, z = o["loc"]
            f.write(" ".join([o["type"], "0.00", "0", "0.00",
                              f"{b[0]:.2f}", f"{b[1]:.2f}", f"{b[2]:.2f}",
                              f"{b[3]:.2f}", f"{h:.2f}", f"{w:.2f}",
                              f"{l:.2f}", f"{x:.2f}", f"{y:.2f}", f"{z:.2f}",
                              f"{o['ry']:.4f}"]) + "\n")
    return labels


def generate_dataset(root: str, n_frames: int, seed: int = 0,
                     cfg: WorldConfig = WorldConfig()) -> List[str]:
    rng = np.random.default_rng(seed)
    ids = [f"{i:06d}" for i in range(n_frames)]
    for fid in ids:
        write_frame(root, fid, rng, cfg)
    return ids


# -- the full task loop --------------------------------------------------


def seg_config():
    """Segmentation parameters for the mini-world's point density."""
    from pctpu_torch.pipelines.segmentation import SegmentationConfig
    return SegmentationConfig(dbscan_eps=0.8, dbscan_min_pts=5,
                              dbscan_k_cap=48)


def run_task_loop(workdir: str, n_train_frames: int = 10,
                  n_eval_frames: int = 4, epochs: int = 12,
                  seed: int = 0, max_steps: Optional[int] = None,
                  heatmap: bool = True, device=None) -> Dict:
    """extract -> trainset -> split -> fit -> detect -> AP, all on the
    mini-world, on `device` (CUDA unless "cpu" is asked for). Returns
    {'val_acc', 'test_acc', 'ap', 'report', 'fit'} (the repo counterpart
    of `Final_Project/README.md:96`'s 0.92 val-acc + kitti_eval AP)."""

    from pctpu_torch.core import io as pio
    from pctpu_torch.device import resolve_device
    from pctpu_torch.nn.config import TrainConfig
    from pctpu_torch.nn.data import KITTIResampledDataset
    from pctpu_torch.nn import fit as F
    from pctpu_torch.pipelines import kitti_etl, trainset
    from pctpu_torch.pipelines.detect import DetectConfig, detect_frame
    from pctpu_torch.pipelines.kitti_eval import evaluate_detections

    dev = resolve_device(device)

    raw = os.path.join(workdir, "kitti")
    ids = generate_dataset(raw, n_train_frames + n_eval_frames, seed=seed)
    train_ids, eval_ids = ids[:n_train_frames], ids[n_train_frames:]

    scfg = seg_config()
    extracted = os.path.join(workdir, "extracted")
    stats = kitti_etl.extract_dataset(raw, extracted, frame_ids=train_ids,
                                      seg_cfg=scfg, seed=seed, device=dev)
    if stats.frames_ok != n_train_frames:
        raise RuntimeError(f"extract: {stats}")

    resampled = os.path.join(workdir, "resampled")
    trainset.generate_training_set(extracted, resampled,
                                   num_sample_points=64, seed=seed)
    trainset.generate_train_test_split(resampled, seed=seed)

    cfg = TrainConfig(model="cls-ssg", num_classes=4, num_points=64,
                      batch_size=16, epochs=epochs, lr=1e-3, grad_clip=1.0,
                      decay_step=1e9, seed=seed)
    train_ds = KITTIResampledDataset(resampled, "train.txt")
    val_ds = KITTIResampledDataset(resampled, "test.txt")
    # trainset already yaw-augments during balancing; train un-augmented
    out = F.fit(cfg, train_ds, val_ds, workdir=os.path.join(workdir, "run"),
                augment_pipeline=(), eval_interval=1,
                early_stop_patience=epochs, max_steps=max_steps,
                device=dev)

    rep = F.test_report(out["model"], val_ds, cfg.batch_size,
                        class_names=list(kitti_etl.CATEGORIES),
                        heatmap_path=(os.path.join(workdir, "run",
                                                   "confusion_matrix.png")
                                      if heatmap else None), device=dev)

    det_dir = os.path.join(workdir, "detections")
    os.makedirs(det_dir, exist_ok=True)
    gt_files, det_files = [], []
    for fid in eval_ids:
        pts = pio.read_velodyne_bin(
            os.path.join(raw, "velodyne", fid + ".bin"))
        calib = pio.read_kitti_calib(
            os.path.join(raw, "calib", fid + ".txt"))
        rows = detect_frame(pts, calib, out["model"], out["state"],
                            cfg=DetectConfig(batch_size=8), seg_cfg=scfg,
                            seed=seed, device=dev)
        det_path = os.path.join(det_dir, fid + ".txt")
        with open(det_path, "w") as f:
            f.write("\n".join(rows) + ("\n" if rows else ""))
        det_files.append(det_path)
        gt_files.append(os.path.join(raw, "label_2", fid + ".txt"))

    ap = evaluate_detections(gt_files, det_files, metric="bev")
    return {"val_acc": out["best_val_acc"], "test_acc": rep["acc"],
            "ap": ap, "report": rep["report"], "fit": out}


def main(argv=None):
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--train-frames", type=int, default=10)
    p.add_argument("--eval-frames", type=int, default=4)
    p.add_argument("--epochs", type=int, default=12)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="cpu to run the port on the CPU (default: cuda)")
    args = p.parse_args(argv)
    res = run_task_loop(args.workdir, args.train_frames, args.eval_frames,
                        args.epochs, args.seed, device=args.device)
    print(res["report"])
    print(json.dumps({"val_acc": round(res["val_acc"], 4),
                      "test_acc": round(res["test_acc"], 4),
                      "ap_bev": {c: {d: (None if np.isnan(v) else round(v, 4))
                                     for d, v in per.items()}
                                 for c, per in res["ap"].items()}}))


if __name__ == "__main__":
    main()
