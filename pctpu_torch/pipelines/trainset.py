"""Balanced training-set generation from the extracted KITTI objects.

Re-design of `Final_Project/scripts/1_generating-training-set.py` (C41):
ROI filter (<= 25 m), class rebalancing by upsampling each class to the
'misc' count with random z-yaw in [-pi/4, pi/4], distance-weighted resample
to 64 points + zero-center, and a stratified 80/20 split written as
object_names.txt / train.txt / test.txt.

The port's numpy copy of `pctpu/pipelines/trainset.py`, on the port's
`nn/data.py:distance_weighted_resample`.
"""
from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from pctpu_torch.nn.data import distance_weighted_resample

CATEGORIES = ("vehicle", "pedestrian", "cyclist", "misc")


def _yaw_matrix(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def preprocess_object(pcd_with_normal: np.ndarray, num_sample_points: int,
                      yaw: Optional[float], rng: np.random.Generator
                      ) -> np.ndarray:
    """Resample + zero-center + optional z-yaw rotation
    (1_generating-training-set.py:160-233)."""
    pts, nrm = pcd_with_normal[:, :3], pcd_with_normal[:, 3:6]
    p, n = distance_weighted_resample(pts, num_sample_points, rng, extra=nrm)
    if yaw is not None:
        R = _yaw_matrix(yaw)
        p = p @ R.T
        n = n @ R.T
    return np.hstack([p, n]).astype(np.float32)


def generate_training_set(input_dir: str, output_dir: str,
                          max_radius_distance: float = 25.0,
                          num_sample_points: int = 64,
                          seed: int = 0) -> Dict[str, int]:
    """ROI filter + balance-to-misc upsampling with yaw augmentation
    (`:235-335`). Reads the per-class object CSVs written by kitti_etl."""
    rng = np.random.default_rng(seed)
    if os.path.exists(output_dir):
        shutil.rmtree(output_dir)
    os.makedirs(output_dir)

    # stage 1: ROI filter
    files: Dict[str, List[str]] = {}
    for category in CATEGORIES:
        cdir = os.path.join(input_dir, category)
        os.makedirs(os.path.join(output_dir, category))
        files[category] = []
        if not os.path.isdir(cdir):
            continue
        for fn in sorted(os.listdir(cdir)):
            if not fn.endswith(".txt"):
                continue
            arr = np.loadtxt(os.path.join(cdir, fn), delimiter=",",
                             skiprows=1, ndmin=2)
            if arr.shape[0] <= 3:   # hard case, ignored (`:309-311`)
                continue
            center = arr[:, :2].mean(axis=0)
            if np.linalg.norm(center) <= max_radius_distance:
                files[category].append(os.path.join(cdir, fn))

    counts = {c: len(files[c]) for c in CATEGORIES}
    misc_count = max(counts.get("misc", 0), 1)

    # stage 2: rebalance by upsampling to the misc count
    out_counts = {}
    for category in CATEGORIES:
        n_out = 0
        ratio = int(np.ceil(misc_count / max(counts[category], 1)))
        for path in files[category]:
            arr = np.loadtxt(path, delimiter=",", skiprows=1, ndmin=2)
            reps = 1 if ratio <= 1 else 1 + ratio
            for _ in range(reps):
                yaw = np.pi / 4.0 * (2 * rng.random() - 1.0)
                out = preprocess_object(arr, num_sample_points, yaw, rng)
                np.savetxt(os.path.join(output_dir, category,
                                        f"{n_out:06d}.txt"),
                           out, delimiter=",")
                n_out += 1
        out_counts[category] = n_out
    return out_counts


def generate_train_test_split(dataset_dir: str, test_frac: float = 0.2,
                              seed: int = 0) -> None:
    """Stratified 80/20 split files (`:337-399`): object_names.txt,
    train.txt, test.txt with `{category}_{idx}` ids."""
    rng = np.random.default_rng(seed)
    train_ids, test_ids = [], []
    with open(os.path.join(dataset_dir, "object_names.txt"), "w") as f:
        f.write("\n".join(CATEGORIES) + "\n")
    for category in CATEGORIES:
        cdir = os.path.join(dataset_dir, category)
        if not os.path.isdir(cdir):
            continue
        ids = [f"{category}_{int(os.path.splitext(fn)[0])}"
               for fn in sorted(os.listdir(cdir)) if fn.endswith(".txt")]
        perm = rng.permutation(len(ids))
        n_test = int(np.floor(test_frac * len(ids)))
        test_ids += [ids[i] for i in perm[:n_test]]
        train_ids += [ids[i] for i in perm[n_test:]]
    with open(os.path.join(dataset_dir, "train.txt"), "w") as f:
        f.write("\n".join(train_ids) + "\n")
    with open(os.path.join(dataset_dir, "test.txt"), "w") as f:
        f.write("\n".join(test_ids) + "\n")
