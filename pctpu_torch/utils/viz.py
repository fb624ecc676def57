"""Headless visualization writers (PLY) (port of `pctpu/utils/viz.py`,
numpy on the host): artifacts a remote job can emit in place of the
reference's interactive Open3D windows (`clustering.py:44-48`,
`ISS.py:78-84`, `detect.py:197-255`).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from pctpu_torch.core.io import write_ply

# a qualitative palette (12 colors), cycled for cluster ids
PALETTE = np.array([
    [228, 26, 28], [55, 126, 184], [77, 175, 74], [152, 78, 163],
    [255, 127, 0], [255, 255, 51], [166, 86, 40], [247, 129, 191],
    [153, 153, 153], [66, 206, 227], [178, 223, 138], [251, 154, 153],
], dtype=np.uint8)


def cluster_colors(labels: np.ndarray) -> np.ndarray:
    """labels [N] (-1=noise -> dark gray) -> uint8 colors [N,3]."""
    colors = PALETTE[np.maximum(labels, 0) % len(PALETTE)].copy()
    colors[labels < 0] = np.array([60, 60, 60], np.uint8)
    return colors


def write_clusters_ply(path: str, points: np.ndarray,
                       labels: np.ndarray) -> None:
    write_ply(path, points, cluster_colors(labels))


def write_registration_ply(path: str, src: np.ndarray, dst: np.ndarray,
                           T: Optional[np.ndarray] = None) -> None:
    """Source (red, transformed by T if given) + target (green) overlay —
    the reference's draw_registration_result analogue."""
    if T is not None:
        src = src @ T[:3, :3].T + T[:3, 3]
    pts = np.concatenate([src, dst])
    colors = np.concatenate([
        np.tile([255, 0, 0], (src.shape[0], 1)),
        np.tile([0, 255, 0], (dst.shape[0], 1))]).astype(np.uint8)
    write_ply(path, pts, colors)


def write_keypoints_ply(path: str, points: np.ndarray,
                        keypoint_mask: np.ndarray) -> None:
    """Cloud in green, keypoints in red (ISS demo analogue)."""
    colors = np.tile([0, 255, 0], (points.shape[0], 1)).astype(np.uint8)
    colors[keypoint_mask.astype(bool)] = [255, 0, 0]
    write_ply(path, points, colors)


def bbox_line_points(center: np.ndarray, dims: np.ndarray,
                     R: Optional[np.ndarray] = None,
                     samples_per_edge: int = 20) -> np.ndarray:
    """Densified wireframe of an oriented box (PLY has no lines; emit
    points along the 12 edges)."""
    l, h, w = dims
    corners = np.array([[sx * l / 2, sy * h / 2, sz * w / 2]
                        for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)])
    if R is not None:
        corners = corners @ R.T
    corners = corners + center
    edges = [(0, 1), (0, 2), (0, 4), (1, 3), (1, 5), (2, 3), (2, 6),
             (3, 7), (4, 5), (4, 6), (5, 7), (6, 7)]
    ts = np.linspace(0, 1, samples_per_edge)[:, None]
    pts = [corners[a] * (1 - ts) + corners[b] * ts for a, b in edges]
    return np.concatenate(pts)


def write_detections_ply(path: str, points: np.ndarray,
                         boxes: Sequence[Dict]) -> None:
    """Frame cloud (gray) + colored bbox wireframes.

    Each box: {'center': [3], 'dims': [3], 'R': [3,3] or None,
    'class_id': int}."""
    all_pts = [points]
    all_cols = [np.tile([120, 120, 120], (points.shape[0], 1))]
    for b in boxes:
        wire = bbox_line_points(np.asarray(b["center"]),
                                np.asarray(b["dims"]), b.get("R"))
        all_pts.append(wire)
        col = PALETTE[b.get("class_id", 0) % len(PALETTE)]
        all_cols.append(np.tile(col, (wire.shape[0], 1)))
    write_ply(path, np.concatenate(all_pts),
              np.concatenate(all_cols).astype(np.uint8))


def write_trajectory_ply(path: str, poses: np.ndarray) -> None:
    """[M,4,4] trajectory -> PLY of positions colored by time."""
    pos = poses[:, :3, 3]
    t = np.linspace(0, 1, pos.shape[0])
    colors = np.stack([255 * t, np.zeros_like(t), 255 * (1 - t)],
                      axis=1).astype(np.uint8)
    write_ply(path, pos, colors)
