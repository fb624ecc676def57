"""KITTI frame transforms (velo <-> cam <-> pixel <-> object), numpy.

Parity with `Final_Project/scripts/transform_coords_utils.py:4-58` and
`scripts/extract.py:86-164`.

The port's numpy copy of `pctpu/pipelines/kitti_frames.py`.
"""
from __future__ import annotations

import numpy as np


def velo_to_cam(X_velo: np.ndarray, calib: dict) -> np.ndarray:
    """R0_rect . (R_v2c . X + t)."""
    R0 = calib["R0_rect"]
    Tr = calib["Tr_velo_to_cam"]
    Rvc, tvc = Tr[:, :3], Tr[:, 3]
    return (X_velo @ Rvc.T + tvc) @ R0.T


def cam_to_velo(X_cam: np.ndarray, calib: dict) -> np.ndarray:
    R0 = calib["R0_rect"]
    Tr = calib["Tr_velo_to_cam"]
    Rvc, tvc = Tr[:, :3], Tr[:, 3]
    return (X_cam @ R0 - tvc) @ Rvc


def cam_to_pixel(X_cam: np.ndarray, calib: dict) -> np.ndarray:
    """P2 intrinsics + perspective divide -> [N,2] pixel coords."""
    P2 = calib["P2"]
    homo = np.hstack([X_cam, np.ones((X_cam.shape[0], 1))])
    proj = homo @ P2.T
    return proj[:, :2] / np.maximum(proj[:, 2:3], 1e-9)


def ry_rotation(ry: float) -> np.ndarray:
    """Object heading rotation about the camera y axis (extract.py:148-157)."""
    c, s = np.cos(ry), np.sin(ry)
    return np.asarray([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def velo_to_obj(X_velo: np.ndarray, calib: dict, t_obj_cam: np.ndarray,
                ry: float) -> np.ndarray:
    """Velodyne points -> KITTI object frame (extract.py:116-164)."""
    X_cam = velo_to_cam(X_velo, calib)
    R = ry_rotation(ry)
    return (X_cam - t_obj_cam) @ R
