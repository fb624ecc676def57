"""SE(3) / quaternion utilities (port of `pctpu/core/se3.py`).

Quaternions are (w, x, y, z); RTE/RRE follow the reference evaluator
(`evaluate_rt.py:21-29`: RRE = sum of |extrinsic-xyz Euler angles|)."""
from __future__ import annotations

import math

import torch


def _copysign_ref(v, s):
    # flip v only when v*s < 0 (reference semantics)
    return torch.where(v * s < 0, -v, v)


def rotmat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """[...,3,3] rotation matrix -> [...,4] quaternion (w,x,y,z)."""
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    d0, d1, d2 = m[..., 0, 0], m[..., 1, 1], m[..., 2, 2]
    qw = torch.sqrt(torch.clamp_min(1.0 + t, 0.0)) / 2
    qx = torch.sqrt(torch.clamp_min(1.0 + d0 - d1 - d2, 0.0)) / 2
    qy = torch.sqrt(torch.clamp_min(1.0 - d0 + d1 - d2, 0.0)) / 2
    qz = torch.sqrt(torch.clamp_min(1.0 - d0 - d1 + d2, 0.0)) / 2
    qx = _copysign_ref(qx, m[..., 2, 1] - m[..., 1, 2])
    qy = _copysign_ref(qy, m[..., 0, 2] - m[..., 2, 0])
    qz = _copysign_ref(qz, m[..., 1, 0] - m[..., 0, 1])
    return torch.stack([qw, qx, qy, qz], dim=-1)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[...,4] (w,x,y,z) quaternion, normalised first -> [...,3,3]
    rotation matrix."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([torch.stack([r00, r01, r02], dim=-1),
                        torch.stack([r10, r11, r12], dim=-1),
                        torch.stack([r20, r21, r22], dim=-1)], dim=-2)


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[...,3,3] R + [...,3] t -> [...,4,4] homogeneous transform."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def transform_to_tq(T: torch.Tensor):
    """[...,4,4] -> ([...,3] t, [...,4] q_wxyz)."""
    return T[..., :3, 3], rotmat_to_quat(T[..., :3, :3])


def tq_to_transform(t: torch.Tensor, q_wxyz: torch.Tensor) -> torch.Tensor:
    """[...,3] t + [...,4] q_wxyz -> [...,4,4]."""
    return make_transform(quat_to_rotmat(q_wxyz), t)


def invert_transform(T: torch.Tensor) -> torch.Tensor:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return make_transform(Rt, -(Rt @ t[..., None])[..., 0])


def apply_transform(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """[...,4,4] @ [...,N,3] -> [...,N,3] (exact f32: the package turns
    TF32 off)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return torch.matmul(points, R.transpose(-1, -2)) + t[..., None, :]


def rotmat_to_euler_xyz(m: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,3] extrinsic-xyz Euler angles (radians), scipy
    `as_euler('xyz')` convention."""
    sy = torch.clamp(-m[..., 2, 0], -1.0, 1.0)
    y = torch.asin(sy)
    cy = torch.sqrt(torch.clamp_min(m[..., 2, 1] ** 2 + m[..., 2, 2] ** 2,
                                    1e-24))
    locked = cy < 1e-7
    x = torch.where(locked, torch.zeros_like(y),
                    torch.atan2(m[..., 2, 1], m[..., 2, 2]))
    z = torch.where(locked,
                    torch.atan2(-m[..., 0, 1], m[..., 1, 1]),
                    torch.atan2(m[..., 1, 0], m[..., 0, 0]))
    return torch.stack([x, y, z], dim=-1)


def pose_diff_rte_rre(P_pred: torch.Tensor, P_gt: torch.Tensor):
    """RTE (m) and RRE (deg) between predicted and ground-truth poses."""
    P_diff = invert_transform(P_pred) @ P_gt
    rte = torch.linalg.vector_norm(P_diff[..., :3, 3], dim=-1)
    ang = rotmat_to_euler_xyz(P_diff[..., :3, :3])
    rre = torch.sum(torch.abs(torch.rad2deg(ang)), dim=-1)
    return rte, rre


def rotation_angle_deg(R: torch.Tensor) -> torch.Tensor:
    """Geodesic rotation angle in degrees."""
    t = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((t - 1.0) / 2.0, -1.0, 1.0)
    return torch.acos(c) * (180.0 / math.pi)
