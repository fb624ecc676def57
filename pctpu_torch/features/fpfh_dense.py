"""Radius-covariance normals by dense chunked matmuls (port of
`pctpu/features/fpfh_dense.py:normals_radius_dense`).

The pair mask `d2 <= r^2` comes from a tiled distance matmul, the
neighbourhood moments from one [Q,N]x[N,10] matmul per chunk, and the
normal is the least eigenvector of the covariance (`ops.eigh3`). The
matmuls are plain `torch.matmul` in exact f32 (the package turns TF32
off), as the reference leaves them to XLA outside any kernel."""
from __future__ import annotations

import torch

from pctpu_torch.ops.eigh3 import eigh3

BIG = 1e30


def normals_radius_dense(points: torch.Tensor, mask: torch.Tensor,
                         radius: float = 4.0,
                         row_chunk: int = 512) -> torch.Tensor:
    """points [B,N,3], mask [B,N] -> [B,N,3] unit normals (least
    eigenvector of the covariance of ALL radius neighbours, self included;
    sign unoriented)."""
    b, n, _ = points.shape
    r2 = float(radius) ** 2
    pts = torch.where(mask[..., None], points.float(),
                      torch.zeros_like(points, dtype=torch.float32))
    p2 = torch.sum(pts * pts, dim=-1)                         # [B,N]
    colpen = torch.where(mask, 0.0, BIG).float()
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    feats = torch.stack([x, y, z, x * x, y * y, z * z,
                         x * y, x * z, y * z, torch.ones_like(x)], dim=-1)
    ptsT = pts.transpose(1, 2)

    moms = []
    for s in range(0, n, row_chunk):
        q = pts[:, s:s + row_chunk]
        q2 = p2[:, s:s + row_chunk]
        d2 = (q2[..., None] + p2[:, None, :] + colpen[:, None, :]
              - 2.0 * torch.matmul(q, ptsT))
        w = (d2 <= r2).float()                                # [B,Q,N]
        moms.append(torch.matmul(w, feats))                   # [B,Q,10]
    return normals_from_moments(torch.cat(moms, dim=1))


def normals_from_moments(mom: torch.Tensor) -> torch.Tensor:
    """[...,10] neighbourhood moments [x,y,z,x2,y2,z2,xy,xz,yz,count]
    (shifted or not: the covariance is translation-invariant) -> [...,3]
    unit normals, the least eigenvector of the covariance."""
    cnt = torch.clamp_min(mom[..., 9], 1.0)
    mu = mom[..., 0:3] / cnt[..., None]
    exx = mom[..., 3:9] / cnt[..., None]
    c00 = exx[..., 0] - mu[..., 0] * mu[..., 0]
    c11 = exx[..., 1] - mu[..., 1] * mu[..., 1]
    c22 = exx[..., 2] - mu[..., 2] * mu[..., 2]
    c01 = exx[..., 3] - mu[..., 0] * mu[..., 1]
    c02 = exx[..., 4] - mu[..., 0] * mu[..., 2]
    c12 = exx[..., 5] - mu[..., 1] * mu[..., 2]
    C = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c01, c11, c12], dim=-1),
        torch.stack([c02, c12, c22], dim=-1)], dim=-2)        # [...,3,3]
    _, vecs = eigh3(C)
    nrm = vecs[..., :, 0]
    return nrm / torch.clamp_min(
        torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), 1e-12)
