"""Dense, neighbour-list-free FPFH-33 and radius-covariance normals by
chunked matmuls (port of `pctpu/features/fpfh_dense.py`).

The pair mask `d2 <= r^2` comes from a tiled distance matmul; the
neighbourhood moments from one [Q,N]x[N,10] matmul per chunk, and the
normal is the least eigenvector of the covariance (`ops.eigh3`); the
Darboux features (f1, f2, f3) of every (row, column) pair expand into
row and column broadcasts over [B,Q,N], the histograms are 33 masked
sums, and FPFH's neighbour-weighted SPFH sum is one [Q,N]x[N,33] matmul.
The matmuls are plain `torch.matmul` in exact f32 (the package turns
TF32 off), as the reference leaves them to XLA outside any kernel. This
is `register_pairs`' `feature_backend="dense"`; the fused kernels K2/K3
(`features/pallas_fpfh.py`) compute the same descriptor without the
[B,Q,N] intermediates."""
from __future__ import annotations

import math
from typing import Optional

import torch

from pctpu_torch.device import f32_square
from pctpu_torch.ops.eigh3 import eigh3

N_BINS = 11
BIG = 1e30


def _chunks(n: int, q: int) -> int:
    return (n + q - 1) // q


def _pad_rows(x: torch.Tensor, q: int) -> torch.Tensor:
    """Zero-pad axis 1 of x [B,N,...] up to a multiple of q."""
    pad = (-x.shape[1]) % q
    if pad:
        x = torch.cat([x, x.new_zeros((x.shape[0], pad) + x.shape[2:])],
                      dim=1)
    return x


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


def _hist(f: torch.Tensor, lo: float, hi: float, wf: torch.Tensor,
          scale: torch.Tensor) -> torch.Tensor:
    """11 bins of f over [lo, hi), each the weight wf summed over the
    columns, times `scale` [B,Q] -> [B,Q,11]."""
    # a true division, as the reference's: CUDA turns a division by a
    # Python scalar into a product with its reciprocal
    width = torch.tensor(hi - lo, dtype=f.dtype, device=f.device)
    bin_ = torch.clamp(torch.floor((f - lo) / width * N_BINS), 0, N_BINS - 1)
    cols = [torch.sum(wf * (bin_ == j), dim=-1) for j in range(N_BINS)]
    return torch.stack(cols, dim=-1) * scale[..., None]


def fpfh_dense(points: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               normals: Optional[torch.Tensor] = None,
               radius: float = 10.0,
               normal_radius: float = 4.0,
               row_chunk: int = 512) -> torch.Tensor:
    """points [B,N,3] (or [N,3]) -> FPFH descriptors [B,N,33] (or [N,33]),
    `row_chunk` query rows at a time. Defaults: descriptor radius 10,
    normals (`normals_radius_dense`) at radius 4."""
    squeeze = points.dim() == 2
    if squeeze:
        points = points[None]
        mask = None if mask is None else mask[None]
        normals = None if normals is None else normals[None]
    b, n, _ = points.shape
    if mask is None:
        mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
    if normals is None:
        normals = normals_radius_dense(points, mask, radius=normal_radius,
                                       row_chunk=row_chunk)
    r2 = f32_square(radius)
    pts = torch.where(mask[..., None], points.float(),
                      torch.zeros_like(points, dtype=torch.float32))
    p2 = torch.sum(pts * pts, dim=-1)                         # [B,N]
    colpen = torch.where(mask, 0.0, BIG).float()[:, None, :]  # [B,1,N]
    ptsT = pts.transpose(1, 2)
    qs, ns = _pad_rows(pts, row_chunk), _pad_rows(normals, row_chunk)
    q2s = _pad_rows(p2[..., None], row_chunk)[..., 0]
    col_ids = torch.arange(n, device=points.device)[None, None, :]
    vx, vy, vz = (normals[:, None, :, i] for i in range(3))   # [B,1,N]
    px, py, pz = (pts[:, None, :, i] for i in range(3))

    def rows(i):
        sl = slice(i * row_chunk, (i + 1) * row_chunk)
        q, q2 = qs[:, sl], q2s[:, sl]
        row_ids = torch.arange(sl.start, sl.stop,
                               device=points.device)[None, :, None]
        d2 = q2[..., None] + p2[:, None, :] - 2.0 * torch.matmul(q, ptsT)
        within = (d2 + colpen <= r2) & (row_ids != col_ids)   # [B,Q,N]
        return q, d2, within.float()

    def spfh_chunk(i):
        q, d2, wf = rows(i)
        nq = ns[:, i * row_chunk:(i + 1) * row_chunk]
        dist = torch.sqrt(torch.clamp_min(d2, 1e-12))
        # pair displacement d = p_col - q_row, as row/column broadcasts
        dx, dy, dz = px - q[..., 0, None], py - q[..., 1, None], \
            pz - q[..., 2, None]
        inv_d = 1.0 / dist
        ux, uy, uz = nq[..., 0, None], nq[..., 1, None], nq[..., 2, None]
        f2 = (ux * dx + uy * dy + uz * dz) * inv_d
        gx = uy * vz - uz * vy                                # u x n_col
        gy = uz * vx - ux * vz
        gz = ux * vy - uy * vx
        s = torch.sqrt(torch.clamp_min(1.0 - f2 * f2, 0.0))
        inv_s = 1.0 / torch.clamp_min(s, 1e-12)
        f1 = (dx * gx + dy * gy + dz * gz) * inv_d * inv_s
        un = ux * vx + uy * vy + uz * vz
        dn = (dx * vx + dy * vy + dz * vz) * inv_d
        f3 = torch.atan2((dn - f2 * un) * inv_s, un)
        cnt = torch.clamp_min(torch.sum(wf, dim=-1), 1.0)     # [B,Q]
        # one rounding, as the reference (`100.0 / c` would be
        # c.reciprocal() * 100 here)
        scale = torch.full_like(cnt, 100.0) / cnt
        return torch.cat([_hist(f1, -1.0, 1.0, wf, scale),
                          _hist(f2, -1.0, 1.0, wf, scale),
                          _hist(f3, -math.pi, math.pi, wf, scale)], dim=-1)

    nchunks = _chunks(n, row_chunk)
    s33 = torch.cat([spfh_chunk(i) for i in range(nchunks)], dim=1)[:, :n]

    def fpfh_chunk(i):
        _, d2, wf = rows(i)
        wd = wf / torch.sqrt(torch.clamp_min(d2, 1e-12))     # 1/dist weights
        k_eff = torch.clamp_min(torch.sum(wf, dim=-1), 1.0)
        return torch.matmul(wd, s33) / k_eff[..., None]

    nbr = torch.cat([fpfh_chunk(i) for i in range(nchunks)], dim=1)[:, :n]
    blocks = (s33 + nbr).reshape(b, n, 3, N_BINS)
    sums = torch.clamp_min(torch.sum(blocks, dim=-1, keepdim=True), 1e-12)
    out = (100.0 * blocks / sums).reshape(b, n, 3 * N_BINS)
    out = torch.where(mask[..., None], out, torch.zeros_like(out))
    return out[0] if squeeze else out
