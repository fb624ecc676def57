"""Plain reference of the `reg-hdl64` registration chain: voxel
downsample, radius normals, FPFH-33, mutual matching, RANSAC and the two
ICP stages, with the semantics of `RegistrationConfig()`'s batched path.

Plain PyTorch (the voxel grid's sums in float64, the rest float32, on
whatever device the tensors live), importing nothing of the program.
The descriptor, matching and RANSAC code are frozen copies of the port's
plain versions (`features/fpfh_dense.py`, `features/matching.py`,
`register/ransac.py`); the ICP is written out from its definition: each
iteration associates every valid source point with its exact nearest
target (ties averaged), keeps the pairs closer than the threshold, and
composes the Procrustes step of their moments (summed in float64).

Every float32 product that a matmul computes goes through
`plain_geometry.mm`, so `tf32=True` runs the whole chain with its matmul
operands rounded to TF32: the control."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.common.plain_geometry import (f32_square, make_transform, mm,
                                             normals_radius,
                                             procrustes_from_moments,
                                             tf32_round, weighted_procrustes)

N_BINS = 11
BIG = 1e30


# ---------------------------------------------------------------------------
# voxel grid (float64 means)
# ---------------------------------------------------------------------------

def voxel_capped(points: torch.Tensor, leaf: float, cap: int,
                 max_cells: int = 1024, tf32: bool = False):
    """One cloud [N,3] float32 (every point valid) -> (voxel centroids
    [cap,3] float32, mask [cap], voxel count). Cells are
    floor((p - min) / leaf) in float32, clamped to `max_cells` a side;
    voxels come in (x, y, z) cell order; with more than `cap` voxels,
    voxel j*nv//cap is kept. The centroids are the voxels' sums over their
    counts in float64 (exact for float32 points, in any order); with `tf32`
    the points enter the sums rounded to TF32, as a tensor core would take
    a membership matrix's product with them."""
    p = points.float()
    pmin = p.min(dim=0).values
    cellf = torch.floor((p - pmin) / torch.tensor(leaf, dtype=torch.float32,
                                                  device=p.device))
    cell = torch.clamp(cellf, 0, max_cells - 1).long()
    key = (cell[:, 0] * max_cells + cell[:, 1]) * max_cells + cell[:, 2]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    nv = len(uniq)
    ps = tf32_round(p) if tf32 else p
    sums = torch.zeros((nv, 3), dtype=torch.float64, device=p.device)
    sums.index_add_(0, inv, ps.double())
    cnt = torch.bincount(inv, minlength=nv).double()
    cent = (sums / cnt[:, None]).float()
    j = torch.arange(cap, device=p.device)
    sel = (j * nv) // cap if nv > cap else torch.clamp_max(j, nv - 1)
    out_mask = j < min(nv, cap)
    out = cent[sel]
    out[~out_mask] = out[0].clone()
    return out, out_mask, nv


# ---------------------------------------------------------------------------
# normals and FPFH-33 (dense, chunked)
# ---------------------------------------------------------------------------

def _hist(f, lo, hi, wf, scale):
    width = torch.tensor(hi - lo, dtype=f.dtype, device=f.device)
    bin_ = torch.clamp(torch.floor((f - lo) / width * N_BINS), 0, N_BINS - 1)
    cols = [torch.sum(wf * (bin_ == j), dim=-1) for j in range(N_BINS)]
    return torch.stack(cols, dim=-1) * scale[..., None]


def fpfh(points, mask, radius, normal_radius, tf32=False, row_chunk=512):
    """[B,N,3], [B,N] -> FPFH-33 [B,N,33] (radius neighbours, self
    excluded; normals by `normals_radius`)."""
    b, n, _ = points.shape
    normals = normals_radius(points, mask, normal_radius, tf32, row_chunk)
    r2 = f32_square(radius)
    pts = torch.where(mask[..., None], points.float(),
                      torch.zeros_like(points, dtype=torch.float32))
    p2 = torch.sum(pts * pts, dim=-1)
    colpen = torch.where(mask, 0.0, BIG).float()[:, None, :]
    ptsT = pts.transpose(1, 2)
    col_ids = torch.arange(n, device=points.device)[None, None, :]
    vx, vy, vz = (normals[:, None, :, i] for i in range(3))
    px, py, pz = (pts[:, None, :, i] for i in range(3))

    def rows(s):
        q, q2 = pts[:, s:s + row_chunk], p2[:, s:s + row_chunk]
        row_ids = torch.arange(s, s + q.shape[1],
                               device=points.device)[None, :, None]
        d2 = q2[..., None] + p2[:, None, :] - 2.0 * mm(q, ptsT, tf32)
        within = (d2 + colpen <= r2) & (row_ids != col_ids)
        return q, d2, within.float()

    spfh = []
    for s in range(0, n, row_chunk):
        q, d2, wf = rows(s)
        nq = normals[:, s:s + row_chunk]
        dist = torch.sqrt(torch.clamp_min(d2, 1e-12))
        dx, dy, dz = px - q[..., 0, None], py - q[..., 1, None], \
            pz - q[..., 2, None]
        inv_d = 1.0 / dist
        ux, uy, uz = nq[..., 0, None], nq[..., 1, None], nq[..., 2, None]
        f2 = (ux * dx + uy * dy + uz * dz) * inv_d
        gx, gy, gz = uy * vz - uz * vy, uz * vx - ux * vz, ux * vy - uy * vx
        sn = torch.sqrt(torch.clamp_min(1.0 - f2 * f2, 0.0))
        inv_s = 1.0 / torch.clamp_min(sn, 1e-12)
        f1 = (dx * gx + dy * gy + dz * gz) * inv_d * inv_s
        un = ux * vx + uy * vy + uz * vz
        dn = (dx * vx + dy * vy + dz * vz) * inv_d
        f3 = torch.atan2((dn - f2 * un) * inv_s, un)
        cnt = torch.clamp_min(torch.sum(wf, dim=-1), 1.0)
        scale = torch.full_like(cnt, 100.0) / cnt
        spfh.append(torch.cat([_hist(f1, -1.0, 1.0, wf, scale),
                               _hist(f2, -1.0, 1.0, wf, scale),
                               _hist(f3, -math.pi, math.pi, wf, scale)],
                              dim=-1))
    s33 = torch.cat(spfh, dim=1)
    nbr = []
    for s in range(0, n, row_chunk):
        _, d2, wf = rows(s)
        wd = wf / torch.sqrt(torch.clamp_min(d2, 1e-12))
        k_eff = torch.clamp_min(torch.sum(wf, dim=-1), 1.0)
        nbr.append(mm(wd, s33, tf32) / k_eff[..., None])
    blocks = (s33 + torch.cat(nbr, dim=1)).reshape(b, n, 3, N_BINS)
    sums = torch.clamp_min(torch.sum(blocks, dim=-1, keepdim=True), 1e-12)
    out = (100.0 * blocks / sums).reshape(b, n, 3 * N_BINS)
    return torch.where(mask[..., None], out, torch.zeros_like(out))


# ---------------------------------------------------------------------------
# mutual matching
# ---------------------------------------------------------------------------

def match(src_feats, dst_feats, src_mask, dst_mask, tf32=False):
    """Mutual nearest neighbours in descriptor space -> (dst_idx [B,M]
    int64, valid [B,M] bool); ties go to the first index."""
    a, b_ = src_feats.float(), dst_feats.float()
    m = a.shape[-2]
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b_ * b_, dim=-1)[..., None, :]
    d2 = torch.clamp_min(a2 + b2 - 2.0 * mm(a, b_.transpose(-1, -2), tf32),
                         0.0)
    d2 = torch.where(dst_mask[..., None, :], d2, torch.full_like(d2, BIG))
    best_dst = torch.argmin(d2, dim=-1)
    d2b = torch.where(src_mask[..., :, None], d2, torch.full_like(d2, BIG))
    best_src = torch.argmin(d2b, dim=-2)
    back = torch.gather(best_src, -1, best_dst)
    rows = torch.arange(m, device=d2.device).expand(best_dst.shape)
    return best_dst, src_mask & (back == rows)


# ---------------------------------------------------------------------------
# RANSAC (batched, capped, given draws)
# ---------------------------------------------------------------------------

def _rows(x, idx):
    """x [B,N,C], idx [B,M] -> [B,M,C] (indices clipped to [0, N-1])."""
    idx = torch.clamp(idx, 0, x.shape[1] - 1).long()
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _triad_rigid(s, d):
    def triad(x):
        a = x[..., 1, :] - x[..., 0, :]
        b = x[..., 2, :] - x[..., 0, :]
        e1 = a / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=-1, keepdim=True), 1e-12)
        b_perp = b - torch.sum(b * e1, dim=-1, keepdim=True) * e1
        bn = torch.linalg.vector_norm(b_perp, dim=-1, keepdim=True)
        e2 = b_perp / torch.clamp_min(bn, 1e-12)
        e3 = torch.stack([e1[..., 1] * e2[..., 2] - e1[..., 2] * e2[..., 1],
                          e1[..., 2] * e2[..., 0] - e1[..., 0] * e2[..., 2],
                          e1[..., 0] * e2[..., 1] - e1[..., 1] * e2[..., 0]],
                         dim=-1)
        return torch.stack([e1, e2, e3], dim=-1), bn[..., 0]

    Fs, ns = triad(s)
    Fd, nd = triad(d)
    R = Fd @ Fs.transpose(-1, -2)
    t = torch.mean(d, dim=-2) - (R @ torch.mean(s, dim=-2)[..., None])[..., 0]
    return R, t, (ns > 1e-6) & (nd > 1e-6)


def _edge_lens(x):
    nrm = torch.linalg.vector_norm
    return torch.stack([nrm(x[..., 0, :] - x[..., 1, :], dim=-1),
                        nrm(x[..., 0, :] - x[..., 2, :], dim=-1),
                        nrm(x[..., 1, :] - x[..., 2, :], dim=-1)], dim=-1)


def ransac(src_pts, dst_pts, valid, sampler, dist_thresh, num_hypotheses,
           m_cap, edge_ratio=0.9, tf32=False):
    """Correspondences [B,M,3] x2, valid [B,M] -> best rigid T [B,4,4]:
    the valid correspondences compacted to the front (stable) and capped
    at `m_cap`; `num_hypotheses` 3-point samples from `sampler(nv, H)`,
    each solved exactly, checked (edge ratio, non-degenerate) and scored
    by its inliers; the best (first of the maximum) refit to its inliers
    by weighted Procrustes."""
    b, m, _ = src_pts.shape
    H = num_hypotheses
    dev = src_pts.device
    src_pts, dst_pts = src_pts.float(), dst_pts.float()
    thresh2 = float(np.float32(dist_thresh)) ** 2
    order = torch.argsort(torch.where(valid, 0, 1), dim=1, stable=True)
    if m_cap < m:
        sel = order[:, :m_cap]
        src_pts, dst_pts = _rows(src_pts, sel), _rows(dst_pts, sel)
        valid = _rows(valid[..., None], sel)[..., 0]
        m = m_cap
        order = torch.arange(m, device=dev).expand(b, m)
    nv = torch.clamp_min(valid.sum(dim=1, dtype=torch.int32), 1)
    u = sampler(nv, H).to(dev).reshape(b, H * 3)
    samples = _rows(order[..., None], u)[..., 0]
    s = _rows(src_pts, samples).reshape(b, H, 3, 3)
    d = _rows(dst_pts, samples).reshape(b, H, 3, 3)
    samp_valid = _rows(valid[..., None], samples)[..., 0].reshape(b, H, 3)
    es, ed = _edge_lens(s), _edge_lens(d)
    ok = torch.all((es > edge_ratio * ed) & (ed > edge_ratio * es), dim=-1)
    ok = ok & torch.all(samp_valid, dim=-1)
    Rs, ts, nondegen = _triad_rigid(s, d)
    ok = ok & nondegen
    p2 = torch.sum(src_pts * src_pts, dim=-1)
    q2 = torch.sum(dst_pts * dst_pts, dim=-1)
    qp = dst_pts[..., :, None] * src_pts[..., None, :]
    G = torch.cat([(p2 + q2)[:, None, :],
                   torch.ones((b, 1, m), dtype=torch.float32, device=dev),
                   src_pts.transpose(1, 2),
                   qp.reshape(b, m, 9).transpose(1, 2),
                   dst_pts.transpose(1, 2)], dim=1)
    tR = (ts[..., None, :] @ Rs)[..., 0, :]
    F = torch.cat([torch.ones((b, H, 1), dtype=torch.float32, device=dev),
                   torch.sum(ts * ts, dim=-1, keepdim=True), 2.0 * tR,
                   -2.0 * Rs.reshape(b, H, 9), -2.0 * ts], dim=2)
    err2 = mm(F, G, tf32)
    inl = (err2 < thresh2) & valid[:, None, :]
    scores = inl.sum(dim=2, dtype=torch.int32) * ok.int()
    best = torch.argmax(scores, dim=1)
    ar = torch.arange(b, device=dev)
    R, t = weighted_procrustes(src_pts, dst_pts, inl[ar, best].float(), tf32)
    return make_transform(R, t)


# ---------------------------------------------------------------------------
# ICP (exact association, fixed iterations)
# ---------------------------------------------------------------------------

def _rot_apply(R, t, q, tf32):
    """R q + t of [M,3] points, each row as r0*q0 + r1*q1 + r2*q2 + t in
    separately rounded float32 steps (operands in TF32 under `tf32`)."""
    if tf32:
        R, q = tf32_round(R), tf32_round(q)
    return torch.stack([q[:, 0] * R[a, 0] + q[:, 1] * R[a, 1]
                        + q[:, 2] * R[a, 2] + t[a] for a in range(3)], dim=1)


def icp(src, src_mask, dst, dst_mask, init_T, iters, dist_thresh,
        tf32=False, query_chunk=1024):
    """Point-to-point ICP of one pair: src [M,3], dst [N,3] (masks
    [M], [N]) from init_T [4,4], `iters` fixed iterations -> T [4,4].
    An iteration moves the source by the pose, finds each valid source
    point's nearest valid target by |b|^2 - 2 b.q (the mean of all targets
    at the minimum), keeps those with |q - b|^2 < thresh^2, and composes
    the Procrustes step of their moments (summed in float64); with fewer
    than 3 pairs the pose stays. The distances are the dot-product form
    the port's kernels keep, each product and sum rounded on its own in
    float32; under `tf32` their operands are rounded to TF32, as a tensor
    core's matmul of q and b would take them."""
    thresh2 = f32_square(dist_thresh)
    dstf = torch.where(dst_mask[:, None], dst.float(), torch.zeros_like(dst))
    pen2 = torch.sum(dstf * dstf, dim=-1) + torch.where(dst_mask, 0.0, BIG)
    db4 = torch.cat([dstf, torch.ones_like(dstf[:, :1])], dim=1)
    dbr = tf32_round(dstf) if tf32 else dstf
    bx, by, bz = (dbr[None, :, k] for k in range(3))
    q_all = src.float()[src_mask]
    T = init_T.float().clone()
    for _ in range(iters):
        R, t = T[:3, :3], T[:3, 3]
        m44 = torch.zeros((4, 4), dtype=torch.float64, device=src.device)
        for s in range(0, q_all.shape[0], query_chunk):
            q = _rot_apply(R, t, q_all[s:s + query_chunk], tf32)
            a = -2.0 * (tf32_round(q) if tf32 else q)
            d2 = ((bx * a[:, 0:1] + by * a[:, 1:2]) + bz * a[:, 2:3]) \
                + pen2[None, :]
            minv = torch.amin(d2, dim=1)
            sel = (d2 <= minv[:, None]).float()
            ext = mm(sel, db4, tf32)
            matched = ext[:, :3] / torch.clamp_min(ext[:, 3:], 1.0)
            qn = q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1] + q[:, 2] * q[:, 2]
            w = ((minv + qn) < thresh2).double()
            hp = torch.cat([q, torch.ones_like(q[:, :1])], 1).double()
            hq = torch.cat([matched, torch.ones_like(q[:, :1])], 1).double()
            m44 += (hp * w[:, None]).T @ hq
        m44 = m44.float()
        Ri, ti = procrustes_from_moments(m44)
        if float(m44[3, 3]) >= 3.0:
            T = make_transform(Ri @ R, Ri @ t + ti)
    return T


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def voxels(clouds: np.ndarray, cfg: dict, device, tf32: bool = False):
    """Raw host clouds [B,N,3] (all points valid) -> (voxel points [B,cap,3],
    mask [B,cap]) as tensors on `device`."""
    res = [voxel_capped(torch.from_numpy(c).to(device), cfg["voxel_size"],
                        cfg["downsample_capacity"], tf32=tf32)
           for c in clouds]
    return (torch.stack([r[0] for r in res]),
            torch.stack([r[1] for r in res]))


def refine_inputs(src_full, cfg):
    """The strided full-resolution source subsample of the refine stage."""
    n = src_full.shape[1]
    stride = max(1, n // cfg["refine_subsample"])
    return src_full[:, ::stride][:, :cfg["refine_subsample"]]
