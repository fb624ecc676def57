"""Plain reference of the `reg-hdl64-single` chain: one pair through
`register_pair` with `RegistrationConfig()` defaults: the uncapped voxel
grid and its uniform cap, kNN normals, FPFH-33 from radius neighbour
lists, mutual matching, RANSAC, the windowed whole-scan ICP of kernel 5
(`icp_fixed_coarse` windowed iterations, then `icp_fixed_polish` exact
ones) and the 1-NN statistics at the final pose.

Plain PyTorch in float32 (moment and voxel sums in float64), on whatever
device the tensors live, importing nothing of the program. Matching and
RANSAC are `reference/reg-hdl64.py`'s, loaded by path; the rest is
written here from its definition. Every float32 product a matmul computes
goes through `plain_geometry.mm`, so `tf32=True` runs the chain with its
matmul operands rounded to TF32: the control.

Departures from the published chain (the reference's
`Registration/main.py`: Open3D's voxel grid, hybrid radius-4 m / 30-NN
normals, FPFH at 10 m with at most 100 neighbours, RANSAC over mutual
matches to 100,000 iterations at 0.999 confidence, then point-to-point
ICP with a KD-tree's exact 1-NN, a 5 m gate and a convergence test up to
100 iterations, Procrustes by SVD):
  - the voxel cloud is capped at `downsample_capacity` voxels, voxel
    i * nv // cap kept when more are valid;
  - normals from the 30 nearest neighbours alone (no 4 m radius), the
    point itself included, with the sign the eigensolver gives;
  - FPFH sees at most the `feature_k_cap` nearest neighbours within the
    radius, lowest index first on ties;
  - RANSAC scores a fixed `ransac_hypotheses` draws, injected by the
    caller, and refits the best to its inliers;
  - the ICP runs a fixed number of iterations; in the windowed ones each
    tile of `query_tile` sources, ordered along the db's widest axis,
    searches only `window_blocks` blocks of `block` db points along that
    axis, so it can miss a query's true nearest neighbour; ties are
    averaged; the rotation is the Newton polar factor (6 iterations), and
    the pose stays put with fewer than 3 correspondences."""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np
import torch

from portbench.common.plain_geometry import (cross, eigh3, f32_square,
                                             make_transform, mm, tf32_round)

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BIG = 1e30
N_BINS = 11
LUT_BINS = 1024


def _load_batched_reference():
    path = Path(__file__).with_name("reg-hdl64.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_reference_reg_hdl64_for_single", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_batched = _load_batched_reference()


# ---------------------------------------------------------------------------
# the voxel grid and its uniform cap
# ---------------------------------------------------------------------------

def voxel_grid(points: torch.Tensor, leaf: float, cap: int,
               tf32: bool = False):
    """One cloud [N,3] (every point valid) -> (voxel centroids [K,3],
    mask [K], voxel count nv), K = min(N, cap). Cells are
    floor((p - min) / leaf) in float32 with no clamp; voxels in (x, y, z)
    cell order; each centroid the voxel's float64 sum over its count
    (with `tf32` the points enter the sums rounded to TF32, as a tensor
    core would take a membership matrix's product with them). With more
    than `cap` voxels, voxel i * nv // cap is kept; else the first nv
    slots hold the voxels and the rest repeat the first."""
    p = points.float()
    n = p.shape[0]
    pmin = p.min(dim=0).values
    cell = torch.floor((p - pmin) / float(leaf)).long()
    ext = cell.max(dim=0).values + 1
    key = (cell[:, 0] * ext[1] + cell[:, 1]) * ext[2] + cell[:, 2]
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    nv = len(uniq)
    sums = torch.zeros((nv, 3), dtype=torch.float64, device=p.device)
    sums.index_add_(0, inv, (tf32_round(p) if tf32 else p).double())
    cnt = torch.bincount(inv, minlength=nv).double()
    cent = (sums / cnt[:, None]).float()
    k = min(n, cap)
    i = torch.arange(k, device=p.device)
    idx = (i * nv) // cap if nv > cap else i
    mask = idx < nv
    out = cent[torch.clamp_max(idx, nv - 1)]
    out[~mask] = cent[0]
    return out, mask, nv


def voxels(cloud: np.ndarray, cfg: dict, device, tf32: bool = False):
    """A raw host cloud [N,3] -> (voxel points [K,3], mask [K], nv) on
    `device`."""
    return voxel_grid(torch.from_numpy(cloud).to(device), cfg["voxel_size"],
                      cfg["downsample_capacity"], tf32)


# ---------------------------------------------------------------------------
# kNN normals and FPFH-33 from radius neighbour lists
# ---------------------------------------------------------------------------

def _sqdist(points, mask, tf32):
    """[K,K] |a|^2 + |b|^2 - 2 a.b, clamped at 0; masked columns BIG."""
    p = points.float()
    p2 = torch.sum(p * p, dim=-1)
    d2 = torch.clamp_min(p2[:, None] + p2[None, :]
                         - 2.0 * mm(p, p.T, tf32), 0.0)
    return torch.where(mask[None, :], d2, torch.full_like(d2, BIG))


def _nearest_k(d2, k):
    """The k smallest of each row, ascending, lowest index first on ties."""
    d, i = torch.sort(d2, dim=1, stable=True)
    return d[:, :k], i[:, :k]


def normals_knn(points, mask, k, tf32=False):
    """[K,3] -> [K,3] unit normals: the least eigenvector of the
    covariance of each point's k nearest valid points (itself included)."""
    d, idx = _nearest_k(_sqdist(points, mask, tf32), k)
    w = (d < BIG).float()
    nbr = points.float()[idx]                                   # [K,k,3]
    cnt = torch.clamp_min(w.sum(dim=1), 1.0)
    mean = torch.sum(nbr * w[..., None], dim=1) / cnt[:, None]
    dev = (nbr - mean[:, None, :]) * w[..., None]
    cov = mm(dev.transpose(1, 2), dev, tf32) / cnt[:, None, None]
    _, vecs = eigh3(cov)
    return vecs[:, :, 0]


def _hist(f, lo, hi, w):
    """[K,k] feature values -> [K,11]: 100 / (neighbours) per neighbour in
    its bin of [lo, hi)."""
    b = torch.clamp(torch.floor((f - lo) / (hi - lo) * N_BINS), 0,
                    N_BINS - 1).long()
    oh = torch.nn.functional.one_hot(b, N_BINS).float() * w[..., None]
    cnt = torch.clamp_min(w.sum(dim=1), 1.0)
    return 100.0 * oh.sum(dim=1) / cnt[:, None]


def fpfh(points, mask, cfg: dict, tf32=False):
    """[K,3], [K] -> FPFH-33 [K,33]: each point's neighbours are the
    `feature_k_cap` nearest valid points within `feature_radius`; for a
    pair (p, q) with u = n_p, d = (q - p) / |q - p|, v = d x u normalised
    and w = u x v: f1 = v.n_q, f2 = u.d, f3 = atan2(w.n_q, u.n_q), 11
    bins each, self excluded; FPFH = SPFH + the mean over the neighbours
    of SPFH_j / d_j, each 11-bin block normalised to 100."""
    k = points.shape[0]
    p = points.float()
    nrm = normals_knn(p, mask, cfg["normal_k"], tf32)
    d2 = _sqdist(p, mask, tf32)
    within = d2 <= f32_square(cfg["feature_radius"])
    dk, idx = _nearest_k(torch.where(within, d2, torch.full_like(d2, BIG)),
                         cfg["feature_k_cap"])
    rows = torch.arange(k, device=p.device)[:, None]
    w = ((dk < BIG) & (idx != rows)).float()
    diff = p[idx] - p[:, None, :]
    dist = torch.linalg.vector_norm(diff, dim=-1)
    dhat = diff / torch.clamp_min(dist, 1e-12)[..., None]
    u = nrm[:, None, :].expand_as(dhat)
    v = cross(dhat, u)
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1,
                                                     keepdim=True), 1e-12)
    ww = cross(u, v)
    nq = nrm[idx]
    f1 = torch.sum(v * nq, dim=-1)
    f2 = torch.sum(u * dhat, dim=-1)
    f3 = torch.atan2(torch.sum(ww * nq, dim=-1), torch.sum(u * nq, dim=-1))
    spfh = torch.cat([_hist(f1, -1.0, 1.0, w), _hist(f2, -1.0, 1.0, w),
                      _hist(f3, -math.pi, math.pi, w)], dim=-1)
    wd = w / torch.sqrt(torch.clamp_min(dk, 1e-12))
    k_eff = torch.clamp_min(w.sum(dim=1), 1.0)
    nbr = mm(wd[:, None, :], spfh[idx], tf32)[:, 0, :]
    blocks = (spfh + nbr / k_eff[:, None]).reshape(k, 3, N_BINS)
    sums = torch.clamp_min(blocks.sum(dim=-1, keepdim=True), 1e-12)
    return (100.0 * blocks / sums).reshape(k, 3 * N_BINS)


# ---------------------------------------------------------------------------
# matching and RANSAC: reference/reg-hdl64.py's, one pair
# ---------------------------------------------------------------------------

def match(src_feats, dst_feats, src_mask, dst_mask, tf32=False):
    """Mutual nearest descriptors -> (dst_idx [M] int64, valid [M])."""
    idx, valid = _batched.match(src_feats[None], dst_feats[None],
                                src_mask[None], dst_mask[None], tf32)
    return idx[0], valid[0]


def ransac(src_pts, dst_pts, valid, sampler, cfg: dict, tf32=False):
    """One pair's correspondences -> T [4,4], every valid one scored (no
    cap)."""
    m = src_pts.shape[0]
    return _batched.ransac(src_pts[None], dst_pts[None], valid[None],
                           sampler, cfg["ransac_dist"],
                           cfg["ransac_hypotheses"], m, tf32=tf32)[0]


# ---------------------------------------------------------------------------
# kernel 5's ICP: the layout, windowed or exact iterations, the polar step
# ---------------------------------------------------------------------------

def _pad_pow2(points, mask):
    """Pad to the next power of two: the last point repeated, masked."""
    n = points.shape[0]
    m = 1 << (n - 1).bit_length()
    idx = torch.clamp_max(torch.arange(m, device=points.device), n - 1)
    return points[idx], torch.cat([mask, torch.zeros(
        m - n, dtype=torch.bool, device=mask.device)])


def _transform(T, pts, tf32=False):
    return mm(pts, T[:3, :3].T, tf32) + T[:3, 3]


def layout(src, src_mask, dst, dst_mask, layout_T, block, query_tile,
           tf32=False):
    """Both clouds padded to a power of two; the db stably sorted along its
    widest valid extent, padded to whole `block`s, with a LUT of 1,024
    bins (`searchsorted` of the sorted coordinates at lo + (hi - lo) k /
    1024); the source stably sorted by its `layout_T`-transformed
    coordinate on that axis (masked points last), padded to whole
    `query_tile` tiles, each tile's centre its point query_tile // 2
    (untransformed)."""
    dst, dst_mask = _pad_pow2(dst.float(), dst_mask)
    src, src_mask = _pad_pow2(src.float(), src_mask)
    dev = dst.device
    big = torch.full_like(dst, BIG)
    lo = torch.where(dst_mask[:, None], dst, big).min(dim=0).values
    hi = torch.where(dst_mask[:, None], dst, -big).max(dim=0).values
    axis = int(torch.argmax(hi - lo))
    vals = torch.where(dst_mask, dst[:, axis], torch.full_like(dst[:, 0],
                                                               BIG))
    order = torch.argsort(vals, stable=True)
    n = dst.shape[0]
    np_ = -(-n // block) * block
    db = torch.zeros((np_, 3), dtype=torch.float32, device=dev)
    db[:n] = dst[order]
    pen = torch.full((np_,), BIG, dtype=torch.float32, device=dev)
    pen[:n] = torch.where(dst_mask[order], 0.0, BIG)
    coords = torch.full((np_,), BIG, dtype=torch.float32, device=dev)
    coords[:n] = vals[order]
    lo_a, hi_a = lo[axis], hi[axis]
    steps = torch.arange(LUT_BINS + 1, dtype=torch.float32, device=dev)
    lut = torch.searchsorted(coords, lo_a + (hi_a - lo_a) * steps / LUT_BINS)
    pen2 = (db[:, 0] * db[:, 0] + db[:, 1] * db[:, 1]) \
        + db[:, 2] * db[:, 2] + pen
    db4 = torch.cat([db, pen2[:, None]], dim=1)                 # x y z pen2

    st = _transform(layout_T.float(), src, tf32)
    svals = torch.where(src_mask, st[:, axis], torch.full_like(st[:, 0], BIG))
    sorder = torch.argsort(svals, stable=True)
    m = src.shape[0]
    mp = -(-m // query_tile) * query_tile
    q = torch.zeros((mp, 3), dtype=torch.float32, device=dev)
    q[:m] = src[sorder]
    qpen = torch.full((mp,), BIG, dtype=torch.float32, device=dev)
    qpen[:m] = torch.where(src_mask[sorder], 0.0, BIG)
    centers = q[query_tile // 2::query_tile]
    return dict(db4=db4, lut=lut, lo=lo_a, hi=hi_a, axis=axis, q=q,
                qpen=qpen, centers=centers, block=block, tile=query_tile,
                nb=np_ // block)


def _polar(H, newton_iters=6):
    """The nearest rotation to [3,3] H: Newton's polar iteration
    X <- (g X + X^-T / g) / 2, g = (|X^-T| / |X|)^(1/2), from H / |H|;
    a reflection is flipped along the least eigenvector of sym(X^T H)."""
    X = H / torch.sqrt(torch.clamp_min(torch.sum(H * H), 1e-30))
    Hn = X
    for _ in range(newton_iters):
        c = torch.stack([cross(X[1], X[2]), cross(X[2], X[0]),
                         cross(X[0], X[1])])
        det = torch.dot(X[0], c[0])
        det = torch.where(torch.abs(det) > 1e-30, det,
                          torch.full_like(det, 1e-30))
        Xit = c / det
        g = torch.sqrt(torch.sqrt(torch.sum(Xit * Xit)
                                  / torch.clamp_min(torch.sum(X * X),
                                                    1e-30)))
        X = (0.5 * g) * X + (0.5 / g) * Xit
    if float(torch.dot(X[0], cross(X[1], X[2]))) < 0:
        S = X.T @ Hn
        _, V = eigh3(0.5 * (S + S.T))
        v = V[:, 0]
        X = X - 2.0 * (X @ v)[:, None] * v[None, :]
    return X


def window_base(lay, R, t, wb):
    """[tiles] the first block of each tile's window of `wb` blocks: the
    tile's centre moved by (R, t), its coordinate on the band axis through
    the LUT to a sorted position pos, then
    clamp(floor((pos - wb * block / 2 + block / 2) / block), 0, nb - wb)."""
    block, nb = lay["block"], lay["nb"]
    c = lay["centers"]
    ct = torch.stack([R[a, 0] * c[:, 0] + R[a, 1] * c[:, 1]
                      + R[a, 2] * c[:, 2] + t[a] for a in range(3)], dim=1)
    val = ct[:, lay["axis"]]
    binf = (val - lay["lo"]) / torch.clamp_min(lay["hi"] - lay["lo"],
                                               1e-12) * LUT_BINS
    pos = lay["lut"][torch.clamp(binf, 0, LUT_BINS).long()]
    return torch.clamp(torch.div(pos - (wb * block) // 2 + block // 2,
                                 block, rounding_mode="floor"), 0, nb - wb)


def _associate(lay, R, t, wb, tf32):
    """One iteration's association -> the moments [4,4] float64
    sum w [q;1][b;1]^T: each tile's window of `wb` blocks (`window_base`);
    in each block every query's least d2 = pen2 - 2 b.q (ties averaged),
    strict < across blocks; kept where d2 + |q|^2 + qpen < thresh^2. The
    distances are the dot-product form the port's kernels keep, each
    product and sum rounded on its own in float32; under `tf32` their
    operands are rounded to TF32, as a tensor core's matmul would take
    them."""
    block, tq = lay["block"], lay["tile"]
    dev = lay["q"].device
    base = window_base(lay, R, t, wb)
    q = lay["q"]
    qt = torch.stack([R[a, 0] * q[:, 0] + R[a, 1] * q[:, 1]
                      + R[a, 2] * q[:, 2] + t[a] for a in range(3)], dim=1)
    qn = qt[:, 0] * qt[:, 0] + qt[:, 1] * qt[:, 1] + qt[:, 2] * qt[:, 2]
    ntiles = q.shape[0] // tq
    a = -2.0 * qt
    a = (tf32_round(a) if tf32 else a).reshape(ntiles, tq, 3)
    a0, a1, a2 = (a[:, None, :, k] for k in range(3))            # [T,1,tq]
    db4 = lay["db4"]
    dbr = torch.cat([tf32_round(db4[:, :3]), db4[:, 3:]], dim=1) if tf32 \
        else db4
    ones = torch.ones((db4.shape[0], 1), dtype=torch.float32, device=dev)
    dbm = torch.cat([db4[:, :3], ones], dim=1)                   # x y z 1
    minv = torch.full((ntiles, tq), BIG, dtype=torch.float32, device=dev)
    acc = torch.zeros((ntiles, 4, tq), dtype=torch.float32, device=dev)
    ar = torch.arange(block, device=dev)
    for j in range(wb):
        cols = ((base + j) * block)[:, None] + ar[None, :]        # [T,blk]
        w = dbr[cols][..., None]                                  # [T,blk,4,1]
        d2 = ((w[:, :, 0] * a0 + w[:, :, 1] * a1) + w[:, :, 2] * a2) \
            + w[:, :, 3]                                          # [T,blk,tq]
        tmin = torch.amin(d2, dim=1)
        sel = (d2 <= tmin[:, None, :]).float()
        ext = mm(dbm[cols].transpose(1, 2), sel, tf32)            # [T,4,tq]
        better = tmin < minv
        minv = torch.where(better, tmin, minv)
        acc = torch.where(better[:, None, :], ext, acc)
    acc = acc.transpose(1, 2).reshape(-1, 4)
    matched = acc[:, :3] / torch.clamp_min(acc[:, 3:], 1.0)
    keep = (minv.reshape(-1) + qn + lay["qpen"]) < lay["thresh2"]
    hp = torch.cat([qt, torch.ones_like(qn)[:, None]], 1)[keep].double()
    hq = torch.cat([matched, torch.ones_like(qn)[:, None]], 1)[keep].double()
    return hp.T @ hq


def icp_kernel5(lay, init_T, iters, window_blocks, dist_thresh,
                newton_iters=6, tf32=False):
    """`iters` iterations of kernel 5 on a `layout` from init_T -> T [4,4]:
    windowed with `window_blocks` < the db's blocks, exact with all of
    them. Each iteration composes the Procrustes step of its moments
    (rounded once to float32) unless fewer than 3 pairs passed the gate."""
    lay = {**lay, "thresh2": f32_square(dist_thresh)}
    wb = min(window_blocks, lay["nb"])
    R = init_T[:3, :3].float().clone()
    t = init_T[:3, 3].float().clone()
    for _ in range(iters):
        m = _associate(lay, R, t, wb, tf32).float()
        if float(m[3, 3]) < 3.0:
            continue
        sw = torch.clamp_min(m[3, 3], 1e-12)
        sp, sq = m[:3, 3], m[3, :3]
        H = m[:3, :3].T - sq[:, None] * sp[None, :] / sw
        Ri = _polar(H, newton_iters)
        ti = sq / sw - Ri @ (sp / sw)
        R, t = Ri @ R, Ri @ t + ti
    return make_transform(R, t)


def icp_stats(T, src, src_mask, dst, dst_mask, dist_thresh, chunk=1024,
              tf32=False):
    """(inliers, rmse) at T: each valid source point's exact nearest valid
    target, d2 = (dx^2 + dy^2) + dz^2, kept within the threshold."""
    q = _transform(T.float(), src.float(), tf32)
    d = dst.float()
    pen = torch.where(dst_mask, 0.0, BIG).float()
    mins = []
    for s in range(0, q.shape[0], chunk):
        qc = q[s:s + chunk]
        dx = qc[:, None, 0] - d[None, :, 0]
        dy = qc[:, None, 1] - d[None, :, 1]
        dz = qc[:, None, 2] - d[None, :, 2]
        mins.append(torch.amin((dx * dx + dy * dy) + dz * dz + pen, dim=1))
    d2 = torch.cat(mins)
    inl = (d2 <= f32_square(dist_thresh)) & src_mask
    num = int(inl.sum())
    return num, math.sqrt(float(torch.where(inl, d2, torch.zeros_like(
        d2)).sum()) / max(num, 1))

