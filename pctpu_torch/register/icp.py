"""ICP (port of `pctpu/register/icp.py`): the while-loop
`icp_point_to_point` and `icp_point_to_plane`, the fixed-iteration
`icp_fixed_iters` and `icp_fixed_iters_p2pl` and the exact polish
`icp_refine_exact` (1-NN through K1), the banded ICP loops
`icp_fixed_iters_banded` (K6), `_fused` (K7) and `_fused_v2` (K8), and the
whole-loop ICPs `icp_fixed_iters_banded_mega` (kernel 5) and
`icp_fixed_iters_banded_mega_batch` / `icp_refine_exact_mega_batch` (K4).

Entry points run on CUDA unless the caller passes `device="cpu"`; the
kernels' plain versions run on the CPU. The point-to-plane 6x6 solves go
through `torch.linalg.solve_ex`, which does not wait on the host to check
its result, so a fixed-iteration loop on the card never syncs. The grid
ICP `icp_fixed_iters_grid` associates through `ops.grid_hash` (plain
PyTorch: the reference's grid search reaches no Pallas kernel).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from pctpu_torch.core import se3
from pctpu_torch.device import DeviceLike, f32_square, resolve_device
from pctpu_torch.ops import pallas_banded as banded
from pctpu_torch.ops import pallas_icp_mega as mega
from pctpu_torch.ops.eigh3 import _cross
from pctpu_torch.ops.gather import gather_points
from pctpu_torch.ops.grid_hash import build_grid, grid_nearest
from pctpu_torch.ops.knn import nearest
from pctpu_torch.ops.pallas_banded import LUT_BINS, build_banded
from pctpu_torch.register.procrustes import (procrustes_from_moments,
                                             weighted_procrustes)

BIG = 1e30


@dataclasses.dataclass(frozen=True)
class ICPConfig:
    """The reference's `ICPConfig` without `backend`: the port's 1-NN is
    always K1. `query_chunk` is the number of queries per K1 call."""
    max_iters: int = 100
    dist_thresh: float = 5.0        # association rejection, metres
    rot_tol: float = 1e-4           # ||dR - I||_F convergence tolerance
    trans_tol: float = 1e-4         # ||dt|| convergence tolerance
    min_associations: int = 3       # bail-out threshold
    query_chunk: int = 2048


class ICPResult(NamedTuple):
    T: torch.Tensor            # [4,4] final transform (src -> dst)
    iters: torch.Tensor        # int32 iterations executed
    num_assoc: torch.Tensor    # int32 inlier associations at the last iteration
    rmse: torch.Tensor         # f32 inlier RMSE at the last iteration
    converged: torch.Tensor    # bool


def _on(dev: torch.device, *tensors):
    return tuple(None if t is None else t.to(dev) for t in tensors)


def _eye(batch, dev) -> torch.Tensor:
    return torch.eye(4, dtype=torch.float32, device=dev).expand(
        *batch, 4, 4).clone()


def _associate(src_t, dst, dst_mask, cfg: ICPConfig):
    return nearest(src_t, dst, dst_mask, cfg.query_chunk)


def icp_point_to_point(src: torch.Tensor, src_mask: torch.Tensor,
                       dst: torch.Tensor, dst_mask: torch.Tensor,
                       init_T: Optional[torch.Tensor] = None,
                       cfg: ICPConfig = ICPConfig(),
                       device: DeviceLike = None) -> ICPResult:
    """Point-to-point ICP with a convergence test: src/dst [N,3]/[M,3]
    padded clouds with masks. Stops after `max_iters`, when the increment
    is below (rot_tol, trans_tol), or when fewer than `min_associations`
    pass the gate (then the pose stays). One host sync per iteration."""
    dev = resolve_device(device)
    src, src_mask, dst, dst_mask, init_T = _on(dev, src, src_mask, dst,
                                               dst_mask, init_T)
    T = _eye((), dev) if init_T is None else init_T.float()
    thresh2 = f32_square(cfg.dist_thresh)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev)
    it, converged = 0, False
    num = torch.zeros((), dtype=torch.int32, device=dev)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    while it < cfg.max_iters and not converged:
        src_t = se3.apply_transform(T, src)
        d2, idx = _associate(src_t, dst, dst_mask, cfg)
        w = (src_mask & (d2 < thresh2)).float()
        num = w.sum().int()
        R, t = weighted_procrustes(src_t, gather_points(dst, idx), w)
        newT = se3.make_transform(R, t) @ T
        conv = ((torch.linalg.matrix_norm(R - eye3) <= cfg.rot_tol)
                & (torch.linalg.vector_norm(t) <= cfg.trans_tol))
        failed = num < cfg.min_associations
        T = torch.where(failed, T, newT)
        converged = bool(conv | failed)
        rmse = torch.sqrt(torch.sum(d2 * w) / torch.clamp_min(w.sum(), 1.0))
        it += 1
    return ICPResult(T, torch.tensor(it, dtype=torch.int32, device=dev), num,
                     rmse, torch.tensor(converged, device=dev))


def _so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, [...,3] -> [...,3,3]; I + [omega]x below
    |omega| = 1e-8. The norm is taken of a safe input on that branch, so
    forward-mode derivatives (`torch.func.jacfwd`) stay finite at 0."""
    s2 = torch.sum(omega * omega, dim=-1, keepdim=True)
    small = torch.sqrt(s2) < 1e-8
    theta = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    k = omega / theta
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    st, ct = torch.sin(theta)[..., None], torch.cos(theta)[..., None]
    K = _hat(k)
    R = eye + st * K + (1 - ct) * (K @ K)
    return torch.where(small[..., None], eye + _hat(omega), R)


def _hat(v: torch.Tensor) -> torch.Tensor:
    """[...,3] -> [...,3,3] cross-product matrix."""
    z = torch.zeros_like(v[..., 0])
    return torch.stack([
        torch.stack([z, -v[..., 2], v[..., 1]], dim=-1),
        torch.stack([v[..., 2], z, -v[..., 0]], dim=-1),
        torch.stack([-v[..., 1], v[..., 0], z], dim=-1)], dim=-2)


def _p2pl_step(src_t, w, q, n):
    """One small-angle Gauss-Newton step of sum w ((p' - q) . n)^2 on
    [...,N] associations -> (dT [...,4,4], xi [...,6], r [...,N]). The
    6x6 normal equations are solved without a host check."""
    r = torch.sum((src_t - q) * n, dim=-1)
    J = torch.cat([_cross(src_t, n), n], dim=-1)           # [...,N,6]
    Jw = J * w[..., None]
    A = Jw.transpose(-1, -2) @ J
    b = -(Jw.transpose(-1, -2) @ r[..., None])[..., 0]
    A = A + 1e-6 * torch.eye(6, dtype=A.dtype, device=A.device)
    xi = torch.linalg.solve_ex(A, b)[0]
    return se3.make_transform(_so3_exp(xi[..., :3]), xi[..., 3:]), xi, r


def icp_point_to_plane(src: torch.Tensor, src_mask: torch.Tensor,
                       dst: torch.Tensor, dst_normals: torch.Tensor,
                       dst_mask: torch.Tensor,
                       init_T: Optional[torch.Tensor] = None,
                       cfg: ICPConfig = ICPConfig(),
                       device: DeviceLike = None) -> ICPResult:
    """Point-to-plane ICP by small-angle Gauss-Newton with a convergence
    test: per iteration, 1-NN association (K1), J_i = [p' x n_i, n_i] and
    one 6x6 solve. Stops after `max_iters`, when the increment's rotation
    and translation norms are below (rot_tol, trans_tol), or when fewer
    than `min_associations` pass the gate (then the pose stays). One host
    sync per iteration, for the test."""
    dev = resolve_device(device)
    src, src_mask, dst, dst_normals, dst_mask, init_T = _on(
        dev, src, src_mask, dst, dst_normals, dst_mask, init_T)
    T = _eye((), dev) if init_T is None else init_T.float()
    thresh2 = f32_square(cfg.dist_thresh)
    it, converged = 0, False
    num = torch.zeros((), dtype=torch.int32, device=dev)
    rmse = torch.zeros((), dtype=torch.float32, device=dev)
    while it < cfg.max_iters and not converged:
        src_t = se3.apply_transform(T, src)
        d2, idx = _associate(src_t, dst, dst_mask, cfg)
        w = (src_mask & (d2 < thresh2)).float()
        num = w.sum().int()
        dT, xi, r = _p2pl_step(src_t, w, gather_points(dst, idx),
                               gather_points(dst_normals, idx))
        conv = ((torch.linalg.vector_norm(xi[:3]) <= cfg.rot_tol)
                & (torch.linalg.vector_norm(xi[3:]) <= cfg.trans_tol))
        failed = num < cfg.min_associations
        T = torch.where(failed, T, dT @ T)
        converged = bool(conv | failed)
        rmse = torch.sqrt(torch.sum(r * r * w) / torch.clamp_min(w.sum(),
                                                                 1.0))
        it += 1
    return ICPResult(T, torch.tensor(it, dtype=torch.int32, device=dev), num,
                     rmse, torch.tensor(converged, device=dev))


def _trim_weights(w: torch.Tensor, d2: torch.Tensor, trim: float,
                  active=None) -> torch.Tensor:
    """Trimmed ICP: keep only the best `trim` fraction of the valid
    associations [...,N] by distance; `active` gates the trim on."""
    if trim >= 1.0:
        return w
    n = d2.shape[-1]
    ds, _ = torch.sort(torch.where(w > 0, d2, BIG), dim=-1)
    k = torch.clamp((trim * w.sum(dim=-1)).int(), 1, n - 1).long()
    cutoff = torch.gather(ds, -1, (k - 1)[..., None])
    wt = w * (d2 <= cutoff).float()
    if active is None:
        return wt
    return torch.where(torch.as_tensor(active, device=w.device), wt, w)


def icp_fixed_iters(src: torch.Tensor, src_mask: torch.Tensor,
                    dst: torch.Tensor, dst_mask: torch.Tensor,
                    init_T: Optional[torch.Tensor] = None,
                    iters: int = 30, dist_thresh: float = 5.0,
                    query_chunk: int = 2048, trim: float = 1.0,
                    device: DeviceLike = None) -> torch.Tensor:
    """`iters` point-to-point iterations, no early exit: src/dst [N,3]
    (or [B,N,3], the pairs in lockstep) -> T [4,4] (or [B,4,4]). The trim
    (when < 1) is on for the second half of the schedule."""
    dev = resolve_device(device)
    src, src_mask, dst, dst_mask, init_T = _on(dev, src, src_mask, dst,
                                               dst_mask, init_T)
    T = (_eye(src.shape[:-2], dev) if init_T is None else init_T.float())
    thresh2 = f32_square(dist_thresh)
    for i in range(iters):
        src_t = se3.apply_transform(T, src)
        d2, idx = nearest(src_t, dst, dst_mask, query_chunk)
        w = (src_mask & (d2 < thresh2)).float()
        w = _trim_weights(w, d2, trim, active=i >= iters // 2)
        R, t = weighted_procrustes(src_t, gather_points(dst, idx), w)
        T = se3.make_transform(R, t) @ T
    return T


def icp_fixed_iters_p2pl(src: torch.Tensor, src_mask: torch.Tensor,
                         dst: torch.Tensor, dst_normals: torch.Tensor,
                         dst_mask: torch.Tensor,
                         init_T: Optional[torch.Tensor] = None,
                         iters: int = 25, dist_thresh: float = 2.0,
                         query_chunk: int = 2048, trim: float = 1.0,
                         device: DeviceLike = None) -> torch.Tensor:
    """`iters` point-to-plane Gauss-Newton iterations, no early exit:
    src [N,3], dst/dst_normals [M,3] (or [B,...], the pairs in lockstep)
    -> T [4,4] (or [B,4,4]). Per iteration one K1 association and one
    6x6 solve per pair, with no host sync. The trim (when < 1) is on for
    the second half of the schedule. The odometry front end's default."""
    dev = resolve_device(device)
    src, src_mask, dst, dst_normals, dst_mask, init_T = _on(
        dev, src, src_mask, dst, dst_normals, dst_mask, init_T)
    T = (_eye(src.shape[:-2], dev) if init_T is None else init_T.float())
    thresh2 = f32_square(dist_thresh)
    for i in range(iters):
        src_t = se3.apply_transform(T, src)
        d2, idx = nearest(src_t, dst, dst_mask, query_chunk)
        w = (src_mask & (d2 < thresh2)).float()
        w = _trim_weights(w, d2, trim, active=i >= iters // 2)
        dT, _, _ = _p2pl_step(src_t, w, gather_points(dst, idx),
                              gather_points(dst_normals, idx))
        T = dT @ T
    return T


def icp_refine_exact(src: torch.Tensor, src_mask: torch.Tensor,
                     dst: torch.Tensor, dst_mask: torch.Tensor,
                     T: torch.Tensor, iters: int = 2,
                     subsample: int = 16384, dist_thresh: float = 5.0,
                     query_chunk: int = 2048,
                     device: DeviceLike = None) -> torch.Tensor:
    """Exact point-to-point polish from a coarse pose: `iters` iterations
    of a uniform-strided source subsample against the FULL target, by
    exact 1-NN (K1) + weighted Procrustes."""
    dev = resolve_device(device)
    src, src_mask, dst, dst_mask, T = _on(dev, src, src_mask, dst, dst_mask,
                                          T)
    stride = max(1, src.shape[0] // subsample)
    q = src[::stride][:subsample]
    qm = src_mask[::stride][:subsample]
    thresh2 = f32_square(dist_thresh)
    T = T.float()
    for _ in range(iters):
        qt = se3.apply_transform(T, q)
        d2, idx = nearest(qt, dst, dst_mask, query_chunk)
        w = (qm & (d2 < thresh2)).float()
        R, t = weighted_procrustes(qt, gather_points(dst, idx), w)
        T = se3.make_transform(R, t) @ T
    return T


# ---------------------------------------------------------------------------
# banded ICP loops (K6, K7, K8)
# ---------------------------------------------------------------------------

def icp_fixed_iters_grid(src: torch.Tensor, src_mask: torch.Tensor,
                         dst: torch.Tensor, dst_mask: torch.Tensor,
                         init_T: Optional[torch.Tensor] = None,
                         iters: int = 30, dist_thresh: float = 5.0,
                         cell_size: Optional[float] = None,
                         cap_per_cell: int = 64, query_chunk: int = 2048,
                         device: DeviceLike = None) -> torch.Tensor:
    """Fixed-iteration ICP with grid-hash association, the O(N) path for
    full-resolution scans: the dst grid is built once; associations are
    exact within min(cell_size, dist_thresh), and anything farther would
    be rejected by the distance threshold regardless. `cell_size` None
    means `dist_thresh`."""
    dev = resolve_device(device)
    src, src_mask, dst, dst_mask, init_T = _on(dev, src, src_mask, dst,
                                               dst_mask, init_T)
    T = _eye((), dev) if init_T is None else init_T.float()
    if cell_size is None:
        cell_size = dist_thresh
    thresh2 = f32_square(min(dist_thresh, cell_size))
    grid = build_grid(dst, dst_mask, cell_size=cell_size)
    for _ in range(iters):
        src_t = se3.apply_transform(T, src)
        d2, idx, found = grid_nearest(grid, src_t, cap_per_cell=cap_per_cell,
                                      query_chunk=query_chunk)
        w = (src_mask & found & (d2 < thresh2)).float()
        R, t = weighted_procrustes(src_t, gather_points(dst, idx), w)
        T = se3.make_transform(R, t) @ T
    return T


def _axis_sort(src, src_mask, axis, T=None):
    """Source points [...,N,3] ordered by their (T-transformed) band-axis
    coordinate, masked points last: (src_s, mask_s). `axis` and `T` carry
    the leading axes of `src`."""
    src = src.float()
    st = src if T is None else se3.apply_transform(T, src)
    ax = axis.long().reshape(axis.shape + (1, 1)).expand(st.shape[:-1] + (1,))
    svals = torch.gather(st, -1, ax)[..., 0]
    svals = torch.where(src_mask, svals, torch.full_like(svals, BIG))
    sorder = torch.argsort(svals, dim=-1, stable=True)
    return (torch.gather(src, -2, sorder[..., None].expand(src.shape)),
            torch.gather(src_mask, -1, sorder))


def icp_fixed_iters_banded(src: torch.Tensor, src_mask: torch.Tensor,
                           dst: torch.Tensor, dst_mask: torch.Tensor,
                           init_T: Optional[torch.Tensor] = None,
                           iters: int = 30, dist_thresh: float = 5.0,
                           block: int = 2048, window_blocks: int = 2,
                           query_tile: int = 512,
                           device: DeviceLike = None) -> torch.Tensor:
    """Fixed-iteration ICP with the banded windowed 1-NN (K6): both clouds
    sorted once along the db's widest axis; each association scans only a
    window of the sorted db per query tile."""
    dev = resolve_device(device)
    src, src_mask, dst, dst_mask, init_T = _on(dev, src, src_mask, dst,
                                               dst_mask, init_T)
    T = _eye((), dev) if init_T is None else init_T.float()
    thresh2 = f32_square(dist_thresh)
    bdb = build_banded(dst, dst_mask, block=block)
    src_s, mask_s = _axis_sort(src, src_mask, bdb.axis)
    for _ in range(iters):
        src_t = se3.apply_transform(T, src_s)
        d2, idx = banded.nearest_banded(bdb, src_t, block=block,
                                        window_blocks=window_blocks,
                                        query_tile=query_tile)
        w = (mask_s & (d2 < thresh2)).float()
        R, t = weighted_procrustes(src_t, gather_points(dst, idx), w)
        T = se3.make_transform(R, t) @ T
    return T


def icp_fixed_iters_banded_fused(src: torch.Tensor, src_mask: torch.Tensor,
                                 dst: torch.Tensor, dst_mask: torch.Tensor,
                                 init_T: Optional[torch.Tensor] = None,
                                 iters: int = 30, dist_thresh: float = 5.0,
                                 block: int = 2048, window_blocks: int = 2,
                                 query_tile: int = 512,
                                 solver: str = "polar",
                                 tiles_per_step: int = 4, unroll: int = 1,
                                 device: DeviceLike = None) -> torch.Tensor:
    """Fused banded ICP: each iteration is ONE K7 launch (windowed
    association + moment reduction) and a 3x3 solve
    (`procrustes_from_moments`, solver 'polar' or 'svd'). Semantics of
    `icp_fixed_iters_banded`. `unroll` (the reference's XLA loop unroll)
    is accepted and has no effect here."""
    del unroll
    dev = resolve_device(device)
    src, src_mask, dst, dst_mask, init_T = _on(dev, src, src_mask, dst,
                                               dst_mask, init_T)
    T = _eye((), dev) if init_T is None else init_T.float()
    bdb = build_banded(dst, dst_mask, block=block)
    src_s, mask_s = _axis_sort(src, src_mask, bdb.axis)
    for _ in range(iters):
        src_t = se3.apply_transform(T, src_s)
        m16 = banded.icp_moments_banded(bdb, src_t, mask_s,
                                        dist_thresh=dist_thresh, block=block,
                                        window_blocks=window_blocks,
                                        query_tile=query_tile,
                                        tiles_per_step=tiles_per_step)
        R, t = procrustes_from_moments(m16, solver=solver)
        T = se3.make_transform(R, t) @ T
    return T


def _query_layout(src_sorted: torch.Tensor, mask_sorted: torch.Tensor,
                  query_tile: int):
    """[B,3,Mp] points, [B,1,Mp] penalty, [B,1,3*ntiles] tile centres."""
    b, n, _ = src_sorted.shape
    mp = ((n + query_tile - 1) // query_tile) * query_tile
    src3 = torch.nn.functional.pad(src_sorted.float().transpose(1, 2),
                                   (0, mp - n))
    spen = torch.nn.functional.pad(
        torch.where(mask_sorted, 0.0, BIG).float(), (0, mp - n), value=BIG)
    ntiles = mp // query_tile
    centers = src3[:, :, query_tile // 2::query_tile].transpose(1, 2)
    return (src3.contiguous(), spen[:, None, :].contiguous(),
            centers.reshape(b, 1, 3 * ntiles).contiguous())


def icp_fixed_iters_banded_fused_v2(src: torch.Tensor,
                                    src_mask: torch.Tensor,
                                    dst: torch.Tensor,
                                    dst_mask: torch.Tensor,
                                    init_T: Optional[torch.Tensor] = None,
                                    iters: int = 30,
                                    dist_thresh: float = 5.0,
                                    block: int = 2048,
                                    window_blocks: int = 2,
                                    query_tile: int = 512,
                                    solver: str = "polar", unroll: int = 1,
                                    device: DeviceLike = None
                                    ) -> torch.Tensor:
    """Fused banded ICP v2: the transform and the window lookup also run
    inside the kernel (K8, the pose passed as 16 scalars); each iteration
    is one K8 launch and a 3x3 solve. Source tiles are ordered by the
    init-transformed band-axis coordinate. `unroll` is accepted and has
    no effect here."""
    del unroll
    dev = resolve_device(device)
    src, src_mask, dst, dst_mask, init_T = _on(dev, src, src_mask, dst,
                                               dst_mask, init_T)
    T = _eye((), dev) if init_T is None else init_T.float()
    bdb = build_banded(dst, dst_mask, block=block)
    src_s, mask_s = _axis_sort(src, src_mask, bdb.axis, T)
    src3, spen, centers = _query_layout(src_s[None], mask_s[None], query_tile)
    pen2t = bdb.pen2.T                                    # [Np,1]
    for _ in range(iters):
        m16 = banded.icp_moments_banded_v2(bdb, pen2t, src3[0], spen[0],
                                           centers[0], T,
                                           dist_thresh=dist_thresh,
                                           block=block,
                                           window_blocks=window_blocks,
                                           query_tile=query_tile)
        R, t = procrustes_from_moments(m16, solver=solver)
        T = se3.make_transform(R, t) @ T
    return T


# ---------------------------------------------------------------------------
# whole-loop ICPs (kernel 5, K4)
# ---------------------------------------------------------------------------

def _pad_pow2(points: torch.Tensor, mask: torch.Tensor, axis: int = 0):
    """Pad the point axis up to the next power of two: edge-mode points
    (the last point repeated), mask False."""
    n = points.shape[axis]
    m = 1 << (n - 1).bit_length()
    if m == n:
        return points, mask
    idx = torch.clamp(torch.arange(m, device=points.device), max=n - 1)
    pts = torch.index_select(points, axis, idx)
    pad_shape = list(mask.shape)
    pad_shape[axis] = m - n
    msk = torch.cat([mask, torch.zeros(pad_shape, dtype=torch.bool,
                                       device=mask.device)], dim=axis)
    return pts, msk


def _mega_layout(src, src_mask, dst, dst_mask, init_T, block, query_tile):
    """[B]-batched layout prep of the mega ICP loops: both clouds padded to a
    power of two, the db banded, the source ordered by its
    init-transformed band-axis coordinate -> (bdb, src3, spen, centers)."""
    src, src_mask = _pad_pow2(src, src_mask, axis=1)
    dst, dst_mask = _pad_pow2(dst, dst_mask, axis=1)
    bdb = build_banded(dst, dst_mask, block=block)
    src_s, mask_s = _axis_sort(src, src_mask, bdb.axis, init_T)
    return (bdb,) + _query_layout(src_s, mask_s, query_tile)


def icp_fixed_iters_banded_mega(src: torch.Tensor, src_mask: torch.Tensor,
                                dst: torch.Tensor, dst_mask: torch.Tensor,
                                init_T: Optional[torch.Tensor] = None,
                                coarse_iters: int = 45,
                                polish_iters: int = 5,
                                dist_thresh: float = 5.0, block: int = 512,
                                window_blocks: int = 4,
                                query_tile: int = 256,
                                newton_iters: int = 6,
                                device: DeviceLike = None) -> torch.Tensor:
    """Whole-loop ICP of one pair: src/dst [N,3]/[M,3] -> T [4,4]. Two
    kernel-5 launches: `coarse_iters` windowed iterations, then
    `polish_iters` exact ones (the window spanning the whole db)."""
    dev = resolve_device(device)
    src, src_mask, dst, dst_mask, init_T = _on(dev, src, src_mask, dst,
                                               dst_mask, init_T)
    T = _eye((), dev) if init_T is None else init_T.float()
    bdb, src3, spen, centers = _mega_layout(src[None], src_mask[None],
                                            dst[None], dst_mask[None],
                                            T[None], block, query_tile)
    bdb = banded.first_db(bdb)
    nb = bdb.dbt4.shape[-1] // block
    for iters, wb in ((coarse_iters, window_blocks), (polish_iters, nb)):
        if iters > 0:
            T = mega.icp_mega(bdb, src3[0], spen[0], centers[0], T,
                              iters=iters, dist_thresh=dist_thresh,
                              block=block, window_blocks=wb,
                              query_tile=query_tile,
                              newton_iters=newton_iters)
    return T


def icp_fixed_iters_banded_mega_batch(src: torch.Tensor,
                                      src_mask: torch.Tensor,
                                      dst: torch.Tensor,
                                      dst_mask: torch.Tensor,
                                      init_T: Optional[torch.Tensor] = None,
                                      coarse_iters: int = 45,
                                      polish_iters: int = 5,
                                      dist_thresh: float = 5.0,
                                      block: int = 512,
                                      window_blocks: int = 4,
                                      query_tile: int = 256,
                                      newton_iters: int = 6) -> torch.Tensor:
    """Batched whole-loop ICP: src/dst [B,N,3]/[B,M,3] -> T [B,4,4].

    One K4 launch per phase: `coarse_iters` windowed iterations, then
    `polish_iters` exact ones (the window spanning the whole db). Source
    tiles are ordered by the init-transformed band-axis coordinate."""
    b = src.shape[0]
    T = _eye((b,), src.device) if init_T is None else init_T.float()
    bdb, src3, spen, centers = _mega_layout(src, src_mask, dst, dst_mask, T,
                                            block, query_tile)
    dbt5 = mega.pack_dbt5(bdb)
    lut = bdb.lut[:, None, :]
    nb = bdb.dbt4.shape[2] // block
    for iters, wb in ((coarse_iters, window_blocks), (polish_iters, nb)):
        if iters > 0:
            T = mega.icp_mega_batch(dbt5, lut, bdb.lo, bdb.hi, bdb.axis,
                                    src3, spen, centers, T, iters=iters,
                                    dist_thresh=dist_thresh, block=block,
                                    window_blocks=wb, query_tile=query_tile,
                                    newton_iters=newton_iters)
    return T


def icp_refine_exact_mega_batch(src: torch.Tensor, src_mask: torch.Tensor,
                                dst: torch.Tensor, dst_mask: torch.Tensor,
                                init_T: torch.Tensor,
                                iters: int = 2, dist_thresh: float = 5.0,
                                block: int = 2048, query_tile: int = 512,
                                newton_iters: int = 6) -> torch.Tensor:
    """Batched EXACT fixed-iteration refine in one K4 launch, with no
    layout prep: the window spans the whole db (window_blocks = nb), so
    the LUT, band axis and source order are dummies and the operands go in
    unsorted. src [B,M,3] (a strided subsample), dst [B,N,3]."""
    src, src_mask = _pad_pow2(src, src_mask, axis=1)
    dst, dst_mask = _pad_pow2(dst, dst_mask, axis=1)
    b, m, _ = src.shape
    n = dst.shape[1]
    dev = src.device
    np_ = ((n + block - 1) // block) * block

    dstf = torch.where(dst_mask[..., None], dst.float(),
                       torch.zeros_like(dst, dtype=torch.float32))
    pen = torch.where(dst_mask, 0.0, BIG).float()
    pen2 = torch.sum(dstf * dstf, dim=-1) + pen
    dbt5 = torch.zeros((b, 5, np_), dtype=torch.float32, device=dev)
    dbt5[:, 0:3, :n] = dstf.transpose(1, 2)
    dbt5[:, 3, :n] = pen2
    dbt5[:, 3, n:] = BIG
    dbt5[:, 4, :n] = 1.0
    src3, spen, centers = _query_layout(src, src_mask, query_tile)
    return mega.icp_mega_batch(
        dbt5, torch.zeros((b, 1, LUT_BINS + 1), dtype=torch.int32,
                          device=dev),
        torch.zeros((b,), device=dev), torch.ones((b,), device=dev),
        torch.zeros((b,), dtype=torch.int32, device=dev), src3, spen,
        centers, init_T.float(), iters=iters, dist_thresh=dist_thresh,
        block=block, window_blocks=np_ // block, query_tile=query_tile,
        newton_iters=newton_iters)
