"""Fused FPFH-33 — kernels K2 `spfh` and K3 `wsum` (`csrc/fpfh.cu`), the
port of `pctpu/features/pallas_fpfh.py` (`_spfh_kernel`, `_wsum_kernel`,
driven by `_fpfh_fused_impl`) — and the radius normals' moment pass,
kernel K9 `moments` (`_moments_kernel`, driven by `normals_radius_fused`).

Pass 1 (K2) builds each point's SPFH: 3 x 11-bin histograms of the
Darboux angles to every radius-r neighbour (self excluded), scaled by
100 / count. Pass 2 (K3) adds the 1/dist-weighted mean of the neighbours'
SPFH rows. Every pairwise dot the Darboux frame needs factors into
per-point vectors (see the reference's module docstring), so the db side
is packed once as 12 rows per point and the query side as 11 columns.

Exact x-band pruning: on a cell-lexsorted voxel cloud the radius-r
neighbours of a query tile lie in one contiguous x range; `_band_tables`
gives each (batch, query tile) the [base, base + nt) db tiles to visit.
A skipped column has |dx| > r, so it could never enter a histogram. The
kernels' launch shape (CTA width, queries a warp) comes from
`fpfh_plan`; their design is described in `csrc/fpfh.cu`.

The normals pass (K9) sums each query's radius-neighbourhood moments
[x,y,z,x2,y2,z2,xy,xz,yz,1] of coordinates shifted by its query tile's
centroid: second moments of raw LiDAR coordinates lose ~eps |p|^2 to
cancellation in E[xx^T] - mu mu^T, shifted ones keep |x'| ~ radius.
Binary weights, self included (`normals_radius_dense` semantics). The
moments are summed in f64 and rounded once, in the kernel and its plain
version alike (the TPU kernel's f32 dot sums in an unspecified order).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from pctpu_torch import kernels
from pctpu_torch.core.cloud import round_up
from pctpu_torch.features.fpfh_dense import normals_from_moments
from pctpu_torch.ops.eigh3 import _cross
from pctpu_torch.ops.pallas_ballgroup import SMEM_BLOCK
from pctpu_torch.utils.profiling import span

N_BINS = 11
BIG = 1e30
PI = math.pi
# the reference's f32 constants (python floats become f32 in the kernel)
_TWO_PI_INV = N_BINS / (2.0 * math.pi)


def _atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The reference's polynomial atan2 (Cephes atanf minimax on [0,1] +
    octant reduction, |err| ~1e-7 rad) — kept instead of torch.atan2 so
    bin boundaries fall where the TPU kernel puts them."""
    ax, ay = torch.abs(x), torch.abs(y)
    hi = torch.maximum(ax, ay)
    a = torch.minimum(ax, ay) / torch.clamp_min(hi, 1e-30)
    z = a * a
    p = ((((8.05374449538e-2 * z - 1.38776856032e-1) * z
           + 1.99777106478e-1) * z - 3.33329491539e-1) * z * a + a)
    r = torch.where(ay > ax, PI / 2 - p, p)
    r = torch.where(x < 0, PI - r, r)
    return torch.where(y < 0, -r, r)


def _bin(f: torch.Tensor, offset: float, scale: float) -> torch.Tensor:
    # clip in float before the int cast: a saturating conversion + clip
    return torch.clamp(torch.floor((f + offset) * scale), 0,
                       N_BINS - 1).long()


def _band_tables(xs: torch.Tensor, valid: torch.Tensor, radius: float,
                 q_tile: int, db_tile: int, slack: float = 0.0):
    """Per-(batch, query-tile) [base db tile, db tile count) covering all
    VALID columns with x within `radius` of the tile's x range.

    xs [B,Np], valid [B,Np]. Valid columns must be nondecreasing in x up
    to inversions of at most `slack` (a cell-lexsorted voxel cloud with
    slack = leaf). Binary search runs on M = cummax(valid ? x : -BIG),
    which is exactly nondecreasing."""
    b, np_ = xs.shape
    n_tiles = np_ // db_tile
    xt = xs.reshape(b, -1, q_tile)
    vt = valid.reshape(b, -1, q_tile)
    tmin = torch.amin(torch.where(vt, xt, torch.full_like(xt, BIG)), dim=2)
    tmax = torch.amax(torch.where(vt, xt, torch.full_like(xt, -BIG)), dim=2)
    m, _ = torch.cummax(torch.where(valid, xs, torch.full_like(xs, -BIG)),
                        dim=1)
    lo = torch.searchsorted(m, tmin - radius).int()
    hi = torch.searchsorted(m, tmax + radius + slack, right=True).int()
    base = torch.div(lo, db_tile, rounding_mode="floor")
    nt = -torch.div(-(hi - base * db_tile), db_tile, rounding_mode="floor")
    nt = torch.minimum(torch.clamp_min(nt, 0), n_tiles - base)
    nt = torch.where(torch.any(vt, dim=2), nt, torch.zeros_like(nt))
    return base.int().contiguous(), nt.int().contiguous()


def _pack(points: torch.Tensor, mask: torch.Tensor, normals: torch.Tensor,
          np_: int):
    """Query-side [B,Np,11] (q, u, q x u, |q|^2, u.q) and db-side
    [B,12,Np] (p, v, v x p, |p|^2, p.v, mask penalty) packings."""
    b, n, _ = points.shape
    pts = torch.where(mask[..., None], points.float(),
                      torch.zeros_like(points, dtype=torch.float32))
    pad = (0, 0, 0, np_ - n)
    p = torch.nn.functional.pad(pts, pad)
    v = torch.nn.functional.pad(normals.float(), pad)
    p2 = torch.sum(p * p, dim=-1, keepdim=True)
    pv = torch.sum(p * v, dim=-1, keepdim=True)
    amat = torch.cat([p, v, _cross(p, v), p2, pv], dim=-1)
    col_valid = torch.nn.functional.pad(mask, (0, np_ - n))
    pen = torch.where(col_valid, 0.0, BIG).float()[..., None]
    dbmat = torch.cat([p, v, _cross(v, p), p2, pv, pen],
                      dim=-1).transpose(1, 2)
    return amat.contiguous(), dbmat.contiguous(), col_valid


def _band_windows(base, nt, i, j, db_tile, device):
    """Columns of each batch element's j-th in-band db tile for query
    tile i ([B,db_tile] int64) and whether that tile exists ([B])."""
    start = (base[:, i].long() + j) * db_tile
    live = j < nt[:, i]
    cols = start[:, None] + torch.arange(db_tile, device=device)[None, :]
    cols = torch.where(live[:, None], cols, torch.zeros_like(cols))
    return cols, live


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B,TQ,3] . [B,3,TN] -> [B,TQ,TN] as a0*b0 + a1*b1 + a2*b2, each
    product and sum rounded in the kernel's order (a matmul may fuse or
    reorder them and move pairs across the radius test)."""
    return (a[..., 0:1] * b[:, None, 0] + a[..., 1:2] * b[:, None, 1]
            + a[..., 2:3] * b[:, None, 2])


def _rsqrt(d2: torch.Tensor) -> torch.Tensor:
    """rsqrt(max(d2, 1e-12)) as a correctly rounded sqrt and divide, as
    the kernel computes it (torch.rsqrt on the card is an approximation)."""
    return 1.0 / torch.sqrt(torch.clamp_min(d2, 1e-12))


def _db_tile(dbmat: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    return torch.gather(dbmat, 2, cols[:, None, :].expand(
        -1, dbmat.shape[1], -1))                          # [B,12,TN]


def spfh_plain(amat, dbmat, base, nt, q_tile: int, db_tile: int,
               r2: float):
    """Plain PyTorch version of K2: (hist [B,Np,33], cnt [B,Np]), the
    same formulas as the kernel, one (query tile, db tile) at a time."""
    b, np_, _ = amat.shape
    dev = amat.device
    hist = torch.zeros((b, np_, 3 * N_BINS), dtype=torch.float32, device=dev)
    cnt = torch.zeros((b, np_), dtype=torch.float32, device=dev)
    for i in range(np_ // q_tile):
        A = amat[:, i * q_tile:(i + 1) * q_tile]                # [B,TQ,11]
        q, u, x = A[..., 0:3], A[..., 3:6], A[..., 6:9]
        q2, uq = A[..., 9:10], A[..., 10:11]
        rows = i * q_tile + torch.arange(q_tile, device=dev)[None, :, None]
        h = torch.zeros((b, q_tile, 3 * N_BINS), dtype=torch.float32,
                        device=dev)
        c = torch.zeros((b, q_tile), dtype=torch.float32, device=dev)
        for j in range(int(nt[:, i].max()) if b else 0):
            cols, live = _band_windows(base, nt, i, j, db_tile, dev)
            db = _db_tile(dbmat, cols)
            P, V, W = db[:, 0:3], db[:, 3:6], db[:, 6:9]
            qp, up = _dot3(q, P), _dot3(u, P)
            qv, un, xv = _dot3(q, V), _dot3(u, V), _dot3(x, V)
            uw = _dot3(u, W)
            d2 = q2 + db[:, 9:10] - 2.0 * qp
            within = ((d2 + db[:, 11:12] <= r2) & (rows != cols[:, None, :])
                      & live[:, None, None])
            wf = within.float()
            inv_d = _rsqrt(d2)
            f2 = (up - uq) * inv_d
            s = torch.sqrt(torch.clamp_min(1.0 - f2 * f2, 0.0))
            inv_s = 1.0 / torch.clamp_min(s, 1e-12)
            f1 = (uw - xv) * inv_d * inv_s
            dn = (db[:, 10:11] - qv) * inv_d
            f3 = _atan2f((dn - f2 * un) * inv_s, un)
            for k, (f, off, sc) in enumerate(((f1, 1.0, N_BINS / 2.0),
                                              (f2, 1.0, N_BINS / 2.0),
                                              (f3, PI, _TWO_PI_INV))):
                part = torch.zeros((b, q_tile, N_BINS), dtype=torch.float32,
                                   device=dev)
                part.scatter_add_(2, _bin(f, off, sc), wf)
                h[..., k * N_BINS:(k + 1) * N_BINS] += part
            c += wf.sum(dim=2)
        c = torch.clamp_min(c, 1.0)
        # a true division, rounded once as in the kernel (`100.0 / c` is
        # c.reciprocal() * 100, which rounds twice)
        scale = torch.full_like(c, 100.0) / c
        hist[:, i * q_tile:(i + 1) * q_tile] = h * scale[..., None]
        cnt[:, i * q_tile:(i + 1) * q_tile] = c
    return hist, cnt


def wsum_plain(amat, dbmat, base, nt, s33, q_tile: int, db_tile: int,
               r2: float):
    """Plain PyTorch version of K3: [B,Np,33] 1/dist-weighted sum of the
    neighbours' SPFH rows over the neighbour count."""
    b, np_, _ = amat.shape
    dev = amat.device
    out = torch.zeros((b, np_, 3 * N_BINS), dtype=torch.float32, device=dev)
    for i in range(np_ // q_tile):
        A = amat[:, i * q_tile:(i + 1) * q_tile]
        q, q2 = A[..., 0:3], A[..., 9:10]
        rows = i * q_tile + torch.arange(q_tile, device=dev)[None, :, None]
        acc = torch.zeros((b, q_tile, 3 * N_BINS), dtype=torch.float32,
                          device=dev)
        k_eff = torch.zeros((b, q_tile), dtype=torch.float32, device=dev)
        for j in range(int(nt[:, i].max()) if b else 0):
            cols, live = _band_windows(base, nt, i, j, db_tile, dev)
            db = _db_tile(dbmat, cols)
            d2 = q2 + db[:, 9:10] - 2.0 * _dot3(q, db[:, 0:3])
            within = ((d2 + db[:, 11:12] <= r2) & (rows != cols[:, None, :])
                      & live[:, None, None])
            wf = within.float()
            wd = wf * _rsqrt(d2)
            rows33 = torch.gather(s33, 1, cols[..., None].expand(
                -1, -1, 3 * N_BINS))                          # [B,TN,33]
            acc += torch.matmul(wd, rows33)
            k_eff += wf.sum(dim=2)
        out[:, i * q_tile:(i + 1) * q_tile] = (
            acc / torch.clamp_min(k_eff, 1.0)[..., None])
    return out


def _check_fpfh_args(name, amat, dbmat, base, nt, q_tile, db_tile):
    b, np_, c = amat.shape
    if (c != 11 or dbmat.shape != (b, 12, np_) or np_ % q_tile
            or np_ % db_tile or base.shape != (b, np_ // q_tile)
            or nt.shape != base.shape):
        raise ValueError(f"{name}: bad shapes amat {tuple(amat.shape)}, "
                         f"dbmat {tuple(dbmat.shape)}, base "
                         f"{tuple(base.shape)}, nt {tuple(nt.shape)}")


# The K2 / K3 launch (`fpfh_plan`): the query tile the kernels take, K2's
# CTA width and the widest CTA, the warps an SM should hold before a warp
# takes fewer queries at once, and the shared memory of `csrc/fpfh.cu`: a
# chunk's step table (3 x 128 floats and four words), the ring of within
# pairs a K2 warp keeps (256 entries of 8 bytes), the ring a K3 query
# keeps (64 of 8), and what K3 stages for a step of 32 columns a warp
# (each column's SPFH row of 33 floats and its p, |p|^2 and pen)
FPFH_Q_TILE = 256
FPFH_THREADS = 256
FPFH_MAX_THREADS = 1024
FPFH_WARPS_PER_SM = 32
FPFH_TABLE_BYTES = (3 * 128 + 4) * 4
FPFH_RING = 256
FPFH_QUERY_RING = 64


def _fpfh_shape(b, np_, sms, kernel, threads, warp_queries):
    warps = threads // 32
    cta_queries = warps * warp_queries
    if FPFH_Q_TILE % cta_queries or np_ % FPFH_Q_TILE:
        return None
    if kernel == "spfh":
        smem = (cta_queries * (3 * N_BINS + 11) * 4 + FPFH_TABLE_BYTES
                + warps * FPFH_RING * 8)
    else:
        smem = (FPFH_TABLE_BYTES + cta_queries * FPFH_QUERY_RING * 8
                + warps * 32 * (3 * N_BINS + 5) * 4)
    if smem > SMEM_BLOCK:
        return None
    return dict(threads=threads, warp_queries=warp_queries,
                cta_queries=cta_queries, ctas=b * np_ // cta_queries,
                smem_bytes=smem, sms=sms)


def fpfh_plan(b: int, np_: int, sms: int, threads: Optional[int] = None,
              warp_queries: Optional[int] = None) -> Optional[dict]:
    """The launch of K2 and K3 for `b` clouds of `np_` (padded) points on
    a card of `sms` SMs: {"spfh": shape, "wsum": shape}, each shape a dict
    of `threads` a CTA, `warp_queries` (the queries a warp tests at once,
    1, 2 or 4), `cta_queries` (a CTA's consecutive queries of one 256-query
    tile: one group of `warp_queries` a warp), `ctas` and `smem_bytes`.
    Each warp takes 4 queries at once unless that leaves fewer than
    FPFH_WARPS_PER_SM warps an SM, then 2, then 1. K2's CTAs are 256
    threads wide; K3's as wide as leaves a CTA for each SM (at most 1,024
    threads), since a CTA stages the SPFH rows of its band once for all
    its queries (a step of 32 rows a warp at a time). `threads` and
    `warp_queries` force their choice for both; None for a shape the
    kernels do not take."""
    if threads is not None and (threads % 32
                                or not 32 <= threads <= FPFH_MAX_THREADS):
        return None
    if warp_queries is None:
        warp_queries = 4
        while (warp_queries > 1
               and b * np_ // warp_queries < FPFH_WARPS_PER_SM * sms):
            warp_queries //= 2
    elif warp_queries not in (1, 2, 4):
        return None
    wide = threads
    if wide is None:
        wide = FPFH_MAX_THREADS
        while (wide > FPFH_THREADS
               and b * np_ // (wide // 32 * warp_queries) < sms):
            wide //= 2
    plan = {"spfh": _fpfh_shape(b, np_, sms, "spfh", threads or FPFH_THREADS,
                                warp_queries),
            "wsum": _fpfh_shape(b, np_, sms, "wsum", wide, warp_queries)}
    return None if None in plan.values() else plan


def _fpfh_launch_args(name, amat, dbmat, base, nt, q_tile, db_tile, shape,
                      extra):
    f32, i32 = torch.float32, torch.int32
    kernels.require_cuda(name, amat, dbmat, base, nt, *extra,
                         dtypes=(f32, f32, i32, i32) + (f32,) * len(extra))
    if q_tile != FPFH_Q_TILE or db_tile % 128:
        raise ValueError(f"{name} kernel needs q_tile == 256 and db_tile % "
                         f"128 == 0, got {q_tile}, {db_tile}")
    b, np_, _ = amat.shape
    if shape is None:
        raise ValueError(f"{name}: no launch shape for {b} x {np_} points")
    return b, np_


def _launch_spfh(amat, dbmat, base, nt, q_tile: int, db_tile: int,
                 r2: float, plan: Optional[dict] = None):
    """Launch K2 on CUDA tensors (the arguments and results of
    `spfh_plain`), shaped by `plan` (default `fpfh_plan`)."""
    if plan is None:
        plan = fpfh_plan(amat.shape[0], amat.shape[1],
                         kernels.sm_count(amat.device))
    shape = None if plan is None else plan["spfh"]
    b, np_ = _fpfh_launch_args("spfh", amat, dbmat, base, nt, q_tile,
                               db_tile, shape, ())
    hist = torch.empty((b, np_, 3 * N_BINS), dtype=torch.float32,
                       device=amat.device)
    cnt = torch.empty((b, np_), dtype=torch.float32, device=amat.device)
    fn = kernels.entry("fpfh.cu", "pct_spfh", n_ptr=6, n_int=7, n_float=1)
    kernels.check(fn(amat.data_ptr(), dbmat.data_ptr(), base.data_ptr(),
                     nt.data_ptr(), hist.data_ptr(), cnt.data_ptr(),
                     b, np_, q_tile, db_tile, shape["threads"],
                     shape["cta_queries"], shape["warp_queries"], r2,
                     kernels.stream_ptr(amat.device)), "spfh")
    return hist, cnt


def _launch_wsum(amat, dbmat, base, nt, s33, q_tile: int, db_tile: int,
                 r2: float, plan: Optional[dict] = None):
    """Launch K3 on CUDA tensors (the arguments and result of
    `wsum_plain`), shaped by `plan` (default `fpfh_plan`)."""
    if plan is None:
        plan = fpfh_plan(amat.shape[0], amat.shape[1],
                         kernels.sm_count(amat.device))
    shape = None if plan is None else plan["wsum"]
    b, np_ = _fpfh_launch_args("wsum", amat, dbmat, base, nt, q_tile,
                               db_tile, shape, (s33,))
    if s33.data_ptr() % 16:
        raise ValueError("wsum: s33 must be 16-byte aligned (the kernel "
                         "stages its rows 16 bytes at a time)")
    out = torch.empty((b, np_, 3 * N_BINS), dtype=torch.float32,
                      device=amat.device)
    fn = kernels.entry("fpfh.cu", "pct_wsum", n_ptr=6, n_int=7, n_float=1)
    kernels.check(fn(amat.data_ptr(), dbmat.data_ptr(), base.data_ptr(),
                     nt.data_ptr(), s33.data_ptr(), out.data_ptr(),
                     b, np_, q_tile, db_tile, shape["threads"],
                     shape["cta_queries"], shape["warp_queries"], r2,
                     kernels.stream_ptr(amat.device)), "wsum")
    return out


def spfh(amat, dbmat, base, nt, q_tile: int, db_tile: int, r2: float):
    """K2 wrapper -> (hist [B,Np,33], cnt [B,Np]). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise. The kernel
    needs q_tile == 256 and db_tile a multiple of 128."""
    _check_fpfh_args("spfh", amat, dbmat, base, nt, q_tile, db_tile)
    if amat.device.type == "cpu":
        return spfh_plain(amat, dbmat, base, nt, q_tile, db_tile, r2)
    out = _launch_spfh(amat, dbmat, base, nt, q_tile, db_tile, r2)
    spfh.launches += 1
    return out


def wsum(amat, dbmat, base, nt, s33, q_tile: int, db_tile: int, r2: float):
    """K3 wrapper -> [B,Np,33]. CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise (same tile rules as `spfh`)."""
    _check_fpfh_args("wsum", amat, dbmat, base, nt, q_tile, db_tile)
    if s33.shape != (amat.shape[0], amat.shape[1], 3 * N_BINS):
        raise ValueError(f"wsum: bad s33 shape {tuple(s33.shape)}")
    if amat.device.type == "cpu":
        return wsum_plain(amat, dbmat, base, nt, s33, q_tile, db_tile, r2)
    out = _launch_wsum(amat, dbmat, base, nt, s33, q_tile, db_tile, r2)
    wsum.launches += 1
    return out


spfh.launches = 0
wsum.launches = 0


def _shifted_features(db: torch.Tensor, cent: torch.Tensor) -> torch.Tensor:
    """db [B,5,TN] (p, |p|^2, pen) and the tile centroid cent [B,3] ->
    [B,TN,10] f32 features [x,y,z,x2,y2,z2,xy,xz,yz,1] of p - cent, zero
    on dead (penalised) columns."""
    dead = db[:, 4] > 1.0                                  # [B,TN]
    x, y, z = (torch.where(dead, 0.0, db[:, k] - cent[:, k, None])
               for k in range(3))
    one = torch.where(dead, 0.0, 1.0)
    return torch.stack([x, y, z, x * x, y * y, z * z, x * y, x * z, y * z,
                        one], dim=-1)


def moments_plain(amat, dbmat, cent, base, nt, q_tile: int, db_tile: int,
                  r2: float):
    """Plain PyTorch version of K9: [B,Np,10] shifted radius-neighbourhood
    moments, the same tests as the kernel, one (query tile, db tile) at a
    time; each tile's sum is a float64 product, rounded once at the end."""
    b, np_, _ = amat.shape
    dev = amat.device
    out = torch.zeros((b, np_, 10), dtype=torch.float32, device=dev)
    for i in range(np_ // q_tile):
        A = amat[:, i * q_tile:(i + 1) * q_tile]                # [B,TQ,4]
        q, q2 = A[..., 0:3], A[..., 3:4]
        acc = torch.zeros((b, q_tile, 10), dtype=torch.float64, device=dev)
        for j in range(int(nt[:, i].max()) if b else 0):
            cols, live = _band_windows(base, nt, i, j, db_tile, dev)
            db = _db_tile(dbmat, cols)                          # [B,5,TN]
            d2 = q2 + db[:, 3:4] - 2.0 * _dot3(q, db[:, 0:3])
            w = (d2 + db[:, 4:5] <= r2) & live[:, None, None]
            feat = _shifted_features(db, cent[:, i])
            acc += torch.matmul(w.double(), feat.double())
        out[:, i * q_tile:(i + 1) * q_tile] = acc.float()
    return out


def moments_plan(b: int, np_: int, q_tile: int, sms: int,
                 threads: Optional[int] = None,
                 warp_queries: Optional[int] = None) -> Optional[dict]:
    """The launch of K9 for `b` clouds of `np_` (padded) points in query
    tiles of `q_tile` on a card of `sms` SMs: a dict of `threads` a CTA,
    `warp_queries` (the queries a warp tests at once, 1, 2 or 4),
    `cta_queries` (a CTA's consecutive queries, one group of
    `warp_queries` a warp, dividing the tile), `ctas` and `smem_bytes`.
    Each warp takes 4 queries at once unless that leaves fewer than
    FPFH_WARPS_PER_SM warps an SM, then 2, then 1 (`fpfh_plan`'s rule).
    The CTAs are as wide as divides the tile and leaves a CTA for each SM
    (at most 1,024 threads, at least 256 unless the tile needs fewer),
    since a CTA builds its band's step tables once for all its queries.
    `threads` and `warp_queries` force their choice; None for a shape the
    kernel does not take."""
    if q_tile <= 0 or q_tile % 32 or q_tile > FPFH_Q_TILE or np_ % q_tile:
        return None
    if warp_queries is None:
        warp_queries = 4
        while (warp_queries > 1
               and b * np_ // warp_queries < FPFH_WARPS_PER_SM * sms):
            warp_queries //= 2
    elif warp_queries not in (1, 2, 4):
        return None

    def cta_queries(t):
        return t // 32 * warp_queries
    if threads is None:
        threads = FPFH_MAX_THREADS
        while threads > 32 and (
                q_tile % cta_queries(threads)
                or (threads > FPFH_THREADS
                    and b * np_ // cta_queries(threads) < sms)):
            threads //= 2
    elif (threads % 32 or not 32 <= threads <= FPFH_MAX_THREADS
          or q_tile % cta_queries(threads)):
        return None
    cq = cta_queries(threads)
    return dict(threads=threads, warp_queries=warp_queries, cta_queries=cq,
                ctas=b * np_ // cq,
                smem_bytes=FPFH_TABLE_BYTES + threads // 32 * 32 * 10 * 4,
                sms=sms)


def _launch_moments(amat, dbmat, cent, base, nt, q_tile: int, db_tile: int,
                    r2: float, plan: Optional[dict] = None):
    """Launch K9 on CUDA tensors (the arguments and result of
    `moments_plain`), shaped by `plan` (default `moments_plan`)."""
    f32, i32 = torch.float32, torch.int32
    kernels.require_cuda("moments", amat, dbmat, cent, base, nt,
                         dtypes=(f32, f32, f32, i32, i32))
    if q_tile % 32 or q_tile > 256 or db_tile % 128:
        raise ValueError("moments kernel needs q_tile % 32 == 0, q_tile <= "
                         f"256 and db_tile % 128 == 0, got {q_tile}, "
                         f"{db_tile}")
    b, np_, _ = amat.shape
    if plan is None:
        plan = moments_plan(b, np_, q_tile, kernels.sm_count(amat.device))
    if plan is None:
        raise ValueError(f"moments: no launch shape for {b} x {np_} points "
                         f"in tiles of {q_tile}")
    out = torch.empty((b, np_, 10), dtype=f32, device=amat.device)
    fn = kernels.entry("fpfh.cu", "pct_moments", n_ptr=6, n_int=7, n_float=1)
    kernels.check(fn(amat.data_ptr(), dbmat.data_ptr(), cent.data_ptr(),
                     base.data_ptr(), nt.data_ptr(), out.data_ptr(), b, np_,
                     q_tile, db_tile, plan["threads"], plan["cta_queries"],
                     plan["warp_queries"], r2,
                     kernels.stream_ptr(amat.device)), "moments")
    return out


def moments(amat, dbmat, cent, base, nt, q_tile: int, db_tile: int,
            r2: float):
    """K9 wrapper: amat [B,Np,4] (q, |q|^2), dbmat [B,5,Np] (p^T, |p|^2,
    pen: 0 valid, 1e30 masked), cent [B,nq,3], base/nt [B,nq] int32 ->
    [B,Np,10] f32. CPU tensors take the plain version; CUDA tensors launch
    the kernel or raise. The kernel tests a warp's queries against 32
    columns a step, visits only the steps of the band that can hold a
    neighbour, and needs q_tile a multiple of 32 up to 256 and db_tile a
    multiple of 128."""
    b, np_, c = amat.shape
    nq = np_ // q_tile if q_tile else 0
    if (c != 4 or dbmat.shape != (b, 5, np_) or np_ % q_tile
            or np_ % db_tile or cent.shape != (b, nq, 3)
            or base.shape != (b, nq) or nt.shape != base.shape):
        raise ValueError(f"moments: bad shapes amat {tuple(amat.shape)}, "
                         f"dbmat {tuple(dbmat.shape)}, cent "
                         f"{tuple(cent.shape)}, base {tuple(base.shape)}, "
                         f"nt {tuple(nt.shape)}")
    if amat.device.type == "cpu":
        return moments_plain(amat, dbmat, cent, base, nt, q_tile, db_tile, r2)
    out = _launch_moments(amat, dbmat, cent, base, nt, q_tile, db_tile, r2)
    moments.launches += 1
    return out


moments.launches = 0


def _moments_inputs(points: torch.Tensor, mask: torch.Tensor, np_: int,
                    q_tile: int):
    """K9's operands: amat [B,Np,4] = (p, |p|^2), dbmat [B,5,Np] = (p^T,
    |p|^2, pen), each query tile's centroid of its valid points
    cent [B,nq,3] (0 for a tile with none), and the column validity."""
    b, n, _ = points.shape
    pts = torch.where(mask[..., None], points.float(),
                      torch.zeros_like(points, dtype=torch.float32))
    p = torch.nn.functional.pad(pts, (0, 0, 0, np_ - n))
    p2 = torch.sum(p * p, dim=-1)
    col_valid = torch.nn.functional.pad(mask, (0, np_ - n))
    pen = torch.where(col_valid, 0.0, BIG).float()
    amat = torch.cat([p, p2[..., None]], dim=-1)
    dbmat = torch.cat([p.transpose(1, 2), p2[:, None], pen[:, None]], dim=1)
    vt = col_valid.reshape(b, -1, q_tile).float()
    cent = (torch.sum(p.reshape(b, -1, q_tile, 3) * vt[..., None], dim=2)
            / torch.clamp_min(torch.sum(vt, dim=2), 1.0)[..., None])
    return (amat.contiguous(), dbmat.contiguous(), cent.contiguous(),
            col_valid)


def _band(xs, col_valid, radius, q_tile, db_tile, x_banded, x_slack):
    """The (base, nt) db-tile tables: the x-band, or every tile."""
    b, np_ = xs.shape
    if x_banded:
        return _band_tables(xs.contiguous(), col_valid, float(radius),
                            q_tile, db_tile, slack=float(x_slack))
    nq = np_ // q_tile
    return (torch.zeros((b, nq), dtype=torch.int32, device=xs.device),
            torch.full((b, nq), np_ // db_tile, dtype=torch.int32,
                       device=xs.device))


def normals_radius_fused(points: torch.Tensor, mask: torch.Tensor,
                         radius: float = 4.0, q_tile: int = 256,
                         db_tile: int = 512, x_banded: bool = False,
                         x_slack: float = 0.0) -> torch.Tensor:
    """Radius-covariance normals with the moment pass in kernel K9
    (optionally x-band pruned): a drop-in for
    `fpfh_dense.normals_radius_dense` ([B,N,3] + [B,N] -> [B,N,3] unit
    normals, the least covariance eigenvector via `ops.eigh3`). Set
    `x_banded=True` only on clouds sorted by x up to `x_slack`."""
    n = points.shape[1]
    np_ = round_up(n, max(q_tile, db_tile))
    amat, dbmat, cent, col_valid = _moments_inputs(points, mask, np_, q_tile)
    base, nt = _band(amat[..., 0], col_valid, radius, q_tile, db_tile,
                     x_banded, x_slack)
    mom = moments(amat, dbmat, cent, base, nt, q_tile, db_tile,
                  float(radius) ** 2)
    return normals_from_moments(mom[:, :n])


def fpfh_fused(points: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               normals: Optional[torch.Tensor] = None,
               radius: float = 10.0,
               normal_radius: float = 4.0,
               q_tile: int = 256, db_tile: int = 512,
               x_banded: bool = False, x_slack: float = 0.0) -> torch.Tensor:
    """points [B,N,3] (or [N,3]) -> FPFH [B,N,33] (or [N,33]).

    Normals default to `normals_radius_dense(normal_radius)`. Set
    `x_banded=True` only when each cloud's valid prefix is sorted by x up
    to inversions of at most `x_slack` (voxel output: x_slack = leaf)."""
    with span("fpfh"):
        squeeze = points.dim() == 2
        if squeeze:
            points = points[None]
            mask = None if mask is None else mask[None]
            normals = None if normals is None else normals[None]
        b, n, _ = points.shape
        if mask is None:
            mask = torch.ones((b, n), dtype=torch.bool, device=points.device)
        if normals is None:
            from pctpu_torch.features.fpfh_dense import normals_radius_dense
            with span("normals"):
                normals = normals_radius_dense(points, mask,
                                               radius=float(normal_radius))
        np_ = round_up(n, max(q_tile, db_tile))
        r2 = float(radius) ** 2
        with span("band"):
            amat, dbmat, col_valid = _pack(points, mask, normals, np_)
            base, nt = _band(amat[..., 0], col_valid, radius, q_tile,
                             db_tile, x_banded, x_slack)
        with span("spfh"):
            s33, _ = spfh(amat, dbmat, base, nt, q_tile, db_tile, r2)
        with span("wsum"):
            nbr = wsum(amat, dbmat, base, nt, s33, q_tile, db_tile, r2)

        with span("normalise"):
            f = (s33 + nbr)[:, :n]
            blocks = f.reshape(b, n, 3, N_BINS)
            sums = torch.clamp_min(torch.sum(blocks, dim=-1, keepdim=True),
                                   1e-12)
            out = (100.0 * blocks / sums).reshape(b, n, 3 * N_BINS)
            out = torch.where(mask[..., None], out, torch.zeros_like(out))
        return out[0] if squeeze else out
