"""Banded (axis-sorted, windowed) 1-NN and ICP moments (port of
`pctpu/ops/pallas_banded.py`): the band layout `build_banded`, the
per-tile window offsets `_tile_offsets`, and three kernels, each with its
plain PyTorch version beside it:

  K6 `nearest_banded`        (csrc/banded.cu `banded_nn_kernel`)
  K7 `icp_moments_banded`    (csrc/banded.cu `banded_moments_kernel<false>`)
  K8 `icp_moments_banded_v2` (csrc/banded.cu `banded_moments_kernel<true>`)

The db is sorted (stable argsort) along its widest extent axis and laid
out as [3, Np] columns, with a bucket LUT that maps a sort-axis coordinate
to its approximate sorted position. Each query tile scans only a window of
`window_blocks` db blocks.

K7 and K8 sum each tile's 16 moments in f64 and write one [16] partial per
tile; the wrapper sums the partials over the tiles in f64 and rounds once
to f32. (The TPU kernels sum in f32 in an unspecified order.) The plain
versions do the same, so kernel and plain version agree to f32 rounding of
one f64 sum, and an ICP loop follows one trajectory on both. K7 and K8
run one CUDA body and spread a launch over the card in units of (tile,
query slice) with lanes that share a query, shaped by `moments_v2_plan`;
K7 takes its queries posed and its window offsets from the wrapper, K8
poses its tiles and finds their windows itself. K6 takes the same units,
lanes and ring (`nearest_banded_plan`): each lane keeps its strict '<'
minimum, and a query's lanes take the lexicographic (d2, column) minimum.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pctpu_torch import kernels
from pctpu_torch.core.cloud import round_up

BIG = 1e30
LUT_BINS = 1024

# K6's, K7's and K8's CTA shape (csrc/banded.cu kMomThreads, kMomQpt,
# kNnQpt): a unit holds MOMENTS_THREADS * (queries a thread) / lanes
# queries of one tile
MOMENTS_THREADS, MOMENTS_QPT, MOMENTS_MAX_LANES = 256, 4, 32
NEAREST_QPT = 4
# the least units a launch aims for per SM (the rule of
# pallas_icp_mega.unit_plan, which K6's, K7's and K8's units follow)
MOMENTS_UNITS_PER_SM = 3

_tickets: dict = {}


class BandedDB(NamedTuple):
    """Fields carry a leading batch axis when `build_banded` got one."""
    dbt: torch.Tensor        # [B,3,Np] coords sorted by axis (padded)
    penalty: torch.Tensor    # [B,1,Np] 0 valid / BIG masked or pad
    coords: torch.Tensor     # [B,Np] sorted axis coordinate (pad -> BIG)
    order: torch.Tensor      # [B,Np] original index per sorted slot
    axis: torch.Tensor       # [B] int32 sort axis
    n: int                   # true db size
    lut: torch.Tensor        # [B,LUT_BINS+1] axis coord -> sorted position
    lo: torch.Tensor         # [B] axis range low
    hi: torch.Tensor         # [B] axis range high
    dbt4: torch.Tensor       # [B,4,Np] coords + ones row
    pen2: torch.Tensor       # [B,1,Np] |b|^2 + penalty


def build_banded(db: torch.Tensor, db_mask: Optional[torch.Tensor] = None,
                 block: int = 2048) -> BandedDB:
    """db [B,N,3] (or [N,3]), db_mask [B,N] (or [N]) -> BandedDB sorted
    along each cloud's widest extent axis (masked points sort last).
    Unbatched input gives unbatched fields."""
    if db.dim() == 2:
        return first_db(build_banded(
            db[None], None if db_mask is None else db_mask[None], block))
    b, n, _ = db.shape
    dev = db.device
    db = db.float()
    if db_mask is None:
        db_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    lo = torch.amin(torch.where(db_mask[..., None], db,
                                torch.full_like(db, BIG)), dim=1)
    hi = torch.amax(torch.where(db_mask[..., None], db,
                                torch.full_like(db, -BIG)), dim=1)
    axis = torch.argmax(hi - lo, dim=1).int()                 # [B]
    vals = torch.gather(db, 2, axis.long()[:, None, None].expand(b, n, 1))
    vals = torch.where(db_mask, vals[..., 0], torch.full_like(vals[..., 0],
                                                              BIG))
    order = torch.argsort(vals, dim=1, stable=True)
    np_ = round_up(n, block)
    pad = np_ - n
    sorted_db = torch.gather(db, 1, order[..., None].expand(b, n, 3))
    dbt = torch.nn.functional.pad(sorted_db.transpose(1, 2), (0, pad))
    pen_valid = torch.gather(db_mask, 1, order)
    penalty = torch.nn.functional.pad(
        torch.where(pen_valid, 0.0, BIG).float(), (0, pad), value=BIG)
    coords = torch.nn.functional.pad(torch.gather(vals, 1, order), (0, pad),
                                     value=BIG)
    order_p = torch.nn.functional.pad(order.int(), (0, pad))
    ar = torch.arange(b, device=dev)
    ax_lo = lo[ar, axis.long()]
    ax_hi = hi[ar, axis.long()]
    steps = torch.arange(LUT_BINS + 1, dtype=torch.float32, device=dev)
    grid_vals = (ax_lo[:, None]
                 + (ax_hi - ax_lo)[:, None] * steps[None, :] / LUT_BINS)
    lut = torch.searchsorted(coords.contiguous(), grid_vals).int()
    dbt4 = torch.cat([dbt, torch.ones((b, 1, np_), dtype=torch.float32,
                                      device=dev)], dim=1)
    pen2 = torch.sum(dbt * dbt, dim=1, keepdim=True) + penalty[:, None, :]
    return BandedDB(dbt, penalty[:, None, :], coords, order_p, axis, n, lut,
                    ax_lo, ax_hi, dbt4, pen2)


def first_db(bdb: BandedDB) -> BandedDB:
    """The first db of a batched BandedDB, with unbatched fields."""
    return BandedDB(*(f if isinstance(f, int) else f[0] for f in bdb))


def _lut_bin(val: torch.Tensor, lo, hi) -> torch.Tensor:
    """clip(trunc((val - lo) / max(hi - lo, 1e-12) * LUT_BINS), 0,
    LUT_BINS) as int64 (clipped in float first: the same integer for every
    finite value, and no out-of-range cast)."""
    binf = (val - lo) / torch.clamp_min(hi - lo, 1e-12) * LUT_BINS
    return torch.clamp(binf, 0, LUT_BINS).long()


def _tile_offsets(bdb: BandedDB, qvals: torch.Tensor, query_tile: int,
                  block: int, window_blocks: int) -> torch.Tensor:
    """[Mp/query_tile] int32 first window block per query tile, from the
    sort-axis coordinate of each tile's centre query (index tile // 2)
    through the bucket LUT (single db)."""
    nb = bdb.dbt.shape[-1] // block
    centers_val = qvals.reshape(-1, query_tile)[:, query_tile // 2]
    center = bdb.lut[_lut_bin(centers_val, bdb.lo, bdb.hi)].long()
    first = torch.div(center, block, rounding_mode="floor") - window_blocks // 2
    return torch.clamp(first, 0, nb - window_blocks).int()


def _check_window(name, np_, block, window_blocks, mp, query_tile):
    if (np_ % block or not 1 <= window_blocks <= np_ // block
            or mp % query_tile):
        raise ValueError(f"{name}: bad tiling (Np={np_}, block={block}, "
                         f"window_blocks={window_blocks}, Mp={mp}, "
                         f"query_tile={query_tile})")


def _sorted_axis(q: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """[Mp] the sort-axis coordinate of each query (the reference's one-hot
    matvec picks the same value)."""
    return torch.gather(q, 1, axis.long().reshape(1, 1).expand(q.shape[0], 1)
                        )[:, 0]


# ---------------------------------------------------------------------------
# K6 nearest_banded
# ---------------------------------------------------------------------------

def nearest_banded_plain(q, dbt, pen, offsets, block: int, wb: int,
                         query_tile: int):
    """Plain PyTorch version of K6: q [Mp,3], dbt [3,Np], pen [Np],
    offsets [ntiles] -> (d2 [Mp] f32, idx [Mp] int32 sorted column).
    d2 = dx*dx + dy*dy + dz*dz + pen in that order; the lowest column wins
    a tie inside a block, a strict '<' decides across blocks."""
    mp = q.shape[0]
    tq = query_tile
    dev = q.device
    qt = q.reshape(mp // tq, tq, 3)
    minv = torch.full((mp // tq, tq), BIG, dtype=torch.float32, device=dev)
    mini = torch.zeros((mp // tq, tq), dtype=torch.int32, device=dev)
    ar = torch.arange(block, device=dev)
    for j in range(wb):
        cols = ((offsets.long() + j) * block)[:, None] + ar[None, :]  # [T,blk]
        dx = qt[..., 0:1] - dbt[0][cols][:, None, :]
        dy = qt[..., 1:2] - dbt[1][cols][:, None, :]
        dz = qt[..., 2:3] - dbt[2][cols][:, None, :]
        d2 = dx * dx + dy * dy + dz * dz + pen[cols][:, None, :]
        tmin, targ = torch.min(d2, dim=2)     # first index of the minimum
        tidx = torch.gather(cols, 1, targ).int()
        better = tmin < minv
        minv = torch.where(better, tmin, minv)
        mini = torch.where(better, tidx, mini)
    return minv.reshape(mp), mini.reshape(mp)


def _launch_nearest_banded(q, dbt, pen, offsets, block, wb, query_tile,
                           plan: Optional[dict] = None):
    """Launch K6 on CUDA tensors (the layouts of `nearest_banded_plain`)
    -> (d2, idx): one CTA per unit of `plan` (default
    `nearest_banded_plan`)."""
    f32, i32 = torch.float32, torch.int32
    kernels.require_cuda("nearest_banded", q, dbt, pen, offsets,
                         dtypes=(f32, f32, f32, i32))
    mp, np_ = q.shape[0], dbt.shape[1]
    if plan is None:
        plan = nearest_banded_plan(mp, query_tile, kernels.sm_count(q.device))
    d2 = torch.empty((mp,), dtype=f32, device=q.device)
    idx = torch.empty((mp,), dtype=i32, device=q.device)
    fn = kernels.entry("banded.cu", "pct_banded_nn", n_ptr=6, n_int=6)
    kernels.check(fn(q.data_ptr(), dbt.data_ptr(), pen.data_ptr(),
                     offsets.data_ptr(), d2.data_ptr(), idx.data_ptr(),
                     mp, np_, block, wb, query_tile, plan["lanes"],
                     kernels.stream_ptr(q.device)), "nearest_banded")
    return d2, idx


def _nearest_banded_args(bdb: BandedDB, query, block, window_blocks,
                         query_tile):
    """(q [Mp,3], dbt [3,Np], pen [Np], offsets) for K6 and its plain
    version: the query zero-padded to a tile multiple."""
    m = query.shape[0]
    mp = round_up(m, query_tile)
    q = torch.nn.functional.pad(query.float(), (0, 0, 0, mp - m)).contiguous()
    _check_window("nearest_banded", bdb.dbt.shape[-1], block, window_blocks,
                  mp, query_tile)
    offsets = _tile_offsets(bdb, _sorted_axis(q, bdb.axis), query_tile,
                            block, window_blocks)
    return (q, bdb.dbt.float().contiguous(),
            bdb.penalty.reshape(-1).float().contiguous(), offsets.contiguous())


def nearest_banded(bdb: BandedDB, query: torch.Tensor, block: int = 2048,
                   window_blocks: int = 2, query_tile: int = 512):
    """K6 wrapper: query [M,3] (tiles sorted by bdb.axis for coherence) ->
    (d2 [M], idx [M] into the ORIGINAL db order), single db. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    m = query.shape[0]
    args = _nearest_banded_args(bdb, query, block, window_blocks, query_tile)
    if query.device.type == "cpu":
        d2, sidx = nearest_banded_plain(*args, block, window_blocks,
                                        query_tile)
    else:
        d2, sidx = _launch_nearest_banded(*args, block, window_blocks,
                                          query_tile)
        nearest_banded.launches += 1
    return d2[:m], bdb.order[sidx[:m].long()]


nearest_banded.launches = 0


# ---------------------------------------------------------------------------
# K7 / K8 shared plain association + moments
# ---------------------------------------------------------------------------

def _moments_tiles_plain(xt, yt, zt, qpen, dbt4, pen2, base, block: int,
                         wb: int, thresh2: float) -> torch.Tensor:
    """[ntiles,16] f64 per-tile moments sum w [p;1][q;1]^T of transformed
    query tiles xt/yt/zt/qpen [T,TQ] against their windows, with
    d2' = pen2 - 2 ((x bx + y by) + z bz), the coordinates of a block's
    tied minima averaged, a strict '<' across blocks, and the gate
    (minv + |p|^2) + qpen < thresh2."""
    ntiles, tq = xt.shape
    dev = xt.device
    ar = torch.arange(block, device=dev)
    minv = torch.full((ntiles, tq), BIG, dtype=torch.float32, device=dev)
    macc = torch.cat([torch.zeros((ntiles, 3, tq), device=dev),
                      torch.ones((ntiles, 1, tq), device=dev)], dim=1)
    for j in range(wb):
        cols = ((base.long() + j) * block)[:, None] + ar[None, :]   # [T,blk]
        win = dbt4[:, cols].permute(1, 0, 2)                       # [T,4,blk]
        bx, by, bz = (win[:, k, :, None] for k in range(3))        # [T,blk,1]
        cross = (bx * xt[:, None, :] + by * yt[:, None, :]) + bz * zt[:, None, :]
        d2 = pen2[cols][:, :, None] - 2.0 * cross                  # [T,blk,TQ]
        tmin = torch.amin(d2, dim=1)
        sel = (d2 <= tmin[:, None, :]).float()
        ext = torch.bmm(win, sel)                                  # [T,4,TQ]
        better = tmin < minv
        minv = torch.where(better, tmin, minv)
        macc = torch.where(better[:, None, :], ext, macc)
    cnt = torch.clamp_min(macc[:, 3], 1.0)
    matched = macc[:, 0:3] / cnt[:, None, :]
    qn = xt * xt + yt * yt + zt * zt
    w = ((minv + qn + qpen) < thresh2).float()
    ones = torch.ones_like(xt)
    hp = torch.stack([xt, yt, zt, ones], dim=1) * w[:, None, :]    # [T,4,TQ]
    hq = torch.cat([matched, ones[:, None, :]], dim=1)
    return torch.bmm(hp.double(), hq.transpose(1, 2).double()).reshape(
        ntiles, 16)


def _sum_partials(partials: torch.Tensor) -> torch.Tensor:
    """[ntiles,16] f64 -> [4,4] f32: one fixed-order f64 sum, rounded once."""
    return torch.sum(partials, dim=0).float().reshape(4, 4)


# ---------------------------------------------------------------------------
# K7 icp_moments_banded
# ---------------------------------------------------------------------------

def icp_moments_banded_plain(q, qpen, dbt4, pen2, offsets, block: int,
                             wb: int, query_tile: int, thresh2: float):
    """Plain PyTorch version of K7: q [Mp,3] transformed sorted source,
    qpen [Mp] (0 valid / BIG), dbt4 [4,Np], pen2 [Np], offsets [ntiles]
    -> [ntiles,16] f64 per-tile moments."""
    tq = query_tile
    qt = q.reshape(-1, tq, 3)
    return _moments_tiles_plain(qt[..., 0], qt[..., 1], qt[..., 2],
                                qpen.reshape(-1, tq), dbt4, pen2, offsets,
                                block, wb, thresh2)


def _launch_icp_moments_banded(q, qpen, dbt4, pen2, offsets, block, wb,
                               query_tile, thresh2,
                               plan: Optional[dict] = None):
    """Launch K7 on CUDA tensors (the layouts of
    `icp_moments_banded_plain`) -> [ntiles,16] f64: K8's body with the
    queries as given and the wrapper's window offsets, one CTA per unit
    of `plan` (default `moments_v2_plan`)."""
    f32, i32 = torch.float32, torch.int32
    kernels.require_cuda("icp_moments_banded", q, qpen, dbt4, pen2, offsets,
                         dtypes=(f32, f32, f32, f32, i32))
    dev = q.device
    mp, np_ = q.shape[0], dbt4.shape[1]
    if plan is None:
        plan = moments_v2_plan(mp, query_tile, kernels.sm_count(dev))
    out, part, tickets = _moments_scratch(dev, mp // query_tile, plan)
    fn = kernels.entry("banded.cu", "pct_banded_moments", n_ptr=8, n_int=6,
                       n_float=1)
    kernels.check(fn(q.data_ptr(), qpen.data_ptr(), dbt4.data_ptr(),
                     pen2.data_ptr(), offsets.data_ptr(), out.data_ptr(),
                     part.data_ptr(), tickets.data_ptr(), mp, np_, block, wb,
                     query_tile, plan["lanes"], thresh2,
                     kernels.stream_ptr(dev)), "icp_moments_banded")
    return out


def _icp_moments_banded_args(bdb: BandedDB, query, query_mask, block,
                             window_blocks, query_tile, tiles_per_step):
    """(q, qpen, dbt4, pen2, offsets) for K7 and its plain version; the
    query is padded to a multiple of query_tile * tiles_per_step with
    zero points of penalty BIG (weight 0), as the reference pads."""
    m = query.shape[0]
    mp = round_up(m, query_tile * tiles_per_step)
    q = torch.nn.functional.pad(query.float(), (0, 0, 0, mp - m)).contiguous()
    qpen = torch.nn.functional.pad(
        torch.where(query_mask, 0.0, BIG).float(), (0, mp - m), value=BIG)
    _check_window("icp_moments_banded", bdb.dbt4.shape[-1], block,
                  window_blocks, mp, query_tile)
    offsets = _tile_offsets(bdb, _sorted_axis(q, bdb.axis), query_tile,
                            block, window_blocks)
    return (q, qpen.contiguous(), bdb.dbt4.float().contiguous(),
            bdb.pen2.reshape(-1).float().contiguous(), offsets.contiguous())


def icp_moments_banded(bdb: BandedDB, query: torch.Tensor,
                       query_mask: torch.Tensor, dist_thresh: float = 5.0,
                       block: int = 2048, window_blocks: int = 2,
                       query_tile: int = 512,
                       tiles_per_step: int = 4) -> torch.Tensor:
    """K7 wrapper: one fused association + moment pass. query [M,3] =
    transformed, SORTED source points; query_mask [M]. Returns
    M [4,4] = sum w [p;1][q;1]^T (q = matched db point). `tiles_per_step`
    only sets the padding (the TPU grouped tiles per grid step); padded
    queries carry weight 0, so it changes no result."""
    args = _icp_moments_banded_args(bdb, query, query_mask, block,
                                    window_blocks, query_tile, tiles_per_step)
    th2 = float(dist_thresh) ** 2     # rounded to f32 where it is used
    if query.device.type == "cpu":
        parts = icp_moments_banded_plain(*args, block, window_blocks,
                                         query_tile, th2)
    else:
        parts = _launch_icp_moments_banded(*args, block, window_blocks,
                                           query_tile, th2)
        icp_moments_banded.launches += 1
    return _sum_partials(parts)


icp_moments_banded.launches = 0


# ---------------------------------------------------------------------------
# K8 icp_moments_banded_v2
# ---------------------------------------------------------------------------

def _pose_scalars(T: torch.Tensor, bdb: BandedDB) -> torch.Tensor:
    """[16] f32: R row-major, t, lo, hi, axis, 0 (the reference's SMEM
    scalars)."""
    return torch.cat([T[:3, :3].reshape(9), T[:3, 3], bdb.lo.reshape(1),
                      bdb.hi.reshape(1), bdb.axis.float().reshape(1),
                      torch.zeros((1,), device=T.device)]).float().contiguous()


def icp_moments_banded_v2_plain(scal, lut, centers, src3, spen, dbt4, pen2t,
                                block: int, wb: int, query_tile: int,
                                thresh2: float):
    """Plain PyTorch version of K8: scal [16], lut [LUT_BINS+1] i32,
    centers [3*ntiles], src3 [3,Mp], spen [Mp], dbt4 [4,Np], pen2t [Np]
    -> [ntiles,16] f64 per-tile moments. Each tile is transformed by the
    pose as ((r0 x + r1 y) + r2 z) + t, and its window starts at
    clip(lut[bin] // block - wb // 2, 0, nb - wb) from its transformed
    centre."""
    r = [scal[k] for k in range(12)]
    tq = query_tile
    nb = dbt4.shape[1] // block
    c = centers.reshape(-1, 3)
    cx = r[0] * c[:, 0] + r[1] * c[:, 1] + r[2] * c[:, 2] + r[9]
    cy = r[3] * c[:, 0] + r[4] * c[:, 1] + r[5] * c[:, 2] + r[10]
    cz = r[6] * c[:, 0] + r[7] * c[:, 1] + r[8] * c[:, 2] + r[11]
    axf = scal[14]
    val = torch.where(axf < 0.5, cx, torch.where(axf < 1.5, cy, cz))
    pos = lut[_lut_bin(val, scal[12], scal[13])].long()
    base = torch.clamp(torch.div(pos, block, rounding_mode="floor") - wb // 2,
                       0, nb - wb)
    x, y, z = (src3[k].reshape(-1, tq) for k in range(3))
    xt = r[0] * x + r[1] * y + r[2] * z + r[9]
    yt = r[3] * x + r[4] * y + r[5] * z + r[10]
    zt = r[6] * x + r[7] * y + r[8] * z + r[11]
    return _moments_tiles_plain(xt, yt, zt, spen.reshape(-1, tq), dbt4,
                                pen2t, base, block, wb, thresh2)


def _unit_plan(mp: int, query_tile: int, sms: int, lanes: Optional[int],
               qpt: int) -> Optional[dict]:
    """The units of one K6, K7 or K8 launch (their CTA of MOMENTS_THREADS
    threads, `qpt` queries a thread); see `moments_v2_plan`."""
    slots = MOMENTS_THREADS * qpt
    ntiles = mp // query_tile

    def units(ln):
        return ntiles * -(-query_tile // (slots // ln))
    if lanes is None:
        lanes = 1
        while lanes < MOMENTS_MAX_LANES and query_tile % (slots // lanes):
            lanes *= 2
        while (lanes < MOMENTS_MAX_LANES
               and units(lanes) < MOMENTS_UNITS_PER_SM * sms):
            lanes *= 2
    elif lanes < 1 or lanes > MOMENTS_MAX_LANES or lanes & (lanes - 1):
        return None
    slc = slots // lanes
    return dict(lanes=lanes, qpt=qpt, slice=slc, slices=-(-query_tile // slc),
                tiles=ntiles, units=units(lanes), sms=sms)


def moments_v2_plan(mp: int, query_tile: int, sms: int,
                    lanes: Optional[int] = None) -> Optional[dict]:
    """How one K7 or K8 launch of `mp` queries in tiles of `query_tile`
    spreads over a card of `sms` SMs (the rule of
    `pallas_icp_mega.unit_plan` at B = 1, with their CTA shape). `lanes`
    (a power of two up to 32) lanes share a query, so a unit holds
    `slice` = MOMENTS_THREADS * MOMENTS_QPT / lanes queries of one tile;
    by default `lanes` is first raised until `slice` divides the tile,
    then until there are MOMENTS_UNITS_PER_SM units per SM. A tile is
    `slices` units; the grid is all `units`. None for lanes the kernel
    does not take."""
    return _unit_plan(mp, query_tile, sms, lanes, MOMENTS_QPT)


def nearest_banded_plan(mp: int, query_tile: int, sms: int,
                        lanes: Optional[int] = None) -> Optional[dict]:
    """How one K6 launch spreads over the card: `moments_v2_plan`'s rule
    with K6's NEAREST_QPT queries a thread. K6 keeps 4 units an SM
    resident (`__launch_bounds__(256, 4)`), so P5's 512 units (16,384
    queries in tiles of 512 at 32 lanes) run in one wave on 132 SMs."""
    return _unit_plan(mp, query_tile, sms, lanes, NEAREST_QPT)


def unit_queries(plan: dict, query_tile: int, unit: int) -> list:
    """The query columns unit `unit` of a K6, K7 or K8 launch of `plan`
    holds, in the kernel's thread order: slice q0 of tile t, query q0 + s
    * (threads / lanes) + group for s < plan["qpt"], where it lies in the
    tile."""
    groups = MOMENTS_THREADS // plan["lanes"]
    tile, sl = divmod(unit, plan["slices"])
    q0 = sl * plan["slice"]
    return [tile * query_tile + q0 + s * groups + g
            for s in range(plan["qpt"]) for g in range(groups)
            if q0 + s * groups + g < query_tile]


def _moments_scratch(dev: torch.device, ntiles: int, plan: dict):
    """(out [ntiles,16] f64, part [units,16] f64, tickets) for one K7 or
    K8 launch of `plan` on `dev`. The tickets (one per query tile) are
    zeroed once per device: the kernel puts each back to 0."""
    buf = _tickets.get(dev)
    if buf is None or buf.numel() < ntiles:
        buf = torch.zeros(max(ntiles, 1024), dtype=torch.int32, device=dev)
        _tickets[dev] = buf
    f64 = torch.float64
    return (torch.empty((ntiles, 16), dtype=f64, device=dev),
            torch.empty((plan["units"], 16), dtype=f64, device=dev), buf)


def _launch_icp_moments_banded_v2(scal, lut, centers, src3, spen, dbt4,
                                  pen2t, block, wb, query_tile, thresh2,
                                  plan: Optional[dict] = None):
    """Launch K8 on CUDA tensors (the layouts of
    `icp_moments_banded_v2_plain`) -> [ntiles,16] f64: one CTA per unit
    of `plan` (default `moments_v2_plan`); the last unit of each tile sums
    the tile's unit partials in slice order."""
    f32, i32 = torch.float32, torch.int32
    kernels.require_cuda("icp_moments_banded_v2", scal, lut, centers, src3,
                         spen, dbt4, pen2t,
                         dtypes=(f32, i32, f32, f32, f32, f32, f32))
    dev = src3.device
    mp, np_ = src3.shape[1], dbt4.shape[1]
    if plan is None:
        plan = moments_v2_plan(mp, query_tile, kernels.sm_count(dev))
    out, part, tickets = _moments_scratch(dev, mp // query_tile, plan)
    fn = kernels.entry("banded.cu", "pct_banded_moments_v2", n_ptr=10,
                       n_int=6, n_float=1)
    kernels.check(fn(scal.data_ptr(), lut.data_ptr(), centers.data_ptr(),
                     src3.data_ptr(), spen.data_ptr(), dbt4.data_ptr(),
                     pen2t.data_ptr(), out.data_ptr(), part.data_ptr(),
                     tickets.data_ptr(), mp, np_, block, wb, query_tile,
                     plan["lanes"], thresh2, kernels.stream_ptr(dev)),
                  "icp_moments_banded_v2")
    return out


def _icp_moments_banded_v2_args(bdb: BandedDB, pen2t, src3, spen, centers,
                                T, block, window_blocks, query_tile):
    """(scal, lut, centers, src3, spen, dbt4, pen2t) for K8 and its plain
    version."""
    _check_window("icp_moments_banded_v2", bdb.dbt4.shape[-1], block,
                  window_blocks, src3.shape[1], query_tile)
    return (_pose_scalars(T.float(), bdb), bdb.lut.int().contiguous(),
            centers.reshape(-1).float().contiguous(),
            src3.float().contiguous(), spen.reshape(-1).float().contiguous(),
            bdb.dbt4.float().contiguous(),
            pen2t.reshape(-1).float().contiguous())


def icp_moments_banded_v2(bdb: BandedDB, pen2t: torch.Tensor,
                          src3: torch.Tensor, spen: torch.Tensor,
                          centers: torch.Tensor, T: torch.Tensor,
                          dist_thresh: float = 5.0, block: int = 2048,
                          window_blocks: int = 2,
                          query_tile: int = 512) -> torch.Tensor:
    """K8 wrapper: one fused transform + association + moment pass given
    the pose T [4,4]. src3 [3,Mp] SORTED source points (pre-transform,
    padded), spen [1,Mp] 0 valid / BIG, centers [1,3*ntiles] per-tile
    centre source coords, pen2t [Np,1] = bdb.pen2 transposed. Returns
    M [4,4] = sum w [p;1][q;1]^T with p = T src."""
    args = _icp_moments_banded_v2_args(bdb, pen2t, src3, spen, centers, T,
                                       block, window_blocks, query_tile)
    th2 = float(dist_thresh) ** 2     # rounded to f32 where it is used
    if src3.device.type == "cpu":
        parts = icp_moments_banded_v2_plain(*args, block, window_blocks,
                                            query_tile, th2)
    else:
        parts = _launch_icp_moments_banded_v2(*args, block, window_blocks,
                                              query_tile, th2)
        icp_moments_banded_v2.launches += 1
    return _sum_partials(parts)


icp_moments_banded_v2.launches = 0
