"""Voxel downsample (port of `pctpu/ops/voxel.py`): `voxel_downsample`
for one cloud at full capacity (centroid or random member),
`voxel_downsample_cloud`, the batched `voxel_downsample_capped` with a
uniform-stride cap and `voxel_downsample_batch` (the capped one at
cap = N).

`voxel_downsample_capped`: one stable sort on a fused int32 cell key
carries the cell-relative coordinates and the mask as payload; per-voxel sums are CUMSUM
DIFFERENCES at run boundaries; when more than `cap` voxels exist a uniform
stride over the cell-sorted voxel ids picks the kept ones. The output is
cell-lexsorted (x-major), which the x-band FPFH relies on."""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.ops.gather import _flat_row_gather

INT_SENTINEL = 2**31 - 1


def voxel_downsample_capped(points: torch.Tensor, mask: torch.Tensor,
                            leaf: float, cap: int, max_cells: int = 1024):
    """[B,N,3] x [B,N] -> (PointCloud [B,cap], pre-cap voxel counts [B]).

    Cells clamp to `max_cells` per axis (points beyond merge into edge
    voxels). The reference's `lax.sort(num_keys=1)` is a stable sort on
    the key; here it is a stable `torch.sort` plus a gather of the payload.
    """
    b, n, _ = points.shape
    dev = points.device
    points = points.float()
    pmin = torch.amin(torch.where(mask[..., None], points,
                                  torch.full_like(points, 1e30)), dim=1)
    cellf = torch.floor((points - pmin[:, None, :]) / float(leaf))
    # clamp in float before the int cast (saturating conversion + clip)
    cell = torch.clamp(cellf, 0, max_cells - 1).to(torch.int32)
    key = (cell[..., 0] * max_cells + cell[..., 1]) * max_cells + cell[..., 2]
    key = torch.where(mask, key, torch.full_like(key, INT_SENTINEL))
    corner = cell.float() * float(leaf) + pmin[:, None, :]
    rel = torch.where(mask[..., None], points - corner,
                      torch.zeros_like(points))

    ks, perm = torch.sort(key, dim=1, stable=True)
    rel = torch.gather(rel, 1, perm[..., None].expand(b, n, 3))
    ms = torch.gather(mask.float(), 1, perm)
    msb = ms > 0.5

    new_run = ks != torch.roll(ks, 1, dims=1)
    new_run[:, 0] = True
    new_run = new_run & msb
    nv = new_run.sum(dim=1, dtype=torch.int32)                   # [B]

    iota = torch.arange(n, dtype=torch.int32, device=dev).expand(b, n)
    starts_full, _ = torch.sort(
        torch.where(new_run, iota, torch.full_like(iota, n)), dim=1)
    starts_ext = torch.cat(
        [starts_full, torch.full((b, 1), n, dtype=torch.int32, device=dev)],
        dim=1)

    j = torch.arange(cap, dtype=torch.int32, device=dev)[None, :]
    vsel = torch.where(nv[:, None] > cap,
                       torch.div(j * nv[:, None], cap, rounding_mode="floor"),
                       j.expand(b, cap))

    def at(c, idx):
        return _flat_row_gather(c[..., None], idx)[..., 0]

    s_v = at(starts_ext, vsel)
    e_v = torch.clamp(at(starts_ext, vsel + 1) - 1, 0, n - 1)

    cx = torch.cumsum(rel[..., 0], dim=1)
    cy = torch.cumsum(rel[..., 1], dim=1)
    cz = torch.cumsum(rel[..., 2], dim=1)
    cc = torch.cumsum(ms, dim=1)

    def run_sum(c):
        hi = at(c, e_v)
        lo = torch.where(s_v > 0, at(c, torch.clamp_min(s_v - 1, 0)),
                         torch.zeros_like(hi))
        return hi - lo

    cnt = torch.clamp_min(run_sum(cc), 1.0)
    mean_rel = torch.stack([run_sum(cx), run_sum(cy), run_sum(cz)],
                           dim=-1) / cnt[..., None]

    # decode the voxel's cell corner from its sorted key at the run start
    kstart = at(ks, s_v)
    cz_i = kstart % max_cells
    cy_i = torch.div(kstart, max_cells, rounding_mode="floor") % max_cells
    cx_i = torch.div(kstart, max_cells * max_cells, rounding_mode="floor")
    corner_v = (torch.stack([cx_i, cy_i, cz_i], dim=-1).float()
                * float(leaf) + pmin[:, None, :])
    out_pts = corner_v + mean_rel

    out_mask = j < torch.clamp_max(nv, cap)[:, None]
    out_pts = torch.where(out_mask[..., None], out_pts,
                          out_pts[:, :1].expand_as(out_pts))
    return PointCloud(points=out_pts, mask=out_mask), nv


def voxel_downsample(points: torch.Tensor, mask: torch.Tensor, leaf: float,
                     method: str = "centroid",
                     generator: Optional[torch.Generator] = None,
                     prio: Optional[torch.Tensor] = None) -> PointCloud:
    """points [N,3], mask [N] -> PointCloud of voxel representatives
    (capacity N, valid voxels compacted to the front in (x, y, z) cell
    order).

    method "centroid": each voxel's mean. The reference's `segment_sum` is
    a cumsum difference over the voxel's contiguous run in f64, rounded
    once to f32, which is deterministic on the card.
    method "random": a uniform member. `prio` [N] int32 (default: drawn in
    [0, 2^31 - 1) from `generator`, itself seeded 0 on the points' device
    when None) is the least significant key of the stable sort, and each
    run's first row is its pick, as in the reference.

    The reference's lexsort is stable sorts, least significant key first.
    """
    if method not in ("centroid", "random"):
        raise ValueError(f"voxel_downsample: unknown method {method!r}")
    n = points.shape[0]
    dev = points.device
    points = points.float()
    pmin = torch.amin(torch.where(mask[:, None], points,
                                  torch.full_like(points, 1e30)), dim=0)
    cellf = torch.floor((points - pmin) / float(leaf))
    cell = torch.where(mask[:, None], cellf, 0.0).long()
    cell = torch.where(mask[:, None], cell, INT_SENTINEL)   # padding last
    order = torch.arange(n, device=dev)
    if method == "random":
        if prio is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            prio = torch.randint(0, INT_SENTINEL, (n,), generator=generator,
                                 device=dev, dtype=torch.int32)
        order = torch.sort(prio.to(dev), stable=True).indices
    for k in (2, 1, 0):                      # lexsort, x the primary key
        _, perm = torch.sort(cell[order, k], stable=True)
        order = order[perm]
    cs, ps, ms = cell[order], points[order], mask[order]

    new_run = torch.any(cs != torch.roll(cs, 1, dims=0), dim=1)
    new_run[0] = True
    new_run = new_run & ms
    seg = torch.cumsum(new_run.long(), dim=0) - 1
    nv = new_run.sum()
    idx = torch.arange(n, device=dev)
    out_mask = idx < nv

    def by_voxel(flag):   # row index of each voxel's flagged row
        slot = torch.where(flag, seg, n)     # slot n collects the rest
        return torch.zeros(n + 1, dtype=torch.long, device=dev).scatter_(
            0, slot, idx)[:n]

    s_v = by_voxel(new_run)
    if method == "random":
        out_pts = ps[s_v]
    else:
        nxt_start = torch.cat([new_run[1:] | ~ms[1:],
                               torch.ones(1, dtype=torch.bool, device=dev)])
        e_v = by_voxel(ms & nxt_start)
        vals = torch.cat([torch.where(ms[:, None], ps, 0.0),
                          ms[:, None].float()], dim=1).double()
        csum = torch.cumsum(vals, dim=0)
        sums = csum[e_v] - torch.where((s_v > 0)[:, None],
                                       csum[torch.clamp_min(s_v - 1, 0)], 0.0)
        out_pts = (sums[:, :3] / torch.clamp_min(sums[:, 3:], 1.0)).float()
    out_pts = torch.where(out_mask[:, None], out_pts, out_pts[:1])
    return PointCloud(points=out_pts, mask=out_mask)


def voxel_downsample_cloud(pc: PointCloud, leaf: float,
                           method: str = "centroid",
                           generator: Optional[torch.Generator] = None,
                           prio: Optional[torch.Tensor] = None) -> PointCloud:
    return voxel_downsample(pc.points, pc.mask, leaf, method=method,
                            generator=generator, prio=prio)


def voxel_downsample_batch(points: torch.Tensor, mask: torch.Tensor,
                           leaf: float) -> PointCloud:
    """Batched centroid voxel downsample at full capacity: [B,N,3] x
    [B,N] -> PointCloud [B,N] (valid voxels compacted to the front); see
    `voxel_downsample_capped`."""
    pc, _ = voxel_downsample_capped(points, mask, leaf, cap=points.shape[1])
    return pc
