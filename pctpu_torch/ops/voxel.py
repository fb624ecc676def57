"""Centroid voxel downsample (port of `pctpu/ops/voxel.py`):
`voxel_downsample` for one cloud at full capacity, and the batched
`voxel_downsample_capped` with a uniform-stride cap.

`voxel_downsample_capped`: one stable sort on a fused int32 cell key carries the cell-relative
coordinates and the mask as payload; per-voxel sums are CUMSUM
DIFFERENCES at run boundaries; when more than `cap` voxels exist a uniform
stride over the cell-sorted voxel ids picks the kept ones. The output is
cell-lexsorted (x-major), which the x-band FPFH relies on."""
from __future__ import annotations

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
                     method: str = "centroid") -> PointCloud:
    """points [N,3], mask [N] -> PointCloud of voxel centroids (capacity
    N, valid voxels compacted to the front in (x, y, z) cell order).

    The reference's 3-key `lexsort` is three stable sorts here; its
    `segment_sum` is a cumsum difference over each voxel's contiguous run
    in f64, rounded once to f32, which is deterministic on the card. Only
    `method="centroid"` is ported."""
    if method != "centroid":
        raise ValueError(f"voxel_downsample: method {method!r} is not "
                         "ported (only 'centroid')")
    n = points.shape[0]
    dev = points.device
    points = points.float()
    pmin = torch.amin(torch.where(mask[:, None], points,
                                  torch.full_like(points, 1e30)), dim=0)
    cellf = torch.floor((points - pmin) / float(leaf))
    cell = torch.where(mask[:, None], cellf, 0.0).long()
    cell = torch.where(mask[:, None], cell, INT_SENTINEL)   # padding last
    order = torch.arange(n, device=dev)
    for k in (2, 1, 0):                      # lexsort, x the primary key
        _, perm = torch.sort(cell[order, k], stable=True)
        order = order[perm]
    cs, ps, ms = cell[order], points[order], mask[order]

    new_run = torch.any(cs != torch.roll(cs, 1, dims=0), dim=1)
    new_run[0] = True
    new_run = new_run & ms
    seg = torch.cumsum(new_run.long(), dim=0) - 1
    nv = new_run.sum()
    nxt_start = torch.cat([new_run[1:] | ~ms[1:],
                           torch.ones(1, dtype=torch.bool, device=dev)])
    is_end = ms & nxt_start
    idx = torch.arange(n, device=dev)

    def by_voxel(flag):   # row index of each voxel's flagged row
        slot = torch.where(flag, seg, n)     # slot n collects the rest
        return torch.zeros(n + 1, dtype=torch.long, device=dev).scatter_(
            0, slot, idx)[:n]

    s_v, e_v = by_voxel(new_run), by_voxel(is_end)
    vals = torch.cat([torch.where(ms[:, None], ps, 0.0),
                      ms[:, None].float()], dim=1).double()
    csum = torch.cumsum(vals, dim=0)
    sums = csum[e_v] - torch.where((s_v > 0)[:, None],
                                   csum[torch.clamp_min(s_v - 1, 0)], 0.0)
    out_pts = (sums[:, :3] / torch.clamp_min(sums[:, 3:], 1.0)).float()
    out_mask = idx < nv
    out_pts = torch.where(out_mask[:, None], out_pts, out_pts[:1])
    return PointCloud(points=out_pts, mask=out_mask)
