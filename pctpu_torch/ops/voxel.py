"""Batched centroid voxel downsample with a uniform-stride cap (port of
`pctpu/ops/voxel.py:voxel_downsample_capped`).

One stable sort on a fused int32 cell key carries the cell-relative
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
