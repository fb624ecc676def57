"""FPFH-33 descriptors from radius neighbour lists (port of
`pctpu/features/fpfh.py`: `spfh`, `fpfh`), single cloud. This is the
path of the single-pair `register_pair`; the batched pipeline uses the
fused kernels of `features.pallas_fpfh`.

Per neighbour pair (p -> q), with u = n_p, v = normalize(d x u),
w = u x v, d = (q - p)/|q - p|: f1 = v . n_q, f2 = u . d,
f3 = atan2(w . n_q, u . n_q); 11 bins each -> 33-D;
FPFH_i = SPFH_i + (1/k) sum_j (1/d_ij) SPFH_j, each 11-bin block
renormalised to sum 100.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from pctpu_torch.ops.eigh3 import _cross
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.knn import NeighborSet, radius_search
from pctpu_torch.ops.normals import estimate_normals

N_BINS = 11


def _bin(x, lo, hi):
    b = torch.floor((x - lo) / (hi - lo) * N_BINS)
    return torch.clamp(b, 0, N_BINS - 1).long()


def _pair_features(p, n_p, q, n_q):
    """p, n_p [N,3]; q, n_q [N,K,3] -> (f1, f2, f3, dist) each [N,K]."""
    d = q - p[:, None, :]
    dist = torch.linalg.vector_norm(d, dim=-1)
    dhat = d / torch.clamp_min(dist, 1e-12)[..., None]
    u = n_p[:, None, :].expand_as(dhat)
    v = _cross(dhat, u)
    v = v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                            1e-12)
    w = _cross(u, v)
    f1 = torch.sum(v * n_q, dim=-1)
    f2 = torch.sum(u * dhat, dim=-1)
    f3 = torch.atan2(torch.sum(w * n_q, dim=-1), torch.sum(u * n_q, dim=-1))
    return f1, f2, f3, dist


def _histogram(f, valid):
    """f [N,K] bin indices -> [N, N_BINS] with 100/neighbours increments."""
    oh = torch.nn.functional.one_hot(f, N_BINS).float() * valid[..., None]
    cnt = torch.clamp_min(valid.sum(dim=1), 1.0)
    return 100.0 * oh.sum(dim=1) / cnt[:, None]


def spfh(points: torch.Tensor, normals: torch.Tensor,
         neighbors: NeighborSet) -> torch.Tensor:
    """Simplified Point Feature Histogram per point -> [N,33]."""
    q = group_points(points, neighbors.idx)
    n_q = group_points(normals, neighbors.idx)
    f1, f2, f3, _ = _pair_features(points, normals, q, n_q)
    rows = torch.arange(neighbors.idx.shape[0],
                        device=points.device)[:, None]
    valid = (neighbors.valid & (neighbors.idx != rows)).float()
    h1 = _histogram(_bin(f1, -1.0, 1.0), valid)
    h2 = _histogram(_bin(f2, -1.0, 1.0), valid)
    h3 = _histogram(_bin(f3, -math.pi, math.pi), valid)
    return torch.cat([h1, h2, h3], dim=-1)


def fpfh(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
         normals: Optional[torch.Tensor] = None, radius: float = 10.0,
         k_cap: int = 100, normal_k: int = 30) -> torch.Tensor:
    """points [N,3] -> FPFH descriptors [N,33]: descriptor radius 10, at
    most k_cap = 100 neighbours, normals from normal_k = 30 neighbours by
    default."""
    n = points.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=points.device)
    if normals is None:
        normals = estimate_normals(points, mask=mask, k=normal_k)
    nbrs = radius_search(points, points, radius, k_cap, db_mask=mask)
    s = spfh(points, normals, nbrs)                              # [N,33]
    rows = torch.arange(n, device=points.device)[:, None]
    not_self = nbrs.valid & (nbrs.idx != rows)
    dist = torch.sqrt(torch.clamp_min(nbrs.dist2, 1e-12))
    wgt = torch.where(not_self, 1.0 / dist, 0.0)
    k_eff = torch.clamp_min(not_self.sum(dim=1).float(), 1.0)
    nbr_spfh = group_points(s, nbrs.idx)                         # [N,K,33]
    f = s + torch.sum(nbr_spfh * wgt[..., None], dim=1) / k_eff[:, None]
    blocks = f.reshape(n, 3, N_BINS)
    sums = torch.clamp_min(blocks.sum(dim=-1, keepdim=True), 1e-12)
    return (100.0 * blocks / sums).reshape(n, 3 * N_BINS)
