"""Per-point normals from kNN neighbourhoods (port of
`pctpu/ops/normals.py:neighborhood_covariances`, `estimate_normals`): the
least eigenvector of each neighbourhood's covariance, from the closed-form
3x3 solver (`ops.eigh3`)."""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.ops.eigh3 import eigh3
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.knn import knn


def neighborhood_covariances(points: torch.Tensor, idx: torch.Tensor,
                             valid: torch.Tensor):
    """points [N,3], idx [M,K], valid [M,K] -> (cov [M,3,3], count [M])."""
    nbr = group_points(points, idx)                        # [M,K,3]
    w = valid.float()
    cnt = torch.clamp_min(w.sum(dim=1), 1.0)
    mean = torch.sum(nbr * w[..., None], dim=1) / cnt[:, None]
    d = (nbr - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("mki,mkj->mij", d, d) / cnt[:, None, None]
    return cov, cnt


def estimate_normals(points: torch.Tensor,
                     mask: Optional[torch.Tensor] = None, k: int = 5,
                     viewpoint: Optional[torch.Tensor] = None,
                     query_chunk: int = 1024) -> torch.Tensor:
    """points [N,3] -> [N,3] normals: the least eigenvector of the kNN(k)
    neighbourhood covariance (k includes the point itself). With
    `viewpoint` [3], normals are flipped to face it."""
    res = knn(points, points, k, db_mask=mask, query_chunk=query_chunk)
    cov, _ = neighborhood_covariances(points, res.idx, res.valid)
    _, vecs = eigh3(cov)
    normals = vecs[:, :, 0]
    if viewpoint is not None:
        to_vp = viewpoint[None, :] - points
        sign = torch.where(torch.sum(normals * to_vp, dim=-1) < 0, -1.0, 1.0)
        normals = normals * sign[:, None]
    return normals
