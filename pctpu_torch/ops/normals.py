"""Global PCA and per-point normals from kNN neighbourhoods (port of
`pctpu/ops/normals.py`): `pca` / `pca_project` of a whole cloud, and
`neighborhood_covariances` / `estimate_normals`, the least eigenvector of
each neighbourhood's covariance. Every 3x3 eigenproblem goes through the
closed-form solver (`ops.eigh3`)."""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.ops.eigh3 import eigh3
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.knn import knn


def pca(data: torch.Tensor, mask: Optional[torch.Tensor] = None,
        correlation: bool = False):
    """Global PCA of [N,D] data -> (eigenvalues [D], eigenvectors [D,D] as
    columns), both in descending order of eigenvalue: the covariance (or,
    with `correlation`, the correlation) of the masked, centred rows.
    Three columns take `eigh3`, others `torch.linalg.eigh`."""
    if mask is None:
        mask = torch.ones(data.shape[:1], dtype=torch.bool,
                          device=data.device)
    w = mask.float()
    n = torch.clamp_min(w.sum(), 1.0)
    mean = torch.sum(data * w[:, None], dim=0) / n
    centered = (data - mean) * w[:, None]
    cov = centered.T @ centered / n
    if correlation:
        d = torch.sqrt(torch.clamp_min(torch.diagonal(cov), 1e-12))
        cov = cov / d[:, None] / d[None, :]
    if data.shape[1] == 3:
        vals, vecs = eigh3(cov)
    else:
        vals, vecs = torch.linalg.eigh(cov)
    return vals.flip(-1), vecs.flip(-1)


def pca_project(data: torch.Tensor, n_components: int = 2,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N,D] data centred on the masked mean and projected onto its top
    `n_components` principal axes -> [N,n_components]."""
    if mask is None:
        mask = torch.ones(data.shape[:1], dtype=torch.bool,
                          device=data.device)
    w = mask.float()
    mean = torch.sum(data * w[:, None], dim=0) / torch.clamp_min(w.sum(), 1.0)
    _, vecs = pca(data, mask)
    return (data - mean) @ vecs[:, :n_components]


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
