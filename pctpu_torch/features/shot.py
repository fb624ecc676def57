"""SHOT-352 descriptors (port of `pctpu/features/shot.py`, the PCL
wrapper's `featureSHOT352`): per keypoint a local reference frame from
the distance-weighted neighbourhood covariance with sign disambiguation,
a 32-sector partition (8 azimuth x 2 elevation x 2 radial shells), and
an 11-bin histogram of cos(angle between the LRF's z axis and each
neighbour's normal) per sector -> 352-D, L2-normalised. The sector and
bin counts are one `scatter_add_` into 352 bins per keypoint."""
from __future__ import annotations

import math
from typing import Optional

import torch

from pctpu_torch.ops.eigh3 import _cross, eigh3
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.knn import NeighborSet, radius_search
from pctpu_torch.ops.normals import estimate_normals

N_AZIMUTH = 8
N_ELEVATION = 2
N_RADIAL = 2
N_SPATIAL = N_AZIMUTH * N_ELEVATION * N_RADIAL  # 32
N_COS_BINS = 11
DESC_DIM = N_SPATIAL * N_COS_BINS               # 352


def _sign_votes(diff: torch.Tensor, axis: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """+1 where most valid neighbours lie on the axis' positive side (ties
    and sign(0) = 0 count as positive), else -1: [M]."""
    s = torch.where(valid, torch.sign(torch.einsum("mki,mi->mk", diff, axis)),
                    0.0).sum(dim=1)
    return torch.where(s < 0, -1.0, 1.0)


def _local_reference_frames(keypoints: torch.Tensor, db_points: torch.Tensor,
                            nbrs: NeighborSet, radius: float) -> torch.Tensor:
    """keypoints [M,3], db_points [N,3] (what nbrs.idx indexes) -> [M,3,3]
    LRFs, rows (x, y, z): x the largest and z the least eigenvector of the
    (radius - d)-weighted covariance, each turned to its neighbours'
    majority side, x re-orthogonalised against z, y = z x x."""
    nbr = group_points(db_points, nbrs.idx)                      # [M,K,3]
    d = torch.sqrt(torch.clamp_min(nbrs.dist2, 0.0))
    w = torch.where(nbrs.valid, radius - d, 0.0)
    wsum = torch.clamp_min(w.sum(dim=1), 1e-12)
    diff = nbr - keypoints[:, None, :]
    cov = torch.einsum("mk,mki,mkj->mij", w, diff, diff) / wsum[:, None, None]
    _, V = eigh3(cov)
    x_axis = V[:, :, 2] * _sign_votes(diff, V[:, :, 2], nbrs.valid)[:, None]
    z_axis = V[:, :, 0] * _sign_votes(diff, V[:, :, 0], nbrs.valid)[:, None]
    x_axis = x_axis - torch.sum(x_axis * z_axis, dim=1,
                                keepdim=True) * z_axis
    x_axis = x_axis / torch.clamp_min(
        torch.linalg.vector_norm(x_axis, dim=1, keepdim=True), 1e-12)
    return torch.stack([x_axis, _cross(z_axis, x_axis), z_axis], dim=1)


def shot352(points: torch.Tensor,
            keypoints: torch.Tensor,
            mask: Optional[torch.Tensor] = None,
            normals: Optional[torch.Tensor] = None,
            radius: float = 1.0,
            k_cap: int = 128,
            normal_k: int = 16) -> torch.Tensor:
    """points [N,3], keypoints [M,3] -> [M,352] descriptors over the
    keypoints' radius neighbours (at most k_cap). Normals default to
    kNN(normal_k) normals facing the cloud's centroid (a rotation-
    equivariant sign, so the histograms are rotation-invariant)."""
    n = points.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=points.device)
    if normals is None:
        w = mask.float()
        centroid = torch.sum(points * w[:, None], dim=0) / torch.clamp_min(
            w.sum(), 1.0)
        normals = estimate_normals(points, mask=mask, k=normal_k,
                                   viewpoint=centroid)
    nbrs = radius_search(keypoints, points, radius, k_cap, db_mask=mask)
    lrf = _local_reference_frames(keypoints, points, nbrs, radius)

    nbr_p = group_points(points, nbrs.idx)                       # [M,K,3]
    nbr_n = group_points(normals, nbrs.idx)
    local = torch.einsum("mai,mki->mka", lrf, nbr_p - keypoints[:, None, :])
    d = torch.linalg.vector_norm(local, dim=-1)

    # true divisions, as the reference's: CUDA turns a division by a
    # Python scalar into a product with its reciprocal
    two_pi = torch.tensor(2 * math.pi, device=points.device)
    azimuth = torch.atan2(local[..., 1], local[..., 0])
    az_bin = torch.clamp(torch.floor((azimuth + math.pi) / two_pi
                                     * N_AZIMUTH), 0, N_AZIMUTH - 1).long()
    el_bin = (local[..., 2] >= 0).long()
    rad_bin = (d >= radius * 0.5).long()
    sector = (rad_bin * N_ELEVATION + el_bin) * N_AZIMUTH + az_bin

    cos_t = torch.clamp(torch.einsum("mi,mki->mk", lrf[:, 2], nbr_n),
                        -1.0, 1.0)
    cos_bin = torch.clamp(torch.floor((cos_t + 1.0) / 2.0 * N_COS_BINS),
                          0, N_COS_BINS - 1).long()
    valid = (nbrs.valid & (d > 1e-9)).float()
    desc = torch.zeros((keypoints.shape[0], DESC_DIM), dtype=torch.float32,
                       device=points.device)
    desc.scatter_add_(1, sector * N_COS_BINS + cos_bin, valid)
    norm = torch.clamp_min(torch.linalg.vector_norm(desc, dim=1,
                                                    keepdim=True), 1e-12)
    return desc / norm
