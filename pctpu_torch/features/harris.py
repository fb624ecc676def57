"""Harris3D and Harris6D keypoints (port of `pctpu/features/harris.py`,
the PCL wrapper's HarrisKeypoint3D / HarrisKeypoint6D).

Harris3D: the covariance C of the unit normals in each point's radius
neighbourhood; response det(C) / tr(C) ("noble", the default) or
det(C) - k tr(C)^2 ("harris", k = 0.04); threshold and radius NMS.
Harris6D: tangent-plane intensity gradients (least squares over the
radius neighbourhood, the normal component projected out), unit-
normalised and stacked with the normals into a 6x6 second-moment matrix
per neighbourhood, whose least eigenvalue is the response.

`torch.linalg.det`, `solve_ex` and `eigvalsh` round apart from XLA's
LAPACK calls, so responses agree with the reference to rounding, not bit
for bit."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pctpu_torch.features.nms import radius_nms
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.knn import radius_search
from pctpu_torch.ops.normals import estimate_normals

MEASURES = ("noble", "harris")


class HarrisResult(NamedTuple):
    keypoint_mask: torch.Tensor   # [N] bool
    response: torch.Tensor        # [N] f32


def _ones(points: torch.Tensor) -> torch.Tensor:
    return torch.ones(points.shape[:1], dtype=torch.bool,
                      device=points.device)


def harris3d_keypoints(points: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       radius: float = 0.5,
                       threshold: float = 0.0,
                       k: float = 0.04,
                       k_cap: int = 64,
                       normal_k: int = 16,
                       normals: Optional[torch.Tensor] = None,
                       measure: str = "noble") -> HarrisResult:
    """points [N,3] -> HarrisResult (response and NMS'd keypoint mask).
    measure: "noble" (det/tr) or "harris" (det - k tr^2); the thresholds
    are measure-specific. Normals default to kNN(normal_k) normals."""
    if measure not in MEASURES:
        raise ValueError(f"measure={measure!r}: expected one of {MEASURES}")
    if mask is None:
        mask = _ones(points)
    if normals is None:
        normals = estimate_normals(points, mask=mask, k=normal_k)
    res = radius_search(points, points, radius, k_cap, db_mask=mask)
    w = res.valid.float()
    cnt = torch.clamp_min(w.sum(dim=1), 1.0)
    nbr_n = group_points(normals, res.idx) * w[..., None]        # [N,K,3]
    C = torch.einsum("nki,nkj->nij", nbr_n, nbr_n) / cnt[:, None, None]
    det = torch.linalg.det(C)
    tr = C[:, 0, 0] + C[:, 1, 1] + C[:, 2, 2]
    if measure == "harris":
        response = det - k * tr * tr
    else:
        response = det / torch.clamp_min(tr, 1e-12)
    keep = radius_nms(points, response, mask & (response > threshold),
                      radius, k_cap=k_cap)
    return HarrisResult(keep, response)


def intensity_gradients(points: torch.Tensor, intensity: torch.Tensor,
                        normals: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        radius: float = 0.5,
                        k_cap: int = 64,
                        normal_k: int = 16) -> torch.Tensor:
    """Per-point tangent-plane intensity gradient [N,3] (PCL
    IntensityGradientEstimation): the least-squares spatial gradient of
    `intensity` over the radius neighbourhood, centred on its centroid and
    mean intensity (a 1e-9 I ridge), minus its normal component.
    `normal_k` is accepted for the reference's signature and unused, as
    there."""
    del normal_k
    if mask is None:
        mask = _ones(points)
    res = radius_search(points, points, radius, k_cap, db_mask=mask)
    w = res.valid.float()
    cnt = torch.clamp_min(w.sum(dim=1), 1.0)
    nbr_p = group_points(points, res.idx)
    nbr_i = torch.where(res.valid, intensity[res.idx], 0.0)
    centroid = torch.sum(nbr_p * w[..., None], dim=1) / cnt[:, None]
    mean_i = torch.sum(nbr_i * w, dim=1) / cnt
    dp = (nbr_p - centroid[:, None, :]) * w[..., None]           # [N,K,3]
    di = (nbr_i - mean_i[:, None]) * w                           # [N,K]
    eye = torch.eye(3, dtype=dp.dtype, device=dp.device)
    A = torch.einsum("nki,nkj->nij", dp, dp) + 1e-9 * eye
    b = torch.einsum("nki,nk->ni", dp, di)
    grad = torch.linalg.solve_ex(A, b[..., None]).result[..., 0]
    return grad - torch.sum(grad * normals, dim=-1, keepdim=True) * normals


def harris6d_keypoints(points: torch.Tensor,
                       intensity: torch.Tensor,
                       mask: Optional[torch.Tensor] = None,
                       radius: float = 0.5,
                       threshold: float = 0.0,
                       k_cap: int = 64,
                       normal_k: int = 16,
                       normals: Optional[torch.Tensor] = None
                       ) -> HarrisResult:
    """Harris6D (PCL HarrisKeypoint6D): the least eigenvalue of the
    neighbourhood's 6x6 second moment of [normal, unit intensity
    gradient] (a zero gradient stays zero), threshold, radius NMS."""
    if mask is None:
        mask = _ones(points)
    if normals is None:
        normals = estimate_normals(points, mask=mask, k=normal_k)
    grad = intensity_gradients(points, intensity, normals, mask=mask,
                               radius=radius, k_cap=k_cap)
    gn = torch.linalg.vector_norm(grad, dim=-1, keepdim=True)
    grad_u = torch.where(gn > 1e-8, grad / torch.clamp_min(gn, 1e-12), 0.0)
    res = radius_search(points, points, radius, k_cap, db_mask=mask)
    w = res.valid.float()
    cnt = torch.clamp_min(w.sum(dim=1), 1.0)
    v6 = torch.cat([normals, grad_u], dim=-1)                    # [N,6]
    nbr_v = group_points(v6, res.idx) * w[..., None]             # [N,K,6]
    C6 = torch.einsum("nki,nkj->nij", nbr_v, nbr_v) / cnt[:, None, None]
    response = torch.linalg.eigvalsh(C6)[:, 0]
    keep = radius_nms(points, response, mask & (response > threshold),
                      radius, k_cap=k_cap)
    return HarrisResult(keep, response)


def rgb_to_intensity(rgb: torch.Tensor) -> torch.Tensor:
    """[N,3] RGB -> [N] luma (Rec.601 weights, PCL's RGB -> I)."""
    return 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
