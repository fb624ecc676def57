"""ISS (Intrinsic Shape Signature) keypoints (port of
`pctpu/features/iss.py`), with the PCL wrapper's defaults: salient radius
3.0, non-max radius 2.0, gamma21 = gamma32 = 0.975, 5 neighbours.

Per point i: scatter = sum_j w_j (p_j - p_i)(p_j - p_i)^T / sum_j w_j
over its radius neighbours, w_j = 1 / |N_radius(j)|; eigenvalues
l1 >= l2 >= l3 from the closed-form 3x3 solver; a candidate iff
l2 < g21 l1, l3 < g32 l2, l3 > 0 and enough neighbours; saliency l3;
then radius NMS."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pctpu_torch.features.nms import radius_nms, top_k_mask
from pctpu_torch.ops.eigh3 import eigvalsh3
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.knn import radius_search


class ISSResult(NamedTuple):
    keypoint_mask: torch.Tensor   # [N] bool
    saliency: torch.Tensor        # [N] f32 (lambda3)
    eigvals: torch.Tensor         # [N,3] descending


def iss_keypoints(points: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  salient_radius: float = 3.0,
                  non_max_radius: float = 2.0,
                  gamma_21: float = 0.975,
                  gamma_32: float = 0.975,
                  min_neighbors: int = 5,
                  k_cap: int = 64,
                  max_keypoints: int = 0) -> ISSResult:
    """points [N,3] -> ISSResult; at most `k_cap` neighbours a point enter
    its scatter matrix. max_keypoints=0 means uncapped."""
    n = points.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=points.device)
    res = radius_search(points, points, salient_radius, k_cap, db_mask=mask)
    # each neighbour weighs 1 / (its own radius-neighbour count)
    w_all = torch.reciprocal(torch.clamp_min(res.count.float(), 1.0))
    nbr_w = torch.where(res.valid, w_all[res.idx], 0.0)          # [N,K]
    nbr = group_points(points, res.idx)                          # [N,K,3]
    diff = (nbr - points[:, None, :]) * torch.sqrt(nbr_w)[..., None]
    scatter = torch.einsum("nki,nkj->nij", diff, diff)
    scatter = scatter / torch.clamp_min(nbr_w.sum(dim=1),
                                        1e-12)[:, None, None]
    w = eigvalsh3(scatter)                      # ascending
    l1, l2, l3 = w[:, 2], w[:, 1], w[:, 0]
    cand = (mask & (res.count >= min_neighbors) & (l2 < gamma_21 * l1)
            & (l3 < gamma_32 * l2) & (l3 > 0))
    keep = radius_nms(points, l3, cand, non_max_radius, k_cap=k_cap)
    if max_keypoints:
        keep = top_k_mask(l3, keep, max_keypoints)
    return ISSResult(keep, l3, w.flip(-1))
