"""Radius non-maximum suppression over per-point saliency scores (port of
`pctpu/features/nms.py`)."""
from __future__ import annotations

import torch

from pctpu_torch.device import f32_square
from pctpu_torch.ops.pairwise import pairwise_sqdist

_NO_INDEX = 2**31 - 1


def radius_nms(points: torch.Tensor, scores: torch.Tensor,
               candidate: torch.Tensor, radius: float, k_cap: int = 64,
               query_chunk: int = 1024) -> torch.Tensor:
    """Keep the candidates whose score is the local maximum among the
    candidates within `radius`; among equal scores the lowest index wins.
    Exact at any density: each query chunk reduces the maximum over the
    whole [chunk, N] distance tile. `k_cap` is accepted for the
    reference's signature and ignored, as there. Returns the keep mask
    [N]."""
    del k_cap
    n = points.shape[0]
    r2 = f32_square(radius)
    neg_inf = torch.tensor(float("-inf"), device=points.device)
    cand_scores = torch.where(candidate, scores, neg_inf)
    ids = torch.arange(n, device=points.device)
    best, best_idx = [], []
    for s in range(0, n, query_chunk):
        d2 = pairwise_sqdist(points[s:s + query_chunk], points, candidate)
        nbr = torch.where(d2 <= r2, cand_scores[None, :], neg_inf)
        top = nbr.amax(dim=1)
        best.append(top)
        best_idx.append(torch.where(nbr >= top[:, None], ids[None, :],
                                    _NO_INDEX).amin(dim=1))
    best, best_idx = torch.cat(best), torch.cat(best_idx)
    return candidate & (scores >= best) & (best_idx >= ids)


def top_k_mask(scores: torch.Tensor, keep: torch.Tensor,
               k: int) -> torch.Tensor:
    """Cap a keep mask at its k highest scores. Equal scores rank the
    lowest index first, as `lax.top_k` does: a stable descending sort cut
    to k (`torch.topk` leaves the order of ties open)."""
    masked = torch.where(keep, scores, float("-inf"))
    idx = torch.sort(masked, descending=True, stable=True).indices[:k]
    out = torch.zeros_like(keep)
    out[idx] = True
    return out & keep
