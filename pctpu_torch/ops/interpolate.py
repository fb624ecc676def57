"""Three-NN inverse-distance feature interpolation, the PointNet++
feature-propagation path (port of `pctpu/ops/interpolate.py`).

`three_nn` is `knn(query, db, 3)` (`ops/knn.py`) with leading batch dims:
three passes of argmin + mask over the |a|^2 + |b|^2 - 2ab distance tiles,
in query chunks, ties to the lowest index. The weights are the
reference's 1/(sqrt(d2) + 1e-8), normalised.

The distances round as the reference's compiled ones do. Every coarse
point is an FPS pick of the fine cloud, so each one meets itself, at a
distance that is only the expansion's rounding residue (0 to ~5e-7 on a
unit cloud); 1/(sqrt(d2) + 1e-8) turns that residue into the share the
two other neighbours get, a few percent of the interpolated feature. XLA
computes |a|^2 inside its compiled `knn` as fma(z, z, fma(y, y, x * x)),
so `_sq_norm` rounds each step once to float32 as well (in float64, then
cast); the cross term is the matrix product on both sides.

`three_interpolate` is a gather (`group_points`, `torch.gather`) and a
weighted sum; its gradient flows through `torch.gather`'s backward, as
the reference's does through XLA's gather. No TPU kernel sits on this
path, so none is written.
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.pairwise import BIG


def _sq_norm(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [...]: fma(z, z, fma(y, y, x * x)), each fma rounded
    once to float32 (computed in float64, where the product is exact)."""
    p = (x[..., 0] * x[..., 0]).double()
    for c in (1, 2):
        xc = x[..., c].double()
        p = (xc * xc + p).float().double()
    return p.float()


def _sqdist(a: torch.Tensor, b: torch.Tensor,
            b_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """[..., M, 3] x [..., N, 3] -> [..., M, N]: max((|a|^2 + |b|^2) -
    2ab, 0) with `_sq_norm`'s norms; masked db points get BIG."""
    cross = torch.matmul(a, b.transpose(-1, -2))
    d2 = torch.clamp_min(_sq_norm(a)[..., :, None] + _sq_norm(b)[..., None, :]
                         - 2.0 * cross, 0.0)
    if b_mask is not None:
        d2 = torch.where(b_mask[..., None, :], d2, torch.full_like(d2, BIG))
    return d2


def three_nn(query: torch.Tensor, db: torch.Tensor,
             db_mask: Optional[torch.Tensor] = None,
             query_chunk: int = 1024):
    """query [..., M, 3], db [..., N, 3] (the same leading dims) ->
    (dist2 [..., M, 3], idx [..., M, 3] int32), ascending, the lowest
    index first among equal distances."""
    query, db = query.float(), db.float()
    ds, is_ = [], []
    for s in range(0, query.shape[-2], query_chunk):
        d2 = _sqdist(query[..., s:s + query_chunk, :], db, db_mask)
        cols = torch.arange(d2.shape[-1], device=d2.device)
        dk, ik = [], []
        for _ in range(3):
            d, i = torch.min(d2, dim=-1)      # first index of the minimum
            dk.append(d)
            ik.append(i)
            d2 = torch.where(cols == i[..., None], BIG, d2)
        ds.append(torch.stack(dk, dim=-1))
        is_.append(torch.stack(ik, dim=-1))
    return torch.cat(ds, dim=-2), torch.cat(is_, dim=-2).int()


def interpolation_weights(dist2: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """[..., 3] squared distances -> normalised inverse-L2-distance weights
    1/(sqrt(d2) + eps) / sum."""
    recip = 1.0 / (torch.sqrt(dist2) + eps)
    return recip / torch.sum(recip, dim=-1, keepdim=True)


def three_interpolate(features: torch.Tensor, idx: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """features [..., N, C], idx [..., M, 3], weights [..., M, 3] ->
    [..., M, C]."""
    gathered = group_points(features, idx)              # [..., M, 3, C]
    return torch.sum(gathered * weights[..., None], dim=-2)
