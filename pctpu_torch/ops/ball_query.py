"""Ball query with the reference's exact padding semantics (port of
`pctpu/ops/ball_query.py`).

For each centre, the first `nsample` point indices (in index order) with
d^2 < radius^2; unfilled slots hold the FIRST hit's index; a centre with
no hit gets idx 0 and valid all-False. Distances come from
`pairwise_sqdist` (the |a|^2 + |b|^2 - 2ab expansion); the first hits are
the `nsample` smallest column indices among hits, one `topk`. With
nsample > N (the KITTI preset: 128 of 64 points) the slots past N are
padding, as in kernel 12 and its plain version; the reference's
`lax.top_k` raises there.
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.device import f32_square
from pctpu_torch.ops.pairwise import pairwise_sqdist

NO_HIT = 2**30


def ball_query(centers: torch.Tensor, points: torch.Tensor, radius: float,
               nsample: int, points_mask: Optional[torch.Tensor] = None,
               query_chunk: int = 512):
    """centers [..., M, 3], points [..., N, 3] (the same leading dims) ->
    (idx [..., M, nsample] int32, valid [..., M, nsample] bool).

    `valid` is True for the first min(count, nsample) slots; padded slots
    repeat the first hit. `query_chunk` bounds the [..., chunk, N]
    distance block."""
    r2 = f32_square(radius)
    n = points.shape[-2]
    cols = torch.arange(n, device=points.device)
    slot = torch.arange(nsample, device=points.device)
    idxs, valids = [], []
    for s in range(0, centers.shape[-2], query_chunk):
        d2 = pairwise_sqdist(centers[..., s:s + query_chunk, :], points,
                             points_mask)
        within = d2 < r2
        masked = torch.where(within, cols, NO_HIT)
        if n < nsample:     # as kernel 12: the slots past N are padding
            masked = torch.nn.functional.pad(masked, (0, nsample - n),
                                             value=NO_HIT)
        out = torch.topk(masked, nsample, dim=-1, largest=False).values
        cnt = within.sum(dim=-1)
        first_hit = torch.where(cnt > 0, out[..., 0], 0)
        filled = slot < torch.clamp(cnt, max=nsample)[..., None]
        idxs.append(torch.where(filled, out, first_hit[..., None]).int())
        valids.append(filled)
    return torch.cat(idxs, dim=-2), torch.cat(valids, dim=-2)
