"""Tiled pairwise squared distances and the plain brute-force 1-NN
(port of `pctpu/ops/pairwise.py`)."""
from __future__ import annotations

from typing import Optional

import torch

BIG = 1e30


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor,
                    b_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[..., M,3] x [..., N,3] -> [..., M,N] squared distances (f32) by the
    |a|^2 + |b|^2 - 2ab expansion; masked db points get BIG."""
    a = a.float()
    b = b.float()
    a2 = torch.sum(a * a, dim=-1, keepdim=True)                # [...,M,1]
    b2 = torch.sum(b * b, dim=-1)[..., None, :]                # [...,1,N]
    cross = torch.matmul(a, b.transpose(-1, -2))
    d2 = torch.clamp_min(a2 + b2 - 2.0 * cross, 0.0)
    if b_mask is not None:
        d2 = torch.where(b_mask[..., None, :], d2,
                         torch.full_like(d2, BIG))
    return d2


def chunked_min_argmin(query: torch.Tensor, db: torch.Tensor,
                       db_mask: Optional[torch.Tensor] = None,
                       query_chunk: int = 2048):
    """1-NN of each query, O(M*N) in query chunks: (dist2 [...,M],
    idx [...,M] int32). Peak memory is query_chunk x N per batch."""
    d2s, idxs = [], []
    for s in range(0, query.shape[-2], query_chunk):
        d2 = pairwise_sqdist(query[..., s:s + query_chunk, :], db, db_mask)
        mn, am = torch.min(d2, dim=-1)
        d2s.append(mn)
        idxs.append(am.int())
    return torch.cat(d2s, dim=-1), torch.cat(idxs, dim=-1)
