"""k-NN, radius search and 1-NN (port of `pctpu/ops/knn.py`).

`knn` and `radius_search` are brute force over the |a|^2 + |b|^2 - 2ab
distance tiles (`ops.pairwise`), in query chunks; results carry explicit
(idx, valid) masks. `nearest`, the ICP association primitive, always goes
through kernel K1 (`ops/pallas_nn.py`); on CPU tensors that is K1's plain
version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pctpu_torch.device import f32_square
from pctpu_torch.ops.pairwise import BIG, pairwise_sqdist
from pctpu_torch.ops.pallas_nn import nearest_batch


class NeighborSet(NamedTuple):
    """Static-shape neighbour result.

    idx:   [M, K] int32 neighbour indices into the db
    dist2: [M, K] f32 squared distances (BIG where invalid)
    valid: [M, K] bool
    count: [M] int32 number of true neighbours found (may exceed K for
           radius search: an overflow counter)
    """
    idx: torch.Tensor
    dist2: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def _smallest(d2: torch.Tensor, k: int):
    """The k smallest entries of each row, ascending, the lowest index
    first among equal values (as `lax.top_k` of the negated row): a
    stable sort cut to k. `torch.topk` leaves the order of ties open.
    The k columns are copied out, so a caller that keeps them does not
    keep the whole sorted row block alive."""
    if k > d2.shape[1]:
        raise ValueError(f"k={k} exceeds the db size {d2.shape[1]}")
    d, i = torch.sort(d2, dim=1, stable=True)
    return d[:, :k].clone(), i[:, :k].clone()


def knn(query: torch.Tensor, db: torch.Tensor, k: int,
        db_mask: Optional[torch.Tensor] = None,
        query_chunk: int = 1024) -> NeighborSet:
    """Exact k nearest neighbours: query [M,3], db [N,3] -> NeighborSet
    with K = k, sorted by distance ascending, ties to the lowest index
    (the order of the reference's `lax.top_k`). For k <= 4, k passes of
    argmin + mask; else a stable sort, cut to k."""
    ds, is_ = [], []
    for s in range(0, query.shape[0], query_chunk):
        d2 = pairwise_sqdist(query[s:s + query_chunk], db, db_mask)
        if k <= 4:
            cols = torch.arange(d2.shape[1], device=d2.device)[None, :]
            dk, ik = [], []
            for _ in range(k):
                d, i = torch.min(d2, dim=1)   # first index of the minimum
                dk.append(d)
                ik.append(i)
                d2 = torch.where(cols == i[:, None], BIG, d2)
            ds.append(torch.stack(dk, dim=1))
            is_.append(torch.stack(ik, dim=1))
        else:
            d, i = _smallest(d2, k)
            ds.append(d)
            is_.append(i)
    d2 = torch.cat(ds)
    idx = torch.cat(is_).int()
    valid = d2 < BIG
    return NeighborSet(idx, d2, valid, valid.sum(dim=1, dtype=torch.int32))


def radius_search(query: torch.Tensor, db: torch.Tensor, radius: float,
                  k_cap: int, db_mask: Optional[torch.Tensor] = None,
                  query_chunk: int = 1024) -> NeighborSet:
    """All neighbours within `radius`, capped at the closest k_cap per
    query (ties to the lowest index), plus the uncapped count as overflow
    telemetry."""
    r2 = f32_square(radius)
    ds, is_, cs = [], [], []
    for s in range(0, query.shape[0], query_chunk):
        d2 = pairwise_sqdist(query[s:s + query_chunk], db, db_mask)
        within = d2 <= r2
        cs.append(within.sum(dim=1, dtype=torch.int32))
        d, i = _smallest(torch.where(within, d2, BIG), k_cap)
        ds.append(d)
        is_.append(i)
    d2 = torch.cat(ds)
    return NeighborSet(torch.cat(is_).int(), d2, d2 < BIG, torch.cat(cs))


def nearest(query: torch.Tensor, db: torch.Tensor,
            db_mask: Optional[torch.Tensor] = None,
            query_chunk: Optional[int] = None):
    """1-NN through K1: query [...,M,3], db [...,N,3], db_mask [...,N] ->
    (dist2 [...,M], idx [...,M] int32), with one leading batch axis or
    none. On the CPU `query_chunk` queries go through K1's plain version
    per pass (all at once when None), which bounds its memory; on the card
    K1 takes every query in one launch, as the reference's Pallas path
    does."""
    if query.dim() == 2:
        d2, idx = nearest(query[None], db[None],
                          None if db_mask is None else db_mask[None],
                          query_chunk)
        return d2[0], idx[0]
    m = query.shape[1]
    step = (m if query_chunk is None or query.device.type != "cpu"
            else max(1, query_chunk))
    if step >= m:
        return nearest_batch(query, db, db_mask)
    parts = [nearest_batch(query[:, s:s + step], db, db_mask)
             for s in range(0, m, step)]
    return (torch.cat([p[0] for p in parts], dim=1),
            torch.cat([p[1] for p in parts], dim=1))
