"""Grid-hash (voxel-bucket) neighbour search, O(27 cap) per query (port of
`pctpu/ops/grid_hash.py`).

The points are bucketed by an int32 key packed from their voxel cell,
(cx << 20) | (cy << 10) | cz, and sorted by it; a query gathers its
candidates from the 27 cells around its own, at most `cap_per_cell` from
each. Plain PyTorch on the points' device (searchsorted, gathers, a stable
sort): the reference computes all of this outside any Pallas kernel.

Results equal the reference's, indices included:
- the cell is `floor((p - origin) / cell_size)` by true division: the
  cell size stays a 0-dim tensor on the points' device, since CUDA divides
  by a Python float (or a 0-dim CPU tensor) as a product with its
  reciprocal, which rounds twice and moves points on a cell face;
- the sort by key is stable, as `jnp.argsort`;
- the candidates lie in the stencil's `meshgrid(indexing="ij")` order and
  the selection keeps the lowest candidate column among equal distances
  (`lax.top_k`, `argmin`), the `BIG` slots included.

Exact for radius searches with radius <= cell_size, and for kNN whenever
the k-th neighbour lies within cell_size; candidates beyond the stencil
are not seen. Cells clamp to a 1024^3 lattice: choose cell_size >=
extent / 1024.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pctpu_torch.device import f32_square
from pctpu_torch.ops.knn import NeighborSet, _smallest

BIG = 1e30
MAX_CELLS = 1024  # per axis; keys pack into (cx<<20)|(cy<<10)|cz
_INVALID_KEY = 1 << 30
_OUTSIDE_KEY = (1 << 30) - 1
# float32 bounds of int32 (2^31 - 128 is the largest float32 below 2^31):
# out-of-range cells saturate, as XLA's float -> int32 conversion does
_I32_LO, _I32_HI = -2.0 ** 31, 2.0 ** 31 - 128


class HashGrid(NamedTuple):
    points: torch.Tensor      # [N,3] sorted by cell key
    mask: torch.Tensor        # [N] sorted validity
    order: torch.Tensor       # [N] int32 original index of each sorted slot
    keys: torch.Tensor        # [N] int32 sorted cell keys (invalid -> 2^30)
    origin: torch.Tensor      # [3]
    cell_size: torch.Tensor   # 0-dim f32, on the points' device


def _cells(points: torch.Tensor, origin: torch.Tensor,
           cell_size: torch.Tensor) -> torch.Tensor:
    c = torch.floor((points - origin) / cell_size)
    return c.clamp(_I32_LO, _I32_HI).int()


def _cell_key(cells: torch.Tensor) -> torch.Tensor:
    c = cells.clamp(0, MAX_CELLS - 1)
    return (c[..., 0] << 20) | (c[..., 1] << 10) | c[..., 2]


def build_grid(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
               cell_size=1.0) -> HashGrid:
    """points [N,3] (mask [N]) -> HashGrid sorted by cell key; the lattice
    starts at the valid points' minimum."""
    n = points.shape[0]
    dev = points.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    cs = torch.as_tensor(cell_size, dtype=torch.float32).to(dev)
    origin = torch.where(mask[:, None], points, BIG).amin(dim=0)
    keys = torch.where(mask, _cell_key(_cells(points, origin, cs)),
                       _INVALID_KEY)
    order = torch.argsort(keys, stable=True)
    return HashGrid(points[order], mask[order], order.int(), keys[order],
                    origin, cs)


def _stencil_keys(qcells: torch.Tensor) -> torch.Tensor:
    """[M,3] query cells -> [M,27] neighbour-cell keys."""
    r = torch.arange(-1, 2, dtype=torch.int32, device=qcells.device)
    offs = torch.stack(torch.meshgrid(r, r, r, indexing="ij"),
                       dim=-1).reshape(27, 3)
    nbr = qcells[:, None, :] + offs[None, :, :]
    in_lattice = ((nbr >= 0) & (nbr < MAX_CELLS)).all(dim=-1)
    return torch.where(in_lattice, _cell_key(nbr), _OUTSIDE_KEY)


def _gather_candidates(grid: HashGrid, query: torch.Tensor,
                       cap_per_cell: int = 32, query_chunk: int = 1024):
    """Per query: candidate slots from the 27-cell stencil.

    Returns (cand_sorted_idx [M, 27*cap] int32, cand_valid [M, 27*cap],
    overflow [M] int32: candidates dropped by the per-cell cap).
    `query_chunk` is accepted for the reference's signature and unused,
    as there."""
    del query_chunk
    m = query.shape[0]
    qcells = _cells(query, grid.origin, grid.cell_size)
    nkeys = _stencil_keys(qcells)                          # [M,27]
    starts = torch.searchsorted(grid.keys, nkeys, side="left",
                                out_int32=True)
    ends = torch.searchsorted(grid.keys, nkeys, side="right",
                              out_int32=True)
    lens = ends - starts
    overflow = torch.clamp_min(lens - cap_per_cell, 0).sum(
        dim=1, dtype=torch.int32)
    offs = torch.arange(cap_per_cell, dtype=torch.int32,
                        device=query.device)
    idx = starts[:, :, None] + offs                        # [M,27,cap]
    valid = offs < lens[:, :, None]
    n = grid.points.shape[0]
    idx = idx.clamp(0, n - 1)
    return idx.reshape(m, -1), valid.reshape(m, -1), overflow


def _chunks(query: torch.Tensor, query_chunk: int):
    """The queries zero-padded to a multiple of `query_chunk`, in chunks."""
    pad = (-query.shape[0]) % query_chunk
    qp = torch.cat([query, query.new_zeros((pad, 3))])
    return qp.split(query_chunk)


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c rounded once, on any device: the product is exact
    in float64, the sum's error comes from TwoSum, and rounding the sum
    to odd before float32 avoids the double rounding."""
    p, c = a.double() * b.double(), c.double()
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf"))
    s = torch.where(even & (err != 0), torch.nextafter(s, toward), s)
    return s.float()


def _candidate_d2(grid: HashGrid, qc: torch.Tensor, cap_per_cell: int):
    """(sorted slots [q,C], d2 [q,C], valid [q,C], overflow [q]).

    d2 rounds as XLA's CPU backend computes the reference's
    `sum((cand - q) ** 2, -1)`: x*x, then a fused multiply-add of y and
    then of z (a chain of FMAs, not three rounded squares and two adds
    as K1 rounds)."""
    idx, valid, overflow = _gather_candidates(grid, qc, cap_per_cell)
    diff = grid.points[idx] - qc[:, None, :]              # [q,C,3]
    dx, dy, dz = diff.unbind(-1)
    d2 = _fma(dz, dz, _fma(dy, dy, dx * dx))
    return idx, d2, valid & grid.mask[idx], overflow


def grid_knn(grid: HashGrid, query: torch.Tensor, k: int,
             cap_per_cell: int = 32, query_chunk: int = 1024) -> NeighborSet:
    """kNN among the 27-cell candidates. Indices refer to the ORIGINAL
    point order used to build the grid."""
    m = query.shape[0]
    ds, ids = [], []
    for qc in _chunks(query, query_chunk):
        idx, d2, ok, _ = _candidate_d2(grid, qc, cap_per_cell)
        d, sel = _smallest(torch.where(ok, d2, BIG), k)
        ds.append(d)
        ids.append(grid.order[torch.gather(idx, 1, sel)])
    d2 = torch.cat(ds)[:m]
    valid = d2 < BIG
    return NeighborSet(torch.cat(ids)[:m], d2, valid,
                       valid.sum(dim=1, dtype=torch.int32))


def grid_radius(grid: HashGrid, query: torch.Tensor, radius: float,
                k_cap: int = 64, cap_per_cell: int = 32,
                query_chunk: int = 1024) -> NeighborSet:
    """Radius search (exact when radius <= cell_size and caps suffice)."""
    r2 = f32_square(radius)
    m = query.shape[0]
    ds, ids, cs = [], [], []
    for qc in _chunks(query, query_chunk):
        idx, d2, ok, _ = _candidate_d2(grid, qc, cap_per_cell)
        ok = ok & (d2 <= r2)
        cs.append(ok.sum(dim=1, dtype=torch.int32))
        d, sel = _smallest(torch.where(ok, d2, BIG), k_cap)
        ds.append(d)
        ids.append(grid.order[torch.gather(idx, 1, sel)])
    d2 = torch.cat(ds)[:m]
    return NeighborSet(torch.cat(ids)[:m], d2, d2 < BIG, torch.cat(cs)[:m])


def grid_nearest(grid: HashGrid, query: torch.Tensor,
                 cap_per_cell: int = 32, query_chunk: int = 2048):
    """1-NN among the 27-cell candidates: (d2 [M], idx [M], found [M]).

    Queries farther than cell_size from every point come back found=False
    (d2=BIG): in ICP those are exactly the associations the distance
    threshold would reject anyway."""
    m = query.shape[0]
    ds, ids = [], []
    for qc in _chunks(query, query_chunk):
        idx, d2, ok, _ = _candidate_d2(grid, qc, cap_per_cell)
        d2 = torch.where(ok, d2, BIG)
        best = torch.argmin(d2, dim=1, keepdim=True)
        ds.append(torch.gather(d2, 1, best)[:, 0])
        ids.append(grid.order[torch.gather(idx, 1, best)[:, 0]])
    d2 = torch.cat(ds)[:m]
    return d2, torch.cat(ids)[:m], d2 < BIG
