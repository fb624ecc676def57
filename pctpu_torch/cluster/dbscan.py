"""DBSCAN as bounded-iteration label propagation (port of
`pctpu/cluster/dbscan.py`).

The radius neighbour graph is computed once (`ops.knn.radius_search`,
ties to the lowest index), core points are those with |N_eps| >= min_pts
(self included), and the connected components of the core-core graph come
from iterated min-label propagation with pointer jumping: a host loop of
at most `max_rounds` rounds with one sync a round (the reference's
`lax.while_loop`). Border points take their smallest core neighbour's
label, the rest are noise (-1). Labels are compacted to 0..k-1 in root
order, as the reference does, so the ids equal the reference's, not just
the partition.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.ops.knn import radius_search

INT_BIG = 2**31 - 1


def dbscan(data: torch.Tensor, eps: float, min_pts: int,
           mask: Optional[torch.Tensor] = None, k_cap: int = 64,
           max_rounds: int = 64) -> torch.Tensor:
    """data [N,D<=3] -> labels [N] int32 (-1 = noise).

    Core detection is exact (the count is uncapped), but labels travel
    over each point's k_cap NEAREST neighbours: a k-NN subgraph of the
    eps-graph, which adversarially dense balls can disconnect. Use
    `dbscan_exact` for the escalating, truncation-proof wrapper."""
    n = data.shape[0]
    dev = data.device
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    res = radius_search(data, data, eps, k_cap, db_mask=mask)
    idx = res.idx.long()
    core = (res.count >= min_pts) & mask
    nbr_core = core[idx] & res.valid                    # [N,K] core neighbours
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    big = torch.full((n,), INT_BIG, dtype=torch.int32, device=dev)
    big_k = torch.full(idx.shape, INT_BIG, dtype=torch.int32, device=dev)

    lab = torch.where(core, iota, big)
    for _ in range(max_rounds):
        m = torch.where(nbr_core, lab[idx], big_k).amin(dim=1)
        new = torch.where(core, torch.minimum(lab, m), lab)
        # pointer jumping: label -> label of that label's root (2 hops)
        unset = new == INT_BIG
        hop = torch.where(unset, new, new[torch.where(unset, 0, new).long()])
        hop = torch.where(hop == INT_BIG, new, hop)
        changed = bool((hop != lab).any())
        lab = hop
        if not changed:
            break

    # border points: the smallest label among their core neighbours
    border = torch.where(nbr_core, lab[idx], big_k).amin(dim=1)
    lab = torch.where(core, lab, border)
    lab = torch.where(mask, lab, big)

    # compact root ids to 0..k-1 in root order
    new_id = torch.cumsum((lab == iota).int(), dim=0, dtype=torch.int32) - 1
    unset = lab == INT_BIG
    return torch.where(unset, -1, new_id[torch.where(unset, 0, lab).long()]
                       ).int()


def _max_radius_count(data: torch.Tensor, eps: float,
                      mask: Optional[torch.Tensor], k_cap: int) -> int:
    if mask is None:
        mask = torch.ones((data.shape[0],), dtype=torch.bool,
                          device=data.device)
    res = radius_search(data, data, eps, k_cap, db_mask=mask)
    return int(torch.where(mask, res.count, 0).max())


def dbscan_exact(data: torch.Tensor, eps: float, min_pts: int,
                 mask: Optional[torch.Tensor] = None, k_cap: int = 64,
                 max_rounds: int = 64) -> torch.Tensor:
    """Escalating DBSCAN: doubles k_cap until no eps-ball is truncated
    (count <= k_cap) or k_cap covers the whole cloud, then runs `dbscan`."""
    n = data.shape[0]
    while True:
        overflow = _max_radius_count(data, eps, mask, k_cap)
        if overflow <= k_cap or k_cap >= n:
            return dbscan(data, eps, min_pts, mask=mask, k_cap=min(k_cap, n),
                          max_rounds=max_rounds)
        k_cap = min(max(2 * k_cap, overflow), n)


class DBSCAN:
    """The reference's interface (`Cluster_dbscan/dbscan.py:4-39`) on the
    escalating exact path, on `device` (CUDA unless "cpu" is asked for)."""

    def __init__(self, radius: float = 0.5, Min_Pts: int = 10,
                 k_cap: int = 64, device: DeviceLike = None):
        self.radius = radius
        self.Min_Pts = Min_Pts
        self.k_cap = k_cap
        self.device = device
        self.labels_ = None

    def fit(self, data):
        dev = resolve_device(self.device)
        x = torch.as_tensor(np.asarray(data, np.float32), device=dev)
        self.labels_ = dbscan_exact(x, self.radius, self.Min_Pts,
                                    k_cap=self.k_cap).cpu().numpy()
        return self

    def predict(self):
        return self.labels_
