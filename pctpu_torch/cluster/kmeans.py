"""K-Means (port of `pctpu/cluster/kmeans.py`): farthest-first seeding,
Lloyd iterations, convergence on centre movement < tol.

The assignment is an [N,k] distance matrix (a plain float32 matmul; TF32
is off) and its first-index argmin. The centre sums are kernel 14
(`ops/pallas_gather.py:scatter_add_rows_pallas`): each centre receives its
rows one at a time in ascending index onto zeros, as XLA's sequential
scatter-add does, and a run on the card repeats bit for bit (an atomic
`index_add_` does not). The loop is on the host, one sync an iteration.

Draws: the reference's first centre is `jax.random.categorical` over the
valid points. Here it is injectable -- `first(mask [N] bool) -> index` --
and by default a uniform draw among the valid points from a CPU
`torch.Generator` (seeded 0), so the card and the CPU seed alike.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.ops.pallas_gather import scatter_add_rows_pallas

FirstDraw = Callable[[torch.Tensor], object]
BIG = 1e30


def generator_first(generator: Optional[torch.Generator] = None
                    ) -> FirstDraw:
    """The first centre drawn uniformly among the valid points from a CPU
    `generator` (default: seeded 0)."""
    gen = (generator if generator is not None
           else torch.Generator().manual_seed(0))

    def first(mask: torch.Tensor):
        return torch.multinomial(mask.cpu().float(), 1, generator=gen)[0]
    return first


def _assign(data: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    d2 = (torch.sum(data * data, dim=1, keepdim=True)
          + torch.sum(centers * centers, dim=1)[None, :]
          - 2.0 * torch.matmul(data, centers.T))
    return torch.argmin(d2, dim=1).int()


def kmeans(data: torch.Tensor, k: int,
           generator: Optional[torch.Generator] = None,
           max_iter: int = 100, tol: float = 1e-4,
           mask: Optional[torch.Tensor] = None,
           first: Optional[FirstDraw] = None):
    """data [N,D] -> (centers [k,D], labels [N] int32, n_iter int).
    `first` draws the first centre (default `generator_first(generator)`);
    the rest are farthest-first (the first index of the largest minimum
    distance)."""
    n, d = data.shape
    dev = data.device
    data = data.float()
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    if first is None:
        first = generator_first(generator)
    maskf = mask.float()

    p0 = int(first(mask))
    centers = torch.zeros((k, d), dtype=torch.float32, device=dev)
    centers[0] = data[p0]
    mind = torch.full((n,), BIG, dtype=torch.float32, device=dev)
    for i in range(1, k):
        mind = torch.minimum(mind, torch.sum((data - centers[i - 1]) ** 2,
                                             dim=-1))
        centers[i] = data[torch.argmax(torch.where(mask, mind, -BIG))]

    # one kernel-14 launch an iteration sums the masked rows and counts
    rows = torch.cat([data * maskf[:, None], maskf[:, None]], dim=1)[None]
    it = 0
    while it < max_iter:
        labels = _assign(data, centers)
        acc = scatter_add_rows_pallas(rows, labels[None], k)[0]
        sums, cnts = acc[:, :d], acc[:, d]
        new = torch.where(cnts[:, None] > 0,
                          sums / torch.clamp_min(cnts, 1.0)[:, None], centers)
        shift = torch.amax(torch.sum((new - centers) ** 2, dim=1))
        centers = new
        it += 1
        if not bool(shift > tol * tol):
            break
    return centers, _assign(data, centers), it


class K_Means:
    """The reference's interface (`compare_cluster.py:105`) on `device`
    (CUDA unless "cpu" is asked for); the first centre from a CPU
    generator seeded with `seed`."""

    def __init__(self, n_clusters: int, max_iter: int = 100,
                 tol: float = 1e-4, seed: int = 0, device: DeviceLike = None):
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.device = device
        self.cluster_centers_ = None
        self.labels_ = None

    def fit(self, X):
        dev = resolve_device(self.device)
        centers, labels, _ = kmeans(
            torch.as_tensor(np.asarray(X, np.float32), device=dev),
            self.n_clusters,
            generator=torch.Generator().manual_seed(self.seed),
            max_iter=self.max_iter, tol=self.tol)
        self.cluster_centers_ = centers.cpu().numpy()
        self.labels_ = labels.cpu().numpy()
        return self

    def predict(self, X):
        X = np.asarray(X, np.float32)
        d2 = ((X[:, None, :] - self.cluster_centers_[None]) ** 2).sum(-1)
        return d2.argmin(1)
