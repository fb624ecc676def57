"""Spectral clustering (port of `pctpu/cluster/spectral.py`): kNN affinity
graph -> Laplacian -> bottom eigenvectors -> k-means.

W[i,j] = W[j,i] = 1/dist over the kNN graph (self excluded), built by one
`scatter_reduce(..., "amax")` (the reference's `W.at[...].max`) and
symmetrised; the symmetric normalised Laplacian I - D^-1/2 W D^-1/2 (or
D - W) goes through `torch.linalg.eigh` (cuSOLVER on the card, LAPACK on
the CPU). Eigenvectors of a repeated eigenvalue are arbitrary, so only
partitions and subspaces are comparable across libraries and devices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pctpu_torch.cluster.kmeans import FirstDraw, kmeans
from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.ops.knn import knn


def spectral_embedding(data: torch.Tensor, n_clusters: int, nnk: int = 7,
                       normalized: bool = True) -> torch.Tensor:
    """data [N,D] -> embedding [N, n_clusters] (the bottom eigenvectors)."""
    n = data.shape[0]
    dev = data.device
    res = knn(data, data, nnk + 1)                  # includes self
    rows = torch.arange(n, device=dev)[:, None].expand(res.idx.shape)
    w = 1.0 / torch.sqrt(torch.clamp_min(res.dist2, 1e-20))
    w = torch.where(res.idx.long() != rows, w, 0.0)
    W = torch.zeros(n * n, dtype=torch.float32, device=dev).scatter_reduce(
        0, (rows * n + res.idx.long()).reshape(-1), w.reshape(-1), "amax")
    W = W.reshape(n, n)
    W = torch.maximum(W, W.T)                       # symmetrise
    deg = torch.sum(W, dim=1)
    if normalized:
        dinv = torch.rsqrt(torch.clamp_min(deg, 1e-12))
        L = (torch.eye(n, device=dev)
             - (dinv[:, None] * W) * dinv[None, :])
    else:
        L = torch.diag(deg) - W
    _, vecs = torch.linalg.eigh(L)                  # ascending
    return vecs[:, :n_clusters]


def spectral_clustering(data: torch.Tensor, n_clusters: int, nnk: int = 7,
                        normalized: bool = True,
                        generator: Optional[torch.Generator] = None,
                        first: Optional[FirstDraw] = None) -> torch.Tensor:
    emb = spectral_embedding(data, n_clusters, nnk, normalized)
    _, labels, _ = kmeans(emb, n_clusters, generator=generator, first=first)
    return labels


class spetral_clustering:  # sic: the reference's class name, kept
    """The reference's interface (`spectral_clustering.py:7-46`) on
    `device` (CUDA unless "cpu" is asked for)."""

    def __init__(self, n_clusters: int = 2, nnk: int = 7,
                 normalized: bool = True, seed: int = 0,
                 device: DeviceLike = None):
        self.n_clusters = n_clusters
        self.nnk_ = nnk
        self.normalized_ = normalized
        self.seed = seed
        self.device = device
        self.labels_ = np.empty(0)

    def fit(self, data):
        dev = resolve_device(self.device)
        self.labels_ = spectral_clustering(
            torch.as_tensor(np.asarray(data, np.float32), device=dev),
            self.n_clusters, self.nnk_, self.normalized_,
            generator=torch.Generator().manual_seed(self.seed)).cpu().numpy()
        return self

    def predict(self):
        return self.labels_
