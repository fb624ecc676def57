"""Full-covariance Gaussian-mixture EM (port of `pctpu/cluster/gmm.py`):
log-space responsibilities through Cholesky factors and logsumexp, a
1e-6 covariance jitter, initialisation from the port's k-means (the same
injectable first centre), and the reference's stop rule: iterate while
n_iter < max_iter and prev_nll - nll >= tol, with prev_nll = inf at the
start. The loop is on the host, one sync an iteration.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pctpu_torch.cluster.kmeans import FirstDraw, kmeans
from pctpu_torch.device import DeviceLike, resolve_device


class GMMState(NamedTuple):
    means: torch.Tensor    # [k, D]
    covs: torch.Tensor     # [k, D, D]
    weights: torch.Tensor  # [k]
    nll: torch.Tensor      # scalar
    n_iter: int


def _log_gaussian(data, means, covs, jitter):
    """log N(data | mean_j, cov_j) for every component: [k,N]."""
    d = data.shape[1]
    eye = torch.eye(d, dtype=covs.dtype, device=covs.device)
    L = torch.linalg.cholesky(covs + jitter * eye)             # [k,D,D]
    diff = data[None, :, :] - means[:, None, :]                # [k,N,D]
    y = torch.linalg.solve_triangular(L, diff.transpose(1, 2), upper=False)
    maha = torch.sum(y * y, dim=1)                             # [k,N]
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=1, dim2=2)),
                             dim=1)
    return -0.5 * (maha + logdet[:, None] + d * math.log(2.0 * math.pi))


def _e_step(data, means, covs, weights, jitter):
    logp = _log_gaussian(data, means, covs, jitter)
    joint = logp + torch.log(torch.clamp_min(weights, 1e-30))[:, None]
    lse = torch.logsumexp(joint, dim=0)                        # [N]
    return torch.exp(joint - lse[None, :]), -torch.sum(lse)


def _m_step(data, gamma):
    n = data.shape[0]
    nk = torch.sum(gamma, dim=1)                               # [k]
    nk_safe = torch.clamp_min(nk, 1e-10)
    means = (gamma @ data) / nk_safe[:, None]
    diff = data[None, :, :] - means[:, None, :]                # [k,N,D]
    covs = torch.einsum("kni,knj->kij", diff * gamma[:, :, None],
                        diff) / nk_safe[:, None, None]
    return means, covs, nk / n


def gmm_fit(data: torch.Tensor, k: int,
            generator: Optional[torch.Generator] = None,
            max_iter: int = 50, tol: float = 1e-3, jitter: float = 1e-6,
            first: Optional[FirstDraw] = None) -> GMMState:
    """EM fit: data [N,D] -> GMMState. Means start at the k-means centres
    (`generator` / `first` as in `kmeans`), covariances at the identity,
    weights uniform."""
    n, d = data.shape
    data = data.float()
    means, _, _ = kmeans(data, k, generator=generator, first=first)
    covs = torch.eye(d, device=data.device).expand(k, d, d).clone()
    weights = torch.full((k,), 1.0 / k, device=data.device)
    _, nll = _e_step(data, means, covs, weights, jitter)
    prev_nll = torch.tensor(float("inf"), device=data.device)
    it = 0
    while it < max_iter and bool(prev_nll - nll >= tol):
        gamma, _ = _e_step(data, means, covs, weights, jitter)
        means, covs, weights = _m_step(data, gamma)
        prev_nll = nll
        _, nll = _e_step(data, means, covs, weights, jitter)
        it += 1
    return GMMState(means, covs, weights, nll, it)


def gmm_predict(state: GMMState, data: torch.Tensor,
                jitter: float = 1e-6) -> torch.Tensor:
    gamma, _ = _e_step(data.float(), state.means, state.covs, state.weights,
                       jitter)
    return torch.argmax(gamma, dim=0)


class GMM:
    """The reference's interface (`GMM.py:13-70`) on `device` (CUDA unless
    "cpu" is asked for); k-means' first centre from a CPU generator seeded
    with `seed`."""

    def __init__(self, n_clusters: int, max_iter: int = 50, tol: float = 1e-3,
                 seed: int = 0, device: DeviceLike = None):
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.tol = tol
        self.seed = seed
        self.device = device
        self.state: Optional[GMMState] = None

    def fit(self, data):
        dev = resolve_device(self.device)
        self.state = gmm_fit(
            torch.as_tensor(np.asarray(data, np.float32), device=dev),
            self.n_clusters, generator=torch.Generator().manual_seed(self.seed),
            max_iter=self.max_iter, tol=self.tol)
        return self

    def predict(self, data):
        dev = self.state.means.device
        return gmm_predict(self.state, torch.as_tensor(
            np.asarray(data, np.float32), device=dev)).cpu().numpy()
