"""Course-skeleton API shims (port of `pctpu/register/template_api.py`,
the names of `Registration/icp_template.py:20-200`).

The port's registration functions under the template's names, so course
material written against the template runs unchanged. Arrays follow the
template's (D, N) column-point layout and come back as numpy. Each shim
runs on CUDA unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.features.matching import match_features
from pctpu_torch.ops.knn import nearest
from pctpu_torch.register.icp import ICPConfig, icp_point_to_point
from pctpu_torch.register.procrustes import weighted_procrustes
from pctpu_torch.register.ransac import (Sampler, generator_sampler,
                                         ransac_registration)


def _cols(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    """(D, N) host array -> [N, D] float32 tensor on `dev`."""
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(x, np.float32).T)).to(dev)


def find_matchings(feature_source: np.ndarray, feature_target: np.ndarray,
                   device: DeviceLike = None) -> np.ndarray:
    """Mutual nearest-descriptor matching: features (C, N) -> matchings
    (2, M) of [src_idx; dst_idx]."""
    dev = resolve_device(device)
    m = match_features(_cols(feature_source, dev), _cols(feature_target, dev),
                       mutual=True)
    valid = m.valid.cpu().numpy()
    return np.stack([m.src_idx.cpu().numpy()[valid],
                     m.dst_idx.cpu().numpy()[valid]])


def procrustes_transformation(A: np.ndarray, B: np.ndarray,
                              device: DeviceLike = None
                              ) -> Tuple[np.ndarray, np.ndarray]:
    """Rigid (R, t) minimising ||R A + t - B||; A, B are (3, N)."""
    dev = resolve_device(device)
    R, t = weighted_procrustes(_cols(A, dev), _cols(B, dev))
    return R.cpu().numpy(), t.cpu().numpy()


def ransac_init(source: np.ndarray, target: np.ndarray,
                matchings: np.ndarray, dist_thresh: float = 1.0,
                num_hypotheses: int = 8192, seed: int = 0,
                sampler: Optional[Sampler] = None,
                device: DeviceLike = None) -> np.ndarray:
    """RANSAC global init from matchings: clouds (3, N), matchings (2, M)
    -> 4x4 transform. Draws come from `sampler` when given, else from a
    `torch.Generator` seeded `seed`."""
    dev = resolve_device(device)
    src = _cols(np.asarray(source).T[matchings[0]].T, dev)
    dst = _cols(np.asarray(target).T[matchings[1]].T, dev)
    if sampler is None:
        sampler = generator_sampler(
            torch.Generator(device=dev).manual_seed(seed))
    res = ransac_registration(src, dst, sampler=sampler,
                              dist_thresh=dist_thresh,
                              num_hypotheses=num_hypotheses)
    return res.T.cpu().numpy()


def find_associations(source: np.ndarray, target: np.ndarray,
                      dist_thresh: float = 5.0,
                      device: DeviceLike = None) -> np.ndarray:
    """Thresholded 1-NN association (K1): clouds (3, N) -> (2, M) pairs
    [src_idx; dst_idx]."""
    dev = resolve_device(device)
    d2, idx = nearest(_cols(source, dev), _cols(target, dev))
    d2, idx = d2.cpu().numpy(), idx.cpu().numpy()
    keep = d2 < dist_thresh ** 2
    return np.stack([np.nonzero(keep)[0], idx[keep]])


def ICP(source: np.ndarray, target: np.ndarray,
        init_transform: Optional[np.ndarray] = None,
        max_iteration: int = 100, dist_thresh: float = 5.0,
        device: DeviceLike = None) -> np.ndarray:
    """Full point-to-point ICP with a convergence test: clouds (3, N) ->
    4x4."""
    dev = resolve_device(device)
    src = PointCloud.from_numpy(np.asarray(source).T, device=dev)
    dst = PointCloud.from_numpy(np.asarray(target).T, device=dev)
    init = (None if init_transform is None
            else torch.as_tensor(init_transform, dtype=torch.float32))
    res = icp_point_to_point(
        src.points, src.mask, dst.points, dst.mask, init_T=init,
        cfg=ICPConfig(max_iters=max_iteration, dist_thresh=dist_thresh),
        device=dev)
    return res.T.cpu().numpy()
