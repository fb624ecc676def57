"""Point-cloud container: fixed-shape, masked clouds (port of
`pctpu/core/cloud.py`). Every cloud is padded to a tile-friendly point
count with an explicit validity mask; padded entries repeat a real point
so distance computations stay finite."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pctpu_torch.device import DeviceLike, resolve_device


def round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """A (possibly batched) padded point cloud.

    points:   [..., N, 3] float32; padded entries are finite.
    mask:     [..., N] bool; True = real point.
    features: optional [..., N, C] float32 per-point features.
    """
    points: torch.Tensor
    mask: torch.Tensor
    features: Optional[torch.Tensor] = None

    @property
    def capacity(self) -> int:
        return self.points.shape[-2]

    @property
    def batch_shape(self):
        return tuple(self.points.shape[:-2])

    def count(self) -> torch.Tensor:
        """Number of valid points, [...] int32."""
        return self.mask.sum(dim=-1, dtype=torch.int32)

    def to(self, device) -> "PointCloud":
        return PointCloud(
            self.points.to(device), self.mask.to(device),
            None if self.features is None else self.features.to(device))

    @staticmethod
    def from_numpy(points: np.ndarray,
                   features: Optional[np.ndarray] = None,
                   capacity: Optional[int] = None,
                   tile: int = 128,
                   device: DeviceLike = None) -> "PointCloud":
        """Build a padded cloud from an (N,3) host array; padding repeats
        the first point and the mask excludes it."""
        dev = resolve_device(device)
        points = np.asarray(points, dtype=np.float32)
        if points.ndim != 2 or points.shape[1] != 3:
            raise ValueError(f"expected (N,3) points, got {points.shape}")
        n = points.shape[0]
        cap = capacity if capacity is not None else round_up(max(n, 1), tile)
        if cap < n:
            raise ValueError(f"capacity {cap} < N {n}")
        pad = cap - n
        fill = points[:1] if n > 0 else np.zeros((1, 3), np.float32)
        pts = np.concatenate([points, np.repeat(fill, pad, axis=0)], axis=0)
        mask = np.zeros((cap,), dtype=bool)
        mask[:n] = True
        feats = None
        if features is not None:
            features = np.asarray(features, dtype=np.float32)
            ffill = (features[:1] if n > 0
                     else np.zeros((1, features.shape[1]), np.float32))
            feats = torch.from_numpy(np.concatenate(
                [features, np.repeat(ffill, pad, axis=0)], axis=0)).to(dev)
        return PointCloud(torch.from_numpy(pts).to(dev),
                          torch.from_numpy(mask).to(dev), feats)


def pad_cloud(points: np.ndarray, capacity: Optional[int] = None,
              tile: int = 128, device: DeviceLike = None) -> PointCloud:
    """Convenience alias for PointCloud.from_numpy."""
    return PointCloud.from_numpy(points, capacity=capacity, tile=tile,
                                 device=device)
