"""Ground removal + object clustering for LiDAR frames (port of
`pctpu/pipelines/segmentation.py`), the shared front end of the KITTI ETL
and detection pipelines: kNN normals -> z-normal-prefiltered plane RANSAC
-> FOV crop -> DBSCAN object ids, on the input's device.

The plane's triples come from `sampler` (`cluster.plane_ransac`), by
default the Gumbel top-3 of `generator` (seeded 0 on the points' device
when None).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from pctpu_torch.cluster.dbscan import dbscan
from pctpu_torch.cluster.plane_ransac import PlaneSampler, segment_ground
from pctpu_torch.ops.normals import estimate_normals


@dataclasses.dataclass(frozen=True)
class SegmentationConfig:
    """Defaults = extract.py's numbers (`:412-468`)."""
    normal_k: int = 9                 # max_nn 9 at radius 5.0
    ground_dist: float = 0.30         # segment_plane distance
    ransac_hypotheses: int = 1024     # ~ 1000 iterations
    z_cos_thresh: float = 0.86602540  # cos(pi/6) normal prefilter
    fov_x: tuple = (1.95, 80.0)       # camera FOV crop
    fov_y: tuple = (-30.0, 30.0)
    dbscan_eps: float = 0.60
    dbscan_min_pts: int = 3
    dbscan_k_cap: int = 32


class SegmentationResult(NamedTuple):
    ground_mask: torch.Tensor   # [N] bool (within the original mask)
    object_ids: torch.Tensor    # [N] int32, -1 = noise/ground/out of FOV
    normals: torch.Tensor       # [N,3]
    foreground: torch.Tensor    # [N] bool: in-FOV, off-ground valid points


def in_fov(points: torch.Tensor, cfg: SegmentationConfig) -> torch.Tensor:
    return ((points[:, 0] >= cfg.fov_x[0]) & (points[:, 0] <= cfg.fov_x[1])
            & (points[:, 1] >= cfg.fov_y[0]) & (points[:, 1] <= cfg.fov_y[1]))


def segment_ground_and_objects(points: torch.Tensor, mask: torch.Tensor,
                               generator: Optional[torch.Generator] = None,
                               sampler: Optional[PlaneSampler] = None,
                               cfg: SegmentationConfig = SegmentationConfig()
                               ) -> SegmentationResult:
    normals = estimate_normals(points, mask=mask, k=cfg.normal_k)
    ground, _ = segment_ground(
        points, mask=mask, dist_thresh=cfg.ground_dist,
        num_hypotheses=cfg.ransac_hypotheses, generator=generator,
        normals=normals, z_cos_thresh=cfg.z_cos_thresh, sampler=sampler)
    fg = mask & ~ground & in_fov(points, cfg)
    ids = dbscan(points, cfg.dbscan_eps, cfg.dbscan_min_pts, mask=fg,
                 k_cap=cfg.dbscan_k_cap)
    return SegmentationResult(ground, torch.where(fg, ids, -1), normals, fg)
