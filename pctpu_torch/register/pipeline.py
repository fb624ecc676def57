"""Batched coarse-to-fine registration (port of
`pctpu/register/pipeline.py:register_pairs` on its accelerator path,
`feature_backend="fused"`, `icp_backend="mega"`):

  cloud -> voxel downsample (cap, cell-lexsorted) -> radius normals ->
  FPFH-33 (K2 spfh, K3 wsum) -> mutual-NN matching -> batched RANSAC ->
  voxel-cloud ICP (K4) -> exact full-res refine (K4) -> stats (K1).

The port has this one path. On the card each stage's kernel runs; on the
CPU (`device="cpu"`) each kernel's plain PyTorch version runs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from pctpu_torch.core import se3
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.features.matching import match_features
from pctpu_torch.features.pallas_fpfh import fpfh_fused
from pctpu_torch.ops.gather import gather_points
from pctpu_torch.ops.knn import nearest
from pctpu_torch.ops.voxel import voxel_downsample_capped
from pctpu_torch.register.icp import (icp_fixed_iters_banded_mega_batch,
                                      icp_refine_exact_mega_batch)
from pctpu_torch.register.ransac import (Sampler, generator_sampler,
                                         ransac_registration_batch)


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """The reference's `RegistrationConfig` fields that `register_pairs`'
    fused/mega path reads, with the same defaults."""
    voxel_size: float = 2.0
    feature_radius: float = 10.0
    ransac_dist: float = 4.0
    ransac_hypotheses: int = 1024
    ransac_m_cap: int = 512
    icp_dist_thresh: float = 5.0
    downsample_capacity: int = 2048
    normal_radius: float = 4.0
    icp_voxel_iters: int = 14
    icp_refine_iters: int = 2
    refine_subsample: int = 2048
    stats_subsample: int = 1024

    # reference fields that select the path: the port runs only this one
    _PATH = {"keypoints": ("all",), "feature_backend": ("auto", "fused"),
             "icp_backend": ("auto", "mega")}
    # reference fields that this path never reads (single-pair
    # `register_pair`, the XLA while-loop ICP, the ISS keypoint option)
    _UNUSED = ("normal_k", "feature_k_cap", "icp_max_iters",
               "icp_query_chunk", "icp_fixed_coarse", "icp_fixed_polish",
               "iss_salient_radius", "iss_nonmax_radius",
               "iss_min_neighbors", "iss_k_cap")

    @classmethod
    def from_dict(cls, d: dict) -> "RegistrationConfig":
        """Build from `dataclasses.asdict(pctpu...RegistrationConfig(...))`.
        Raises on a value that selects another path than the port's, and
        on a key the reference does not have."""
        own = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for key, val in d.items():
            if key in own:
                kw[key] = val
            elif key in cls._PATH:
                if val not in cls._PATH[key]:
                    raise ValueError(
                        f"{key}={val!r}: the port runs only "
                        f"{cls._PATH[key]}")
            elif key not in cls._UNUSED:
                raise ValueError(f"unknown RegistrationConfig field {key!r}")
        return cls(**kw)


class RegistrationOutput(NamedTuple):
    T: torch.Tensor                # [B,4,4] src -> dst
    ransac_T: torch.Tensor
    ransac_fitness: torch.Tensor
    icp_iters: torch.Tensor
    icp_rmse: torch.Tensor
    num_matches: torch.Tensor
    src_voxels: torch.Tensor       # pre-cap valid-voxel count (telemetry)
    dst_voxels: torch.Tensor


def _refine_exact_batch(T, src: PointCloud, dst: PointCloud,
                        cfg: RegistrationConfig):
    """`icp_refine_iters` exact iterations of a strided full-res source
    subsample against the FULL target, in one K4 launch."""
    n = src.points.shape[1]
    stride = max(1, n // cfg.refine_subsample)
    q = src.points[:, ::stride][:, :cfg.refine_subsample]
    qm = src.mask[:, ::stride][:, :cfg.refine_subsample]
    return icp_refine_exact_mega_batch(
        q, qm, dst.points, dst.mask, T, iters=cfg.icp_refine_iters,
        dist_thresh=cfg.icp_dist_thresh)


def _icp_stats_subsampled(T, src: PointCloud, dst: PointCloud,
                          cfg: RegistrationConfig):
    """Inlier count (scaled back to the full cloud) and RMSE at the final
    pose, from one exact 1-NN pass (K1) of a uniform source subsample."""
    n = src.points.shape[1]
    stride = max(1, n // cfg.stats_subsample)
    q = src.points[:, ::stride][:, :cfg.stats_subsample]
    qm = src.mask[:, ::stride][:, :cfg.stats_subsample]
    d2, _ = nearest(se3.apply_transform(T, q), dst.points, dst.mask)
    thresh2 = float(torch.tensor(cfg.icp_dist_thresh,
                                 dtype=torch.float32)) ** 2
    inl = (d2 <= thresh2) & qm
    num = inl.sum(dim=1, dtype=torch.int32)
    rmse = torch.sqrt(torch.where(inl, d2, torch.zeros_like(d2)).sum(dim=1)
                      / torch.clamp_min(num.float(), 1.0))
    return num * stride, rmse


def register_pairs(src: PointCloud, dst: PointCloud,
                   cfg: RegistrationConfig = RegistrationConfig(),
                   sampler: Optional[Sampler] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> RegistrationOutput:
    """Batched full pipeline on clouds with a leading pair axis
    ([B,N,3] points, [B,N] masks) -> RegistrationOutput (T src->dst).

    Runs on CUDA unless `device="cpu"`; raises without a card. RANSAC
    draws come from `sampler` if given, else from `generator` (a
    `torch.Generator` on the run's device; seed 0 when omitted)."""
    dev = resolve_device(device)
    src, dst = src.to(dev), dst.to(dev)
    b = src.points.shape[0]
    if sampler is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        sampler = generator_sampler(generator)

    def preprocess(pc: PointCloud):
        down, nv = voxel_downsample_capped(pc.points, pc.mask,
                                           cfg.voxel_size,
                                           cfg.downsample_capacity)
        # the capped voxel clouds are cell-lexsorted (valid prefix x-sorted
        # up to one leaf), so the exact x-band pruning applies
        feats = fpfh_fused(down.points, mask=down.mask,
                           radius=cfg.feature_radius,
                           normal_radius=cfg.normal_radius,
                           x_banded=True, x_slack=cfg.voxel_size)
        return down, feats, nv

    sdown, sfeat, s_nv = preprocess(src)
    ddown, dfeat, d_nv = preprocess(dst)
    matches = match_features(sfeat, dfeat, src_mask=sdown.mask,
                             dst_mask=ddown.mask, mutual=True)
    dst_kp = gather_points(ddown.points, matches.dst_idx)
    rr = ransac_registration_batch(
        sdown.points, dst_kp, matches.valid, sampler,
        dist_thresh=cfg.ransac_dist, num_hypotheses=cfg.ransac_hypotheses,
        m_cap=cfg.ransac_m_cap)
    num_matches = matches.valid.sum(dim=1, dtype=torch.int32)

    # multiscale ICP: exact-window iterations on the 2k voxel clouds, then
    # exact strided full-res refine iterations against the full target
    T = icp_fixed_iters_banded_mega_batch(
        sdown.points, sdown.mask, ddown.points, ddown.mask, init_T=rr.T,
        coarse_iters=cfg.icp_voxel_iters, polish_iters=0,
        dist_thresh=cfg.icp_dist_thresh, block=2048, window_blocks=1,
        query_tile=2048)
    if cfg.icp_refine_iters > 0:
        T = _refine_exact_batch(T, src, dst, cfg)
    _, rmse = _icp_stats_subsampled(T, src, dst, cfg)
    iters = torch.full((b,), cfg.icp_voxel_iters + cfg.icp_refine_iters,
                       dtype=torch.int32, device=dev)
    return RegistrationOutput(T, rr.T, rr.fitness, iters, rmse,
                              num_matches, s_nv, d_nv)
