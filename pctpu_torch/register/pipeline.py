"""Coarse-to-fine registration (port of `pctpu/register/pipeline.py`).

`register_pairs`, batched, on the reference's accelerator path
(`feature_backend="fused"`, `icp_backend="mega"`):

  cloud -> voxel downsample (cap, cell-lexsorted) -> radius normals ->
  FPFH-33 (K2 spfh, K3 wsum) -> mutual-NN matching -> batched RANSAC ->
  voxel-cloud ICP (K4) -> exact full-res refine (K4) -> stats (K1).

`register_pair`, one pair:

  cloud -> voxel downsample -> uniform cap -> kNN normals -> FPFH-33
  (neighbour lists) -> mutual-NN matching -> RANSAC -> whole-loop ICP
  (kernel 5: windowed, then exact) -> stats (K1).

`keypoints="iss"` restricts matching and RANSAC to the ISS keypoints of
each voxel cloud (`features/iss.py`; FPFH still sees the whole voxel
cloud), in both. `feature_backend="dense"` computes `register_pairs`'
FPFH by `features/fpfh_dense.py:fpfh_dense` instead of K2/K3.
`icp_backend="while"` runs the convergence-tested `icp_point_to_point`
(K1) instead of the mega kernels, in both. On the card each stage's
kernel runs; on the CPU (`device="cpu"`) each kernel's plain version runs.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from pctpu_torch.core import se3
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.device import DeviceLike, f32_square, resolve_device
from pctpu_torch.features.fpfh import fpfh
from pctpu_torch.features.fpfh_dense import fpfh_dense
from pctpu_torch.features.iss import iss_keypoints
from pctpu_torch.features.matching import match_features
from pctpu_torch.features.pallas_fpfh import fpfh_fused
from pctpu_torch.ops.gather import gather_points
from pctpu_torch.ops.knn import nearest
from pctpu_torch.ops.voxel import voxel_downsample, voxel_downsample_capped
from pctpu_torch.register.icp import (ICPConfig, icp_fixed_iters_banded_mega,
                                      icp_fixed_iters_banded_mega_batch,
                                      icp_point_to_point,
                                      icp_refine_exact_mega_batch)
from pctpu_torch.register.ransac import (Sampler, generator_sampler,
                                         ransac_registration,
                                         ransac_registration_batch)
from pctpu_torch.utils.profiling import span

ICP_BACKENDS = ("auto", "mega", "while")
KEYPOINTS = ("all", "iss")
FEATURE_BACKENDS = ("auto", "fused", "dense")


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    """The reference's `RegistrationConfig` fields, with the same defaults
    (`pctpu/register/pipeline.py:31-95`). `icp_backend` "auto" and "mega"
    run the mega kernels on the card (their plain versions on the CPU);
    "while" runs `icp_point_to_point`. `keypoints` "all" matches every
    capped voxel point, "iss" only the ISS keypoints of each voxel cloud
    (`iss_*`: the PCL wrapper's ISS parameters). `feature_backend` picks
    `register_pairs`' FPFH: "auto" and "fused" run K2/K3 on the card (their
    plain versions on the CPU), "dense" runs `fpfh_dense`. The reference's
    "auto" means "fused" on the TPU and "dense" elsewhere, so a comparison
    with the JAX package on the CPU names the backend."""
    voxel_size: float = 2.0
    normal_k: int = 30
    feature_radius: float = 10.0
    feature_k_cap: int = 100
    ransac_dist: float = 4.0
    ransac_hypotheses: int = 1024
    ransac_m_cap: int = 512
    icp_dist_thresh: float = 5.0
    icp_max_iters: int = 100
    icp_query_chunk: int = 2048
    downsample_capacity: int = 2048
    icp_backend: str = "auto"
    icp_fixed_coarse: int = 47
    icp_fixed_polish: int = 3
    normal_radius: float = 4.0
    icp_voxel_iters: int = 14
    icp_refine_iters: int = 2
    refine_subsample: int = 2048
    stats_subsample: int = 1024
    keypoints: str = "all"
    iss_salient_radius: float = 3.0
    iss_nonmax_radius: float = 2.0
    iss_min_neighbors: int = 5
    iss_k_cap: int = 64
    feature_backend: str = "auto"

    def __post_init__(self):
        for name, allowed in (("icp_backend", ICP_BACKENDS),
                              ("keypoints", KEYPOINTS),
                              ("feature_backend", FEATURE_BACKENDS)):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name}={getattr(self, name)!r}: expected "
                                 f"one of {allowed}")

    @classmethod
    def from_dict(cls, d: dict) -> "RegistrationConfig":
        """Build from `dataclasses.asdict(pctpu...RegistrationConfig(...))`.
        Raises on a key the reference does not have and on a value it
        does not take."""
        own = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - own)
        if unknown:
            raise ValueError(f"unknown RegistrationConfig field(s) {unknown}")
        return cls(**d)


class RegistrationOutput(NamedTuple):
    T: torch.Tensor                # [B,4,4] src -> dst
    ransac_T: torch.Tensor
    ransac_fitness: torch.Tensor
    icp_iters: torch.Tensor
    icp_rmse: torch.Tensor
    num_matches: torch.Tensor
    src_voxels: torch.Tensor       # pre-cap valid-voxel count (telemetry)
    dst_voxels: torch.Tensor


def _icp_config(cfg: RegistrationConfig) -> ICPConfig:
    return ICPConfig(max_iters=cfg.icp_max_iters,
                     dist_thresh=cfg.icp_dist_thresh,
                     query_chunk=cfg.icp_query_chunk)


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
    inl = (d2 <= f32_square(cfg.icp_dist_thresh)) & qm
    num = inl.sum(dim=1, dtype=torch.int32)
    rmse = torch.sqrt(torch.where(inl, d2, torch.zeros_like(d2)).sum(dim=1)
                      / torch.clamp_min(num.float(), 1.0))
    return num * stride, rmse


def keypoint_sites(down: PointCloud,
                   cfg: RegistrationConfig) -> torch.Tensor:
    """The matching sites of one voxel cloud ([N]) or a batch ([B,N]), a
    bool mask shaped as `down.mask`: every valid point, or
    (keypoints="iss") each cloud's ISS keypoints, one cloud at a time
    (`radius_search` takes one cloud). Both entry points take their sites
    from here."""
    if cfg.keypoints == "all":
        return down.mask
    if down.points.dim() == 2:
        return keypoint_sites(PointCloud(down.points[None], down.mask[None]),
                              cfg)[0]
    return torch.stack([
        iss_keypoints(p, mask=m, salient_radius=cfg.iss_salient_radius,
                      non_max_radius=cfg.iss_nonmax_radius,
                      min_neighbors=cfg.iss_min_neighbors,
                      k_cap=cfg.iss_k_cap).keypoint_mask & m
        for p, m in zip(down.points, down.mask)])


def register_pairs(src: PointCloud, dst: PointCloud,
                   cfg: RegistrationConfig = RegistrationConfig(),
                   sampler: Optional[Sampler] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None) -> RegistrationOutput:
    """Batched full pipeline on clouds with a leading pair axis
    ([B,N,3] points, [B,N] masks) -> RegistrationOutput (T src->dst).
    With `icp_backend="while"` the pairs' ICP runs one by one.

    Runs on CUDA unless `device="cpu"`; raises without a card. RANSAC
    draws come from `sampler` if given, else from `generator` (a
    `torch.Generator` on the run's device; seed 0 when omitted).

    Its stages are spans of `utils/profiling.py`, recorded while a torch
    profiler records: `register_pairs` and, under it, `inputs`, `sites`,
    `match`, `gather`, `icp_voxel`, `icp_refine` and `icp_stats`, opened
    here, and `voxel`, `fpfh` and `ransac`, opened by the functions that
    do those stages."""
    with span("register_pairs"):
        dev = resolve_device(device)
        with span("inputs"):
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
            if cfg.feature_backend == "dense":
                feats = fpfh_dense(down.points, mask=down.mask,
                                   radius=cfg.feature_radius,
                                   normal_radius=cfg.normal_radius)
            else:
                # the capped voxel clouds are cell-lexsorted (valid prefix
                # x-sorted up to one leaf), so the exact x-band pruning applies
                feats = fpfh_fused(down.points, mask=down.mask,
                                   radius=cfg.feature_radius,
                                   normal_radius=cfg.normal_radius,
                                   x_banded=True, x_slack=cfg.voxel_size)
            return down, feats, nv

        sdown, sfeat, s_nv = preprocess(src)
        ddown, dfeat, d_nv = preprocess(dst)
        with span("sites"):
            s_sites = keypoint_sites(sdown, cfg)
            d_sites = keypoint_sites(ddown, cfg)
        with span("match"):
            matches = match_features(sfeat, dfeat, src_mask=s_sites,
                                     dst_mask=d_sites, mutual=True)
        with span("gather"):
            dst_kp = gather_points(ddown.points, matches.dst_idx)
        rr = ransac_registration_batch(
            sdown.points, dst_kp, matches.valid, sampler,
            dist_thresh=cfg.ransac_dist, num_hypotheses=cfg.ransac_hypotheses,
            m_cap=cfg.ransac_m_cap)
        num_matches = matches.valid.sum(dim=1, dtype=torch.int32)

        if cfg.icp_backend == "while":
            icp_cfg = _icp_config(cfg)
            res = [icp_point_to_point(src.points[i], src.mask[i],
                                      dst.points[i], dst.mask[i],
                                      init_T=rr.T[i], cfg=icp_cfg,
                                      device=dev) for i in range(b)]
            return RegistrationOutput(
                torch.stack([r.T for r in res]), rr.T, rr.fitness,
                torch.stack([r.iters for r in res]),
                torch.stack([r.rmse for r in res]), num_matches, s_nv, d_nv)

        # multiscale ICP: exact-window iterations on the 2k voxel clouds,
        # then exact strided full-res refine iterations against the full
        # target
        with span("icp_voxel"):
            T = icp_fixed_iters_banded_mega_batch(
                sdown.points, sdown.mask, ddown.points, ddown.mask,
                init_T=rr.T, coarse_iters=cfg.icp_voxel_iters,
                polish_iters=0, dist_thresh=cfg.icp_dist_thresh, block=2048,
                window_blocks=1, query_tile=2048)
        if cfg.icp_refine_iters > 0:
            with span("icp_refine"):
                T = _refine_exact_batch(T, src, dst, cfg)
        with span("icp_stats"):
            _, rmse = _icp_stats_subsampled(T, src, dst, cfg)
        iters = torch.full((b,), cfg.icp_voxel_iters + cfg.icp_refine_iters,
                           dtype=torch.int32, device=dev)
        return RegistrationOutput(T, rr.T, rr.fitness, iters, rmse,
                                  num_matches, s_nv, d_nv)


# ---------------------------------------------------------------------------
# single pair
# ---------------------------------------------------------------------------

def _cap_uniform(down: PointCloud, cap: int):
    """Slice a front-compacted voxel cloud to `cap` points; when more
    voxels are valid, stride uniformly over the valid prefix (the voxels
    are lexsorted by cell, so a stride samples the scene evenly)."""
    n = down.points.shape[0]
    nv = down.mask.sum(dtype=torch.int32)
    if cap >= n:
        return down, nv
    i = torch.arange(cap, device=down.points.device)
    idx = torch.where(nv > cap, torch.div(i * nv, cap, rounding_mode="floor"),
                      i)
    return PointCloud(points=down.points[idx], mask=down.mask[idx]), nv


def _front_end(src: PointCloud, dst: PointCloud, sampler: Sampler,
               cfg: RegistrationConfig):
    """voxel -> FPFH (neighbour lists) -> mutual matching over the sites
    (every voxel point, or its ISS keypoints) -> RANSAC global init, for
    one pair."""

    def preprocess(pc: PointCloud):
        with span("voxel"):
            down = voxel_downsample(pc.points, pc.mask, cfg.voxel_size)
            down, nv = _cap_uniform(down, cfg.downsample_capacity)
        feats = fpfh(down.points, mask=down.mask, radius=cfg.feature_radius,
                     k_cap=cfg.feature_k_cap, normal_k=cfg.normal_k)
        with span("sites"):
            sites = keypoint_sites(down, cfg)
        return down, feats, sites, nv

    sdown, sfeat, s_sites, s_nv = preprocess(src)
    ddown, dfeat, d_sites, d_nv = preprocess(dst)
    with span("match"):
        matches = match_features(sfeat, dfeat, src_mask=s_sites,
                                 dst_mask=d_sites, mutual=True)
    with span("gather"):
        dst_kp = gather_points(ddown.points, matches.dst_idx)
    rr = ransac_registration(sdown.points, dst_kp, matches.valid, sampler,
                             dist_thresh=cfg.ransac_dist,
                             num_hypotheses=cfg.ransac_hypotheses)
    return rr, matches.valid.sum(dtype=torch.int32), s_nv, d_nv


def _icp_stats(T, src: PointCloud, dst: PointCloud,
               cfg: RegistrationConfig):
    """One exact association pass (K1) at the final pose: inlier count and
    RMSE."""
    d2, _ = nearest(se3.apply_transform(T, src.points), dst.points,
                    dst.mask, cfg.icp_query_chunk)
    inl = (d2 <= f32_square(cfg.icp_dist_thresh)) & src.mask
    num = inl.sum(dtype=torch.int32)
    rmse = torch.sqrt(torch.where(inl, d2, torch.zeros_like(d2)).sum()
                      / torch.clamp_min(num.float(), 1.0))
    return num, rmse


def _register_pair_impl(src: PointCloud, dst: PointCloud, sampler: Sampler,
                        cfg: RegistrationConfig,
                        dev: torch.device) -> RegistrationOutput:
    """The full coarse-to-fine chain for ONE pair."""
    rr, num_matches, s_nv, d_nv = _front_end(src, dst, sampler, cfg)
    if cfg.icp_backend == "while":
        with span("icp"):
            icp = icp_point_to_point(src.points, src.mask, dst.points,
                                     dst.mask, init_T=rr.T,
                                     cfg=_icp_config(cfg), device=dev)
        icp_T, icp_iters, icp_rmse = icp.T, icp.iters, icp.rmse
    else:
        with span("icp"):
            icp_T = icp_fixed_iters_banded_mega(
                src.points, src.mask, dst.points, dst.mask, init_T=rr.T,
                coarse_iters=cfg.icp_fixed_coarse,
                polish_iters=cfg.icp_fixed_polish,
                dist_thresh=cfg.icp_dist_thresh, block=1024,
                window_blocks=1, query_tile=1024, device=dev)
        with span("icp_stats"):
            _, icp_rmse = _icp_stats(icp_T, src, dst, cfg)
        icp_iters = torch.tensor(cfg.icp_fixed_coarse + cfg.icp_fixed_polish,
                                 dtype=torch.int32, device=dev)
    return RegistrationOutput(icp_T, rr.T, rr.fitness, icp_iters, icp_rmse,
                              num_matches, s_nv, d_nv)


def register_pair(src: PointCloud, dst: PointCloud,
                  cfg: RegistrationConfig = RegistrationConfig(),
                  sampler: Optional[Sampler] = None,
                  generator: Optional[torch.Generator] = None,
                  device: DeviceLike = None) -> RegistrationOutput:
    """Full coarse-to-fine registration of two padded clouds ([N,3]
    points, [N] masks) -> RegistrationOutput (T [4,4] src -> dst).

    Runs on CUDA unless `device="cpu"`; raises without a card. RANSAC
    draws come from `sampler` if given, else from `generator` (a
    `torch.Generator` on the run's device; seed 0 when omitted).

    Its stages are spans of `utils/profiling.py`, recorded while a torch
    profiler records: `register_pair` and, under it, `inputs`, `voxel`
    (the grid and the uniform cap), `sites`, `match`, `gather`, `icp` and
    `icp_stats`, opened in this module, and `fpfh` (with `normals`, `radius`,
    `spfh`), `ransac` and, under `icp`, `layout`, `coarse` and `polish`,
    opened by the functions that do those stages."""
    with span("register_pair"):
        dev = resolve_device(device)
        with span("inputs"):
            src, dst = src.to(dev), dst.to(dev)
        if sampler is None:
            if generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            sampler = generator_sampler(generator)
        return _register_pair_impl(src, dst, sampler, cfg, dev)


def result_row(idx1: int, idx2: int, T) -> tuple:
    """One result-file row in the reference's format (`main.py:213-218`):
    (idx1, idx2, t [3], q_wxyz [4]) of the given transform, as numpy. Pass
    the transform in the direction the evaluator expects (mapping cloud
    idx2 onto idx1)."""
    t, q = se3.transform_to_tq(torch.as_tensor(T, dtype=torch.float32))
    return idx1, idx2, t.cpu().numpy(), q.cpu().numpy()
