"""Pair-parallel registration sweeps (port of
`pctpu/parallel/pair_sweep.py`): a batch of independent scan pairs in
lockstep on one device (`batched_icp`: K1; `batched_icp_mega`: K4), and
the pair batch split over the ranks of a mesh, each rank running the
one-device program on its B / W pairs with no collective but the final
`all_gather` of the results (`make_pair_sweep`, `make_full_pipeline_sweep`).
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.parallel.mesh import Mesh, all_gather, shard_batch
from pctpu_torch.register.icp import (icp_fixed_iters,
                                      icp_fixed_iters_banded_mega_batch)
from pctpu_torch.register.pipeline import (RegistrationConfig,
                                           RegistrationOutput, register_pairs)
from pctpu_torch.register.ransac import Sampler, generator_sampler


def batched_icp(src: torch.Tensor, src_mask: torch.Tensor,
                dst: torch.Tensor, dst_mask: torch.Tensor,
                init_T: Optional[torch.Tensor] = None,
                iters: int = 30, dist_thresh: float = 5.0,
                query_chunk: int = 2048,
                device: DeviceLike = None) -> torch.Tensor:
    """[B,N,3] x [B,M,3] -> [B,4,4]: fixed-iteration ICP (K1) of every
    pair at once."""
    return icp_fixed_iters(src, src_mask, dst, dst_mask, init_T=init_T,
                           iters=iters, dist_thresh=dist_thresh,
                           query_chunk=query_chunk, device=device)


def batched_icp_mega(src: torch.Tensor, src_mask: torch.Tensor,
                     dst: torch.Tensor, dst_mask: torch.Tensor,
                     coarse_iters: int = 28, polish_iters: int = 2,
                     dist_thresh: float = 5.0, block: int = 512,
                     window_blocks: int = 1, query_tile: int = 512,
                     device: DeviceLike = None) -> torch.Tensor:
    """[B,N,3] x [B,M,3] -> [B,4,4]: the whole-loop ICP over the pair
    batch, one K4 launch per phase (windowed, then exact)."""
    dev = resolve_device(device)
    return icp_fixed_iters_banded_mega_batch(
        src.to(dev), src_mask.to(dev), dst.to(dev), dst_mask.to(dev),
        coarse_iters=coarse_iters, polish_iters=polish_iters,
        dist_thresh=dist_thresh, block=block, window_blocks=window_blocks,
        query_tile=query_tile)


def make_pair_sweep(mesh: Mesh, pair_axis: str = "data", iters: int = 30,
                    dist_thresh: float = 5.0, query_chunk: int = 2048,
                    device: DeviceLike = None):
    """sweep(src, src_mask, dst, dst_mask) -> [B,4,4]: `batched_icp` of
    each rank's contiguous B / W pairs (B must divide by the axis size),
    gathered so that every rank returns all B poses. Every rank passes the
    whole batch. Runs on CUDA unless `device="cpu"` is asked for."""
    dev = resolve_device(device)
    shard = shard_batch(mesh, pair_axis)

    def sweep(src, src_mask, dst, dst_mask):
        local = [torch.as_tensor(shard.take(x)).to(dev)
                 for x in (src, src_mask, dst, dst_mask)]
        return shard.gather(batched_icp(*local, iters=iters,
                                        dist_thresh=dist_thresh,
                                        query_chunk=query_chunk,
                                        device=dev))
    return sweep


def make_full_pipeline_sweep(mesh: Mesh, pair_axis: str = "data", cfg=None,
                             device: DeviceLike = None):
    """The whole registration pipeline (`register.pipeline.register_pairs`:
    voxel -> FPFH -> mutual-NN -> RANSAC -> multiscale ICP) over the mesh:
    each rank runs it on its contiguous B / W pairs (B must divide by the
    axis size) and the outputs are gathered, so every rank returns the
    whole `RegistrationOutput`.

    Returns sweep(src: PointCloud, dst: PointCloud, sampler=None). RANSAC's
    draws must not depend on W, as the reference's per-pair keys [B,2] do
    not: `sampler(nv [B], H) -> [B,H,3]` is called over the whole batch
    (the ranks gather their valid-match counts first) and each rank keeps
    its pairs' rows. The default draws from a generator seeded with 0 on
    the run's device, `register_pairs`' default for the whole batch. Runs
    on CUDA unless `device="cpu"` is asked for."""
    dev = resolve_device(device)
    cfg = RegistrationConfig() if cfg is None else cfg
    shard = shard_batch(mesh, pair_axis)
    group = mesh.group(pair_axis)

    def sweep(src: PointCloud, dst: PointCloud,
              sampler: Optional[Sampler] = None) -> RegistrationOutput:
        if sampler is None:
            sampler = generator_sampler(
                torch.Generator(device=dev).manual_seed(0))
        rows = shard.rows(src.points.shape[0])

        def local_sampler(nv: torch.Tensor, H: int) -> torch.Tensor:
            return sampler(all_gather(nv, group), H)[rows]

        def local(pc: PointCloud) -> PointCloud:
            return PointCloud(pc.points[rows], pc.mask[rows])
        out = register_pairs(local(src), local(dst), cfg=cfg,
                             sampler=local_sampler, device=dev)
        return RegistrationOutput(*(shard.gather(x) for x in out))
    return sweep
