"""Pair-parallel registration sweeps on one device (port of
`pctpu/parallel/pair_sweep.py:batched_icp`, `batched_icp_mega`): a batch
of independent scan pairs in lockstep. The mesh-sharded sweeps
(`make_pair_sweep`, `make_full_pipeline_sweep`) are not ported yet."""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.register.icp import (icp_fixed_iters,
                                      icp_fixed_iters_banded_mega_batch)


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
