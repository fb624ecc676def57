"""Batched whole-loop ICP around kernel K4 (port of
`pctpu/register/icp.py:339-552`: `_pad_pow2`,
`icp_fixed_iters_banded_mega_batch`, `icp_refine_exact_mega_batch`)."""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.ops.pallas_banded import LUT_BINS, build_banded
from pctpu_torch.ops.pallas_icp_mega import icp_mega_batch

BIG = 1e30


def _pad_pow2(points: torch.Tensor, mask: torch.Tensor, axis: int = 0):
    """Pad the point axis up to the next power of two: edge-mode points
    (the last point repeated), mask False."""
    n = points.shape[axis]
    m = 1 << (n - 1).bit_length()
    if m == n:
        return points, mask
    idx = torch.clamp(torch.arange(m, device=points.device), max=n - 1)
    pts = torch.index_select(points, axis, idx)
    pad_shape = list(mask.shape)
    pad_shape[axis] = m - n
    msk = torch.cat([mask, torch.zeros(pad_shape, dtype=torch.bool,
                                       device=mask.device)], dim=axis)
    return pts, msk


def _query_layout(src_sorted: torch.Tensor, mask_sorted: torch.Tensor,
                  query_tile: int):
    """[B,3,Mp] points, [B,1,Mp] penalty, [B,1,3*ntiles] tile centres."""
    b, n, _ = src_sorted.shape
    mp = ((n + query_tile - 1) // query_tile) * query_tile
    src3 = torch.nn.functional.pad(src_sorted.float().transpose(1, 2),
                                   (0, mp - n))
    spen = torch.nn.functional.pad(
        torch.where(mask_sorted, 0.0, BIG).float(), (0, mp - n), value=BIG)
    ntiles = mp // query_tile
    centers = src3[:, :, query_tile // 2::query_tile].transpose(1, 2)
    return (src3.contiguous(), spen[:, None, :].contiguous(),
            centers.reshape(b, 1, 3 * ntiles).contiguous())


def icp_fixed_iters_banded_mega_batch(src: torch.Tensor,
                                      src_mask: torch.Tensor,
                                      dst: torch.Tensor,
                                      dst_mask: torch.Tensor,
                                      init_T: Optional[torch.Tensor] = None,
                                      coarse_iters: int = 45,
                                      polish_iters: int = 5,
                                      dist_thresh: float = 5.0,
                                      block: int = 512,
                                      window_blocks: int = 4,
                                      query_tile: int = 256,
                                      newton_iters: int = 6) -> torch.Tensor:
    """Batched whole-loop ICP: src/dst [B,N,3]/[B,M,3] -> T [B,4,4].

    One K4 launch per phase: `coarse_iters` windowed iterations, then
    `polish_iters` exact ones (the window spanning the whole db). Source
    tiles are ordered by the init-transformed band-axis coordinate."""
    src, src_mask = _pad_pow2(src, src_mask, axis=1)
    dst, dst_mask = _pad_pow2(dst, dst_mask, axis=1)
    b, n, _ = src.shape
    if init_T is None:
        init_T = torch.eye(4, dtype=torch.float32,
                           device=src.device).repeat(b, 1, 1)
    init_T = init_T.float()
    bdb = build_banded(dst, dst_mask, block=block)

    st = src.float() @ init_T[:, :3, :3].transpose(1, 2) + init_T[:, None,
                                                                  :3, 3]
    svals = torch.gather(st, 2, bdb.axis.long()[:, None, None].expand(
        b, n, 1))[..., 0]
    svals = torch.where(src_mask, svals, torch.full_like(svals, BIG))
    sorder = torch.argsort(svals, dim=1, stable=True)
    src_s = torch.gather(src.float(), 1, sorder[..., None].expand(b, n, 3))
    mask_s = torch.gather(src_mask, 1, sorder)
    src3, spen, centers = _query_layout(src_s, mask_s, query_tile)
    dbt5 = torch.cat([bdb.dbt, bdb.pen2, torch.ones_like(bdb.pen2)], dim=1)
    lut = bdb.lut[:, None, :]
    nb = bdb.dbt4.shape[2] // block

    T = init_T
    for iters, wb in ((coarse_iters, window_blocks), (polish_iters, nb)):
        if iters > 0:
            T = icp_mega_batch(dbt5, lut, bdb.lo, bdb.hi, bdb.axis, src3,
                               spen, centers, T, iters=iters,
                               dist_thresh=dist_thresh, block=block,
                               window_blocks=wb, query_tile=query_tile,
                               newton_iters=newton_iters)
    return T


def icp_refine_exact_mega_batch(src: torch.Tensor, src_mask: torch.Tensor,
                                dst: torch.Tensor, dst_mask: torch.Tensor,
                                init_T: torch.Tensor,
                                iters: int = 2, dist_thresh: float = 5.0,
                                block: int = 2048, query_tile: int = 512,
                                newton_iters: int = 6) -> torch.Tensor:
    """Batched EXACT fixed-iteration refine in one K4 launch, with no
    layout prep: the window spans the whole db (window_blocks = nb), so
    the LUT, band axis and source order are dummies and the operands go in
    unsorted. src [B,M,3] (a strided subsample), dst [B,N,3]."""
    src, src_mask = _pad_pow2(src, src_mask, axis=1)
    dst, dst_mask = _pad_pow2(dst, dst_mask, axis=1)
    b, m, _ = src.shape
    n = dst.shape[1]
    dev = src.device
    np_ = ((n + block - 1) // block) * block

    dstf = torch.where(dst_mask[..., None], dst.float(),
                       torch.zeros_like(dst, dtype=torch.float32))
    pen = torch.where(dst_mask, 0.0, BIG).float()
    pen2 = torch.sum(dstf * dstf, dim=-1) + pen
    dbt5 = torch.zeros((b, 5, np_), dtype=torch.float32, device=dev)
    dbt5[:, 0:3, :n] = dstf.transpose(1, 2)
    dbt5[:, 3, :n] = pen2
    dbt5[:, 3, n:] = BIG
    dbt5[:, 4, :n] = 1.0
    src3, spen, centers = _query_layout(src, src_mask, query_tile)
    return icp_mega_batch(
        dbt5, torch.zeros((b, 1, LUT_BINS + 1), dtype=torch.int32,
                          device=dev),
        torch.zeros((b,), device=dev), torch.ones((b,), device=dev),
        torch.zeros((b,), dtype=torch.int32, device=dev), src3, spen,
        centers, init_T.float(), iters=iters, dist_thresh=dist_thresh,
        block=block, window_blocks=np_ // block, query_tile=query_tile,
        newton_iters=newton_iters)
