"""Furthest-point sampling (port of `pctpu/ops/fps.py`).

`fps` is the reference's greedy loop for one cloud in plain PyTorch;
`fps_batched` runs a batch through kernel 11 on CUDA and its plain
version on the CPU (`ops/pallas_fps.py`). Both keep the reference's
semantics: idx[0] = 0 unconditionally, first-index ties, masked and
(with `skip_near_origin`) near-origin points never selected.
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.ops import pallas_fps


def fps(points: torch.Tensor, m: int, mask: Optional[torch.Tensor] = None,
        skip_near_origin: bool = False) -> torch.Tensor:
    """points [N,3] -> idx [m] int32 of a furthest-point subset, in plain
    PyTorch on the tensor's device.

    Masked-out (padding) points are never selected; if the cloud has fewer
    than m valid points, selections repeat."""
    pts, eligible = pallas_fps._prepare(
        points[None], None if mask is None else mask[None], skip_near_origin)
    return pallas_fps.fps_plain(pts, m, eligible)[0]


def fps_batched(points: torch.Tensor, m: int,
                mask: Optional[torch.Tensor] = None,
                skip_near_origin: bool = False) -> torch.Tensor:
    """[B,N,3] -> [B,m] int32: kernel 11 on CUDA tensors, its plain
    version on CPU tensors."""
    return pallas_fps.fps_pallas_batched(points, m, mask=mask,
                                         skip_near_origin=skip_near_origin)
