"""Row gathers with explicit batch dims (port of `pctpu/ops/gather.py`)."""
from __future__ import annotations

import torch


def _flat_row_gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [*B, N, C], idx [*B, M] -> [*B, M, C].

    Indices are clipped to [0, N-1] first, as the reference does, so an
    out-of-range index can never read another batch element's rows."""
    n, c = points.shape[-2], points.shape[-1]
    idx = torch.clamp(idx, 0, n - 1).long()
    if points.dim() == 2:
        return points[idx]
    return torch.gather(points, -2,
                        idx[..., None].expand(*idx.shape, c))


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [..., N, C], idx [..., M] -> [..., M, C]."""
    return _flat_row_gather(points, idx)


def group_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [..., N, C], idx [..., M, K] -> [..., M, K, C]."""
    m, k = idx.shape[-2], idx.shape[-1]
    out = _flat_row_gather(points, idx.reshape(idx.shape[:-2] + (m * k,)))
    return out.reshape(idx.shape[:-2] + (m, k, points.shape[-1]))


def mask_group(grouped: torch.Tensor, valid: torch.Tensor,
               fill: float = 0.0) -> torch.Tensor:
    """Fill invalid grouped entries: grouped [..., M, K, C], valid
    [..., M, K] -> grouped with `fill` where not valid."""
    return torch.where(valid[..., None], grouped,
                       torch.tensor(fill, dtype=grouped.dtype,
                                    device=grouped.device))
