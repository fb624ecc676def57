"""Morton (Z-order) codes for window grouping (port of
`pctpu/ops/morton.py`).

Interleaves 10 quantised bits per axis into a 30-bit int32 key, in int32
bit operations as the reference. Consecutive points in Morton order are
spatially compact, so fixed strided windows behave like neighbourhoods
(`grouping="window"` in `models/pointnet2.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

BITS = 10
MASKED_CODE = 2**31 - 1


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    """Spread the low 10 bits of int32 x so two zero bits lie between
    each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_codes(points: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """points [..., N, 3] -> int32 Morton codes [..., N]: each axis
    quantised as ((p - lo) / scale) * 1023, clipped to [0, 1023], then
    truncated, with lo, hi over the unmasked points and scale =
    max(hi - lo, 1e-9). Masked points get 2**31 - 1 (they sort last)."""
    points = points.float()
    if mask is None:
        mask = torch.ones(points.shape[:-1], dtype=torch.bool,
                          device=points.device)
    big = torch.tensor(1e30, dtype=torch.float32, device=points.device)
    m3 = mask[..., None]
    lo = torch.where(m3, points, big).amin(dim=-2, keepdim=True)
    hi = torch.where(m3, points, -big).amax(dim=-2, keepdim=True)
    scale = torch.clamp_min(hi - lo, 1e-9)
    top = 2 ** BITS - 1
    q = torch.clamp(((points - lo) / scale) * top, 0, top).to(torch.int32)
    code = (_spread_bits(q[..., 0])
            | (_spread_bits(q[..., 1]) << 1)
            | (_spread_bits(q[..., 2]) << 2))
    return torch.where(mask, code, torch.full_like(code, MASKED_CODE))


def morton_sort(points: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Morton-order permutation [..., N] int32: a stable argsort of
    the codes."""
    return torch.argsort(morton_codes(points, mask), dim=-1,
                         stable=True).int()
