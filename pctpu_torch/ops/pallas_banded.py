"""Band layout of a db for the windowed ICP kernel (port of
`pctpu/ops/pallas_banded.py:31-85`: `BandedDB`, `LUT_BINS`,
`build_banded`), batched over a leading axis.

The db is sorted (stable argsort) along its widest extent axis and laid
out as [3, Np] columns, with a bucket LUT that maps a sort-axis coordinate
to its approximate sorted position."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pctpu_torch.core.cloud import round_up

BIG = 1e30
LUT_BINS = 1024


class BandedDB(NamedTuple):
    dbt: torch.Tensor        # [B,3,Np] coords sorted by axis (padded)
    penalty: torch.Tensor    # [B,1,Np] 0 valid / BIG masked or pad
    coords: torch.Tensor     # [B,Np] sorted axis coordinate (pad -> BIG)
    order: torch.Tensor      # [B,Np] original index per sorted slot
    axis: torch.Tensor       # [B] int32 sort axis
    n: int                   # true db size
    lut: torch.Tensor        # [B,LUT_BINS+1] axis coord -> sorted position
    lo: torch.Tensor         # [B] axis range low
    hi: torch.Tensor         # [B] axis range high
    dbt4: torch.Tensor       # [B,4,Np] coords + ones row
    pen2: torch.Tensor       # [B,1,Np] |b|^2 + penalty


def build_banded(db: torch.Tensor, db_mask: Optional[torch.Tensor] = None,
                 block: int = 2048) -> BandedDB:
    """db [B,N,3], db_mask [B,N] -> BandedDB sorted along each cloud's
    widest extent axis (masked points sort last)."""
    b, n, _ = db.shape
    dev = db.device
    db = db.float()
    if db_mask is None:
        db_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    lo = torch.amin(torch.where(db_mask[..., None], db,
                                torch.full_like(db, BIG)), dim=1)
    hi = torch.amax(torch.where(db_mask[..., None], db,
                                torch.full_like(db, -BIG)), dim=1)
    axis = torch.argmax(hi - lo, dim=1).int()                 # [B]
    vals = torch.gather(db, 2, axis.long()[:, None, None].expand(b, n, 1))
    vals = torch.where(db_mask, vals[..., 0], torch.full_like(vals[..., 0],
                                                              BIG))
    order = torch.argsort(vals, dim=1, stable=True)
    np_ = round_up(n, block)
    pad = np_ - n
    sorted_db = torch.gather(db, 1, order[..., None].expand(b, n, 3))
    dbt = torch.nn.functional.pad(sorted_db.transpose(1, 2), (0, pad))
    pen_valid = torch.gather(db_mask, 1, order)
    penalty = torch.nn.functional.pad(
        torch.where(pen_valid, 0.0, BIG).float(), (0, pad), value=BIG)
    coords = torch.nn.functional.pad(torch.gather(vals, 1, order), (0, pad),
                                     value=BIG)
    order_p = torch.nn.functional.pad(order.int(), (0, pad))
    ar = torch.arange(b, device=dev)
    ax_lo = lo[ar, axis.long()]
    ax_hi = hi[ar, axis.long()]
    steps = torch.arange(LUT_BINS + 1, dtype=torch.float32, device=dev)
    grid_vals = (ax_lo[:, None]
                 + (ax_hi - ax_lo)[:, None] * steps[None, :] / LUT_BINS)
    lut = torch.searchsorted(coords.contiguous(), grid_vals).int()
    dbt4 = torch.cat([dbt, torch.ones((b, 1, np_), dtype=torch.float32,
                                      device=dev)], dim=1)
    pen2 = torch.sum(dbt * dbt, dim=1, keepdim=True) + penalty[:, None, :]
    return BandedDB(dbt, penalty[:, None, :], coords, order_p, axis, n, lut,
                    ax_lo, ax_hi, dbt4, pen2)
