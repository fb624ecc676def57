"""Descriptor matching: (mutual) nearest neighbour in feature space
(port of `pctpu/features/matching.py`), batched over a leading axis."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

BIG = 1e30


class Matches(NamedTuple):
    src_idx: torch.Tensor   # [...,M] int32 (arange for dense matching)
    dst_idx: torch.Tensor   # [...,M] int32 best dst for each src
    dist2: torch.Tensor     # [...,M] descriptor distance
    valid: torch.Tensor     # [...,M] bool (mutual + mask filters)


def _feat_dist2(a, b, b_mask=None):
    """a^2 + b^2 - 2ab in f32, clamped at 0; masked dst columns get BIG."""
    a2 = torch.sum(a * a, dim=-1, keepdim=True)
    b2 = torch.sum(b * b, dim=-1)[..., None, :]
    cross = torch.matmul(a, b.transpose(-1, -2))
    d2 = torch.clamp_min(a2 + b2 - 2.0 * cross, 0.0)
    if b_mask is not None:
        d2 = torch.where(b_mask[..., None, :], d2, torch.full_like(d2, BIG))
    return d2


def match_features(src_feats: torch.Tensor, dst_feats: torch.Tensor,
                   src_mask: Optional[torch.Tensor] = None,
                   dst_mask: Optional[torch.Tensor] = None,
                   mutual: bool = True) -> Matches:
    """src_feats [...,M,C], dst_feats [...,N,C] -> Matches (one row per
    src). mutual=True keeps only pairs where src->dst and dst->src agree.
    Ties go to the first index (torch.argmin returns the first)."""
    src_feats, dst_feats = src_feats.float(), dst_feats.float()
    m = src_feats.shape[-2]
    d2 = _feat_dist2(src_feats, dst_feats, dst_mask)          # [...,M,N]
    best_d2, best_dst = torch.min(d2, dim=-1)
    best_dst = best_dst.int()
    rows = torch.arange(m, dtype=torch.int32, device=d2.device).expand(
        best_dst.shape)
    valid = (torch.ones_like(best_dst, dtype=torch.bool) if src_mask is None
             else src_mask)
    if mutual:
        d2b = d2 if src_mask is None else torch.where(
            src_mask[..., :, None], d2, torch.full_like(d2, BIG))
        best_src = torch.argmin(d2b, dim=-2).int()            # [...,N]
        back = torch.gather(best_src, -1, best_dst.long())
        valid = valid & (back == rows)
    return Matches(rows, best_dst, best_d2, valid)
