"""SIFT3D keypoints, PCL `SIFTKeypoint` semantics (port of
`pctpu/features/sift3d.py`).

Per octave o (base scale min_scale * 2^o) the scale-space signal is
smoothed at `scales_per_octave + 3` Gaussian scales,
L_sigma(i) = sum_j w_ij f(j) / sum_j w_ij, w = exp(-d^2 / (2 sigma^2)),
over each point's `k_cap` nearest neighbours; adjacent levels give the
DoG, and point i is a keypoint at an interior level s iff
|DoG(i,s)| >= min_contrast and DoG(i,s) is a strict extremum against its
25 nearest neighbours at the same level and its own values at s-1 and
s+1. Every octave runs on the full cloud.

`field` picks the signal: "y" (the reference wrapper's choice for a bare
XYZ cloud), "z", "density" (the smoothing weights' sum), or an [N] tensor.
The 25 neighbours are `knn`'s columns 1..25, column 0 taken for the
point itself. With an exact duplicate the two tie at distance 0 and
`knn` puts the lower index first, as the reference's `lax.top_k` does;
so both packages take the same columns, and a point whose twin is among
its 25 is never a strict extremum."""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.knn import knn

BIG = 1e30
FIELDS = ("y", "z", "density")


class SIFT3DResult(NamedTuple):
    keypoint_mask: torch.Tensor   # [N] bool: a keypoint at any level
    response: torch.Tensor        # [N] max |DoG| over the extremal levels
    scale: torch.Tensor           # [N] sigma of the strongest such level


def sift3d_keypoints(points: torch.Tensor,
                     mask: Optional[torch.Tensor] = None,
                     min_scale: float = 0.1,
                     n_octaves: int = 3,
                     scales_per_octave: int = 4,
                     min_contrast: float = 0.05,
                     k_cap: int = 96,
                     field: Union[str, torch.Tensor] = "y") -> SIFT3DResult:
    """points [N,3] -> PCL-style scale-space DoG keypoints. `field` is
    resolved to an [N] signal (or the density mode) here."""
    if isinstance(field, str):
        if field not in FIELDS:
            raise ValueError(f"unknown field {field!r}")
        f = {"y": points[:, 1], "z": points[:, 2], "density": None}[field]
    else:
        f = torch.as_tensor(field, dtype=torch.float32, device=points.device)
    return _sift3d_impl(points, mask, f, min_scale, n_octaves,
                        scales_per_octave, min_contrast, k_cap)


def _sift3d_impl(points: torch.Tensor, mask: Optional[torch.Tensor],
                 f: Optional[torch.Tensor], min_scale: float,
                 n_octaves: int, scales_per_octave: int,
                 min_contrast: float, k_cap: int) -> SIFT3DResult:
    n = points.shape[0]
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=points.device)
    # one kNN list serves the smoothing at every scale and the
    # 25-neighbour extremum test
    nbrs = knn(points, points, min(k_cap, n), db_mask=mask)
    d2 = torch.where(nbrs.valid, nbrs.dist2, BIG)                # [N,K]
    fv = None if f is None else group_points(f[:, None], nbrs.idx)[..., 0]

    # octave o, level i: sigma = min_scale 2^o 2^(i / spo), i in [0, spo+2]
    per = scales_per_octave + 3
    sigmas = torch.tensor(
        [min_scale * 2.0 ** o * 2.0 ** (i / scales_per_octave)
         for o in range(n_octaves) for i in range(per)],
        dtype=torch.float32, device=points.device)

    def smooth(sigma):
        w = torch.where(nbrs.valid, torch.exp(-d2 / (2.0 * sigma * sigma)),
                        0.0)
        if fv is None:
            return w.sum(dim=1)                                  # density
        return torch.sum(w * fv, dim=1) / torch.clamp_min(w.sum(dim=1),
                                                          1e-12)

    L = torch.stack([smooth(s) for s in sigmas])                 # [L,N]

    keep = torch.zeros((n,), dtype=torch.bool, device=points.device)
    best_resp = torch.zeros((n,), dtype=torch.float32, device=points.device)
    best_scale = torch.zeros_like(best_resp)
    nn25 = nbrs.idx[:, 1:26].long()                              # not self
    nn25_valid = nbrs.valid[:, 1:26]
    for o in range(n_octaves):
        lo = o * per
        dog = L[lo + 1:lo + per] - L[lo:lo + per - 1]            # [per-1,N]
        for s in range(1, per - 2):                              # interior
            v = dog[s]
            nb = v[nn25]
            nb_max = torch.where(nn25_valid, nb, -BIG).amax(dim=1)
            nb_min = torch.where(nn25_valid, nb, BIG).amin(dim=1)
            is_max = (v > nb_max) & (v > dog[s - 1]) & (v > dog[s + 1])
            is_min = (v < nb_min) & (v < dog[s - 1]) & (v < dog[s + 1])
            extremal = (is_max | is_min) & mask & (v.abs() >= min_contrast)
            keep = keep | extremal
            better = extremal & (v.abs() > best_resp)
            best_resp = torch.where(better, v.abs(), best_resp)
            best_scale = torch.where(better, sigmas[lo + s], best_scale)
    return SIFT3DResult(keep, best_resp, best_scale)
