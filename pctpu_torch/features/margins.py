"""Which keypoint and descriptor results cannot hinge on rounding.

Two runs of one detector (the card and the CPU, or the port and the JAX
package) agree on each response only to rounding, so a keep decision that
compares two values closer than that may fall either way, and so may a
radius test on a point that lies at the radius. From the reference run's
values and the geometry alone, never from the two runs' agreement, these
helpers bound each result's error and mark the decisions that the bound
settles: masks are then held equal there, and responses against their
bound.

A radius test is unsure when the exact squared distance lies within
1e-6 (|p|^2 + |q|^2 + r^2) of r^2: the |p|^2 + |q|^2 - 2pq expansion that
both runs use rounds by a few float32 units of |p|^2 + |q|^2. A neighbour
is surely among the k_cap closest when fewer than k_cap + 1 points may lie
as close, and surely not when k_cap points surely lie closer.

The NMS rule (`nms_decided`): a point that is surely not a candidate is
decided (not kept). A point that is surely a candidate is decided when a
sure candidate surely within the NMS radius outscores it by the margin
(suppressed), or when no point that may be a candidate, within the radius
or at it, comes within the margin of its score or above it (kept).

Everything runs in float64 over [chunk, N] tiles, on the points' device.
"""
from __future__ import annotations

import math
from typing import Iterator, Optional, Tuple

import torch

_EDGE = 1e-6
_U = 2.0 ** -24          # float32 unit roundoff
# measured bounds: a Harris response within 1e-6 between the card, the
# CPU and the JAX package, held with a tenfold margin; an ISS eigenvalue
# within 1e-5 of its point's largest, 1e-3 at a double root
_RESPONSE = 1e-5
_EIG, _EIG_DOUBLE = 1e-5, 1e-3


def _valid(points: torch.Tensor, mask: Optional[torch.Tensor]):
    return (torch.ones(points.shape[0], dtype=torch.bool,
                       device=points.device)
            if mask is None else mask.to(points.device))


def _tiles(queries: torch.Tensor, points: torch.Tensor, radius: float,
           mask: Optional[torch.Tensor], chunk: int = 1024
           ) -> Iterator[Tuple[slice, torch.Tensor, torch.Tensor,
                               torch.Tensor]]:
    """Yields (rows, d2 [c,N], near [c,N], edge [c,N]) per chunk of
    queries: the exact squared distances (inf to invalid points), the
    valid points within `radius`, and those whose radius test is unsure."""
    q, p = queries.double(), points.double()
    qn2, pn2 = (q * q).sum(1), (p * p).sum(1)
    valid = _valid(points, mask)
    r2 = float(radius) ** 2
    for s in range(0, q.shape[0], chunk):
        rows = slice(s, min(s + chunk, q.shape[0]))
        d2 = torch.cdist(q[rows], p,
                         compute_mode="donot_use_mm_for_euclid_dist") ** 2
        d2 = torch.where(valid[None], d2, float("inf"))
        edge = (d2 - r2).abs() <= _EDGE * (qn2[rows, None] + pn2[None] + r2)
        yield rows, d2, d2 <= r2, edge


def _kth(d2: torch.Tensor, member: torch.Tensor, k: int) -> torch.Tensor:
    """[c] the k-th smallest of d2 over `member`, per row (inf where fewer
    than k)."""
    if k > d2.shape[1]:
        return torch.full(d2.shape[:1], float("inf"), dtype=d2.dtype,
                          device=d2.device)
    return torch.topk(torch.where(member, d2, float("inf")), k,
                      largest=False).values[:, k - 1]


def _members(d2, near, edge, qn2, radius: float, k_cap: int):
    """([c,N] sure members of each query's capped radius neighbour set,
    [c,N] unsure ones): `radius_search(..., radius, k_cap)`'s set, which
    keeps the k_cap closest within the radius."""
    sure, maybe = near & ~edge, near | edge
    k_lo, k_hi = _kth(d2, maybe, k_cap + 1), _kth(d2, sure, k_cap)
    m = _EDGE * 4 * (qn2.sqrt() + radius) ** 2       # two d2 apart
    member = sure & (d2 < (k_lo - m)[:, None])
    return member, maybe & ~(d2 > (k_hi + m)[:, None]) & ~member


def neighbourhoods(points: torch.Tensor, radius: float, k_cap: int,
                   mask: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For `radius_search(points, points, radius, k_cap)`: ([N] int64 the
    exact count of valid points within `radius`, itself included; [N]
    bool: the capped neighbour set is unsure)."""
    n2 = (points.double() ** 2).sum(1)
    count = torch.zeros(points.shape[0], dtype=torch.long,
                        device=points.device)
    unsure = torch.zeros_like(count, dtype=torch.bool)
    for rows, d2, near, edge in _tiles(points, points, radius, mask):
        count[rows] = near.sum(1)
        unsure[rows] = _members(d2, near, edge, n2[rows], radius,
                                k_cap)[1].any(1)
    return count, unsure


def spread(flag: torch.Tensor, points: torch.Tensor, radius: float,
           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] bool: a valid point within `radius` (or at it; itself included)
    is flagged. A value computed over a radius neighbourhood is unsure
    where any input to it is."""
    out = torch.zeros_like(flag)
    f = flag.to(points.device)
    for rows, _, near, edge in _tiles(points, points, radius, mask):
        out[rows] = ((near | edge) & f[None]).any(1)
    return out


def nms_decided(points: torch.Tensor, score: torch.Tensor, tol,
                certain: torch.Tensor, excluded: torch.Tensor,
                radius: float, mask: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """[N] bool: points whose radius-NMS keep decision is settled (module
    docstring). `score` [N] is the reference run's (NaN: unsure), `tol` a
    bound on each score's error (a float or [N]); two scores are apart
    when they differ by more than the sum of their bounds. `certain` and
    `excluded` [N]: surely a candidate, surely not one."""
    s = score.double()
    tol = torch.as_tensor(tol, dtype=torch.float64,
                          device=s.device).expand_as(s)
    possible = ~excluded
    decided = excluded.clone()
    ids = torch.arange(s.shape[0], device=s.device)
    for rows, _, near, edge in _tiles(points, points, radius, mask):
        si = s[rows, None]
        margin = tol[rows, None] + tol[None]
        suppressed = (near & ~edge & certain[None]
                      & (s[None] > si + margin)).any(1)
        rival = ((near | edge) & (ids[None] != ids[rows, None])
                 & possible[None] & ~(s[None] < si - margin)).any(1)
        sure = certain[rows] & torch.isfinite(s[rows])
        decided[rows] |= sure & (suppressed | ~rival)
    return decided


def threshold_decided(points: torch.Tensor, response: torch.Tensor,
                      threshold: float, radius: float,
                      mask: Optional[torch.Tensor] = None,
                      unsure: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """[N] bool: settled keep decisions of a detector that keeps the
    points whose `response` exceeds `threshold` and survives radius NMS
    (Harris3D, Harris6D), each response within 1e-5; `unsure` [N] marks
    responses with no bound."""
    tol = _RESPONSE
    r = response.double()
    valid = _valid(r, mask)
    unsure = ~torch.isfinite(r) | (False if unsure is None
                                   else unsure.to(r.device))
    r = torch.where(unsure, float("nan"), r)
    excluded = ~valid | (~unsure & (r < threshold - tol))
    certain = valid & ~unsure & (r > threshold + tol)
    return nms_decided(points, r, tol, certain, excluded, radius, mask)


def iss_bounds(points: torch.Tensor, eigvals: torch.Tensor,
               mask: Optional[torch.Tensor] = None, radius: float = 3.0,
               k_cap: int = 64
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A bound [N] on how far either run's ISS eigenvalues may lie from the
    reference run's `eigvals` [N,3] (descending), and the least and the
    most radius count [N] either run can see.

    Two parts. The solver's rounding: 1e-5 of the point's largest
    eigenvalue, growing as 8 float32 units over the relative spectral gap
    near a close pair, up to 1e-3 at a double root (the closed-
    form solver's arccos turns a rounding into about its square root
    there). And the scatter's own uncertainty (Weyl: an eigenvalue moves
    by at most the spectral norm of the change): an unsure neighbour may
    add or drop its term w_j d_ij d_ij^T, a sure neighbour's weight
    1/count_j may take any value its count range allows, and the
    normalisation by the weights' sum W moves with them, so the scatter
    S / W moves by at most (|dS| + l1 |dW|) / W_least."""
    w = eigvals.double()
    dev = w.device
    l1 = w[:, 0].clamp_min(1e-12)
    gap = torch.minimum(w[:, 0] - w[:, 1], w[:, 1] - w[:, 2]) / l1
    solver = l1 * torch.clamp(8 * _U / gap.clamp_min(1e-30), _EIG,
                              _EIG_DOUBLE)
    n = points.shape[0]
    lo = torch.zeros(n, dtype=torch.long, device=points.device)
    hi = torch.zeros_like(lo)
    for rows, _, near, edge in _tiles(points, points, radius, mask):
        lo[rows], hi[rows] = (near & ~edge).sum(1), (near | edge).sum(1)
    w_lo, w_hi = 1.0 / hi.clamp_min(1).double(), 1.0 / lo.clamp_min(1).double()
    n2 = (points.double() ** 2).sum(1)
    l1p = l1.to(points.device)
    scatter = torch.empty_like(l1p)
    for rows, d2, near, edge in _tiles(points, points, radius, mask):
        member, unsure = _members(d2, near, edge, n2[rows], radius, k_cap)
        dw = (torch.where(member, w_hi - w_lo, 0.0)
              + torch.where(unsure, w_hi, 0.0))
        d_s = (dw * d2.nan_to_num(posinf=0.0)).sum(1)
        least = torch.where(member, w_lo, 0.0).sum(1)
        scatter[rows] = torch.where(
            least > 0, (d_s + l1p[rows] * dw.sum(1)) / least.clamp_min(1e-300),
            float("inf"))
    return solver + scatter.to(dev), lo.to(dev), hi.to(dev)


def iss_decided(points: torch.Tensor, eigvals: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                salient_radius: float = 3.0, non_max_radius: float = 2.0,
                gamma_21: float = 0.975, gamma_32: float = 0.975,
                min_neighbors: int = 5, k_cap: int = 64,
                max_keypoints: int = 0,
                kept: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The settled decisions of `iss_keypoints` with these parameters
    (the defaults are PCL's), from the reference run's eigenvalues [N,3]
    (descending), each within its `iss_bounds`. With `max_keypoints`,
    `kept` [N] is the reference run's keep mask before the cap (its
    `max_keypoints=0` result), and the cap's decisions are settled by
    `top_k_decided`. Returns (decided [N], bound [N])."""
    w = eigvals.double()
    l1, l2, l3 = w[:, 0], w[:, 1], w[:, 2]
    valid = _valid(l1, mask)
    bound, lo, hi = iss_bounds(points, eigvals, mask, salient_radius, k_cap)
    m = 2 * bound                     # l2 - g l1 moves by (1 + g) bounds
    fails = ((l2 - gamma_21 * l1 > m) | (l3 - gamma_32 * l2 > m)
             | (l3 < -bound))
    passes = ((gamma_21 * l1 - l2 > m) & (gamma_32 * l2 - l3 > m)
              & (l3 > bound))
    excluded = ~valid | (hi < min_neighbors) | fails
    certain = valid & (lo >= min_neighbors) & passes
    score = torch.where(torch.isfinite(bound), l3, float("nan"))
    decided = nms_decided(points, score, bound, certain, excluded,
                          non_max_radius, mask)
    if max_keypoints:
        if kept is None:
            raise ValueError("max_keypoints needs the uncapped keep mask")
        decided = top_k_decided(score, bound, kept.to(decided.device),
                                decided, max_keypoints)
    return decided, bound


def top_k_decided(score: torch.Tensor, tol, kept: torch.Tensor,
                  decided: torch.Tensor, k: int) -> torch.Tensor:
    """[N] bool: settled decisions of `top_k_mask(score, keep, k)`, where
    the reference run's `keep` is `kept` [N] and settled where `decided`
    [N]; `score` [N] as in `nms_decided` (NaN: unsure), within `tol`. A
    point is surely in the top k when it is surely kept and fewer than k
    other points that may be kept may score as high; surely out when it
    is surely not kept, or k surely kept points surely outscore it."""
    s = score.double()
    tol = torch.as_tensor(tol, dtype=torch.float64,
                          device=s.device).expand_as(s)
    sure = decided & kept
    maybe = ~decided | kept
    margin = tol[:, None] + tol[None]
    others = ~torch.eye(s.shape[0], dtype=torch.bool, device=s.device)
    rivals = (maybe[None] & others
              & ~(s[None] < s[:, None] - margin)).sum(1)
    above = (sure[None] & (s[None] > s[:, None] + margin)).sum(1)
    return (sure & torch.isfinite(s) & (rivals < k)) \
        | (decided & ~kept) | (above >= k)


def gradient_conditioning(points: torch.Tensor, normals: torch.Tensor,
                          radius: float, k_cap: int = 64,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The conditioning of `intensity_gradients`' least-squares solve, per
    point ([N] float64 each): the matrix A's condition number (its closest
    `k_cap` radius neighbours' centred scatter plus 1e-9 I), and what of
    it survives the projection onto the tangent plane, max_k |P v_k|
    l_max / l_k over A's eigenpairs (P = I - n n^T). A solve's rounding
    lies along A's weak directions; on flat ground the weakest is the
    normal, which the projection removes."""
    p = points.double()
    nrm = normals.double().to(p.device)
    kappa = torch.empty(p.shape[0], dtype=torch.float64, device=p.device)
    tangent = torch.empty_like(kappa)
    eye = torch.eye(3, dtype=torch.float64, device=p.device)
    k = min(k_cap, p.shape[0])
    for rows, d2, near, _ in _tiles(points, points, radius, mask):
        dk, ik = torch.topk(torch.where(near, d2, float("inf")), k,
                            largest=False)
        w = torch.isfinite(dk).double()
        q = p[ik]                                         # [c,k,3]
        cen = (q * w[..., None]).sum(1) / w.sum(1).clamp_min(1.0)[:, None]
        dq = (q - cen[:, None]) * w[..., None]
        lam, vec = torch.linalg.eigh(
            torch.einsum("cki,ckj->cij", dq, dq) + 1e-9 * eye)
        n = nrm[rows]
        proj = ((eye - n[:, :, None] * n[:, None, :]) @ vec).norm(dim=1)
        kappa[rows] = lam[:, 2] / lam[:, 0]
        tangent[rows] = (proj * lam[:, 2:] / lam).amax(1)
    return kappa, tangent


def harris6d_unsure(points: torch.Tensor, normals: torch.Tensor,
                    radius: float = 0.5, k_cap: int = 64,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[N] bool: Harris6D responses with no rounding bound: a point within
    `radius` has an unsure neighbour set or a gradient solve whose
    tangent conditioning reaches 1e3 (`gradient_conditioning`): the
    response reads its neighbours' unit gradients, each of which reads
    its own neighbourhood."""
    _, nb = neighbourhoods(points, radius, k_cap, mask)
    _, tangent = gradient_conditioning(points, normals, radius, k_cap, mask)
    return spread(nb | (tangent >= 1e3), points, radius, mask)


def shot_bounds(points: torch.Tensor, keypoints: torch.Tensor,
                normals: torch.Tensor, radius: float, k_cap: int = 128,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`shot352`'s settled keypoints [M] and a bound [M] on either run's
    max |descriptor difference| there.

    A keypoint's frame is settled when its neighbour set is sure, both
    gaps of the (radius - d)-weighted covariance exceed 1e-3 of its
    largest eigenvalue (an axis then rounds by at most 8 float32 units
    over the gap), and both sign votes are: the neighbours whose side of
    the axis that rounding cannot move outvote the others. Given the
    frame, a neighbour whose sector (azimuth, elevation, shell) or cosine
    bin lies within its coordinates' rounding of an edge may move one
    count to the next bin, moving the L2-normalised histogram h by at
    most 2 sqrt(2) / |h| each; the bound is 1e-5 plus that."""
    p = points.double()
    kq = keypoints.double().to(p.device)
    nrm = normals.double().to(p.device)
    qn2 = (kq * kq).sum(1)
    m = kq.shape[0]
    settled = torch.zeros(m, dtype=torch.bool, device=p.device)
    bound = torch.full((m,), float("inf"), dtype=torch.float64,
                       device=p.device)
    k = min(k_cap, p.shape[0])
    az_edges = torch.arange(-4, 5, device=p.device) * (math.pi / 4)
    cos_edges = -1.0 + 2.0 * torch.arange(1, 11, device=p.device) / 11
    for rows, d2, near, edge in _tiles(kq, points, radius, mask):
        member, unsure = _members(d2, near, edge, qn2[rows], radius, k_cap)
        dk, ik = torch.topk(torch.where(near, d2, float("inf")), k,
                            largest=False)
        valid = torch.isfinite(dk)
        diff = p[ik] - kq[rows, None]                      # [c,k,3]
        dist = dk.clamp_min(0.0).nan_to_num(posinf=0.0).sqrt()
        w = torch.where(valid, radius - dist, 0.0)
        cov = (torch.einsum("ck,cki,ckj->cij", w, diff, diff)
               / w.sum(1).clamp_min(1e-12)[:, None, None])
        lam, vec = torch.linalg.eigh(cov)
        top = lam[:, 2].clamp_min(1e-300)
        gap = torch.minimum(lam[:, 1] - lam[:, 0], lam[:, 2] - lam[:, 1])
        axis_err = 8 * _U * top / gap.clamp_min(1e-300)
        # a coordinate along a frame axis rounds by the axis' error times
        # |diff| (thrice: x is re-orthogonalised against z, y = z x x)
        # plus float32 units of the keypoint's magnitude
        dn = diff.norm(dim=-1)
        slack = 3 * axis_err[:, None] * dn + 8 * _U * (qn2[rows].sqrt()
                                                        + radius)[:, None]

        def vote(axis):
            proj = (diff * axis[:, None]).sum(-1)
            clear = valid & ((proj.abs() > slack) | (dn == 0))
            s = torch.where(clear, torch.sign(proj), 0.0).sum(1)
            unclear = (valid & ~clear).sum(1)
            ok = (unclear == 0) | (s.abs() > unclear)
            return torch.where(s < 0, -1.0, 1.0)[:, None] * axis, ok

        x, ok_x = vote(vec[:, :, 2])
        z, ok_z = vote(vec[:, :, 0])
        x = x - (x * z).sum(1, keepdim=True) * z
        x = x / x.norm(dim=1, keepdim=True).clamp_min(1e-300)
        y = torch.cross(z, x, dim=1)
        lx, ly, lz = ((diff * a[:, None]).sum(-1) for a in (x, y, z))
        rho = torch.sqrt(lx * lx + ly * ly)
        az = torch.atan2(ly, lx)
        az_near = (((az[..., None] - az_edges).abs().amin(-1) * rho)
                   <= 2 * slack) | (rho <= 2 * slack)
        cos_t = (z[:, None] * nrm[ik]).sum(-1).clamp(-1.0, 1.0)
        cos_near = ((cos_t[..., None] - cos_edges).abs().amin(-1)
                    <= 2 * axis_err[:, None] + 8 * _U)
        shell_near = (dn - 0.5 * radius).abs() <= slack
        flips = (valid & (dn > 1e-9)
                 & (az_near | cos_near | shell_near | (lz.abs() <= slack)))
        rad_bin = (dn >= 0.5 * radius).long()
        az_bin = torch.clamp(torch.floor((az + math.pi) / (2 * math.pi) * 8),
                             0, 7).long()
        cos_bin = torch.clamp(torch.floor((cos_t + 1.0) / 2.0 * 11),
                              0, 10).long()
        sector = (rad_bin * 2 + (lz >= 0).long()) * 8 + az_bin
        hist = torch.zeros((dk.shape[0], 352), dtype=torch.float64,
                           device=p.device)
        hist.scatter_add_(1, sector * 11 + cos_bin,
                          (valid & (dn > 1e-9)).double())
        norm = hist.norm(dim=1).clamp_min(1e-12)
        settled[rows] = (~unsure.any(1) & (gap > 1e-3 * top)
                         & ok_x & ok_z)
        bound[rows] = 1e-5 + 2 * math.sqrt(2) * flips.sum(1) / norm
    return settled, bound
