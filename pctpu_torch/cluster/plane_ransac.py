"""Plane RANSAC ground segmentation with batched hypotheses (port of
`pctpu/cluster/plane_ransac.py`).

All hypotheses are evaluated at once: sample H triples, plane from the
cross product, count inliers over all N points in one [H,N] masked
reduction, then refine the best plane by least squares over its inliers
(the least eigenvector of their scatter, `ops.eigh3`).

Draws: the reference takes its triples as the Gumbel top-3 of the masked
logits under a `jax.random` key, which PyTorch cannot reproduce, so the
sampler is injectable -- `sampler(vote_mask [N] bool, H) -> [H,3] int`
point indices. The default (`gumbel_sampler`) draws the Gumbel noise from
a seeded `torch.Generator` on the points' device and takes `topk(3)`.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from pctpu_torch.ops.eigh3 import _cross, eigh3

PlaneSampler = Callable[[torch.Tensor, int], torch.Tensor]


class PlaneResult(NamedTuple):
    normal: torch.Tensor        # [3] unit normal
    offset: torch.Tensor        # scalar d: n.x + d = 0
    inlier_mask: torch.Tensor   # [N] bool
    num_inliers: torch.Tensor   # scalar int32


def gumbel_sampler(generator: torch.Generator) -> PlaneSampler:
    """Gumbel top-3 of the masked logits (0 where the mask holds, -1e9
    elsewhere), the noise drawn from `generator` (on the mask's device):
    three distinct valid points a hypothesis while at least three vote."""
    def sample(vote_mask: torch.Tensor, h: int) -> torch.Tensor:
        u = torch.rand((h, vote_mask.shape[0]), generator=generator,
                       device=vote_mask.device)
        g = -torch.log(-torch.log(torch.clamp_min(
            u, torch.finfo(torch.float32).tiny)))     # u < 1: -log(u) > 0
        g = g + torch.where(vote_mask, 0.0, -1e9)[None, :]
        return torch.topk(g, 3, dim=1).indices
    return sample


def plane_ransac(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 dist_thresh: float = 0.3, num_hypotheses: int = 1024,
                 generator: Optional[torch.Generator] = None,
                 refine: bool = True,
                 sampler: Optional[PlaneSampler] = None) -> PlaneResult:
    """points [N,3] -> the best plane. Degenerate (near-collinear) samples
    score zero. `sampler` draws the triples (default: `gumbel_sampler` of
    `generator`, itself seeded 0 on the points' device when None)."""
    n = points.shape[0]
    dev = points.device
    points = points.float()
    if mask is None:
        mask = torch.ones((n,), dtype=torch.bool, device=dev)
    if sampler is None:
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        sampler = gumbel_sampler(generator)

    samples = sampler(mask, num_hypotheses).long().to(dev)      # [H,3]
    p = points[samples]                                         # [H,3,3]
    normal = _cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])       # [H,3]
    norm = torch.linalg.vector_norm(normal, dim=-1, keepdim=True)
    ok = norm[:, 0] > 1e-8                                      # non-degenerate
    normal = normal / torch.clamp_min(norm, 1e-12)
    d = -torch.sum(normal * p[:, 0], dim=-1)                    # [H]

    dist = torch.abs(points @ normal.T + d[None, :])            # [N,H]
    inl = (dist.T < dist_thresh) & mask[None, :]                # [H,N]
    scores = inl.sum(dim=1, dtype=torch.int32) * ok.int()
    best = torch.argmax(scores)                                 # first max
    bn, bd = normal[best], d[best]
    inlier_mask = inl[best]

    if refine:
        # least-squares plane through the inliers: the least eigenvector
        # of their scatter, oriented as the hypothesis
        w = inlier_mask.float()
        cnt = torch.clamp_min(w.sum(), 1.0)
        c = torch.sum(points * w[:, None], dim=0) / cnt
        diff = (points - c) * w[:, None]
        cov = diff.T @ diff / cnt
        _, vecs = eigh3(cov)
        bn2 = vecs[:, 0]
        bn2 = torch.where(torch.dot(bn2, bn) < 0, -bn2, bn2)
        bd2 = -torch.dot(bn2, c)
        inlier_mask = (torch.abs(points @ bn2 + bd2) < dist_thresh) & mask
        bn, bd = bn2, bd2

    return PlaneResult(bn, bd, inlier_mask,
                       inlier_mask.sum(dtype=torch.int32))


def segment_ground(points: torch.Tensor, mask: Optional[torch.Tensor] = None,
                   dist_thresh: float = 0.3, num_hypotheses: int = 1024,
                   generator: Optional[torch.Generator] = None,
                   normals: Optional[torch.Tensor] = None,
                   z_cos_thresh: float = 0.86602540378,
                   sampler: Optional[PlaneSampler] = None):
    """Ground segmentation with the normal prefilter: only points with
    |normal_z| > z_cos_thresh vote for the ground plane. Returns
    (ground_mask [N] bool, PlaneResult)."""
    base = (mask if mask is not None
            else torch.ones(points.shape[:1], dtype=torch.bool,
                            device=points.device))
    vote_mask = base
    if normals is not None:
        vote_mask = vote_mask & (torch.abs(normals[:, 2]) > z_cos_thresh)
    res = plane_ransac(points, vote_mask, dist_thresh, num_hypotheses,
                       generator, sampler=sampler)
    dist = torch.abs(points.float() @ res.normal + res.offset)
    return (dist < dist_thresh) & base, res
