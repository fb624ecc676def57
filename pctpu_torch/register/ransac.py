"""RANSAC global registration from feature correspondences (port of
`pctpu/register/ransac.py`): the batched `ransac_registration_batch`, the
single-pair `ransac_registration` (the batch code at B = 1, as the
reference's two functions compute the same math) and the
confidence-gated `ransac_registration_adaptive`.

Every hypothesis is sampled, solved (closed-form triad rotation), checked
(edge-length ratio, non-degenerate triangle) and scored at once; the
whole [H,M] residual matrix is one [H,16]x[16,M] product per pair.

Draws: `jax.random` cannot be reproduced in PyTorch, so the sampler is
injectable — `sampler(nv [B] int, H) -> [B,H,3] int` positions in
[0, nv) (B = 1 for the single-pair functions; the adaptive loop calls it
once per batch of hypotheses). The default draws uniformly from a
`torch.Generator`."""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from pctpu_torch.core import se3
from pctpu_torch.device import f32_square
from pctpu_torch.ops.eigh3 import _cross
from pctpu_torch.ops.gather import _flat_row_gather
from pctpu_torch.register.procrustes import weighted_procrustes

Sampler = Callable[[torch.Tensor, int], torch.Tensor]


class RansacResult(NamedTuple):
    T: torch.Tensor            # [B,4,4] best transform
    inliers: torch.Tensor      # [B] int32 inlier count of the best hypothesis
    inlier_mask: torch.Tensor  # [B,m_cap] bool correspondence inliers
    fitness: torch.Tensor      # [B] f32 inliers / valid correspondences


def generator_sampler(generator: torch.Generator) -> Sampler:
    """Uniform draws in [0, nv) from `generator` (on nv's device)."""
    def sample(nv: torch.Tensor, H: int) -> torch.Tensor:
        u = torch.rand((nv.shape[0], H, 3), generator=generator,
                       device=nv.device, dtype=torch.float64)
        nvl = nv.long()[:, None, None]
        return torch.minimum((u * nvl).long(), nvl - 1)
    return sample


def _triad_rigid(s: torch.Tensor, d: torch.Tensor):
    """Exact rigid fit to 3-point samples s, d [...,3,3] (points in rows)
    through per-triangle orthonormal triads. Returns (R [...,3,3],
    t [...,3], nondegen [...] bool)."""

    def triad(x):
        a = x[..., 1, :] - x[..., 0, :]
        b = x[..., 2, :] - x[..., 0, :]
        e1 = a / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=-1, keepdim=True), 1e-12)
        b_perp = b - torch.sum(b * e1, dim=-1, keepdim=True) * e1
        bn = torch.linalg.vector_norm(b_perp, dim=-1, keepdim=True)
        e2 = b_perp / torch.clamp_min(bn, 1e-12)
        e3 = _cross(e1, e2)
        return torch.stack([e1, e2, e3], dim=-1), bn[..., 0]

    Fs, ns = triad(s)
    Fd, nd = triad(d)
    R = Fd @ Fs.transpose(-1, -2)
    cs = torch.mean(s, dim=-2)
    cd = torch.mean(d, dim=-2)
    t = cd - (R @ cs[..., None])[..., 0]
    nondegen = (ns > 1e-6) & (nd > 1e-6)
    return R, t, nondegen


def _edge_lens(x: torch.Tensor) -> torch.Tensor:
    nrm = torch.linalg.vector_norm
    return torch.stack([nrm(x[..., 0, :] - x[..., 1, :], dim=-1),
                        nrm(x[..., 0, :] - x[..., 2, :], dim=-1),
                        nrm(x[..., 1, :] - x[..., 2, :], dim=-1)], dim=-1)


def ransac_registration_batch(src_pts: torch.Tensor, dst_pts: torch.Tensor,
                              corr_valid: torch.Tensor,
                              sampler: Sampler,
                              dist_thresh: float = 4.0,
                              edge_ratio: float = 0.9,
                              num_hypotheses: int = 4096,
                              refine: bool = True,
                              m_cap: Optional[int] = None) -> RansacResult:
    """src/dst correspondence sets [B,M,3], valid [B,M] -> RansacResult.

    `m_cap`: compact the valid correspondences to the front (stable
    argsort) and keep the first m_cap; when more are valid, scoring and
    refine see that prefix and the returned inlier_mask / fitness are over
    the capped set (the reference's behaviour, kept as it is)."""
    b, m, _ = src_pts.shape
    H = num_hypotheses
    dev = src_pts.device
    src_pts, dst_pts = src_pts.float(), dst_pts.float()
    thresh2 = float(torch.tensor(dist_thresh, dtype=torch.float32)) ** 2

    order = torch.argsort(torch.where(corr_valid, 0, 1), dim=1,
                          stable=True).int()
    if m_cap is not None and m_cap < m:
        sel = order[:, :m_cap]
        src_pts = _flat_row_gather(src_pts, sel)
        dst_pts = _flat_row_gather(dst_pts, sel)
        corr_valid = _flat_row_gather(corr_valid[..., None], sel)[..., 0]
        m = m_cap
        order = torch.arange(m, dtype=torch.int32, device=dev).expand(b, m)

    n_valid = torch.clamp_min(corr_valid.float().sum(dim=1), 1.0)
    nv_i = torch.clamp_min(corr_valid.sum(dim=1, dtype=torch.int32), 1)
    u = sampler(nv_i, H)                                       # [B,H,3]
    if u.shape != (b, H, 3):
        raise ValueError(f"sampler returned {tuple(u.shape)}, "
                         f"expected {(b, H, 3)}")
    flat_u = u.to(dev).reshape(b, H * 3)
    samples = _flat_row_gather(order[..., None], flat_u)[..., 0]
    s = _flat_row_gather(src_pts, samples).reshape(b, H, 3, 3)
    d = _flat_row_gather(dst_pts, samples).reshape(b, H, 3, 3)
    samp_valid = _flat_row_gather(corr_valid[..., None],
                                  samples)[..., 0].reshape(b, H, 3)

    es, ed = _edge_lens(s), _edge_lens(d)
    ratio_ok = torch.all((es > edge_ratio * ed) & (ed > edge_ratio * es),
                         dim=-1)
    sample_ok = ratio_ok & torch.all(samp_valid, dim=-1)
    Rs, ts, nondegen = _triad_rigid(s, d)                      # [B,H,3,3]
    sample_ok = sample_ok & nondegen

    # |R p + t - q|^2 expands into terms bilinear in per-hypothesis and
    # per-correspondence quantities: one [H,16]x[16,M] product per pair
    p2 = torch.sum(src_pts * src_pts, dim=-1)
    q2 = torch.sum(dst_pts * dst_pts, dim=-1)
    qp = dst_pts[..., :, None] * src_pts[..., None, :]         # [B,M,3,3]
    G = torch.cat([
        (p2 + q2)[:, None, :],
        torch.ones((b, 1, m), dtype=torch.float32, device=dev),
        src_pts.transpose(1, 2),
        qp.reshape(b, m, 9).transpose(1, 2),
        dst_pts.transpose(1, 2)], dim=1)                       # [B,16,M]
    tR = (ts[..., None, :] @ Rs)[..., 0, :]
    F = torch.cat([
        torch.ones((b, H, 1), dtype=torch.float32, device=dev),
        torch.sum(ts * ts, dim=-1, keepdim=True),
        2.0 * tR,
        -2.0 * Rs.reshape(b, H, 9),
        -2.0 * ts], dim=2)                                     # [B,H,16]
    err2 = torch.bmm(F, G)
    inl = (err2 < thresh2) & corr_valid[:, None, :]
    scores = inl.sum(dim=2, dtype=torch.int32) * sample_ok.int()

    best = torch.argmax(scores, dim=1)        # first index of the maximum
    ar = torch.arange(b, device=dev)
    R, t = Rs[ar, best], ts[ar, best]
    inlier_mask = inl[ar, best]

    if refine:
        R, t = weighted_procrustes(src_pts, dst_pts, inlier_mask.float())
        err2b = torch.sum((src_pts @ R.transpose(1, 2) + t[:, None, :]
                           - dst_pts) ** 2, dim=-1)
        inlier_mask = (err2b < thresh2) & corr_valid

    T = se3.make_transform(R, t)
    inliers = inlier_mask.sum(dim=1, dtype=torch.int32)
    return RansacResult(T, inliers, inlier_mask, inliers / n_valid)


def _squeeze(r: RansacResult) -> RansacResult:
    return RansacResult(*(f[0] for f in r))


def ransac_registration(src_pts: torch.Tensor, dst_pts: torch.Tensor,
                        corr_valid: Optional[torch.Tensor] = None,
                        sampler: Optional[Sampler] = None,
                        dist_thresh: float = 4.0, edge_ratio: float = 0.9,
                        num_hypotheses: int = 8192,
                        refine: bool = True) -> RansacResult:
    """src_pts/dst_pts [M,3] matched pairs (row i of src corresponds to
    row i of dst) -> the best rigid transform src -> dst, unbatched.
    Checkers: 3-point samples, edge-length ratio >= edge_ratio both ways,
    inlier distance < dist_thresh. `sampler` defaults to a
    `torch.Generator` seeded 0 on the points' device."""
    m = src_pts.shape[0]
    if corr_valid is None:
        corr_valid = torch.ones((m,), dtype=torch.bool, device=src_pts.device)
    if sampler is None:
        sampler = generator_sampler(
            torch.Generator(device=src_pts.device).manual_seed(0))
    return _squeeze(ransac_registration_batch(
        src_pts[None], dst_pts[None], corr_valid[None], sampler,
        dist_thresh=dist_thresh, edge_ratio=edge_ratio,
        num_hypotheses=num_hypotheses, refine=refine))


class AdaptiveRansacResult(NamedTuple):
    T: torch.Tensor
    inliers: torch.Tensor
    inlier_mask: torch.Tensor
    fitness: torch.Tensor
    hypotheses_consumed: int   # host int: lottery tickets actually played


def ransac_registration_adaptive(src_pts: torch.Tensor,
                                 dst_pts: torch.Tensor,
                                 corr_valid: Optional[torch.Tensor] = None,
                                 sampler: Optional[Sampler] = None,
                                 dist_thresh: float = 4.0,
                                 edge_ratio: float = 0.9,
                                 batch_hypotheses: int = 8192,
                                 max_iterations: int = 100000,
                                 confidence: float = 0.999,
                                 refine: bool = True
                                 ) -> AdaptiveRansacResult:
    """Confidence-gated RANSAC: batches of `batch_hypotheses` (one
    `ransac_registration` each, one `sampler` call each) until
    k >= log(1 - confidence) / log(1 - w^3), w the best fitness so far,
    or `max_iterations` hypotheses. The reference draws batch i with
    `fold_in(key, i)`; a test's sampler replays those draws in order."""
    m = src_pts.shape[0]
    dev = src_pts.device
    if corr_valid is None:
        corr_valid = torch.ones((m,), dtype=torch.bool, device=dev)
    if sampler is None:
        sampler = generator_sampler(torch.Generator(device=dev).manual_seed(0))
    n_valid = max(int(corr_valid.sum()), 1)

    best = None
    consumed = 0
    while consumed < max_iterations:
        r = ransac_registration(src_pts, dst_pts, corr_valid, sampler,
                                dist_thresh=dist_thresh,
                                edge_ratio=edge_ratio,
                                num_hypotheses=batch_hypotheses,
                                refine=False)
        consumed += batch_hypotheses
        if best is None or int(r.inliers) > int(best.inliers):
            best = r
        w = min(float(best.inliers) / n_valid, 1.0 - 1e-9)
        p_good = w ** 3
        if p_good >= 1.0 - 1e-12:
            break
        if p_good <= 0.0:
            continue   # zero inliers so far: no confidence bound yet
        needed = math.log(max(1.0 - confidence, 1e-300)) / math.log(
            1.0 - p_good)
        if consumed >= needed:
            break

    T, inlier_mask = best.T, best.inlier_mask
    if refine:
        src_f, dst_f = src_pts.float(), dst_pts.float()
        thresh2 = f32_square(dist_thresh)
        R, t = weighted_procrustes(src_f, dst_f, inlier_mask.float())
        err2 = torch.sum((src_f @ R.T + t - dst_f) ** 2, dim=-1)
        inlier_mask = (err2 < thresh2) & corr_valid
        T = se3.make_transform(R, t)
    inliers = inlier_mask.sum(dtype=torch.int32)
    return AdaptiveRansacResult(T, inliers, inlier_mask,
                                inliers / float(n_valid), consumed)
