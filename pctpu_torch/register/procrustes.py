"""Weighted Procrustes (port of `pctpu/register/procrustes.py`), batched
over leading axes.

Rotations come from the Higham-scaled Newton polar iteration with the
adjugate reflection flip; a rank-deficient H falls back to the closed
form from the eigensystem of H^T H. Only `procrustes_from_moments`'
`solver="svd"` takes a 3x3 `torch.linalg.svd`, as the reference leaves
its SVD to XLA."""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.core import se3
from pctpu_torch.ops.eigh3 import _cross, eigh3


def _inv_transpose3(X: torch.Tensor) -> torch.Tensor:
    """X^{-T} of [...,3,3] via the cofactor matrix: its rows are cross
    products of the other two rows of X, over det."""
    r0, r1, r2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    c0 = _cross(r1, r2)
    c1 = _cross(r2, r0)
    c2 = _cross(r0, r1)
    det = torch.sum(r0 * c0, dim=-1)
    safe = torch.where(torch.abs(det) > 1e-30, det,
                       torch.full_like(det, 1e-30))
    return torch.stack([c0, c1, c2], dim=-2) / safe[..., None, None]


def rotation_polar3(H: torch.Tensor, newton_iters: int = 6) -> torch.Tensor:
    """Nearest proper rotation to [...,3,3] H (the Procrustes R)."""
    eye = torch.eye(3, dtype=H.dtype, device=H.device)
    H = H / torch.clamp_min(torch.linalg.matrix_norm(H), 1e-30)[..., None,
                                                               None]
    X = H
    for _ in range(newton_iters):
        Xit = _inv_transpose3(X)
        g = torch.sqrt(torch.sqrt(
            torch.sum(Xit * Xit, dim=(-2, -1))
            / torch.clamp_min(torch.sum(X * X, dim=(-2, -1)), 1e-30)))
        X = 0.5 * (g[..., None, None] * X + (1.0 / g)[..., None, None] * Xit)
    Up = X
    d = torch.linalg.det(Up)
    # S = Up^T H is SPD (= V diag(s) V^T); its least eigenvector is the
    # smallest-singular direction of H
    S = Up.transpose(-1, -2) @ H
    S = 0.5 * (S + S.transpose(-1, -2))
    w, V = eigh3(S)
    # one adjugate inverse-iteration polish of the least eigenvector
    B = S - w[..., 0, None, None] * eye
    adjB = torch.stack([_cross(B[..., 1, :], B[..., 2, :]),
                        _cross(B[..., 2, :], B[..., 0, :]),
                        _cross(B[..., 0, :], B[..., 1, :])], dim=-1)
    v_min = (adjB @ V[..., :, 0:1])[..., 0]
    v_min = v_min / torch.clamp_min(
        torch.linalg.vector_norm(v_min, dim=-1, keepdim=True), 1e-30)
    flip = eye - 2.0 * v_min[..., :, None] * v_min[..., None, :]
    R_newton = torch.where((d < 0)[..., None, None], Up @ flip, Up)

    # rank-deficient fallback: closed form from eigh3 of H^T H
    G = H.transpose(-1, -2) @ H
    wG, VG = eigh3(0.5 * (G + G.transpose(-1, -2)))
    order = torch.argsort(wG, dim=-1, stable=True)
    wG = torch.gather(wG, -1, order)
    VG = torch.gather(VG, -1, order[..., None, :].expand(VG.shape))
    s = torch.sqrt(torch.clamp_min(wG, 0.0))
    u2 = (H @ VG[..., :, 2:3])[..., 0] / torch.clamp_min(s[..., 2:3], 1e-30)
    u1r = (H @ VG[..., :, 1:2])[..., 0] / torch.clamp_min(s[..., 1:2], 1e-30)
    u1r = u1r - torch.sum(u1r * u2, dim=-1, keepdim=True) * u2
    u1r = u1r / torch.clamp_min(
        torch.linalg.vector_norm(u1r, dim=-1, keepdim=True), 1e-30)
    u0 = _cross(u2, u1r)
    v0 = _cross(VG[..., :, 2], VG[..., :, 1])

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    R_rank2 = (outer(u2, VG[..., :, 2]) + outer(u1r, VG[..., :, 1])
               + outer(u0, v0))
    rank_lt2 = (s[..., 2] < 0.1) | (s[..., 1] <= 1e-3 * s[..., 2])
    R_fallback = torch.where(rank_lt2[..., None, None], eye.expand_as(H),
                             R_rank2)
    degenerate = s[..., 0] < 2e-3 * torch.clamp_min(s[..., 2], 1e-30)
    bad = ~torch.all(torch.isfinite(R_newton).flatten(-2), dim=-1)
    return torch.where((degenerate | bad)[..., None, None], R_fallback,
                       R_newton)


def weighted_procrustes(src: torch.Tensor, dst: torch.Tensor,
                        weights: Optional[torch.Tensor] = None):
    """(R, t) minimising sum_i w_i ||R src_i + t - dst_i||^2.
    src, dst [...,N,3]; weights [...,N] (>= 0) -> (R [...,3,3], t [...,3]).
    Always a proper rotation (polar solver)."""
    if weights is None:
        weights = torch.ones(src.shape[:-1], dtype=torch.float32,
                             device=src.device)
    w = weights.float()
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-12)[..., None]
    src_c = torch.sum(src * w[..., None], dim=-2) / wsum
    dst_c = torch.sum(dst * w[..., None], dim=-2) / wsum
    a = (src - src_c[..., None, :]) * w[..., None]
    b = dst - dst_c[..., None, :]
    H = b.transpose(-1, -2) @ a          # sum w (dst-dc)(src-sc)^T
    R = rotation_polar3(H)
    t = dst_c - (R @ src_c[..., None])[..., 0]
    return R, t


def procrustes_from_moments(M: torch.Tensor, allow_reflection: bool = False,
                            solver: str = "svd"):
    """Rigid alignment from the homogeneous moment matrix [...,4,4]
    M = sum_i w_i [p_i;1][q_i;1]^T (p = src, q = dst) -> (R, t).
    H = sum w q p^T - Sq Sp^T / Sw. solver: 'polar' (`rotation_polar3`,
    always a proper rotation) or 'svd' (with the det-sign correction
    unless `allow_reflection`)."""
    if solver not in ("polar", "svd"):
        raise ValueError(f"solver {solver!r}: expected 'polar' or 'svd'")
    sw = torch.clamp_min(M[..., 3, 3], 1e-12)[..., None]
    sp = M[..., :3, 3]
    sq = M[..., 3, :3]
    spq = M[..., :3, :3].transpose(-1, -2)      # sum w q p^T
    src_c = sp / sw
    dst_c = sq / sw
    H = spq - sq[..., :, None] * sp[..., None, :] / sw[..., None]
    if solver == "polar":
        R = rotation_polar3(H)
    else:
        U, _, Vt = torch.linalg.svd(H)
        R = U @ Vt
        if not allow_reflection:
            d = torch.linalg.det(R)
            S = torch.diag_embed(torch.stack(
                [torch.ones_like(d), torch.ones_like(d), d], dim=-1))
            R = U @ S @ Vt
    t = dst_c - (R @ src_c[..., None])[..., 0]
    return R, t


def procrustes_transform(src: torch.Tensor, dst: torch.Tensor,
                         weights: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """`weighted_procrustes` as a [...,4,4] homogeneous transform."""
    R, t = weighted_procrustes(src, dst, weights)
    return se3.make_transform(R, t)
