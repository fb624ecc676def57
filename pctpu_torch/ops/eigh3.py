"""Closed-form symmetric 3x3 eigendecomposition, batched (port of
`pctpu/ops/eigh3.py`).

Eigenvalues: Smith's trigonometric method on the characteristic cubic
(arccos of the normalised determinant). Eigenvectors: the largest cross
product of rows of (A - lam I), with orthonormal completion on
(near-)degenerate eigenvalues."""
from __future__ import annotations

import math

import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, in the reference's term order."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [...,3,3], ascending, [...,3]."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp_min(p2 / 6.0, 0.0))
    safe_p = torch.where(p > 0, p, torch.ones_like(p))
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detB / (2.0 * safe_p ** 3), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    w = torch.stack([e_lo, e_mid, e_hi], dim=-1)
    return torch.where(p2[..., None] > 0, w,
                       torch.stack([q, q, q], dim=-1))


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor):
    """Null-space direction of (A - lam I) via row cross products."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - lam[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = _cross(r0, r1)
    c02 = _cross(r0, r2)
    c12 = _cross(r1, r2)
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best12 = (n12 >= n01) & (n12 >= n02)
    best02 = (~best12) & (n02 >= n01)
    v = torch.where(best12[..., None], c12,
                    torch.where(best02[..., None], c02, c01))
    n = torch.where(best12, n12, torch.where(best02, n02, n01))
    return v, n


def eigh3(A: torch.Tensor, degeneracy_eps: float = 1e-20):
    """Full eigendecomposition of symmetric [...,3,3]: (w [...,3]
    ascending, V [...,3,3] with eigenvectors as COLUMNS)."""
    w = eigvalsh3(A)
    v0, n0 = _eigvec_for(A, w[..., 0])
    v2, n2 = _eigvec_for(A, w[..., 2])

    scale = torch.clamp_min(torch.amax(torch.abs(w), dim=-1), 1.0) ** 4
    ok0 = n0 > degeneracy_eps * scale
    ok2 = n2 > degeneracy_eps * scale

    def axis(vals):
        return torch.tensor(vals, dtype=A.dtype,
                            device=A.device).expand(v0.shape)

    ex, ey, ez = axis([1.0, 0.0, 0.0]), axis([0.0, 1.0, 0.0]), \
        axis([0.0, 0.0, 1.0])
    v0 = torch.where(ok0[..., None], v0, ex)
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)

    v2 = torch.where(ok2[..., None], v2, ez)
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    norm2 = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    alt = _cross(v0, torch.where(torch.abs(v0[..., :1]) < 0.9, ex, ez + ey))
    alt = alt / torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    v2 = torch.where(norm2 > 1e-12, v2 / torch.clamp_min(norm2, 1e-30), alt)

    v1 = _cross(v2, v0)
    return w, torch.stack([v0, v1, v2], dim=-1)
