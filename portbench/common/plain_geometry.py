"""Plain PyTorch geometry shared by the references: a symmetric 3x3
eigensolver, the polar rotation solver and weighted Procrustes.

Frozen copies of the port's plain versions (`ops/eigh3.py`,
`register/procrustes.py`), kept here so that the benchmark's yardstick
imports nothing of the program. Every product that a float32 matmul
computes goes through `mm`, so that a reference can be run with its
matmul operands rounded to TF32 (10 mantissa bits), the precision a
Hopper tensor core takes float32 operands in: that is the control that
`correct` has to reject."""
from __future__ import annotations

import math

import torch


def f32_square(x: float) -> float:
    """float32(x) ** 2 rounded to float32: the float32 thresholds."""
    return float(torch.tensor(float(x), dtype=torch.float32) ** 2)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 explicit mantissa bits, ties
    away from zero), still stored as float32."""
    i = x.float().contiguous().view(torch.int32)
    i = (i + 0x1000) & ~0x1FFF
    return i.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """a @ b in float32; with `tf32` the operands are rounded to TF32
    first and the products summed in float32, as a tensor core does."""
    if tf32:
        a, b = tf32_round(a), tf32_round(b)
    return torch.matmul(a, b)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1,
                        a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [...,3,3], ascending (Smith's method)."""
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
    return torch.where(p2[..., None] > 0, w, torch.stack([q, q, q], dim=-1))


def _eigvec_for(A: torch.Tensor, lam: torch.Tensor):
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - lam[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01, c02, c12 = cross(r0, r1), cross(r0, r2), cross(r1, r2)
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
    """(w [...,3] ascending, V [...,3,3] eigenvectors as columns)."""
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
    alt = cross(v0, torch.where(torch.abs(v0[..., :1]) < 0.9, ex, ez + ey))
    alt = alt / torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    v2 = torch.where(norm2 > 1e-12, v2 / torch.clamp_min(norm2, 1e-30), alt)
    v1 = cross(v2, v0)
    return w, torch.stack([v0, v1, v2], dim=-1)


def _inv_transpose3(X: torch.Tensor) -> torch.Tensor:
    r0, r1, r2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
    c0, c1, c2 = cross(r1, r2), cross(r2, r0), cross(r0, r1)
    det = torch.sum(r0 * c0, dim=-1)
    safe = torch.where(torch.abs(det) > 1e-30, det,
                       torch.full_like(det, 1e-30))
    return torch.stack([c0, c1, c2], dim=-2) / safe[..., None, None]


def rotation_polar3(H: torch.Tensor, newton_iters: int = 6) -> torch.Tensor:
    """Nearest proper rotation to [...,3,3] H: scaled Newton polar
    iteration, reflection flipped along the least singular direction, a
    closed form from H^T H where H is rank-deficient."""
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
    S = Up.transpose(-1, -2) @ H
    S = 0.5 * (S + S.transpose(-1, -2))
    w, V = eigh3(S)
    B = S - w[..., 0, None, None] * eye
    adjB = torch.stack([cross(B[..., 1, :], B[..., 2, :]),
                        cross(B[..., 2, :], B[..., 0, :]),
                        cross(B[..., 0, :], B[..., 1, :])], dim=-1)
    v_min = (adjB @ V[..., :, 0:1])[..., 0]
    v_min = v_min / torch.clamp_min(
        torch.linalg.vector_norm(v_min, dim=-1, keepdim=True), 1e-30)
    flip = eye - 2.0 * v_min[..., :, None] * v_min[..., None, :]
    R_newton = torch.where((d < 0)[..., None, None], Up @ flip, Up)

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
    u0 = cross(u2, u1r)
    v0 = cross(VG[..., :, 2], VG[..., :, 1])

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
                        weights: torch.Tensor, tf32: bool = False):
    """(R, t) minimising sum_i w_i |R src_i + t - dst_i|^2 over [...,N,3]."""
    w = weights.float()
    wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-12)[..., None]
    src_c = torch.sum(src * w[..., None], dim=-2) / wsum
    dst_c = torch.sum(dst * w[..., None], dim=-2) / wsum
    a = (src - src_c[..., None, :]) * w[..., None]
    b = dst - dst_c[..., None, :]
    H = mm(b.transpose(-1, -2), a, tf32)
    R = rotation_polar3(H)
    t = dst_c - (R @ src_c[..., None])[..., 0]
    return R, t


def procrustes_from_moments(M: torch.Tensor):
    """(R, t) from the homogeneous moments [...,4,4]
    M = sum_i w_i [p_i;1][q_i;1]^T (p source, q target), polar solver."""
    sw = torch.clamp_min(M[..., 3, 3], 1e-12)[..., None]
    sp = M[..., :3, 3]
    sq = M[..., 3, :3]
    spq = M[..., :3, :3].transpose(-1, -2)
    H = spq - sq[..., :, None] * sp[..., None, :] / sw[..., None]
    R = rotation_polar3(H)
    t = sq / sw - (R @ (sp / sw)[..., None])[..., 0]
    return R, t


def make_transform(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[...,3,3] R and [...,3] t -> [...,4,4] (out of place, so it also
    runs under torch.func transforms)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    top = torch.cat([R.expand(batch + (3, 3)),
                     t.expand(batch + (3,))[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (1, 4))
    return torch.cat([top, bottom], dim=-2)


BIG = 1e30


def normals_radius(points, mask, radius, tf32=False, row_chunk=512):
    """[B,N,3], [B,N] -> [B,N,3] unit normals: the least eigenvector of the
    covariance of all radius neighbours, self included."""
    b, n, _ = points.shape
    r2 = float(radius) ** 2
    pts = torch.where(mask[..., None], points.float(),
                      torch.zeros_like(points, dtype=torch.float32))
    p2 = torch.sum(pts * pts, dim=-1)
    colpen = torch.where(mask, 0.0, BIG).float()
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    feats = torch.stack([x, y, z, x * x, y * y, z * z,
                         x * y, x * z, y * z, torch.ones_like(x)], dim=-1)
    ptsT = pts.transpose(1, 2)
    moms = []
    for s in range(0, n, row_chunk):
        q = pts[:, s:s + row_chunk]
        d2 = (p2[:, s:s + row_chunk, None] + p2[:, None, :]
              + colpen[:, None, :] - 2.0 * mm(q, ptsT, tf32))
        moms.append(mm((d2 <= r2).float(), feats, tf32))
    mom = torch.cat(moms, dim=1)
    cnt = torch.clamp_min(mom[..., 9], 1.0)
    mu = mom[..., 0:3] / cnt[..., None]
    exx = mom[..., 3:9] / cnt[..., None]
    c00 = exx[..., 0] - mu[..., 0] * mu[..., 0]
    c11 = exx[..., 1] - mu[..., 1] * mu[..., 1]
    c22 = exx[..., 2] - mu[..., 2] * mu[..., 2]
    c01 = exx[..., 3] - mu[..., 0] * mu[..., 1]
    c02 = exx[..., 4] - mu[..., 0] * mu[..., 2]
    c12 = exx[..., 5] - mu[..., 1] * mu[..., 2]
    C = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                     torch.stack([c01, c11, c12], dim=-1),
                     torch.stack([c02, c12, c22], dim=-1)], dim=-2)
    _, vecs = eigh3(C)
    nrm = vecs[..., :, 0]
    return nrm / torch.clamp_min(
        torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), 1e-12)


def point_gaps(Ta: torch.Tensor, Tb: torch.Tensor, pts: torch.Tensor,
               mask: torch.Tensor = None) -> torch.Tensor:
    """The widest distance between where two poses [...,4,4] put a
    (valid) point of the clouds [...,N,3] (m), in float64, one a cloud
    [...]."""
    D = (Ta.to(pts.device) - Tb.to(pts.device)).double()
    moved = pts.double() @ D[..., :3, :3].transpose(-1, -2) \
        + D[..., None, :3, 3]
    d = torch.linalg.vector_norm(moved, dim=-1)
    if mask is not None:
        d = torch.where(mask, d, torch.zeros_like(d))
    return torch.amax(d, dim=-1)


def point_gap(Ta: torch.Tensor, Tb: torch.Tensor, pts: torch.Tensor,
              mask: torch.Tensor = None) -> float:
    """The widest of `point_gaps` over all the clouds (m)."""
    return float(torch.max(point_gaps(Ta, Tb, pts, mask)))
