"""Pose-graph optimization, Gauss-Newton over SE(3) (port of
`pctpu/parallel/posegraph.py`, the single-device solvers).

Residual per edge (i, j, T_meas): r = [Log_SO3(R_err), t_err] of
T_err = T_meas^-1 . T_i^-1 . T_j, with the poses perturbed on the RIGHT
(body frame), so Jacobian entries stay O(1) however far the trajectory
drifts from the origin. The [6,6] Jacobian blocks of every edge come from
`torch.func.jacfwd` at the tangent origin, under `torch.func.vmap`.

`optimize_pose_graph` assembles the dense [6M,6M] normal equations and
fixes the gauge with a 1e6 prior on pose 0; `optimize_pose_graph_sparse`
keeps H as pose blocks (D [M,6,6] and one [6,6] block per edge), fixes the
gauge by eliminating pose 0, and solves by block-Jacobi preconditioned CG
with iterative refinement; `optimize_pose_graph_sparse_f64` runs that in
float64. Every solve is `solve_ex` / `inv_ex`, which do not wait on the
host to check their result.

The edge-sharded steps split the edge list over the ranks of a mesh:
`make_sharded_pose_graph_step` sums each rank's dense H and b with one
`all_reduce` each; `make_sharded_pose_graph_step_sparse` sums the pose
blocks D and b once, then one [M,6] vector every CG iteration. The CG's
host look at its convergence flag reads values that every rank computes
from the same all-reduced sums, so all ranks leave the loop together.

The solvers run on CUDA unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from pctpu_torch.core import se3
from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.parallel.mesh import Mesh, all_reduce, shard_batch
from pctpu_torch.register.icp import _so3_exp

# CG: how often (in iterations) the host looks at the convergence flag;
# the iterations after convergence are masked, so the result is the
# reference's while loop's whatever this is
_CG_CHECK_EVERY = 32


def _f32(x: float) -> float:
    return float(np.float32(x))


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,3] rotation vector (w/2 below theta = 1e-6).
    On that branch the arccos is taken of a safe input, so no infinite
    forward-mode tangent is formed at the identity (arccos'(1) = -inf).
    The scalars keep a trailing axis: forward-mode AD of a 0-dim tensor
    combined with a Python float promotes the tangent to float64."""
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    cos_t = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    small = torch.arccos(cos_t) < 1e-6
    theta = torch.arccos(torch.where(small, torch.zeros_like(cos_t), cos_t))
    w = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    scale = torch.where(small, torch.full_like(theta, 0.5),
                        theta / (2.0 * torch.sin(theta)))
    return w * scale


def _exp6(d: torch.Tensor) -> torch.Tensor:
    """[...,6] tangent (omega, v) -> [...,4,4] Exp."""
    return se3.make_transform(_so3_exp(d[..., :3]), d[..., 3:])


def _edge_residual(eps_i, eps_j, T_i, T_j, T_meas_inv):
    Ti = T_i @ _exp6(eps_i)
    Tj = T_j @ _exp6(eps_j)
    T_err = T_meas_inv @ se3.invert_transform(Ti) @ Tj
    return torch.cat([so3_log(T_err[:3, :3]), T_err[:3, 3]])


class PoseGraphResult(NamedTuple):
    poses: torch.Tensor     # [M,4,4]
    final_cost: torch.Tensor
    iters: torch.Tensor


def _edge_terms(poses, edges_i, edges_j, T_meas_inv, weights,
                robust_delta: Optional[float] = None,
                robust_kernel: str = "geman"):
    """Per-edge residuals and Jacobian blocks: (r [E,6], Ji [E,6,6],
    Jj [E,6,6]), each scaled by sqrt(w_eff). `robust_delta` enables an
    IRLS M-estimator: 'huber' w = min(1, delta/||r||), or 'geman'
    (Geman-McClure, redescending) w = (1 + ||r||^2/delta^2)^-2."""
    zero = torch.zeros((6,), dtype=poses.dtype, device=poses.device)

    def one(Ti, Tj, Tmi):
        f_i = lambda e: _edge_residual(e, zero, Ti, Tj, Tmi)   # noqa: E731
        f_j = lambda e: _edge_residual(zero, e, Ti, Tj, Tmi)   # noqa: E731
        return (f_i(zero), torch.func.jacfwd(f_i)(zero),
                torch.func.jacfwd(f_j)(zero))

    r, Ji, Jj = torch.func.vmap(one)(poses[edges_i.long()],
                                     poses[edges_j.long()], T_meas_inv)
    w = weights
    if robust_delta is not None:
        rn2 = torch.sum(r * r, dim=-1)
        delta = _f32(robust_delta)
        if robust_kernel == "huber":
            w = w * torch.clamp_max(
                delta / torch.clamp_min(torch.sqrt(rn2), 1e-12), 1.0)
        else:                                  # geman-mcclure
            w = w / (1.0 + rn2 / _f32(delta * delta)) ** 2
    sw = torch.sqrt(w)
    return r * sw[:, None], Ji * sw[:, None, None], Jj * sw[:, None, None]


def _assemble(m, edges_i, edges_j, r, Ji, Jj):
    """Scatter-add the normal equations: H [6m,6m], b [6m]."""
    dt, dev = Ji.dtype, Ji.device
    JiTJi = torch.einsum("eab,eac->ebc", Ji, Ji)
    JjTJj = torch.einsum("eab,eac->ebc", Jj, Jj)
    JiTJj = torch.einsum("eab,eac->ebc", Ji, Jj)
    bi = -torch.einsum("eab,ea->eb", Ji, r)
    bj = -torch.einsum("eab,ea->eb", Jj, r)
    six = torch.arange(6, device=dev)
    ri = edges_i.long()[:, None] * 6 + six[None, :]               # [E,6]
    rj = edges_j.long()[:, None] * 6 + six[None, :]
    H = torch.zeros((6 * m * 6 * m,), dtype=dt, device=dev)
    for rows, cols, vals in ((ri, ri, JiTJi), (rj, rj, JjTJj),
                             (ri, rj, JiTJj), (rj, ri, JiTJj.transpose(1, 2))):
        flat = rows[:, :, None] * (6 * m) + cols[:, None, :]
        H.index_add_(0, flat.reshape(-1), vals.reshape(-1))
    b = torch.zeros((6 * m,), dtype=dt, device=dev)
    b.index_add_(0, ri.reshape(-1), bi.reshape(-1))
    b.index_add_(0, rj.reshape(-1), bj.reshape(-1))
    return H.reshape(6 * m, 6 * m), b


def _delta_k(robust_delta, robust_warmup, k):
    """The GNC schedule: delta * 2^max(0, warmup - k), in float32."""
    if robust_delta is None:
        return None
    return _f32(np.float32(robust_delta)
                * np.exp2(np.float32(max(0, robust_warmup - k))))


def _retract(poses, dx):
    """poses [M,4,4] . Exp(dx [M,6])."""
    return poses @ _exp6(dx)


def _graph_inputs(poses, edges_i, edges_j, T_meas, weights, dt):
    dev = poses.device
    edges_i = torch.as_tensor(edges_i, device=dev).long()
    edges_j = torch.as_tensor(edges_j, device=dev).long()
    T_meas = torch.as_tensor(T_meas, device=dev).to(dt)
    if weights is None:
        weights = torch.ones(edges_i.shape, dtype=dt, device=dev)
    return (edges_i, edges_j, se3.invert_transform(T_meas),
            torch.as_tensor(weights, device=dev).to(dt))


def optimize_pose_graph(poses: torch.Tensor, edges_i, edges_j, T_meas,
                        weights=None, iters: int = 10,
                        damping: float = 1e-6, gauge_weight: float = 1e6,
                        robust_delta: Optional[float] = None,
                        robust_kernel: str = "geman",
                        robust_warmup: int = 0,
                        device: DeviceLike = None) -> PoseGraphResult:
    """poses [M,4,4]; edges (i [E], j [E], T_meas [E,4,4]) with T_meas ~
    T_i^-1 T_j -> optimized poses (pose 0 held by the gauge prior), by
    `iters` Gauss-Newton steps on the dense [6M,6M] system.

    `robust_warmup` > 0 enables graduated non-convexity: the robust scale
    starts at delta * 2^warmup and halves each step until it reaches
    delta, so closures that contradict the accumulated drift are not
    crushed by the redescending kernel at the first step."""
    poses = torch.as_tensor(poses).to(resolve_device(device)).float()
    m = poses.shape[0]
    ei, ej, Tmi, w = _graph_inputs(poses, edges_i, edges_j, T_meas, weights,
                                   torch.float32)
    cost = torch.zeros((), dtype=torch.float32, device=poses.device)
    eye = torch.eye(6 * m, dtype=torch.float32, device=poses.device)
    for k in range(iters):
        r, Ji, Jj = _edge_terms(poses, ei, ej, Tmi, w,
                                _delta_k(robust_delta, robust_warmup, k),
                                robust_kernel)
        H, b = _assemble(m, ei, ej, r, Ji, Jj)
        H = H + torch.diag(torch.cat([
            torch.full((6,), gauge_weight, device=poses.device),
            torch.zeros((6 * m - 6,), device=poses.device)]))
        H = H + damping * eye
        dx = torch.linalg.solve_ex(H, b)[0].reshape(m, 6)
        poses = _retract(poses, dx)
        cost = torch.sum(r * r)
    return PoseGraphResult(poses, cost, torch.tensor(iters, dtype=torch.int32))


def _pose_blocks(m, edges_i, edges_j, r, Ji, Jj, damping):
    """Block normal equations: D [M,6,6] diagonal blocks, Bij [E,6,6]
    coupling blocks (H[i,j] = Bij, H[j,i] = Bij^T), b [M,6]."""
    JiTJi = torch.einsum("eab,eac->ebc", Ji, Ji)
    JjTJj = torch.einsum("eab,eac->ebc", Jj, Jj)
    Bij = torch.einsum("eab,eac->ebc", Ji, Jj)
    D = torch.zeros((m, 6, 6), dtype=Ji.dtype, device=Ji.device)
    D.index_add_(0, edges_i, JiTJi)
    D.index_add_(0, edges_j, JjTJj)
    D = D + damping * torch.eye(6, dtype=Ji.dtype, device=Ji.device)
    b = torch.zeros((m, 6), dtype=Ji.dtype, device=Ji.device)
    b.index_add_(0, edges_i, -torch.einsum("eab,ea->eb", Ji, r))
    b.index_add_(0, edges_j, -torch.einsum("eab,ea->eb", Jj, r))
    return D, Bij, b


def _project0(v):
    """Zero the pose-0 block: restrict to the gauge-fixed subspace."""
    return torch.cat([torch.zeros_like(v[:1]), v[1:]])


def _bs_matvec(D, edges_i, edges_j, Bij, x):
    """Block-sparse H @ x: x [M,6] -> [M,6]."""
    y = torch.einsum("mab,mb->ma", D, x)
    y = y.index_add(0, edges_i, torch.einsum("eab,eb->ea", Bij, x[edges_j]))
    return y.index_add(0, edges_j,
                       torch.einsum("eba,eb->ea", Bij, x[edges_i]))


def _pcg(matvec, Minv, b, cg_iters: int, tol: float = 1e-8):
    """Conjugate gradient under the block preconditioner Minv [M,6,6] on
    the gauge-fixed subspace. The reference's while loop stops once
    |r|^2 <= tol |b|^2; here every iteration past that point is masked
    (the state stops changing), and the host reads the flag only every
    `_CG_CHECK_EVERY` iterations to end the loop early."""
    def apply_M(v):
        return _project0(torch.einsum("mab,mb->ma", Minv, v))

    b = _project0(b)
    x = torch.zeros_like(b)
    r = b
    p = apply_M(r)
    rz = torch.sum(r * p)
    thresh = tol * torch.clamp_min(torch.sum(b * b), 1e-30)
    active = torch.ones((), dtype=torch.bool, device=b.device)
    for k in range(cg_iters):
        active = active & (torch.sum(r * r) > thresh)
        if k % _CG_CHECK_EVERY == _CG_CHECK_EVERY - 1 and not bool(active):
            break
        Ap = _project0(matvec(_project0(p)))
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = apply_M(r_n)
        rz_n = torch.sum(r_n * z)
        p_n = z + rz_n / torch.clamp_min(rz, 1e-30) * p
        x, r, p, rz = (torch.where(active, new, old) for new, old in
                       ((x_n, x), (r_n, r), (p_n, p), (rz_n, rz)))
    return x


def _pcg_refined(matvec, Minv, b, cg_iters: int, refine: int = 2):
    """f32 CG stalls at a roundoff floor on ill-conditioned chains;
    iterative refinement (re-solve against the true residual) recovers
    it."""
    x = _pcg(matvec, Minv, b, cg_iters)
    for _ in range(refine):
        r = _project0(b) - _project0(matvec(_project0(x)))
        x = x + _pcg(matvec, Minv, r, cg_iters)
    return x


def optimize_pose_graph_sparse(poses: torch.Tensor, edges_i, edges_j,
                               T_meas, weights=None, iters: int = 10,
                               cg_iters: int = 100, damping: float = 1e-6,
                               refine: int = 2,
                               robust_delta: Optional[float] = None,
                               robust_kernel: str = "geman",
                               robust_warmup: int = 0,
                               device: DeviceLike = None) -> PoseGraphResult:
    """Block-sparse Gauss-Newton: the problem of `optimize_pose_graph`
    in O(M+E) memory, for graphs beyond ~100 poses. The gauge is fixed by
    eliminating pose 0. The dtype follows the poses: float64 poses give
    the float64 solve."""
    poses = torch.as_tensor(poses).to(resolve_device(device))
    dt = torch.float64 if poses.dtype == torch.float64 else torch.float32
    poses = poses.to(dt)
    m = poses.shape[0]
    ei, ej, Tmi, w = _graph_inputs(poses, edges_i, edges_j, T_meas, weights,
                                   dt)
    cost = torch.zeros((), dtype=dt, device=poses.device)
    for k in range(iters):
        r, Ji, Jj = _edge_terms(poses, ei, ej, Tmi, w,
                                _delta_k(robust_delta, robust_warmup, k),
                                robust_kernel)
        D, Bij, b = _pose_blocks(m, ei, ej, r, Ji, Jj, damping)
        Minv = torch.linalg.inv_ex(D)[0]
        dx = _pcg_refined(lambda x: _bs_matvec(D, ei, ej, Bij, x), Minv, b,
                          cg_iters, refine=refine)
        poses = _retract(poses, dx)
        cost = torch.sum(r * r)
    return PoseGraphResult(poses, cost, torch.tensor(iters, dtype=torch.int32))


def optimize_pose_graph_sparse_f64(poses, edges_i, edges_j, T_meas,
                                   weights=None, device: DeviceLike = None,
                                   **kw) -> PoseGraphResult:
    """The block-sparse solve in native float64, returning float32 poses:
    at 1000-keyframe conditioning f32 CG's step error (~cond(H) eps_f32
    |x|) reaches decimetres."""
    dev = resolve_device(device)
    res = optimize_pose_graph_sparse(
        torch.as_tensor(poses).to(dev).double(), edges_i, edges_j,
        torch.as_tensor(T_meas).to(dev).double(),
        weights=None if weights is None else torch.as_tensor(
            weights).to(dev).double(), device=dev, **kw)
    return PoseGraphResult(res.poses.float(), res.final_cost.float(),
                           res.iters)


def _edge_shard(mesh: Mesh, edge_axis: str, dev, poses, edges_i, edges_j,
                T_meas_inv, weights):
    """The poses (replicated) and this rank's contiguous block of the edge
    arrays (E must divide by the axis size), as float32 on `dev`."""
    shard = shard_batch(mesh, edge_axis)
    poses = torch.as_tensor(poses).to(dev).float()
    ei, ej, Tmi, w = (torch.as_tensor(shard.take(x)).to(dev)
                      for x in (edges_i, edges_j, T_meas_inv, weights))
    return poses, ei.long(), ej.long(), Tmi.float(), w.float()


def make_sharded_pose_graph_step_sparse(mesh: Mesh, edge_axis: str = "data",
                                        cg_iters: int = 100,
                                        device: DeviceLike = None):
    """Edge-sharded block-sparse Gauss-Newton step: step(poses, edges_i,
    edges_j, T_meas_inv, weights) -> new poses [M,4,4]. Each rank builds
    the pose blocks of its edges with damping 1e-6 / W, so the summed D
    carries the one-rank damping; D and b are all-reduced once, and every
    CG matvec adds D x / W to the rank's coupling blocks and all-reduces
    the [M,6] result. Pad the edge list to a multiple of W with weight-0
    edges at (0, 0). Every rank passes the whole edge list. Runs on CUDA
    unless `device="cpu"` is asked for."""
    dev = resolve_device(device)
    w = mesh.shape[edge_axis]
    group = mesh.group(edge_axis)
    wt = torch.tensor(float(w), device=dev)   # a true division on the card

    def step(poses, edges_i, edges_j, T_meas_inv, weights):
        poses, ei, ej, Tmi, wts = _edge_shard(mesh, edge_axis, dev, poses,
                                              edges_i, edges_j, T_meas_inv,
                                              weights)
        m = poses.shape[0]
        r, Ji, Jj = _edge_terms(poses, ei, ej, Tmi, wts)
        D, Bij, b = _pose_blocks(m, ei, ej, r, Ji, Jj, 1e-6 / w)
        D, b = all_reduce(D, group), all_reduce(b, group)
        Minv = torch.linalg.inv_ex(D)[0]

        def matvec(x):
            # D is replicated after the sum: each rank adds 1/W of D x, so
            # the sum restores it; the coupling blocks are the rank's own
            y = torch.einsum("mab,mb->ma", D, x) / wt
            y = y.index_add(0, ei, torch.einsum("eab,eb->ea", Bij, x[ej]))
            y = y.index_add(0, ej, torch.einsum("eba,eb->ea", Bij, x[ei]))
            return all_reduce(y, group)

        return _retract(poses, _pcg_refined(matvec, Minv, b, cg_iters,
                                            refine=2))
    return step


def make_sharded_pose_graph_step(mesh: Mesh, edge_axis: str = "data",
                                 device: DeviceLike = None):
    """Edge-sharded dense Gauss-Newton step: step(poses, edges_i, edges_j,
    T_meas_inv, weights) -> new poses [M,4,4]. Each rank assembles H and b
    over its edges, both are all-reduced, and the 1e6 gauge prior on pose
    0, the 1e-6 damping and the solve run replicated. Pad the edge list to
    a multiple of W with weight-0 edges. Every rank passes the whole edge
    list. Runs on CUDA unless `device="cpu"` is asked for."""
    dev = resolve_device(device)
    group = mesh.group(edge_axis)

    def step(poses, edges_i, edges_j, T_meas_inv, weights):
        poses, ei, ej, Tmi, wts = _edge_shard(mesh, edge_axis, dev, poses,
                                              edges_i, edges_j, T_meas_inv,
                                              weights)
        m = poses.shape[0]
        r, Ji, Jj = _edge_terms(poses, ei, ej, Tmi, wts)
        H, b = _assemble(m, ei, ej, r, Ji, Jj)
        H, b = all_reduce(H, group), all_reduce(b, group)
        H = H + torch.diag(torch.cat([
            torch.full((6,), 1e6, device=dev),
            torch.zeros((6 * m - 6,), device=dev)]))
        H = H + 1e-6 * torch.eye(6 * m, dtype=torch.float32, device=dev)
        dx = torch.linalg.solve_ex(H, b)[0].reshape(m, 6)
        return _retract(poses, dx)
    return step
