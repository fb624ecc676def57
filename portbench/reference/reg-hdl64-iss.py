"""Plain reference of the `reg-hdl64-iss` chain: `reference/reg-hdl64.py`'s
voxel grid, FPFH-33, mutual matching, RANSAC and two ICP stages, loaded
by path, with matching and RANSAC restricted to each voxel cloud's ISS
keypoints, as `register_pairs` runs them with `keypoints="iss"`.

`iss` is written from Intrinsic Shape Signatures (Zhong, ICCV Workshops
2009) and PCL's `ISSKeypoint3D`, with the PCL wrapper's defaults (salient
radius 3 m, non-max radius 2 m, gamma21 = gamma32 = 0.975, 5
neighbours). For each valid point p_i:
  - its neighbours N(i): the valid points within the salient radius, the
    point itself included, from a full distance matrix;
  - each neighbour's weight w_j = 1 / |N(j)|;
  - the weighted scatter about p_i,
    S_i = sum_j w_j (p_j - p_i)(p_j - p_i)^T / sum_j w_j;
  - its eigenvalues l1 >= l2 >= l3 by `torch.linalg.eigvalsh`, the
    scatter formed and solved in float64 (as PCL does): on flat ground a
    scatter's l3 lies ~1e-8 below its l1, under float32's rounding, and
    its sign decides the candidate test;
  - a candidate iff l2 < gamma21 l1, l3 < gamma32 l2, l3 > 0 and
    |N(i)| >= min_neighbors;
  - kept iff no candidate within the non-max radius has a larger l3, or
    an equal l3 at a lower index.

Plain PyTorch in float32 (TF32 off; the scatter and its eigenvalues in
float64), on whatever device the tensors live, importing nothing of the
program. The squared distances are |q|^2 + |p|^2 - 2 q.p, as the chain's
other stages form them. Every float32 product a matmul computes goes
through `plain_geometry.mm`, so `tf32=True` runs `iss` with its matmul
operands rounded to TF32: the control; there the scatter's offsets enter
its float64 sums rounded to TF32, as a tensor core would take them.

Departures from the published detector:
  - ISS runs on the capped voxel cloud (2 m voxels, at most
    `downsample_capacity` of them), as `register_pairs` does, not on the
    raw scan;
  - at most the `k_cap` (64) closest neighbours enter a scatter, lowest
    index first on ties; PCL has no cap;
  - the neighbour count is tested in the salient radius only, and a tie
    in l3 inside the non-max radius goes to the lowest index (PCL keeps
    every tied maximum)."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from portbench.common.plain_geometry import f32_square, mm, tf32_round

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

BIG = 1e30


def _load_batched_reference():
    path = Path(__file__).with_name("reg-hdl64.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_reference_reg_hdl64_for_iss", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_batched = _load_batched_reference()
# the shared chain, under the names the cell code calls
voxel_capped = _batched.voxel_capped
voxels = _batched.voxels
fpfh = _batched.fpfh
match = _batched.match
ransac = _batched.ransac
icp = _batched.icp
refine_inputs = _batched.refine_inputs
_rows = _batched._rows


def _sqdist(points, col_mask, tf32):
    """[N,3] -> [N,N] squared distances |q|^2 + |p|^2 - 2 q.p in float32,
    clamped at 0; columns outside `col_mask` read BIG."""
    p2 = torch.sum(points * points, dim=-1)
    d2 = torch.clamp_min(p2[:, None] + p2[None, :]
                         - 2.0 * mm(points, points.T, tf32), 0.0)
    return torch.where(col_mask[None, :], d2, torch.full_like(d2, BIG))


def iss(points, mask, salient_radius, nonmax_radius, gamma21, gamma32,
        min_neighbors, k_cap, tf32=False):
    """One cloud [N,3], mask [N] -> the ISS keypoint mask [N] (module
    docstring)."""
    p = points.float()
    n = p.shape[0]
    d2 = _sqdist(p, mask, tf32)
    within = d2 <= f32_square(salient_radius)
    count = within.sum(dim=1)
    near = torch.sort(torch.where(within, d2, torch.full_like(d2, BIG)),
                      dim=1, stable=True)
    idx = near.indices[:, :k_cap]
    member = near.values[:, :k_cap] < BIG
    w = 1.0 / torch.clamp_min(count.double(), 1.0)
    wj = torch.where(member, w[idx], torch.zeros_like(idx, dtype=w.dtype))
    d = p[idx] - p[:, None, :]                                   # [N,K,3]
    d = (tf32_round(d) if tf32 else d).double()
    scatter = (d * wj[..., None]).transpose(1, 2) @ d
    scatter = scatter / torch.clamp_min(wj.sum(dim=1), 1e-12)[:, None, None]
    ev = torch.linalg.eigvalsh(scatter)                          # ascending
    l1, l2, l3 = ev[:, 2], ev[:, 1], ev[:, 0]
    cand = (mask & (count >= min_neighbors) & (l2 < gamma21 * l1)
            & (l3 < gamma32 * l2) & (l3 > 0))
    rivals = _sqdist(p, cand, tf32) <= f32_square(nonmax_radius)
    ids = torch.arange(n, device=p.device)
    beaten = rivals & ((l3[None, :] > l3[:, None])
                       | ((l3[None, :] == l3[:, None])
                          & (ids[None, :] < ids[:, None])))
    return cand & ~beaten.any(dim=1)
