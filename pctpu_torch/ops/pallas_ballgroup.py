"""Fused ball query + grouping — kernel 12 (`csrc/ballgroup.cu`), the port
of the forward pass of the TPU kernel
`pctpu/ops/pallas_ballgroup.py:_ballgroup_kernel` (`ball_group_pallas`,
`ball_group_pallas_batched`), shaped by `ball_group_plan`.

For each centre: the first `nsample` point indices in index order with
d^2 < r^2 (strict, r^2 = float32(radius)^2), slots past the hit count
repeating the first hit; the rows of `packed` at those indices, copied
exactly, with the centre subtracted from the leading 3 (xyz) channels
when `sub_xyz`. The distance is the TPU kernel's own expansion,
d2 = (b2 + c2) - 2 * cross with b2 = x*x + y*y + z*z, c2 likewise and
cross = (x*cx + y*cy) + z*cz, written out elementwise in that order in
both the kernel and its plain version, so they round alike.

An empty ball (not reachable from the model, whose centres are FPS picks
of the same cloud) follows `ops/ball_query.py`'s contract: idx 0, row
`packed[0]` minus the centre. The TPU kernel there returns the sum of all
rows instead (ROADMAP, queue C).

The backward pass mirrors the reference's VJP (`_bg_bwd`, `_bgb_bwd`),
the selection held constant: d_packed is the deterministic scatter-add of
the cotangent over the emitted idx, kernel 14's entry
(`ops/pallas_gather.py:scatter_add_rows_pallas`, or its plain version on
CPU tensors), and d_centers = -(the cotangent's xyz channels summed over
the nsample slots) when `sub_xyz`, else zeros. Each is computed only when
its input needs a gradient.
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch import kernels
from pctpu_torch.core.cloud import round_up
from pctpu_torch.device import f32_square
from pctpu_torch.ops import pallas_gather
from pctpu_torch.ops.gather import group_points

BIG = 1e30
NO_HIT = 2**30
CENTER_CHUNK = 128   # plain version's centre chunk (bounds [B,chunk,N])

# the kernel's launch (csrc/ballgroup.cu): CTAs of THREADS_MIN to
# THREADS_MAX threads, one warp a centre; the cloud, padded to a whole scan
# step of SCAN_STEP candidates, staged as 16-byte (x, y, z, b2) points in
# shared memory ("shared") or read from device memory ("global"); each
# warp's nsample slots (4 B each) and STATIC_SMEM bytes of the kernel's
# own in shared memory. An H100 gives a block SMEM_BLOCK bytes of shared
# memory and an SM SMEM_SM, less CTA_RESERVED a CTA, and at most
# SM_THREADS threads
THREADS_MIN, THREADS_MAX, SCAN_STEP, STATIC_SMEM = 128, 1024, 128, 16
SMEM_BLOCK, SMEM_SM, CTA_RESERVED, SM_THREADS = 232448, 233472, 1024, 2048
MODES = ("shared", "global")


def ball_group_plain(centers: torch.Tensor, packed: torch.Tensor,
                     radius: float, nsample: int,
                     points_mask: Optional[torch.Tensor] = None,
                     sub_xyz: bool = True):
    """Plain PyTorch version of kernel 12: centers [B,M,3], packed
    [B,N,C] (xyz first), points_mask [B,N] or None -> (grouped
    [B,M,nsample,C] f32, idx [B,M,nsample] int32)."""
    r2 = f32_square(radius)
    n = packed.shape[1]
    x, y, z = packed[..., 0], packed[..., 1], packed[..., 2]   # [B,N]
    b2 = x * x + y * y + z * z
    if points_mask is not None:
        b2 = torch.where(points_mask, b2, BIG)
    x, y, z, b2 = x[:, None], y[:, None], z[:, None], b2[:, None]
    cols = torch.arange(n, device=packed.device)
    slot = torch.arange(nsample, device=packed.device)
    idxs = []
    for s in range(0, centers.shape[1], CENTER_CHUNK):
        c = centers[:, s:s + CENTER_CHUNK]
        cx, cy, cz = c[..., 0:1], c[..., 1:2], c[..., 2:3]      # [B,m,1]
        c2 = cx * cx + cy * cy + cz * cz
        cross = x * cx + y * cy + z * cz                        # [B,m,N]
        within = (b2 + c2) - 2.0 * cross < r2
        masked = torch.where(within, cols, NO_HIT)
        if n < nsample:
            masked = torch.nn.functional.pad(masked, (0, nsample - n),
                                             value=NO_HIT)
        top = torch.topk(masked, nsample, dim=-1, largest=False).values
        cnt = within.sum(dim=-1)
        first = torch.where(cnt > 0, top[..., 0], 0)
        filled = slot < torch.clamp(cnt, max=nsample)[..., None]
        idxs.append(torch.where(filled, top, first[..., None]))
    idx = torch.cat(idxs, dim=1).int()
    grouped = group_points(packed, idx)
    if sub_xyz:
        grouped = torch.cat([grouped[..., :3] - centers[:, :, None, :],
                             grouped[..., 3:]], dim=-1)
    return grouped, idx


def ball_group_plan(b: int, m: int, n: int, c: int, k: int, sms: int,
                    mode: Optional[str] = None,
                    threads: Optional[int] = None) -> Optional[dict]:
    """The kernel's launch for `b` clouds of `n` points x `c` channels,
    `m` centres each, nsample `k`, on a card of `sms` SMs. CTAs of
    `threads` threads, one warp a centre: by default a warp for each of an
    SM's share of the centres, as a power of two within [THREADS_MIN,
    THREADS_MAX] threads (the widest CTA the card can fill ran fastest in
    tools/k7_k12_sweep.py). Each CTA takes a chunk of `centres`
    centres of one cloud, `ctas_per_cloud` of them, as many as fill one
    wave of the card (the CTAs an SM holds at once by threads and shared
    memory, times `sms`) while every warp has a centre. The cloud lives in
    shared memory where it and the slots fit a block (`smem_bytes`), else
    in device memory ("global"); rows go out as 16-byte stores where
    k * c % 4 == 0, else 4-byte ones (`store_bytes`). `mode` and
    `threads` force their choice; None for a choice the kernel cannot
    take at this shape."""
    if threads is None:
        per_sm = -(-b * m // sms)
        threads = min(THREADS_MAX,
                      max(THREADS_MIN, 32 << (per_sm.bit_length() - 1)))
    elif threads % 32 or not 32 <= threads <= THREADS_MAX:
        return None
    warps = threads // 32
    slots = warps * k * 4 + STATIC_SMEM
    cloud = round_up(n, SCAN_STEP) * 16
    fits = cloud + slots <= SMEM_BLOCK
    if mode is None:
        mode = "shared" if fits else "global"
    if mode not in MODES or not (fits or mode == "global") \
            or slots > SMEM_BLOCK:
        return None
    smem = slots + (cloud if mode == "shared" else 0)
    resident = max(1, min(SM_THREADS // threads,
                          SMEM_SM // (smem + CTA_RESERVED)))
    per_cloud = max(1, min(-(-m // warps), resident * sms // b))
    centres = -(-m // per_cloud)
    per_cloud = -(-m // centres)
    return dict(threads=threads, centres=centres, ctas_per_cloud=per_cloud,
                ctas=b * per_cloud, mode=mode, smem_bytes=smem,
                store_bytes=16 if k * c % 4 == 0 else 4, sms=sms)


def _launch_ball_group(centers: torch.Tensor, packed: torch.Tensor,
                       radius: float, nsample: int,
                       points_mask: Optional[torch.Tensor] = None,
                       sub_xyz: bool = True, plan: Optional[dict] = None):
    """Launch `csrc/ballgroup.cu` on CUDA tensors (the arguments and
    results of `ball_group_plain`), shaped by `plan` (default
    `ball_group_plan`)."""
    b, m, _ = centers.shape
    n, c = packed.shape[1], packed.shape[2]
    f32 = torch.float32
    kernels.require_cuda("ball_group", centers, packed, dtypes=(f32, f32))
    if points_mask is not None:
        kernels.require_cuda("ball_group", points_mask, dtypes=(torch.bool,))
    dev = packed.device
    if plan is None:
        plan = ball_group_plan(b, m, n, c, nsample, kernels.sm_count(dev))
        if plan is None:
            raise ValueError(f"ball_group: nsample {nsample} is past the "
                             "kernel's shared memory")
    out = torch.empty((b, m, nsample, c), dtype=f32, device=dev)
    idx = torch.empty((b, m, nsample), dtype=torch.int32, device=dev)
    fn = kernels.entry("ballgroup.cu", "pct_ball_group", n_ptr=5, n_int=10,
                       n_float=1)
    kernels.check(fn(centers.data_ptr(), packed.data_ptr(),
                     None if points_mask is None else points_mask.data_ptr(),
                     out.data_ptr(), idx.data_ptr(), b, m, n, c, nsample,
                     int(sub_xyz), plan["threads"], plan["centres"],
                     MODES.index(plan["mode"]), plan["store_bytes"] // 4,
                     f32_square(radius), kernels.stream_ptr(dev)),
                  "ball_group")
    return out, idx


class _BallGroup(torch.autograd.Function):
    """Kernel 12 (or its plain version) forward; the reference's VJP."""

    @staticmethod
    def forward(ctx, centers, packed, radius, nsample, points_mask, sub_xyz):
        args = (centers, packed, radius, nsample, points_mask, sub_xyz)
        if packed.device.type == "cpu":
            grouped, idx = ball_group_plain(*args)
        else:
            grouped, idx = _launch_ball_group(*args)
            ball_group.launches += 1
        ctx.mark_non_differentiable(idx)
        ctx.save_for_backward(idx)
        ctx.n, ctx.sub_xyz = packed.shape[1], sub_xyz
        return grouped, idx

    @staticmethod
    def backward(ctx, ct, _):
        (idx,) = ctx.saved_tensors
        b, m, k, c = ct.shape
        d_centers = d_packed = None
        if ctx.needs_input_grad[1]:
            d_packed = pallas_gather.scatter_add_rows_pallas(
                ct.reshape(b, m * k, c), idx.reshape(b, m * k), ctx.n)
        if ctx.needs_input_grad[0]:
            d_centers = (-ct[..., :3].sum(dim=2) if ctx.sub_xyz else
                         ct.new_zeros((b, m, 3)))
        return d_centers, d_packed, None, None, None, None


def ball_group(centers: torch.Tensor, packed: torch.Tensor, radius: float,
               nsample: int, points_mask: Optional[torch.Tensor] = None,
               sub_xyz: bool = True):
    """Kernel 12: centers [B,M,3], packed [B,N,C] (C >= 3, xyz first),
    points_mask [B,N] or None -> (grouped [B,M,nsample,C] f32, idx
    [B,M,nsample] int32), differentiable in centers and packed. CPU
    tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    b, m, three = centers.shape
    if (three != 3 or packed.dim() != 3 or packed.shape[0] != b
            or packed.shape[2] < 3 or packed.shape[1] < 1 or nsample < 1):
        raise ValueError(f"ball_group: centers {tuple(centers.shape)}, "
                         f"packed {tuple(packed.shape)}, nsample {nsample}")
    return _BallGroup.apply(
        centers.float().contiguous(), packed.float().contiguous(), radius,
        nsample, None if points_mask is None else points_mask.contiguous(),
        sub_xyz)


ball_group.launches = 0


def ball_group_pallas(centers: torch.Tensor, packed: torch.Tensor,
                      radius: float = 1.0, nsample: int = 32,
                      sub_xyz: bool = True) -> torch.Tensor:
    """centers [M,3], packed [N,3+C] (xyz first) -> grouped
    [M,nsample,3+C], equal to group_points(packed, ball_query(...)[0])
    with the relative-xyz subtraction; differentiable w.r.t. packed and
    centers (the selection held constant). (The reference's `tile` and
    `interpret` arguments are TPU layout and have no counterpart.)"""
    return ball_group(centers[None], packed[None], radius, nsample,
                      sub_xyz=sub_xyz)[0][0]


def ball_group_pallas_batched(centers: torch.Tensor, packed: torch.Tensor,
                              radius: float, nsample: int,
                              sub_xyz: bool = True) -> torch.Tensor:
    """[B,M,3] x [B,N,3+C] -> [B,M,nsample,3+C], differentiable as
    `ball_group_pallas`."""
    return ball_group(centers, packed, radius, nsample, sub_xyz=sub_xyz)[0]
