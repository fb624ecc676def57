"""Furthest-point sampling — kernels 10 and 11 (`csrc/fps.cu`), the port
of the TPU kernels `pctpu/ops/pallas_fps.py:_fps_kernel` (`fps_pallas`,
one cloud) and `_fps_kernel_batched` (`fps_pallas_batched`).

Semantics, bit for bit those of the reference: idx[0] = 0
unconditionally; `mind` starts at 1e10; each step takes the last pick's
xyz, d = (x-sx)^2 + (y-sy)^2 + (z-sz)^2 summed in that order,
mind = min(mind, d); ineligible points score -1e30; the first index
among equal maxima wins. `skip_near_origin` makes points with
|p|^2 <= 1e-3 ineligible. With fewer eligible points than m, picks
repeat, as in the reference.

Kernel 10 is kernel 11's CUDA entry launched at B = 1; each wrapper has
its own `launches` counter.
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch import kernels

NEG = -1e30
INIT_MIND = 1e10


def fps_plain(points: torch.Tensor, m: int,
              eligible: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: points [B,N,3] f32, eligible
    [B,N] bool -> idx [B,m] int32, the greedy loop one step at a time."""
    b, n, _ = points.shape
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    rows = torch.arange(b, device=points.device)
    idx = torch.zeros((b, m), dtype=torch.int32, device=points.device)
    mind = torch.full((b, n), INIT_MIND, dtype=torch.float32,
                      device=points.device)
    neg = torch.tensor(NEG, dtype=torch.float32, device=points.device)
    last = torch.zeros((b,), dtype=torch.long, device=points.device)
    for i in range(1, m):
        dx = x - x[rows, last][:, None]
        dy = y - y[rows, last][:, None]
        dz = z - z[rows, last][:, None]
        d = dx * dx + dy * dy + dz * dz
        mind = torch.minimum(mind, d)
        # torch.argmax returns the first index of the maximum
        last = torch.argmax(torch.where(eligible, mind, neg), dim=1)
        idx[:, i] = last.int()
    return idx


def _launch_fps(points: torch.Tensor, m: int,
                eligible: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/fps.cu` on CUDA tensors (the layouts of `fps_plain`)
    -> idx [B,m] int32; one CTA per cloud."""
    b, n, _ = points.shape
    kernels.require_cuda("fps", points, eligible,
                         dtypes=(torch.float32, torch.bool))
    idx = torch.empty((b, m), dtype=torch.int32, device=points.device)
    # min-distance scratch, read only when a cloud's N is too large for
    # the kernel to hold its share of `mind` in registers
    scratch = torch.empty((b, n), dtype=torch.float32, device=points.device)
    fn = kernels.entry("fps.cu", "pct_fps", n_ptr=4, n_int=3)
    kernels.check(fn(points.data_ptr(), eligible.data_ptr(), idx.data_ptr(),
                     scratch.data_ptr(), b, n, m,
                     kernels.stream_ptr(points.device)), "fps")
    return idx


def _prepare(points: torch.Tensor, mask: Optional[torch.Tensor],
             skip_near_origin: bool):
    """[B,N,3] -> (f32 contiguous points, eligible [B,N] bool)."""
    pts = points.float().contiguous()
    b, n, _ = pts.shape
    if mask is None:
        eligible = torch.ones((b, n), dtype=torch.bool, device=pts.device)
    else:
        eligible = mask.to(device=pts.device, dtype=torch.bool)
    if skip_near_origin:
        x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
        eligible = eligible & ((x * x + y * y + z * z) > 1e-3)
    return pts, eligible.contiguous()


def fps_pallas_batched(points: torch.Tensor, m: int,
                       mask: Optional[torch.Tensor] = None,
                       skip_near_origin: bool = False) -> torch.Tensor:
    """Kernel 11: [B,N,3] -> [B,m] int32, the whole batch in one launch.
    CPU tensors take the plain version; CUDA tensors launch the kernel or
    raise."""
    if points.dim() != 3 or points.shape[-1] != 3 or m < 1:
        raise ValueError(f"fps: points {tuple(points.shape)}, m={m}")
    pts, eligible = _prepare(points, mask, skip_near_origin)
    if pts.device.type == "cpu":
        return fps_plain(pts, m, eligible)
    idx = _launch_fps(pts, m, eligible)
    fps_pallas_batched.launches += 1
    return idx


fps_pallas_batched.launches = 0


def fps_pallas(points: torch.Tensor, m: int,
               mask: Optional[torch.Tensor] = None,
               skip_near_origin: bool = False) -> torch.Tensor:
    """Kernel 10: one cloud [N,3] -> idx [m] int32 (kernel 11's entry at
    B = 1). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    if points.dim() != 2 or points.shape[-1] != 3 or m < 1:
        raise ValueError(f"fps: points {tuple(points.shape)}, m={m}")
    pts, eligible = _prepare(points[None], None if mask is None
                             else mask[None], skip_near_origin)
    if pts.device.type == "cpu":
        return fps_plain(pts, m, eligible)[0]
    idx = _launch_fps(pts, m, eligible)
    fps_pallas.launches += 1
    return idx[0]


fps_pallas.launches = 0
