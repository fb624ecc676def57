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
its own `launches` counter. `fps_plan` picks a launch's CTA width and
where the kernel keeps each cloud.
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch import kernels

NEG = -1e30
INIT_MIND = 1e10

# the kernel's limits (csrc/fps.cu): a CTA of up to MAX_THREADS threads
# per cloud; a thread holds PER points (a template constant); the points'
# xyz and `mind` take 4 registers a point, and a CTA spends at most
# REG_BUDGET registers on them; a cloud's xyz fits shared memory up to
# SMEM_POINTS_MAX bytes
MAX_THREADS = 1024
PER_CHOICES = (1, 2, 4, 8, 16)
REG_BUDGET = 32768
SMEM_POINTS_MAX = 200 * 1024
# the CTA width: the power of two that gives each thread about
# POINTS_PER_THREAD points, within [MIN_THREADS, WIDE_THREADS], wider only
# where a thread would hold more than 16 points. Fastest at every path's
# shape in tools/fps_k8_sweep.py (H100 80GB HBM3, 700 W): a wider CTA
# adds to the step's fixed barrier and reduction (0.15 us at 128 threads,
# 0.25 at 1,024), more points a thread add to its serial argmax
MIN_THREADS, WIDE_THREADS = 128, 256
POINTS_PER_THREAD = 4
# where the kernel keeps a cloud (the C entry's `mode`): xyz and mind in
# registers; mind in registers, xyz read from shared memory; mind in a
# global scratch row, xyz in shared memory; both in global memory
MODES = ("registers", "shared", "scratch", "global")


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


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, x - 1).bit_length()


def fps_plan(b: int, n: int, m: int, sms: int,
             threads: Optional[int] = None) -> Optional[dict]:
    """The launch of `b` clouds of `n` points, `m` picks each, on a card
    of `sms` SMs: one CTA of `threads` threads per cloud (by default the
    power of two near n / POINTS_PER_THREAD, within [MIN_THREADS,
    WIDE_THREADS], doubled up to MAX_THREADS while a thread would hold
    more than 16 points); thread t owns points t, t + threads, ..., `per` of
    them (a power of two), and `mode` says where they live: "registers"
    when their xyz and mind fit REG_BUDGET, else "shared" (xyz read from
    shared memory each step) while per <= 16 and the cloud fits
    SMEM_POINTS_MAX, else "scratch" (mind in a global row, per 0) or, past
    shared memory, "global". None for a width the kernel does not take."""
    if threads is None:
        threads = min(WIDE_THREADS, max(MIN_THREADS, _pow2_at_least(
            -(-n // POINTS_PER_THREAD))))
        while n > PER_CHOICES[-1] * threads and threads < MAX_THREADS:
            threads *= 2
    elif threads % 32 or not 32 <= threads <= MAX_THREADS:
        return None
    per = _pow2_at_least(-(-n // threads))
    fits_smem = 12 * n <= SMEM_POINTS_MAX
    if per <= PER_CHOICES[-1] and fits_smem:
        mode = "registers" if 4 * per * threads <= REG_BUDGET else "shared"
    else:
        mode, per = ("scratch" if fits_smem else "global"), 0
    return dict(threads=threads, per=per, mode=mode, ctas=b,
                sms_busy=min(b, sms), steps=max(m - 1, 0),
                smem_bytes=12 * n if fits_smem else 0)


def _launch_fps(points: torch.Tensor, m: int, eligible: torch.Tensor,
                plan: Optional[dict] = None) -> torch.Tensor:
    """Launch `csrc/fps.cu` on CUDA tensors (the layouts of `fps_plain`)
    -> idx [B,m] int32: one CTA per cloud, shaped by `plan` (default
    `fps_plan`)."""
    b, n, _ = points.shape
    kernels.require_cuda("fps", points, eligible,
                         dtypes=(torch.float32, torch.bool))
    if plan is None:
        plan = fps_plan(b, n, m, kernels.sm_count(points.device))
    idx = torch.empty((b, m), dtype=torch.int32, device=points.device)
    # `mind` rows, read only in the "scratch" and "global" modes
    scratch = torch.empty((b, n) if plan["per"] == 0 else (1,),
                          dtype=torch.float32, device=points.device)
    fn = kernels.entry("fps.cu", "pct_fps", n_ptr=4, n_int=6)
    kernels.check(fn(points.data_ptr(), eligible.data_ptr(), idx.data_ptr(),
                     scratch.data_ptr(), b, n, m, plan["threads"],
                     plan["per"], MODES.index(plan["mode"]),
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
