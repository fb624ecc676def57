"""Row gather and deterministic row scatter-add — kernels 13 and 14
(`csrc/gather.cu`), the port of the TPU kernels
`pctpu/ops/pallas_gather.py:_gather_kernel` (`gather_rows_pallas`) and
`_scatter_add_kernel` (`scatter_add_rows_pallas`), and the differentiable
`group_points_pallas` whose forward is kernel 13 and backward kernel 14.

Kernel 13 copies rows: out[b, i] = table[b, clip(idx[b, i], 0, N-1)].
Kernel 14 is its transpose: out[b, n] is the sum of the rows g[b, i] whose
clipped idx is n, added one by one in ascending i onto zeros, the order of
the TPU kernel's sequential loop; kernel and plain version add in that
order and agree bit for bit. Kernel 12's backward
(`ops/pallas_ballgroup.py`) is this scatter-add too.

The reference's `rows_per_step` and `interpret` arguments are TPU layout
(and its padded parking row N has no counterpart); they are accepted and
ignored.
"""
from __future__ import annotations

import torch

from pctpu_torch import kernels
from pctpu_torch.ops.gather import _flat_row_gather

# the reference's VMEM budget for a table (`table_fits`)
MAX_TABLE_BYTES = 8 * 1024 * 1024


def table_fits(table_shape, dtype_bytes: int = 4) -> bool:
    """The reference's rule for a table [.., N, C] to sit in VMEM (C padded
    to 128 lanes): N * C128 * dtype_bytes <= 8 MiB."""
    n, c = table_shape[-2], table_shape[-1]
    c_padded = ((c + 127) // 128) * 128
    return n * c_padded * dtype_bytes <= MAX_TABLE_BYTES


def _check(name: str, rows: torch.Tensor, idx: torch.Tensor) -> None:
    if (rows.dim() != 3 or idx.dim() != 2 or idx.shape[0] != rows.shape[0]
            or idx.dtype.is_floating_point):
        raise ValueError(f"{name}: rows {tuple(rows.shape)}, idx "
                         f"{tuple(idx.shape)} {idx.dtype}")


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of kernel 13: table [B,N,C], idx [B,M] ->
    [B,M,C] (`torch.gather` after clipping idx)."""
    return _flat_row_gather(table, idx)


def _launch_gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Launch kernel 13 on CUDA tensors (f32 table, int32 idx); one warp
    per output row."""
    b, n, c = table.shape
    m = idx.shape[1]
    kernels.require_cuda("gather_rows", table, idx,
                         dtypes=(torch.float32, torch.int32))
    out = torch.empty((b, m, c), dtype=torch.float32, device=table.device)
    fn = kernels.entry("gather.cu", "pct_gather_rows", n_ptr=3, n_int=4)
    kernels.check(fn(table.data_ptr(), idx.data_ptr(), out.data_ptr(), b, n,
                     m, c, kernels.stream_ptr(table.device)), "gather_rows")
    return out


def gather_rows_pallas(table: torch.Tensor, idx: torch.Tensor,
                       rows_per_step: int = 1024,
                       interpret: bool = False) -> torch.Tensor:
    """Kernel 13: table [B,N,C], idx [B,M] int -> [B,M,C], idx clipped to
    [0, N-1]. CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    _check("gather_rows", table, idx)
    table = table.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    out = _launch_gather_rows(table, idx)
    gather_rows_pallas.launches += 1
    return out


gather_rows_pallas.launches = 0


def scatter_add_rows_plain(grads: torch.Tensor, idx: torch.Tensor,
                           n: int) -> torch.Tensor:
    """Plain PyTorch version of kernel 14: grads [B,M,C], idx [B,M] -> [B,n,C].

    The same buckets as the kernel (a stable sort of the clipped idx), then
    round r adds the r-th entry of every bucket: each row receives its
    entries one at a time in ascending i, onto zeros."""
    b, m, c = grads.shape
    keys = torch.clamp(idx.long(), 0, n - 1)
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    counts = torch.zeros((b, n), dtype=torch.long, device=grads.device)
    counts.scatter_add_(1, keys, torch.ones_like(keys))
    start = torch.cumsum(counts, dim=1) - counts
    rank = (torch.arange(m, device=grads.device)
            - torch.gather(start, 1, sorted_keys)).reshape(-1)
    rows = torch.gather(grads, 1, order[..., None].expand(b, m, c))
    out = torch.zeros((b, n, c), dtype=grads.dtype, device=grads.device)
    by_rank = torch.argsort(rank, stable=True)
    sizes = torch.bincount(rank).tolist() if rank.numel() else []
    for flat in torch.split(by_rank, sizes):
        bi, j = flat // m, flat % m     # one entry per (b, bucket)
        k = sorted_keys[bi, j]
        out[bi, k] = out[bi, k] + rows[bi, j]
    return out


def _launch_scatter_add_rows(grads: torch.Tensor, idx: torch.Tensor,
                             n: int) -> torch.Tensor:
    """Launch kernel 14 on CUDA tensors (f32 grads, int32 idx): the bucket
    sort, then one warp per output row."""
    b, m, c = grads.shape
    kernels.require_cuda("scatter_add_rows", grads, idx,
                         dtypes=(torch.float32, torch.int32))
    dev = grads.device
    out = torch.empty((b, n, c), dtype=torch.float32, device=dev)
    start = torch.empty((b, n + 1), dtype=torch.int32, device=dev)
    order = torch.empty((b, m), dtype=torch.int32, device=dev)
    # counts and keys of the sort, read only when (n + m) ints are too many
    # for the kernel's shared memory
    scratch = torch.empty((b, n + m), dtype=torch.int32, device=dev)
    fn = kernels.entry("gather.cu", "pct_scatter_add_rows", n_ptr=6, n_int=4)
    kernels.check(fn(grads.data_ptr(), idx.data_ptr(), start.data_ptr(),
                     order.data_ptr(), scratch.data_ptr(), out.data_ptr(), b,
                     m, n, c, kernels.stream_ptr(dev)), "scatter_add_rows")
    return out


def scatter_add_rows_pallas(grads: torch.Tensor, idx: torch.Tensor, n: int,
                            rows_per_step: int = 1024,
                            interpret: bool = False) -> torch.Tensor:
    """Kernel 14: grads [B,M,C], idx [B,M] int -> [B,n,C] with each row
    accumulated at its (clipped) index, deterministically. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    _check("scatter_add_rows", grads, idx)
    if n < 1:
        raise ValueError(f"scatter_add_rows: n = {n}")
    grads = grads.float().contiguous()
    idx = idx.to(torch.int32).contiguous()
    if grads.device.type == "cpu":
        return scatter_add_rows_plain(grads, idx, n)
    out = _launch_scatter_add_rows(grads, idx, n)
    scatter_add_rows_pallas.launches += 1
    return out


scatter_add_rows_pallas.launches = 0


class _GroupPoints(torch.autograd.Function):
    """Forward kernel 13 on the flattened idx, backward kernel 14."""

    @staticmethod
    def forward(ctx, points, idx):
        b, m, k = idx.shape
        flat = gather_rows_pallas(points, idx.reshape(b, m * k))
        ctx.save_for_backward(idx)
        ctx.n = points.shape[1]
        return flat.reshape(b, m, k, points.shape[-1])

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        b, m, k, c = grad.shape
        return scatter_add_rows_pallas(grad.reshape(b, m * k, c),
                                       idx.reshape(b, m * k), ctx.n), None


def group_points_pallas(points: torch.Tensor, idx: torch.Tensor,
                        rows_per_step: int = 1024,
                        interpret: bool = False) -> torch.Tensor:
    """Differentiable grouping: points [B,N,C], idx [B,M,K] -> [B,M,K,C];
    forward kernel 13, backward (w.r.t. points) kernel 14."""
    if points.dim() != 3 or idx.dim() != 3 or idx.shape[0] != points.shape[0]:
        raise ValueError(f"group_points_pallas: points "
                         f"{tuple(points.shape)}, idx {tuple(idx.shape)}")
    return _GroupPoints.apply(points, idx)
