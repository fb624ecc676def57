"""Exact batched 1-NN — kernel K1 (`csrc/nn1.cu`), the port of the TPU
kernel `pctpu/ops/pallas_nn.py:_nn_kernel` (`nearest_pallas`).

Distances are direct squared differences, `dx*dx + dy*dy + dz*dz + pen`
in that order (pen = 0 for a valid db point, BIG for a masked or padded
one), and the lowest index wins ties. The module name mirrors the JAX
package so the counterpart is easy to find.
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch import kernels

BIG = 1e30
DB_TILE = 2048      # plain version's db chunk (bounds its [B,M,tile] temps)
Q_CHUNK = 256       # plain version's query chunk on the CPU


def _penalty(db_mask: Optional[torch.Tensor], b: int, n: int,
             device) -> torch.Tensor:
    if db_mask is None:
        return torch.zeros((b, n), dtype=torch.float32, device=device)
    return torch.where(db_mask, 0.0, BIG).float()


def nearest_plain(query: torch.Tensor, db: torch.Tensor,
                  pen: torch.Tensor, db_tile: int = DB_TILE):
    """Plain PyTorch version of K1: query [B,M,3], db [B,N,3], pen [B,N]
    -> (d2 [B,M] f32, idx [B,M] int32). On the CPU the queries go
    Q_CHUNK at a time, so the [B,chunk,tile] temporaries stay in cache
    (each query's result is the same either way)."""
    m = query.shape[1]
    step = Q_CHUNK if query.device.type == "cpu" else max(m, 1)
    if m > step:
        parts = [nearest_plain(query[:, s:s + step], db, pen, db_tile)
                 for s in range(0, m, step)]
        return (torch.cat([p[0] for p in parts], dim=1),
                torch.cat([p[1] for p in parts], dim=1))
    b = query.shape[0]
    minv = torch.full((b, m), BIG, dtype=torch.float32, device=query.device)
    mini = torch.zeros((b, m), dtype=torch.int32, device=query.device)
    qx, qy, qz = (query[..., k:k + 1] for k in range(3))     # [B,M,1]
    for start in range(0, db.shape[1], db_tile):
        blk = db[:, start:start + db_tile]
        # ((dx*dx + dy*dy) + dz*dz) + pen, each op rounded (no FMA)
        d2 = qx - blk[:, None, :, 0]
        d2.mul_(d2)
        t = qy - blk[:, None, :, 1]
        d2.add_(t.mul_(t))
        t = torch.sub(qz, blk[:, None, :, 2], out=t)
        d2.add_(t.mul_(t))
        d2.add_(pen[:, None, start:start + db_tile])
        tmin, targ = torch.min(d2, dim=2)      # first index of the minimum
        better = tmin < minv                   # strict: earlier tile wins
        minv = torch.where(better, tmin, minv)
        mini = torch.where(better, targ.int() + start, mini)
    return minv, mini


def nn1(query: torch.Tensor, db: torch.Tensor, pen: torch.Tensor):
    """K1 wrapper: query [B,M,3] f32, db [B,N,3] f32, pen [B,N] f32 ->
    (d2 [B,M] f32, idx [B,M] int32). CPU tensors take the plain version;
    CUDA tensors launch the kernel or raise."""
    b, m, _ = query.shape
    n = db.shape[1]
    if db.shape != (b, n, 3) or pen.shape != (b, n) or query.shape[2] != 3:
        raise ValueError(f"nn1: shapes {tuple(query.shape)}, "
                         f"{tuple(db.shape)}, {tuple(pen.shape)}")
    if query.device.type == "cpu":
        return nearest_plain(query.float(), db.float(), pen.float())
    f32 = torch.float32
    kernels.require_cuda("nn1", query, db, pen, dtypes=(f32, f32, f32))
    d2 = torch.empty((b, m), dtype=f32, device=query.device)
    idx = torch.empty((b, m), dtype=torch.int32, device=query.device)
    fn = kernels.entry("nn1.cu", "pct_nn1", n_ptr=5, n_int=3)
    kernels.check(fn(query.data_ptr(), db.data_ptr(), pen.data_ptr(),
                     d2.data_ptr(), idx.data_ptr(), b, m, n,
                     kernels.stream_ptr(query.device)), "nn1")
    nn1.launches += 1
    return d2, idx


nn1.launches = 0


def nearest_batch(query: torch.Tensor, db: torch.Tensor,
                  db_mask: Optional[torch.Tensor] = None):
    """1-NN of each query in its own batch element's db: query [B,M,3],
    db [B,N,3], db_mask [B,N] -> (d2 [B,M], idx [B,M] int32). Ties go to
    the lowest index; with no valid db point d2 = BIG and idx = 0."""
    b, n = db.shape[0], db.shape[1]
    pen = _penalty(db_mask, b, n, db.device)
    return nn1(query.float().contiguous(), db.float().contiguous(),
               pen.contiguous())
