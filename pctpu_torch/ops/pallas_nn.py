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
QPT = 4             # K1's queries per thread (csrc/nn1.cu kQPT)
THREADS = 128       # K1's CTA width (csrc/nn1.cu kThreads)
CTAS_PER_SM = 16    # CTAs per SM a launch is cut into at most
MAX_SLICES = 16     # db slices at most: the merge reads a partial from each
MIN_SLICE = 128     # db points a slice keeps at least

_tickets: dict = {}


def nn1_plan(b: int, m: int, n: int, sms: int) -> dict:
    """How one K1 launch of b x m queries against b x n db points spreads
    over a card of `sms` SMs, as `csrc/nn1.cu` computes it.

    A CTA of THREADS threads holds a tile of THREADS * QPT queries and
    scans one of `slices` db slices of `slice_len` points; the grid is
    tiles x slices CTAs for each of the b batch elements. The db is cut
    into as many slices as keep the grid within CTAS_PER_SM CTAs per SM,
    at most MAX_SLICES of at least MIN_SLICE points: one slice where the
    query tiles alone fill the card that far."""
    tiles = max(1, -(-m // (THREADS * QPT)))
    slices = max(1, min(CTAS_PER_SM * sms // (b * tiles), MAX_SLICES,
                        n // MIN_SLICE))
    slice_len = -(-n // slices)
    slices = -(-n // slice_len) if n else 1
    return dict(tiles=tiles, slices=slices, slice_len=slice_len,
                grid=b * tiles * slices)


def _ticket_buffer(device: torch.device, count: int) -> torch.Tensor:
    """At least `count` int32 tickets for K1's multi-slice launches on
    `device`, zeroed once: the kernel puts each ticket back to 0."""
    buf = _tickets.get(device)
    if buf is None or buf.numel() < count:
        buf = torch.zeros(max(count, 4096), dtype=torch.int32, device=device)
        _tickets[device] = buf
    return buf


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
    dev = query.device
    d2 = torch.empty((b, m), dtype=f32, device=dev)
    idx = torch.empty((b, m), dtype=torch.int32, device=dev)
    plan = nn1_plan(b, m, n, kernels.sm_count(dev))
    parts = tickets = None
    if plan["slices"] > 1:     # partials [2, S, B, M]: d2 bits, then idx
        part = torch.empty((2, plan["slices"], b, m), dtype=torch.int32,
                           device=dev)
        parts = (part[0].data_ptr(), part[1].data_ptr())
        tickets = _ticket_buffer(dev, b * plan["tiles"]).data_ptr()
    fn = kernels.entry("nn1.cu", "pct_nn1", n_ptr=8, n_int=6)
    kernels.check(fn(query.data_ptr(), db.data_ptr(), pen.data_ptr(),
                     d2.data_ptr(), idx.data_ptr(), *(parts or (None, None)),
                     tickets, b, m, n, plan["tiles"], plan["slices"],
                     plan["slice_len"], kernels.stream_ptr(dev)), "nn1")
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


def nearest_pallas(query: torch.Tensor, db: torch.Tensor,
                   db_mask: Optional[torch.Tensor] = None,
                   query_tile: int = 512, db_tile: int = 2048,
                   interpret: bool = False):
    """The reference's single-cloud entry: query [M,3], db [N,3], db_mask
    [N] -> (d2 [M] f32, idx [M] int32), through K1 at B = 1. Ties go to
    the lowest index. `query_tile`, `db_tile` and `interpret` are the TPU
    kernel's layout; they are accepted and ignored."""
    d2, idx = nearest_batch(query[None], db[None],
                            None if db_mask is None else db_mask[None])
    return d2[0], idx[0]
