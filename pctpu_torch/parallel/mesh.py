"""Process meshes over `torch.distributed` (port of `pctpu/parallel/mesh.py`):
the port's communication layer.

One process per rank. A `Mesh` lays the ranks of the current world out
row-major over named axes, as the reference's `jax.sharding.Mesh` lays out
its devices, and holds one process group per axis slice. The reference's
collectives map to:

  psum      -> `all_reduce` (sum), `AllReduceSum.apply` where a gradient
               flows;
  ppermute  -> `ring_shift`, a `batch_isend_irecv` ring;
  P(axis)   -> `shard_batch(mesh, axis)`: this rank's contiguous block of
               the leading axis; the results come back by `all_gather`;
  P()       -> `replicated(mesh)`: a copy broadcast from the axis' first
               rank.

**The backend follows the device:** gloo for CPU tensors, NCCL for CUDA
tensors with one rank per card (`backend_for`). A caller may name gloo for
CUDA tensors, for instance to put several ranks on one card, which NCCL
refuses. gloo's CUDA support differs between collectives and builds
(point-to-point takes CPU tensors only), so under gloo every transfer of a
CUDA tensor is staged through host memory, here and nowhere else
(`_staged`): the tensor is copied to the host, the collective runs there,
and the result is copied back. Only the transfer moves; the compute stays
on the card. Under NCCL nothing is staged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from pctpu_torch.device import DeviceLike, resolve_device


def backend_for(device: DeviceLike = None) -> str:
    """The backend that follows the device: "nccl" for CUDA (the default
    device, which raises without a card), "gloo" for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def multihost_init(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   device: DeviceLike = None) -> None:
    """Join this process to the world (`jax.distributed.initialize`'s
    counterpart): `init_process_group` at `tcp://coordinator` ("host:port")
    with `num_processes` ranks as rank `process_id`, or, when all three are
    None, from the environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE,
    RANK). The backend follows `device` (`backend_for`)."""
    given = (coordinator, num_processes, process_id)
    if any(v is None for v in given) and any(v is not None for v in given):
        raise ValueError("multihost_init: give coordinator, num_processes "
                         "and process_id together, or none of them")
    backend = backend_for(device)
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Ranks 0..W-1 laid out row-major over `axis_names` with sizes
    `shape[name]` (W = the world size). `groups[name]` is the process
    group of this rank's slice along that axis (`dist.group.WORLD` when
    the axis spans the world)."""
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    groups: Dict[str, dist.ProcessGroup]
    coords: Dict[str, int]

    def group(self, axis: str):
        return self.groups[axis]

    def axis_index(self, axis: str) -> int:
        """This rank's position along `axis` (`jax.lax.axis_index`)."""
        return self.coords[axis]


def make_mesh(axes: Sequence[Tuple[str, int]] = (("data", -1),)) -> Mesh:
    """A mesh over the current world from (axis_name, size) pairs, -1 for
    the ranks that remain, e.g. make_mesh((("pair", 2), ("point", 2))).
    Every rank must call it, in the same order as its other calls that
    make groups: each axis slice gets a group unless it spans the whole
    world. The sizes must multiply to the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(multihost_init or launch.run_world)")
    world, rank = dist.get_world_size(), dist.get_rank()
    names = tuple(a for a, _ in axes)
    sizes = [int(s) for _, s in axes]
    if sizes.count(-1) > 1:
        raise ValueError("make_mesh: at most one axis may be -1")
    if -1 in sizes:
        known = int(np.prod([s for s in sizes if s != -1]))
        sizes[sizes.index(-1)] = world // known
    if int(np.prod(sizes)) != world:
        raise ValueError(f"make_mesh: axes {dict(zip(names, sizes))} do "
                         f"not cover the world of {world} ranks")
    grid = np.arange(world).reshape(sizes)
    pos = np.unravel_index(rank, sizes)
    groups = {}
    for ax, name in enumerate(names):
        if sizes[ax] == world:
            groups[name] = dist.group.WORLD
            continue
        lines = np.moveaxis(grid, ax, -1).reshape(-1, sizes[ax])
        for line in lines:              # every rank makes every group
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[name] = g
    return Mesh(names, dict(zip(names, sizes)), groups,
                {n: int(p) for n, p in zip(names, pos)})


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group, copy: bool = False
            ) -> Tuple[torch.Tensor, bool]:
    """The buffer a collective moves `t` in: its host copy when `t` is a
    CUDA tensor and the group's backend gloo (see the module docstring),
    else `t` itself (a copy with `copy`, for a collective that writes its
    buffer); and whether it was staged."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu().contiguous(), True
    if copy:
        return t.clone(memory_format=torch.contiguous_format), False
    return t.contiguous(), False


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of `t` over the group, as a new tensor (psum)."""
    buf, staged = _staged(t, group, copy=True)
    dist.all_reduce(buf, group=group)
    return buf.to(t.device) if staged else buf


class AllReduceSum(torch.autograd.Function):
    """psum with a gradient: the sum over the group forward, and the sum of
    the incoming gradients over the group backward (every rank's loss
    reads the replicated sum, so each input's gradient is the sum of
    theirs)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t, group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' tensors of one shape, concatenated along the leading axis
    in rank order (the global array of a P(axis)-sharded one)."""
    buf, staged = _staged(t, group)
    parts = [torch.empty_like(buf) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, buf, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if staged else out


def broadcast(t: torch.Tensor, group=None) -> torch.Tensor:
    """The group's first rank's `t` on every rank, as a new tensor."""
    buf, staged = _staged(t, group, copy=True)
    dist.broadcast(buf, src=dist.get_global_rank(group or dist.group.WORLD,
                                                 0), group=group)
    return buf.to(t.device) if staged else buf


def ring_shift(t: torch.Tensor, step: int, group=None) -> torch.Tensor:
    """ppermute over the ring j -> (j + step) % W: every rank sends `t` to
    the rank `step` after it and returns what the rank `step` before it
    sent (`t` itself in a world of one)."""
    w = dist.get_world_size(group)
    if w == 1:
        return t.clone()
    me = dist.get_rank(group)
    group = group or dist.group.WORLD

    def glob(r):
        return dist.get_global_rank(group, r)
    buf, staged = _staged(t, group)
    out = torch.empty_like(buf)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, buf, glob((me + step) % w), group),
        dist.P2POp(dist.irecv, out, glob((me - step) % w), group)])
    for r in reqs:
        r.wait()
    return out.to(t.device) if staged else out


# ---------------------------------------------------------------------------
# shardings
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BatchShard:
    """P(axis): `take(x)` is this rank's contiguous block of x's leading
    axis (its length must divide by the axis size); `gather(y)` puts the
    blocks back together on every rank."""
    mesh: Mesh
    axis: str

    def rows(self, n: int) -> slice:
        w = self.mesh.shape[self.axis]
        if n % w:
            raise ValueError(f"leading axis {n} does not divide by the "
                             f"{self.axis!r} axis size {w}")
        i, per = self.mesh.axis_index(self.axis), n // w
        return slice(i * per, (i + 1) * per)

    def take(self, x):
        return x[self.rows(x.shape[0])]

    def gather(self, y: torch.Tensor) -> torch.Tensor:
        return all_gather(y, self.mesh.group(self.axis))


@dataclasses.dataclass(frozen=True)
class Replicated:
    """P(): `take(x)` is rank 0's x on every rank of the mesh."""
    mesh: Mesh

    def take(self, x: torch.Tensor) -> torch.Tensor:
        return broadcast(x, dist.group.WORLD)


def shard_batch(mesh: Mesh, axis: str = "data") -> BatchShard:
    return BatchShard(mesh, axis)


def replicated(mesh: Mesh) -> Replicated:
    return Replicated(mesh)

