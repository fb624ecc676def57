"""Start a world of ranks on this host and run one function in each.

`run_world(fn, world, backend, device, *args)` spawns `world` processes
(the `spawn` start method: each imports afresh, so `fn` and its module
must be importable and import no JAX), joins them in one process group
through a `file://` store in a temporary directory (no TCP port to
collide with another world on the host), runs `fn(*args)` in each with
the rank's device set, and returns rank 0's result, moved to the host.
A rank that raises, dies or outlives `timeout` fails the whole run: the
other ranks, which may be waiting in a collective, are killed and the
first rank's traceback is raised.

On the CPU each rank runs torch on one thread, so a world of W ranks
takes W cores. On CUDA rank r computes on card r modulo the cards present:
NCCL needs a card per rank; gloo may put several ranks on one card.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import queue
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

from pctpu_torch.parallel.mesh import backend_for
from pctpu_torch.device import DeviceLike, resolve_device


def _to_host(x):
    """Tensors in nested tuples, lists and dicts moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, tuple):                       # a NamedTuple
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank, world, backend, device_type, store, fn, args, out):
    try:
        if device_type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            res = fn(*args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, pickle.dumps(_to_host(res))))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise


def run_world(fn: Callable, world: int, backend: Optional[str] = None,
              device: DeviceLike = None, *args,
              timeout: float = 600.0) -> Any:
    """fn(*args) in each of `world` ranks -> rank 0's result. `backend`
    defaults to the device's (`mesh.backend_for`: NCCL on CUDA, which is
    the default device and raises without a card; gloo on the CPU).
    Raises RuntimeError when a rank fails or `timeout` seconds pass."""
    dev = resolve_device(device)
    backend = backend or backend_for(dev)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="pctpu_world_") as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, backend, dev.type, store, fn,
                                   args, out))
                 for r in range(world)]
        for p in procs:
            p.start()
        results, failures, grace = {}, [], None
        deadline = time.monotonic() + timeout
        try:
            # after the first failure, wait a moment for the others' reports:
            # the first to arrive may be from a rank that lost its peer
            while len(results) + len(failures) < world:
                if grace is not None and time.monotonic() > grace:
                    break
                try:
                    rank, ok, payload = out.get(timeout=0.5)
                except queue.Empty:
                    if grace is None:
                        dead = [r for r, p in enumerate(procs)
                                if p.exitcode not in (None, 0)]
                        if dead:
                            failures.append(f"rank {dead[0]} exited with "
                                            f"code {procs[dead[0]].exitcode}")
                        elif time.monotonic() > deadline:
                            failures.append(
                                f"timed out after {timeout:.0f} s with "
                                f"{len(results)} of {world} ranks done")
                        if failures:
                            grace = time.monotonic() + 2.0
                    continue
                if ok:
                    results[rank] = payload
                else:
                    failures.append(f"rank {rank} raised:\n{payload}")
                    grace = grace or time.monotonic() + 2.0
        finally:
            for p in procs:
                if not failures:
                    p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
    if failures:
        raise RuntimeError(f"run_world({world}, {backend}): "
                           + "\n".join(failures))
    return pickle.loads(results[0])
