"""Neighbour-search benchmark CLI (port of `pctpu/pipelines/nn_benchmark.py`).

Re-design of `Kdtree_Octree/lesson2/benchmark.py:16-142`, with its
transpose bug fixed (`:27` feeds 3xN into N x 3 consumers): times the
port's `knn`, `radius_search` and `nearest` (K1 on the card) on a KITTI
scan, beside the native C++ KD-tree and octree, scipy's `cKDTree` and
numpy brute force, printing one ms row each. Device times are host-clock
times around a call that ends in `torch.cuda.synchronize`.

    python -m pctpu_torch.pipelines.nn_benchmark [--bin PATH] [--n N]
        [--k K] [--radius R] [--queries Q] [--device cpu]

Without --bin (or when its file is missing) it prints a note and uses a
synthetic uniform cloud of 124,668 points in an 80 m cube.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def _host():
    """The host-side rows need no sync."""


def _timed(fn, sync=_host):
    """(result, ms) of one call of fn, synchronised by `sync`."""
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bin", default=None,
                    help="KITTI velodyne .bin (default: a synthetic cloud)")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--radius", type=float, default=1.0)
    ap.add_argument("--queries", type=int, default=8192)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from pctpu_torch.core.io import read_velodyne_bin
    from pctpu_torch.device import resolve_device
    from pctpu_torch.native import spatial
    from pctpu_torch.ops.knn import knn, nearest, radius_search

    dev = resolve_device(args.device)
    if args.bin and os.path.exists(args.bin):
        pts = read_velodyne_bin(args.bin)  # (N,3): the transpose bug fixed
    else:
        print(f"note: {args.bin or 'no --bin given'}"
              f"{' not found' if args.bin else ''}; using a synthetic "
              "uniform cloud")
        pts = np.random.default_rng(0).uniform(
            -40, 40, (124668, 3)).astype(np.float32)
    rng = np.random.default_rng(0)
    sel = rng.choice(pts.shape[0], min(args.n, pts.shape[0]), replace=False)
    db = pts[sel]
    q = db[: args.queries]
    dbt, qt = torch.from_numpy(db).to(dev), torch.from_numpy(q).to(dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    print(f"db={db.shape[0]} queries={q.shape[0]} k={args.k} "
          f"radius={args.radius} device={dev}")

    # the port: each call once to warm up, then timed
    ours = (("knn", lambda: knn(qt, dbt, args.k)),
            ("radius", lambda: radius_search(qt, dbt, args.radius, 64)),
            ("1-NN", lambda: nearest(qt, dbt)))
    for name, fn in ours:
        _timed(fn, sync)
        _, ms = _timed(fn, sync)
        print(f"{'pctpu_torch ' + name + ':':22s}{ms:8.1f} ms")

    # native C++ trees (host side; comparison counters like result_set.py:59)
    kd, ms = _timed(lambda: spatial.KDTree(db))
    print(f"{'c++ kd build:':22s}{ms:8.1f} ms ({kd.node_count} nodes)")
    (_, _, cmp), ms = _timed(lambda: kd.knn(q, args.k))
    print(f"{'c++ kd knn:':22s}{ms:8.1f} ms ({cmp.mean():.0f} cmp/query)")
    _, ms = _timed(lambda: kd.radius(q, args.radius, cap=64))
    print(f"{'c++ kd radius:':22s}{ms:8.1f} ms")
    oc, ms = _timed(lambda: spatial.Octree(db))
    print(f"{'c++ oct build:':22s}{ms:8.1f} ms ({oc.node_count} nodes)")
    (_, _, cmp), ms = _timed(lambda: oc.knn(q, args.k))
    print(f"{'c++ oct knn:':22s}{ms:8.1f} ms ({cmp.mean():.0f} cmp/query)")
    _, ms = _timed(lambda: oc.radius(q, args.radius, cap=64, fast=True))
    print(f"{'c++ oct radius:':22s}{ms:8.1f} ms (contains() fast path)")

    # scipy
    from scipy.spatial import cKDTree
    tree, ms = _timed(lambda: cKDTree(db))
    print(f"{'scipy build:':22s}{ms:8.1f} ms")
    _, ms = _timed(lambda: tree.query(q, k=args.k))
    print(f"{'scipy knn:':22s}{ms:8.1f} ms")
    _, ms = _timed(lambda: tree.query_ball_point(q, args.radius))
    print(f"{'scipy radius:':22s}{ms:8.1f} ms")

    # brute force numpy (the reference's oracle, benchmark.py:65-69), on
    # 256 queries, extrapolated
    qb = q[:256]

    def brute():
        d = ((qb[:, None, :] - db[None]) ** 2).sum(-1)
        return np.argsort(d, axis=1)
    _, ms = _timed(brute)
    print(f"{'numpy brute:':22s}{ms * q.shape[0] / qb.shape[0]:8.1f} ms "
          "(extrapolated)")


if __name__ == "__main__":
    main()
