"""Host-side spatial index: native C++ KD-tree and octree over ctypes
(port of `pctpu/native/spatial.py`, on its own copy of `spatial.cpp`).

The parity layer for the reference's from-scratch trees and result sets:
query results come back as fixed-shape arrays plus per-query true
neighbour counts and distance-comparison counters (the reference's
`KNNResultSet.comparison_counter`). These trees are for the host side
(grouping, benchmarking, ad-hoc queries); the card's path is
`pctpu_torch.ops` (brute force, K1, grid-hash buckets).

The library is built at first use by `pctpu_torch.native`; a failed build
raises. Unlike the reference there is no scipy fallback, so `native` is
always true and the counters are always counted.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from pctpu_torch import native as _native

_i32p = ctypes.POINTER(ctypes.c_int32)
_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_long)


def get_lib() -> ctypes.CDLL:
    """The spatial library, built on first use (raises if it cannot be)."""
    lib = _native.load("spatial")
    lib.kdtree_build.restype = ctypes.c_void_p
    lib.kdtree_build.argtypes = [_f32p, ctypes.c_long, ctypes.c_int]
    lib.kdtree_free.argtypes = [ctypes.c_void_p]
    lib.kdtree_node_count.restype = ctypes.c_long
    lib.kdtree_node_count.argtypes = [ctypes.c_void_p]
    lib.kdtree_knn.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_long,
                               ctypes.c_int, _i32p, _f32p, _i64p,
                               ctypes.c_int]
    lib.kdtree_radius.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_long,
                                  ctypes.c_float, ctypes.c_int, _i32p, _f32p,
                                  _i32p, _i64p, ctypes.c_int]
    lib.octree_build.restype = ctypes.c_void_p
    lib.octree_build.argtypes = [_f32p, ctypes.c_long, ctypes.c_int,
                                 ctypes.c_float]
    lib.octree_free.argtypes = [ctypes.c_void_p]
    lib.octree_node_count.restype = ctypes.c_long
    lib.octree_node_count.argtypes = [ctypes.c_void_p]
    lib.octree_knn.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_long,
                               ctypes.c_int, _i32p, _f32p, _i64p,
                               ctypes.c_int]
    lib.octree_radius.argtypes = [ctypes.c_void_p, _f32p, ctypes.c_long,
                                  ctypes.c_float, ctypes.c_int, _i32p, _f32p,
                                  _i32p, _i64p, ctypes.c_int, ctypes.c_int]
    return lib


def available() -> bool:
    """Whether the spatial library builds and loads here; the trees raise
    where it does not."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _as_f32_c(x: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(x)[:, :3], np.float32)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"expected (N,3) points, got {a.shape}")
    return a


class _TreeBase:
    """Shared query plumbing; subclasses set the native symbol prefix and
    build the tree (`_h`) over the points `_setup` returns (the build
    copies them)."""

    _prefix = ""
    _h = None

    def _setup(self, points: np.ndarray, leaf_size: int) -> np.ndarray:
        self._lib = get_lib()
        pts = _as_f32_c(points)
        self.n, self.leaf_size = pts.shape[0], leaf_size
        if self.n == 0:
            raise ValueError("cannot build a tree over no points")
        return pts

    def __del__(self):
        if self._h:
            getattr(self._lib, self._prefix + "_free")(self._h)
            self._h = None

    @property
    def native(self) -> bool:
        return self._h is not None

    @property
    def node_count(self) -> int:
        return int(getattr(self._lib, self._prefix + "_node_count")(self._h))

    def knn(self, queries: np.ndarray, k: int, n_threads: int = 8
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """k nearest neighbours. Returns (idx [Q,k], dist2 [Q,k],
        comparisons [Q]); idx -1 (dist2 inf) where fewer than k points
        exist."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        q = _as_f32_c(queries)
        nq = q.shape[0]
        idx = np.empty((nq, k), np.int32)
        d2 = np.empty((nq, k), np.float32)
        cmp = np.empty((nq,), np.int64)
        getattr(self._lib, self._prefix + "_knn")(
            self._h, q.ctypes.data_as(_f32p), nq, k,
            idx.ctypes.data_as(_i32p), d2.ctypes.data_as(_f32p),
            cmp.ctypes.data_as(_i64p), n_threads)
        return idx, d2, cmp

    def radius(self, queries: np.ndarray, r: float, cap: int = 64,
               n_threads: int = 8, **kw
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """Radius search. Returns (idx [Q,cap] (-1 padded), dist2 [Q,cap]
        (inf padded), count [Q]: the TRUE neighbour count, which may
        exceed cap, comparisons [Q])."""
        q = _as_f32_c(queries)
        nq = q.shape[0]
        idx = np.empty((nq, cap), np.int32)
        # the C++ side writes only the first `found` slots of each query
        d2 = np.full((nq, cap), np.inf, np.float32)
        cnt = np.empty((nq,), np.int32)
        cmp = np.empty((nq,), np.int64)
        self._radius_native(q, nq, r, cap, idx, d2, cnt, cmp, n_threads,
                            **kw)
        return idx, d2, cnt, cmp


class KDTree(_TreeBase):
    """Median-split round-robin-axis KD-tree."""

    _prefix = "kdtree"

    def __init__(self, points: np.ndarray, leaf_size: int = 32):
        pts = self._setup(points, leaf_size)
        self._h = self._lib.kdtree_build(pts.ctypes.data_as(_f32p), self.n,
                                         leaf_size)

    def _radius_native(self, q, nq, r, cap, idx, d2, cnt, cmp, n_threads):
        self._lib.kdtree_radius(
            self._h, q.ctypes.data_as(_f32p), nq, r, cap,
            idx.ctypes.data_as(_i32p), d2.ctypes.data_as(_f32p),
            cnt.ctypes.data_as(_i32p), cmp.ctypes.data_as(_i64p), n_threads)


class Octree(_TreeBase):
    """8-way morton-split octree; radius search has the `contains()`
    no-distance-check fast path at every level (`fast=True`)."""

    _prefix = "octree"

    def __init__(self, points: np.ndarray, leaf_size: int = 32,
                 min_extent: float = 1e-4):
        pts = self._setup(points, leaf_size)
        self.min_extent = min_extent
        self._h = self._lib.octree_build(pts.ctypes.data_as(_f32p), self.n,
                                         leaf_size, min_extent)

    def _radius_native(self, q, nq, r, cap, idx, d2, cnt, cmp, n_threads,
                       fast: bool = True):
        self._lib.octree_radius(
            self._h, q.ctypes.data_as(_f32p), nq, r, cap,
            idx.ctypes.data_as(_i32p), d2.ctypes.data_as(_f32p),
            cnt.ctypes.data_as(_i32p), cmp.ctypes.data_as(_i64p),
            1 if fast else 0, n_threads)
