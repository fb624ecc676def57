"""The grid-hash neighbour search (`pctpu_torch.ops.grid_hash`) and the
grid ICP (`register.icp.icp_fixed_iters_grid`) against the JAX package,
on the CPU, from numpy inputs with a seed.

Tolerances: every `build_grid` field, every `_gather_candidates` output
and every `NeighborSet` field (and `grid_nearest`'s d2, idx, found) equal,
indices included. The cases: duplicated points (equal distances, so the
lowest candidate column must win), a mask, a per-cell cap below and above
the densest cell, points on cell faces at a cell size of 0.1 (true
division, not a product with the reciprocal), a query farther than a cell
from every point, and a query chunk that does not divide the queries.
The grid ICP: the pose within 1e-5 of the JAX package's, and the
reference test's gate (`tests/test_register.py:189`: RTE < 0.05 m, RRE <
0.5 deg).
"""
import torch_threads as _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.core import se3 as jse3
from pctpu.ops import grid_hash as jG
from pctpu.register import icp as jicp
from pctpu_torch import ops as tops
from pctpu_torch.core import se3 as tse3
from pctpu_torch.ops import grid_hash as tG
from pctpu_torch.register import icp as ticp

from grid_faces import faces_cloud


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _cloud(seed, n=3000, dup=200):
    """n points in a 10 m cube with `dup` of them repeated (exact ties),
    and a mask with 5% of them off."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    p[-dup:] = p[:dup]
    return p, rng.uniform(size=n) > 0.05, rng


def _grids(p, mask, cs):
    return (jG.build_grid(jnp.asarray(p), jnp.asarray(mask), cell_size=cs),
            tG.build_grid(_t(p), _t(mask), cell_size=cs))


def _check_grid(ref, got):
    for name in tG.HashGrid._fields:
        _eq(getattr(got, name), getattr(ref, name))
    assert got.order.dtype == got.keys.dtype == torch.int32


def test_ops_exports_the_reference_names():
    for name in ("HashGrid", "build_grid", "grid_knn", "grid_radius",
                 "grid_nearest"):
        assert getattr(tops, name) is getattr(tG, name)


@pytest.mark.parametrize("cs", [0.7, 1.0])
def test_build_grid_matches_jax(cs):
    p, mask, _ = _cloud(0)
    ref, got = _grids(p, mask, cs)
    _check_grid(ref, got)
    assert int(got.keys[-1]) == 1 << 30 and int(got.keys[0]) < 1 << 30


def test_build_grid_without_mask_matches_jax():
    p, _, _ = _cloud(1)
    _check_grid(jG.build_grid(jnp.asarray(p), cell_size=0.5),
                tG.build_grid(_t(p), cell_size=0.5))


def test_cell_faces_match_jax():
    """At cell size 0.1 a point on a face sits in the cell that true
    division gives; the product with 1/0.1 would move some of them."""
    p = faces_cloud()
    mask = np.ones(len(p), bool)
    ref, got = _grids(p, mask, 0.1)
    _check_grid(ref, got)
    cells = np.floor(p / np.float32(0.1)).astype(np.int64)
    recip = np.floor(p * (np.float32(1) / np.float32(0.1))).astype(np.int64)
    assert (cells != recip).any()      # the case is exercised
    res_r = jG.grid_nearest(ref, jnp.asarray(p[::7]), cap_per_cell=8,
                            query_chunk=256)
    res_g = tG.grid_nearest(got, _t(p[::7]), cap_per_cell=8,
                            query_chunk=256)
    for a, b in zip(res_g, res_r):
        _eq(a, b)


@pytest.mark.parametrize("cap", [4, 48])
def test_gather_candidates_match_jax(cap):
    """cap 4 lies below the densest 0.7 m cell (overflow > 0), 48 above
    it (no overflow)."""
    p, mask, rng = _cloud(2)
    ref, got = _grids(p, mask, 0.7)
    q = rng.uniform(-1, 11, (300, 3)).astype(np.float32)
    r = jG._gather_candidates(ref, jnp.asarray(q), cap)
    g = tG._gather_candidates(got, _t(q), cap)
    for a, b in zip(g, r):
        _eq(a, b)
    assert (int(g[2].sum()) > 0) == (cap == 4)


@pytest.mark.parametrize("cap,chunk", [(4, 128), (48, 100)])
def test_grid_knn_matches_jax(cap, chunk):
    p, mask, rng = _cloud(3)
    ref, got = _grids(p, mask, 1.0)
    q = np.concatenate([p[rng.choice(len(p), 250, replace=False)],
                        p[:40], [[40.0, 40.0, 40.0]]]).astype(np.float32)
    r = jG.grid_knn(ref, jnp.asarray(q), k=6, cap_per_cell=cap,
                    query_chunk=chunk)
    g = tG.grid_knn(got, _t(q), k=6, cap_per_cell=cap, query_chunk=chunk)
    for name in g._fields:
        _eq(getattr(g, name), getattr(r, name))
    assert not bool(g.valid[-1].any())        # the far query


@pytest.mark.parametrize("cap,chunk", [(4, 128), (48, 100)])
def test_grid_radius_matches_jax(cap, chunk):
    p, mask, rng = _cloud(4)
    ref, got = _grids(p, mask, 0.7)
    q = np.concatenate([p[rng.choice(len(p), 250, replace=False)],
                        p[:40], [[-30.0, 5.0, 5.0]]]).astype(np.float32)
    r = jG.grid_radius(ref, jnp.asarray(q), radius=0.7, k_cap=8,
                       cap_per_cell=cap, query_chunk=chunk)
    g = tG.grid_radius(got, _t(q), radius=0.7, k_cap=8, cap_per_cell=cap,
                       query_chunk=chunk)
    for name in g._fields:
        _eq(getattr(g, name), getattr(r, name))
    assert int(g.count[-1]) == 0 and int(g.count.max()) > 8


@pytest.mark.parametrize("cap,chunk", [(4, 128), (48, 300)])
def test_grid_nearest_matches_jax(cap, chunk):
    p, mask, rng = _cloud(5)
    ref, got = _grids(p, mask, 0.5)
    q = np.concatenate([rng.uniform(0, 10, (500, 3)), p[:60],
                        [[5.0, 5.0, 25.0]]]).astype(np.float32)
    r = jG.grid_nearest(ref, jnp.asarray(q), cap_per_cell=cap,
                        query_chunk=chunk)
    g = tG.grid_nearest(got, _t(q), cap_per_cell=cap, query_chunk=chunk)
    for a, b in zip(g, r):
        _eq(a, b)
    assert not bool(g[2][-1]) and bool(g[2][:-1].any())


def _make_pair(rng, n=3000, angle_deg=6.0, trans=0.4):
    """`tests/test_register.py:11`'s pair (no noise)."""
    src = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    R = Rotation.from_rotvec(
        np.radians(angle_deg) * axis).as_matrix().astype(np.float32)
    t = (rng.normal(size=3) * trans).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    return src, src @ R.T + t, T


def test_icp_fixed_iters_grid_matches_jax():
    """`tests/test_register.py:189`'s case: 25 iterations, cell 2 m."""
    src, dst, T_gt = _make_pair(np.random.default_rng(0))
    m = np.ones(len(src), bool)
    kw = dict(iters=25, dist_thresh=5.0, cell_size=2.0, cap_per_cell=64,
              query_chunk=512)
    ref = np.asarray(jicp.icp_fixed_iters_grid(
        jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst), jnp.asarray(m),
        **kw))
    got = ticp.icp_fixed_iters_grid(_t(src), _t(m), _t(dst), _t(m),
                                    device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)
    rte, rre = tse3.pose_diff_rte_rre(got, _t(T_gt))
    assert float(rte) < 0.05 and float(rre) < 0.5
    jrte, jrre = jse3.pose_diff_rte_rre(jnp.asarray(ref), jnp.asarray(T_gt))
    assert float(jrte) < 0.05 and float(jrre) < 0.5


def test_icp_fixed_iters_grid_default_cell_and_init():
    """cell_size None means dist_thresh; an init pose is honoured."""
    src, dst, _ = _make_pair(np.random.default_rng(1), n=800)
    m = np.ones(len(src), bool)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = [0.05, -0.02, 0.01]
    kw = dict(iters=5, dist_thresh=1.5, query_chunk=256)
    ref = np.asarray(jicp.icp_fixed_iters_grid(
        jnp.asarray(src), jnp.asarray(m), jnp.asarray(dst), jnp.asarray(m),
        jnp.asarray(init), **kw))
    got = ticp.icp_fixed_iters_grid(_t(src), _t(m), _t(dst), _t(m),
                                    _t(init), device="cpu", **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)


def test_icp_fixed_iters_grid_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = torch.zeros((8, 3))
    m = torch.ones(8, dtype=torch.bool)
    with pytest.raises(RuntimeError, match="device"):
        ticp.icp_fixed_iters_grid(p, m, p, m, iters=1)
