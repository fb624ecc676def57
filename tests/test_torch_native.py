"""The port's native C++ loader and trees (`pctpu_torch.native`,
`native.spatial`), mirroring `tests/test_native.py` and
`tests/test_spatial_index.py` on the port's own copies of the sources,
against numpy, scipy and brute force (no tolerance but the reference
tests' own: exact arrays and indices; kNN distances within 1e-4 relative
to brute force, and 1e-3 to scipy on the large cloud). Also: a failed
build raises with no fallback, every source the loader compiles lies
under `pctpu_torch/`, and concurrent builds land whole. The JAX
package's native build is not called here: it builds in its own tree,
which other test files' workers share.
"""
import torch_threads as _torch_threads  # noqa: F401

import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
from scipy.spatial import cKDTree

from pctpu_torch import native
from pctpu_torch.native import spatial

PORT = Path(native.__file__).resolve().parents[1]


def test_native_builds():
    assert native.available() and spatial.available()
    for name in native.LIBS:
        lib = native.build(name)
        assert lib.parent == native.BUILD_DIR and lib.exists()


def test_sources_lie_under_the_port():
    for name in native.LIBS:
        src = native.source(name)
        assert src.is_relative_to(PORT) and src.exists()
        assert src.read_bytes() == (
            PORT.parent / "pctpu" / "native" / src.name).read_bytes()


def test_compiler_sees_only_the_ports_sources(monkeypatch, tmp_path):
    seen = []
    real = subprocess.run

    def run(cmd, *a, **kw):
        seen.append(cmd)
        return real(cmd, *a, **kw)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(subprocess, "run", run)
    for name in native.LIBS:
        assert native.build(name).parent == tmp_path
    assert len(seen) == len(native.LIBS)
    for cmd in seen:
        srcs = [Path(c) for c in cmd if c.endswith(".cpp")]
        assert len(srcs) == 1 and srcs[0].is_relative_to(PORT)
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("cxx", ["no-such-compiler-here", "false"])
def test_failed_build_raises(monkeypatch, tmp_path, cxx):
    """A missing (or failing) compiler raises; nothing falls back."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", cxx)
    monkeypatch.setattr(native, "_loaded", {})
    with pytest.raises(RuntimeError, match=cxx):
        native.get_lib()
    with pytest.raises(RuntimeError):
        native.voxel_count(np.zeros((4, 3), np.float32), 0.5)
    with pytest.raises(RuntimeError):
        spatial.KDTree(np.zeros((4, 3), np.float32))
    assert not native.available() and not spatial.available()
    assert not list(tmp_path.iterdir())


def test_concurrent_builds_land_whole(monkeypatch, tmp_path):
    """Builds of the same library at once (as test workers may start
    them): each compiles into its own temporary and renames it into
    place, so every caller gets a whole library and no temporary stays."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    with ThreadPoolExecutor(3) as pool:
        outs = list(pool.map(lambda _: native.build("fastio"), range(3)))
    assert len(set(outs)) == 1 and outs[0].exists()
    assert [p.name for p in tmp_path.iterdir()] == [outs[0].name]
    assert ctypes.CDLL(str(outs[0])).voxel_count is not None


def test_batch_read_f32(tmp_path):
    rng = np.random.default_rng(0)
    paths, datas = [], []
    for i in range(10):
        d = rng.normal(size=(100 + i * 7,)).astype(np.float32)
        p = tmp_path / f"f{i}.bin"
        d.tofile(p)
        paths.append(str(p))
        datas.append(d)
    paths.append(str(tmp_path / "missing.bin"))
    arena, counts = native.batch_read_f32(paths, 1024, n_threads=4)
    for i, d in enumerate(datas):
        assert counts[i] == d.size
        np.testing.assert_array_equal(arena[i, : d.size], d)
    assert counts[-1] == -1


def test_batch_read_velodyne(tmp_path):
    rng = np.random.default_rng(0)
    scans, paths = [], []
    for i in range(4):
        s = rng.normal(size=(50 + i, 4)).astype(np.float32)
        p = tmp_path / f"{i:06d}.bin"
        s.tofile(p)
        scans.append(s)
        paths.append(str(p))
    out = native.batch_read_velodyne(paths + [str(tmp_path / "no.bin")],
                                     max_points=1000, n_threads=2)
    for s, o in zip(scans, out):
        np.testing.assert_array_equal(o, s[:, :3])
    assert out[-1] is None


def test_voxel_count_matches_python():
    pts = np.random.default_rng(0).uniform(0, 5, (2000, 3)).astype(
        np.float32)
    mn = pts.min(axis=0)
    cells = np.floor((pts - mn) / 0.5).astype(np.int64)
    assert native.voxel_count(pts, 0.5) == len({tuple(c) for c in cells})


# ---------------------------------------------------------------------------
# trees (tests/test_spatial_index.py)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def db():
    return np.random.default_rng(7).uniform(-10, 10, (5000, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def queries():
    return np.random.default_rng(8).uniform(-10, 10, (200, 3)).astype(
        np.float32)


@pytest.fixture(scope="module")
def brute(db, queries):
    d2 = ((queries[:, None, :] - db[None]) ** 2).sum(-1)
    return d2, np.argsort(d2, axis=1)


@pytest.fixture(scope="module", params=["kdtree", "octree"])
def tree(request, db):
    if request.param == "kdtree":
        return spatial.KDTree(db, leaf_size=16)
    return spatial.Octree(db, leaf_size=16)


def test_knn_matches_brute(tree, queries, brute):
    d2, order = brute
    k = 8
    idx, dd2, cmp = tree.knn(queries, k)
    ref_d2 = np.take_along_axis(d2, order[:, :k], 1)
    np.testing.assert_allclose(np.sort(dd2, 1), np.sort(ref_d2, 1),
                               rtol=1e-4, atol=1e-5)
    assert (np.sort(idx, 1) == np.sort(order[:, :k], 1)).all()


def test_knn_counters_prune(tree, db, queries):
    """A tree does far fewer distance comparisons than brute force."""
    assert tree.native and tree.node_count > 0
    _, _, cmp = tree.knn(queries, 8)
    assert (cmp > 0).all()
    assert cmp.mean() < db.shape[0] / 4


def test_radius_matches_brute(tree, queries, brute):
    d2, _ = brute
    r = 1.5
    idx, dd2, cnt, cmp = tree.radius(queries, r, cap=256)
    np.testing.assert_array_equal(cnt, (d2 <= r * r).sum(1))
    assert (cmp > 0).all()
    for i in range(0, queries.shape[0], 23):
        got = np.sort(idx[i][: min(int(cnt[i]), 256)])
        ref = np.sort(np.flatnonzero(d2[i] <= r * r))
        np.testing.assert_array_equal(got, ref)


def test_radius_overflow_count(tree, db):
    """cap below the true neighbourhood: count still reports the truth."""
    q = db[:4]
    idx, _, cnt, _ = tree.radius(q, 5.0, cap=4)
    d2 = ((q[:, None, :] - db[None]) ** 2).sum(-1)
    np.testing.assert_array_equal(cnt, (d2 <= 25.0).sum(1))
    assert (idx >= 0).all()


def test_octree_fast_path(db, queries):
    oc = spatial.Octree(db, leaf_size=16)
    r = 4.0
    i1, _, c1, m1 = oc.radius(queries, r, cap=512, fast=True)
    i2, _, c2, m2 = oc.radius(queries, r, cap=512, fast=False)
    np.testing.assert_array_equal(c1, c2)
    s1 = np.sort(np.where(i1 < 0, 1 << 30, i1), 1)
    s2 = np.sort(np.where(i2 < 0, 1 << 30, i2), 1)
    np.testing.assert_array_equal(s1, s2)
    # contains() fires at interior levels -> strictly fewer comparisons
    assert m1.sum() < m2.sum()


def test_kdtree_k_larger_than_n():
    db = np.random.default_rng(1).normal(size=(5, 3)).astype(np.float32)
    kd = spatial.KDTree(db, leaf_size=2)
    idx, d2, _ = kd.knn(db[:2], k=8)
    assert (idx[:, :5] >= 0).all()
    assert (idx[:, 5:] == -1).all()
    assert np.isinf(d2[:, 5:]).all()


def test_large_cloud_matches_scipy():
    """A 40,000-point cloud against scipy, as the reference benchmark's
    oracle (`benchmark.py:85-97`), through the threaded query path."""
    pts = np.random.default_rng(3).uniform(-40, 40, (40000, 3)).astype(
        np.float32)
    q = pts[:1000]
    ref_d, _ = cKDTree(pts).query(q, k=4)
    for tree in (spatial.KDTree(pts), spatial.Octree(pts)):
        _, d2, _ = tree.knn(q, 4, n_threads=8)
        np.testing.assert_allclose(np.sort(d2, 1),
                                   np.sort(ref_d.astype(np.float64) ** 2, 1),
                                   rtol=1e-3, atol=1e-4)


def test_radius_dist2_padding_is_inf():
    pts = np.random.default_rng(0).uniform(0, 10, (500, 3)).astype(
        np.float32)
    q = pts[:5]
    for cls in (spatial.KDTree, spatial.Octree):
        idx, d2, _, _ = cls(pts, leaf_size=8).radius(q, r=0.5, cap=32)
        pad = idx < 0
        assert pad.any()
        assert np.isinf(d2[pad]).all()
        assert np.isfinite(d2[~pad]).all()


@pytest.mark.parametrize("cls", [spatial.KDTree, spatial.Octree])
def test_knn_rejects_k_zero_and_empty_clouds(cls):
    pts = np.random.default_rng(0).uniform(0, 10, (100, 3)).astype(
        np.float32)
    with pytest.raises(ValueError):
        cls(pts).knn(pts[:3], k=0)
    with pytest.raises(ValueError):
        cls(pts[:0])
