"""Kernels K6 `nearest_banded`, K7 `icp_moments_banded` and K8
`icp_moments_banded_v2` (their plain PyTorch versions, on the CPU) against
the JAX package's Pallas kernels in interpret mode, at the shapes of
tests/test_pallas_nn.py:32-107, with masked queries and masked db points.

K7/K8 tolerance: m44 within 1e-4 relative. The Pallas kernels sum the
moments in f32 in XLA's order; the port sums each tile in f64 and rounds
the tiles' f64 sum once, so the two differ by f32 summation noise."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.ops import pallas_banded as jb
from pctpu_torch.ops import pallas_banded as tb


def _t(x):
    return torch.from_numpy(np.array(x))


def _cloud(rng, n, widest=0):
    db = rng.uniform(0, 10, size=(n, 3)).astype(np.float32)
    db[:, widest] *= 10
    return db


def _both_banded(db, mask, block):
    j = jb.build_banded(jnp.asarray(db), None if mask is None
                        else jnp.asarray(mask), block=block)
    t = tb.build_banded(_t(db), None if mask is None else _t(mask),
                        block=block)
    return j, t


def test_build_banded_single_matches_jax(rng):
    db = _cloud(rng, 1000, widest=2)
    mask = rng.uniform(size=1000) > 0.2
    j, t = _both_banded(db, mask, 256)
    assert int(t.axis) == int(j.axis) == 2 and t.n == j.n
    for name in ("dbt", "penalty", "coords", "order", "lut", "dbt4"):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    np.testing.assert_allclose(t.pen2.numpy(), np.asarray(j.pen2), rtol=2e-7)


@pytest.mark.parametrize("masked", [False, True])
def test_nearest_banded_matches_pallas_interpret(rng, masked):
    """K6: idx equal; d2 within rtol 1e-6 (the same direct differences in
    the same order)."""
    db = _cloud(rng, 2048)
    mask = (rng.uniform(size=2048) > 0.3) if masked else None
    q = (db[:500] + rng.normal(scale=0.05, size=(500, 3))).astype(np.float32)
    q = q[np.argsort(q[:, 0])]
    j, t = _both_banded(db, mask, 256)
    kw = dict(block=256, window_blocks=4, query_tile=128)
    d2_j, idx_j = jb.nearest_banded(j, jnp.asarray(q), interpret=True, **kw)
    before = tb.nearest_banded.launches
    d2_t, idx_t = tb.nearest_banded(t, _t(q), **kw)
    assert tb.nearest_banded.launches == before      # plain version on CPU
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j), rtol=1e-6)


def _transformed_sorted(rng, db, n, mask_frac):
    R = Rotation.from_rotvec([0.02, -0.01, 0.03]).as_matrix()
    src = db[:n] @ R.T + np.array([0.3, -0.2, 0.1])
    src = (src + rng.normal(scale=0.02, size=src.shape)).astype(np.float32)
    src = src[np.argsort(src[:, 0])]
    qmask = rng.uniform(size=n) > mask_frac
    return src, qmask


@pytest.mark.parametrize("masked", [False, True])
def test_icp_moments_banded_matches_pallas_interpret(rng, masked):
    """K7: m44 within 1e-4 relative of the Pallas kernel, with padded
    queries (700 is not a multiple of tile * tiles_per_step)."""
    db = _cloud(rng, 2048)
    dmask = (rng.uniform(size=2048) > 0.2) if masked else None
    q, qmask = _transformed_sorted(rng, db, 700, 0.15 if masked else 0.0)
    j, t = _both_banded(db, dmask, 256)
    kw = dict(dist_thresh=2.0, block=256, window_blocks=4, query_tile=128,
              tiles_per_step=2)
    ref = np.asarray(jb.icp_moments_banded(j, jnp.asarray(q),
                                           jnp.asarray(qmask),
                                           interpret=True, **kw))
    ours = tb.icp_moments_banded(t, _t(q), _t(qmask), **kw).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(
        ref).max())
    assert ref[3, 3] > 100        # the gate passed real correspondences


@pytest.mark.parametrize("tiles_per_step", [1, 4])
def test_icp_moments_banded_tiles_per_step_changes_nothing(rng,
                                                           tiles_per_step):
    db = _cloud(rng, 1024)
    q, qmask = _transformed_sorted(rng, db, 300, 0.1)
    _, t = _both_banded(db, None, 256)
    kw = dict(dist_thresh=2.0, block=256, window_blocks=2, query_tile=64)
    base = tb.icp_moments_banded(t, _t(q), _t(qmask), tiles_per_step=1, **kw)
    other = tb.icp_moments_banded(t, _t(q), _t(qmask),
                                  tiles_per_step=tiles_per_step, **kw)
    torch.testing.assert_close(other, base, rtol=0, atol=0)


def _v2_layout(src, qmask, tq):
    n = src.shape[0]
    mp = ((n + tq - 1) // tq) * tq
    src3 = np.zeros((3, mp), np.float32)
    src3[:, :n] = src.T
    spen = np.full((1, mp), 1e30, np.float32)
    spen[0, :n] = np.where(qmask, 0.0, 1e30)
    centers = src3[:, tq // 2::tq].T.reshape(1, -1)
    return src3, spen, np.ascontiguousarray(centers)


@pytest.mark.parametrize("masked", [False, True])
def test_icp_moments_banded_v2_matches_pallas_interpret(rng, masked):
    """K8: the transform and the window base in the kernel; m44 within
    1e-4 relative of the Pallas kernel, for a rotated pose."""
    db = _cloud(rng, 2048)
    dmask = (rng.uniform(size=2048) > 0.2) if masked else None
    src = db[:640] + rng.normal(scale=0.02, size=(640, 3))
    src = src[np.argsort(src[:, 0])].astype(np.float32)
    qmask = rng.uniform(size=640) > (0.15 if masked else 0.0)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec([0.01, 0.02, -0.03]).as_matrix()
    T[:3, 3] = [0.2, -0.1, 0.05]
    src3, spen, centers = _v2_layout(src, qmask, 128)
    j, t = _both_banded(db, dmask, 256)
    kw = dict(dist_thresh=2.0, block=256, window_blocks=3, query_tile=128)
    ref = np.asarray(jb.icp_moments_banded_v2(
        j, j.pen2.T, jnp.asarray(src3), jnp.asarray(spen),
        jnp.asarray(centers), jnp.asarray(T), interpret=True, **kw))
    ours = tb.icp_moments_banded_v2(t, t.pen2.T, _t(src3), _t(spen),
                                    _t(centers), _t(T), **kw).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4 * np.abs(
        ref).max())
    assert ref[3, 3] > 100


def test_tile_offsets_match_jax(rng):
    db = _cloud(rng, 3000, widest=1)
    q = rng.uniform(-5, 110, size=(1024, 3)).astype(np.float32)
    q = q[np.argsort(q[:, 1])]
    j, t = _both_banded(db, None, 128)
    for wb in (1, 3):
        ref = jb._tile_offsets(j, jnp.asarray(q[:, 1]), 64, 128, wb)
        ours = tb._tile_offsets(t, _t(q[:, 1]), 64, 128, wb)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
