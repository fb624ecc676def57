"""Rotated 3D-box ops against the JAX package, on the CPU: BEV and 3D IoU
on random boxes and on identical, disjoint, touching, nested and crossed
ones; greedy rotated NMS with equal scores and with a budget larger than
the candidates; points-in-boxes; ROI pooling with a pool larger than the
cloud. Inputs come from numpy with a seed.

Tolerances: IoU within 1e-5 (the clip's products round apart from XLA's
dot); NMS indices and validity, point membership, and ROI pooling's
selection and counts equal, the pooled local coordinates within 1e-6."""
import torch_threads as _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops import box3d as jb
from pctpu_torch import ops as tops
from pctpu_torch.ops import box3d as tb


def _t(x):
    return torch.from_numpy(np.array(x))


def _boxes(rng, n, spread=6.0):
    return np.concatenate([
        rng.uniform(-spread, spread, (n, 2)), rng.uniform(-1, 1, (n, 1)),
        rng.uniform(0.5, 4.0, (n, 3)), rng.uniform(-np.pi, np.pi, (n, 1))],
        axis=1).astype(np.float32)


def _hand_made():
    """Identical, disjoint, touching (edge to edge), nested, crossed at
    45 degrees, and zero-overlap-in-z boxes."""
    return np.float32([
        [0, 0, 0, 4, 2, 1.5, 0.0],
        [0, 0, 0, 4, 2, 1.5, 0.0],          # identical to 0
        [10, 10, 0, 1, 1, 1, 0.3],          # disjoint
        [4, 0, 0, 4, 2, 1.5, 0.0],          # touches 0 along x = 2
        [0, 0, 0, 1, 1, 0.5, 0.0],          # inside 0
        [0, 0, 0, 4, 2, 1.5, np.pi / 4],    # crossed
        [0, 0, 3, 4, 2, 1.0, 0.0],          # above 0: no z overlap
        [0, 0, 0, 2, 4, 1.5, np.pi / 2],    # 0 turned by 90 degrees
    ])


@pytest.mark.parametrize("fn", ["iou_bev", "iou3d"])
@pytest.mark.parametrize("case", ["random", "hand_made"])
def test_iou_matches_jax(fn, case):
    if case == "random":
        rng = np.random.default_rng(0)
        a, b = _boxes(rng, 40), _boxes(rng, 30)
    else:
        a = b = _hand_made()
    ref = np.asarray(getattr(jb, fn)(jnp.asarray(a), jnp.asarray(b)))
    got = getattr(tb, fn)(_t(a), _t(b)).numpy()
    assert got.shape == (len(a), len(b))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    if case == "hand_made":
        assert abs(got[0, 1] - 1.0) < 1e-6 and got[0, 2] == 0.0
        assert abs(got[0, 3]) < 1e-6 and abs(got[0, 7] - 1.0) < 1e-5


def test_corners_match_jax():
    b = _boxes(np.random.default_rng(1), 10)
    for fn in ("bev_corners", "corners3d"):
        np.testing.assert_allclose(getattr(tops, fn)(_t(b)).numpy(),
                                   np.asarray(getattr(jb, fn)(
                                       jnp.asarray(b))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("bev", [True, False])
@pytest.mark.parametrize("scores,max_out", [("random", 10), ("equal", 12),
                                            ("levels", 60)])
def test_nms_rotated_matches_jax(bev, scores, max_out):
    """Clustered boxes (many overlaps): index for index, with all scores
    equal (the argsort's stable order decides) and with a budget larger
    than the 40 candidates (padded with -1)."""
    rng = np.random.default_rng(2)
    boxes = _boxes(rng, 40, spread=3.0)
    s = {"random": rng.uniform(size=40), "equal": np.ones(40),
         "levels": rng.integers(0, 4, 40)}[scores].astype(np.float32)
    ri, rv = jb.nms_rotated(jnp.asarray(boxes), jnp.asarray(s), 0.3,
                            max_out, bev=bev)
    gi, gv = tb.nms_rotated(_t(boxes), _t(s), 0.3, max_out, bev=bev)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(rv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
    assert 0 < int(gv.sum()) < 40


def _cloud(rng, n):
    return rng.uniform(-6, 6, (n, 3)).astype(np.float32)


def test_points_in_boxes_matches_jax():
    rng = np.random.default_rng(3)
    p, b = _cloud(rng, 2000), _boxes(rng, 25, spread=4.0)
    ref = np.asarray(jb.points_in_boxes(jnp.asarray(p), jnp.asarray(b)))
    got = tb.points_in_boxes(_t(p), _t(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert ref.sum() > 100


@pytest.mark.parametrize("n,cap", [(2000, 16), (300, 64), (40, 64)])
def test_roipool3d_matches_jax(n, cap):
    """The first `cap` in-box points in point order; at n 40 the pool is
    larger than the cloud."""
    rng = np.random.default_rng(4)
    p, b = _cloud(rng, n), _boxes(rng, 12, spread=4.0)
    b[:, 3:6] += 2.0
    f = rng.normal(size=(n, 5)).astype(np.float32)
    ref = [np.asarray(x) for x in jb.roipool3d(
        jnp.asarray(p), jnp.asarray(f), jnp.asarray(b), cap=cap)]
    got = [x.numpy() for x in tb.roipool3d(_t(p), _t(f), _t(b), cap=cap)]
    np.testing.assert_array_equal(got[2], ref[2])            # valid
    np.testing.assert_array_equal(got[3], ref[3])            # count
    np.testing.assert_array_equal(got[1], ref[1])            # feats
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
    assert ref[3].max() > 0 and ref[2].sum() > 0
