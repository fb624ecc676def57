"""`pctpu_torch.features.margins` on hand-made clouds, on the CPU: which
radius tests and cap ranks are unsure, which NMS and threshold decisions
are settled, and that the ISS, gradient and SHOT bounds react to the
geometry that makes a result depend on rounding. Exact expectations
(booleans), no tolerance."""
import numpy as np
import pytest
import torch

from pctpu_torch.features import margins


def _t(x):
    return torch.from_numpy(np.asarray(x, np.float32))


def test_a_point_at_the_radius_is_unsure():
    """A neighbour at exactly the radius makes both ends' sets unsure; one
    well inside does not."""
    p = _t([[0, 0, 0], [1.0, 0, 0], [0, 0.5, 0], [10, 10, 10]])
    count, unsure = margins.neighbourhoods(p, 1.0, 8)
    assert count.tolist() == [3, 2, 2, 1]
    assert unsure.tolist() == [True, True, False, False]


@pytest.mark.parametrize("far,tied", [(0.8, False), (0.7, True)])
def test_a_tie_at_the_cap_is_unsure(far, tied):
    """With k_cap 2 the query keeps itself and its closest neighbour; a
    second neighbour as close as the first leaves the set to rounding."""
    p = _t([[0, 0, 0], [0.7, 0, 0], [0, far, 0]])
    _, unsure = margins.neighbourhoods(p, 2.0, 2)
    assert bool(unsure[0]) == tied


def _line(scores):
    """Points 1 m apart on a line: NMS radius 1.5 sees the next one."""
    n = len(scores)
    p = _t(np.stack([np.arange(n), np.zeros(n), np.zeros(n)], 1))
    return p, torch.tensor(scores, dtype=torch.float64)


def test_nms_decided_cases():
    """A clear maximum is settled (kept), as is its clearly weaker
    neighbour (suppressed by a sure candidate); two scores within the sum
    of their bounds are not; a point beside an unsure score is not; a
    point that is surely no candidate is settled whatever its score."""
    p, s = _line([5.0, 1.0, 3.0, 3.05, 0.0, float("nan"), 2.0, 9.0])
    certain = torch.tensor([1, 1, 1, 1, 0, 0, 1, 0], dtype=torch.bool)
    excluded = torch.tensor([0, 0, 0, 0, 1, 0, 0, 1], dtype=torch.bool)
    dec = margins.nms_decided(p, s, 0.1, certain, excluded, 1.5)
    assert dec.tolist() == [True, True, False, False, True, False, False,
                            True]


def test_threshold_decided_near_the_threshold():
    """A response within the margin of the threshold is not settled; one
    clearly below is (not a keypoint), as is a clear maximum above."""
    p = _t([[0, 0, 0], [5, 0, 0], [10, 0, 0]])
    r = torch.tensor([1e-4 + 5e-6, 0.0, 1.0], dtype=torch.float64)
    dec = margins.threshold_decided(p, r, 1e-4, 1.0)
    assert dec.tolist() == [False, True, True]
    unsure = torch.tensor([False, False, True])
    dec = margins.threshold_decided(p, r, 1e-4, 1.0, unsure=unsure)
    assert dec.tolist() == [False, True, False]


def test_iss_bounds_grow_with_an_unsure_neighbour():
    """On a jittered cube of points, the bound is the solver's alone; a
    point moved onto another's salient radius widens the bound of the
    points that read its membership or its 1/count weight."""
    rng = np.random.default_rng(0)
    g = np.stack(np.meshgrid(*[np.arange(6.0)] * 3, indexing="ij"),
                 -1).reshape(-1, 3) + rng.uniform(-0.2, 0.2, (216, 3))
    ev = torch.tensor([[1.0, 0.5, 0.2]] * 216, dtype=torch.float64)
    bound, lo, hi = margins.iss_bounds(_t(g), ev, radius=1.5)
    assert torch.equal(lo, hi) and float(bound.max()) == pytest.approx(1e-5)
    g[1] = g[0] + [1.5, 0, 0]
    bound, lo, hi = margins.iss_bounds(_t(g), ev, radius=1.5)
    assert int(hi[0] - lo[0]) == 1 and float(bound[0]) > 1e-3


def test_gradient_conditioning_on_a_plane_and_a_line():
    """A noiseless plane's least-squares matrix is singular along its
    normal, which the tangent projection removes; a line's is singular
    across the tangent plane as well."""
    rng = np.random.default_rng(1)
    plane = np.c_[rng.uniform(-1, 1, (200, 2)), np.zeros(200)]
    line = np.c_[rng.uniform(-1, 1, 200), np.zeros((200, 2))]
    nrm = _t(np.tile([0.0, 0.0, 1.0], (200, 1)))
    for pts, tangent_small in ((plane, True), (line, False)):
        kappa, tangent = margins.gradient_conditioning(_t(pts), nrm, 0.5)
        assert float(kappa.min()) > 1e6
        assert bool((tangent < 1e3).all()) == tangent_small
        assert bool((tangent >= 1e3).all()) != tangent_small


def test_shot_frames_settle_only_off_degenerate_neighbourhoods():
    """A keypoint among well-spread neighbours has a settled frame; one on
    a line (two equal eigenvalues) does not."""
    rng = np.random.default_rng(2)
    blob = rng.normal(size=(300, 3)) * [1.0, 0.6, 0.3]
    line = np.c_[np.linspace(-1, 1, 41), np.zeros((41, 2))] + [20, 0, 0]
    pts = np.concatenate([blob, line])
    nrm = _t(np.tile([0.0, 0.0, 1.0], (len(pts), 1)))
    kp = _t([[0, 0, 0], [20, 0, 0]])
    settled, bound = margins.shot_bounds(_t(pts), kp, nrm, 1.5)
    assert settled.tolist() == [True, False]
    assert float(bound[0]) >= 1e-5
