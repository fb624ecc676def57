"""The keypoint and descriptor library against the JAX package, on the
CPU: `radius_nms` and `top_k_mask` (with ties), ISS, Harris3D (both
measures), `intensity_gradients`, Harris6D, SIFT3D (fields "y",
"density" and an array, and a cloud with duplicated points), SHOT-352,
and `pca` / `pca_project`. Inputs come from numpy with a seed: a ground
plane with four boxes, noisy where a test needs well-conditioned
neighbourhoods.

Tolerances:
- NMS, top-k and SIFT3D masks, and SHOT descriptors: equal (their
  inputs agree to rounding and no decision lies within it here).
- ISS masks: equal where `margins.iss_decided` settles them, at least 95%
  of the valid points and half of the keypoints (measured 98.8%; 144 of
  149 keypoints uncapped, 14 of 20 capped; 1.5e3 points). The ground plane's rank-1
  neighbourhoods put l3 within rounding of 0, so the `l3 > 0` test falls
  either way there (two points' signs differ between the port and the
  JAX package on one CPU), and a candidate at the NMS radius may flip.
- ISS eigenvalues and saliency: within 1e-5 of each point's largest
  eigenvalue, except where the two smaller ones form a (near-)double
  root (l2 - l3 < 1e-3 l1: the closed-form solver's arccos turns a
  rounding of the scatter matrix into about its square root there;
  measured up to 1.3e-4 of l1, on rank-1 neighbourhoods whose l3 is then
  not > 0 on either side).
  The eigenvalues also lie within `margins.iss_bounds`.
- Harris responses: within 1e-6 (measured 2.2e-8, 3D; 3.3e-7, 6D:
  `torch.linalg.det` / `eigvalsh` round apart from XLA's; Harris6D where
  `margins.harris6d_unsure` does not hold). Their masks are compared where
  `margins.threshold_decided` (a 1e-5 margin) settles them, which must be
  more than half of the points, with at least 5 keypoints among them.
- `intensity_gradients`: within 1e-4 where the neighbourhood's least-
  squares matrix has a condition number below 1e3
  (`margins.gradient_conditioning`; elsewhere the solve rounds apart, and
  the reference returns NaN on a singular one).
- SIFT3D responses and scales: within 1e-5, absolute and relative
  (smoothed fields to rounding; the density field sums to ~10).
- `pca`: eigenvalues within 1e-5 relative, eigenvectors within 1e-5 up to
  sign; `pca_project` likewise.
"""
import torch_threads as _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.features import harris as jh
from pctpu.features import iss as jiss
from pctpu.features import nms as jnms
from pctpu.features import shot as jshot
from pctpu.features import sift3d as jsift
from pctpu.ops import normals as jn
from pctpu_torch import features as tfeatures
from pctpu_torch import ops as tops
from pctpu_torch.features import harris as th
from pctpu_torch.features import iss as tiss
from pctpu_torch.features import margins
from pctpu_torch.features import nms as tnms
from pctpu_torch.features import shot as tshot
from pctpu_torch.features import sift3d as tsift
from pctpu_torch.ops import normals as tn


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(seed, n=1500, noise=0.0):
    """A ground plane (2 cm noise) and four axis-aligned boxes' faces
    ([n, 3], about 16 x 16 m), plus `noise` on every point, and a mask
    with 5% of the points off."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-8, 8, (n // 2, 3))
    g[:, 2] = rng.normal(scale=0.02, size=n // 2)
    pts = [g]
    for _ in range(4):
        c = rng.uniform(-6, 6, 3)
        c[2] = 0.0
        e = rng.uniform(0.8, 2.0, 3)
        u = rng.uniform(-0.5, 0.5, (n // 8, 3))
        ax = rng.integers(0, 3, n // 8)
        rows = np.arange(n // 8)
        u[rows, ax] = np.sign(u[rows, ax]) * 0.5
        pts.append(c + u * e + [0.0, 0.0, e[2] / 2])
    p = np.concatenate(pts)
    p = p + rng.normal(scale=noise, size=p.shape) if noise else p
    return p.astype(np.float32), rng.uniform(size=len(p)) > 0.05


def _masks_agree(points, mask, ref, got, thr, radius, unsure=None):
    """Masks equal where `margins.threshold_decided` settles them; more
    than half of the points settled, at least 5 keypoints among them."""
    ok = margins.threshold_decided(
        _t(points), _t(np.asarray(ref.response)), thr, radius,
        mask=_t(mask), unsure=unsure).numpy()
    ref_m, got_m = np.asarray(ref.keypoint_mask), got.keypoint_mask.numpy()
    np.testing.assert_array_equal(got_m[ok], ref_m[ok])
    assert ok.mean() > 0.5 and ref_m[ok].sum() >= 5, (ok.mean(),
                                                       ref_m[ok].sum())


# ---------------------------------------------------------------------------
# NMS
# ---------------------------------------------------------------------------

def _grid(n=6):
    g = np.stack(np.meshgrid(*[np.arange(n)] * 2, [0.0], indexing="ij"),
                 -1).reshape(-1, 3)
    return g.astype(np.float32)


@pytest.mark.parametrize("radius", [1.0, 1.5])
def test_radius_nms_ties_go_to_the_lower_index(radius):
    """On an integer grid with scores in 3 levels (many equal neighbours)
    and a third of the points not candidates: the keep mask equals the
    reference's, the lowest index winning among equal maxima."""
    p = _grid()
    rng = np.random.default_rng(1)
    scores = rng.integers(0, 3, len(p)).astype(np.float32)
    cand = rng.uniform(size=len(p)) > 0.3
    ref = jnms.radius_nms(jnp.asarray(p), jnp.asarray(scores),
                          jnp.asarray(cand), radius)
    got = tnms.radius_nms(_t(p), _t(scores), _t(cand), radius,
                          query_chunk=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert 0 < int(got.sum()) < int(cand.sum())


@pytest.mark.parametrize("k", [1, 5, 36])
def test_top_k_mask_ties_match_jax(k):
    """Equal scores rank the lowest index first, as `lax.top_k`."""
    scores = np.repeat(np.float32([3.0, 1.0, 2.0]), 12)
    keep = np.random.default_rng(2).uniform(size=36) > 0.25
    ref = jnms.top_k_mask(jnp.asarray(scores), jnp.asarray(keep), k)
    got = tnms.top_k_mask(_t(scores), _t(keep), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# ISS
# ---------------------------------------------------------------------------

def _iss_kw(max_keypoints):
    return dict(salient_radius=1.0, non_max_radius=0.7,
                max_keypoints=max_keypoints)


@pytest.mark.parametrize("max_keypoints", [0, 20])
def test_iss_keypoints_match_jax(max_keypoints):
    p, mask = _scene(0)
    kw = _iss_kw(max_keypoints)
    _check_iss(p, mask, kw, tiss.iss_keypoints(_t(p), _t(mask), **kw))


def _scatter_summed(order):
    """`torch.einsum` for ISS's scatter contraction ("nki,nkj->nij"),
    summing the neighbours in another order: in reverse, or in float64
    and rounded once, as another BLAS kernel might."""
    einsum = torch.einsum

    def contract(eq, a, b):
        assert eq == "nki,nkj->nij", eq
        if order == "reverse":
            a, b = a.flip(1), b.flip(1)
            return (a[..., :, None] * b[..., None, :]).sum(1)
        return einsum(eq, a.double(), b.double()).float()
    return contract


@pytest.mark.parametrize("order", ["reverse", "float64"])
@pytest.mark.parametrize("max_keypoints", [0, 20])
def test_iss_checks_hold_when_the_scatter_rounds_apart(max_keypoints, order,
                                                       monkeypatch):
    """The parity checks hold whichever order the scatter matrix's sum
    takes (the rounding a thread count or a CPU's BLAS kernel may change;
    a ground-plane point's l3 then moves by as much as its own size)."""
    p, mask = _scene(0)
    kw = _iss_kw(max_keypoints)
    with monkeypatch.context() as mp:
        mp.setattr(torch, "einsum", _scatter_summed(order))
        got = tiss.iss_keypoints(_t(p), _t(mask), **kw)
    _check_iss(p, mask, kw, got)


def _check_iss(p, mask, kw, got):
    """`got` against the JAX package's ISS on the same cloud, at the
    tolerances of the module's docstring."""
    max_keypoints = kw["max_keypoints"]
    ref = jiss.iss_keypoints(jnp.asarray(p), jnp.asarray(mask), **kw)
    ref_m = np.asarray(ref.keypoint_mask)
    assert int(ref_m.sum()) == (max_keypoints or int(ref_m.sum())) >= 20
    w = np.asarray(ref.eigvals)
    kept = (ref_m if not max_keypoints else np.asarray(jiss.iss_keypoints(
        jnp.asarray(p), jnp.asarray(mask),
        **dict(kw, max_keypoints=0)).keypoint_mask))
    decided = margins.iss_decided(
        _t(p), _t(w), _t(mask), salient_radius=1.0, non_max_radius=0.7,
        max_keypoints=max_keypoints, kept=_t(kept))[0].numpy()
    assert decided[mask].mean() > 0.95, decided[mask].mean()
    assert (decided & ref_m).sum() >= ref_m.sum() // 2
    np.testing.assert_array_equal(got.keypoint_mask.numpy()[decided],
                                  ref_m[decided])
    l1 = np.maximum(w[:, :1], 1e-12)
    double = (w[:, 1] - w[:, 2]) < 1e-3 * w[:, 0]
    err = np.abs(got.eigvals.numpy() - w) / l1
    assert err[~double].max() <= 1e-5, err[~double].max()
    assert err[double].max(initial=0.0) <= 1e-3
    bound = margins.iss_bounds(_t(p), _t(w), _t(mask), radius=1.0)[0]
    assert bool((torch.abs(got.eigvals.double() - _t(w).double()).amax(1)
                 <= bound)[_t(mask)].all())
    np.testing.assert_array_equal(got.saliency.numpy(), got.eigvals[:, 2])
    assert not bool(got.keypoint_mask[~_t(mask)].any())


# ---------------------------------------------------------------------------
# Harris
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("measure,thr", [("noble", 0.0), ("harris", -0.03)])
def test_harris3d_matches_jax(measure, thr):
    p, mask = _scene(3)
    kw = dict(radius=1.0, threshold=thr, measure=measure)
    ref = jh.harris3d_keypoints(jnp.asarray(p), jnp.asarray(mask), **kw)
    got = th.harris3d_keypoints(_t(p), _t(mask), **kw)
    np.testing.assert_allclose(got.response.numpy(), np.asarray(ref.response),
                               rtol=0, atol=1e-6)
    _masks_agree(p, mask, ref, got, thr, 1.0,
                 unsure=margins.neighbourhoods(_t(p), 1.0, 64, _t(mask))[1])


def test_harris3d_rejects_an_unknown_measure():
    p, _ = _scene(3, n=200)
    with pytest.raises(ValueError, match="measure"):
        th.harris3d_keypoints(_t(p), measure="tomasi")


def test_intensity_gradients_match_jax():
    p, mask = _scene(4, noise=0.03)
    inten = np.random.default_rng(5).uniform(size=len(p)).astype(np.float32)
    nrm = np.asarray(jn.estimate_normals(jnp.asarray(p), jnp.asarray(mask),
                                         k=16))
    ref = np.asarray(jh.intensity_gradients(
        jnp.asarray(p), jnp.asarray(inten), jnp.asarray(nrm),
        jnp.asarray(mask), radius=1.0))
    got = th.intensity_gradients(_t(p), _t(inten), _t(nrm), _t(mask),
                                 radius=1.0).numpy()
    ok = (margins.gradient_conditioning(_t(p), _t(nrm), 1.0,
                                        mask=_t(mask))[0] < 1e3).numpy()
    assert ok.mean() > 0.8, ok.mean()
    np.testing.assert_allclose(got[ok], ref[ok], rtol=0, atol=1e-4)


def test_harris6d_matches_jax():
    """Responses where `margins.harris6d_unsure` does not hold (no point
    within the radius has an unsure neighbour set or an ill-conditioned
    gradient solve), and masks where they are settled. At 3,000 points:
    Harris6D's keypoints gather by the ill-conditioned solves (its
    response rises where the unit gradients are arbitrary), and a point
    with such a rival is not settled, so 1,500 points settle 3."""
    p, mask = _scene(4, n=3000, noise=0.03)
    inten = tfeatures.rgb_to_intensity(_t(np.random.default_rng(6).uniform(
        size=(len(p), 3)).astype(np.float32))).numpy()
    ref = jh.harris6d_keypoints(jnp.asarray(p), jnp.asarray(inten),
                                jnp.asarray(mask), radius=1.0)
    got = th.harris6d_keypoints(_t(p), _t(inten), _t(mask), radius=1.0)
    nrm = tn.estimate_normals(_t(p), _t(mask), k=16)
    unsure = margins.harris6d_unsure(_t(p), nrm, 1.0, mask=_t(mask))
    ok = ~unsure.numpy()
    assert ok.mean() > 0.5, ok.mean()
    r, g = np.asarray(ref.response), got.response.numpy()
    np.testing.assert_allclose(g[ok], r[ok], rtol=0, atol=1e-6)
    _masks_agree(p, mask, ref, got, 0.0, 1.0, unsure=unsure)


# ---------------------------------------------------------------------------
# SIFT3D
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field", ["y", "density", "array"])
def test_sift3d_matches_jax(field):
    p, mask = _scene(7)
    f = np.random.default_rng(8).uniform(size=len(p)).astype(np.float32)
    ref = jsift.sift3d_keypoints(jnp.asarray(p), jnp.asarray(mask),
                                 min_scale=0.2, field=(jnp.asarray(f)
                                 if field == "array" else field))
    got = tsift.sift3d_keypoints(_t(p), _t(mask), min_scale=0.2,
                                 field=_t(f) if field == "array" else field)
    np.testing.assert_array_equal(got.keypoint_mask.numpy(),
                                  np.asarray(ref.keypoint_mask))
    assert int(got.keypoint_mask.sum()) >= 20
    for a, b in ((got.response, ref.response), (got.scale, ref.scale)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def test_sift3d_with_duplicated_points_matches_jax():
    """A third of the points duplicated: both packages take the same 25
    columns after the first (`knn` breaks distance ties by the lower
    index, C1), so the masks agree, and a point whose valid twin is among
    its 25 is never a strict extremum."""
    p, mask = _scene(9, n=1200)
    dup = np.random.default_rng(10).choice(len(p), len(p) // 3,
                                           replace=False)
    q = np.concatenate([p, p[dup]])
    qm = np.concatenate([mask, np.ones(len(dup), bool)])
    ref = jsift.sift3d_keypoints(jnp.asarray(q), jnp.asarray(qm),
                                 min_scale=0.2)
    got = tsift.sift3d_keypoints(_t(q), _t(qm), min_scale=0.2)
    np.testing.assert_array_equal(got.keypoint_mask.numpy(),
                                  np.asarray(ref.keypoint_mask))
    both = mask[dup]                 # the twins of a pair both valid
    twins = np.concatenate([dup[both], len(p) + np.flatnonzero(both)])
    assert not got.keypoint_mask.numpy()[twins].any()
    assert int(got.keypoint_mask.sum()) >= 10


def test_sift3d_rejects_an_unknown_field():
    p, _ = _scene(9, n=200)
    with pytest.raises(ValueError, match="field"):
        tsift.sift3d_keypoints(_t(p), field="x")


# ---------------------------------------------------------------------------
# SHOT, PCA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_normals", [False, True])
def test_shot352_matches_jax(with_normals):
    p, mask = _scene(11)
    kp = p[::37]
    nrm = None
    if with_normals:
        nrm = np.asarray(jn.estimate_normals(jnp.asarray(p),
                                             jnp.asarray(mask), k=12))
    ref = np.asarray(jshot.shot352(
        jnp.asarray(p), jnp.asarray(kp), jnp.asarray(mask),
        normals=None if nrm is None else jnp.asarray(nrm), radius=1.5))
    got = tshot.shot352(_t(p), _t(kp), _t(mask),
                        normals=None if nrm is None else _t(nrm), radius=1.5)
    assert got.shape == (len(kp), 352)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_allclose(np.linalg.norm(ref, axis=1), 1.0, rtol=1e-6)


@pytest.mark.parametrize("dim,correlation", [(3, False), (3, True),
                                             (5, False), (5, True)])
def test_pca_and_projection_match_jax(dim, correlation):
    rng = np.random.default_rng(12)
    x = (rng.normal(size=(300, dim)) * np.arange(1, dim + 1)
         + rng.normal(size=dim)).astype(np.float32)
    mask = rng.uniform(size=300) > 0.1
    rv, rV = jn.pca(jnp.asarray(x), jnp.asarray(mask), correlation)
    gv, gV = tn.pca(_t(x), _t(mask), correlation)
    rv, rV = np.asarray(rv), np.asarray(rV)
    np.testing.assert_allclose(gv.numpy(), rv, rtol=1e-5, atol=0)
    assert np.all(np.diff(gv.numpy()) <= 0)
    sign = np.sign(np.sum(gV.numpy() * rV, axis=0))
    np.testing.assert_allclose(gV.numpy() * sign, rV, rtol=0, atol=1e-5)
    ref = np.asarray(jn.pca_project(jnp.asarray(x), 2, jnp.asarray(mask)))
    got = tops.pca_project(_t(x), 2, _t(mask)).numpy()
    sign = np.sign(np.sum(got * ref, axis=0))
    np.testing.assert_allclose(got * sign, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
