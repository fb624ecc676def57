"""Kernel 9 (`features/pallas_fpfh.py`: `moments`, `normals_radius_fused`)
against the JAX package on the CPU: the plain version of the shifted
moments against a float64 numpy brute force, and the fused normals
against the reference's `normals_radius_fused(interpret=True)` and the
analytic normal on the tilted plane of `tests/test_features.py:679-711`.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.features.pallas_fpfh import fpfh_fused as j_fpfh_fused
from pctpu.features.pallas_fpfh import \
    normals_radius_fused as j_normals_radius_fused
from pctpu_torch.features import pallas_fpfh
from pctpu_torch.features.fpfh_dense import normals_radius_dense


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TRUE_N = np.array([-0.05, -0.1, 1.0]) / np.linalg.norm([-0.05, -0.1, 1.0])


def _plane(rng, b=2, n=384):
    """x-sorted tilted planes z = 0.05 x + 0.1 y (+1 cm noise), ~10% of
    the rows invalid."""
    g = rng.uniform(-20, 20, (b, n, 2)).astype(np.float32)
    pts = np.stack([g[..., 0], g[..., 1],
                    0.05 * g[..., 0] + 0.1 * g[..., 1]
                    + rng.normal(scale=0.01, size=(b, n))],
                   axis=-1).astype(np.float32)
    for i in range(b):
        pts[i] = pts[i][np.argsort(pts[i, :, 0])]
    return pts, rng.uniform(size=(b, n)) > 0.1


@pytest.mark.parametrize("banded", [False, True])
def test_normals_radius_fused_matches_jax(rng, banded):
    """Unit normals within |dot| > 0.999 of the reference's kernel run in
    interpret mode and of the analytic plane normal; the wrapper takes
    the plain version on CPU tensors (no launch)."""
    pts, mask = _plane(rng)
    before = pallas_fpfh.moments.launches
    ours = pallas_fpfh.normals_radius_fused(
        torch.from_numpy(pts), torch.from_numpy(mask), radius=6.0,
        q_tile=128, db_tile=128, x_banded=banded).numpy()
    assert pallas_fpfh.moments.launches == before
    ref = np.asarray(j_normals_radius_fused(
        jnp.asarray(pts), jnp.asarray(mask), radius=6.0, q_tile=128,
        db_tile=128, x_banded=banded, interpret=True))
    assert np.abs(np.sum(ours * ref, axis=-1))[mask].min() > 0.999
    assert np.abs(ours @ TRUE_N)[mask].min() > 0.999
    dense = normals_radius_dense(torch.from_numpy(pts),
                                 torch.from_numpy(mask), radius=6.0).numpy()
    assert np.abs(np.sum(ours * dense, axis=-1))[mask].min() > 0.999


@pytest.mark.parametrize("banded", [False, True])
def test_moments_plain_matches_float64_brute_force(rng, banded):
    """Every valid query's moments against numpy in float64 over its
    radius neighbours (self included), shifted by its tile's centroid:
    within 1e-6 of each row's largest moment. Queries with a column within
    1e-3 of r^2 (where f32 and f64 can disagree on membership) are left
    out, and counted. (A masked row's moments are unused, and the band
    does not cover it.)"""
    pts, mask = _plane(rng, n=500)
    q_tile, db_tile, r = 128, 256, 5.0
    np_ = 512
    amat, dbmat, cent, valid = pallas_fpfh._moments_inputs(
        torch.from_numpy(pts), torch.from_numpy(mask), np_, q_tile)
    base, nt = pallas_fpfh._band(amat[..., 0], valid, r, q_tile, db_tile,
                                 banded, 0.0)
    mom = pallas_fpfh.moments(amat, dbmat, cent, base, nt, q_tile, db_tile,
                              r * r).numpy()
    b, n = mask.shape
    p64 = np.where(mask[..., None], pts, 0.0).astype(np.float64)
    c64 = cent.numpy().astype(np.float64)
    checked = skipped = 0
    for bi in range(b):
        d2 = ((p64[bi][:, None] - p64[bi][None]) ** 2).sum(-1)
        d2[:, ~mask[bi]] = np.inf
        for qi in np.nonzero(mask[bi])[0]:
            if np.any(np.abs(d2[qi] - r * r) < 1e-3):
                skipped += 1
                continue
            x = p64[bi][d2[qi] <= r * r] - c64[bi, qi // q_tile]
            want = np.concatenate([
                x.sum(0), (x * x).sum(0),
                [(x[:, 0] * x[:, 1]).sum(), (x[:, 0] * x[:, 2]).sum(),
                 (x[:, 1] * x[:, 2]).sum(), len(x)]])
            np.testing.assert_allclose(mom[bi, qi], want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
            checked += 1
    assert checked > 0.95 * mask.sum(), (checked, skipped)


def test_moments_empty_tile_writes_zeros(rng):
    """A banded query tile with no valid point gets nt = 0 and all-zero
    moments."""
    pts, mask = _plane(rng)
    mask[0, 128:256] = False
    amat, dbmat, cent, valid = pallas_fpfh._moments_inputs(
        torch.from_numpy(pts), torch.from_numpy(mask), 384, 128)
    base, nt = pallas_fpfh._band(amat[..., 0], valid, 6.0, 128, 128, True,
                                 0.0)
    assert int(nt[0, 1]) == 0 and bool((cent[0, 1] == 0).all())
    mom = pallas_fpfh.moments(amat, dbmat, cent, base, nt, 128, 128, 36.0)
    assert not bool(mom[0, 128:256].any())


def test_fpfh_fused_with_fused_normals_matches_jax(rng):
    """The reference's opt-in (`pallas_fpfh.py:449-461`): K9's normals
    into the banded K2/K3 descriptor, both packages in their plain /
    interpret form: histograms within the bin-boundary bound of the other
    FPFH parity tests (flip fraction < 2e-3, mean |diff| < 0.02)."""
    pts, mask = _plane(rng, b=1, n=256)
    kw = dict(radius=8.0, q_tile=128, db_tile=128, x_banded=True,
              x_slack=0.5)
    nrm = pallas_fpfh.normals_radius_fused(
        torch.from_numpy(pts), torch.from_numpy(mask), radius=6.0,
        q_tile=128, db_tile=128, x_banded=True, x_slack=0.5)
    ours = pallas_fpfh.fpfh_fused(torch.from_numpy(pts),
                                  torch.from_numpy(mask), normals=nrm,
                                  **kw).numpy()
    jn = j_normals_radius_fused(jnp.asarray(pts), jnp.asarray(mask),
                                radius=6.0, q_tile=128, db_tile=128,
                                x_banded=True, x_slack=0.5, interpret=True)
    ref = np.asarray(j_fpfh_fused(jnp.asarray(pts), jnp.asarray(mask),
                                  normals=jn, interpret=True, **kw))
    diff = np.abs(ours - ref)
    assert (diff > 0.5).mean() < 2e-3 and diff.mean() < 0.02, (
        (diff > 0.5).mean(), diff.mean())
