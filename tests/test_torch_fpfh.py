"""The port's feature stage against the JAX package: radius normals,
the x-band tables, kernels K2/K3 (fused FPFH; plain versions on the CPU,
against the Pallas kernels in interpret mode) and mutual matching."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.features.fpfh_dense import normals_radius_dense as j_normals
from pctpu.features.matching import match_features as j_match
from pctpu.features.pallas_fpfh import _band_tables as j_band
from pctpu.features.pallas_fpfh import fpfh_fused as j_fpfh
from pctpu.ops.voxel import voxel_downsample_capped as j_voxel
from pctpu_torch.features.fpfh_dense import normals_radius_dense
from pctpu_torch.features.matching import match_features
from pctpu_torch.features.pallas_fpfh import _band_tables, fpfh_fused


def _scene(rng, n=3000):
    """Ground + box walls + pillars: geometry FPFH can describe."""
    g = rng.uniform(-15, 15, (n // 2, 3))
    g[:, 2] = rng.normal(scale=0.05, size=n // 2)
    parts = [g]
    for _ in range(4):
        c, w, h = rng.uniform(-10, 10, 2), rng.uniform(1, 3, 2), \
            rng.uniform(2, 5)
        f = rng.uniform(-1, 1, (n // 8, 3))
        f[:, 0] = c[0] + w[0] * np.sign(f[:, 0])
        f[:, 1] = c[1] + w[1] * f[:, 1]
        f[:, 2] = h * (f[:, 2] + 1) / 2
        parts.append(f)
    return np.concatenate(parts).astype(np.float32)


def _voxel_clouds(rng, b=2, leaf=1.0, cap=512):
    """Cell-lexsorted voxel clouds from the JAX package, and their JAX
    radius normals: the same inputs for both FPFH implementations."""
    pts = np.stack([_scene(rng) for _ in range(b)])
    mask = np.ones(pts.shape[:2], bool)
    down, _ = j_voxel(jnp.asarray(pts), jnp.asarray(mask), leaf, cap)
    nrm = j_normals(down.points, down.mask, radius=2.0)
    return (np.array(down.points), np.array(down.mask), np.array(nrm))


def _flip_stats(out, ref, mask):
    diff = np.abs(out[mask] - ref[mask])
    return float(np.mean(diff > 0.5)), float(np.mean(diff)), \
        float(np.max(diff))


def test_normals_radius_dense_matches_jax_on_planes(rng):
    """Well-conditioned geometry only (tilted planes): on degenerate
    neighbourhoods the least eigenvector is arbitrary. |n . n_ref| and
    |n . n_true| > 0.999 on every valid point."""
    b, n = 2, 512
    g = rng.uniform(-10, 10, (b, n, 2)).astype(np.float32)
    pts = np.stack([g[..., 0], g[..., 1],
                    0.05 * g[..., 0] + 0.1 * g[..., 1]
                    + rng.normal(scale=0.01, size=(b, n))],
                   axis=-1).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.1
    ours = normals_radius_dense(torch.from_numpy(pts),
                                torch.from_numpy(mask), radius=3.0,
                                row_chunk=128).numpy()
    ref = np.asarray(j_normals(jnp.asarray(pts), jnp.asarray(mask),
                               radius=3.0))
    true_n = np.array([-0.05, -0.1, 1.0]) / np.linalg.norm([-0.05, -0.1, 1])
    assert np.min(np.abs(np.sum(ours * ref, axis=-1))[mask]) > 0.999
    assert np.min(np.abs(ours @ true_n)[mask]) > 0.999


def test_band_tables_match_jax(rng):
    """The x-band [base, nt) tables are integer-exact."""
    pts, mask, _ = _voxel_clouds(rng, cap=1024)
    xs = np.where(mask, pts[..., 0], 0.0).astype(np.float32)
    for q_tile, db_tile in ((128, 128), (256, 512)):
        ours = _band_tables(torch.from_numpy(xs), torch.from_numpy(mask),
                            5.0, q_tile, db_tile, slack=1.0)
        ref = j_band(jnp.asarray(xs), jnp.asarray(mask), 5.0, q_tile,
                     db_tile, slack=1.0)
        for o, r in zip(ours, ref):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
        assert int(ours[1].sum()) < ours[1].numel() * (1024 // db_tile)


@pytest.mark.parametrize("q_tile,db_tile", [(128, 128), (256, 512)])
def test_fpfh_fused_matches_pallas_interpret(rng, q_tile, db_tile):
    """K2 + K3 (plain versions) against the Pallas kernels in interpret
    mode, x-banded on a cell-lexsorted voxel cloud with the same normals.
    Bin-boundary bound of test_fpfh_pallas_matches_dense: flip fraction
    < 2e-3, mean |diff| < 0.02, max |diff| < 15."""
    pts, mask, nrm = _voxel_clouds(rng)
    kw = dict(radius=5.0, q_tile=q_tile, db_tile=db_tile, x_banded=True,
              x_slack=1.0)
    ours = fpfh_fused(torch.from_numpy(pts), torch.from_numpy(mask),
                      torch.from_numpy(nrm), **kw).numpy()
    ref = np.asarray(j_fpfh(jnp.asarray(pts), jnp.asarray(mask),
                            jnp.asarray(nrm), interpret=True, **kw))
    assert ours.shape == ref.shape == pts.shape[:2] + (33,)
    flips, mean, mx = _flip_stats(ours, ref, mask)
    assert flips < 2e-3 and mean < 0.02 and mx < 15.0, (flips, mean, mx)
    assert np.all(ours[~mask] == 0.0)


def test_fpfh_banded_equals_unbanded(rng):
    """x-band pruning is exact: banded == unbanded bit for bit."""
    pts, mask, nrm = _voxel_clouds(rng)
    args = (torch.from_numpy(pts), torch.from_numpy(mask),
            torch.from_numpy(nrm))
    kw = dict(radius=5.0, q_tile=128, db_tile=128)
    band = fpfh_fused(*args, x_banded=True, x_slack=1.0, **kw)
    full = fpfh_fused(*args, x_banded=False, **kw)
    assert torch.equal(band, full)


def test_match_features_matches_jax(rng):
    """Mutual-NN matching on identical features: exact indices and
    validity (ties go to the first index on both sides)."""
    b, m, n = 2, 200, 180
    a = rng.uniform(0, 100, (b, m, 33)).astype(np.float32)
    c = rng.uniform(0, 100, (b, n, 33)).astype(np.float32)
    c[:, :60] = a[:, 10:70] + rng.normal(scale=0.5, size=(b, 60, 33))
    ma = rng.uniform(size=(b, m)) > 0.1
    mc = rng.uniform(size=(b, n)) > 0.1
    ours = match_features(torch.from_numpy(a), torch.from_numpy(c),
                          torch.from_numpy(ma), torch.from_numpy(mc))
    for i in range(b):
        ref = j_match(jnp.asarray(a[i]), jnp.asarray(c[i]),
                      jnp.asarray(ma[i]), jnp.asarray(mc[i]))
        np.testing.assert_array_equal(ours.dst_idx[i].numpy(),
                                      np.asarray(ref.dst_idx))
        np.testing.assert_array_equal(ours.valid[i].numpy(),
                                      np.asarray(ref.valid))
        np.testing.assert_array_equal(ours.src_idx[i].numpy(),
                                      np.asarray(ref.src_idx))
    assert int(ours.valid.sum()) > 50
