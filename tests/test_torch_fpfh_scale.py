"""K2's and K3's plain versions (`spfh_plain`, `wsum_plain` in
`pctpu_torch/features/pallas_fpfh.py`) against the reference Pallas
kernels `_spfh_kernel` and `_wsum_kernel` of `pctpu/features/
pallas_fpfh.py`, run through `pl.pallas_call(..., interpret=True)` on the
same packed operands and band tables.

The SPFH histograms are counts scaled once by 100 / count, so the plain
version must equal the reference bit for bit, histograms and counts; the
weighted neighbour sums are f32 dot products summed in another order.
Cases: x-banded voxel-like clouds, a query tile with no valid point
(nt = 0), masked columns, two coincident points (d2 = 0) and the
unbanded tables."""
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pctpu.features.pallas_fpfh import _spfh_kernel, _wsum_kernel
from pctpu_torch.features import pallas_fpfh as pf

Q_TILE = 256


def _pallas(kernel, base, nt, amat, dbmat, extra, outs, db_tile, r2):
    """One reference kernel over the (batch, query tile) grid, in
    interpret mode, with the block specs of `_fpfh_fused_impl`."""
    b, np_, _ = amat.shape

    def qspec(c):
        return pl.BlockSpec((1, Q_TILE, c), lambda bi, i, base, nt: (bi, i, 0),
                            memory_space=pl.ANY)

    def dbspec(r, c):
        return pl.BlockSpec((1, r, c), lambda bi, i, base, nt: (bi, 0, 0),
                            memory_space=pl.ANY)
    in_specs = [qspec(11), dbspec(12, np_)] + [dbspec(np_, 33)] * len(extra)
    out_specs = [qspec(c) for c in outs]
    call = pl.pallas_call(
        partial(kernel, db_tile=db_tile, r2=r2),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=2, grid=(b, np_ // Q_TILE),
            in_specs=in_specs, out_specs=out_specs),
        out_shape=[jax.ShapeDtypeStruct((b, np_, c), jnp.float32)
                   for c in outs],
        interpret=True)
    return [np.asarray(o) for o in call(
        *(jnp.asarray(x) for x in (base, nt, amat, dbmat, *extra)))]


def _cloud(case, b=2, n=1024, seed=0):
    """Points sorted by x (a voxel cloud's x-major order), unit normals and
    a mask. "masked": random masked points, and the second cloud's last
    query tile all masked (its nt is 0); "coincident": two points at one
    spot with one normal, on dyadic values so that d2 = 0 exactly."""
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-12, 12, n), rng.uniform(-6, 6, n),
                    rng.normal(scale=0.3, size=n)], -1)
    pts = np.stack([pts[np.argsort(pts[:, 0])]] * b).astype(np.float32)
    pts[1] += rng.normal(scale=0.05, size=pts[1].shape).astype(np.float32)
    nrm = rng.normal(size=(b, n, 3)) + [0.0, 0.0, 3.0]
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    mask = np.ones((b, n), bool)
    if case == "masked":
        mask &= rng.uniform(size=(b, n)) > 0.15
        mask[1, n - Q_TILE:] = False
    if case == "coincident":
        k = n // 2
        pts[:, k] = pts[:, k + 1] = np.round(pts[:, k] * 8) / 8
        nrm[:, k] = nrm[:, k + 1] = [0.0, 0.0, 1.0]
    return pts, nrm, mask


def _operands(case, db_tile, radius=3.0):
    pts, nrm, mask = _cloud(case)
    mask_t = torch.from_numpy(mask)
    amat, dbmat, valid = pf._pack(torch.from_numpy(pts), mask_t,
                                  torch.from_numpy(nrm), pts.shape[1])
    base, nt = pf._band(amat[..., 0], valid, radius, Q_TILE, db_tile,
                        x_banded=case != "unbanded", x_slack=0.0)
    return amat, dbmat, base, nt, radius * radius


CASES = ["banded", "masked", "coincident", "unbanded"]


@pytest.mark.parametrize("db_tile", [128, 256])
@pytest.mark.parametrize("case", CASES)
def test_spfh_plain_equals_reference_kernel(case, db_tile):
    """Histograms and counts bit for bit (the parent's `100.0 / c` scaled
    by c.reciprocal() * 100 and missed by an ulp on ~10% of entries)."""
    amat, dbmat, base, nt, r2 = _operands(case, db_tile)
    if case == "masked":
        assert int(nt[1, -1]) == 0
    if case == "unbanded":
        assert bool((nt == amat.shape[1] // db_tile).all())
    hist, cnt = pf.spfh_plain(amat, dbmat, base, nt, Q_TILE, db_tile, r2)
    ref_hist, ref_cnt = _pallas(_spfh_kernel, base.numpy(), nt.numpy(),
                                amat.numpy(), dbmat.numpy(), (), (33, 1),
                                db_tile, r2)
    np.testing.assert_array_equal(cnt.numpy(), ref_cnt[..., 0])
    np.testing.assert_array_equal(hist.numpy(), ref_hist)
    assert float(cnt.max()) > 10.0          # real neighbourhoods
    if case == "coincident":
        k = amat.shape[1] // 2
        d2 = pf._dot3(amat[:, k:k + 1, 0:3], dbmat[:, 0:3, k + 1:k + 2])
        assert bool((amat[:, k, 9] + dbmat[:, 9, k + 1] - 2.0 * d2[:, 0, 0]
                     == 0.0).all())


@pytest.mark.parametrize("case", CASES)
def test_wsum_plain_matches_reference_kernel(case):
    """The 1/dist-weighted neighbour sums within 2e-3 of each entry. The
    reference takes q.p from an XLA dot and rsqrt from XLA, which round
    otherwise than the port's sequential dot and correctly rounded
    1 / sqrt; on close pairs the cancellation in |q|^2 + |p|^2 - 2 q.p
    magnifies one ulp of q.p to up to ~8e-4 of a weight (measured on these
    inputs)."""
    db_tile = 128
    amat, dbmat, base, nt, r2 = _operands(case, db_tile)
    s33, _ = pf.spfh_plain(amat, dbmat, base, nt, Q_TILE, db_tile, r2)
    out = pf.wsum_plain(amat, dbmat, base, nt, s33, Q_TILE, db_tile, r2)
    (ref,) = _pallas(_wsum_kernel, base.numpy(), nt.numpy(), amat.numpy(),
                     dbmat.numpy(), (s33.numpy(),), (33,), db_tile, r2)
    scale = float(np.abs(ref).max())
    assert scale > 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-3,
                               atol=1e-6 * scale)
