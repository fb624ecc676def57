"""The port's ICP loops (plain kernel versions on the CPU) against the
JAX package: kernel 5 through the single-pair whole-loop ICP, the three
banded ICP loops (K6, K7, K8), the exact polish and the while-loop ICP
(K1), the pair sweeps (K1, K4), and `procrustes_from_moments`. Pallas
kernels run in interpret mode. T within 1e-4 unless a test says
otherwise."""
import torch_threads as _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.core import se3 as jse3
from pctpu.ops.pallas_banded import build_banded as j_build_banded
from pctpu.ops.pallas_banded import nearest_banded as j_nearest_banded
from pctpu.ops.pallas_nn import nearest_pallas as j_nearest_pallas
from pctpu.parallel import pair_sweep as jsweep
from pctpu.register import icp as jicp
from pctpu.register.procrustes import procrustes_from_moments as j_pfm
from pctpu.register.procrustes import procrustes_transform as j_ptrans
from pctpu.register.procrustes import weighted_procrustes as j_procrustes
from pctpu_torch.ops import pallas_icp_mega
from pctpu_torch.parallel import pair_sweep as tsweep
from pctpu_torch.register import icp as ticp
from pctpu_torch.register.procrustes import (procrustes_from_moments,
                                             procrustes_transform)


def _t(x):
    return torch.from_numpy(np.array(x))


def _pair(rng, n, rot=0.03, trans=0.3, noise=0.01, extent=20.0, outlier=0.0):
    """(src, dst = T src + noise, T): a pair of n points whose widest axis
    is x; a fraction `outlier` of dst is moved far away."""
    src = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    src[:, 0] *= 3.0
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(scale=rot, size=3)
                                     ).as_matrix()
    T[:3, 3] = rng.normal(scale=trans, size=3)
    dst = (src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(scale=noise, size=src.shape)).astype(np.float32)
    k = int(outlier * n)
    dst[:k] = rng.uniform(-3 * extent, 3 * extent, (k, 3))
    return src, dst, T


@pytest.mark.parametrize("window_blocks,coarse,polish",
                         [(1, 4, 2), (8, 3, 0)])
def test_icp_mega_single_matches_pallas_interpret(rng, window_blocks, coarse,
                                                  polish):
    """Kernel 5 (plain version) through `icp_fixed_iters_banded_mega`:
    window 1 (the LUT window path) and the full window (8 of 8 blocks),
    with masked points and a non-power-of-two size (padding)."""
    src, dst, T = _pair(rng, 900)
    mask = rng.uniform(size=900) > 0.05
    kw = dict(coarse_iters=coarse, polish_iters=polish, dist_thresh=5.0,
              block=128, window_blocks=window_blocks, query_tile=128)
    before = pallas_icp_mega.icp_mega.launches
    ours = ticp.icp_fixed_iters_banded_mega(_t(src), _t(mask), _t(dst),
                                            _t(mask), device="cpu", **kw)
    assert pallas_icp_mega.icp_mega.launches == before   # plain on the CPU
    ref = jicp.icp_fixed_iters_banded_mega(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst),
        jnp.asarray(mask), interpret=True, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), T, atol=0.05)


def test_icp_mega_single_rotated_init(rng):
    """A rotated init orders the source tiles by the init-transformed
    band-axis coordinate on both sides."""
    src, dst, T = _pair(rng, 1024, rot=0.02)
    init = np.eye(4, dtype=np.float32)
    init[:3, :3] = Rotation.from_rotvec([0, 0, 0.3]).as_matrix()
    init = (T @ np.linalg.inv(init)).astype(np.float32) @ init
    mask = np.ones(1024, bool)
    kw = dict(coarse_iters=3, polish_iters=1, block=256, window_blocks=1,
              query_tile=256)
    ours = ticp.icp_fixed_iters_banded_mega(_t(src), _t(mask), _t(dst),
                                            _t(mask), _t(init), device="cpu",
                                            **kw)
    ref = jicp.icp_fixed_iters_banded_mega(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst),
        jnp.asarray(mask), jnp.asarray(init), interpret=True, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


BANDED_KW = dict(iters=5, dist_thresh=3.0, block=256, window_blocks=2,
                 query_tile=128)


def _ref_banded_loop(src, mask, dst, dmask, iters, dist_thresh, block,
                     window_blocks, query_tile):
    """`pctpu/register/icp.py:210-219` rebuilt around the reference's
    `nearest_banded(interpret=True)` (`icp_fixed_iters_banded` takes no interpret flag)."""
    s, m, d, dm = map(jnp.asarray, (src, mask, dst, dmask))
    bdb = j_build_banded(d, dm, block=block)
    svals = jnp.where(m, s[:, int(bdb.axis)], jnp.float32(1e30))
    sorder = jnp.argsort(svals)
    src_s, mask_s = s[sorder], m[sorder]
    T = jnp.eye(4, dtype=jnp.float32)
    for _ in range(iters):
        src_t = jse3.apply_transform(T, src_s)
        d2, idx = j_nearest_banded(bdb, src_t, block=block,
                                   window_blocks=window_blocks,
                                   query_tile=query_tile, interpret=True)
        w = (mask_s & (d2 < jnp.float32(dist_thresh) ** 2)).astype(
            jnp.float32)
        R, t = j_procrustes(src_t, d[idx], w)
        T = jse3.make_transform(R, t) @ T
    return np.asarray(T)


def _banded_inputs(rng):
    src, dst, T = _pair(rng, 2000, outlier=0.05)
    mask = rng.uniform(size=2000) > 0.05
    dmask = rng.uniform(size=2000) > 0.05
    return src, mask, dst, dmask, T


def test_icp_fixed_iters_banded_matches_reference_loop(rng):
    src, mask, dst, dmask, T = _banded_inputs(rng)
    ours = ticp.icp_fixed_iters_banded(_t(src), _t(mask), _t(dst), _t(dmask),
                                       device="cpu", **BANDED_KW)
    ref = _ref_banded_loop(src, mask, dst, dmask, **BANDED_KW)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), T, atol=0.05)


@pytest.mark.parametrize("solver", ["polar", "svd"])
def test_icp_fixed_iters_banded_fused_matches_pallas_interpret(rng, solver):
    src, mask, dst, dmask, T = _banded_inputs(rng)
    kw = dict(BANDED_KW, solver=solver, tiles_per_step=2)
    ours = ticp.icp_fixed_iters_banded_fused(
        _t(src), _t(mask), _t(dst), _t(dmask), device="cpu", **kw)
    ref = jicp.icp_fixed_iters_banded_fused(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst),
        jnp.asarray(dmask), interpret=True, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), T, atol=0.05)


def test_icp_fixed_iters_banded_fused_v2_matches_pallas_interpret(rng):
    src, mask, dst, dmask, T = _banded_inputs(rng)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = T[:3, 3] * 0.5
    ours = ticp.icp_fixed_iters_banded_fused_v2(
        _t(src), _t(mask), _t(dst), _t(dmask), _t(init), device="cpu",
        **BANDED_KW)
    ref = jicp.icp_fixed_iters_banded_fused_v2(
        jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst),
        jnp.asarray(dmask), jnp.asarray(init), interpret=True, **BANDED_KW)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), T, atol=0.05)


def test_icp_refine_exact_matches_reference_loop(rng):
    """`icp_refine_exact` (K1) against `pctpu/register/icp.py:683-697`
    rebuilt around `nearest_pallas(interpret=True)`: subsample stride 3."""
    src, dst, T = _pair(rng, 1500, rot=0.01, trans=0.1)
    mask = rng.uniform(size=1500) > 0.05
    T0 = np.eye(4, dtype=np.float32)
    kw = dict(iters=2, subsample=500, dist_thresh=2.0)
    ours = ticp.icp_refine_exact(_t(src), _t(mask), _t(dst), _t(mask),
                                 _t(T0), device="cpu", **kw)
    s, m, d = jnp.asarray(src), jnp.asarray(mask), jnp.asarray(dst)
    q, qm = s[::3][:500], m[::3][:500]
    Tr = jnp.asarray(T0)
    for _ in range(2):
        qt = jse3.apply_transform(Tr, q)
        d2, idx = j_nearest_pallas(qt, d, m, query_tile=256, db_tile=512,
                                   interpret=True)
        w = (qm & (d2 < jnp.float32(2.0) ** 2)).astype(jnp.float32)
        R, t = j_procrustes(qt, d[idx], w)
        Tr = jse3.make_transform(R, t) @ Tr
    np.testing.assert_allclose(ours.numpy(), np.asarray(Tr), atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), T, atol=0.05)


def test_icp_point_to_point_matches_jax(rng):
    """The while-loop ICP (K1 association; the reference's CPU 1-NN takes
    the a^2+b^2-2ab expansion, so near-ties could differ): T within 1e-4,
    the same iteration count and association count."""
    src, dst, T = _pair(rng, 800, rot=0.02, trans=0.2)
    mask = rng.uniform(size=800) > 0.05
    cfg = dict(max_iters=30, dist_thresh=2.0, query_chunk=256)
    ours = ticp.icp_point_to_point(_t(src), _t(mask), _t(dst), _t(mask),
                                   cfg=ticp.ICPConfig(**cfg), device="cpu")
    ref = jicp.icp_point_to_point(jnp.asarray(src), jnp.asarray(mask),
                                  jnp.asarray(dst), jnp.asarray(mask),
                                  cfg=jicp.ICPConfig(**cfg))
    np.testing.assert_allclose(ours.T.numpy(), np.asarray(ref.T), atol=1e-4)
    assert int(ours.iters) == int(ref.iters) and bool(ours.converged)
    assert int(ours.num_assoc) == int(ref.num_assoc)
    # rmse^2 is a mean d2 of ~3e-4 m^2; the expansion's f32 error is
    # ulp(|p|^2) ~ 1e-3 m^2 at |p| ~ 60 m, K1's direct differences are exact
    assert abs(float(ours.rmse) ** 2 - float(ref.rmse) ** 2) < 2e-3


@pytest.mark.parametrize("trim,atol", [(1.0, 1e-4), (0.8, 5e-4)])
def test_icp_fixed_iters_matches_jax(rng, trim, atol):
    """With trim < 1 the kept set is cut by rank of d2; the reference's
    CPU d2 (the a^2+b^2-2ab expansion, f32 error ~1e-3 m^2 at |p| ~ 60 m)
    reorders near-equal distances at the cut, hence 5e-4 there."""
    src, dst, T = _pair(rng, 600, outlier=0.1)
    mask = np.ones(600, bool)
    kw = dict(iters=6, dist_thresh=3.0, query_chunk=256, trim=trim)
    ours = ticp.icp_fixed_iters(_t(src), _t(mask), _t(dst), _t(mask),
                                device="cpu", **kw)
    ref = jicp.icp_fixed_iters(jnp.asarray(src), jnp.asarray(mask),
                               jnp.asarray(dst), jnp.asarray(mask), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=atol)
    np.testing.assert_allclose(ours.numpy(), T, atol=0.05)


@pytest.mark.parametrize("active", [None, True, False])
def test_trim_weights_matches_jax(rng, active):
    d2 = rng.uniform(0, 4, 500).astype(np.float32)
    w = (rng.uniform(size=500) > 0.3).astype(np.float32)
    ours = ticp._trim_weights(_t(w), _t(d2), 0.7, active=active)
    ref = jicp._trim_weights(jnp.asarray(w), jnp.asarray(d2), 0.7,
                             active=active)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


def _pair_batch(rng, b, n):
    srcs, dsts, Ts = zip(*[_pair(rng, n) for _ in range(b)])
    return np.stack(srcs), np.stack(dsts), np.stack(Ts)


def test_batched_icp_matches_jax(rng):
    src, dst, Ts = _pair_batch(rng, 3, 400)
    mask = np.ones((3, 400), bool)
    ours = tsweep.batched_icp(_t(src), _t(mask), _t(dst), _t(mask), iters=6,
                              query_chunk=128, device="cpu")
    ref = jsweep.batched_icp(jnp.asarray(src), jnp.asarray(mask),
                             jnp.asarray(dst), jnp.asarray(mask), iters=6,
                             query_chunk=128)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)


def test_batched_icp_mega_matches_pallas_interpret(rng):
    """tests/test_parallel.py:469 at a small size: K4 (plain version)."""
    src, dst, Ts = _pair_batch(rng, 3, 512)
    mask = np.ones((3, 512), bool)
    kw = dict(coarse_iters=4, polish_iters=1, block=128, window_blocks=1,
              query_tile=128)
    ours = tsweep.batched_icp_mega(_t(src), _t(mask), _t(dst), _t(mask),
                                   device="cpu", **kw)
    ref = jsweep.batched_icp_mega(jnp.asarray(src), jnp.asarray(mask),
                                  jnp.asarray(dst), jnp.asarray(mask),
                                  interpret=True, **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), Ts, atol=0.05)


@pytest.mark.parametrize("solver", ["polar", "svd"])
def test_procrustes_from_moments_matches_jax(rng, solver):
    """R, t from M = sum w [p;1][q;1]^T within 1e-5 / 1e-4 (a proper
    rotation, also for a reflected H in the polar case)."""
    src, dst, T = _pair(rng, 300, rot=0.5, trans=3.0, noise=0.05)
    w = (rng.uniform(size=300) > 0.2).astype(np.float32)
    hp = np.concatenate([src, np.ones((300, 1), np.float32)], 1) * w[:, None]
    hq = np.concatenate([dst, np.ones((300, 1), np.float32)], 1)
    M = (hp.T.astype(np.float64) @ hq).astype(np.float32)
    R, t = procrustes_from_moments(_t(M), solver=solver)
    Rr, tr = j_pfm(jnp.asarray(M), solver=solver)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rr), atol=1e-5)
    np.testing.assert_allclose(t.numpy(), np.asarray(tr), atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(R.numpy()), 1.0, atol=1e-5)
    Tt = procrustes_transform(_t(src), _t(dst), _t(w))
    np.testing.assert_allclose(Tt.numpy(), np.asarray(j_ptrans(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w))), atol=1e-4)
