"""The port's registration stage against the JAX package: polar
Procrustes, the triad rigid fit, batched RANSAC (fed the JAX package's own
draws), RANSAC's select and refine on its degenerate cases, the band
layout and kernel K4 through both ICP entry points (plain version on the
CPU, against the Pallas kernel in interpret mode)."""
import torch_threads as _torch_threads  # noqa: F401

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.core import se3 as j_se3
from pctpu.ops.pallas_banded import build_banded as j_build_banded
from pctpu.register.icp import (
    icp_fixed_iters_banded_mega_batch as j_icp_mega,
    icp_refine_exact_mega_batch as j_refine)
from pctpu.register.procrustes import rotation_polar3 as j_polar
from pctpu.register.procrustes import weighted_procrustes as j_procrustes
from pctpu.register.ransac import _triad_rigid as j_triad
from pctpu.register.ransac import ransac_registration_batch as j_ransac
from pctpu_torch.ops.pallas_banded import build_banded
from pctpu_torch.register.icp import (_pad_pow2,
                                      icp_fixed_iters_banded_mega_batch,
                                      icp_refine_exact_mega_batch)
from pctpu_torch.register.procrustes import (rotation_polar3,
                                             weighted_procrustes)
from pctpu_torch.register import ransac
from pctpu_torch.register.ransac import (_triad_rigid, generator_sampler,
                                         ransac_registration_batch)

from ransac_cases import CASES, DIST, refine_inputs, unsure_rows


def _t(x):
    return torch.from_numpy(np.array(x))


def _rigid(rng, scale_rot=0.3, scale_t=2.0):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec(
        rng.normal(scale=scale_rot, size=3)).as_matrix()
    T[:3, 3] = rng.normal(scale=scale_t, size=3)
    return T


def _pairs(rng, b, n, noise=0.01, extent=20.0):
    """b (src, dst = T src + noise) pairs of n uniform points, and T."""
    src = rng.uniform(-extent, extent, (b, n, 3)).astype(np.float32)
    Ts = np.stack([_rigid(rng, 0.02, 0.3) for _ in range(b)])
    dst = (np.einsum("bij,bnj->bni", Ts[:, :3, :3], src)
           + Ts[:, None, :3, 3]
           + rng.normal(scale=noise, size=src.shape)).astype(np.float32)
    return src, dst, Ts


def test_weighted_procrustes_matches_jax(rng):
    """Polar solver (never SVD): R and t within 1e-5 of the reference,
    batched here against the reference's per-pair call."""
    b, n = 4, 200
    src = rng.normal(scale=10.0, size=(b, n, 3)).astype(np.float32)
    Ts = np.stack([_rigid(rng) for _ in range(b)])
    dst = (np.einsum("bij,bnj->bni", Ts[:, :3, :3], src)
           + Ts[:, None, :3, 3]
           + rng.normal(scale=0.05, size=src.shape)).astype(np.float32)
    w = (rng.uniform(size=(b, n)) > 0.3).astype(np.float32)
    R, t = weighted_procrustes(_t(src), _t(dst), _t(w))
    for i in range(b):
        Rr, tr = j_procrustes(jnp.asarray(src[i]), jnp.asarray(dst[i]),
                              jnp.asarray(w[i]))
        np.testing.assert_allclose(R[i].numpy(), np.asarray(Rr), atol=1e-5)
        np.testing.assert_allclose(t[i].numpy(), np.asarray(tr), atol=1e-4)


def test_rotation_polar3_reflection_and_rank_deficient(rng):
    """det(H) < 0 (reflection flip), rank-2 H (closed-form fallback) and
    H = 0 (identity) match the reference within 1e-5. (A numerically
    rank-1 H determines no rotation: both sides then return an arbitrary
    one, decided by f32 noise, so it is not compared.)"""
    Hs = [rng.normal(size=(3, 3)) for _ in range(4)]
    Hs[1][:, 2] *= -1.0                                   # flip det sign
    u, v = rng.normal(size=3), rng.normal(size=3)
    Hs.append(np.outer(u, v) + np.outer(v, rng.normal(size=3)))  # rank 2
    Hs.append(np.zeros((3, 3)))
    H = np.stack(Hs).astype(np.float32)
    ours = rotation_polar3(_t(H)).numpy()
    for i in range(len(Hs)):
        ref = np.asarray(j_polar(jnp.asarray(H[i])))
        np.testing.assert_allclose(ours[i], ref, atol=1e-5)
        np.testing.assert_allclose(np.linalg.det(ours[i]), 1.0, atol=1e-4)


def test_triad_rigid_matches_jax(rng):
    s = rng.normal(scale=5.0, size=(64, 3, 3)).astype(np.float32)
    s[0, 2] = s[0, 1]                                        # degenerate
    T = _rigid(rng)
    d = (s @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    ours = _triad_rigid(_t(s), _t(d))
    ref = j_triad(jnp.asarray(s), jnp.asarray(d))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref[0]),
                               atol=1e-5)
    np.testing.assert_allclose(ours[1].numpy(), np.asarray(ref[1]),
                               atol=1e-4)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    assert not bool(ours[2][0])


def _jax_sampler(keys):
    """The reference's own draws (`ransac.py:204`), for both sides."""
    def sample(nv, H):
        u = jax.vmap(lambda k, n: jax.random.randint(k, (H, 3), 0, n))(
            keys, jnp.asarray(nv.numpy()))
        return torch.from_numpy(np.array(u))
    return sample


def test_ransac_batch_matches_jax_with_jax_draws(rng):
    """Same draws on both sides: T within 1e-4, inlier counts, masks
    ([B, m_cap], the capped prefix) and fitness equal."""
    b, m, H, m_cap = 3, 300, 512, 200
    src = rng.uniform(-20, 20, (b, m, 3)).astype(np.float32)
    Ts = np.stack([_rigid(rng, 0.5, 3.0) for _ in range(b)])
    dst = (np.einsum("bij,bnj->bni", Ts[:, :3, :3], src)
           + Ts[:, None, :3, 3]
           + rng.normal(scale=0.02, size=src.shape)).astype(np.float32)
    bad = rng.uniform(size=(b, m)) < 0.4
    dst[bad] = rng.uniform(-60, 60, (int(bad.sum()), 3))
    valid = rng.uniform(size=(b, m)) > 0.2
    keys = jax.random.split(jax.random.PRNGKey(3), b)
    kw = dict(dist_thresh=0.5, num_hypotheses=H, m_cap=m_cap)
    ours = ransac_registration_batch(_t(src), _t(dst), _t(valid),
                                     _jax_sampler(keys), **kw)
    ref = j_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
                   keys, **kw)
    np.testing.assert_allclose(ours.T.numpy(), np.asarray(ref.T), atol=1e-4)
    np.testing.assert_array_equal(ours.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert ours.inlier_mask.shape == (b, m_cap)
    np.testing.assert_array_equal(ours.inlier_mask.numpy(),
                                  np.asarray(ref.inlier_mask))
    np.testing.assert_allclose(ours.fitness.numpy(), np.asarray(ref.fitness),
                               rtol=1e-6)
    for i in range(b):
        np.testing.assert_allclose(ours.T[i].numpy(), Ts[i], atol=0.05)


def test_ransac_generator_sampler_recovers_transform(rng):
    """The default torch.Generator draws find the transform too."""
    b, m = 2, 256
    src = rng.uniform(-20, 20, (b, m, 3)).astype(np.float32)
    Ts = np.stack([_rigid(rng, 0.5, 3.0) for _ in range(b)])
    dst = (np.einsum("bij,bnj->bni", Ts[:, :3, :3], src)
           + Ts[:, None, :3, 3]).astype(np.float32)
    dst[:, :80] = rng.uniform(-60, 60, (b, 80, 3))
    gen = torch.Generator().manual_seed(0)
    out = ransac_registration_batch(_t(src), _t(dst),
                                    torch.ones((b, m), dtype=torch.bool),
                                    generator_sampler(gen), dist_thresh=0.5,
                                    num_hypotheses=512)
    for i in range(b):
        np.testing.assert_allclose(out.T[i].numpy(), Ts[i], atol=1e-3)


def _jax_select_refine(scores, inl, src, dst, valid, n_valid, thresh2):
    """The JAX package's select, refine and result
    (`pctpu/register/ransac.py:253-269`), on the same inputs."""
    best = jnp.argmax(scores, axis=1)
    w = jnp.take_along_axis(inl, best[:, None, None], axis=1)[:, 0]
    R, t = jax.vmap(j_procrustes)(src, dst, w.astype(jnp.float32))
    err2 = jnp.sum((jnp.einsum("bij,bmj->bmi", R, src,
                               precision=jax.lax.Precision.HIGHEST)
                    + t[:, None, :] - dst) ** 2, axis=-1)
    mask = (err2 < thresh2) & valid
    inliers = jnp.sum(mask, axis=1).astype(jnp.int32)
    return (jax.vmap(j_se3.make_transform)(R, t), inliers, mask,
            inliers / n_valid)


@pytest.mark.parametrize("case", CASES)
def test_select_refine_plain_matches_jax(rng, case):
    """`_select_refine_plain` against the JAX package's select and refine:
    T within 1e-5 (R) and 1e-4 m (t), the inlier mask equal wherever no
    residual lies within 1e-4 m of the threshold, counts and fitness
    consistent with the mask. "collinear" and "zero" take the fallback's
    identity, "coplanar" its rank-2 form, "reflection" the Newton flip;
    "ties" the first of three rows sharing the maximum score."""
    args = refine_inputs(rng, 4, 64, 200, case)
    scores, inl, src, dst, valid, n_valid, thresh2 = args
    ours = ransac._select_refine_plain(*(_t(x) for x in args[:6]), thresh2)
    ref = _jax_select_refine(*(jnp.asarray(x) for x in args[:6]), thresh2)
    T, Tr = ours.T.numpy(), np.asarray(ref[0])
    np.testing.assert_allclose(T[:, :3, :3], Tr[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(T[:, :3, 3], Tr[:, :3, 3], atol=1e-4)
    np.testing.assert_array_equal(T[:, 3], Tr[:, 3])
    sure = ~unsure_rows([T, Tr], src, dst, DIST)
    mask, mask_r = ours.inlier_mask.numpy(), np.asarray(ref[2])
    np.testing.assert_array_equal(mask[sure], mask_r[sure])
    np.testing.assert_array_equal(ours.inliers.numpy(), mask.sum(1))
    np.testing.assert_allclose(ours.fitness.numpy(), mask.sum(1) / n_valid,
                               rtol=1e-7)
    if case in ("zero", "collinear"):
        np.testing.assert_array_equal(T[:, :3, :3],
                                      np.broadcast_to(np.eye(3), (4, 3, 3)))
    if case == "ties":
        first = np.argmax(scores, axis=1)
        assert (first > 0).all()
        w = inl[np.arange(4), first].astype(np.float32)
        R1, _ = weighted_procrustes(_t(src), _t(dst), _t(w))
        np.testing.assert_array_equal(T[:, :3, :3], R1.numpy())


@pytest.mark.parametrize("bad", ["scores_int64", "inl_uint8", "src_f64",
                                 "valid_f32", "n_valid_i32", "inl_short_m",
                                 "src_other_batch", "n_valid_2d",
                                 "no_hypothesis"])
def test_ransac_refine_rejects_bad_inputs(rng, bad):
    """The wrapper raises on a mismatched shape or dtype before it picks a
    path (here the CPU's plain chain)."""
    x = dict(zip(("scores", "inl", "src", "dst", "valid", "n_valid"),
                 (_t(a) for a in refine_inputs(rng, 2, 8, 16,
                                               "random")[:6])))
    change = {
        "scores_int64": ("scores", lambda v: v.long()),
        "inl_uint8": ("inl", lambda v: v.to(torch.uint8)),
        "src_f64": ("src", lambda v: v.double()),
        "valid_f32": ("valid", lambda v: v.float()),
        "n_valid_i32": ("n_valid", lambda v: v.int()),
        "inl_short_m": ("inl", lambda v: v[:, :, :-1]),
        "src_other_batch": ("src", lambda v: v[:1]),
        "n_valid_2d": ("n_valid", lambda v: v[:, None]),
        "no_hypothesis": ("scores", lambda v: v[:, :0]),
    }[bad]
    x[change[0]] = change[1](x[change[0]])
    if bad == "no_hypothesis":
        x["inl"] = x["inl"][:, :0]
    with pytest.raises(ValueError, match="ransac_refine"):
        ransac.ransac_refine(*x.values(), float(np.float32(DIST)) ** 2)


def test_build_banded_matches_jax(rng):
    """Sort axis, order (stable argsort), layout and LUT: exact; pen2 =
    |b|^2 + penalty within 1 ulp (rtol 2e-7: the 3-term sum's order)."""
    db = rng.uniform(-20, 20, (2, 700, 3)).astype(np.float32)
    db[1, :, 1] *= 3.0                                   # widest axis y
    mask = rng.uniform(size=(2, 700)) > 0.2
    ours = build_banded(_t(db), _t(mask), block=256)
    for i in range(2):
        ref = j_build_banded(jnp.asarray(db[i]), jnp.asarray(mask[i]),
                             block=256)
        assert int(ours.axis[i]) == int(ref.axis)
        for name in ("dbt", "penalty", "coords", "order", "lut", "dbt4"):
            np.testing.assert_array_equal(
                getattr(ours, name)[i].numpy(),
                np.asarray(getattr(ref, name)), err_msg=name)
        np.testing.assert_allclose(ours.pen2[i].numpy(),
                                   np.asarray(ref.pen2), rtol=2e-7)


def test_pad_pow2_edge_mode():
    pts = torch.arange(15, dtype=torch.float32).reshape(1, 5, 3)
    mask = torch.ones((1, 5), dtype=torch.bool)
    p, m = _pad_pow2(pts, mask, axis=1)
    assert p.shape == (1, 8, 3) and m.tolist() == [[True] * 5 + [False] * 3]
    assert torch.equal(p[0, 5:], pts[0, 4:5].expand(3, 3))


@pytest.mark.parametrize("window_blocks,coarse,polish",
                         [(1, 4, 1), (2, 5, 0)])
def test_icp_mega_batch_matches_pallas_interpret(rng, window_blocks, coarse,
                                                 polish):
    """K4 (plain version) through the voxel-stage ICP against the
    Pallas kernel in interpret mode: the LUT window path (window_blocks <
    nb) and the full window; T within 1e-4."""
    src, dst, Ts = _pairs(rng, 2, 500)
    mask = rng.uniform(size=(2, 500)) > 0.05
    kw = dict(coarse_iters=coarse, polish_iters=polish, dist_thresh=5.0,
              block=128, window_blocks=window_blocks, query_tile=128)
    ours = icp_fixed_iters_banded_mega_batch(_t(src), _t(mask), _t(dst),
                                             _t(mask), **kw).numpy()
    ref = np.asarray(j_icp_mega(jnp.asarray(src), jnp.asarray(mask),
                                jnp.asarray(dst), jnp.asarray(mask),
                                interpret=True, **kw))
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    for i in range(2):
        np.testing.assert_allclose(ours[i], Ts[i], atol=0.1)


def test_icp_refine_exact_matches_pallas_interpret(rng):
    """K4 (plain version) through the exact refine ICP, shapes as in
    tests/test_register.py::test_refine_exact_mega_matches_xla (subsample
    512 against 1024, block 512, query tile 128): T within 1e-4."""
    src, dst, Ts = _pairs(rng, 2, 1024)
    mask = np.ones((2, 1024), bool)
    T0 = np.tile(np.eye(4, dtype=np.float32), (2, 1, 1))
    q, qm = src[:, ::2], mask[:, ::2]
    kw = dict(iters=2, dist_thresh=5.0, block=512, query_tile=128)
    ours = icp_refine_exact_mega_batch(_t(q), _t(qm), _t(dst), _t(mask),
                                       _t(T0), **kw).numpy()
    ref = np.asarray(j_refine(jnp.asarray(q), jnp.asarray(qm),
                              jnp.asarray(dst), jnp.asarray(mask),
                              jnp.asarray(T0), interpret=True, **kw))
    np.testing.assert_allclose(ours, ref, atol=1e-4)
    for i in range(2):
        np.testing.assert_allclose(ours[i], Ts[i], atol=5e-2)
