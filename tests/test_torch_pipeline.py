"""The whole slice: the port's `register_pairs` (fused FPFH + mega ICP,
plain kernel versions on the CPU) against the JAX package's
`register_pairs` on the same structured 2-pair scene. On the CPU the JAX
package runs its dense-FPFH / while-loop ICP path, so the two are not
expected to agree exactly: both must pass the reference's success bound
and agree with each other within 0.1 m and 0.5 deg."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.core import se3 as jse3
from pctpu.core.cloud import PointCloud as JCloud
from pctpu.register import pipeline as jpipe
from pctpu_torch.core import se3
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.register import pipeline as tpipe

# tests/test_pipeline.py:86-89
CFG = dict(voxel_size=1.0, feature_radius=5.0, ransac_dist=1.5,
           ransac_hypotheses=2048, icp_dist_thresh=2.0, icp_query_chunk=1024,
           downsample_capacity=1024)


def make_structured_scene(rng, n=2000):
    """Ground + box walls (tests/test_pipeline.py:15-33)."""
    pts = []
    g = rng.uniform(-20, 20, (n // 2, 3)).astype(np.float32)
    g[:, 2] = rng.normal(scale=0.05, size=n // 2)
    pts.append(g)
    for _ in range(4):
        c = rng.uniform(-15, 15, 2)
        w = rng.uniform(1, 3, 2)
        h = rng.uniform(2, 5)
        face = rng.uniform(-1, 1, (n // 8, 3)).astype(np.float32)
        face[:, 0] = c[0] + w[0] * np.sign(face[:, 0])
        face[:, 1] = c[1] + w[1] * face[:, 1]
        face[:, 2] = h * (face[:, 2] + 1) / 2
        pts.append(face)
    return np.concatenate(pts).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(0)
    src_np = make_structured_scene(rng)
    srcs, dsts, gts = [], [], []
    for i in range(2):
        R = Rotation.from_rotvec(
            [0, 0, np.radians(10.0 + 7.0 * i)]).as_matrix().astype(np.float32)
        t = np.array([2.0 + i, -1.0, 0.1 * i], np.float32)
        dsts.append((src_np @ R.T + t + rng.normal(
            scale=0.02, size=src_np.shape)).astype(np.float32))
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, t
        srcs.append(src_np)
        gts.append(T)
    return np.stack(srcs), np.stack(dsts), np.stack(gts)


def _jax_sampler(keys):
    def sample(nv, H):
        u = jax.vmap(lambda k, n: jax.random.randint(k, (H, 3), 0, n))(
            keys, jnp.asarray(nv.numpy()))
        return torch.from_numpy(np.array(u))
    return sample


def test_config_from_jax_dict():
    """The JAX config's dict carries across, the ISS keypoint option, its
    four parameters and the dense FPFH backend included; a value the
    reference does not take, or an unknown field, is refused."""
    d = dataclasses.asdict(jpipe.RegistrationConfig(
        **CFG, keypoints="iss", iss_salient_radius=2.5, iss_nonmax_radius=1.5,
        iss_min_neighbors=7, iss_k_cap=48, feature_backend="dense"))
    cfg = tpipe.RegistrationConfig.from_dict(d)
    assert cfg.voxel_size == 1.0 and cfg.downsample_capacity == 1024
    assert {f.name for f in dataclasses.fields(cfg)} == set(d)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == d[f.name]
    assert (cfg.keypoints, cfg.feature_backend, cfg.iss_k_cap) == \
        ("iss", "dense", 48)
    with pytest.raises(ValueError, match="keypoints"):
        tpipe.RegistrationConfig.from_dict(dict(d, keypoints="harris"))
    with pytest.raises(ValueError, match="feature_backend"):
        tpipe.RegistrationConfig.from_dict(dict(d, feature_backend="pallas"))
    with pytest.raises(ValueError, match="unknown"):
        tpipe.RegistrationConfig.from_dict(dict(d, bogus=1))


def test_icp_stats_subsampled_matches_jax(scene, monkeypatch):
    """Stats pass (K1, plain on the CPU): inlier count equal, RMSE within
    1e-5, per pair against the JAX helper run on its TPU path (the Pallas
    1-NN in interpret mode: direct differences, as K1 computes; the CPU
    default would take the a^2+b^2-2ab expansion instead)."""
    import importlib

    from pctpu.ops.pallas_nn import nearest_pallas
    monkeypatch.setattr(
        importlib.import_module("pctpu.ops.knn"), "nearest",
        lambda q, db, m, chunk, backend: nearest_pallas(q, db, m,
                                                        interpret=True))
    src, dst, gts = scene
    b, n = src.shape[:2]
    mask = np.ones((b, n), bool)
    cfg = tpipe.RegistrationConfig(stats_subsample=256, icp_dist_thresh=2.0)
    jcfg = jpipe.RegistrationConfig(stats_subsample=256, icp_dist_thresh=2.0)
    num, rmse = tpipe._icp_stats_subsampled(
        torch.from_numpy(gts), PointCloud(torch.from_numpy(src),
                                          torch.from_numpy(mask)),
        PointCloud(torch.from_numpy(dst), torch.from_numpy(mask)), cfg)
    for i in range(b):
        jn, jr = jpipe._icp_stats_subsampled(
            jnp.asarray(gts[i]), JCloud(jnp.asarray(src[i]),
                                        jnp.asarray(mask[i])),
            JCloud(jnp.asarray(dst[i]), jnp.asarray(mask[i])), jcfg)
        assert int(num[i]) == int(jn)
        np.testing.assert_allclose(float(rmse[i]), float(jr), rtol=1e-5)


def test_register_pairs_matches_jax(scene):
    src, dst, gts = scene
    b, n = src.shape[:2]
    mask = np.ones((b, n), bool)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    ref = jpipe.register_pairs(
        JCloud(jnp.asarray(src), jnp.asarray(mask)),
        JCloud(jnp.asarray(dst), jnp.asarray(mask)), keys=keys,
        cfg=jpipe.RegistrationConfig(**CFG))
    cfg = tpipe.RegistrationConfig.from_dict(
        dataclasses.asdict(jpipe.RegistrationConfig(**CFG)))
    out = tpipe.register_pairs(
        PointCloud(torch.from_numpy(src), torch.from_numpy(mask)),
        PointCloud(torch.from_numpy(dst), torch.from_numpy(mask)), cfg=cfg,
        sampler=_jax_sampler(keys), device="cpu")
    assert out.T.shape == (b, 4, 4) and out.T.dtype == torch.float32
    assert torch.isfinite(out.T).all() and torch.isfinite(out.icp_rmse).all()
    gt = torch.from_numpy(gts)
    rte, rre = se3.pose_diff_rte_rre(out.T, gt)
    jrte, jrre = jse3.pose_diff_rte_rre(ref.T, jnp.asarray(gts))
    # the reference's success bound (evaluate_rt.py:16-18), both sides
    assert float(rte.max()) < 2.0 and float(rre.max()) < 5.0, (rte, rre)
    assert float(jnp.max(jrte)) < 2.0 and float(jnp.max(jrre)) < 5.0
    # and the two agree
    drte, drre = se3.pose_diff_rte_rre(out.T, torch.from_numpy(
        np.array(ref.T)))
    assert float(drte.max()) < 0.1 and float(drre.max()) < 0.5, (drte, drre)
    np.testing.assert_array_equal(out.src_voxels.numpy(),
                                  np.asarray(ref.src_voxels))
    assert int(out.num_matches.min()) > 20
    assert out.icp_iters.tolist() == [16, 16]


def test_register_pairs_while_matches_jax(scene):
    """`icp_backend="while"`: each pair's convergence-tested ICP (K1,
    plain on the CPU) from its RANSAC pose, against the JAX package's
    `register_pairs`, which takes the same while-loop ICP on the CPU. The
    front ends differ (fused FPFH here, dense there), so the poses agree
    within the bound of `test_register_pairs_matches_jax`; the iteration
    counts come from the same convergence test."""
    src, dst, gts = scene
    b, n = src.shape[:2]
    mask = np.ones((b, n), bool)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    cfg = dict(CFG, icp_backend="while")
    ref = jpipe.register_pairs(
        JCloud(jnp.asarray(src), jnp.asarray(mask)),
        JCloud(jnp.asarray(dst), jnp.asarray(mask)), keys=keys,
        cfg=jpipe.RegistrationConfig(**cfg))
    out = tpipe.register_pairs(
        PointCloud(torch.from_numpy(src), torch.from_numpy(mask)),
        PointCloud(torch.from_numpy(dst), torch.from_numpy(mask)),
        cfg=tpipe.RegistrationConfig(**cfg), sampler=_jax_sampler(keys),
        device="cpu")
    rte, rre = se3.pose_diff_rte_rre(out.T, torch.from_numpy(gts))
    assert float(rte.max()) < 2.0 and float(rre.max()) < 5.0, (rte, rre)
    drte, drre = se3.pose_diff_rte_rre(out.T, torch.from_numpy(
        np.array(ref.T)))
    assert float(drte.max()) < 0.1 and float(drre.max()) < 0.5, (drte, drre)
    assert out.icp_iters.shape == (b,)
    assert int(out.icp_iters.min()) >= 1
    assert int(out.icp_iters.max()) <= tpipe.RegistrationConfig().icp_max_iters


def _run_both(scene, **extra):
    """The reference's and the port's `register_pairs` on the scene with
    the same draws and `CFG` plus `extra`."""
    src, dst, gts = scene
    b, n = src.shape[:2]
    mask = np.ones((b, n), bool)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    jcfg = jpipe.RegistrationConfig(**CFG, **extra)
    ref = jpipe.register_pairs(
        JCloud(jnp.asarray(src), jnp.asarray(mask)),
        JCloud(jnp.asarray(dst), jnp.asarray(mask)), keys=keys, cfg=jcfg)
    out = tpipe.register_pairs(
        PointCloud(torch.from_numpy(src), torch.from_numpy(mask)),
        PointCloud(torch.from_numpy(dst), torch.from_numpy(mask)),
        cfg=tpipe.RegistrationConfig.from_dict(dataclasses.asdict(jcfg)),
        sampler=_jax_sampler(keys), device="cpu")
    return ref, out, gts


def _within_bounds(ref, out, gts):
    """Both within the reference's success bound, and within 0.1 m and
    0.5 deg of each other (the bounds of `test_register_pairs_matches_jax`:
    the reference's CPU path runs the while-loop ICP)."""
    rte, rre = se3.pose_diff_rte_rre(out.T, torch.from_numpy(gts))
    assert float(rte.max()) < 2.0 and float(rre.max()) < 5.0, (rte, rre)
    jrte, jrre = jse3.pose_diff_rte_rre(ref.T, jnp.asarray(gts))
    assert float(jnp.max(jrte)) < 2.0 and float(jnp.max(jrre)) < 5.0
    drte, drre = se3.pose_diff_rte_rre(out.T, torch.from_numpy(
        np.array(ref.T)))
    assert float(drte.max()) < 0.1 and float(drre.max()) < 0.5, (drte, drre)


def test_register_pairs_iss_matches_jax(scene):
    """`keypoints="iss"`: matching and RANSAC only at each voxel cloud's
    ISS keypoints (K2/K3 FPFH and K4 ICP, plain on the CPU), against the
    reference's run with the same draws (its CPU path: dense FPFH and the
    while-loop ICP). Matching among some 50 keypoints a cloud, the
    descriptors' bin flips move a few matches: within 3 or 10%, and fewer
    than at every voxel point."""
    ref, out, gts = _run_both(scene, keypoints="iss")
    _within_bounds(ref, out, gts)
    src, dst, _ = scene
    mask = torch.ones(src.shape[:2], dtype=torch.bool)
    full = tpipe.register_pairs(
        PointCloud(torch.from_numpy(src), mask),
        PointCloud(torch.from_numpy(dst), mask),
        cfg=tpipe.RegistrationConfig(**CFG), device="cpu")
    ours, theirs = out.num_matches.numpy(), np.asarray(ref.num_matches)
    assert np.all(np.abs(ours - theirs) <= np.maximum(3, 0.1 * theirs))
    assert np.all(ours < full.num_matches.numpy()) and ours.min() >= 10


def test_register_pairs_dense_features_match_jax(scene):
    """`feature_backend="dense"` on both sides: `fpfh_dense` in place of
    K2/K3; matches within 2% of the reference's."""
    ref, out, gts = _run_both(scene, feature_backend="dense")
    _within_bounds(ref, out, gts)
    ours, theirs = out.num_matches.numpy(), np.asarray(ref.num_matches)
    assert np.all(np.abs(ours - theirs) <= 0.02 * theirs), (ours, theirs)


def test_register_pair_iss_matches_jax(scene):
    """`register_pair` with `keypoints="iss"` (kernel 5 and K1, plain on
    the CPU) against the reference's with the same draws (its CPU path:
    the while-loop ICP): both within the success bound and within 0.1 m
    and 0.5 deg of each other; matches within 3 or 10% (neighbour-list
    FPFH on both sides, up to bin flips); and the ISS sites of each voxel
    cloud equal to the reference's."""
    src, dst, gts = scene
    mask = np.ones(src.shape[1], bool)
    key = jax.random.PRNGKey(3)
    jcfg = jpipe.RegistrationConfig(**CFG, keypoints="iss")
    ref = jpipe.register_pair(JCloud(jnp.asarray(src[0]), jnp.asarray(mask)),
                              JCloud(jnp.asarray(dst[0]), jnp.asarray(mask)),
                              key=key, cfg=jcfg)

    def sampler(nv, H):
        return torch.from_numpy(np.array(jax.random.randint(
            key, (H, 3), 0, jnp.int32(int(nv[0])))))[None]
    out = tpipe.register_pair(
        PointCloud(torch.from_numpy(src[0]), torch.from_numpy(mask)),
        PointCloud(torch.from_numpy(dst[0]), torch.from_numpy(mask)),
        cfg=tpipe.RegistrationConfig.from_dict(dataclasses.asdict(jcfg)),
        sampler=sampler, device="cpu")
    rte, rre = se3.pose_diff_rte_rre(out.T, torch.from_numpy(gts[0]))
    assert float(rte) < 2.0 and float(rre) < 5.0
    drte, drre = se3.pose_diff_rte_rre(out.T, torch.from_numpy(
        np.array(ref.T)))
    assert float(drte) < 0.1 and float(drre) < 0.5, (drte, drre)
    assert abs(int(out.num_matches) - int(ref.num_matches)) <= max(
        3, 0.1 * int(ref.num_matches))
    # the sites themselves: the same voxel cloud gives the same keypoints
    for cloud in (src[0], dst[0]):
        jdown, _ = jpipe._cap_uniform(jpipe.voxel_downsample(
            jnp.asarray(cloud), jnp.asarray(mask), jcfg.voxel_size),
            jcfg.downsample_capacity)
        tdown, _ = tpipe._cap_uniform(tpipe.voxel_downsample(
            torch.from_numpy(cloud), torch.from_numpy(mask),
            jcfg.voxel_size), jcfg.downsample_capacity)
        sites = tpipe.keypoint_sites(
            tdown, tpipe.RegistrationConfig(**CFG, keypoints="iss"))
        np.testing.assert_array_equal(
            sites.numpy(), np.asarray(jpipe._iss_sites(jdown, jcfg)))
        assert 20 <= int(sites.sum()) < int(tdown.mask.sum())


@pytest.mark.parametrize("batched", [True, False])
def test_fpfh_dense_matches_jax(batched):
    """`fpfh_dense` against the reference's, batched [B,N,3] and single
    [N,3], with padding rows and a row chunk that does not divide N, on
    the reference's radius normals (on these uniform clouds many
    neighbourhoods are near-isotropic, so each side's own least
    eigenvector is arbitrary there; that `normals=None` takes the port's
    `normals_radius_dense` is checked apart). The same arithmetic, the
    neighbour-weighted sum in another order: 99.9% of the entries within
    1e-3 (measured 4e-4 of the 100-scale blocks), every entry within 25
    (a bin flip moves two entries by 100/count)."""
    from pctpu.features.fpfh_dense import fpfh_dense as j_fpfh_dense
    from pctpu.features.fpfh_dense import normals_radius_dense as j_nrd
    from pctpu_torch.features.fpfh_dense import (fpfh_dense,
                                                 normals_radius_dense)

    rng = np.random.default_rng(4)
    b, n = 2, 300
    pts = rng.uniform(-10, 10, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.1
    nrm = np.asarray(j_nrd(jnp.asarray(pts), jnp.asarray(mask), radius=4.0))
    p, m, nr = (pts, mask, nrm) if batched else (pts[0], mask[0], nrm[0])
    ref = np.asarray(j_fpfh_dense(jnp.asarray(p), mask=jnp.asarray(m),
                                  normals=jnp.asarray(nr), radius=6.0,
                                  row_chunk=128))
    got = fpfh_dense(torch.from_numpy(p), mask=torch.from_numpy(m),
                     normals=torch.from_numpy(nr), radius=6.0,
                     row_chunk=128).numpy()
    assert got.shape == ref.shape == p.shape[:-1] + (33,)
    diff = np.abs(got - ref)
    assert np.mean(diff <= 1e-3) >= 0.999, np.mean(diff <= 1e-3)
    assert diff.max() < 25.0, diff.max()
    assert np.all(got[~m] == 0)
    own = normals_radius_dense(torch.from_numpy(pts), torch.from_numpy(mask),
                               radius=4.0)
    own = own if batched else own[0]
    np.testing.assert_array_equal(
        fpfh_dense(torch.from_numpy(p), mask=torch.from_numpy(m), radius=6.0,
                   row_chunk=128).numpy(),
        fpfh_dense(torch.from_numpy(p), mask=torch.from_numpy(m), normals=own,
                   radius=6.0, row_chunk=128).numpy())
