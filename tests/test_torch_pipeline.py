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
    """The JAX config's dict carries across; a field that selects another
    path, or an unknown field, is refused."""
    d = dataclasses.asdict(jpipe.RegistrationConfig(**CFG))
    cfg = tpipe.RegistrationConfig.from_dict(d)
    assert cfg.voxel_size == 1.0 and cfg.downsample_capacity == 1024
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == d[f.name]
    with pytest.raises(ValueError, match="keypoints"):
        tpipe.RegistrationConfig.from_dict(dict(d, keypoints="iss"))
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
