"""The single-pair slice against the JAX package, on the CPU: k-NN and
radius search, the single-cloud 1-NN, the full-capacity voxel downsample,
kNN normals, the neighbour-list FPFH, single-pair and adaptive RANSAC (fed
the JAX package's own draws), `register_pair` as a whole (both ICP
backends), the config round trip, and the numpy-only IO and evaluation
copies. Inputs come from numpy with a seed."""
import torch_threads as _torch_threads  # noqa: F401

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.core import io as jio
from pctpu.core import se3 as jse3
from pctpu.core.cloud import PointCloud as JCloud
from pctpu.features.fpfh import fpfh as j_fpfh
from pctpu.ops.gather import group_points as j_group
from pctpu.ops.knn import knn as j_knn
from pctpu.ops.knn import radius_search as j_radius
from pctpu.ops.normals import estimate_normals as j_normals
from pctpu.ops.pallas_nn import nearest_pallas
from pctpu.ops.voxel import voxel_downsample as j_voxel
from pctpu.register import evaluate as jeval
from pctpu.register import icp as jicp
from pctpu.register import pipeline as jpipe
from pctpu.register.ransac import ransac_registration as j_ransac
from pctpu.register.ransac import ransac_registration_adaptive as j_adaptive
from pctpu_torch.core import io as tio
from pctpu_torch.core import se3
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.features.fpfh import fpfh
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.knn import knn, nearest, radius_search
from pctpu_torch.ops.normals import estimate_normals
from pctpu_torch.ops.voxel import voxel_downsample
from pctpu_torch.register import evaluate as teval
from pctpu_torch.register import pipeline as tpipe
from pctpu_torch.register.ransac import (ransac_registration,
                                         ransac_registration_adaptive)


def _t(x):
    return torch.from_numpy(np.array(x))


def _structured_scene(rng, n=2000):
    """Ground + box walls (tests/test_pipeline.py:15-33)."""
    g = rng.uniform(-20, 20, (n // 2, 3)).astype(np.float32)
    g[:, 2] = rng.normal(scale=0.05, size=n // 2)
    pts = [g]
    for _ in range(4):
        c, w, h = rng.uniform(-15, 15, 2), rng.uniform(1, 3, 2), \
            rng.uniform(2, 5)
        face = rng.uniform(-1, 1, (n // 8, 3)).astype(np.float32)
        face[:, 0] = c[0] + w[0] * np.sign(face[:, 0])
        face[:, 1] = c[1] + w[1] * face[:, 1]
        face[:, 2] = h * (face[:, 2] + 1) / 2
        pts.append(face)
    return np.concatenate(pts).astype(np.float32)


# ---------------------------------------------------------------------------
# neighbour search, gather, voxel, normals, FPFH
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", [3, 8])
def test_knn_matches_jax(rng, k):
    """k <= 4 takes the argmin passes, k > 4 the stable sort: indices
    equal (no ties in uniform data); distances within 1e-4, the f32 rounding of the
    a^2+b^2-2ab tiles, summed in another order, at |p|^2 ~ 300 m^2 (ulp
    3e-5)."""
    db = rng.uniform(-10, 10, (600, 3)).astype(np.float32)
    q = rng.uniform(-10, 10, (250, 3)).astype(np.float32)
    mask = rng.uniform(size=600) > 0.2
    ours = knn(_t(q), _t(db), k, db_mask=_t(mask), query_chunk=64)
    ref = j_knn(jnp.asarray(q), jnp.asarray(db), k,
                db_mask=jnp.asarray(mask), query_chunk=64)
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(ours.dist2.numpy(), np.asarray(ref.dist2),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(ours.count.numpy(), np.asarray(ref.count))


def test_radius_search_matches_jax(rng):
    """Capped radius search: the uncapped counts equal, the kept
    neighbour sets equal, distances within 1e-5 (|p|^2 ~ 25 m^2)."""
    db = rng.uniform(-5, 5, (500, 3)).astype(np.float32)
    q = db[:200] + rng.normal(scale=0.1, size=(200, 3)).astype(np.float32)
    mask = rng.uniform(size=500) > 0.1
    ours = radius_search(_t(q), _t(db), 1.5, 8, db_mask=_t(mask),
                         query_chunk=64)
    ref = j_radius(jnp.asarray(q), jnp.asarray(db), 1.5, 8,
                   db_mask=jnp.asarray(mask), query_chunk=64)
    np.testing.assert_array_equal(ours.count.numpy(), np.asarray(ref.count))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    v = ours.valid.numpy()
    np.testing.assert_array_equal(ours.idx.numpy()[v], np.asarray(ref.idx)[v])
    np.testing.assert_allclose(ours.dist2.numpy()[v],
                               np.asarray(ref.dist2)[v], rtol=1e-5, atol=1e-5)
    assert int(ours.count.max()) > 8            # the cap binds somewhere


def test_nearest_single_cloud_matches_pallas_interpret(rng):
    """The single-cloud 1-NN (K1, plain version; chunked queries) against
    the Pallas 1-NN: idx equal, d2 within rtol 1e-6."""
    db = rng.uniform(-20, 20, (700, 3)).astype(np.float32)
    q = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    mask = rng.uniform(size=700) > 0.2
    d2, idx = nearest(_t(q), _t(db), _t(mask), query_chunk=128)
    rd2, ridx = nearest_pallas(jnp.asarray(q), jnp.asarray(db),
                               jnp.asarray(mask), interpret=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(rd2), rtol=1e-6)


def test_group_points_matches_jax(rng):
    pts = rng.normal(size=(2, 50, 4)).astype(np.float32)
    idx = rng.integers(0, 50, (2, 7, 5)).astype(np.int32)
    np.testing.assert_array_equal(
        group_points(_t(pts), _t(idx)).numpy(),
        np.asarray(j_group(jnp.asarray(pts), jnp.asarray(idx))))


def test_voxel_downsample_matches_jax(rng):
    """Full-capacity centroid voxels: the same voxel count and mask, the
    centroids in the same (x, y, z) cell order within 1e-5 (f32 segment
    sums against the port's f64 cumsum differences)."""
    pts = rng.uniform(-10, 10, (1500, 3)).astype(np.float32)
    mask = rng.uniform(size=1500) > 0.1
    ours = voxel_downsample(_t(pts), _t(mask), 1.5)
    ref = j_voxel(jnp.asarray(pts), jnp.asarray(mask), 1.5)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(ours.points.numpy(), np.asarray(ref.points),
                               rtol=1e-5, atol=1e-5)
    assert 200 < int(ours.mask.sum()) < 1500


def test_estimate_normals_matches_jax_on_planes(rng):
    """kNN normals on well-conditioned geometry (a tilted plane): on
    degenerate neighbourhoods the least eigenvector is arbitrary.
    |n . n_ref| > 0.999 on every point."""
    g = rng.uniform(-10, 10, (600, 2))
    pts = np.column_stack([g, 0.1 * g[:, 0] - 0.2 * g[:, 1]
                           + rng.normal(scale=0.01, size=600)]
                          ).astype(np.float32)
    ours = estimate_normals(_t(pts), k=12, query_chunk=128).numpy()
    ref = np.asarray(j_normals(jnp.asarray(pts), k=12, query_chunk=128))
    assert np.min(np.abs(np.sum(ours * ref, axis=-1))) > 0.999


def test_fpfh_matches_jax(rng):
    """Neighbour-list FPFH with the same normals on both sides: the
    bin-boundary bound of tests/test_torch_fpfh.py (flip fraction < 2e-3,
    mean |diff| < 0.02, max |diff| < 15)."""
    pts = _structured_scene(rng, 1200)
    mask = rng.uniform(size=1200) > 0.05
    nrm = np.asarray(j_normals(jnp.asarray(pts), mask=jnp.asarray(mask),
                               k=20))
    ours = fpfh(_t(pts), _t(mask), _t(nrm), radius=3.0, k_cap=40).numpy()
    ref = np.asarray(j_fpfh(jnp.asarray(pts), jnp.asarray(mask),
                            jnp.asarray(nrm), radius=3.0, k_cap=40))
    diff = np.abs(ours - ref)[mask]
    flips, mean, mx = np.mean(diff > 0.5), np.mean(diff), np.max(diff)
    assert flips < 2e-3 and mean < 0.02 and mx < 15.0, (flips, mean, mx)


def test_fpfh_on_cpu_tensors_never_takes_the_graph(rng):
    """CPU tensors run the eager body: no graph captured or replayed, no
    key remembered, the same bits on every call."""
    from pctpu_torch.features import fpfh as fpfh_mod
    pts = _t(_structured_scene(rng, 600))
    mask = _t(rng.uniform(size=600) > 0.05)
    counts = (fpfh_mod.fpfh_graph.captures, fpfh_mod.fpfh_graph.replays)
    seen, graphs = dict(fpfh_mod._SEEN), dict(fpfh_mod._GRAPHS)
    outs = [fpfh(pts, mask, radius=3.0, k_cap=40, normal_k=12)
            for _ in range(3)]
    assert (fpfh_mod.fpfh_graph.captures,
            fpfh_mod.fpfh_graph.replays) == counts
    assert dict(fpfh_mod._SEEN) == seen and dict(fpfh_mod._GRAPHS) == graphs
    assert all(torch.equal(o, outs[0]) for o in outs[1:])
    assert torch.equal(outs[0], fpfh_mod._fpfh_body(pts, mask, None, 3.0, 40,
                                                    12))


# ---------------------------------------------------------------------------
# RANSAC, single pair
# ---------------------------------------------------------------------------

def _correspondences(rng, m=300, inlier=0.5):
    src = rng.uniform(-20, 20, (m, 3)).astype(np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = Rotation.from_rotvec([0.1, -0.2, 0.6]).as_matrix()
    T[:3, 3] = [3.0, -1.0, 0.5]
    dst = (src @ T[:3, :3].T + T[:3, 3]
           + rng.normal(scale=0.05, size=src.shape)).astype(np.float32)
    out = rng.uniform(size=m) > inlier
    dst[out] = rng.uniform(-20, 20, (int(out.sum()), 3))
    valid = rng.uniform(size=m) > 0.1
    return src, dst, valid, T


def _key_sampler(key):
    """The reference's draws (`ransac.py:90`) as the port's sampler."""
    def sample(nv, H):
        u = jax.random.randint(key, (H, 3), 0, int(nv[0]))
        return torch.from_numpy(np.array(u))[None]
    return sample


def test_ransac_registration_matches_jax_with_jax_draws(rng):
    """The same draws: the same best hypothesis, so inlier counts equal
    and T within 1e-4 after the refine."""
    src, dst, valid, T = _correspondences(rng)
    key = jax.random.PRNGKey(3)
    ours = ransac_registration(_t(src), _t(dst), _t(valid), _key_sampler(key),
                               dist_thresh=0.5, num_hypotheses=512)
    ref = j_ransac(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
                   key=key, dist_thresh=0.5, num_hypotheses=512)
    assert int(ours.inliers) == int(ref.inliers)
    np.testing.assert_array_equal(ours.inlier_mask.numpy(),
                                  np.asarray(ref.inlier_mask))
    np.testing.assert_allclose(ours.T.numpy(), np.asarray(ref.T), atol=1e-4)
    np.testing.assert_allclose(ours.T.numpy(), T, atol=0.05)


def test_ransac_adaptive_matches_jax_with_jax_draws(rng):
    """The confidence-gated loop: batch i draws with fold_in(key, i)
    (`ransac.py:318`), fed to the port in order; the same number of
    hypotheses consumed, the same inliers, T within 1e-4."""
    src, dst, valid, _ = _correspondences(rng, inlier=0.3)
    key = jax.random.PRNGKey(5)
    calls = []

    def sample(nv, H):
        u = jax.random.randint(jax.random.fold_in(key, len(calls)), (H, 3),
                               0, int(nv[0]))
        calls.append(H)
        return torch.from_numpy(np.array(u))[None]
    kw = dict(dist_thresh=0.5, batch_hypotheses=64, max_iterations=2000,
              confidence=0.999)
    ours = ransac_registration_adaptive(_t(src), _t(dst), _t(valid), sample,
                                        **kw)
    ref = j_adaptive(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(valid),
                     key=key, **kw)
    assert ours.hypotheses_consumed == ref.hypotheses_consumed
    assert ours.hypotheses_consumed == 64 * len(calls) > 64
    assert int(ours.inliers) == int(ref.inliers)
    np.testing.assert_allclose(ours.T.numpy(), np.asarray(ref.T), atol=1e-4)


# ---------------------------------------------------------------------------
# register_pair and its config
# ---------------------------------------------------------------------------

# tests/test_pipeline.py:50-52, at 2,000 points
CFG = dict(voxel_size=1.0, feature_radius=5.0, ransac_dist=1.5,
           ransac_hypotheses=4096, icp_dist_thresh=2.0, icp_query_chunk=1024)


def test_config_round_trips_every_reference_field():
    """`from_dict(asdict(reference cfg))` keeps every field the port has,
    with the reference's defaults, and the port has every field the
    reference's register_pair reads (`pipeline.py:139-143, 249-265`)."""
    ref = jpipe.RegistrationConfig(normal_k=12, feature_k_cap=50,
                                   icp_max_iters=40, icp_query_chunk=512,
                                   icp_backend="while", icp_fixed_coarse=20,
                                   icp_fixed_polish=2)
    d = dataclasses.asdict(ref)
    cfg = tpipe.RegistrationConfig.from_dict(d)
    own = {f.name for f in dataclasses.fields(cfg)}
    for name in own:
        assert getattr(cfg, name) == d[name], name
    for name in ("normal_k", "feature_k_cap", "icp_max_iters",
                 "icp_query_chunk", "icp_fixed_coarse", "icp_fixed_polish",
                 "icp_backend"):
        assert name in own
    assert own - set(d) == set()
    defaults = dataclasses.asdict(jpipe.RegistrationConfig())
    for f in dataclasses.fields(tpipe.RegistrationConfig):
        assert f.default == defaults[f.name], f.name
    with pytest.raises(ValueError, match="icp_backend"):
        tpipe.RegistrationConfig(icp_backend="grid")


def _pair_clouds(rng, deg=25.0):
    src = _structured_scene(rng)
    R = Rotation.from_rotvec([0, 0, np.radians(deg)]).as_matrix()
    t = np.array([3.0, -2.0, 0.3])
    dst = (src @ R.T + t + rng.normal(scale=0.02, size=src.shape)).astype(
        np.float32)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3], T[:3, 3] = R, t
    mask = np.ones(src.shape[0], bool)
    return src, dst, mask, T


def _key_sampler_nv(key):
    """register_pair's draws: `ransac.py:90` with the valid-match count."""
    def sample(nv, H):
        return torch.from_numpy(np.array(jax.random.randint(
            key, (H, 3), 0, jnp.int32(int(nv[0])))))[None]
    return sample


def _front_ends_agree(ours, ref_matches, ref_ransac_T):
    """The front ends agree up to FPFH bin flips: the two frameworks round
    the descriptors' f32 arithmetic in other orders (XLA fuses), so a few
    mutual matches differ (2% allowed) and RANSAC's refined pose moves by
    a few cm (0.1 allowed on each entry of T)."""
    assert abs(int(ours.num_matches) - int(ref_matches)) <= \
        0.02 * int(ref_matches) and int(ours.num_matches) > 20
    np.testing.assert_allclose(ours.ransac_T.numpy(), np.asarray(ref_ransac_T),
                               atol=0.1)


def test_register_pair_while_matches_jax(rng):
    """`icp_backend="while"` (K1 association, plain on the CPU) against the
    reference's `register_pair` on the CPU with the same draws. From
    front ends that agree up to FPFH bin flips, the convergence-tested ICP
    lands on the same pose: T within 1e-4, the same iteration count, RMSE
    within 1e-4 m."""
    src, dst, mask, T = _pair_clouds(rng)
    key = jax.random.PRNGKey(0)
    cfg = dict(CFG, icp_backend="while")
    ref = jpipe.register_pair(JCloud(jnp.asarray(src), jnp.asarray(mask)),
                              JCloud(jnp.asarray(dst), jnp.asarray(mask)),
                              key=key, cfg=jpipe.RegistrationConfig(**cfg))
    ours = tpipe.register_pair(PointCloud(_t(src), _t(mask)),
                               PointCloud(_t(dst), _t(mask)),
                               cfg=tpipe.RegistrationConfig(**cfg),
                               sampler=_key_sampler_nv(key), device="cpu")
    assert int(ours.src_voxels) == int(ref.src_voxels)
    assert int(ours.dst_voxels) == int(ref.dst_voxels)
    _front_ends_agree(ours, ref.num_matches, ref.ransac_T)
    np.testing.assert_allclose(ours.T.numpy(), np.asarray(ref.T), atol=1e-4)
    assert int(ours.icp_iters) == int(ref.icp_iters)
    assert abs(float(ours.icp_rmse) - float(ref.icp_rmse)) < 1e-4
    rte, rre = se3.pose_diff_rte_rre(ours.T, _t(T))
    assert float(rte) < 2.0 and float(rre) < 5.0


def test_register_pair_mega_matches_jax_chain(rng, monkeypatch):
    """`icp_backend="mega"` (kernel 5 and K1, plain on the CPU) against the
    reference's chain: `_front_end` (agreeing up to FPFH bin flips), then
    from the port's own RANSAC pose `icp_fixed_iters_banded_mega` in
    interpret mode, then `_icp_stats` (its 1-NN routed to the Pallas 1-NN
    in interpret mode: direct differences, as K1). T within 1e-4, RMSE
    within 1e-5 relative, with a short schedule (6 + 1 iterations)."""
    src, dst, mask, T = _pair_clouds(rng)
    key = jax.random.PRNGKey(1)
    cfg = dict(CFG, icp_backend="mega", icp_fixed_coarse=6,
               icp_fixed_polish=1)
    ours = tpipe.register_pair(PointCloud(_t(src), _t(mask)),
                               PointCloud(_t(dst), _t(mask)),
                               cfg=tpipe.RegistrationConfig(**cfg),
                               sampler=_key_sampler_nv(key), device="cpu")
    jcfg = jpipe.RegistrationConfig(**cfg)
    js, jd = (JCloud(jnp.asarray(src), jnp.asarray(mask)),
              JCloud(jnp.asarray(dst), jnp.asarray(mask)))
    rr, nm, _, _ = jpipe._front_end(js, jd, key, jcfg)
    _front_ends_agree(ours, nm, rr.T)
    Tj = jicp.icp_fixed_iters_banded_mega(
        js.points, js.mask, jd.points, jd.mask,
        init_T=jnp.asarray(ours.ransac_T.numpy()), coarse_iters=6,
        polish_iters=1, dist_thresh=2.0, block=1024, window_blocks=1,
        query_tile=1024, interpret=True)
    monkeypatch.setattr(
        importlib.import_module("pctpu.ops.knn"), "nearest",
        lambda q, db, m, chunk, backend: nearest_pallas(q, db, m,
                                                        interpret=True))
    _, rmse = jpipe._icp_stats(Tj, js, jd, jcfg)
    np.testing.assert_allclose(ours.T.numpy(), np.asarray(Tj), atol=1e-4)
    np.testing.assert_allclose(float(ours.icp_rmse), float(rmse), rtol=1e-5)
    assert int(ours.icp_iters) == 7
    rte, rre = se3.pose_diff_rte_rre(ours.T, _t(T))
    assert float(rte) < 2.0 and float(rre) < 5.0


# ---------------------------------------------------------------------------
# numpy-only copies
# ---------------------------------------------------------------------------

def test_io_and_evaluate_copies_match(tmp_path, rng):
    """The port's numpy copies read and score what the JAX package's do."""
    scan = rng.normal(size=(100, 4)).astype(np.float32)
    path = tmp_path / "scan.bin"
    scan.tofile(path)
    np.testing.assert_array_equal(tio.read_velodyne_bin(str(path)),
                                  jio.read_velodyne_bin(str(path)))
    rows = []
    for i in range(4):
        Tq = np.eye(4)
        Tq[:3, :3] = Rotation.from_rotvec(rng.normal(scale=0.3, size=3)
                                          ).as_matrix()
        Tq[:3, 3] = rng.normal(size=3)
        t, q = jse3.transform_to_tq(jnp.asarray(Tq, jnp.float32))
        rows.append((i, i + 1, np.asarray(t), np.asarray(q)))
    gt, pred = tmp_path / "gt.txt", tmp_path / "pred.txt"
    tio.write_reg_results(str(gt), rows)
    noisy = [(a, b, t + (3.0 if a == 2 else 0.01), q) for a, b, t, q in rows]
    tio.write_reg_results(str(pred), noisy)
    ours = teval.evaluate_rt(str(gt), str(pred))
    assert ours == jeval.evaluate_rt(str(gt), str(pred))
    assert ours["n_success"] == 3
