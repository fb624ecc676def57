"""The SLAM loop (`pipelines/odometry.py`) against the JAX package on the
CPU: `run_odometry` on 6 frames of an arc through the world of
`tests/test_odometry.py` (plain kernel versions), its two front ends, the
checkpoint format both ways, `compose_deltas` and `ate`.

Both packages get the same normals: the radius normals of the pillars
(0.4 m cylinders at a 1.25 m radius) are degenerate, their least
eigenvector is decided by rounding, and the two packages' dense matmuls
round differently, so `run_odometry`'s normals call is pointed at the
reference's `normals_radius_dense` here. One JAX run per file, shared
through a module fixture."""
import torch_threads as _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.features.fpfh_dense import normals_radius_dense as j_normals
from pctpu.pipelines import odometry as jodo
from pctpu_torch.ops import pallas_nn
from pctpu_torch.pipelines import odometry as todo


CFG = dict(voxel_leaf=0.5, icp_iters=8, icp_dist_thresh=3.0,
           keyframe_every=1, closure_radius=10.0, closure_min_gap=3,
           query_chunk=512, closure_init="odometry")


def make_world(rng, n):
    """tests/test_odometry.py:8-24: ground and 12 pillars."""
    g = np.zeros((n // 2, 3), np.float32)
    g[:, :2] = rng.uniform(-30, 30, (n // 2, 2))
    g[:, 2] = rng.normal(scale=0.02, size=n // 2)
    pts = [g]
    for _ in range(12):
        c = rng.uniform(-25, 25, 2)
        m = n // 24
        ang = rng.uniform(0, 2 * np.pi, m)
        pts.append(np.stack([c[0] + 0.4 * np.cos(ang),
                             c[1] + 0.4 * np.sin(ang),
                             rng.uniform(0, 4, m)], axis=1))
    return np.concatenate(pts).astype(np.float32)


def arc_scans(frames=6):
    """The first `frames` poses of a 32-pose circle of radius 6 m
    (11.25 deg and 1.2 m per frame) and their 15 m scans."""
    rng = np.random.default_rng(0)
    world = make_world(rng, 2000)
    gt = []
    for i in range(frames):
        th = 2 * np.pi * i / 32
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rotation.from_rotvec([0, 0, th]).as_matrix()
        T[:3, 3] = [6 * np.cos(th), 6 * np.sin(th), 0.0]
        gt.append(T)
    scans = []
    for T in gt:
        inv = np.linalg.inv(T)
        local = world @ inv[:3, :3].T + inv[:3, 3]
        keep = np.linalg.norm(local[:, :2], axis=1) < 15.0
        scans.append((local[keep] + rng.normal(scale=0.01, size=(
            int(keep.sum()), 3))).astype(np.float32))
    return scans, np.stack(gt)


def _reference_normals(points, mask, radius):
    return torch.from_numpy(np.array(j_normals(
        jnp.asarray(points.numpy()), jnp.asarray(mask.numpy()),
        radius=radius)))


@pytest.fixture(scope="module")
def runs():
    """(scans, gt, the JAX run, the port's run), both with the scan front
    end and odometry-initialised closures."""
    scans, gt = arc_scans()
    ref = jodo.run_odometry(scans, jodo.OdometryConfig(**CFG,
                                                       frontend="scan"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(todo, "normals_radius_dense", _reference_normals)
        before = pallas_nn.nn1.launches
        ours = todo.run_odometry(scans, todo.OdometryConfig(
            **CFG, frontend="scan"), device="cpu")
        assert pallas_nn.nn1.launches == before
    return scans, gt, ref, ours


def test_run_odometry_matches_jax(runs):
    """The same keyframes, candidates, accepted and rejected closures
    (fitness within 1e-6); raw and optimized poses within 1e-4; the
    graph's final cost within 1e-6 (a sum of squared millimetre-scale
    residuals, 6.6e-4 here: the packages' f32 poses differ by up to
    1.5e-5, which moves it by 3.4e-7); the loop is tracked."""
    _, gt, ref, ours = runs
    assert ours["keyframes"] == ref["keyframes"]
    assert ours["closures"] == ref["closures"] and len(ours["closures"]) > 0
    assert [r[:2] for r in ours["closures_rejected"]] == [
        r[:2] for r in ref["closures_rejected"]]
    for a, b in zip(ours["closures_rejected"], ref["closures_rejected"]):
        assert abs(a[2] - b[2]) < 1e-6
    for key in ("poses", "poses_optimized", "keyframe_poses"):
        np.testing.assert_allclose(ours[key], np.asarray(ref[key]),
                                   rtol=0, atol=1e-4)
    for a, b in zip(ours["edges"], ref["edges"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    np.testing.assert_allclose(ours["final_cost"], ref["final_cost"],
                               rtol=0, atol=1e-6)
    assert todo.ate(ours["poses_optimized"], gt) < 0.2


def _host_run(scans, cfg, **kw):
    """`run_odometry` with the host front end, given the reference's
    normals."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(todo, "normals_radius_dense", _reference_normals)
        return todo.run_odometry(scans, todo.OdometryConfig(
            **cfg, frontend="host"), device="cpu", **kw)


def test_scan_frontend_equals_host(runs):
    """Scan-to-scan: the device-resident loop and the per-frame host loop
    give the same poses (1e-6)."""
    scans, _, _, ours = runs
    host = _host_run(scans, dict(CFG, closure_radius=0.0))
    np.testing.assert_allclose(host["poses"], ours["poses"], rtol=0,
                               atol=1e-6)


def test_scan_frontend_equals_host_submap():
    """With a 2-frame submap the host path rebuilds its buffer from poses,
    so only the trajectory agrees (2e-2, the reference's own bound,
    `tests/test_odometry.py:163-166`)."""
    scans, _ = arc_scans(frames=4)
    kw = dict(CFG, icp_iters=5, closure_radius=0.0, submap_frames=2)
    out = {fe: todo.run_odometry(scans, todo.OdometryConfig(
        **kw, frontend=fe), device="cpu") for fe in ("scan", "host")}
    np.testing.assert_allclose(out["scan"]["poses"], out["host"]["poses"],
                               rtol=0, atol=2e-2)


def test_jax_checkpoint_resumes_in_port(tmp_path, runs):
    """A checkpoint the reference writes after frame 3 resumes in the
    port's host front end: frames 0-3 are the checkpoint's, the rest as
    in the unbroken run (1e-5); and the reference reads the checkpoint
    the port writes at the last frame."""
    scans, _, _, ours = runs
    poses = [p for p in ours["poses"][:4]]
    deltas = [np.eye(4, dtype=np.float32)] + [
        (np.linalg.inv(poses[i - 1]) @ poses[i]).astype(np.float32)
        for i in range(1, 4)]
    ckpt = str(tmp_path / "odo.npz")
    jodo.save_odometry_state(ckpt, 3, poses, deltas)
    resumed = _host_run(scans, dict(CFG, closure_radius=0.0),
                        checkpoint_path=ckpt)
    np.testing.assert_array_equal(resumed["poses"][:4], np.stack(poses))
    np.testing.assert_allclose(resumed["poses"], ours["poses"], rtol=0,
                               atol=1e-5)
    i, jp, jd = jodo.load_odometry_state(ckpt)
    assert i == len(scans) - 1 and len(jd) == len(scans)
    np.testing.assert_array_equal(np.stack(jp), resumed["poses"])


def test_run_odometry_global_closures():
    """Round 0 initialised by the port's `register_pairs` (fused FPFH, K4
    mega ICP: plain versions here). Only the port's own properties are
    checked: on the CPU the reference's `register_pairs` takes its dense
    FPFH and while-loop ICP, not the fused path the port runs, so its
    inits would differ by design (and cost ~30 s more). The one candidate
    is accepted from its global init, and the graph improves the loop."""
    scans, gt = arc_scans(frames=5)
    draws = []

    def sampler(nv, H):
        draws.append(tuple(nv.tolist()))
        g = torch.Generator().manual_seed(0)
        return torch.minimum((torch.rand((nv.shape[0], H, 3), generator=g,
                                         dtype=torch.float64)
                              * nv[:, None, None]).long(),
                             nv.long()[:, None, None] - 1)
    cfg = todo.OdometryConfig(**dict(CFG, closure_init="global",
                                     closure_reg_capacity=512,
                                     closure_ransac_hypotheses=256))
    out = todo.run_odometry(scans, cfg, sampler=sampler, device="cpu")
    assert out["closure_candidates"][0] == 1 and len(draws) == 1
    assert len(draws[0]) == 1
    assert out["closures"] == [(0, 4)]
    assert todo.ate(out["poses_optimized"], gt) <= todo.ate(out["poses"], gt)


def test_compose_deltas_matches_jax():
    """tests/test_odometry.py:169-181: the sequential chain against the
    reference's associative scan, within its 1e-4."""
    rng = np.random.default_rng(3)
    deltas = np.tile(np.eye(4, dtype=np.float32), (9, 1, 1))
    deltas[:, :3, :3] = Rotation.random(9, random_state=3).as_matrix()
    deltas[:, :3, 3] = rng.normal(size=(9, 3))
    ours = todo.compose_deltas(torch.from_numpy(deltas)).numpy()
    ref = np.asarray(jodo.compose_deltas(jnp.asarray(deltas)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_ate_matches_jax(runs):
    _, gt, ref, ours = runs
    for poses in (ours["poses"], np.asarray(ref["poses_optimized"])):
        assert todo.ate(poses, gt) == jodo.ate(poses, gt)
