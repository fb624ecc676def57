"""The registration-dataset driver (`pipelines/registration_driver.py`)
and the course-template shims (`register/template_api.py`) against the JAX
package on the CPU (plain kernel versions): the shims on the same numpy
inputs (the same RANSAC draws for `ransac_init`), and the driver on three
small synthetic oxford `.bin` clouds, its result file read and scored by
the reference's own reader and `evaluate_rt`."""

import jax
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.core import io as jio
from pctpu.register import evaluate as jevaluate
from pctpu.register import template_api as japi
from pctpu_torch.pipelines import registration_driver as driver
from pctpu_torch.register import template_api as tapi


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# tests/test_pipeline.py:86-89
ARGS = ["--voxel-size", "1.0", "--feature-radius", "5.0", "--ransac-dist",
        "1.5", "--downsample-capacity", "1024", "--device", "cpu"]


def _scene(rng, n=1600):
    """Ground and four box walls (tests/test_pipeline.py:15-33)."""
    g = rng.uniform(-20, 20, (n // 2, 3))
    g[:, 2] = rng.normal(scale=0.05, size=n // 2)
    pts = [g]
    for _ in range(4):
        c, w, h = rng.uniform(-15, 15, 2), rng.uniform(1, 3, 2), \
            rng.uniform(2, 5)
        face = rng.uniform(-1, 1, (n // 8, 3))
        face[:, 0] = c[0] + w[0] * np.sign(face[:, 0])
        face[:, 1] = c[1] + w[1] * face[:, 1]
        face[:, 2] = h * (face[:, 2] + 1) / 2
        pts.append(face)
    return np.concatenate(pts).astype(np.float32)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Clouds 0-2 (the scene under three poses, 2 cm noise, written as
    oxford 6-float rows with zero normals), the pair list (0,1), (0,2),
    (1,2) and its ground truth (idx2 onto idx1)."""
    rng = np.random.default_rng(4)
    root = tmp_path_factory.mktemp("reg")
    (root / "point_clouds").mkdir()
    scene = _scene(rng)
    poses = []
    for k in range(3):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec([0, 0, np.radians(8.0 * k)]
                                         ).as_matrix()
        T[:3, 3] = [1.5 * k, -0.5 * k, 0.0]
        pts = scene @ T[:3, :3].T + T[:3, 3] + rng.normal(
            scale=0.02, size=scene.shape)
        rows = np.concatenate([pts, np.zeros_like(pts)], axis=1)
        rows.astype(np.float32).tofile(root / "point_clouds" / f"{k}.bin")
        poses.append(T)
    pairs = [(0, 1), (0, 2), (1, 2)]
    with open(root / "pairs.txt", "w") as f:
        f.write("idx1,idx2\n" + "".join(f"{a},{b}\n" for a, b in pairs))
    gt = []
    for a, b in pairs:
        P = poses[a] @ np.linalg.inv(poses[b])
        t, q = P[:3, 3], Rotation.from_matrix(P[:3, :3]).as_quat()
        gt.append((a, b, t, np.array([q[3], q[0], q[1], q[2]])))
    jio.write_reg_results(str(root / "gt.txt"), gt)
    return root


def test_driver_cli_batched_matches_reference_format(dataset, tmp_path):
    """`main` with --batch-size 2 (two register_pairs calls, the second
    padded): no failure, every pair within the reference's success bound
    (RTE < 2 m, RRE < 5 deg) as the reference's evaluate_rt scores the
    file; the file is the reference's format (its header, 3 rows, the
    reader's columns), and both packages' evaluators agree on it."""
    out = str(tmp_path / "result.txt")
    res = driver.main(["--dataset", str(dataset), "--pairs",
                       str(dataset / "pairs.txt"), "--output", out, "--gt",
                       str(dataset / "gt.txt"), "--batch-size", "2"] + ARGS)
    assert res["n_pairs"] == 3 and res["n_failed"] == 0
    ref_ev = jevaluate.evaluate_rt(str(dataset / "gt.txt"), out)
    assert ref_ev["n_success"] == 3 and res["eval"] == ref_ev
    rows = jio.read_reg_results(out)
    assert rows[0] == "idx1,idx2,t_x,t_y,t_z,q_w,q_x,q_y,q_z".split(",")
    assert [r[:2] for r in rows[1:]] == [["0", "1"], ["0", "2"], ["1", "2"]]
    assert all(len(r) == 9 for r in rows[1:])
    assert driver.load_pair_list(str(dataset / "pairs.txt")) == [
        (0, 1), (0, 2), (1, 2)]


def test_driver_cli_keypoints_iss(dataset, tmp_path, monkeypatch):
    """`main --keypoints iss`: the config reaches `register_pairs` with
    ISS matching sites, and every pair lands within the reference's
    success bound as its evaluate_rt scores the file."""
    seen = []
    run = driver.register_pairs

    def spy(*args, cfg, **kw):
        seen.append(cfg.keypoints)
        return run(*args, cfg=cfg, **kw)
    monkeypatch.setattr(driver, "register_pairs", spy)
    out = str(tmp_path / "result.txt")
    res = driver.main(["--dataset", str(dataset), "--pairs",
                       str(dataset / "pairs.txt"), "--output", out, "--gt",
                       str(dataset / "gt.txt"), "--batch-size", "2",
                       "--keypoints", "iss"] + ARGS)
    assert seen == ["iss", "iss"] and res["n_failed"] == 0
    assert jevaluate.evaluate_rt(str(dataset / "gt.txt"),
                                 out)["n_success"] == 3


def test_driver_per_pair_isolates_a_failing_pair(dataset, tmp_path):
    """batch_size 1 (`register_pair` per pair): a pair whose cloud file is
    missing is written as the identity and counted as failed; the other
    pair still succeeds."""
    pairs = tmp_path / "pairs.txt"
    pairs.write_text("idx1,idx2\n0,1\n0,9\n")
    out = str(tmp_path / "result.txt")
    res = driver.run_registration_dataset(
        str(dataset), str(pairs), out, capacity=2048, batch_size=1,
        cfg=driver.RegistrationConfig(voxel_size=1.0, feature_radius=5.0,
                                      ransac_dist=1.5,
                                      downsample_capacity=1024),
        verbose=False, device="cpu")
    assert res["n_failed"] == 1 and res["failed"][0][:2] == (0, 9)
    rows = jio.read_reg_results(out)
    assert [float(v) for v in rows[2][2:]] == [0, 0, 0, 1, 0, 0, 0]
    gt = jio.read_reg_results(str(dataset / "gt.txt"))
    _, _, P_gt = jevaluate.pose_from_row(gt[1])
    _, _, P = jevaluate.pose_from_row(rows[1])
    assert jevaluate.is_successful(P, P_gt)[0]


def _jax_draws(seed):
    def sample(nv, H):
        return torch.from_numpy(np.array(jax.random.randint(
            jax.random.PRNGKey(seed), (H, 3), 0, int(nv[0]))))[None]
    return sample


def test_template_shims_match_jax(rng):
    """The five course-template functions on (3, N) / (C, N) arrays:
    matchings equal; Procrustes within 1e-5; RANSAC with the reference's
    draws within 1e-4; associations equal (K1's plain version vs the
    reference's XLA 1-NN: no near-ties at these spacings); ICP within
    1e-4."""
    src = rng.uniform(-10, 10, (3, 400)).astype(np.float32)
    R = Rotation.from_rotvec([0.02, -0.01, 0.1]).as_matrix()
    dst = (R @ src + np.array([[0.5], [-0.2], [0.1]])).astype(np.float32)
    feats_s = rng.normal(size=(33, 400)).astype(np.float32)
    feats_d = (feats_s + rng.normal(scale=0.05, size=feats_s.shape)).astype(
        np.float32)
    m = tapi.find_matchings(feats_s, feats_d, device="cpu")
    np.testing.assert_array_equal(m, japi.find_matchings(feats_s, feats_d))
    for ours, ref in zip(tapi.procrustes_transformation(src, dst,
                                                        device="cpu"),
                         japi.procrustes_transformation(src, dst)):
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    kw = dict(dist_thresh=0.5, num_hypotheses=256, seed=3)
    np.testing.assert_allclose(
        tapi.ransac_init(src, dst, m, sampler=_jax_draws(3), device="cpu",
                         **kw),
        japi.ransac_init(src, dst, m, **kw), rtol=0, atol=1e-4)
    moved = (src + rng.normal(scale=0.05, size=src.shape)).astype(np.float32)
    np.testing.assert_array_equal(
        tapi.find_associations(moved, src, dist_thresh=0.2, device="cpu"),
        japi.find_associations(moved, src, dist_thresh=0.2))
    np.testing.assert_allclose(
        tapi.ICP(src, dst, max_iteration=30, dist_thresh=3.0, device="cpu"),
        japi.ICP(src, dst, max_iteration=30, dist_thresh=3.0), rtol=0,
        atol=1e-4)
