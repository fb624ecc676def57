"""ISS keypoints and `register_pairs(keypoints="iss")` on the CPU against
the benchmark's plain reference of the ISS chain
(`portbench/reference/reg-hdl64-iss.py`): `iss_keypoints` against the
reference's `iss` on seeded clouds, equal wherever
`features/margins.py:iss_decided` settles the flag, and equal everywhere
on a flat patch whose l3 lies below float32's rounding; then one
`register_pairs` call stage by stage, each reference stage fed the
port's previous stage as the benchmark's judge feeds it: the sites, the
mutual matches, RANSAC and the two ICP stages. Small sizes: 2,400-point
clouds, voxel 1 m, capacity 512."""
import torch_threads as _torch_threads  # noqa: F401

import dataclasses
import functools

import numpy as np
import pytest
import torch

from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.features import margins
from pctpu_torch.features.iss import iss_keypoints
from pctpu_torch.register import pipeline

GAMMA = 0.975            # iss_keypoints' gamma_21 and gamma_32
CFG = pipeline.RegistrationConfig(
    voxel_size=1.0, feature_radius=5.0, ransac_dist=1.5,
    ransac_hypotheses=256, icp_dist_thresh=2.0, downsample_capacity=512,
    refine_subsample=512, stats_subsample=256, keypoints="iss")
STAGES = ("voxel_downsample_capped", "fpfh_fused", "keypoint_sites",
          "match_features", "ransac_registration_batch",
          "icp_fixed_iters_banded_mega_batch", "_refine_exact_batch")


@pytest.fixture(scope="module")
def ref():
    from portbench.common.harness import BENCH_DIR, load_module
    return load_module(BENCH_DIR / "reference" / "reg-hdl64-iss.py",
                       "portbench_reference_reg_hdl64_iss")


def _scene(rng, n=2400):
    """Ground (5 cm of noise) and four box walls (1 cm), 40 m across: no
    neighbourhood exactly flat, whose l3 of 0 only rounding would sign."""
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
        pts.append(face + rng.normal(scale=0.01, size=face.shape))
    return np.concatenate(pts).astype(np.float32)


def _ref_iss(ref, points, mask, cfg=CFG):
    return ref.iss(points, mask, cfg.iss_salient_radius,
                   cfg.iss_nonmax_radius, GAMMA, GAMMA,
                   cfg.iss_min_neighbors, cfg.iss_k_cap)


def _settled_equal(ref, points, mask, sites, cfg=CFG):
    """`sites` [N] against the reference's ISS of the same cloud: equal
    wherever `margins.iss_decided` (from the port's eigenvalues) settles
    the flag, which must be at least 90% of the valid points. Returns
    the reference's keypoint count."""
    ev = iss_keypoints(points, mask, cfg.iss_salient_radius,
                       cfg.iss_nonmax_radius, GAMMA, GAMMA,
                       cfg.iss_min_neighbors, cfg.iss_k_cap).eigvals
    decided, _ = margins.iss_decided(
        points, ev, mask, cfg.iss_salient_radius, cfg.iss_nonmax_radius,
        GAMMA, GAMMA, cfg.iss_min_neighbors, cfg.iss_k_cap)
    r = _ref_iss(ref, points, mask, cfg)
    assert float(decided[mask].double().mean()) >= 0.9
    assert torch.equal(sites[decided], r[decided])
    assert not bool(sites[~mask].any())
    return int(r.sum())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_iss_keypoints_match_the_reference(ref, seed):
    """A seeded 2,400-point cloud, its last 200 rows masked out, at the
    PCL defaults (3 m, 2 m, 5 neighbours, at most 64)."""
    p = torch.from_numpy(_scene(np.random.default_rng(seed)))
    mask = torch.arange(len(p)) < len(p) - 200
    got = iss_keypoints(p, mask)
    assert _settled_equal(ref, p, mask, got.keypoint_mask,
                          pipeline.RegistrationConfig()) >= 20


def test_flat_patch_candidates_match_the_reference(ref):
    """A jittered 2 m grid on a plane 50 m from the origin with 0.1 mm of
    height noise: each neighbourhood's l3 is ~1e-8 of its l1, under
    float32's rounding of the closed-form solver, so only a float64
    scatter and solve decide `l3 > 0` as the reference does. The keypoints
    are equal at every point."""
    rng = np.random.default_rng(4)
    gx, gy = np.meshgrid(np.arange(20) * 2.0, np.arange(20) * 2.0)
    xy = np.stack([gx.ravel(), gy.ravel()], 1) + rng.uniform(
        -0.5, 0.5, (400, 2)) + np.array([30.0, -40.0])
    z = rng.normal(scale=1e-4, size=(400, 1))
    p = torch.from_numpy(np.concatenate([xy, z], 1).astype(np.float32))
    mask = torch.ones(len(p), dtype=torch.bool)
    got = iss_keypoints(p, mask).keypoint_mask
    r = _ref_iss(ref, p, mask, pipeline.RegistrationConfig())
    assert int(r.sum()) >= 20
    assert torch.equal(got, r)


def _moved(src, deg, t, rng):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return (src @ R.T + np.asarray(t, np.float32)
            + rng.normal(scale=0.01, size=src.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def traced_pairs():
    """One `register_pairs(keypoints="iss")` call on two pairs (a 2,400-
    point scene against its copy moved 12 deg and [1.5, -1, 0.2] m, and
    8 deg and [-1, 0.5, 0], 1 cm noise) with its stages' outputs
    captured: (inputs, outputs by stage, the result, the draws' sampler)."""
    from portbench.common.draws import sampler_for
    rng = np.random.default_rng(21)
    scene = _scene(rng)
    src = np.stack([scene, scene])
    dst = np.stack([_moved(scene, 12, [1.5, -1.0, 0.2], rng),
                    _moved(scene, 8, [-1.0, 0.5, 0.0], rng)])
    seen = {}

    def keep(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            seen.setdefault(name, []).append(out)
            return out
        return wrapper

    with pytest.MonkeyPatch.context() as mp:
        for name in STAGES:
            mp.setattr(pipeline, name, keep(name, getattr(pipeline, name)))
        mask = torch.ones(src.shape[:2], dtype=torch.bool)
        out = pipeline.register_pairs(
            PointCloud(torch.from_numpy(src), mask),
            PointCloud(torch.from_numpy(dst), mask), CFG,
            sampler=sampler_for(7, 0, "cpu"), device="cpu")
    return dict(src=src, dst=dst, seen=seen, out=out,
                sampler=lambda: sampler_for(7, 0, "cpu"))


def _gap(Ta, Tb, pts):
    from portbench.common.plain_geometry import point_gap
    return point_gap(Ta, Tb, torch.from_numpy(pts))


def test_sites_match(traced_pairs, ref):
    """The sites from the port's voxel clouds: equal to the reference's
    ISS where settled; fewer than the valid voxels, at least 20 a cloud."""
    seen = traced_pairs["seen"]
    for (down, _), sites in zip(seen["voxel_downsample_capped"],
                                seen["keypoint_sites"]):
        for k in range(down.points.shape[0]):
            _settled_equal(ref, down.points[k], down.mask[k], sites[k])
            assert 20 <= int(sites[k].sum()) < int(down.mask[k].sum())


def test_matches_and_ransac_match(traced_pairs, ref):
    """Mutual matches from the port's descriptors over the port's sites
    are the same rows; RANSAC from the port's matches with the same draws
    lands within 1e-4 m of the port's pose (the refit's float32 sums)."""
    cfg = dataclasses.asdict(CFG)
    seen = traced_pairs["seen"]
    (sdown, _), (ddown, _) = seen["voxel_downsample_capped"]
    m = seen["match_features"][0]
    idx, valid = ref.match(*seen["fpfh_fused"], *seen["keypoint_sites"])
    assert torch.equal(valid, m.valid) and int(valid.sum(1).min()) >= 10
    assert torch.equal(idx[valid], m.dst_idx.long()[valid])
    rT = ref.ransac(sdown.points, ref._rows(ddown.points, m.dst_idx),
                    m.valid, traced_pairs["sampler"](), cfg["ransac_dist"],
                    cfg["ransac_hypotheses"], cfg["ransac_m_cap"])
    assert _gap(rT, seen["ransac_registration_batch"][0].T,
                traced_pairs["src"]) <= 1e-4


def test_icp_stages_match(traced_pairs, ref):
    """The voxel-cloud ICP from the port's RANSAC pose and the refine of
    the strided source subsample against the whole target from the port's
    voxel ICP pose, each pair within 1e-3 m of the port's at any source
    point (the 3x3 solve and the pose's composition round in another
    order), and both pairs within the success bound of the truth."""
    cfg = dataclasses.asdict(CFG)
    seen, out = traced_pairs["seen"], traced_pairs["out"]
    (sdown, _), (ddown, _) = seen["voxel_downsample_capped"]
    rT = seen["ransac_registration_batch"][0].T
    icp_T = seen["icp_fixed_iters_banded_mega_batch"][0]
    assert torch.equal(seen["_refine_exact_batch"][0], out.T)
    q = torch.from_numpy(np.ascontiguousarray(
        ref.refine_inputs(traced_pairs["src"], cfg)))
    for k in range(2):
        t1 = ref.icp(sdown.points[k], sdown.mask[k], ddown.points[k],
                     ddown.mask[k], rT[k], cfg["icp_voxel_iters"],
                     cfg["icp_dist_thresh"])
        d = torch.from_numpy(traced_pairs["dst"][k])
        t2 = ref.icp(q[k], torch.ones(len(q[k]), dtype=torch.bool), d,
                     torch.ones(len(d), dtype=torch.bool), icp_T[k],
                     cfg["icp_refine_iters"], cfg["icp_dist_thresh"])
        src = traced_pairs["src"][k]
        assert _gap(t1, icp_T[k], src) <= 1e-3
        assert _gap(t2, out.T[k], src) <= 1e-3
    from portbench.common.generators import rte_rre
    truth = np.stack([np.eye(4, dtype=np.float32)] * 2)
    for k, (deg, t) in enumerate(((12, [1.5, -1.0, 0.2]),
                                  (8, [-1.0, 0.5, 0.0]))):
        c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
        truth[k, :2, :2] = [[c, -s], [s, c]]
        truth[k, :3, 3] = t
    rte, rre = rte_rre(out.T.numpy(), truth)
    assert float(rte.max()) < 2.0 and float(rre.max()) < 5.0
