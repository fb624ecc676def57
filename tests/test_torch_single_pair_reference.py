"""`register_pair` on the CPU against the benchmark's plain reference of
the single-pair chain (`portbench/reference/reg-hdl64-single.py`), stage by
stage, each reference stage fed the port's previous stage as the
benchmark's judge feeds it; and kernel 5's windowed ICP on a pair built so
that the window leaves out queries' true nearest neighbours, where the
reference's windowed phase follows the port's and an exact 1-NN ICP does
not. Small sizes: 2,400-point clouds, kernel 5 at `block` and
`query_tile` 128, 6 windowed and 2 exact iterations."""
import torch_threads as _torch_threads  # noqa: F401

import dataclasses
import functools

import numpy as np
import pytest
import torch

from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.ops import pallas_icp_mega as mega
from pctpu_torch.register import icp as ticp
from pctpu_torch.register import pipeline

BLOCK = TILE = 128
CFG = pipeline.RegistrationConfig(
    voxel_size=1.0, feature_radius=5.0, ransac_dist=1.5,
    ransac_hypotheses=256, icp_dist_thresh=2.0, downsample_capacity=512,
    icp_fixed_coarse=6, icp_fixed_polish=2)
STAGES = ("_cap_uniform", "fpfh", "match_features", "ransac_registration",
          "_icp_stats")


@pytest.fixture(scope="module")
def ref():
    from portbench.common.harness import BENCH_DIR, load_module
    return load_module(BENCH_DIR / "reference" / "reg-hdl64-single.py",
                       "portbench_reference_reg_hdl64_single")


def _scene(rng, n=2400):
    """Ground and four box walls, 40 m across."""
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
def traced_pair():
    """One `register_pair` call (a 2,400-point scene against its copy moved
    12 deg and [1.5, -1, 0.2] m, 1 cm noise) with its stages' outputs and
    kernel 5's two launches captured, kernel 5 at block and query tile
    128: (inputs, outputs by stage, the result, the draws' sampler)."""
    from portbench.common.draws import sampler_for
    rng = np.random.default_rng(21)
    src = _scene(rng)
    c, s = np.cos(np.radians(12)), np.sin(np.radians(12))
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    dst = (src @ R.T + np.array([1.5, -1.0, 0.2], np.float32)
           + rng.normal(scale=0.01, size=src.shape)).astype(np.float32)
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
        mp.setattr(mega, "icp_mega", keep("icp_mega", mega.icp_mega))
        icp5 = pipeline.icp_fixed_iters_banded_mega
        mp.setattr(pipeline, "icp_fixed_iters_banded_mega",
                   lambda *a, **kw: icp5(*a, **{**kw, "block": BLOCK,
                                                "query_tile": TILE}))
        mask = torch.ones(len(src), dtype=torch.bool)
        out = pipeline.register_pair(
            PointCloud(torch.from_numpy(src), mask),
            PointCloud(torch.from_numpy(dst), mask), CFG,
            sampler=sampler_for(7, 0, "cpu"), device="cpu")
    return dict(src=src, dst=dst, seen=seen, out=out,
                sampler=lambda: sampler_for(7, 0, "cpu"))


def _gap(Ta, Tb, pts):
    from portbench.common.plain_geometry import point_gap
    return point_gap(Ta, Tb, torch.from_numpy(pts))


def test_voxels_match(traced_pair, ref):
    """The uncapped grid and its cap: the same voxels in the same slots;
    centroids within 1e-6 m (float64 sums in another order, rounded once
    to float32: an ulp at 20 m is 1.9e-6)."""
    cfg = dataclasses.asdict(CFG)
    for side, (down, nv) in zip(("src", "dst"),
                                traced_pair["seen"]["_cap_uniform"]):
        rp, rm, rnv = ref.voxels(traced_pair[side], cfg, "cpu")
        assert int(nv) == rnv and rnv > CFG.downsample_capacity
        assert torch.equal(down.mask, rm)
        assert float((down.points - rp).abs().max()) <= 1e-6


def test_features_match(traced_pair, ref):
    """FPFH from the port's voxel clouds: equal up to float32 rounding in
    the histograms' weighted sums (the neighbour lists and bins agree; a
    descriptor's entries are of size 100, so 1e-3 is 1e-5 relative)."""
    cfg = dataclasses.asdict(CFG)
    for (down, _), feats in zip(traced_pair["seen"]["_cap_uniform"],
                                traced_pair["seen"]["fpfh"]):
        rf = ref.fpfh(down.points, down.mask, cfg)
        gap = (feats - rf)[down.mask].abs()
        assert float(gap.mean()) <= 1e-4 and float(gap.max()) <= 1e-3


def test_matches_and_ransac_match(traced_pair, ref):
    """Mutual matches from the port's descriptors are the same rows; RANSAC
    from the port's matches with the same draws lands within 1e-4 m of
    the port's pose (the refit's float32 sums)."""
    cfg = dataclasses.asdict(CFG)
    seen = traced_pair["seen"]
    (sdown, _), (ddown, _) = seen["_cap_uniform"]
    m = seen["match_features"][0]
    idx, valid = ref.match(*seen["fpfh"], sdown.mask, ddown.mask)
    assert torch.equal(valid, m.valid)
    assert torch.equal(idx[valid], m.dst_idx.long()[valid])
    rT = ref.ransac(sdown.points, ddown.points[m.dst_idx.long()], m.valid,
                    traced_pair["sampler"](), cfg)
    assert _gap(rT, seen["ransac_registration"][0].T,
                traced_pair["src"]) <= 1e-4


def test_windowed_then_exact_icp_and_stats_match(traced_pair, ref):
    """Kernel 5's windowed phase from the port's RANSAC pose, its exact
    phase from the port's windowed pose, and the stats' RMSE at the port's
    final pose. The distances and the moments are formed alike on both
    sides; the 3x3 solve and the pose's composition round in another order
    (a few ulps an iteration), which an ICP still moving carries on: the
    poses within 1e-3 m at any source point (1e-4 read here), the RMSE
    within 1e-6 m (its float64 sum, 7e-9 read)."""
    seen = traced_pair["seen"]
    src = torch.from_numpy(traced_pair["src"])
    dst = torch.from_numpy(traced_pair["dst"])
    ones = torch.ones(len(src), dtype=torch.bool)
    rT = seen["ransac_registration"][0].T
    coarse_T, polish_T = seen["icp_mega"]
    lay = ref.layout(src, ones, dst, ones, rT, BLOCK, TILE)
    c = ref.icp_kernel5(lay, rT, CFG.icp_fixed_coarse, 1,
                        CFG.icp_dist_thresh)
    p = ref.icp_kernel5(lay, coarse_T, CFG.icp_fixed_polish, lay["nb"],
                        CFG.icp_dist_thresh)
    assert _gap(c, coarse_T, traced_pair["src"]) <= 1e-3
    assert _gap(p, polish_T, traced_pair["src"]) <= 1e-3
    assert torch.equal(polish_T, traced_pair["out"].T)
    _, rmse = ref.icp_stats(polish_T, src, ones, dst, ones,
                            CFG.icp_dist_thresh)
    assert abs(rmse - float(traced_pair["out"].icp_rmse)) <= 1e-6
    (_, port_rmse), = seen["_icp_stats"]
    assert float(port_rmse) == float(traced_pair["out"].icp_rmse)


def test_window_that_misses_true_neighbours(ref):
    """A db of 512 points spread 64 m along x and a source of the same
    points less the first 64, at the true pose: every tile of 128 sources
    straddles two db blocks, and its window (one block, from its centre)
    leaves out the true nearest neighbour (the point itself) of half its
    queries. The reference's windowed phase follows the port's (kernel 5's
    plain version) within 1e-4 m; an exact ICP stays at the truth, over
    0.05 m away."""
    rng = np.random.default_rng(4)
    db = np.stack([rng.uniform(0, 64, 512), rng.uniform(-2, 2, 512),
                   rng.uniform(-2, 2, 512)], 1).astype(np.float32)
    db = db[np.argsort(db[:, 0])]
    src, dst = torch.from_numpy(db[64:]), torch.from_numpy(db)
    sm = torch.ones(len(src), dtype=torch.bool)
    dm = torch.ones(len(dst), dtype=torch.bool)
    eye = torch.eye(4)
    lay = ref.layout(src, sm, dst, dm, eye, BLOCK, TILE)
    base = ref.window_base(lay, eye[:3, :3], eye[:3, 3], 1)
    q = lay["q"][lay["qpen"] == 0]
    valid_db = lay["db4"][:, 3] < 1e29
    true_nn = torch.cdist(q.double(), lay["db4"][valid_db, :3].double()
                          ).argmin(dim=1)
    tile = torch.arange(len(q)) // TILE
    outside = (true_nn // BLOCK) != base[tile]
    assert int(outside.sum()) >= len(q) // 4

    port = ticp.icp_fixed_iters_banded_mega(
        src, sm, dst, dm, init_T=eye, coarse_iters=4, polish_iters=0,
        dist_thresh=5.0, block=BLOCK, window_blocks=1, query_tile=TILE,
        device="cpu")
    windowed = ref.icp_kernel5(lay, eye, 4, 1, 5.0)
    exact = ref.icp_kernel5(lay, eye, 4, lay["nb"], 5.0)
    assert _gap(port, windowed, db[64:]) <= 1e-4
    assert _gap(exact, eye, db[64:]) <= 1e-4
    assert _gap(port, exact, db[64:]) > 0.05

