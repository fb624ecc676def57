"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode); all carry the `cuda` marker. This file imports
nothing of JAX, so on a machine without JAX it runs without the repo's
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import torch_threads as _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from pctpu_torch import kernels
from pctpu_torch.features import pallas_fpfh
from pctpu_torch.features.fpfh_dense import normals_radius_dense
from pctpu_torch.ops import (pallas_ballgroup, pallas_banded, pallas_fps,
                             pallas_gather, pallas_icp_mega, pallas_nn)
from pctpu_torch.ops.ball_query import ball_query
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops import voxel
from pctpu_torch.ops.voxel import voxel_downsample_capped
from pctpu_torch.register import icp, ransac
from pctpu_torch.register.icp import icp_fixed_iters_banded_mega_batch
from pctpu_torch.register.procrustes import weighted_procrustes

from grid_faces import faces_cloud
from ransac_cases import CASES as RANSAC_CASES
from ransac_cases import DIST as RANSAC_DIST
from ransac_cases import refine_inputs, unsure_rows
from voxel_runs import CASES as VOXEL_CASES
from voxel_runs import (case_cloud, hdl64_scan, in_order_means, plain_gap_ok,
                        recorded_runs)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture
def gen():
    return np.random.default_rng(7)


def _t(x, dev):
    return torch.from_numpy(np.array(x)).to(dev)


def test_nn1_kernel_matches_plain(gen, cuda):
    """K1: d2 within rtol 1e-6 and idx equal (same rounding order)."""
    q = _t(gen.uniform(-40, 40, (3, 1000, 3)).astype(np.float32), cuda)
    db = _t(gen.uniform(-40, 40, (3, 5000, 3)).astype(np.float32), cuda)
    pen = torch.where(_t(gen.uniform(size=(3, 5000)) > 0.3, cuda), 0.0,
                      1e30).float()
    before = pallas_nn.nn1.launches
    d2k, idxk = pallas_nn.nn1(q, db, pen)
    torch.cuda.synchronize()
    assert pallas_nn.nn1.launches == before + 1
    d2p, idxp = pallas_nn.nearest_plain(q, db, pen)
    torch.testing.assert_close(d2k, d2p, rtol=1e-6, atol=0)
    assert torch.equal(idxk, idxp)


def _grid_ties(dev, b=1):
    """A 4x4x4 integer grid (shuffled per batch element) as the db and
    queries at its points and half-integer offsets, equidistant from 2, 4
    or 8 db points."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    rng = np.random.default_rng(3)
    db = np.stack([g[rng.permutation(64)] for _ in range(b)])
    q = np.concatenate([g, g + 0.5, g + [0.5, 0, 0], g + [0.5, 0.5, 0]]
                       ).astype(np.float32)
    return _t(np.stack([q] * b), dev), _t(db, dev)


@pytest.mark.parametrize("case", ["grid_ties", "slam_front_end",
                                  "few_queries_whole_scan", "all_masked",
                                  "first_slices_masked"])
def test_nn1_kernel_equals_plain_exactly(gen, cuda, case):
    """K1's d2 and idx equal the plain version's exactly: ties on a grid
    (with the db repeated 64 times, so equal distances fall in different
    slices), the SLAM front end's 1 x 4,096 x 4,096 launch, 64 queries
    against a 124,668-point db (hundreds of slices), an all-masked db
    ((1e30, 0)), and a db whose first slices are all masked."""
    if case == "grid_ties":
        q, db = _grid_ties(cuda, b=3)
        db = db.repeat(1, 64, 1).contiguous()
    elif case == "slam_front_end":
        db = _t(gen.uniform(-20, 20, (1, 4096, 3)).astype(np.float32), cuda)
        q = db[:, gen.permutation(4096)] + 0.05 * torch.randn(
            (1, 4096, 3), device=cuda, generator=torch.Generator(
                cuda).manual_seed(0))
    elif case == "few_queries_whole_scan":
        db = _t(gen.uniform(-80, 80, (1, 124668, 3)).astype(np.float32),
                cuda)
        q = db[:, :64] + 0.1
    else:
        db = _t(gen.uniform(-5, 5, (2, 5000, 3)).astype(np.float32), cuda)
        q = _t(gen.uniform(-5, 5, (2, 700, 3)).astype(np.float32), cuda)
    b, n = db.shape[0], db.shape[1]
    pen = torch.zeros((b, n), device=cuda)
    if case == "all_masked":
        pen[:] = 1e30
    if case == "first_slices_masked":
        pen[:, :4000] = 1e30
    q = q.contiguous()
    plan = pallas_nn.nn1_plan(b, q.shape[1], n, kernels.sm_count(q.device))
    d2k, idxk = pallas_nn.nn1(q, db, pen)
    d2p, idxp = pallas_nn.nearest_plain(q, db, pen)
    assert torch.equal(d2k, d2p) and torch.equal(idxk, idxp)
    again = pallas_nn.nn1(q, db, pen)
    assert torch.equal(again[0], d2k) and torch.equal(again[1], idxk)
    if case in ("slam_front_end", "few_queries_whole_scan",
                "first_slices_masked"):
        assert plan["slices"] > 1
    if case == "all_masked":
        assert bool((d2k == 1e30).all()) and int(idxk.abs().max()) == 0
    if case == "first_slices_masked":
        assert int(idxk.min()) >= 4000


def test_cuda_tensor_never_takes_the_plain_version(gen, cuda, monkeypatch):
    def refuse(*args):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(pallas_nn, "nearest_plain", refuse)
    q = _t(gen.uniform(-1, 1, (1, 10, 3)).astype(np.float32), cuda)
    pallas_nn.nearest_batch(q, q)


def test_wrappers_reject_bad_inputs(cuda):
    q = torch.zeros((1, 10, 3), device=cuda)
    pen = torch.zeros((1, 10), device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        pallas_nn.nn1(q, q.double(), pen)
    strided = torch.zeros((1, 3, 10), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        pallas_nn.nn1(q, strided, pen)
    with pytest.raises(ValueError, match="CUDA device"):
        pallas_nn.nn1(q, q.cpu(), pen)


def _fpfh_inputs(gen, dev, b=2, n=4096, cap=1024, leaf=1.0, radius=5.0,
                 half_width=20.0, case="banded"):
    """K2/K3 operands on tilted noisy planes, voxelised and x-banded as
    `fpfh_fused` packs them. "unbanded": every tile visits every db tile;
    "coincident": two neighbouring voxels moved to one spot with one
    normal, on dyadic values (d2 = 0 exactly) in every cloud; "empty":
    the points of query tiles 1 and 3 masked (their nt is 0)."""
    g = gen.uniform(-half_width, half_width, (b, n, 2))
    pts = np.concatenate([g, (0.1 * g[..., :1] + gen.normal(
        scale=0.3, size=(b, n, 1)))], axis=-1).astype(np.float32)
    down, _ = voxel_downsample_capped(_t(pts, dev),
                                      torch.ones((b, n), dtype=torch.bool,
                                                 device=dev), leaf, cap)
    points, mask = down.points.clone(), down.mask.clone()
    if case == "empty":
        for tile in (1, 3):
            mask[:, tile * 256:(tile + 1) * 256] = False
    nrm = normals_radius_dense(points, mask, radius=2.0)
    if case == "coincident":
        k = cap // 3
        points[:, k] = points[:, k + 1] = torch.round(points[:, k] * 8) / 8
        nrm[:, k] = nrm[:, k + 1] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    amat, dbmat, valid = pallas_fpfh._pack(points, mask, nrm, cap)
    base, nt = pallas_fpfh._band(amat[..., 0], valid, radius, 256, 512,
                                 case != "unbanded", leaf)
    if case == "empty":
        assert int(nt[:, 1].max()) == int(nt[:, 3].max()) == 0
    return amat, dbmat, base, nt, radius * radius


# P1's shape: 16 voxel clouds of 2,048, r 10, slack 2.0 (leaf 2)
P1_FPFH = dict(b=16, n=16384, cap=2048, leaf=2.0, radius=10.0,
               half_width=60.0)
FPFH_CASES = ["banded", "unbanded", "coincident", "empty"]
# every launch shape the plan takes: threads x queries a warp
FPFH_SHAPES = [(t, wq) for t in (32, 64, 128, 256, 512, 1024)
               for wq in (1, 2, 4)]


def test_spfh_wsum_kernels_match_plain(gen, cuda):
    """K2: histograms and counts equal to the plain version's. K3: within
    the bin-boundary bound (flip fraction < 2e-3, mean |diff| < 0.02, max
    < 15): the plain version sums through a matmul."""
    amat, dbmat, base, nt, r2 = _fpfh_inputs(gen, cuda)
    hk, ck = pallas_fpfh.spfh(amat, dbmat, base, nt, 256, 512, r2)
    hp, cp = pallas_fpfh.spfh_plain(amat, dbmat, base, nt, 256, 512, r2)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp) and torch.equal(hk, hp)
    wk = pallas_fpfh.wsum(amat, dbmat, base, nt, hp, 256, 512, r2)
    wp = pallas_fpfh.wsum_plain(amat, dbmat, base, nt, hp, 256, 512, r2)
    diff = (wk - wp).abs()
    assert float((diff > 0.5).float().mean()) < 2e-3
    assert float(diff.mean()) < 0.02 and float(diff.max()) < 15.0


def _fpfh_plans(amat):
    b, np_ = amat.shape[0], amat.shape[1]
    sms = kernels.sm_count(amat.device)
    plans = [pallas_fpfh.fpfh_plan(b, np_, sms, threads=t, warp_queries=wq)
             for t, wq in FPFH_SHAPES]
    assert all(p is not None for p in plans)
    return plans


@pytest.mark.parametrize("case", FPFH_CASES)
def test_spfh_kernel_equals_plain_at_p1_shape(gen, cuda, case):
    """K2 at P1's shape, at every launch shape the plan takes: histograms
    and counts equal to `spfh_plain` (integer bins, scaled once)."""
    args = _fpfh_inputs(gen, cuda, case=case, **P1_FPFH)
    amat, dbmat, base, nt, r2 = args
    hp, cp = pallas_fpfh.spfh_plain(amat, dbmat, base, nt, 256, 512, r2)
    if case == "coincident":
        k = amat.shape[1] // 3
        assert bool((hp[:, k].sum(-1) > 0).all())
    for plan in [None] + _fpfh_plans(amat):
        hk, ck = pallas_fpfh._launch_spfh(amat, dbmat, base, nt, 256, 512,
                                          r2, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(ck, cp) and torch.equal(hk, hp), plan


@pytest.mark.parametrize("case", FPFH_CASES)
def test_wsum_kernel_within_bound_and_repeats_at_p1_shape(gen, cuda, case):
    """K3 at P1's shape, at every launch shape the plan takes: within the
    bin-boundary bound of `wsum_plain`, the same bits on a second launch
    and at every shape (each sum runs in ascending column order)."""
    amat, dbmat, base, nt, r2 = _fpfh_inputs(gen, cuda, case=case,
                                             **P1_FPFH)
    s33, _ = pallas_fpfh.spfh_plain(amat, dbmat, base, nt, 256, 512, r2)
    wp = pallas_fpfh.wsum_plain(amat, dbmat, base, nt, s33, 256, 512, r2)
    first = None
    for plan in [None] + _fpfh_plans(amat):
        wk = pallas_fpfh._launch_wsum(amat, dbmat, base, nt, s33, 256, 512,
                                      r2, plan=plan)
        again = pallas_fpfh._launch_wsum(amat, dbmat, base, nt, s33, 256,
                                         512, r2, plan=plan)
        torch.cuda.synchronize()
        assert torch.equal(wk, again), plan
        first = wk if first is None else first
        assert torch.equal(wk, first), plan
        diff = (wk - wp).abs()
        assert float((diff > 0.5).float().mean()) < 2e-3
        assert float(diff.mean()) < 0.02 and float(diff.max()) < 15.0


def test_spfh_kernel_needs_its_tiles(gen, cuda):
    amat, dbmat, _, _, r2 = _fpfh_inputs(gen, cuda)
    tiles = torch.zeros((amat.shape[0], amat.shape[1] // 128),
                        dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="q_tile"):
        pallas_fpfh.spfh(amat, dbmat, tiles, tiles, 128, 512, r2)


def test_fpfh_wrappers_reject_mixed_devices_and_never_take_plain(
        gen, cuda, monkeypatch):
    amat, dbmat, base, nt, r2 = _fpfh_inputs(gen, cuda)
    with pytest.raises(ValueError, match="CUDA device"):
        pallas_fpfh.spfh(amat, dbmat.cpu(), base, nt, 256, 512, r2)
    s33 = torch.zeros(amat.shape[:2] + (33,))
    with pytest.raises(ValueError, match="CUDA device"):
        pallas_fpfh.wsum(amat, dbmat, base, nt, s33, 256, 512, r2)

    def refuse(*args):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(pallas_fpfh, "spfh_plain", refuse)
    monkeypatch.setattr(pallas_fpfh, "wsum_plain", refuse)
    hist, _ = pallas_fpfh.spfh(amat, dbmat, base, nt, 256, 512, r2)
    pallas_fpfh.wsum(amat, dbmat, base, nt, hist, 256, 512, r2)


@pytest.mark.parametrize("window_blocks", [1, 2, 8])
def test_icp_mega_kernel_matches_plain(gen, cuda, window_blocks):
    """K4 through the voxel-stage ICP, LUT window path (1, 2 of 8
    blocks) and the full window: T within 1e-4 of the plain version."""
    b, n = 3, 2048
    src = gen.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    ang = gen.normal(scale=0.02, size=(b, 3))
    R = np.stack([np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]],
                            [-a[1], a[0], 1]]) for a in ang])
    dst = (np.einsum("bij,bnj->bni", R, src) + 0.2).astype(np.float32)
    mask = np.ones((b, n), bool)
    kw = dict(coarse_iters=6, polish_iters=1, block=256,
              window_blocks=window_blocks, query_tile=512)
    args = [_t(x, cuda) for x in (src, mask, dst, mask)]
    before = pallas_icp_mega.icp_mega_batch.launches
    kern = icp_fixed_iters_banded_mega_batch(*args, **kw)
    torch.cuda.synchronize()
    assert pallas_icp_mega.icp_mega_batch.launches == before + 2
    plain = icp_fixed_iters_banded_mega_batch(*[a.cpu() for a in args], **kw)
    torch.testing.assert_close(kern.cpu(), plain, rtol=0, atol=1e-4)


def _pair(gen, n, dev):
    src = gen.uniform(-20, 20, (n, 3)).astype(np.float32)
    src[:, 0] *= 3.0
    a = gen.normal(scale=0.02, size=3)
    R = np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]], [-a[1], a[0], 1]])
    dst = (src @ R.T + [0.2, -0.1, 0.05]).astype(np.float32)
    mask = gen.uniform(size=n) > 0.05
    return [_t(x, dev) for x in (src, mask, dst, mask)]


@pytest.mark.parametrize("window_blocks", [1, 8])
def test_icp_mega_single_kernel_matches_plain(gen, cuda, window_blocks):
    """Kernel 5 (one pair, B = 1) through the single-pair ICP: two
    launches; T within 1e-4 of the plain version (on the CPU)."""
    args = _pair(gen, 2000, cuda)
    kw = dict(coarse_iters=5, polish_iters=1, block=256,
              window_blocks=window_blocks, query_tile=512)
    before = pallas_icp_mega.icp_mega.launches
    batch_before = pallas_icp_mega.icp_mega_batch.launches
    kern = icp.icp_fixed_iters_banded_mega(*args, **kw)
    torch.cuda.synchronize()
    assert pallas_icp_mega.icp_mega.launches == before + 2
    assert pallas_icp_mega.icp_mega_batch.launches == batch_before
    plain = icp.icp_fixed_iters_banded_mega(*[a.cpu() for a in args],
                                            device="cpu", **kw)
    torch.testing.assert_close(kern.cpu(), plain, rtol=0, atol=1e-4)


def _mega_case(gen, dev, b, n, block, window_blocks, query_tile, iters=4,
               dup=1, dist_thresh=5.0, offset=(0.2, -0.1, 0.05)):
    """The argument tuple of `_launch_icp_mega` / `icp_mega_plain` for `b`
    pairs of `n` source points; `dup` > 1 repeats every db point `dup`
    times (exact ties, side by side in the banded order, so they fall
    within a block, across the lanes that share a query and, at a block's
    edge, across blocks)."""
    src = gen.uniform(-20, 20, (b, n, 3)).astype(np.float32)
    src[..., 0] *= 3.0
    ang = gen.normal(scale=0.02, size=(b, 3))
    R = np.stack([np.array([[1, -a[2], a[1]], [a[2], 1, -a[0]],
                            [-a[1], a[0], 1]]) for a in ang])
    dst = (np.einsum("bij,bnj->bni", R, src) + offset).astype(np.float32)
    dst = np.repeat(dst[:, :n // dup], dup, axis=1)
    mask = _t(np.ones((b, n), bool), dev)
    T0 = torch.eye(4, device=dev).repeat(b, 1, 1)
    bdb, src3, spen, centers = icp._mega_layout(
        _t(src, dev), mask, _t(dst, dev), mask, T0, block, query_tile)
    return pallas_icp_mega._mega_args(
        pallas_icp_mega.pack_dbt5(bdb), bdb.lut[:, None, :], bdb.lo, bdb.hi,
        bdb.axis, src3, spen, centers, T0, iters, dist_thresh, block,
        window_blocks, query_tile, 6)


@pytest.mark.parametrize("b,n,block,wb,tq", [
    (1, 16384, 1024, 1, 1024),     # workload 1's tiles: 16 of 1,024
    (1, 16384, 1024, 1, 512),      # 32 tiles of 512
    (1, 8192, 512, 2, 1024),       # a LUT window of 2 blocks
    (1, 8192, 1024, 8, 512),       # the window spans the whole db
    (16, 2048, 512, 1, 512),       # B = 16, workload 2's tiles
    (16, 2048, 2048, 1, 2048),     # B = 16, register_pairs' voxel stage
    (3, 1024, 256, 4, 128),        # small tiles: 32 lanes per query
])
def test_icp_mega_grid_matches_plain(gen, cuda, b, n, block, wb, tq):
    """The persistent grid (K4, kernel 5 at B = 1) against
    `icp_mega_plain` on the same CUDA inputs: the pose within 1e-4; the
    launch spreads over at least one CTA per SM where the shape has the
    units."""
    args = _mega_case(gen, cuda, b, n, block, wb, tq)
    plan = pallas_icp_mega.launch_plan(args)
    if b * n >= 16384:
        assert plan["grid"] >= plan["sms"], plan
    assert plan["slice"] <= tq and tq % plan["slice"] == 0, plan
    kern = pallas_icp_mega._launch_icp_mega(*args)
    plain = pallas_icp_mega.icp_mega_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(kern, plain, rtol=0, atol=1e-4)


@pytest.mark.parametrize("lanes_case", [(1, 2048, 512, 1, 512),
                                        (1, 4096, 1024, 4, 1024)])
def test_icp_mega_duplicate_db_points_match_plain(gen, cuda, lanes_case):
    """Every db point four times over: d2 ties inside a block, across the
    lanes of one query and across block edges; the pose within 1e-4."""
    args = _mega_case(gen, cuda, *lanes_case, dup=4)
    assert pallas_icp_mega.launch_plan(args)["lanes"] > 1
    kern = pallas_icp_mega._launch_icp_mega(*args)
    plain = pallas_icp_mega.icp_mega_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(kern, plain, rtol=0, atol=1e-4)


def test_icp_mega_all_gated_out_keeps_the_pose(gen, cuda):
    """Pairs 500 m apart with a 1 m gate: no correspondence passes, the
    < 3 guard holds the initial pose (the identity) in every iteration,
    as in the plain version."""
    args = _mega_case(gen, cuda, 2, 2048, 512, 1, 512, dist_thresh=1.0,
                      offset=(500.0, 0.0, 0.0))
    kern = pallas_icp_mega._launch_icp_mega(*args)
    plain = pallas_icp_mega.icp_mega_plain(*args)
    torch.cuda.synchronize()
    eye = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0], device=cuda)
    torch.testing.assert_close(kern, plain, rtol=0, atol=0)
    torch.testing.assert_close(kern, eye.expand(2, 12), rtol=0, atol=0)


def test_icp_mega_runs_are_bit_identical(gen, cuda):
    """Two launches on the same inputs give the same bits: the moments
    are reduced in a fixed order, with no float atomics."""
    args = _mega_case(gen, cuda, 4, 4096, 512, 2, 512, iters=8)
    first = pallas_icp_mega._launch_icp_mega(*args)
    second = pallas_icp_mega._launch_icp_mega(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_icp_mega_zero_iterations_return_the_initial_pose(gen, cuda):
    args = list(_mega_case(gen, cuda, 2, 1024, 256, 1, 256))
    args[6] = 0
    kern = pallas_icp_mega._launch_icp_mega(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(kern, args[2][:, :12], rtol=0, atol=0)


def _banded_case(gen, dev, n=3000, m=1000, block=256):
    db = gen.uniform(0, 10, (n, 3)).astype(np.float32)
    db[:, 0] *= 10
    dmask = _t(gen.uniform(size=n) > 0.2, dev)
    q = (db[:m] + gen.normal(scale=0.05, size=(m, 3))).astype(np.float32)
    q = q[np.argsort(q[:, 0])]
    qmask = _t(gen.uniform(size=m) > 0.1, dev)
    bdb = pallas_banded.build_banded(_t(db, dev), dmask, block=block)
    return bdb, _t(q, dev), qmask


def test_nearest_banded_kernel_matches_plain(gen, cuda):
    """K6: idx and d2 equal to the plain version's (the same direct
    differences in the same order, the same tie rule)."""
    bdb, q, _ = _banded_case(gen, cuda)
    kw = dict(block=256, window_blocks=3, query_tile=128)
    before = pallas_banded.nearest_banded.launches
    d2k, idxk = pallas_banded.nearest_banded(bdb, q, **kw)
    assert pallas_banded.nearest_banded.launches == before + 1
    args = pallas_banded._nearest_banded_args(bdb, q, **kw)
    d2p, sidx = pallas_banded.nearest_banded_plain(*args, 256, 3, 128)
    torch.cuda.synchronize()
    assert torch.equal(d2k, d2p[:q.shape[0]])
    assert torch.equal(idxk, bdb.order[sidx[:q.shape[0]].long()])


def _k6_ties(gen, dev, n=3000, dup=3, block=256):
    """db points on a 1/4 grid, each `dup` times over side by side in the
    sorted order (exact d2 ties inside a block, across a query's lanes
    and across block edges), 30% masked; queries on the same grid."""
    g = np.round(gen.uniform(0, 10, (n // dup, 3)) * 4) / 4
    g[:, 0] *= 10
    db = np.repeat(g, dup, axis=0).astype(np.float32)
    mask = gen.uniform(size=db.shape[0]) > 0.3
    q = db[gen.integers(0, db.shape[0], 1200)]
    q = (q + np.round(gen.normal(scale=0.5, size=q.shape) * 4) / 4).astype(
        np.float32)
    bdb = pallas_banded.build_banded(_t(db, dev), _t(mask, dev), block=block)
    return bdb, _t(q[np.argsort(q[:, 0])], dev)


@pytest.mark.parametrize("lanes", [1, 4, 32])
@pytest.mark.parametrize("case", ["random", "ties"])
def test_nearest_banded_kernel_every_lane_count(gen, cuda, lanes, case):
    """K6 at forced lane counts (the lanes of a query split its window's
    columns and combine by (d2, column)): d2 and idx equal to the plain
    version's, on random points and on duplicated grid points with exact
    ties; one tile's window moved onto the masked and pad columns at the
    db's end gives (1e30, 0); two launches give the same bits."""
    block, wb, tq = 256, 2, 128
    bdb, q = (_banded_case(gen, cuda)[:2] if case == "random"
              else _k6_ties(gen, cuda))
    q_, dbt, pen, off = pallas_banded._nearest_banded_args(bdb, q, block, wb,
                                                           tq)
    nb = dbt.shape[1] // block
    off = off.clone()
    off[1] = nb - wb
    assert bool((pen[(nb - wb) * block:] > 1e29).all())
    args = (q_, dbt, pen, off, block, wb, tq)
    plan = pallas_banded.nearest_banded_plan(q_.shape[0], tq,
                                             kernels.sm_count(cuda),
                                             lanes=lanes)
    d2k, ik = pallas_banded._launch_nearest_banded(*args, plan=plan)
    again = pallas_banded._launch_nearest_banded(*args, plan=plan)
    d2p, ip = pallas_banded.nearest_banded_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(d2k, d2p) and torch.equal(ik, ip)
    assert torch.equal(again[0], d2k) and torch.equal(again[1], ik)
    assert bool((d2k[tq:2 * tq] == pallas_banded.BIG).all())
    assert not bool(ik[tq:2 * tq].any())


def test_nearest_banded_kernel_at_p5_shape(gen, cuda):
    """K6 at P5's launch (16,384 queries against 16,384 db points, blocks
    of 2,048, a window of 2, tiles of 512): the plan's units fill the
    card in one wave; d2 and idx equal to the plain version's."""
    db = gen.uniform(0, 10, (16384, 3)).astype(np.float32)
    db[:, 0] *= 10
    q = (db[gen.integers(0, 16384, 16384)]
         + gen.normal(scale=0.05, size=(16384, 3))).astype(np.float32)
    bdb = pallas_banded.build_banded(_t(db, cuda), None, block=2048)
    args = pallas_banded._nearest_banded_args(
        bdb, _t(q[np.argsort(q[:, 0])], cuda), 2048, 2, 512) + (2048, 2, 512)
    plan = pallas_banded.nearest_banded_plan(16384, 512,
                                             kernels.sm_count(cuda))
    assert 3 * kernels.sm_count(cuda) <= plan["units"] \
        <= 4 * kernels.sm_count(cuda)
    d2k, ik = pallas_banded._launch_nearest_banded(*args)
    d2p, ip = pallas_banded.nearest_banded_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(d2k, d2p) and torch.equal(ik, ip)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_icp_moments_banded_kernel_matches_plain(gen, cuda):
    """K7: per-tile f64 moments within 1e-12 relative of the plain
    version's, the rounded [4,4] within 1e-6 relative."""
    bdb, q, qmask = _banded_case(gen, cuda)
    kw = dict(block=256, window_blocks=2, query_tile=128, tiles_per_step=2)
    before = pallas_banded.icp_moments_banded.launches
    mk = pallas_banded.icp_moments_banded(bdb, q, qmask, dist_thresh=2.0,
                                          **kw)
    assert pallas_banded.icp_moments_banded.launches == before + 1
    args = pallas_banded._icp_moments_banded_args(bdb, q, qmask, **kw)
    pk = pallas_banded._launch_icp_moments_banded(*args, 256, 2, 128, 4.0)
    pp = pallas_banded.icp_moments_banded_plain(*args, 256, 2, 128, 4.0)
    torch.cuda.synchronize()
    assert _rel(pk, pp) <= 1e-12
    assert _rel(mk, pallas_banded._sum_partials(pp)) <= 1e-6
    assert float(mk[3, 3]) > 100


def test_icp_moments_banded_v2_kernel_matches_plain(gen, cuda):
    """K8: the transform and the window base inside the kernel; per-tile
    moments within 1e-12 relative, the [4,4] within 1e-6 relative."""
    bdb, q, qmask = _banded_case(gen, cuda, m=1024)
    src3, spen, centers = icp._query_layout(q[None], qmask[None], 128)
    T = torch.eye(4, device=cuda)
    T[:3, 3] = torch.tensor([0.05, -0.02, 0.01], device=cuda)
    kw = dict(block=256, window_blocks=3, query_tile=128)
    before = pallas_banded.icp_moments_banded_v2.launches
    mk = pallas_banded.icp_moments_banded_v2(
        bdb, bdb.pen2.T, src3[0], spen[0], centers[0], T, dist_thresh=2.0,
        **kw)
    assert pallas_banded.icp_moments_banded_v2.launches == before + 1
    args = pallas_banded._icp_moments_banded_v2_args(
        bdb, bdb.pen2.T, src3[0], spen[0], centers[0], T, **kw)
    pk = pallas_banded._launch_icp_moments_banded_v2(*args, 256, 3, 128, 4.0)
    pp = pallas_banded.icp_moments_banded_v2_plain(*args, 256, 3, 128, 4.0)
    torch.cuda.synchronize()
    assert _rel(pk, pp) <= 1e-12
    assert _rel(mk, pallas_banded._sum_partials(pp)) <= 1e-6
    assert float(mk[3, 3]) > 100


def _k8_args(gen, dev, n, m, block, wb, tq, dup=1, grid=None):
    """The argument tuple of `_launch_icp_moments_banded_v2` for a db of
    `n` points (each repeated `dup` times, side by side in the banded
    order: exact d2 ties within a block, across the lanes of a query and
    at block edges) and `m` queries near it. `grid` rounds the db to
    multiples of 1/grid (few significant bits, so the tie sums are exact
    in any order)."""
    db = gen.uniform(0, 10, (n // dup, 3)).astype(np.float32)
    db[:, 0] *= 10
    if grid:
        db = np.round(db * grid) / grid
    db = np.repeat(db, dup, axis=0).astype(np.float32)
    q = (db[gen.integers(0, n, m)] + gen.normal(scale=0.05, size=(m, 3))
         ).astype(np.float32)
    q = q[np.argsort(q[:, 0])]
    bdb = pallas_banded.build_banded(_t(db, dev), None, block=block)
    src3, spen, centers = icp._query_layout(
        _t(q, dev)[None], _t(np.ones(m, bool), dev)[None], tq)
    T = torch.eye(4, device=dev)
    T[:3, 3] = torch.tensor([0.05, -0.02, 0.01], device=dev)
    return pallas_banded._icp_moments_banded_v2_args(
        bdb, bdb.pen2.T, src3[0], spen[0], centers[0], T, block, wb, tq) + (
        block, wb, tq, 4.0)


def _k8_close(kern, plain):
    """Per-tile moments within 1e-12 relative, the [4,4] within 1e-6."""
    assert _rel(kern, plain) <= 1e-12
    assert _rel(pallas_banded._sum_partials(kern),
                pallas_banded._sum_partials(plain)) <= 1e-6
    assert float(pallas_banded._sum_partials(plain)[3, 3]) > 100


def test_icp_moments_banded_v2_kernel_at_p5_shape(gen, cuda):
    """K8 at P5's launch (16,384 queries against 16,384 db points, blocks
    of 2,048, a window of 2, tiles of 512): the plan's units fill the
    card; per-tile moments within 1e-12 of the plain version's."""
    args = _k8_args(gen, cuda, 16384, 16384, 2048, 2, 512)
    plan = pallas_banded.moments_v2_plan(16384, 512, kernels.sm_count(cuda))
    assert plan["units"] >= 3 * kernels.sm_count(cuda)
    kern = pallas_banded._launch_icp_moments_banded_v2(*args)
    plain = pallas_banded.icp_moments_banded_v2_plain(*args)
    torch.cuda.synchronize()
    _k8_close(kern, plain)


@pytest.mark.parametrize("dup,grid", [(2, None), (4, 64)])
def test_icp_moments_banded_v2_duplicate_db_points(gen, cuda, dup, grid):
    """Every db point `dup` times over, side by side: d2 ties inside a
    block are split across the lanes of one query (and fall across block
    edges). Two copies add exactly in any order; four copies sit on a
    1/64 grid, so their sums are exact in any order too."""
    args = _k8_args(gen, cuda, 4096, 1024, 512, 2, 256, dup=dup, grid=grid)
    assert pallas_banded.moments_v2_plan(1024, 256, kernels.sm_count(cuda)
                                         )["lanes"] > 1
    kern = pallas_banded._launch_icp_moments_banded_v2(*args)
    plain = pallas_banded.icp_moments_banded_v2_plain(*args)
    torch.cuda.synchronize()
    _k8_close(kern, plain)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_icp_moments_banded_v2_every_lane_count(gen, cuda, lanes):
    """K8 at each lane count its plan can pick, on duplicated db points
    and tiles of 384 (a slice that does not divide the tile leaves dead
    query slots); and two launches give the same bits."""
    args = _k8_args(gen, cuda, 6144, 1536, 512, 3, 384, dup=2)
    plan = pallas_banded.moments_v2_plan(1536, 384, kernels.sm_count(cuda),
                                         lanes=lanes)
    kern = pallas_banded._launch_icp_moments_banded_v2(*args, plan=plan)
    again = pallas_banded._launch_icp_moments_banded_v2(*args, plan=plan)
    plain = pallas_banded.icp_moments_banded_v2_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kern, again)
    _k8_close(kern, plain)


def _k7_args(gen, dev, n, m, block, wb, tq, dup=1, grid=None):
    """The argument tuple of `_launch_icp_moments_banded` for the db and
    queries of `_k8_args` (posed by the same small translation)."""
    db = gen.uniform(0, 10, (n // dup, 3)).astype(np.float32)
    db[:, 0] *= 10
    if grid:
        db = np.round(db * grid) / grid
    db = np.repeat(db, dup, axis=0).astype(np.float32)
    q = (db[gen.integers(0, n, m)] + gen.normal(scale=0.05, size=(m, 3))
         + np.float32([0.05, -0.02, 0.01])).astype(np.float32)
    q = q[np.argsort(q[:, 0])]
    bdb = pallas_banded.build_banded(_t(db, dev), None, block=block)
    return pallas_banded._icp_moments_banded_args(
        bdb, _t(q, dev), _t(np.ones(m, bool), dev), block, wb, tq, 1) + (
        block, wb, tq, 4.0)


def test_icp_moments_banded_kernel_at_p5_shape(gen, cuda):
    """K7 at P5's launch (16,384 queries against 16,384 db points, blocks
    of 2,048, a window of 2, tiles of 512), on K8's body: the plan's units
    fill the card; per-tile moments within 1e-12 of the plain version's."""
    args = _k7_args(gen, cuda, 16384, 16384, 2048, 2, 512)
    plan = pallas_banded.moments_v2_plan(16384, 512, kernels.sm_count(cuda))
    assert plan["units"] >= 3 * kernels.sm_count(cuda)
    kern = pallas_banded._launch_icp_moments_banded(*args)
    plain = pallas_banded.icp_moments_banded_plain(*args)
    torch.cuda.synchronize()
    _k8_close(kern, plain)


@pytest.mark.parametrize("dup,grid", [(2, None), (4, 64)])
def test_icp_moments_banded_duplicate_db_points(gen, cuda, dup, grid):
    """K7 with every db point `dup` times over, side by side: d2 ties
    inside a block split across the lanes of one query (and across block
    edges), summed exactly in any order (two copies, or four on a 1/64
    grid)."""
    args = _k7_args(gen, cuda, 4096, 1024, 512, 2, 256, dup=dup, grid=grid)
    kern = pallas_banded._launch_icp_moments_banded(*args)
    plain = pallas_banded.icp_moments_banded_plain(*args)
    torch.cuda.synchronize()
    _k8_close(kern, plain)


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_icp_moments_banded_every_lane_count(gen, cuda, lanes):
    """K7 at each lane count its plan can pick, on duplicated db points
    and tiles of 384 (dead query slots); two launches give the same
    bits."""
    args = _k7_args(gen, cuda, 6144, 1536, 512, 3, 384, dup=2)
    plan = pallas_banded.moments_v2_plan(1536, 384, kernels.sm_count(cuda),
                                         lanes=lanes)
    kern = pallas_banded._launch_icp_moments_banded(*args, plan=plan)
    again = pallas_banded._launch_icp_moments_banded(*args, plan=plan)
    plain = pallas_banded.icp_moments_banded_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(kern, again)
    _k8_close(kern, plain)


@pytest.mark.parametrize("loop", ["icp_fixed_iters_banded",
                                    "icp_fixed_iters_banded_fused",
                                    "icp_fixed_iters_banded_fused_v2"])
def test_banded_loops_match_plain(gen, cuda, loop):
    """K6, K7, K8 through their ICP loops: one launch per iteration; T
    within 1e-4 of the plain versions' (on the CPU)."""
    args = _pair(gen, 3000, cuda)
    kw = dict(iters=6, dist_thresh=3.0, block=512, window_blocks=2,
              query_tile=256)
    fn = getattr(icp, loop)
    kern_fn = {"icp_fixed_iters_banded": pallas_banded.nearest_banded,
               "icp_fixed_iters_banded_fused":
                   pallas_banded.icp_moments_banded,
               "icp_fixed_iters_banded_fused_v2":
                   pallas_banded.icp_moments_banded_v2}[loop]
    before = kern_fn.launches
    kern = fn(*args, **kw)
    torch.cuda.synchronize()
    assert kern_fn.launches == before + 6
    plain = fn(*[a.cpu() for a in args], device="cpu", **kw)
    torch.testing.assert_close(kern.cpu(), plain, rtol=0, atol=1e-4)


def _surface_clouds(gen, b, n):
    """Points on unit spheres and boxes, normalised into the unit ball
    (the density of ModelNet-style clouds), [B,N,3] f32."""
    out = []
    for k in range(b):
        p = gen.normal(size=(n, 3))
        p /= np.linalg.norm(p, axis=1, keepdims=True)
        if k % 2:
            p /= np.abs(p).max(axis=1, keepdims=True)     # a cube's surface
        p *= gen.uniform(0.5, 1.0, 3)
        out.append(p / np.linalg.norm(p, axis=1).max())
    return np.stack(out).astype(np.float32)


@pytest.mark.parametrize("b,n,m,masked", [(32, 4096, 512, False),
                                          (3, 1000, 200, True),
                                          (2, 20000, 64, True),
                                          (8, 128, 512, False)])
def test_fps_kernel_matches_plain(gen, cuda, b, n, m, masked):
    """Kernel 11: idx equal to the plain version's, bit for bit (N = 4096
    keeps mind in registers and the cloud in shared memory, N = 1000 has
    a ragged last warp, N = 20000 uses the global-memory paths, and
    N = 128 < m = 512, the toy task's SA1, repeats its picks)."""
    pts = _t(_surface_clouds(gen, b, n), cuda)
    mask = _t(gen.uniform(size=(b, n)) > 0.2, cuda) if masked else None
    before = pallas_fps.fps_pallas_batched.launches
    k = pallas_fps.fps_pallas_batched(pts, m, mask=mask)
    torch.cuda.synchronize()
    assert pallas_fps.fps_pallas_batched.launches == before + 1
    elig = torch.ones((b, n), dtype=torch.bool, device=cuda) \
        if mask is None else mask
    assert torch.equal(k, pallas_fps.fps_plain(pts, m, elig))
    one = pallas_fps.fps_pallas(pts[1], m, mask=None if mask is None
                                else mask[1])
    assert torch.equal(one, k[1])


def _fps_case(gen, kind, b, n):
    """(points [b,n,3], eligible [b,n]) for the tie-heavy FPS cases."""
    if kind == "grid":          # integer grid points: equal d2 everywhere
        pts = gen.integers(-8, 8, (b, n, 3)).astype(np.float32)
    elif kind == "duplicates":  # every point four times
        pts = np.repeat(_surface_clouds(gen, b, n // 4), 4, axis=1)
    else:
        pts = _surface_clouds(gen, b, n)
    elig = np.ones((b, n), bool)
    if kind == "one_eligible":
        elig[:] = False
        elig[np.arange(b), gen.integers(1, n, b)] = True
    return pts, elig


@pytest.mark.parametrize("kind", ["grid", "duplicates", "one_eligible"])
def test_fps_kernel_on_ties_equals_plain(gen, cuda, kind):
    """Kernel 11 on an integer-grid cloud, on duplicated points and with
    one eligible point: idx equal to `fps_plain` (the lowest index wins
    every tie); kernel 10 equal to its row; two runs the same bits."""
    pts, elig = _fps_case(gen, kind, 4, 4096)
    pts, elig = _t(pts, cuda), _t(elig, cuda)
    k = pallas_fps._launch_fps(pts, 512, elig)
    again = pallas_fps._launch_fps(pts, 512, elig)
    torch.cuda.synchronize()
    assert torch.equal(k, again)
    assert torch.equal(k, pallas_fps.fps_plain(pts, 512, elig))
    one = pallas_fps.fps_pallas(pts[2], 512, mask=elig[2])
    assert torch.equal(one, k[2])


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("n", [128, 1000, 4096])
def test_fps_kernel_at_every_width(gen, cuda, threads, n):
    """Every CTA width `fps_plan` takes, on a grid cloud with a mask
    (ties, ineligible points, ragged warps): idx equal to `fps_plain`."""
    pts, _ = _fps_case(gen, "grid", 3, n)
    pts = _t(pts, cuda)
    elig = _t(gen.uniform(size=(3, n)) > 0.2, cuda)
    plan = pallas_fps.fps_plan(3, n, 256, kernels.sm_count(cuda),
                               threads=threads)
    k = pallas_fps._launch_fps(pts, 256, elig, plan=plan)
    torch.cuda.synchronize()
    assert torch.equal(k, pallas_fps.fps_plain(pts, 256, elig)), plan


@pytest.mark.parametrize("n,mode", [(4096, "registers"), (12000, "shared"),
                                    (17000, "scratch"), (20000, "global")])
def test_fps_kernel_in_every_mode(gen, cuda, n, mode):
    """Each place the kernel keeps a cloud, at the plan's default width:
    idx equal to `fps_plain` on masked grid clouds."""
    pts, _ = _fps_case(gen, "grid", 2, n)
    pts = _t(pts, cuda)
    elig = _t(gen.uniform(size=(2, n)) > 0.1, cuda)
    plan = pallas_fps.fps_plan(2, n, 64, kernels.sm_count(cuda))
    assert plan["mode"] == mode
    k = pallas_fps._launch_fps(pts, 64, elig)
    torch.cuda.synchronize()
    assert torch.equal(k, pallas_fps.fps_plain(pts, 64, elig))


def test_fps_kernel_rejects_a_plan_it_cannot_run(gen, cuda):
    """A width that cannot hold the cloud in its mode is refused at
    launch, not run."""
    pts = _t(_surface_clouds(gen, 1, 4096), cuda)
    elig = torch.ones((1, 4096), dtype=torch.bool, device=cuda)
    bad = dict(pallas_fps.fps_plan(1, 4096, 8, 132), threads=32, per=8)
    with pytest.raises(RuntimeError):
        pallas_fps._launch_fps(pts, 8, elig, plan=bad)


@pytest.mark.parametrize("m,n,c,k,radius", [(512, 4096, 6, 128, 0.4),
                                            (512, 4096, 6, 16, 0.1),
                                            (128, 512, 323, 32, 0.2)])
def test_ball_group_kernel_matches_plain(gen, cuda, m, n, c, k, radius):
    """Kernel 12 at cls-msg's SA1 and SA2 shapes (B cut to 4): idx equal
    to the plain version's, grouped rows equal; and the unmasked result
    equals ball_query + group_points - centre wherever no point lies
    within 1e-5 of the radius (the two distance formulas round apart)."""
    b = 4
    xyz = _surface_clouds(gen, b, n)
    packed = np.concatenate(
        [xyz, gen.normal(size=(b, n, c - 3)).astype(np.float32)], axis=-1)
    centers = xyz[:, :m]
    packed, centers = _t(packed, cuda), _t(centers, cuda)
    mask = _t(gen.uniform(size=(b, n)) > 0.1, cuda)
    for pm in (mask, None):
        before = pallas_ballgroup.ball_group.launches
        gk, ik = pallas_ballgroup.ball_group(centers, packed, radius, k,
                                             points_mask=pm)
        torch.cuda.synchronize()
        assert pallas_ballgroup.ball_group.launches == before + 1
        gp, ip = pallas_ballgroup.ball_group_plain(centers, packed, radius,
                                                   k, points_mask=pm)
        assert torch.equal(ik, ip)
        assert torch.equal(gk, gp)
    # gk, ik: the unmasked launch
    idx, _ = ball_query(centers, packed[..., :3].contiguous(), radius, k)
    d2 = ((centers[:, :, None] - packed[:, None, :, :3]) ** 2).sum(-1)
    near = ((d2 - radius ** 2).abs() < 1e-5).any(-1)           # [B,M]
    same = (idx == ik).all(-1)
    assert bool((same | near).all())
    comp = group_points(packed, idx)
    comp[..., :3] -= centers[:, :, None]
    assert torch.equal(gk[same], comp[same])


# kernel 12's launches on P7 (cls-msg) and P8 (cls-ssg): (M, N, C, K, r)
BALL_GROUP_PATHS = [(512, 4096, 6, 16, 0.1), (512, 4096, 6, 32, 0.2),
                    (512, 4096, 6, 128, 0.4), (128, 512, 323, 32, 0.2),
                    (512, 4096, 6, 64, 0.2), (128, 512, 131, 64, 0.4)]


def _ball_group_case(gen, dev, b, m, n, c):
    """(centres [b,m,3], packed [b,n,c]): surface clouds with normal
    features; the centres are the cloud's first m points (FPS picks of
    the cloud in the model)."""
    xyz = _surface_clouds(gen, b, n)
    packed = np.concatenate(
        [xyz, gen.normal(size=(b, n, c - 3)).astype(np.float32)], axis=-1)
    return _t(xyz[:, :m], dev), _t(packed, dev)


def _ball_group_equal(centers, packed, radius, k, pm=None, plan=None):
    """The kernel under `plan` (default the plan's own) against the plain
    version: idx equal, rows bit-equal."""
    gk, ik = pallas_ballgroup._launch_ball_group(centers, packed, radius, k,
                                                 pm, True, plan=plan)
    gp, ip = pallas_ballgroup.ball_group_plain(centers, packed, radius, k,
                                               pm)
    torch.cuda.synchronize()
    assert torch.equal(ik, ip)
    assert torch.equal(gk, gp)
    return ik


@pytest.mark.parametrize("mode", ["shared", "global"])
@pytest.mark.parametrize("m,n,c,k,radius", BALL_GROUP_PATHS)
def test_ball_group_kernel_at_the_paths_shapes(gen, cuda, m, n, c, k,
                                               radius, mode):
    """Kernel 12 at every P7 and P8 launch shape at full B 32, in both of
    the plan's modes (the cloud staged in shared memory, or read from
    device memory): idx and rows bit-equal to the plain version's."""
    centers, packed = _ball_group_case(gen, cuda, 32, m, n, c)
    plan = pallas_ballgroup.ball_group_plan(32, m, n, c, k,
                                            kernels.sm_count(cuda),
                                            mode=mode)
    assert plan["store_bytes"] == 16
    _ball_group_equal(centers, packed, radius, k, plan=plan)


@pytest.mark.parametrize("mode", ["shared", "global"])
@pytest.mark.parametrize("case", ["kc_not_4", "c3", "n_below_k",
                                  "empty_balls", "all_masked",
                                  "duplicates"])
def test_ball_group_kernel_edge_cases(gen, cuda, case, mode):
    """Kernel 12 against the plain version, bit for bit, in both modes:
    nsample * C % 4 != 0 (5 channels, nsample 3: 4-byte stores); C 3 (xyz
    only); fewer points than nsample; empty balls (centres away from the
    cloud: idx 0, row 0 minus the centre); a fully masked cloud; every
    point four times over (hits in ascending index across copies)."""
    b, m, n, c, k, radius, pm = 4, 200, 1000, 6, 32, 0.3, None
    if case == "kc_not_4":
        c, k = 5, 3
    elif case == "c3":
        c = 3
    elif case == "n_below_k":
        n, m, k, radius = 20, 20, 32, 0.8
    centers, packed = _ball_group_case(gen, cuda, b, m, n, c)
    if case == "empty_balls":
        centers[:, ::3] += 5.0
    elif case == "all_masked":
        pm = torch.zeros((b, n), dtype=torch.bool, device=cuda)
    elif case == "duplicates":
        packed = packed[:, :n // 4].repeat_interleave(4, dim=1).contiguous()
        centers = packed[:, :m:4, :3].contiguous()
    plan = pallas_ballgroup.ball_group_plan(b, centers.shape[1], n, c, k,
                                            kernels.sm_count(cuda),
                                            mode=mode)
    assert plan["store_bytes"] == (4 if case == "kc_not_4" else 16)
    idx = _ball_group_equal(centers, packed, radius, k, pm, plan=plan)
    if case in ("empty_balls", "all_masked"):
        assert bool((idx[:, ::3] if case == "empty_balls" else idx)
                    .eq(0).all())
    if case == "duplicates":
        assert bool((idx[..., 1:4] - idx[..., :1] == torch.tensor(
            [1, 2, 3], device=cuda)).all())


def test_ball_group_kernel_rejects_a_plan_it_cannot_run(gen, cuda):
    """16-byte stores where nsample * C % 4 != 0, a width off the warp
    grid and a cloud past shared memory forced into it are refused at
    launch, not run."""
    centers, packed = _ball_group_case(gen, cuda, 2, 64, 512, 5)
    sms = kernels.sm_count(cuda)
    plan = pallas_ballgroup.ball_group_plan(2, 64, 512, 5, 3, sms)
    for bad in (dict(plan, store_bytes=16), dict(plan, threads=48)):
        with pytest.raises(RuntimeError):
            pallas_ballgroup._launch_ball_group(centers, packed, 0.3, 3,
                                                plan=bad)
    big_c, big_p = _ball_group_case(gen, cuda, 1, 16, 16000, 3)
    plan = pallas_ballgroup.ball_group_plan(1, 16, 16000, 3, 8, sms)
    assert plan["mode"] == "global"
    with pytest.raises(RuntimeError):
        pallas_ballgroup._launch_ball_group(big_c, big_p, 0.1, 8,
                                            plan=dict(plan, mode="shared"))
    _ball_group_equal(big_c, big_p, 0.1, 8, plan=plan)


def test_cls_ssg_forward_kernels_vs_plain(gen, cuda, monkeypatch):
    """One cls-ssg forward (B = 4, 2,048 points): 2 FPS and 2 ball-group
    launches; logits with the kernels swapped for their plain versions
    agree within 1e-5."""
    from pctpu_torch.nn import train as T
    from pctpu_torch.nn.config import TrainConfig
    model = T.build_model(TrainConfig(model="cls-ssg"), device=cuda)
    xyz = _surface_clouds(gen, 4, 2048)
    pc = _t(np.concatenate([xyz, xyz], axis=-1), cuda)
    f0 = pallas_fps.fps_pallas_batched.launches
    g0 = pallas_ballgroup.ball_group.launches
    with torch.no_grad():
        logits = model(pc)
    torch.cuda.synchronize()
    assert pallas_fps.fps_pallas_batched.launches == f0 + 2
    assert pallas_ballgroup.ball_group.launches == g0 + 2
    monkeypatch.setattr(pallas_fps, "_launch_fps", pallas_fps.fps_plain)
    monkeypatch.setattr(pallas_ballgroup, "_launch_ball_group",
                        pallas_ballgroup.ball_group_plain)
    with torch.no_grad():
        plain = model(pc)
    assert logits.shape == (4, 40) and bool(torch.isfinite(logits).all())
    torch.testing.assert_close(logits, plain, rtol=0, atol=1e-5)


@pytest.mark.parametrize("b,n,m,c", [(32, 512, 8192, 320), (3, 700, 1001, 7),
                                     (2, 50, 33, 1)])
def test_gather_rows_kernel_matches_plain(gen, cuda, b, n, m, c):
    """Kernel 13: an exact copy, equal to torch.gather after clipping
    (out-of-range indices included)."""
    table = _t(gen.normal(size=(b, n, c)).astype(np.float32), cuda)
    idx = _t(gen.integers(-2, n + 2, (b, m)).astype(np.int32), cuda)
    before = pallas_gather.gather_rows_pallas.launches
    k = pallas_gather.gather_rows_pallas(table, idx)
    torch.cuda.synchronize()
    assert pallas_gather.gather_rows_pallas.launches == before + 1
    assert torch.equal(k, pallas_gather.gather_rows_plain(table, idx))


@pytest.mark.parametrize("b,n,m,c", [(32, 512, 16384, 323),
                                     (2, 1000, 60000, 5), (4, 64, 300, 40),
                                     (1, 3, 0, 4)])
def test_scatter_add_rows_kernel_matches_plain(gen, cuda, b, n, m, c):
    """Kernel 14 == its plain version bit for bit: the cls-msg SA2 shape
    (the inverted index in shared memory), one whose N + M ints exceed it
    (global scratch), a heavy bucket, clipped indices and M = 0."""
    g = _t(gen.normal(size=(b, m, c)).astype(np.float32), cuda)
    idx = gen.integers(-2, n + 2, (b, m)).astype(np.int32)
    idx[:, ::4] = 1
    idx = _t(idx, cuda)
    before = pallas_gather.scatter_add_rows_pallas.launches
    k = pallas_gather.scatter_add_rows_pallas(g, idx, n)
    torch.cuda.synchronize()
    assert pallas_gather.scatter_add_rows_pallas.launches == before + 1
    assert torch.equal(k, pallas_gather.scatter_add_rows_plain(g, idx, n))
    again = pallas_gather.scatter_add_rows_pallas(g, idx, n)
    assert torch.equal(k, again)                 # deterministic


@pytest.mark.parametrize("case", ["one_row", "out_of_range", "c131", "c323",
                                  "c700", "phase_m8192", "phase_m16384"])
def test_scatter_add_rows_kernel_edge_cases(gen, cuda, case):
    """Kernel 14 == its plain version bit for bit, and two runs give the
    same bits: every entry on one row, indices out of range on both sides,
    widths of 131, 323 and 700 channels (scalar loads; 700 walks each
    bucket twice), and the kernels-13/14 phase's two shapes (C 320, float4
    loads)."""
    b, m, n = 4, 3000, 64
    c = {"c131": 131, "c323": 323, "c700": 700}.get(case, 40)
    if case.startswith("phase"):
        b, m, n, c = 32, int(case[len("phase_m"):]), 512, 320
    g = _t(gen.normal(size=(b, m, c)).astype(np.float32), cuda)
    if case == "one_row":
        idx = np.full((b, m), 9, np.int32)
    elif case == "out_of_range":
        idx = gen.choice([-7, -1, n, n + 40, 5], (b, m)).astype(np.int32)
    else:
        idx = gen.integers(0 if case.startswith("phase") else -2,
                           n + (0 if case.startswith("phase") else 2),
                           (b, m)).astype(np.int32)
    idx = _t(idx, cuda)
    k = pallas_gather.scatter_add_rows_pallas(g, idx, n)
    assert torch.equal(k, pallas_gather.scatter_add_rows_plain(g, idx, n))
    assert torch.equal(pallas_gather.scatter_add_rows_pallas(g, idx, n), k)


def test_group_points_pallas_kernels_forward_backward(gen, cuda):
    """group_points_pallas on the card: forward (kernel 13) equals
    torch.gather; backward (kernel 14) equals the plain scatter-add bit
    for bit and torch.gather's atomic backward within 1e-5."""
    b, n, m, k, c = 4, 512, 128, 64, 320
    pts = _t(gen.normal(size=(b, n, c)).astype(np.float32), cuda)
    idx = _t(gen.integers(0, n, (b, m, k)).astype(np.int32), cuda)
    ct = _t(gen.normal(size=(b, m, k, c)).astype(np.float32), cuda)
    p = pts.clone().requires_grad_()
    out = pallas_gather.group_points_pallas(p, idx)
    assert torch.equal(out, group_points(pts, idx))
    out.backward(ct)
    plain = pallas_gather.scatter_add_rows_plain(
        ct.reshape(b, m * k, c), idx.reshape(b, m * k), n)
    assert torch.equal(p.grad, plain)
    q = pts.clone().requires_grad_()
    group_points(q, idx).backward(ct)
    torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=1e-5)


def test_ball_group_backward_kernel_matches_plain(gen, cuda):
    """Kernel 12's backward on the card (kernel 14's entry, one launch for
    d_packed) equals the plain scatter-add of the cotangent over the
    emitted idx bit for bit; d_centers = -(xyz cotangent summed)."""
    b, n, m, k, c = 4, 512, 128, 32, 323
    xyz = _surface_clouds(gen, b, n)
    packed = _t(np.concatenate(
        [xyz, gen.normal(size=(b, n, c - 3)).astype(np.float32)], -1), cuda)
    centers = _t(xyz[:, :m], cuda).requires_grad_()
    p = packed.clone().requires_grad_()
    ct = _t(gen.normal(size=(b, m, k, c)).astype(np.float32), cuda)
    before = pallas_gather.scatter_add_rows_pallas.launches
    grouped, idx = pallas_ballgroup.ball_group(centers, p, 0.4, k)
    grouped.backward(ct)
    torch.cuda.synchronize()
    assert pallas_gather.scatter_add_rows_pallas.launches == before + 1
    plain = pallas_gather.scatter_add_rows_plain(
        ct.reshape(b, m * k, c), idx.reshape(b, m * k), n)
    assert torch.equal(p.grad, plain)
    assert torch.equal(centers.grad, -ct[..., :3].sum(dim=2))


def _moments_case(gen, dev, banded, b=2, n=3000, q_tile=256, db_tile=512):
    """Kernel 9's operands on x-sorted tilted planes of n points (not a
    multiple of db_tile); batch 0's second query tile has no valid
    point."""
    g = gen.uniform(-20, 20, (b, n, 2))
    pts = np.concatenate([g, 0.05 * g[..., :1] + 0.1 * g[..., 1:] + gen.normal(
        scale=0.01, size=(b, n, 1))], axis=-1).astype(np.float32)
    pts = np.take_along_axis(pts, np.argsort(pts[..., :1], axis=1), axis=1)
    mask = gen.uniform(size=(b, n)) > 0.1
    mask[0, q_tile:2 * q_tile] = False
    np_ = -(-n // max(q_tile, db_tile)) * max(q_tile, db_tile)
    amat, dbmat, cent, valid = pallas_fpfh._moments_inputs(
        _t(pts, dev), _t(mask, dev), np_, q_tile)
    base, nt = pallas_fpfh._band(amat[..., 0], valid, 3.0, q_tile, db_tile,
                                 banded, 0.0)
    return (amat, dbmat, cent, base, nt, q_tile, db_tile, 9.0), pts, mask


@pytest.mark.parametrize("banded", [False, True])
def test_moments_kernel_matches_plain(gen, cuda, banded):
    """Kernel 9: every moment within one f32 ulp of the plain version
    (both sum in f64 and round once); a tile with no valid point writes
    zeros when banded (nt = 0)."""
    args, _, _ = _moments_case(gen, cuda, banded)
    before = pallas_fpfh.moments.launches
    k = pallas_fpfh.moments(*args)
    torch.cuda.synchronize()
    assert pallas_fpfh.moments.launches == before + 1
    p = pallas_fpfh.moments_plain(*args)
    inf = torch.tensor(float("inf"), device=cuda)
    assert bool(((k >= torch.nextafter(p, -inf))
                 & (k <= torch.nextafter(p, inf))).all())
    if banded:
        assert int(args[4][0, 1]) == 0 and not bool(k[0, 256:512].any())


def _within_ulp(k, p):
    inf = torch.tensor(float("inf"), device=p.device)
    return bool(((k >= torch.nextafter(p, -inf))
                 & (k <= torch.nextafter(p, inf))).all())


def test_moments_kernel_shuffled_unbanded_cloud(gen, cuda):
    """Kernel 9 on a cloud in no x order (its step tables cannot prune, so
    every step of the band is tested), unbanded: within one f32 ulp of the
    plain version, counts equal, every shape of the plan bit for bit the
    same as the default launch, and a repeat too."""
    b, n = 2, 3000
    g = gen.uniform(-20, 20, (b, n, 2))
    pts = np.concatenate([g, 0.05 * g[..., :1] + gen.normal(
        scale=0.1, size=(b, n, 1))], axis=-1).astype(np.float32)
    mask = gen.uniform(size=(b, n)) > 0.1
    amat, dbmat, cent, valid = pallas_fpfh._moments_inputs(
        _t(pts, cuda), _t(mask, cuda), 3072, 256)
    base, nt = pallas_fpfh._band(amat[..., 0], valid, 1.5, 256, 512, False,
                                 0.0)
    args = (amat, dbmat, cent, base, nt, 256, 512, 2.25)
    k = pallas_fpfh._launch_moments(*args)
    again = pallas_fpfh._launch_moments(*args)
    p = pallas_fpfh.moments_plain(*args)
    torch.cuda.synchronize()
    assert _within_ulp(k, p) and torch.equal(k[..., 9], p[..., 9])
    assert torch.equal(k, again)
    assert float(p[..., 9].sum()) > 10 * b * n
    sms = kernels.sm_count(cuda)
    for threads in (64, 256, 1024):
        for wq in (1, 2, 4):
            plan = pallas_fpfh.moments_plan(b, 3072, 256, sms,
                                            threads=threads, warp_queries=wq)
            assert torch.equal(pallas_fpfh._launch_moments(*args, plan=plan),
                               k), (threads, wq)


@pytest.mark.parametrize("q_tile", [64, 256])
@pytest.mark.parametrize("banded", [False, True])
def test_moments_kernel_query_tiles(gen, cuda, q_tile, banded):
    """Kernel 9 at query tiles of 64 and 256 on x-sorted planes (its step
    tables prune), banded and not: within one f32 ulp of the plain
    version, counts equal, a repeat bit for bit the same."""
    args, _, _ = _moments_case(gen, cuda, banded, q_tile=q_tile)
    k = pallas_fpfh.moments(*args)
    again = pallas_fpfh.moments(*args)
    p = pallas_fpfh.moments_plain(*args)
    torch.cuda.synchronize()
    assert _within_ulp(k, p) and torch.equal(k[..., 9], p[..., 9])
    assert torch.equal(k, again)


def test_normals_radius_fused_kernel_on_a_plane(gen, cuda):
    """Kernel 9 through `normals_radius_fused`: the tilted plane's
    analytic normal (|dot| > 0.99), banded and unbanded alike."""
    _, pts, mask = _moments_case(gen, cuda, False)
    true_n = np.array([-0.05, -0.1, 1.0]) / np.linalg.norm([-0.05, -0.1, 1])
    for banded in (False, True):
        nrm = pallas_fpfh.normals_radius_fused(
            _t(pts, cuda), _t(mask, cuda), radius=3.0, x_banded=banded)
        dots = np.abs(nrm.cpu().numpy() @ true_n)[mask]
        assert dots.min() > 0.99, (banded, dots.min())


def test_moments_kernel_needs_its_tiles(gen, cuda):
    args, _, _ = _moments_case(gen, cuda, False)
    with pytest.raises(ValueError, match="db_tile"):
        pallas_fpfh.moments(*args[:6], 192, args[7])


def test_icp_fixed_iters_p2pl_card_matches_cpu(gen, cuda):
    """Point-to-plane ICP, 3 pairs in lockstep on the card (K1, cuSOLVER's
    6x6 solves) and on the CPU (plain K1, LAPACK): T within 1e-4."""
    b, n = 3, 2000
    g = gen.uniform(-20, 20, (b, n, 2))
    dst = np.concatenate([g, np.sin(0.3 * g[..., :1])
                          + np.cos(0.25 * g[..., 1:])], axis=-1).astype(
                              np.float32)
    nrm = np.stack([-0.3 * np.cos(0.3 * g[..., 0]),
                    0.25 * np.sin(0.25 * g[..., 1]), np.ones_like(g[..., 0])],
                   axis=-1)
    nrm = (nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)).astype(
        np.float32)
    src = (dst - np.array([0.3, -0.2, 0.05])).astype(np.float32)
    mask = gen.uniform(size=(b, n)) > 0.05
    args = [_t(x, cuda) for x in (src, mask, dst, nrm, mask)]
    before = pallas_nn.nn1.launches
    kern = icp.icp_fixed_iters_p2pl(*args, iters=8, dist_thresh=2.0)
    torch.cuda.synchronize()
    assert pallas_nn.nn1.launches == before + 8
    plain = icp.icp_fixed_iters_p2pl(*[a.cpu() for a in args], iters=8,
                                     dist_thresh=2.0, device="cpu")
    torch.testing.assert_close(kern.cpu(), plain, rtol=0, atol=1e-4)


def test_icp_fixed_iters_p2pl_card_vs_cpu_on_a_plane(gen, cuda):
    """On a tilted plane point-to-plane ICP fixes 3 of the 6 degrees of
    freedom. The damped 6x6 (+1e-6 I, as in the reference) turns rounding
    noise along the other 3 into steps, so card and CPU drift apart along
    the plane; the drift is printed. What the plane fixes agrees: both
    poses carry the source onto the target plane (normal within 1e-4,
    every point within 1e-3 m of it)."""
    b, n = 3, 2000
    normal = np.array([-0.05, -0.1, 1.0]) / np.linalg.norm([-0.05, -0.1, 1])

    def plane(size):
        g = gen.uniform(-20, 20, size + (2,))
        return np.concatenate([g, 0.05 * g[..., :1] + 0.1 * g[..., 1:]],
                              axis=-1).astype(np.float32)
    dst = plane((b, n))
    src = (plane((b, n)) - np.array([0.3, -0.2, 0.05])).astype(np.float32)
    nrm = np.broadcast_to(normal, (b, n, 3)).astype(np.float32)
    mask = gen.uniform(size=(b, n)) > 0.05
    args = [_t(x, cuda) for x in (src, mask, dst, nrm, mask)]
    kern = icp.icp_fixed_iters_p2pl(*args, iters=8, dist_thresh=2.0).cpu()
    plain = icp.icp_fixed_iters_p2pl(*[a.cpu() for a in args], iters=8,
                                     dist_thresh=2.0, device="cpu")
    for T in (kern, plain):
        T = T.double().numpy()
        assert np.isfinite(T).all()
        assert np.abs(T[:, :3, :3] @ normal - normal).max() < 1e-4
        moved = np.einsum("bij,bnj->bni", T[:, :3, :3], src) + T[:, None, :3, 3]
        assert np.abs(moved @ normal)[mask].max() < 1e-3
    drift = (kern - plain)[:, :3, 3].norm(dim=-1)
    print(f"p2pl on a plane, card vs CPU: translation drift per pair (m) "
          f"{drift.tolist()}, max |dR| "
          f"{float((kern - plain)[:, :3, :3].abs().max()):.2e}")


def test_pose_graph_card_matches_cpu(gen, cuda):
    """The dense and sparse Gauss-Newton solves (torch.func Jacobians,
    cuSOLVER) on the card against the CPU on a noisy 12-pose loop."""
    from scipy.spatial.transform import Rotation

    from pctpu_torch.parallel import posegraph
    m = 12
    steps = np.tile(np.eye(4, dtype=np.float32), (m, 1, 1))
    steps[:, :3, :3] = Rotation.from_rotvec(
        gen.normal(scale=0.3, size=(m, 3))).as_matrix()
    steps[:, :3, 3] = gen.normal(size=(m, 3))
    gt = [np.eye(4)]
    for k in range(1, m):
        gt.append(gt[-1] @ steps[k])
    gt = np.stack(gt).astype(np.float32)
    ei = np.array(list(range(m - 1)) + [m - 1, 0])
    ej = np.array(list(range(1, m)) + [0, m // 2])
    Tm = np.stack([np.linalg.inv(gt[i]) @ gt[j] for i, j in zip(ei, ej)])
    Tm[:, :3, 3] += gen.normal(scale=0.1, size=(len(ei), 3))
    init = [np.eye(4)]
    for k in range(m - 1):
        init.append(init[-1] @ Tm[k])
    init = np.stack(init).astype(np.float32)
    for fn in (posegraph.optimize_pose_graph,
               posegraph.optimize_pose_graph_sparse):
        kw = dict(iters=4, robust_delta=0.5, robust_warmup=3)
        card = fn(_t(init, cuda), ei, ej, Tm.astype(np.float32), **kw)
        cpu = fn(torch.from_numpy(init), ei, ej, Tm.astype(np.float32),
                 device="cpu", **kw)
        torch.testing.assert_close(card.poses.cpu(), cpu.poses, rtol=0,
                                   atol=1e-3)


# kernel 12's launches in the segmenters at B 24 x 4,096 x 9: (M, N, C, K,
# r) of semseg-ssg's four levels, then semseg-msg's fused scales
SEMSEG_BALL_GROUP = [(1024, 4096, 9, 32, 0.1), (256, 1024, 67, 32, 0.2),
                     (64, 256, 131, 32, 0.4), (16, 64, 259, 32, 0.8),
                     (1024, 4096, 9, 16, 0.05), (256, 1024, 99, 16, 0.1),
                     (256, 1024, 99, 32, 0.2), (64, 256, 259, 16, 0.2),
                     (64, 256, 259, 32, 0.4), (16, 64, 515, 16, 0.4)]


@pytest.mark.parametrize("m,n,c,k,radius", SEMSEG_BALL_GROUP)
def test_ball_group_kernel_at_the_segmenters_shapes(gen, cuda, m, n, c, k,
                                                    radius):
    """Kernel 12 at every fused scale of semseg-ssg and semseg-msg (B cut
    to 4), packed widths that are not a multiple of 4 (67, 99, 131, 259,
    515) and 16 centres against 64 points: idx and rows bit-equal to the
    plain version's."""
    centers, packed = _ball_group_case(gen, cuda, 4, m, n, c)
    _ball_group_equal(centers, packed, radius, k)


@pytest.mark.parametrize("b,n,m,c", [(24, 1024, 256 * 32, 67),
                                     (24, 256, 64 * 32, 131),
                                     (24, 64, 16 * 32, 259)])
def test_scatter_add_rows_kernel_at_the_segmenters_shapes(gen, cuda, b, n,
                                                          m, c):
    """Kernel 14 as kernel 12's backward at semseg-ssg's SA2-SA4 (rows of
    67, 131 and 259 floats): bit-equal to the plain version's."""
    g = _t(gen.normal(size=(b, m, c)).astype(np.float32), cuda)
    idx = _t(gen.integers(0, n, (b, m)).astype(np.int32), cuda)
    k = pallas_gather.scatter_add_rows_pallas(g, idx, n)
    torch.cuda.synchronize()
    assert torch.equal(k, pallas_gather.scatter_add_rows_plain(g, idx, n))


def test_kernels_at_the_kitti_preset_shapes(gen, cuda):
    """The KITTI preset (cls-msg on 64-point clouds): kernel 11 asked for
    512 picks of 64 points returns every point, then index 0, as its
    plain version; kernel 12 with nsample 128 > N = 64 equals its plain
    version."""
    pts = _t(_surface_clouds(gen, 8, 64), cuda)
    k = pallas_fps.fps_pallas_batched(pts, 512)
    elig = torch.ones((8, 64), dtype=torch.bool, device=cuda)
    assert torch.equal(k, pallas_fps.fps_plain(pts, 512, elig))
    assert bool((k[:, 64:] == 0).all())
    centers = torch.gather(pts, 1, k.long()[..., None].expand(-1, -1, 3))
    packed = torch.cat([pts, pts], -1)
    for nsample, radius in ((16, 0.1), (32, 0.2), (128, 0.4)):
        _ball_group_equal(centers, packed, radius, nsample)


def _cpu_copy(model):
    import copy
    return copy.deepcopy(model).cpu()


def test_semseg_ssg_forward_card_matches_cpu(gen, cuda, monkeypatch):
    """semseg-ssg eval logits (B 2 x 4,096 x 9) on the card == the CPU's
    within 1e-4, every scale through kernel 12 / its plain version (the
    same neighbours on both sides), three-NN's distances equal on both;
    with kernels 11 and 12 swapped for their plain versions within 1e-5."""
    from pctpu_torch.models import pointnet2 as tp
    from pctpu_torch.nn import train as T
    from pctpu_torch.nn.config import S3DIS_SEMSEG_SSG
    from pctpu_torch.ops import interpolate
    model = T.build_model(S3DIS_SEMSEG_SSG, device=cuda)
    xyz = _surface_clouds(gen, 2, 4096)
    pc = _t(np.concatenate([xyz, gen.uniform(size=(2, 4096, 3)), xyz],
                           axis=-1).astype(np.float32), cuda)
    monkeypatch.setattr(tp, "fused_ok", lambda *a: True)
    with torch.no_grad():
        logits = model(pc)
        cpu = _cpu_copy(model)(pc.cpu())
    assert logits.shape == (2, 4096, 13)
    torch.testing.assert_close(logits.cpu(), cpu, rtol=1e-4, atol=1e-4)
    db = pc[:, :1024, :3].contiguous()
    d_k, i_k = interpolate.three_nn(pc[..., :3], db)
    d_c, i_c = interpolate.three_nn(pc[..., :3].cpu(), db.cpu())
    assert torch.equal(d_k.cpu(), d_c) and torch.equal(i_k.cpu(), i_c)
    monkeypatch.setattr(pallas_fps, "_launch_fps", pallas_fps.fps_plain)
    monkeypatch.setattr(pallas_ballgroup, "_launch_ball_group",
                        pallas_ballgroup.ball_group_plain)
    with torch.no_grad():
        plain = model(pc)
    torch.testing.assert_close(logits, plain, rtol=0, atol=1e-5)


def test_window_bf16_card_matches_cpu(gen, cuda):
    """cls-ssg at window grouping with compute_dtype bfloat16 (workload
    6's classifier), B 2 x 4,096 x 6: the card's logits within 1e-2 of
    the CPU's largest (at least 1), the tolerance
    `tests/test_torch_window.py` holds the CPU to against the reference
    (cuBLAS and the CPU round each bf16 product after float32 sums in
    other orders)."""
    from pctpu_torch.nn import train as T
    from pctpu_torch.nn.config import TrainConfig
    model = T.build_model(TrainConfig(grouping="window",
                                      compute_dtype="bfloat16"), device=cuda)
    xyz = _surface_clouds(gen, 2, 4096)
    pc = _t(np.concatenate([xyz, xyz], axis=-1), cuda)
    with torch.no_grad():
        logits = model(pc)
        cpu = _cpu_copy(model)(pc.cpu())
    assert logits.dtype == torch.float32
    torch.testing.assert_close(logits.cpu(), cpu, rtol=0, atol=1e-2 * max(
        1.0, float(cpu.abs().max())))


def _cpu_gumbel_sampler(seed):
    """The plane's triples as the Gumbel top-3 of noise drawn on the CPU
    from `seed` at every call, whatever device the vote mask is on: one
    sampler for the card and the CPU."""
    from pctpu_torch.cluster.plane_ransac import gumbel_sampler

    def sample(vote_mask, h):
        draw = gumbel_sampler(torch.Generator().manual_seed(seed))
        return draw(vote_mask.cpu(), h).to(vote_mask.device)
    return sample


def test_segmentation_card_matches_cpu(gen, cuda):
    """segment_ground_and_objects on a mini-world frame (7,560 points) with
    the same plane draws on both devices: ground, object ids and
    foreground equal."""
    import tempfile
    from pctpu_torch.core import io
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.pipelines import miniworld
    from pctpu_torch.pipelines.segmentation import segment_ground_and_objects
    with tempfile.TemporaryDirectory() as root:
        fid = miniworld.generate_dataset(root, 1, seed=0)[0]
        pts = io.read_velodyne_bin(f"{root}/velodyne/{fid}.bin")
    cfg = miniworld.seg_config()
    out = []
    for dev in (cuda, torch.device("cpu")):
        pc = PointCloud.from_numpy(pts, device=dev)
        out.append(segment_ground_and_objects(
            pc.points, pc.mask, sampler=_cpu_gumbel_sampler(0), cfg=cfg))
    for name in ("ground_mask", "object_ids", "foreground"):
        assert torch.equal(getattr(out[0], name).cpu(),
                           getattr(out[1], name)), name
    ids = out[0].object_ids.cpu().numpy()
    assert len(np.unique(ids[ids >= 0])) >= 4


def test_kmeans_card_repeats_and_matches_cpu(gen, cuda):
    """k-means on 3 blobs (N 3,000): the centre sums through kernel 14,
    two runs on the card bit for bit, and labels, n_iter equal to the
    CPU's (the plain version) with centres within 1e-5."""
    from pctpu_torch.cluster.kmeans import kmeans
    c = np.array([[0.0, 0.0], [4.0, 1.0], [1.5, 4.5]])
    x = (c[np.arange(3000) % 3] + gen.normal(scale=0.8, size=(3000, 2))
         ).astype(np.float32)
    before = pallas_gather.scatter_add_rows_pallas.launches
    runs = [kmeans(_t(x, cuda), 3, generator=torch.Generator().manual_seed(1))
            for _ in range(2)]
    assert (pallas_gather.scatter_add_rows_pallas.launches - before
            == 2 * runs[0][2])
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    cc, cl, cn = kmeans(torch.from_numpy(x), 3,
                        generator=torch.Generator().manual_seed(1))
    assert cn == runs[0][2]
    assert torch.equal(runs[0][1].cpu(), cl)
    torch.testing.assert_close(runs[0][0].cpu(), cc, rtol=0, atol=1e-5)


def test_random_voxel_card_matches_cpu(gen, cuda):
    """voxel_downsample(method="random") with the same priorities on both
    devices: the same picks."""
    from pctpu_torch.ops.voxel import voxel_downsample
    pts = gen.uniform(-20, 20, (20000, 3)).astype(np.float32)
    mask = gen.uniform(size=20000) > 0.1
    prio = torch.from_numpy(gen.integers(0, 2**31 - 1, 20000).astype(
        np.int32))
    k = voxel_downsample(_t(pts, cuda), _t(mask, cuda), 1.5, method="random",
                         prio=prio.to(cuda))
    c = voxel_downsample(torch.from_numpy(pts), torch.from_numpy(mask), 1.5,
                         method="random", prio=prio)
    assert torch.equal(k.mask.cpu(), c.mask)
    assert torch.equal(k.points.cpu(), c.points)


def _boxes_scene(gen, n=1500):
    """A ground plane and four boxes' faces, about 16 x 16 m."""
    g = gen.uniform(-8, 8, (n // 2, 3))
    g[:, 2] = gen.normal(scale=0.02, size=n // 2)
    pts = [g]
    for _ in range(4):
        c = np.append(gen.uniform(-6, 6, 2), 0.0)
        e = gen.uniform(0.8, 2.0, 3)
        u = gen.uniform(-0.5, 0.5, (n // 8, 3))
        rows, ax = np.arange(n // 8), gen.integers(0, 3, n // 8)
        u[rows, ax] = np.sign(u[rows, ax]) * 0.5
        pts.append(c + u * e + [0.0, 0.0, e[2] / 2])
    return np.concatenate(pts).astype(np.float32)


def test_iou_and_nms_rotated_card_match_cpu(gen, cuda):
    """Rotated BEV/3D IoU within 1e-5 and greedy NMS (equal scores
    included) index for index, card against CPU."""
    from pctpu_torch.ops import box3d
    boxes = np.concatenate([
        gen.uniform(-3, 3, (60, 2)), gen.uniform(-1, 1, (60, 1)),
        gen.uniform(0.5, 4.0, (60, 3)), gen.uniform(-np.pi, np.pi, (60, 1))],
        axis=1).astype(np.float32)
    for fn in (box3d.iou_bev, box3d.iou3d):
        torch.testing.assert_close(fn(_t(boxes, cuda), _t(boxes, cuda)).cpu(),
                                   fn(_t(boxes, "cpu"), _t(boxes, "cpu")),
                                   rtol=0, atol=1e-5)
    for scores in (gen.uniform(size=60), np.ones(60)):
        s = scores.astype(np.float32)
        k = box3d.nms_rotated(_t(boxes, cuda), _t(s, cuda), 0.3, 80)
        c = box3d.nms_rotated(_t(boxes, "cpu"), _t(s, "cpu"), 0.3, 80)
        assert torch.equal(k[0].cpu(), c[0]) and torch.equal(k[1].cpu(), c[1])


def test_iss_keypoints_card_match_cpu(gen, cuda):
    """ISS on a boxes scene: the same keypoints on the card as on the
    CPU, eigenvalues within 1e-4 of each point's largest."""
    from pctpu_torch.features.iss import iss_keypoints
    p = _boxes_scene(gen)
    k = iss_keypoints(_t(p, cuda), salient_radius=1.0, non_max_radius=0.7)
    c = iss_keypoints(_t(p, "cpu"), salient_radius=1.0, non_max_radius=0.7)
    assert torch.equal(k.keypoint_mask.cpu(), c.keypoint_mask)
    assert int(c.keypoint_mask.sum()) >= 20
    err = (k.eigvals.cpu() - c.eigvals).abs() / c.eigvals[:, :1].clamp_min(
        1e-12)
    assert float(err.max()) <= 1e-4


def test_proposal_net_card_matches_cpu(gen, cuda):
    """ProposalNet (npoints 128, 32) at B 2 x 512 x 4, eval: the card's
    logits and residuals within 1e-4 of the CPU's."""
    from pctpu_torch.models.pointnet2 import morton_sort_packed
    from pctpu_torch.models.pointrcnn import ProposalNet
    pc = morton_sort_packed(_t(np.concatenate([
        gen.uniform(-8, 8, (2, 512, 3)), gen.uniform(size=(2, 512, 1))],
        -1).astype(np.float32), "cpu"))
    model = ProposalNet(npoints=(128, 32), in_channels=4,
                        generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        cs, cr = model(pc)
        ks, kr = model.to(cuda)(pc.to(cuda))
    torch.testing.assert_close(ks.cpu(), cs, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(kr.cpu(), cr, rtol=1e-4, atol=1e-4)


def _walls_scene(gen, n=2000):
    """Ground over 40 x 40 m and four box walls (tests/test_pipeline.py:
    15-33)."""
    g = gen.uniform(-20, 20, (n // 2, 3))
    g[:, 2] = gen.normal(scale=0.05, size=n // 2)
    pts = [g]
    for _ in range(4):
        c, w, h = gen.uniform(-15, 15, 2), gen.uniform(1, 3, 2), \
            gen.uniform(2, 5)
        face = gen.uniform(-1, 1, (n // 8, 3))
        face[:, 0] = c[0] + w[0] * np.sign(face[:, 0])
        face[:, 1] = c[1] + w[1] * face[:, 1]
        face[:, 2] = h * (face[:, 2] + 1) / 2
        pts.append(face)
    return np.concatenate(pts).astype(np.float32)


def test_register_pairs_iss_card_matches_cpu(cuda):
    """`register_pairs(keypoints="iss")` on the 2-pair walls scene of
    tests/test_torch_pipeline.py (seed 0, 10 and 17 deg) at voxel 1.0:
    K1-K4 launch (K2/K3 twice, K4 twice, K1 once); at least 10 matches a
    pair on either side; the card's poses within the success bound and
    within 0.05 m and 0.5 deg of the CPU's with the same draws (K3 sums in
    another order than its plain version's matmul), its matches within 3
    of the CPU's."""
    from pctpu_torch.core import se3
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.register import pipeline
    from pctpu_torch.register.ransac import generator_sampler
    rng = np.random.default_rng(0)
    src = _walls_scene(rng)
    gts, dsts = [], []
    for i in range(2):
        a = np.radians(10.0 + 7.0 * i)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]
        T[:3, 3] = [2.0 + i, -1.0, 0.1 * i]
        gts.append(T)
        dsts.append(src @ T[:3, :3].T + T[:3, 3]
                    + rng.normal(scale=0.02, size=src.shape))
    srcs, dst = np.stack([src, src]), np.stack(dsts).astype(np.float32)
    mask = np.ones((2, len(src)), bool)
    cfg = pipeline.RegistrationConfig(
        voxel_size=1.0, feature_radius=5.0, ransac_dist=1.5,
        ransac_hypotheses=2048, icp_dist_thresh=2.0,
        downsample_capacity=1024, keypoints="iss")

    def sampler(nv, H):
        return generator_sampler(torch.Generator().manual_seed(0))(
            nv.cpu(), H).to(nv.device)
    counted = (pallas_nn.nn1, pallas_fpfh.spfh, pallas_fpfh.wsum,
               pallas_icp_mega.icp_mega_batch)
    before = [f.launches for f in counted]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        out[dev.type] = pipeline.register_pairs(
            PointCloud(_t(srcs, dev), _t(mask, dev)),
            PointCloud(_t(dst, dev), _t(mask, dev)), cfg=cfg,
            sampler=sampler, device=dev)
    assert [f.launches - b for f, b in zip(counted, before)] == [1, 2, 2, 2]
    rte, rre = se3.pose_diff_rte_rre(out["cuda"].T.cpu(),
                                     torch.from_numpy(np.stack(gts)))
    assert float(rte.max()) < 2.0 and float(rre.max()) < 5.0
    drte, drre = se3.pose_diff_rte_rre(out["cuda"].T.cpu(), out["cpu"].T)
    assert float(drte.max()) < 0.05 and float(drre.max()) < 0.5
    assert int((out["cuda"].num_matches.cpu()
                - out["cpu"].num_matches).abs().max()) <= 3
    assert min(int(o.num_matches.min()) for o in out.values()) >= 10


def test_grid_keys_at_cell_faces_card_match_cpu(cuda):
    """The card's cells divide by the cell size as the CPU does (a 0-dim
    tensor on the card), so points on cell faces get the CPU's keys."""
    from pctpu_torch.ops import grid_hash as G
    p = faces_cloud()
    g_cpu = G.build_grid(torch.from_numpy(p), cell_size=0.1)
    g_card = G.build_grid(_t(p, cuda), cell_size=0.1)
    for name in G.HashGrid._fields:
        assert torch.equal(getattr(g_card, name).cpu(),
                           getattr(g_cpu, name)), name
    # dividing by a Python float would multiply by its reciprocal there
    recip = torch.floor((_t(p, cuda) - g_card.origin) / 0.1).int()
    exact = G._cells(_t(p, cuda), g_card.origin, g_card.cell_size)
    assert not torch.equal(recip, exact)


def test_grid_nearest_card_matches_cpu(gen, cuda):
    """grid_nearest, grid_knn and grid_radius: every output equal to the
    CPU's, with ties, a mask, overflow and a far query."""
    from pctpu_torch.ops import grid_hash as G
    p = gen.uniform(0, 10, (20000, 3)).astype(np.float32)
    p[-500:] = p[:500]
    m = gen.uniform(size=len(p)) > 0.05
    q = np.concatenate([gen.uniform(0, 10, (3000, 3)), p[:100],
                        [[50.0, 50.0, 50.0]]]).astype(np.float32)
    g_cpu = G.build_grid(torch.from_numpy(p), torch.from_numpy(m), 0.5)
    g_card = G.build_grid(_t(p, cuda), _t(m, cuda), 0.5)
    qc, qd = torch.from_numpy(q), _t(q, cuda)
    pairs = [(G.grid_nearest(g_card, qd, 8, 1000),
              G.grid_nearest(g_cpu, qc, 8, 1000)),
             (G.grid_knn(g_card, qd, 5, 8, 1000),
              G.grid_knn(g_cpu, qc, 5, 8, 1000)),
             (G.grid_radius(g_card, qd, 0.5, 16, 8, 1000),
              G.grid_radius(g_cpu, qc, 0.5, 16, 8, 1000))]
    for card, cpu in pairs:
        for a, b in zip(card, cpu):
            assert torch.equal(a.cpu(), b)
    assert not bool(pairs[0][0][2][-1])


def test_dp_train_step_nccl_world_of_one_matches_train_step(cuda):
    """The data-parallel `cls-ssg` step over an NCCL world of one rank on
    the card (kernels 11, 12 and 14 in its forward and backward) equals
    the one-process `make_train_step` on the same batch, at the bounds of
    `tests/test_torch_dp_train.py` (`torch_ranks.dp_mismatches`) with the
    card's float32 floor (gradients 1e-2 of a norm, the loss 1e-5
    relative), for a first step with an injected keep-mask and one with
    the generator's."""
    import torch_ranks
    from pctpu_torch.nn import train as T
    from pctpu_torch.nn.config import TrainConfig
    from pctpu_torch.parallel.launch import run_world
    cfg = dict(model="cls-ssg", num_classes=10, num_points=512, batch_size=8)
    model = T.build_model(TrainConfig(**cfg), device=cuda)
    rng = np.random.default_rng(16)
    pc = rng.normal(size=(8, 512, 6)).astype(np.float32)
    pc[..., :3] /= np.abs(pc[..., :3]).max()
    inp = dict(cfg=cfg, pc=pc, labels=rng.integers(0, 10, 8),
               mask=rng.uniform(size=(8, 256)) < 0.5, seed=11, device="cuda",
               state={k: v.cpu().numpy() for k, v in
                      model.state_dict().items()})
    world = run_world(torch_ranks.dp_train_checks, 1, "nccl", cuda, inp,
                      timeout=300)
    one = torch_ranks.one_process_steps(inp)
    for how in ("mask", "generator"):
        assert torch_ranks.dp_mismatches(world[how], one[how], one["names"],
                                         grad_tol=1e-2, loss_rtol=1e-5) == [], \
            how


@pytest.mark.parametrize("case", RANSAC_CASES)
@pytest.mark.parametrize("h", [1, 1024])
@pytest.mark.parametrize("m", [3, 512, 700])
@pytest.mark.parametrize("b", [1, 16, 64])
def test_ransac_refine_kernel_matches_plain(cuda, b, m, h, case):
    """RANSAC's select-and-refine kernel against `_select_refine_plain` on
    the same CUDA tensors (`tests/ransac_cases.py`: zero inliers, the
    fallback's identity and rank-2 branches, the Newton flip, tied
    scores): R within 1e-5 a term and t within 1e-4 m (the kernel's sums
    run in another order than PyTorch's and cuBLAS's); with tied scores,
    R nearest the refit of the first tied row (torch.argmax's); the inlier
    mask equal wherever no residual lies within 1e-4 m of the threshold;
    counts and fitness from the mask; one launch a call; a second run
    equal bit for bit."""
    rng = np.random.default_rng([b, m, h, RANSAC_CASES.index(case)])
    *arrays, thresh2 = refine_inputs(rng, b, h, m, case)
    x = [_t(a, cuda) for a in arrays]
    before = ransac.ransac_refine.launches
    out = ransac.ransac_refine(*x, thresh2)
    torch.cuda.synchronize()
    assert ransac.ransac_refine.launches == before + 1
    again = ransac._launch_refine(*x, thresh2)
    torch.cuda.synchronize()
    assert ransac.ransac_refine.launches == before + 2
    assert all(torch.equal(u, v) for u, v in zip(out, again))
    plain = ransac._select_refine_plain(*x, thresh2)
    dR = (out.T[:, :3, :3] - plain.T[:, :3, :3]).abs().max()
    dt = (out.T[:, :3, 3] - plain.T[:, :3, 3]).abs().max()
    assert float(dR) <= 1e-5 and float(dt) <= 1e-4, (float(dR), float(dt))
    assert torch.equal(out.T[:, 3], plain.T[:, 3])
    sure = torch.from_numpy(~unsure_rows(
        [out.T.cpu().numpy(), plain.T.cpu().numpy()], arrays[2], arrays[3],
        RANSAC_DIST)).to(cuda)
    assert torch.equal(out.inlier_mask[sure], plain.inlier_mask[sure])
    assert torch.equal(out.inliers, out.inlier_mask.sum(1, dtype=torch.int32))
    assert torch.equal(out.fitness, out.inliers / x[5])
    if case in ("zero", "collinear"):
        assert torch.equal(out.T[:, :3, :3],
                           torch.eye(3, device=cuda).expand(b, 3, 3))
    if case == "ties" and h > 1:
        scores = arrays[0]
        tied = np.stack([np.flatnonzero(r == r.max()) for r in scores])
        ar = torch.arange(b, device=cuda)
        d = torch.stack([
            (out.T[:, :3, :3] - weighted_procrustes(
                x[2], x[3], x[1][ar, _t(rows, cuda)].float())[0])
            .abs().amax((1, 2)) for rows in tied.T], dim=1)
        assert (tied[:, 0] > 0).all()
        assert torch.equal(d[:, 0], d.min(1).values), d


def test_ransac_batch_on_cuda_launches_the_refine_kernel(cuda, monkeypatch):
    """`ransac_registration_batch(refine=True)` on CUDA tensors launches
    the kernel once and never the plain chain; `refine=False` launches
    nothing of it and keeps the best hypothesis' own pose."""
    def refuse(*args):
        raise AssertionError("plain chain called on CUDA tensors")
    monkeypatch.setattr(ransac, "_select_refine_plain", refuse)
    rng = np.random.default_rng(20)
    src = rng.uniform(-20, 20, (2, 300, 3)).astype(np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    dst = src @ R.T + np.array([1.0, 2.0, 0.5], np.float32)
    valid = torch.ones((2, 300), dtype=torch.bool, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(0)
    before = ransac.ransac_refine.launches
    out = ransac.ransac_registration_batch(
        _t(src, cuda), _t(dst, cuda), valid, ransac.generator_sampler(gen),
        dist_thresh=0.5, num_hypotheses=256, m_cap=200)
    torch.cuda.synchronize()
    assert ransac.ransac_refine.launches == before + 1
    assert out.inlier_mask.shape == (2, 200)
    np.testing.assert_allclose(out.T[:, :3, :3].cpu().numpy(),
                               np.stack([R, R]), atol=1e-5)
    ransac.ransac_registration_batch(
        _t(src, cuda), _t(dst, cuda), valid, ransac.generator_sampler(gen),
        dist_thresh=0.5, num_hypotheses=256, refine=False)
    assert ransac.ransac_refine.launches == before + 1


def test_ransac_refine_rejects_mixed_devices_and_strides(cuda):
    rng = np.random.default_rng(21)
    x = [_t(a, cuda) for a in refine_inputs(rng, 2, 8, 16, "random")[:6]]
    th = float(np.float32(RANSAC_DIST)) ** 2
    with pytest.raises(ValueError, match="CUDA device"):
        ransac.ransac_refine(*x[:5], x[5].cpu(), th)
    strided = x[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ransac.ransac_refine(x[0], x[1], strided, *x[3:], th)


@pytest.fixture(scope="module")
def hdl64():
    """One whole synthetic HDL-64E scan, 124,668 points."""
    return hdl64_scan(124_668)


@pytest.mark.parametrize("case", VOXEL_CASES)
def test_voxel_run_means_kernel_equals_in_order_sums(cuda, hdl64, case):
    """Kernel V on `voxel_downsample`'s own inputs: every centroid equal
    bit for bit to a host float64 sum of its run in ascending row order,
    divided and rounded once; a second launch gives the same bits and
    zeros past the voxels; one launch counted; the plain version on the
    same CUDA tensors within `plain_gap_ok` (one float32 ulp; near 0 its
    prefixes' float64 rounding), the share of rows that differ printed."""
    pts, mask, leaf = case_cloud(case, hdl64)
    before = voxel.voxel_run_means.launches
    down, args = recorded_runs(pts, mask, leaf, cuda)
    torch.cuda.synchronize()
    assert voxel.voxel_run_means.launches == before + 1
    nv = int(args[4])
    assert nv == int(down.mask.sum()) > 0
    got = down.points[:nv].cpu().numpy()
    np.testing.assert_array_equal(got, in_order_means(*args))
    assert torch.equal(down.points[nv:],
                       down.points[:1].expand(len(pts) - nv, 3))
    again = voxel._launch_run_means(*args)
    assert torch.equal(again[:nv], down.points[:nv])
    assert bool((again[nv:] == 0).all())
    plain = voxel._run_means_plain(*args[:4])[:nv].cpu().numpy()
    differ = float((plain != got).any(1).mean())
    print(f"{case}: {len(pts)} points, {nv} voxels, {differ:.3%} of rows "
          "differ from the plain version")
    assert plain_gap_ok(plain, got, args[0], args[1])


def test_voxel_run_means_kernel_on_a_masked_out_cloud(cuda):
    pts = np.random.default_rng(2).uniform(-5, 5, (300, 3)).astype(np.float32)
    down, args = recorded_runs(pts, np.zeros(300, bool), 1.0, cuda)
    assert int(args[4]) == 0 and not bool(down.mask.any())
    assert torch.equal(down.points.cpu(), torch.zeros(300, 3))


def test_register_pair_launches_voxel_run_means_twice(cuda, hdl64,
                                                      monkeypatch):
    """One `register_pair` call on CUDA tensors launches kernel V once a
    cloud and never takes the plain version."""
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.register import pipeline

    def refuse(*args):
        raise AssertionError("plain version called on CUDA tensors")
    monkeypatch.setattr(voxel, "_run_means_plain", refuse)
    src = hdl64[np.random.default_rng(4).choice(len(hdl64), 16_384,
                                                replace=False)]
    c, s = np.cos(0.3), np.sin(0.3)
    dst = (src @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]], np.float32)
           + np.array([1.0, -0.5, 0.2], np.float32))
    mask = torch.ones(len(src), dtype=torch.bool, device=cuda)
    before = voxel.voxel_run_means.launches
    out = pipeline.register_pair(
        PointCloud(_t(src, cuda), mask), PointCloud(_t(dst, cuda), mask),
        generator=torch.Generator(device=cuda).manual_seed(0), device=cuda)
    torch.cuda.synchronize()
    assert voxel.voxel_run_means.launches == before + 2
    assert bool(torch.isfinite(out.T).all())


def test_voxel_run_means_rejects_bad_inputs(cuda):
    pts = np.random.default_rng(3).uniform(-5, 5, (500, 3)).astype(np.float32)
    _, args = recorded_runs(pts, np.ones(500, bool), 1.0, cuda)
    ps, ms, new_run, s_v, nv = args
    with pytest.raises(ValueError, match="CUDA device"):
        voxel.voxel_run_means(ps, ms.cpu(), new_run, s_v, nv)
    with pytest.raises(ValueError, match="dtype"):
        voxel.voxel_run_means(ps, ms, new_run, s_v.int(), nv)
    with pytest.raises(ValueError, match="contiguous"):
        voxel.voxel_run_means(ps.t().contiguous().t(), ms, new_run, s_v, nv)
    with pytest.raises(ValueError, match="shapes"):
        voxel.voxel_run_means(ps[:, :2].contiguous(), ms, new_run, s_v, nv)


# ---------------------------------------------------------------------------
# the single pair's FPFH replayed from a CUDA graph
# ---------------------------------------------------------------------------

@pytest.fixture
def fpfh_graphs():
    """`features/fpfh.py` with no key seen and no graph held, before and
    after the test."""
    from pctpu_torch.features import fpfh as fpfh_mod
    fpfh_mod._SEEN.clear()
    fpfh_mod._GRAPHS.clear()
    yield fpfh_mod
    fpfh_mod._SEEN.clear()
    fpfh_mod._GRAPHS.clear()


def _fpfh_key_inputs(key, hdl64, dev, seed=0):
    """(points, mask, normals, kwargs) of one `fpfh` key: "hdl64_cap" is a
    moved copy of the scan voxelised and capped as `register_pair` does
    (2,048 points, `RegistrationConfig()`'s radius, caps and k), "small"
    600 masked points of the scan with their normals given."""
    from pctpu_torch.ops.normals import estimate_normals
    from pctpu_torch.register import pipeline
    rng = np.random.default_rng(seed)
    c, s = np.cos(0.3 * seed), np.sin(0.3 * seed)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    pts = (hdl64 @ R.T + rng.normal(scale=0.01, size=hdl64.shape)
           ).astype(np.float32)
    if key == "hdl64_cap":
        cfg = pipeline.RegistrationConfig()
        down = voxel.voxel_downsample(_t(pts, dev),
                                      torch.ones(len(pts), dtype=torch.bool,
                                                 device=dev), cfg.voxel_size)
        down, _ = pipeline._cap_uniform(down, cfg.downsample_capacity)
        return down.points, down.mask, None, dict(
            radius=cfg.feature_radius, k_cap=cfg.feature_k_cap,
            normal_k=cfg.normal_k)
    sub = _t(pts[rng.choice(len(pts), 600, replace=False)], dev)
    mask = _t(rng.uniform(size=600) > 0.1, dev)
    nrm = estimate_normals(sub, mask=mask, k=12)
    return sub, mask, nrm, dict(radius=3.0, k_cap=40, normal_k=12)


def _fpfh_eager(fpfh_mod, pts, mask, nrm, kw):
    return fpfh_mod._fpfh_body(pts, mask, nrm, kw["radius"], kw["k_cap"],
                               kw["normal_k"])


@pytest.mark.parametrize("key", ["hdl64_cap", "small"])
def test_fpfh_replay_equals_eager_bit_for_bit(cuda, hdl64, fpfh_graphs, key):
    """Every call at one key (eager, the capture's warm-up, replays) gives
    the eager body's bits, on fresh clouds after the capture too."""
    f = fpfh_graphs
    for seed in range(4):
        pts, mask, nrm, kw = _fpfh_key_inputs(key, hdl64, cuda, seed)
        got = f.fpfh(pts, mask, nrm, **kw)
        assert torch.equal(got, _fpfh_eager(f, pts, mask, nrm, kw)), seed
    assert len(f._GRAPHS) == 1


def test_fpfh_source_survives_the_targets_replay(cuda, hdl64, fpfh_graphs):
    """`register_pair`'s order: the source's descriptors, then the
    target's at the same key; the source's are unchanged by the target's
    replay."""
    f = fpfh_graphs
    clouds = [_fpfh_key_inputs("hdl64_cap", hdl64, cuda, s) for s in (1, 2)]
    for _ in range(2):                         # the first sighting, capture
        for pts, mask, _, kw in clouds:
            f.fpfh(pts, mask, **kw)
    replays = f.fpfh_graph.replays
    src = f.fpfh(clouds[0][0], clouds[0][1], **clouds[0][3])
    kept = src.clone()
    dst = f.fpfh(clouds[1][0], clouds[1][1], **clouds[1][3])
    assert f.fpfh_graph.replays == replays + 2
    assert torch.equal(src, kept) and not torch.equal(src, dst)
    assert torch.equal(src, _fpfh_eager(f, clouds[0][0], clouds[0][1], None,
                                        clouds[0][3]))


def test_fpfh_graph_counters_by_call(cuda, hdl64, fpfh_graphs):
    """0 captures at a key's first call, 1 at its second, then one replay
    a call and no more captures."""
    f = fpfh_graphs
    pts, mask, nrm, kw = _fpfh_key_inputs("hdl64_cap", hdl64, cuda)
    c0, r0 = f.fpfh_graph.captures, f.fpfh_graph.replays
    seen = []
    for _ in range(5):
        f.fpfh(pts, mask, nrm, **kw)
        seen.append((f.fpfh_graph.captures - c0, f.fpfh_graph.replays - r0))
    assert seen == [(0, 0), (1, 0), (1, 1), (1, 2), (1, 3)], seen


def test_fpfh_graph_second_key_captures_its_own(cuda, hdl64, fpfh_graphs):
    """Two keys interleaved: each captures its own graph at its second
    call and replays its own bits."""
    f = fpfh_graphs
    keys = [_fpfh_key_inputs(k, hdl64, cuda) for k in ("hdl64_cap", "small")]
    c0 = f.fpfh_graph.captures
    for _ in range(3):
        for pts, mask, nrm, kw in keys:
            got = f.fpfh(pts, mask, nrm, **kw)
            assert torch.equal(got, _fpfh_eager(f, pts, mask, nrm, kw))
    assert f.fpfh_graph.captures == c0 + 2 and len(f._GRAPHS) == 2


def test_fpfh_graph_keeps_the_latest_keys(cuda, hdl64, fpfh_graphs):
    """One more key than the bound drops the least recently used graph;
    that key then starts over from its first sighting."""
    f = fpfh_graphs
    pts, mask, nrm, kw = _fpfh_key_inputs("small", hdl64, cuda)
    radii = [2.0 + 0.5 * i for i in range(f._MAX_GRAPHS + 1)]
    for r in radii:
        for _ in range(2):
            f.fpfh(pts, mask, nrm, **dict(kw, radius=r))
    assert len(f._GRAPHS) == f._MAX_GRAPHS
    c0, r0 = f.fpfh_graph.captures, f.fpfh_graph.replays
    f.fpfh(pts, mask, nrm, **dict(kw, radius=radii[1]))
    assert f.fpfh_graph.replays == r0 + 1
    f.fpfh(pts, mask, nrm, **dict(kw, radius=radii[0]))
    assert (f.fpfh_graph.captures, f.fpfh_graph.replays) == (c0, r0 + 1)
    assert len(f._SEEN) == 1
