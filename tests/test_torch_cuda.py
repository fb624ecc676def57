"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode); all carry the `cuda` marker. This file imports
nothing of JAX, so on a machine without JAX it runs without the repo's
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pctpu_torch.features import pallas_fpfh
from pctpu_torch.features.fpfh_dense import normals_radius_dense
from pctpu_torch.ops import (pallas_ballgroup, pallas_banded, pallas_fps,
                             pallas_gather, pallas_icp_mega, pallas_nn)
from pctpu_torch.ops.ball_query import ball_query
from pctpu_torch.ops.gather import group_points
from pctpu_torch.ops.voxel import voxel_downsample_capped
from pctpu_torch.register import icp
from pctpu_torch.register.icp import icp_fixed_iters_banded_mega_batch

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


def _fpfh_inputs(gen, dev, b=2, n=4096, cap=1024, leaf=1.0, radius=5.0):
    g = gen.uniform(-20, 20, (b, n, 2))
    pts = np.concatenate([g, (0.1 * g[..., :1] + gen.normal(
        scale=0.3, size=(b, n, 1)))], axis=-1).astype(np.float32)
    down, _ = voxel_downsample_capped(_t(pts, dev),
                                      torch.ones((b, n), dtype=torch.bool,
                                                 device=dev), leaf, cap)
    nrm = normals_radius_dense(down.points, down.mask, radius=2.0)
    amat, dbmat, valid = pallas_fpfh._pack(down.points, down.mask, nrm, cap)
    base, nt = pallas_fpfh._band_tables(amat[..., 0].contiguous(), valid,
                                        radius, 256, 512, slack=leaf)
    return amat, dbmat, base, nt, radius * radius


def test_spfh_wsum_kernels_match_plain(gen, cuda):
    """K2: neighbour counts equal; histograms within the bin-boundary
    bound (flip fraction < 2e-3, mean |diff| < 0.02, max < 15). K3: the
    same bound on the weighted sums."""
    amat, dbmat, base, nt, r2 = _fpfh_inputs(gen, cuda)
    hk, ck = pallas_fpfh.spfh(amat, dbmat, base, nt, 256, 512, r2)
    hp, cp = pallas_fpfh.spfh_plain(amat, dbmat, base, nt, 256, 512, r2)
    torch.cuda.synchronize()
    assert torch.equal(ck, cp)
    wk = pallas_fpfh.wsum(amat, dbmat, base, nt, hp, 256, 512, r2)
    wp = pallas_fpfh.wsum_plain(amat, dbmat, base, nt, hp, 256, 512, r2)
    for k, p in ((hk, hp), (wk, wp)):
        diff = (k - p).abs()
        assert float((diff > 0.5).float().mean()) < 2e-3
        assert float(diff.mean()) < 0.02 and float(diff.max()) < 15.0


def test_spfh_kernel_needs_its_tiles(gen, cuda):
    amat, dbmat, _, _, r2 = _fpfh_inputs(gen, cuda)
    tiles = torch.zeros((amat.shape[0], amat.shape[1] // 128),
                        dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="q_tile"):
        pallas_fpfh.spfh(amat, dbmat, tiles, tiles, 128, 512, r2)


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
