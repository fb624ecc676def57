"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and skips without one (the
kernels have no CPU mode). This file imports nothing of JAX, so on a
machine without JAX it runs without the repo's conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from pctpu_torch.features import pallas_fpfh
from pctpu_torch.features.fpfh_dense import normals_radius_dense
from pctpu_torch.ops import pallas_icp_mega, pallas_nn
from pctpu_torch.ops.voxel import voxel_downsample_capped
from pctpu_torch.register.icp import icp_fixed_iters_banded_mega_batch


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
    before = pallas_icp_mega.icp_mega.launches
    kern = icp_fixed_iters_banded_mega_batch(*args, **kw)
    torch.cuda.synchronize()
    assert pallas_icp_mega.icp_mega.launches == before + 2
    plain = icp_fixed_iters_banded_mega_batch(*[a.cpu() for a in args], **kw)
    torch.testing.assert_close(kern.cpu(), plain, rtol=0, atol=1e-4)
