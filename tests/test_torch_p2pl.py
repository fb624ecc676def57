"""Point-to-plane ICP (`register/icp.py`: `_so3_exp`, `icp_point_to_plane`,
`icp_fixed_iters_p2pl`) against the JAX package on the CPU: K1's plain
version for every association. T within 1e-4.

The fixed-iteration loop is held against the reference with its 1-NN
pinned to the Pallas kernel in interpret mode (direct differences, as K1
computes): with the trim on, the kept set is cut by the rank of d2, and
the reference's CPU default (the a^2+b^2-2ab expansion, f32 error ~3e-5
m^2 at 20 m, the size of the 5 mm residuals here) would reorder
near-equal distances at the cut."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.ops.pallas_nn import nearest_pallas
from pctpu.register import icp as jicp
from pctpu_torch.ops import pallas_nn
from pctpu_torch.register import icp as ticp


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.array(x))


def _surface_pair(rng, n=900, rot=0.03, trans=0.3):
    """(src, src_mask, dst, dst_normals, dst_mask, T): dst samples the
    wavy surface z = sin(0.3 x) + cos(0.25 y) over 40 x 40 m with its
    analytic normals; src = T^-1 dst + 5 mm noise."""
    g = rng.uniform(-20, 20, (n, 2))
    dst = np.concatenate([g, np.sin(0.3 * g[:, :1])
                          + np.cos(0.25 * g[:, 1:])], axis=1)
    nrm = np.stack([-0.3 * np.cos(0.3 * g[:, 0]),
                    0.25 * np.sin(0.25 * g[:, 1]), np.ones(n)], axis=1)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    T = np.eye(4)
    T[:3, :3] = Rotation.from_rotvec(rng.normal(scale=rot, size=3)
                                     ).as_matrix()
    T[:3, 3] = rng.normal(scale=trans, size=3)
    inv = np.linalg.inv(T)
    src = dst @ inv[:3, :3].T + inv[:3, 3] + rng.normal(scale=0.005,
                                                        size=dst.shape)
    f32 = np.float32
    return (src.astype(f32), rng.uniform(size=n) > 0.05, dst.astype(f32),
            nrm.astype(f32), rng.uniform(size=n) > 0.05, T.astype(f32))


@pytest.mark.parametrize("scale", [0.0, 3e-9, 2e-8, 1e-3, 0.7, 2.5])
def test_so3_exp_matches_jax(rng, scale):
    """Rodrigues' formula on both sides of the |omega| = 1e-8 switch,
    batched against the reference's one-at-a-time function."""
    omega = (rng.normal(size=(4, 3)) * scale).astype(np.float32)
    ours = ticp._so3_exp(_t(omega)).numpy()
    for k in range(4):
        np.testing.assert_allclose(
            ours[k], np.asarray(jicp._so3_exp(jnp.asarray(omega[k]))),
            rtol=0, atol=2e-7)


def test_so3_exp_forward_jacobian_is_finite_at_zero():
    """jacfwd at omega = 0 is the hat map's, d(I + [w]x)/dw."""
    J = torch.func.jacfwd(ticp._so3_exp)(torch.zeros(3))
    assert bool(torch.isfinite(J).all())
    np.testing.assert_array_equal(J[..., 0].numpy(),
                                  [[0, 0, 0], [0, 0, -1], [0, 1, 0]])


def test_icp_point_to_plane_matches_jax(rng):
    """The while loop: T within 1e-4, the same iteration count and
    association count, rmse within 1e-5."""
    src, sm, dst, nrm, dm, T = _surface_pair(rng)
    cfg = dict(max_iters=30, dist_thresh=2.0, query_chunk=256)
    ours = ticp.icp_point_to_plane(_t(src), _t(sm), _t(dst), _t(nrm),
                                   _t(dm), cfg=ticp.ICPConfig(**cfg),
                                   device="cpu")
    ref = jicp.icp_point_to_plane(*map(jnp.asarray, (src, sm, dst, nrm, dm)),
                                  cfg=jicp.ICPConfig(**cfg))
    np.testing.assert_allclose(ours.T.numpy(), np.asarray(ref.T), atol=1e-4)
    np.testing.assert_allclose(ours.T.numpy(), T, atol=0.02)
    assert int(ours.iters) == int(ref.iters) < 30 and bool(ours.converged)
    assert int(ours.num_assoc) == int(ref.num_assoc)
    assert abs(float(ours.rmse) - float(ref.rmse)) < 1e-5


@pytest.fixture
def pallas_association(monkeypatch):
    monkeypatch.setattr(
        jicp, "nearest", lambda q, db, m, chunk, backend: nearest_pallas(
            q, db, m, query_tile=256, db_tile=512, interpret=True))


@pytest.mark.parametrize("trim", [1.0, 0.7])
def test_icp_fixed_iters_p2pl_matches_jax(rng, trim, pallas_association):
    """Fixed iterations with an init pose, with and without the trim
    (annealed on for the second half): T within 1e-4 of the reference,
    and one K1 call per iteration (plain on the CPU: no launch)."""
    src, sm, dst, nrm, dm, T = _surface_pair(rng)
    init = np.eye(4, dtype=np.float32)
    init[:3, 3] = T[:3, 3] + 0.1
    kw = dict(iters=8, dist_thresh=2.0, query_chunk=256, trim=trim)
    before = pallas_nn.nn1.launches
    ours = ticp.icp_fixed_iters_p2pl(_t(src), _t(sm), _t(dst), _t(nrm),
                                     _t(dm), _t(init), device="cpu", **kw)
    assert pallas_nn.nn1.launches == before
    ref = jicp.icp_fixed_iters_p2pl(
        *map(jnp.asarray, (src, sm, dst, nrm, dm, init)), **kw)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4)
    np.testing.assert_allclose(ours.numpy(), T, atol=0.02)


def test_icp_fixed_iters_p2pl_batched_equals_per_pair(rng):
    """Three pairs in lockstep ([B,...] in, [B,4,4] out) give each pair's
    own result (within 1e-6: the batched 6x6 solves are the same LAPACK
    calls)."""
    pairs = [_surface_pair(rng, n=600) for _ in range(3)]
    stacked = [np.stack(x) for x in zip(*pairs)]
    kw = dict(iters=6, dist_thresh=2.0, trim=0.8, device="cpu")
    batch = ticp.icp_fixed_iters_p2pl(*map(_t, stacked[:5]), **kw)
    assert batch.shape == (3, 4, 4)
    for k, p in enumerate(pairs):
        one = ticp.icp_fixed_iters_p2pl(*map(_t, p[:5]), **kw)
        np.testing.assert_allclose(batch[k].numpy(), one.numpy(), atol=1e-6)
