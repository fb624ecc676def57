"""The pose graph (`parallel/posegraph.py`) against the JAX package on the
CPU: `so3_log`, the per-edge residuals and `torch.func` Jacobians
(`_edge_terms`), and the dense, block-sparse and float64 Gauss-Newton
solvers on a noisy 12-pose loop with 2 closures.

Tolerances come from a float64 run of the port: on this graph the f32
poses of either package sit within 1.0e-6 of the port's float64 solve
(and of each other), the float64 poses of the two packages are equal
after rounding to f32; the tests allow 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.parallel import posegraph as jpg
from pctpu_torch.parallel import posegraph as tpg


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot(rng, n, scale):
    return Rotation.from_rotvec(rng.normal(scale=scale, size=(n, 3))
                                ).as_matrix().astype(np.float32)


@pytest.fixture(scope="module")
def loop():
    """tests/test_parallel.py:137-162: 12 poses, noisy odometry edges and
    the closures (11, 0) and (0, 6); init = the integrated odometry."""
    rng = np.random.default_rng(2)
    m = 12
    gt = [np.eye(4, dtype=np.float32)]
    for i in range(1, m):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _rot(rng, 1, 0.3)[0]
        T[:3, 3] = rng.normal(size=3)
        gt.append((gt[-1] @ T).astype(np.float32))
    gt = np.stack(gt)
    ei, ej, Tm = [], [], []
    for i, j in [(k, k + 1) for k in range(m - 1)] + [(m - 1, 0), (0, m // 2)]:
        rel = np.linalg.inv(gt[i]) @ gt[j]
        rel[:3, :3] = rel[:3, :3] @ _rot(rng, 1, 0.03)[0]
        rel[:3, 3] += rng.normal(scale=0.15, size=3)
        ei.append(i)
        ej.append(j)
        Tm.append(rel)
    Tm = np.stack(Tm).astype(np.float32)
    init = [np.eye(4, dtype=np.float32)]
    for k in range(m - 1):
        init.append((init[-1] @ Tm[k]).astype(np.float32))
    return gt, np.stack(init), np.array(ei), np.array(ej), Tm


def test_so3_log_matches_jax(rng):
    """Random rotations, the identity, and rotations below and above the
    theta = 1e-6 switch: within 2e-6 (arccos near 1 in f32)."""
    Rs = np.concatenate([_rot(rng, 6, 1.0), np.eye(3, dtype=np.float32)[None],
                         _rot(rng, 3, 1e-7), _rot(rng, 3, 1e-3)])
    ours = tpg.so3_log(torch.from_numpy(Rs)).numpy()
    for k, R in enumerate(Rs):
        np.testing.assert_allclose(ours[k], np.asarray(jpg.so3_log(
            jnp.asarray(R))), rtol=0, atol=2e-6)


@pytest.mark.parametrize("robust", [None, "geman", "huber"])
def test_edge_terms_matches_jax(loop, robust):
    """Residuals and Jacobian blocks of every edge, weights folded in:
    within 1e-5. The first edge's measurement is exactly T_0^-1 T_1, so
    its residual is the identity's, where arccos'(1) is infinite: its
    Jacobians are finite on both sides and agree."""
    _, init, ei, ej, Tm = loop
    Tm = Tm.copy()
    Tm[0] = np.linalg.inv(init[0]) @ init[1]
    Tmi = np.linalg.inv(Tm).astype(np.float32)
    w = np.linspace(0.5, 1.5, len(ei)).astype(np.float32)
    kw = {} if robust is None else dict(robust_delta=0.3,
                                        robust_kernel=robust)
    ours = tpg._edge_terms(torch.from_numpy(init), torch.from_numpy(ei),
                           torch.from_numpy(ej), torch.from_numpy(Tmi),
                           torch.from_numpy(w), **kw)
    ref = jpg._edge_terms(jnp.asarray(init), jnp.asarray(ei), jnp.asarray(ej),
                          jnp.asarray(Tmi), jnp.asarray(w), **kw)
    for a, b in zip(ours, ref):
        assert bool(torch.isfinite(a).all())
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    assert float(ours[0][0].abs().max()) < 1e-6


@pytest.mark.parametrize("solver,kw", [
    ("optimize_pose_graph", {}),
    ("optimize_pose_graph", dict(robust_delta=0.5, robust_warmup=4)),
    ("optimize_pose_graph_sparse", dict(cg_iters=200, robust_delta=0.5,
                                        robust_warmup=4)),
    ("optimize_pose_graph_sparse", dict(cg_iters=200, robust_delta=0.5,
                                        robust_kernel="huber")),
    ("optimize_pose_graph_sparse_f64", dict(cg_iters=200, robust_delta=0.5,
                                            robust_warmup=4)),
])
def test_pose_graph_solvers_match_jax(loop, solver, kw):
    """8 Gauss-Newton steps: poses within 1e-5, the final cost within
    1e-5 relative, and the loop's error below the drifted init's."""
    gt, init, ei, ej, Tm = loop
    ref = getattr(jpg, solver)(jnp.asarray(init), jnp.asarray(ei),
                               jnp.asarray(ej), jnp.asarray(Tm), iters=8,
                               **kw)
    ours = getattr(tpg, solver)(torch.from_numpy(init), ei, ej, Tm, iters=8,
                                device="cpu", **kw)
    assert ours.poses.dtype == torch.float32
    np.testing.assert_allclose(ours.poses.numpy(), np.asarray(ref.poses),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(ours.final_cost), float(ref.final_cost),
                               rtol=1e-5)

    def err(p):
        return np.abs(p[:, :3, 3] - gt[:, :3, 3]).mean()
    assert err(ours.poses.numpy()) < 0.75 * err(init)
