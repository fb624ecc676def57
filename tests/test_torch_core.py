"""Parity of the PyTorch port's core and plain ops with the JAX package
(`pctpu_torch.core`, `ops.gather`, `ops.pairwise`, `ops.eigh3`,
`ops.voxel`), plus the port's device and import rules. Inputs come from
numpy with a seed and go through both packages on the CPU."""
import torch_threads as _torch_threads  # noqa: F401

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from pctpu.core import se3 as jse3
from pctpu.core.cloud import PointCloud as JCloud
from pctpu.ops.eigh3 import eigh3 as jeigh3
from pctpu.ops.gather import _flat_row_gather as j_gather
from pctpu.ops.pairwise import chunked_min_argmin as j_chunked
from pctpu.ops.voxel import voxel_downsample_capped as j_voxel
from pctpu_torch import device as tdevice
from pctpu_torch.core import se3 as tse3
from pctpu_torch.core.cloud import PointCloud, pad_cloud, round_up
from pctpu_torch.ops.eigh3 import eigh3 as teigh3
from pctpu_torch.ops.gather import _flat_row_gather as t_gather
from pctpu_torch.ops.pairwise import chunked_min_argmin as t_chunked
from pctpu_torch.ops.voxel import voxel_downsample_capped as t_voxel

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pctpu"}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _transforms(rng, b):
    T = np.tile(np.eye(4, dtype=np.float32), (b, 1, 1))
    T[:, :3, :3] = Rotation.from_rotvec(
        rng.normal(scale=0.8, size=(b, 3))).as_matrix()
    T[:, :3, 3] = rng.normal(scale=5.0, size=(b, 3))
    return T


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_no_jax_or_pctpu():
    """Static import rule: no module of the port (nor chip_smoke.py)
    imports JAX, flax or the JAX package. (A sys.modules check cannot
    work: the test process imports JAX already.)"""
    files = sorted((REPO / "pctpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    names = {str(f.relative_to(REPO)) for f in files}
    for module in ("core/io.py", "ops/normals.py", "ops/knn.py",
                   "ops/pallas_banded.py", "features/fpfh.py",
                   "parallel/pair_sweep.py", "register/evaluate.py",
                   "register/icp.py", "register/pipeline.py",
                   "ops/fps.py", "ops/pallas_fps.py", "ops/ball_query.py",
                   "ops/pallas_ballgroup.py", "models/pointnet2.py",
                   "models/convert.py", "nn/config.py", "nn/train.py",
                   "nn/data.py", "nn/fit.py", "entry.py",
                   "ops/pallas_gather.py", "nn/augment.py",
                   "nn/checkpoint.py", "nn/train_cli.py",
                   "parallel/posegraph.py", "pipelines/odometry.py",
                   "pipelines/registration_driver.py",
                   "register/template_api.py", "cluster/__init__.py",
                   "cluster/plane_ransac.py", "cluster/dbscan.py",
                   "cluster/kmeans.py", "cluster/gmm.py", "cluster/spectral.py",
                   "pipelines/segmentation.py", "pipelines/cluster_compare.py",
                   "pipelines/kitti_frames.py", "pipelines/kitti_eval.py",
                   "pipelines/analytics.py", "pipelines/trainset.py",
                   "pipelines/kitti_etl.py", "pipelines/detect.py",
                   "pipelines/miniworld.py", "features/__init__.py",
                   "features/nms.py", "features/iss.py",
                   "features/harris.py", "features/sift3d.py",
                   "features/shot.py", "features/fpfh_dense.py",
                   "features/margins.py", "ops/__init__.py", "ops/box3d.py",
                   "models/pointrcnn.py"):
        assert f"pctpu_torch/{module}" in names, module
    bad = [(str(f.relative_to(REPO)), mod) for f in files
           for mod in _imports(f) if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_raise_without_cuda(monkeypatch):
    """No silent CPU fallback: without a card and without device='cpu'
    an entry point raises."""
    from pctpu_torch.parallel import posegraph
    from pctpu_torch.parallel.pair_sweep import batched_icp_mega
    from pctpu_torch.pipelines import odometry, registration_driver
    from pctpu_torch.register import icp, template_api
    from pctpu_torch.register.pipeline import register_pair, register_pairs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts = np.zeros((5, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pad_cloud(pts)
    cloud = pad_cloud(pts, device="cpu")
    batch = PointCloud(cloud.points[None], cloud.mask[None])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_pairs(batch, batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        register_pair(cloud, cloud)
    m = cloud.mask
    for loop in (icp.icp_fixed_iters_banded_mega, icp.icp_fixed_iters_banded,
                 icp.icp_fixed_iters_banded_fused,
                 icp.icp_fixed_iters_banded_fused_v2, icp.icp_fixed_iters):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop(cloud.points, m, cloud.points, m)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batched_icp_mega(batch.points, batch.mask, batch.points, batch.mask)
    p = cloud.points
    for loop in (icp.icp_fixed_iters_p2pl, icp.icp_point_to_plane):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            loop(p, m, p, p, m)
    poses = torch.eye(4).expand(2, 4, 4)
    for solver in (posegraph.optimize_pose_graph,
                   posegraph.optimize_pose_graph_sparse,
                   posegraph.optimize_pose_graph_sparse_f64):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            solver(poses, [0], [1], poses[:1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        odometry.run_odometry([pts, pts])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        registration_driver.run_registration_dataset("d", "p", "o")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        template_api.find_associations(pts.T, pts.T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu").type == "cpu"


def test_precision_check_raises_on_tf32():
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    old = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="highest"):
            tdevice.resolve_device("cpu")
    finally:
        torch.set_float32_matmul_precision(old)
    tdevice.resolve_device("cpu")


def test_pad_cloud_matches_jax(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    feats = rng.normal(size=(300, 5)).astype(np.float32)
    ours = PointCloud.from_numpy(pts, features=feats, tile=128, device="cpu")
    ref = JCloud.from_numpy(pts, features=feats, tile=128)
    assert ours.capacity == ref.capacity == round_up(300, 128)
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(ours.features.numpy(),
                                  np.asarray(ref.features))
    assert int(ours.count()) == 300


@pytest.mark.parametrize("fn", ["make_transform", "apply_transform",
                                "invert_transform", "transform_to_tq",
                                "pose_diff_rte_rre", "rotation_angle_deg"])
def test_se3_matches_jax(rng, fn):
    """Each SE(3) helper == its JAX counterpart within 1e-5 (f32 math;
    RRE in degrees within 1e-3)."""
    T = _transforms(rng, 6)
    T2 = _transforms(rng, 6)
    pts = rng.normal(scale=20.0, size=(6, 50, 3)).astype(np.float32)
    args = {
        "make_transform": (T[:, :3, :3], T[:, :3, 3]),
        "apply_transform": (T, pts),
        "invert_transform": (T,),
        "transform_to_tq": (T,),
        "pose_diff_rte_rre": (T, T2),
        "rotation_angle_deg": (T[:, :3, :3],),
    }[fn]
    ours = getattr(tse3, fn)(*map(_t, args))
    ref = getattr(jse3, fn)(*map(jnp.asarray, args))
    if not isinstance(ours, tuple):
        ours, ref = (ours,), (ref,)
    tol = 1e-3 if fn in ("pose_diff_rte_rre", "rotation_angle_deg") else 1e-5
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=tol)


def test_flat_row_gather_matches_jax(rng):
    pts = rng.normal(size=(3, 40, 4)).astype(np.float32)
    idx = rng.integers(-5, 45, size=(3, 17)).astype(np.int32)  # clipped
    np.testing.assert_array_equal(t_gather(_t(pts), _t(idx)).numpy(),
                                  np.asarray(j_gather(jnp.asarray(pts),
                                                      jnp.asarray(idx))))


def test_chunked_min_argmin_matches_jax(rng):
    """The plain brute 1-NN (a^2+b^2-2ab): idx equal, d2 within 5e-4 —
    a few f32 ulps of |a|^2 + |b|^2 (~1.2e-4 each at |p| ~ 20 m), where
    the two libraries' matmuls sum in different orders."""
    q = rng.uniform(-20, 20, (300, 3)).astype(np.float32)
    db = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    mask = rng.uniform(size=500) > 0.2
    d_o, i_o = t_chunked(_t(q), _t(db), _t(mask), query_chunk=128)
    d_r, i_r = j_chunked(jnp.asarray(q), jnp.asarray(db), jnp.asarray(mask),
                         query_chunk=128)
    np.testing.assert_array_equal(i_o.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(d_o.numpy(), np.asarray(d_r), atol=5e-4)


def test_eigh3_matches_jax(rng):
    """Closed-form eigensystem on well-separated spectra: eigenvalues
    within 1e-4 relative, eigenvectors equal up to sign within 1e-4."""
    Q = Rotation.from_rotvec(rng.normal(size=(64, 3))).as_matrix()
    w = np.sort(rng.uniform(0.1, 10.0, (64, 3)), axis=1)
    w[:, 1] += 1.0
    w[:, 2] += 2.0
    A = (Q * w[:, None, :]) @ np.swapaxes(Q, 1, 2)
    A = A.astype(np.float32)
    wo, Vo = teigh3(_t(A))
    wr, Vr = jeigh3(jnp.asarray(A))
    np.testing.assert_allclose(wo.numpy(), np.asarray(wr), rtol=1e-4,
                               atol=1e-4)
    dots = np.abs(np.sum(Vo.numpy() * np.asarray(Vr), axis=1))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)


def _eigh3_host_axes(A, degeneracy_eps=1e-20):
    """`eigh3` as it was with its unit axes made from host lists (one
    host-to-device copy each), kept to hold the device-built axes to."""
    from pctpu_torch.ops.eigh3 import _cross, _eigvec_for, eigvalsh3
    w = eigvalsh3(A)
    v0, n0 = _eigvec_for(A, w[..., 0])
    v2, n2 = _eigvec_for(A, w[..., 2])
    scale = torch.clamp_min(torch.amax(torch.abs(w), dim=-1), 1.0) ** 4
    ok0 = n0 > degeneracy_eps * scale
    ok2 = n2 > degeneracy_eps * scale

    def axis(vals):
        return torch.tensor(vals, dtype=A.dtype,
                            device=A.device).expand(v0.shape)

    ex, ey, ez = axis([1.0, 0.0, 0.0]), axis([0.0, 1.0, 0.0]), \
        axis([0.0, 0.0, 1.0])
    v0 = torch.where(ok0[..., None], v0, ex)
    v0 = v0 / torch.linalg.vector_norm(v0, dim=-1, keepdim=True)
    v2 = torch.where(ok2[..., None], v2, ez)
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    norm2 = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    alt = _cross(v0, torch.where(torch.abs(v0[..., :1]) < 0.9, ex, ez + ey))
    alt = alt / torch.linalg.vector_norm(alt, dim=-1, keepdim=True)
    v2 = torch.where(norm2 > 1e-12, v2 / torch.clamp_min(norm2, 1e-30), alt)
    v1 = _cross(v2, v0)
    return w, torch.stack([v0, v1, v2], dim=-1)


def _eigh3_batch(rng, case, dtype):
    """[64,3,3] symmetric matrices: random spectra; degenerate ones (zero,
    multiples of I, two equal eigenvalues, exact diagonals); or rank 1 and
    2 (outer products, planar and collinear neighbourhoods)."""
    Q = Rotation.from_rotvec(rng.normal(size=(64, 3))).as_matrix()
    if case == "random":
        A = rng.normal(size=(64, 3, 3))
        A = A + np.swapaxes(A, 1, 2)
    elif case == "degenerate":
        w = np.repeat(rng.uniform(0.5, 5.0, (64, 1)), 3, axis=1)
        w[16:32, 2] += 1.0                     # two equal eigenvalues
        w[32:40] = 0.0                         # the zero matrix
        A = (Q * w[:, None, :]) @ np.swapaxes(Q, 1, 2)
        A[:16] = w[:16, :1, None] * np.eye(3)  # exact multiples of I
        A[40:48] = np.eye(3) * rng.uniform(0.1, 3.0, (8, 1, 3))
    else:
        v = rng.normal(size=(64, 3, 2))
        v[:32, :, 1] = 0.0                     # rank 1
        A = v @ np.swapaxes(v, 1, 2)           # rank 2
        A[48:] = np.eye(3) * np.array([0.0, 0.0, 1.0])
    return torch.from_numpy(A.astype(dtype))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("case", ["random", "degenerate", "rank_deficient"])
def test_eigh3_device_axes_equal_host_list_axes(rng, case, dtype):
    """`eigh3`'s unit axes, rows of an identity built on the device, give
    the same bits as the former axes copied from host lists."""
    A = _eigh3_batch(rng, case, dtype)
    w, V = teigh3(A)
    w_h, V_h = _eigh3_host_axes(A)
    torch.testing.assert_close(w, w_h, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(V, V_h, rtol=0, atol=0, equal_nan=True)


def test_voxel_downsample_capped_matches_jax(rng):
    """Voxel centroids: masks and counts equal, points within 1e-4 m, for
    a binding cap (uniform stride) and a loose one. The cell-relative
    cumsums differ only in rounding order between the two libraries."""
    b, n, leaf = 2, 1024, 1.0
    pts = rng.uniform(-6, 6, (b, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(b, n)) > 0.1
    for cap in (128, 512):
        ours, nv_o = t_voxel(_t(pts), _t(mask), leaf, cap)
        ref, nv_r = j_voxel(jnp.asarray(pts), jnp.asarray(mask), leaf, cap)
        np.testing.assert_array_equal(nv_o.numpy(), np.asarray(nv_r))
        np.testing.assert_array_equal(ours.mask.numpy(),
                                      np.asarray(ref.mask))
        np.testing.assert_allclose(ours.points.numpy(),
                                   np.asarray(ref.points), atol=1e-4)
