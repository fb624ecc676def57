"""The port's distribution (`pctpu_torch.parallel`: meshes, the halo 1-NN,
the point-sharded ICP, the pair and full-pipeline sweeps, the sharded
pose-graph steps; `entry.dryrun_multichip`) in one gloo world of 4 CPU
ranks, against the JAX package's functions on a 4-device mesh
(`jax.devices()[:4]`: the sparse step's damping and matvec scale with the
axis size, so both sides run at W = 4) and against the port's one-process
functions, on the same numpy inputs.

The ranks run `tests/torch_ranks.py:parallel_checks` once for the module
(`world` fixture); each test reads its part. Tolerances, from the
reference's own agreement between its sharded and one-device functions on
8 devices (`MULTICHIP_r05.json`: point-sharded ICP 2.21e-6, sparse pose
graph 1.67e-6, full pipeline 4.77e-7, dense pose graph and pair sweep 0):

  * halo 1-NN: d2 and index equal to the port's `nearest` over the whole
    database for every query whose true neighbour lies within the slab or
    the halo; against the reference's halo the same index wherever its
    two nearest d2 differ by more than 1e-3, and d2 within 2e-2 (the
    reference's a^2 + b^2 - 2ab expansion at coordinate scale 100,
    `tests/test_parallel.py`, `__graft_entry__.py:80-83`);
  * point-sharded ICP, dense and sparse pose-graph steps: max |d| <= 1e-5
    against the reference and against the port's one-process solver
    (`icp_fixed_iters`, `optimize_pose_graph` / `_sparse` at one
    iteration), padded edges included (measured 1.5e-6, 1.4e-6; 2.7e-7,
    1.2e-7; 9.1e-6, 3.8e-6). The sparse step's float32 CG sets its own
    floor: on the test's 16-pose graph the reference's sharded step lies
    7.3e-6 from its one-device solver, so the sparse bound is the larger
    of 1e-5 and twice that gap, computed in the test;
  * pair sweep: <= 1e-6 against `batched_icp`;
  * full-pipeline sweep (the dry run's 600-point scene and configuration,
    `__graft_entry__.py:195-229`, one pair a rank): <= 1e-6 against the
    port's `register_pairs` given the same draws; against the reference's
    sweep given the same draws, both within the success bound (RTE < 2 m,
    RRE < 5 deg) and within 0.1 m and 0.5 deg of each other, the bound of
    `tests/test_torch_pipeline.py` (on the CPU the reference takes its
    dense FPFH and while-loop ICP);
  * every rank returns the same result (0 apart).
"""
import torch_threads as _torch_threads  # noqa: F401

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh
from scipy.spatial.transform import Rotation

from pctpu import parallel as jpar
from pctpu.core import se3 as jse3
from pctpu.core.cloud import PointCloud as JCloud
from pctpu.register import pipeline as jpipe
from pctpu_torch import parallel as P
from pctpu_torch.core import se3
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.entry import dryrun_multichip
from pctpu_torch.ops.knn import nearest
from pctpu_torch.parallel.launch import run_world
from pctpu_torch.register import pipeline as tpipe
from pctpu_torch.register.icp import icp_fixed_iters

import torch_ranks

W = 4
FULL_CFG = dict(voxel_size=0.8, feature_radius=4.0, normal_radius=1.6,
                ransac_dist=1.2, ransac_hypotheses=512, icp_dist_thresh=2.0,
                downsample_capacity=512, refine_subsample=512,
                stats_subsample=256)


def _jmesh(axis):
    return Mesh(np.array(jax.devices()[:W]), (axis,))


def _pair(rng, n, angle, trans):
    src = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    axis = rng.normal(size=3)
    R = Rotation.from_rotvec(np.radians(angle) * axis / np.linalg.norm(axis)
                             ).as_matrix().astype(np.float32)
    return src, (src @ R.T + rng.normal(size=3) * trans).astype(np.float32)


def _ring_graph(rng, m, closure_every):
    """A drifting loop of m poses: noisy odometry edges, the loop closure,
    and exact closures every `closure_every` poses (`tests/test_parallel.py`
    :_ring_graph and its keyframe graph); the odometry-integrated start."""
    gt = [np.eye(4)]
    for _ in range(1, m):
        T = np.eye(4)
        T[:3, :3] = Rotation.from_rotvec(rng.normal(scale=0.3, size=3)
                                         ).as_matrix()
        T[:3, 3] = rng.normal(size=3)
        gt.append(gt[-1] @ T)
    ei, ej, Tm = [], [], []
    for i, j in [(k, k + 1) for k in range(m - 1)] + [(m - 1, 0)]:
        rel = np.linalg.inv(gt[i]) @ gt[j]
        rel[:3, :3] = rel[:3, :3] @ Rotation.from_rotvec(
            rng.normal(scale=0.02, size=3)).as_matrix()
        rel[:3, 3] += rng.normal(scale=0.1, size=3)
        ei, ej, Tm = ei + [i], ej + [j], Tm + [rel]
    for i in range(0, m - closure_every, closure_every):
        ei, ej = ei + [i], ej + [i + closure_every]
        Tm.append(np.linalg.inv(gt[i]) @ gt[i + closure_every])
    init = [np.eye(4)]
    for k in range(m - 1):
        init.append(init[-1] @ Tm[k])
    pad = (-len(ei)) % W                     # weight-0 edges at (0, 0)
    return dict(poses=np.stack(init).astype(np.float32),
                ei=np.array(ei + [0] * pad, np.int64),
                ej=np.array(ej + [0] * pad, np.int64),
                Tm=np.concatenate([np.stack(Tm), np.tile(np.eye(4), (pad, 1,
                                                                     1))]
                                  ).astype(np.float32),
                w=np.array([1.0] * len(ei) + [0.0] * pad, np.float32))


def _scene(rng, n_fp=600):
    """The dry run's ground-and-two-walls scene and its pairs
    (`__graft_entry__.py:195-221`), one pair a rank."""
    g = rng.uniform(-10, 10, (n_fp // 2, 3)).astype(np.float32)
    g[:, 2] = rng.normal(scale=0.05, size=n_fp // 2)
    w1 = rng.uniform(-1, 1, (n_fp // 4, 3)).astype(np.float32)
    w1[:, 0] = 4.0
    w1[:, 2] = 2.0 * (w1[:, 2] + 1)
    w2 = rng.uniform(-1, 1, (n_fp - n_fp // 2 - n_fp // 4, 3)
                     ).astype(np.float32)
    w2[:, 1] = -3.0
    w2[:, 2] = 1.5 * (w2[:, 2] + 1)
    scene = np.concatenate([g, w1, w2])
    dsts, gts = [], []
    for i in range(W):
        ang = np.radians(8.0 + 2.0 * i)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0],
                     [np.sin(ang), np.cos(ang), 0], [0, 0, 1]]
        T[:3, 3] = [1.0 + 0.2 * i, -0.5, 0.05]
        dsts.append((scene @ T[:3, :3].T + T[:3, 3] + rng.normal(
            scale=0.02, size=scene.shape)).astype(np.float32))
        gts.append(T)
    return (np.stack([scene] * W), np.stack(dsts), np.stack(gts),
            np.ones((W, scene.shape[0]), bool))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(16)
    dst = rng.uniform(0, 100, (1022, 3)).astype(np.float32)
    src = (dst + rng.normal(scale=0.3, size=dst.shape)).astype(np.float32)
    src_p, src_m = P.partition_by_axis(src, W)
    dst_p, dst_m = P.partition_by_axis(dst, W)
    halo = dict(src=src_p, src_mask=src_m, dst=dst_p, dst_mask=dst_m,
                width=64, chunk=256)
    s, d = _pair(rng, 1024, 8.0, 0.5)
    icp = dict(src=s, dst=d, mask=np.ones(1024, bool), iters=25, chunk=256)
    graphs = {}
    for key, m, every in (("pg_dense", 9, 4), ("pg_sparse", 16, 4)):
        g = _ring_graph(rng, m, every)
        g["Tm_inv"] = se3.invert_transform(torch.from_numpy(g["Tm"])).numpy()
        if key == "pg_sparse":
            g["cg_iters"] = 400
        graphs[key] = g
    pairs = [_pair(rng, 256, 5.0, 0.3) for _ in range(2 * W)]
    sweep = dict(src=np.stack([p[0] for p in pairs]),
                 dst=np.stack([p[1] for p in pairs]),
                 mask=np.ones((2 * W, 256), bool), iters=20, chunk=256)
    fsrc, fdst, fgt, fmask = _scene(rng)
    return dict(halo=halo, icp=icp, sweep=sweep, **graphs,
                full=dict(src=fsrc, dst=fdst, gt=fgt, mask=fmask,
                          cfg=FULL_CFG))


@pytest.fixture(scope="module")
def full_one(inputs):
    """The port's one-process `register_pairs` on the full-pipeline pairs
    with the reference's draws (jax.random.randint from each pair's key at
    the pair's valid-match count), and those draws as a lookup sampler."""
    f = inputs["full"]
    keys = jax.random.split(jax.random.PRNGKey(5), W)
    seen = {}

    def sample(nv, H):
        u = jax.vmap(lambda k, n: jax.random.randint(k, (H, 3), 0, n))(
            keys, jnp.asarray(nv.numpy()))
        seen["nv"], seen["u"] = nv.numpy().copy(), np.array(u)
        return torch.from_numpy(np.array(u))
    out = tpipe.register_pairs(
        PointCloud(torch.from_numpy(f["src"]), torch.from_numpy(f["mask"])),
        PointCloud(torch.from_numpy(f["dst"]), torch.from_numpy(f["mask"])),
        cfg=tpipe.RegistrationConfig(**FULL_CFG), sampler=sample,
        device="cpu")
    return out, keys, torch_ranks.LookupSampler(seen["nv"], seen["u"])


@pytest.fixture(scope="module")
def world(inputs, full_one):
    inp = dict(inputs, full=dict(inputs["full"], sampler=full_one[2]))
    return run_world(torch_ranks.parallel_checks, W, "gloo", "cpu", inp,
                     timeout=300)


def test_make_mesh_shapes_and_collectives(world):
    """`make_mesh` resolves -1 as the reference's does on 4 devices; the
    axis groups, the ring, the gather, the row block, the broadcast and the
    differentiable all-reduce give what the 4 ranks put in (rank 0's
    view)."""
    m = world["mesh"]
    ref = [dict(jpar.make_mesh(axes, devices=jax.devices()[:W]).shape)
           for axes in ((("data", -1),), (("pair", 2), ("point", -1)))]
    assert m["shapes"] == ref == [{"data": 4}, {"pair": 2, "point": 2}]
    assert m["coords"] == [{"data": 0}, {"pair": 0, "point": 0}]
    assert m["sums"] == [0.0 + 2.0, 0.0 + 1.0]     # ranks {0,2}, {0,1}
    assert (m["right"], m["left"]) == (3, 1)       # from the left, the right
    assert m["gathered"] == [0, 10, 20, 30]
    assert m["rows"] == [0, 1, 2, 3]
    assert m["replicated"] == [0.0]
    # y = sum_r (r+1) x = 10 x; loss sum_r (r+1) sum(y): dx_0 = 10 * 1
    assert m["reduce_grad"] == ([10.0, 20.0], [10.0, 10.0])


@pytest.mark.parametrize("n_shards,axis", [(4, 0), (3, 2), (8, 1)])
def test_partition_by_axis_matches_jax(n_shards, axis):
    """Sorted, padded slabs and mask equal to the reference's exactly,
    ties in the sort axis included."""
    rng = np.random.default_rng(n_shards)
    pts = rng.integers(0, 20, (101, 4)).astype(np.float32)
    got = P.partition_by_axis(pts, n_shards, axis)
    ref = jpar.partition_by_axis(pts, n_shards, axis)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


def test_halo_nearest_matches_port_nearest(inputs, world):
    """Equal d2 and index to K1 (plain) over the whole padded database
    wherever the true neighbour lies within the slab or the halo; padded
    queries read 1e30."""
    h = inputs["halo"]
    d2, idx = world["halo"]
    assert world["spread"]["halo"] == 0.0
    rd2, ridx = nearest(torch.from_numpy(h["src"]), torch.from_numpy(h["dst"]),
                        torch.from_numpy(h["dst_mask"]))
    s, hw = h["src"].shape[0] // W, h["width"]
    slab = np.arange(h["src"].shape[0]) // s
    ri = ridx.numpy()
    reach = (ri >= slab * s - hw) & (ri < (slab + 1) * s + hw)
    q = h["src_mask"] & reach
    assert q.mean() > 0.9
    np.testing.assert_array_equal(d2.numpy()[q], rd2.numpy()[q])
    np.testing.assert_array_equal(idx.numpy()[q], ri[q])
    assert (d2.numpy()[~h["src_mask"]] == 1e30).all()


def test_halo_nearest_matches_jax(inputs, world):
    """Against the reference's halo on 4 devices: the same index wherever
    the reference's two nearest d2 differ by more than 1e-3; d2 within
    2e-2."""
    h = inputs["halo"]
    f = jpar.make_halo_nearest(_jmesh("point"), halo_width=h["width"],
                               query_chunk=h["chunk"])
    rd2, ridx = (np.asarray(a) for a in f(*(jnp.asarray(h[k]) for k in (
        "src", "src_mask", "dst", "dst_mask"))))
    d2, idx = (a.numpy() for a in world["halo"])
    v = h["src_mask"]
    np.testing.assert_allclose(d2[v], rd2[v], atol=2e-2, rtol=0)
    full = ((h["src"][:, None] - h["dst"][None]) ** 2).sum(-1)
    full[:, ~h["dst_mask"]] = np.inf
    two = np.sort(full, axis=1)[:, :2]
    clear = v & (two[:, 1] - two[:, 0] > 1e-3)
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx[clear], ridx[clear])


def test_point_sharded_icp_matches_jax_and_one_process(inputs, world):
    """max |dT| <= 1e-5 against the reference at W = 4 and against the
    port's one-process `icp_fixed_iters`."""
    p = inputs["icp"]
    assert world["spread"]["icp"] == 0.0
    T = world["icp"].numpy()
    f = jpar.make_point_sharded_icp(_jmesh("point"), iters=p["iters"],
                                    query_chunk=p["chunk"])
    ref = np.asarray(f(jnp.asarray(p["src"]), jnp.asarray(p["mask"]),
                       jnp.asarray(p["dst"]), jnp.asarray(p["mask"])))
    one = icp_fixed_iters(torch.from_numpy(p["src"]),
                          torch.from_numpy(p["mask"]),
                          torch.from_numpy(p["dst"]),
                          torch.from_numpy(p["mask"]), iters=p["iters"],
                          query_chunk=p["chunk"], device="cpu").numpy()
    assert np.abs(T - ref).max() <= 1e-5, np.abs(T - ref).max()
    assert np.abs(T - one).max() <= 1e-5, np.abs(T - one).max()


@pytest.mark.parametrize("key", ["pg_dense", "pg_sparse"])
def test_sharded_pose_graph_step_matches_jax_and_one_process(inputs, world,
                                                              key):
    """One edge-sharded Gauss-Newton step, dense and block-sparse, padded
    edges included: max |dP| <= 1e-5 against the reference's step at W = 4
    and against the port's one-process solver at one iteration; for the
    sparse step, <= the larger of 1e-5 and twice the reference's own gap
    between its sharded step and its one-device solver on the graph."""
    g = inputs[key]
    sparse = key == "pg_sparse"
    assert world["spread"][key] == 0.0
    got = world[key].numpy()
    args = (jnp.asarray(g["poses"]), jnp.asarray(g["ei"]),
            jnp.asarray(g["ej"]),
            jax.vmap(jse3.invert_transform)(jnp.asarray(g["Tm"])),
            jnp.asarray(g["w"]))
    tol = 1e-5
    if sparse:
        f = jpar.make_sharded_pose_graph_step_sparse(
            _jmesh("data"), cg_iters=g["cg_iters"])
        one = P.optimize_pose_graph_sparse(
            g["poses"], g["ei"], g["ej"], g["Tm"], weights=g["w"], iters=1,
            cg_iters=g["cg_iters"], device="cpu")
        # float32 CG: the reference's sharded step is itself this far from
        # its one-device solver on the same graph (7.3e-6 here)
        self_gap = np.abs(np.asarray(f(*args)) - np.asarray(
            jpar.optimize_pose_graph_sparse(
                *args[:3], jnp.asarray(g["Tm"]), weights=args[4], iters=1,
                cg_iters=g["cg_iters"]).poses)).max()
        tol = max(tol, 2 * float(self_gap))
    else:
        f = jpar.make_sharded_pose_graph_step(_jmesh("data"))
        one = P.optimize_pose_graph(g["poses"], g["ei"], g["ej"], g["Tm"],
                                    weights=g["w"], iters=1, device="cpu")
    ref = np.asarray(f(*args))
    assert np.abs(got - ref).max() <= tol, (np.abs(got - ref).max(), tol)
    assert np.abs(got - one.poses.numpy()).max() <= tol
    assert np.abs(got - g["poses"]).max() > 1e-3     # the step moved


def test_pair_sweep_matches_batched_icp(inputs, world):
    """The pair-sharded sweep (2 pairs a rank) within 1e-6 of the
    one-process `batched_icp` on all 8 pairs."""
    s = inputs["sweep"]
    assert world["spread"]["sweep"] == 0.0
    one = P.batched_icp(*(torch.from_numpy(s[k]) for k in (
        "src", "mask", "dst", "mask")), iters=s["iters"],
        query_chunk=s["chunk"], device="cpu")
    assert world["sweep"].shape == (2 * W, 4, 4)
    assert (world["sweep"] - one).abs().max() <= 1e-6


def test_full_pipeline_sweep_matches_register_pairs(world, full_one):
    """One pair a rank, the reference's draws: every output within 1e-6
    of the port's one-process `register_pairs` with the same draws."""
    assert world["spread"]["full"] == 0.0
    one = full_one[0]
    for name, got, ref in zip(one._fields, world["full"], one):
        assert got.shape == ref.shape, name
        assert (got.double() - ref.double()).abs().max() <= 1e-6, name


def test_full_pipeline_sweep_matches_jax(inputs, world, full_one):
    """Against the reference's sweep on 4 devices with the same keys: both
    within the success bound of the ground truth, and within 0.1 m and
    0.5 deg of each other."""
    f = inputs["full"]
    keys = full_one[1]
    jmesh = _jmesh("data")
    sweep = jpar.make_full_pipeline_sweep(
        jmesh, cfg=jpipe.RegistrationConfig(**FULL_CFG))
    with jmesh:
        ref = sweep(JCloud(jnp.asarray(f["src"]), jnp.asarray(f["mask"])),
                    JCloud(jnp.asarray(f["dst"]), jnp.asarray(f["mask"])),
                    keys)
    T = world["full"].T
    gt = torch.from_numpy(f["gt"])
    rte, rre = se3.pose_diff_rte_rre(T, gt)
    jrte, jrre = jse3.pose_diff_rte_rre(ref.T, jnp.asarray(f["gt"]))
    assert float(rte.max()) < 2.0 and float(rre.max()) < 5.0, (rte, rre)
    assert float(jnp.max(jrte)) < 2.0 and float(jnp.max(jrre)) < 5.0
    drte, drre = se3.pose_diff_rte_rre(T, torch.from_numpy(np.array(ref.T)))
    assert float(drte.max()) < 0.1 and float(drre.max()) < 0.5, (drte, drre)


def test_dryrun_multichip_cpu():
    """The port's dry run in a world of 4 CPU ranks: all six checks pass
    their gates (it raises otherwise) and agree as the reference's do."""
    res = dryrun_multichip(W, device="cpu")
    assert np.isfinite(res["loss"])
    assert res["halo_exact"] == 1.0
    assert res["icp_dT"] <= 1e-5
    for k in ("posegraph_dP", "posegraph_sparse_dP", "pair_sweep_dT",
              "full_pipeline_dT"):
        assert res[k] <= 1e-6, (k, res[k])


def test_run_world_fails_on_a_rank_and_on_timeout():
    """A rank that raises fails the run with its traceback, and a rank
    that never reaches the collective fails it at the timeout; neither
    hangs."""
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_world(torch_ranks.raise_on_rank1, 2, "gloo", "cpu", timeout=120)
    with pytest.raises(RuntimeError, match="timed out"):
        run_world(torch_ranks.hang_on_rank1, 2, "gloo", "cpu", 600.0,
                  timeout=6)


def test_entry_points_raise_without_a_card():
    """The distributed entry points default to CUDA and raise without a
    card; none falls back to the CPU or to gloo."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: P.make_point_sharded_icp(None),
                 lambda: P.make_halo_nearest(None, 8),
                 lambda: P.make_pair_sweep(None),
                 lambda: P.make_full_pipeline_sweep(None),
                 lambda: P.make_sharded_pose_graph_step(None),
                 lambda: P.make_sharded_pose_graph_step_sparse(None),
                 lambda: P.multihost_init(),
                 lambda: run_world(torch_ranks.raise_on_rank1, 2),
                 lambda: dryrun_multichip(2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_multihost_init_tcp_and_env(monkeypatch):
    """A world of one joined at tcp://host:port, then from the
    environment's variables, on the CPU (gloo)."""
    import socket
    import torch.distributed as dist
    for how in ("tcp", "env"):
        with socket.socket() as sock:
            sock.bind(("localhost", 0))
            port = sock.getsockname()[1]
        if how == "tcp":
            P.multihost_init(f"localhost:{port}", 1, 0, device="cpu")
        else:
            for k, v in dict(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                             WORLD_SIZE="1", RANK="0").items():
                monkeypatch.setenv(k, v)
            P.multihost_init(device="cpu")
        try:
            assert dist.get_backend() == "gloo"
            assert dist.get_world_size() == 1
            assert P.make_mesh().shape == {"data": 1}
        finally:
            dist.destroy_process_group()
    with pytest.raises(ValueError, match="together"):
        P.multihost_init("localhost:1", device="cpu")
