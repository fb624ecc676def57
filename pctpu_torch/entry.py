"""The entry points of `__graft_entry__.py`, ported: the flagship
forward as `(fn, example_args)` (`entry`: the PointNet++ MSG classifier,
eval mode) and the multi-rank dry run of every distributed path
(`dryrun_multichip`)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.nn import train as T
from pctpu_torch.nn.config import TrainConfig


def entry(device: DeviceLike = None):
    """(forward, (pc,)): `cls-msg` with 40 classes on B = 4 random clouds
    of 1,024 points x 6 channels, weights from a generator seeded with 0;
    forward(pc) -> logits [4,40] under no_grad. On CUDA unless "cpu" is
    asked for."""
    dev = resolve_device(device)
    cfg = TrainConfig(model="cls-msg", num_classes=40, num_points=1024,
                      batch_size=4)
    gen = torch.Generator().manual_seed(0)
    model = T.build_model(cfg, device=dev, generator=gen)
    pc = torch.randn((4, 1024, 6), generator=gen).to(dev)

    @torch.no_grad()
    def forward(pc):
        return model(pc)

    return forward, (pc,)


def _dryrun_rank(n: int, device: str) -> dict:
    """The six checks of `dryrun_multichip` in one rank of a world of n:
    each distributed function on every rank, its one-process counterpart
    on rank 0 alone. Returns rank 0's figures."""
    import numpy as np
    import torch.distributed as dist

    from pctpu_torch.core import se3
    from pctpu_torch.core.cloud import PointCloud
    from pctpu_torch.ops.knn import nearest
    from pctpu_torch import parallel as P
    from pctpu_torch.register.icp import icp_fixed_iters
    from pctpu_torch.register.pipeline import (RegistrationConfig,
                                               register_pairs)

    dev = resolve_device(device)
    lead = dist.get_rank() == 0
    mesh = P.make_mesh((("data", -1),))
    out = {}

    def t(x):
        return torch.as_tensor(x).to(dev)

    # 1. data-parallel train step
    cfg = TrainConfig(model="cls-ssg", num_classes=10, num_points=128,
                      batch_size=n, lr=1e-4)
    gen = torch.Generator().manual_seed(0)
    pc = torch.randn((n, 128, 6), generator=gen).to(dev)
    labels = torch.zeros((n,), dtype=torch.int64, device=dev)
    model, state = T.create_train_state(cfg, gen, pc, device=dev)
    step = T.make_data_parallel_train_step(model, cfg, mesh, device=dev)
    metrics = step(state, pc, labels, torch.Generator(dev).manual_seed(0))
    out["loss"] = float(metrics["loss"])

    # 2. halo-exchange point-sharded 1-NN against the whole database
    rng = np.random.default_rng(0)
    n_pts = 64 * n
    dst_raw = rng.uniform(0, 100, (n_pts, 3)).astype(np.float32)
    src_raw = (dst_raw + rng.normal(scale=0.3, size=dst_raw.shape)
               ).astype(np.float32)
    src_p, src_m = P.partition_by_axis(src_raw, n)
    dst_p, dst_m = P.partition_by_axis(dst_raw, n)
    halo = P.make_halo_nearest(mesh, halo_width=32, point_axis="data",
                               query_chunk=64, device=dev)
    d2_halo, _ = halo(src_p, src_m, dst_p, dst_m)
    if lead:
        d2_ref, _ = nearest(t(src_p), t(dst_p), t(dst_m), 64)
        err = (d2_halo - d2_ref).abs()[t(src_m)]
        out["halo_exact"] = float((err < 2e-2).float().mean())

    # 3. point-sharded ICP against the one-process ICP
    n_icp = 128 * n
    src_i = rng.uniform(-10, 10, (n_icp, 3)).astype(np.float32)
    c, s = np.cos(0.02), np.sin(0.02)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    dst_i = src_i @ R.T + np.array([0.1, -0.05, 0.02], np.float32)
    ones = np.ones((n_icp,), bool)
    T_sh = P.make_point_sharded_icp(mesh, point_axis="data", iters=10,
                                    query_chunk=128, device=dev)(
        src_i, ones, dst_i, ones)
    if lead:
        T_ref = icp_fixed_iters(t(src_i), t(ones), t(dst_i), t(ones),
                                iters=10, query_chunk=128, device=dev)
        out["icp_dT"] = float((T_sh - T_ref).abs().max())

    # 4. edge-sharded pose-graph steps, dense and block-sparse
    ei, ej, T_meas = [0, 1, 2, 0], [1, 2, 3, 3], []
    for k in range(4):
        ang = 0.05 * (k + 1)
        ca, sa = np.cos(ang), np.sin(ang)
        M = np.eye(4, dtype=np.float32)
        M[:3, :3] = [[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]]
        M[:3, 3] = [1.0 + 0.1 * k, 0.0, 0.0]
        T_meas.append(M)
    n_edges = max(n, -(-len(ei) // n) * n)
    pad = n_edges - len(ei)
    ei_a = np.asarray(ei + [0] * pad, np.int64)
    ej_a = np.asarray(ej + [1] * pad, np.int64)
    Tm_a = np.stack(T_meas + [np.eye(4, dtype=np.float32)] * pad)
    w_a = np.asarray([1.0] * len(ei) + [0.0] * pad, np.float32)
    poses = torch.eye(4, device=dev).repeat(4, 1, 1)
    Tm_inv = se3.invert_transform(t(Tm_a))
    dense = P.make_sharded_pose_graph_step(mesh, device=dev)(
        poses, ei_a, ej_a, Tm_inv, w_a)
    sparse = P.make_sharded_pose_graph_step_sparse(mesh, cg_iters=100,
                                                   device=dev)(
        poses, ei_a, ej_a, Tm_inv, w_a)
    if lead:
        ref = P.optimize_pose_graph(poses, ei_a, ej_a, Tm_a, weights=w_a,
                                    iters=1, device=dev).poses
        ref_sp = P.optimize_pose_graph_sparse(
            poses, ei_a, ej_a, Tm_a, weights=w_a, iters=1, cg_iters=100,
            device=dev).poses
        out["posegraph_dP"] = float((dense - ref).abs().max())
        out["posegraph_sparse_dP"] = float((sparse - ref_sp).abs().max())

    # 5. pair-sharded ICP sweep against the one-process batched ICP
    n_pairs, n_pp = 2 * n, 96
    srcs = rng.uniform(-8, 8, (n_pairs, n_pp, 3)).astype(np.float32)
    ca, sa = np.cos(0.03), np.sin(0.03)
    Rp = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
    dsts = srcs @ Rp.T + np.array([0.2, -0.1, 0.05], np.float32)
    masks = np.ones((n_pairs, n_pp), bool)
    Ts = P.make_pair_sweep(mesh, iters=8, query_chunk=n_pp, device=dev)(
        srcs, masks, dsts, masks)
    if lead:
        Ts_ref = P.batched_icp(t(srcs), t(masks), t(dsts), t(masks), iters=8,
                               query_chunk=n_pp, device=dev)
        out["pair_sweep_dT"] = float((Ts - Ts_ref).abs().max())

    # 6. pair-sharded full registration pipeline against the one-process
    # `register_pairs` with the same draws
    n_fp = 600
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
    dsts_fp = []
    for i in range(n):
        ang = np.radians(8.0 + 2.0 * i)
        ca, sa = np.cos(ang), np.sin(ang)
        Rf = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]], np.float32)
        dsts_fp.append((scene @ Rf.T + np.array([1.0 + 0.2 * i, -0.5, 0.05],
                                                np.float32)
                        + rng.normal(scale=0.02, size=scene.shape)
                        ).astype(np.float32))
    mask_fp = t(np.ones((n, scene.shape[0]), bool))
    sp = PointCloud(t(np.stack([scene] * n)), mask_fp)
    dp = PointCloud(t(np.stack(dsts_fp)), mask_fp)
    cfg_fp = RegistrationConfig(voxel_size=0.8, feature_radius=4.0,
                                normal_radius=1.6, ransac_dist=1.2,
                                ransac_hypotheses=512, icp_dist_thresh=2.0,
                                downsample_capacity=512,
                                refine_subsample=512, stats_subsample=256)
    out_sh = P.make_full_pipeline_sweep(mesh, cfg=cfg_fp, device=dev)(sp, dp)
    if lead:
        out_ref = register_pairs(sp, dp, cfg=cfg_fp, device=dev)
        out["full_pipeline_dT"] = float((out_sh.T - out_ref.T).abs().max())
    return out


def dryrun_multichip(n_devices: int, backend: Optional[str] = None,
                     device: DeviceLike = None) -> dict:
    """The multi-rank dry run (port of `__graft_entry__.py:dryrun_multichip`):
    a world of `n_devices` ranks (`parallel.launch.run_world`; `backend`
    defaults to the device's: NCCL on CUDA, gloo on the CPU) runs, at the
    reference's shapes and gates,

      1. the data-parallel `cls-ssg` train step (finite loss);
      2. the halo-exchange 1-NN against the whole database (> 97% of the
         queries within 2e-2 in d2);
      3. the point-sharded ICP against `icp_fixed_iters` (1e-3);
      4. the edge-sharded pose-graph steps, dense and block-sparse, against
         `optimize_pose_graph` / `_sparse` at one iteration (1e-3);
      5. the pair sweep against `batched_icp` (1e-3);
      6. the full-pipeline sweep against `register_pairs` with the same
         draws (1e-3).

    Prints a line a check and returns the figures; raises on a failed
    gate. On CUDA unless "cpu" is asked for."""
    from pctpu_torch.parallel.launch import run_world
    dev = resolve_device(device)
    res = run_world(_dryrun_rank, n_devices, backend, dev, n_devices,
                    dev.type)
    gates = (("dp_train", "loss", lambda v: np.isfinite(v)),
             ("halo_nn", "halo_exact", lambda v: v > 0.97),
             ("point_sharded_icp", "icp_dT", lambda v: v < 1e-3),
             ("sharded_posegraph", "posegraph_dP", lambda v: v < 1e-3),
             ("sharded_posegraph_sparse", "posegraph_sparse_dP",
              lambda v: v < 1e-3),
             ("pair_sweep", "pair_sweep_dT", lambda v: v < 1e-3),
             ("full_pipeline_sweep", "full_pipeline_dT", lambda v: v < 1e-3))
    for name, key, ok in gates:
        if not ok(res[key]):
            raise RuntimeError(f"dryrun_multichip({n_devices}): {name} "
                               f"failed, {key}={res[key]}")
        print(f"dryrun_multichip({n_devices}): {name} ok, {key}="
              f"{res[key]:.3g}")
    print(f"dryrun_multichip({n_devices}): ok, loss={res['loss']:.4f} "
          "(dp_train + halo_nn + point_sharded_icp + sharded_posegraph"
          "[dense+sparse] + pair_sweep + full_pipeline_sweep)")
    return res
