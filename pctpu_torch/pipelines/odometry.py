"""LiDAR odometry and pose-graph SLAM (port of
`pctpu/pipelines/odometry.py`).

Scan-to-scan (or scan-to-submap) point-to-plane ICP with a
constant-velocity prior, keyframes, proximity loop closures re-registered
by ICP and validated by their fitness, and Gauss-Newton over the keyframe
graph (`parallel.posegraph`). Round 0's closure candidates are
initialised by the batched global registration `register_pairs`.

On the card every association is kernel K1; round 0's `register_pairs`
adds K2, K3 and K4. The `"scan"` front end keeps the submap buffer and the
prior on the device and reads nothing back until the whole chain is done:
one host sync per sequence. The `"host"` front end brings each frame's
pose back, so it can checkpoint and resume.

Entry points run on CUDA unless the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from pctpu_torch.core import se3
from pctpu_torch.core.cloud import PointCloud, round_up
from pctpu_torch.device import DeviceLike, f32_square, resolve_device
from pctpu_torch.features.fpfh_dense import normals_radius_dense
from pctpu_torch.ops.knn import nearest
from pctpu_torch.ops.voxel import voxel_downsample
from pctpu_torch.parallel.posegraph import (optimize_pose_graph,
                                            optimize_pose_graph_sparse)
from pctpu_torch.register.icp import icp_fixed_iters, icp_fixed_iters_p2pl
from pctpu_torch.register.ransac import Sampler


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    """The reference's `OdometryConfig`, with the same fields and
    defaults."""
    voxel_leaf: float = 0.5
    icp_iters: int = 25
    icp_dist_thresh: float = 2.0
    keyframe_every: int = 5
    closure_radius: float = 5.0       # keyframe proximity for loop closure
    closure_min_gap: int = 3          # in keyframes
    # accept a closure edge only if, at the ICP-refined pose, at least
    # this fraction of source points has a target neighbour within
    # validation_dist: one bad edge drags the whole graph
    closure_min_fitness: float = 0.55
    closure_validation_dist: float = 0.5
    # 'global': round 0 re-registers every candidate from scratch with the
    # FPFH + RANSAC front end (`register_pairs`, all candidates batched);
    # 'odometry': the drifted relative pose is the ICP init
    closure_init: str = "global"
    closure_reg_capacity: int = 2048
    closure_ransac_hypotheses: int = 2048
    # rounds >= 1 re-detect and retry candidates from the graph-corrected
    # poses (stopping when a round accepts nothing new)
    closure_rounds: int = 2
    pose_graph_iters: int = 16
    # Geman-McClure scale of the graph solve (None = plain L2), and its
    # graduated non-convexity: delta starts at 2^warmup * robust_delta and
    # halves per Gauss-Newton step
    robust_delta: Optional[float] = 0.5
    robust_warmup: int = 8
    # 'p2pl': point-to-plane scan matching; 'p2p': point-to-point
    method: str = "p2pl"
    # register each frame against the union of the last submap_frames
    # downsampled clouds (1 = scan-to-scan)
    submap_frames: int = 1
    # trimmed association (annealed on for the second half of the
    # iterations); 1.0 = off
    trim: float = 1.0
    closure_trim: float = 1.0
    query_chunk: int = 2048
    # 'scan': the whole front end on the device, one host sync per
    # sequence, no checkpoints; 'host': one ICP per frame from the host
    # (restartable); 'auto': scan unless checkpoint_path is given
    frontend: str = "auto"


def _prep(scan: np.ndarray, capacity: int, leaf: float,
          device: DeviceLike = None) -> PointCloud:
    pc = PointCloud.from_numpy(scan, capacity=capacity, device=device)
    return voxel_downsample(pc.points, pc.mask, leaf)


def save_odometry_state(path: str, i: int, poses, deltas) -> None:
    """Restartable front-end state: the same `.npz` as the reference, so
    either package resumes the other's checkpoint."""
    np.savez(path, i=i, poses=np.stack(poses), deltas=np.stack(deltas))


def load_odometry_state(path: str):
    if not os.path.exists(path):
        return None
    z = np.load(path)
    return (int(z["i"]), [p for p in z["poses"].astype(np.float32)],
            [d for d in z["deltas"].astype(np.float32)])


def odometry_deltas_scan(points: torch.Tensor, masks: torch.Tensor,
                         normals: Optional[torch.Tensor] = None,
                         iters: int = 25, dist_thresh: float = 2.0,
                         query_chunk: int = 2048, method: str = "p2pl",
                         trim: float = 1.0,
                         submap_frames: int = 1) -> torch.Tensor:
    """The device-resident front end: points [F,N,3], masks [F,N]
    (normals [F,N,3] for 'p2pl') -> deltas [F,4,4] with deltas[0] = I and
    deltas[k] = prev_T_cur, on the device of `points`. A loop over frames
    carries the rolling submap buffer (K clouds in the previous frame's
    coordinates) and the constant-velocity prior; nothing is read back to
    the host inside the loop."""
    f, n, _ = points.shape
    k = max(1, submap_frames)
    eye = torch.eye(4, dtype=torch.float32, device=points.device)

    def init_buf(x0):
        """[N,...] -> [K,N,...] with only slot 0 live."""
        return torch.cat([x0[None], torch.zeros((k - 1,) + x0.shape,
                                                dtype=x0.dtype,
                                                device=x0.device)])

    p2pl = method == "p2pl"
    if p2pl and normals is None:
        raise ValueError("method='p2pl' needs normals")
    buf_pts, buf_msk = init_buf(points[0]), init_buf(masks[0])
    buf_nrm = init_buf(normals[0]) if p2pl else None
    prior, deltas = eye, [eye]
    for i in range(1, f):
        if p2pl:
            T = icp_fixed_iters_p2pl(
                points[i], masks[i], buf_pts.reshape(k * n, 3),
                buf_nrm.reshape(k * n, 3), buf_msk.reshape(k * n),
                init_T=prior, iters=iters, dist_thresh=dist_thresh,
                query_chunk=query_chunk, trim=trim, device=points.device)
        else:
            T = icp_fixed_iters(
                points[i], masks[i], buf_pts.reshape(k * n, 3),
                buf_msk.reshape(k * n), init_T=prior, iters=iters,
                dist_thresh=dist_thresh, query_chunk=query_chunk, trim=trim,
                device=points.device)
        # move the buffer into the CURRENT frame: p' = R^T (p - t),
        # normals rotate by R^T
        R = T[:3, :3]
        buf_pts = torch.cat([points[i][None], ((buf_pts - T[:3, 3]) @ R)[:-1]])
        if p2pl:
            buf_nrm = torch.cat([normals[i][None], (buf_nrm @ R)[:-1]])
        buf_msk = torch.cat([masks[i][None], buf_msk[:-1]])
        prior = T
        deltas.append(T)
    return torch.stack(deltas)


def _closure_validate_batch(src_p, src_m, src_n, dst_p, dst_n, dst_m, inits,
                            iters: int, dist_thresh: float, query_chunk: int,
                            trim: float, method: str,
                            validation_dist: float):
    """Closure refine + fitness for a batch of candidate pairs, all in
    lockstep: (Ts [C,4,4], fitness [C]), the fitness being the fraction of
    source points with a target neighbour within validation_dist at the
    refined pose."""
    dev = src_p.device
    if method == "p2pl":
        Ts = icp_fixed_iters_p2pl(src_p, src_m, dst_p, dst_n, dst_m,
                                  init_T=inits, iters=iters,
                                  dist_thresh=dist_thresh,
                                  query_chunk=query_chunk, trim=trim,
                                  device=dev)
    else:
        Ts = icp_fixed_iters(src_p, src_m, dst_p, dst_m, init_T=inits,
                             iters=iters, dist_thresh=dist_thresh,
                             query_chunk=query_chunk, trim=trim, device=dev)
    d2, _ = nearest(se3.apply_transform(Ts, src_p), dst_p, dst_m,
                    query_chunk)
    inl = d2 <= f32_square(validation_dist)
    fits = ((inl & src_m).sum(dim=1).float()
            / torch.clamp_min(src_m.sum(dim=1), 1).float())
    return Ts, fits


def compose_deltas(deltas: torch.Tensor) -> torch.Tensor:
    """deltas [F,4,4] (delta[k] = pose[k-1]^-1 pose[k]) -> world poses
    [F,4,4] as a sequential chain of exact-f32 products on the device.
    (The reference composes by an associative scan, which rounds in
    another order: the two agree within 1e-4.)"""
    poses = [deltas[0]]
    for k in range(1, deltas.shape[0]):
        poses.append(poses[-1] @ deltas[k])
    return torch.stack(poses)


def run_odometry(scans: Sequence[np.ndarray],
                 cfg: OdometryConfig = OdometryConfig(),
                 checkpoint_path: Optional[str] = None,
                 checkpoint_every: int = 25,
                 sampler: Optional[Sampler] = None,
                 device: DeviceLike = None) -> Dict:
    """scans: list of (N_i, 3) arrays in the sensor frame -> dict with
    'poses' [F,4,4] world_T_sensor (numpy), the keyframes, the accepted
    and rejected loop closures, the optimized keyframe and frame poses,
    the graph's edges and its final cost, and 'closure_candidates' (the
    candidate count of each closure round that ran). With
    checkpoint_path the front end is restartable mid-sequence.

    Round 0's global closures run `register_pairs` with RANSAC draws from
    `sampler` when given, else from a `torch.Generator` seeded 0."""
    dev = resolve_device(device)
    capacity = round_up(max(s.shape[0] for s in scans), 2048)
    clouds = [_prep(s, capacity, cfg.voxel_leaf, dev) for s in scans]
    pts = torch.stack([c.points for c in clouds])
    msk = torch.stack([c.mask for c in clouds])
    if cfg.method == "p2pl":
        # radius-covariance normals for all frames at once
        nrms = normals_radius_dense(pts, msk, radius=2.5 * cfg.voxel_leaf)
    else:
        nrms = None

    def pair_icp(cur, cur_n, cur_m, prev, prev_n, prev_m, init):
        if cfg.method == "p2pl":
            return icp_fixed_iters_p2pl(
                cur, cur_m, prev, prev_n, prev_m, init_T=init,
                iters=cfg.icp_iters, dist_thresh=cfg.icp_dist_thresh,
                query_chunk=cfg.query_chunk, trim=cfg.trim, device=dev)
        return icp_fixed_iters(
            cur, cur_m, prev, prev_m, init_T=init, iters=cfg.icp_iters,
            dist_thresh=cfg.icp_dist_thresh, query_chunk=cfg.query_chunk,
            trim=cfg.trim, device=dev)

    def on_dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    n = len(scans)
    frontend = cfg.frontend
    if frontend == "auto":
        frontend = "host" if checkpoint_path else "scan"
    if frontend == "scan":
        deltas_d = odometry_deltas_scan(pts, msk, nrms, iters=cfg.icp_iters,
                                        dist_thresh=cfg.icp_dist_thresh,
                                        query_chunk=cfg.query_chunk,
                                        method=cfg.method, trim=cfg.trim,
                                        submap_frames=cfg.submap_frames)
        poses = compose_deltas(deltas_d).cpu().numpy()
    else:
        poses = [np.eye(4, dtype=np.float32)]
        deltas = [np.eye(4, dtype=np.float32)]
        start = 1
        if checkpoint_path:
            restored = load_odometry_state(checkpoint_path)
            if restored:
                start, poses, deltas = restored
                start += 1
        # rolling scan-to-submap buffer in the previous frame's
        # coordinates, rebuilt from the checkpointed poses on resume
        K = max(1, cfg.submap_frames)
        pts_h, msk_h = pts.cpu().numpy(), msk.cpu().numpy()
        nrm_h = None if nrms is None else nrms.cpu().numpy()

        def rebuild_buf(upto):
            buf = []
            for j in list(range(max(0, upto - K + 1), upto + 1))[::-1]:
                rel = np.linalg.inv(poses[upto]) @ poses[j]
                bp = pts_h[j] @ rel[:3, :3].T + rel[:3, 3]
                bn = None if nrm_h is None else nrm_h[j] @ rel[:3, :3].T
                buf.append((bp.astype(np.float32), bn, msk_h[j]))
            return buf

        buf = rebuild_buf(start - 1)
        for i in range(start, n):
            init = on_dev(deltas[-1])             # constant-velocity prior
            tgt_p = np.concatenate([b[0] for b in buf])
            tgt_n = (None if nrm_h is None
                     else np.concatenate([b[1] for b in buf]))
            tgt_m = np.concatenate([b[2] for b in buf])
            # T maps cur (src) into the prev (dst) frame
            T = pair_icp(pts[i], None if nrms is None else nrms[i], msk[i],
                         on_dev(tgt_p),
                         None if tgt_n is None else on_dev(tgt_n),
                         on_dev(tgt_m), init).cpu().numpy()
            deltas.append(T.astype(np.float32))
            poses.append((poses[-1] @ T).astype(np.float32))
            inv = np.linalg.inv(T).astype(np.float32)
            buf = [(pts_h[i], None if nrm_h is None else nrm_h[i],
                    msk_h[i])] + [
                (bp @ inv[:3, :3].T + inv[:3, 3],
                 None if bn is None else bn @ inv[:3, :3].T, bm)
                for bp, bn, bm in buf[:K - 1]]
            if checkpoint_path and (i % checkpoint_every == 0 or i == n - 1):
                save_odometry_state(checkpoint_path, i, poses, deltas)
        poses = np.stack(poses)

    # keyframes and odometry edges between consecutive keyframes
    kf = list(range(0, n, cfg.keyframe_every))
    if kf[-1] != n - 1:
        kf.append(n - 1)
    kf_poses = poses[kf]
    edges_i, edges_j, T_meas = [], [], []
    for a in range(len(kf) - 1):
        rel = np.linalg.inv(kf_poses[a]) @ kf_poses[a + 1]
        edges_i.append(a)
        edges_j.append(a + 1)
        T_meas.append(rel.astype(np.float32))

    def validate_closures_batch(cand_list, init_arr):
        """Every candidate's closure ICP and fitness in one lockstep batch
        -> (Ts [C,4,4], fits [C]) numpy."""
        ib = torch.tensor([kf[b] for _, b in cand_list], device=dev)
        ia = torch.tensor([kf[a] for a, _ in cand_list], device=dev)
        Ts, fits = _closure_validate_batch(
            pts[ib], msk[ib], None if nrms is None else nrms[ib],
            pts[ia], None if nrms is None else nrms[ia], msk[ia],
            on_dev(init_arr.astype(np.float32)),
            iters=cfg.icp_iters, dist_thresh=cfg.icp_dist_thresh,
            query_chunk=cfg.query_chunk, trim=cfg.closure_trim,
            method=cfg.method,
            validation_dist=cfg.closure_validation_dist)
        return Ts.cpu().numpy().astype(np.float32), fits.cpu().numpy()

    def solve_graph(kf_init, ei, ej, Tm):
        # dense up to ~100 keyframes; block-sparse PCG beyond
        args = (on_dev(kf_init), np.array(ei, np.int64),
                np.array(ej, np.int64), np.stack(Tm))
        if len(kf) <= 100:
            return optimize_pose_graph(
                *args, iters=cfg.pose_graph_iters,
                robust_delta=cfg.robust_delta,
                robust_warmup=cfg.robust_warmup, device=dev)
        return optimize_pose_graph_sparse(
            *args, iters=cfg.pose_graph_iters,
            cg_iters=max(400, 3 * len(kf)), robust_delta=cfg.robust_delta,
            robust_warmup=cfg.robust_warmup, device=dev)

    accepted = {}                 # (a, b) -> T_meas
    rejected = []
    candidates_per_round = []
    kf_cur = kf_poses.copy()
    res = None
    for rnd in range(max(1, cfg.closure_rounds)):
        cands = []
        for a in range(len(kf)):
            for b in range(a + cfg.closure_min_gap + 1, len(kf)):
                if (a, b) in accepted:
                    continue
                d = np.linalg.norm(kf_cur[a][:3, 3] - kf_cur[b][:3, 3])
                if d < cfg.closure_radius:
                    cands.append((a, b))
        candidates_per_round.append(len(cands))

        # round 0: global re-registration of every candidate in one
        # batched register_pairs; later rounds start from the
        # graph-corrected relative pose
        inits = {}
        if cands and rnd == 0 and cfg.closure_init == "global":
            from pctpu_torch.register.pipeline import (RegistrationConfig,
                                                       register_pairs)
            leaf = cfg.voxel_leaf
            rcfg = RegistrationConfig(
                voxel_size=2.0 * leaf, feature_radius=10.0 * leaf,
                normal_radius=4.0 * leaf, ransac_dist=3.0 * leaf,
                ransac_hypotheses=cfg.closure_ransac_hypotheses,
                icp_dist_thresh=5.0 * leaf,
                downsample_capacity=cfg.closure_reg_capacity,
                # closure inits feed the pose graph: the accuracy-oriented
                # ICP budget, not the throughput defaults
                icp_voxel_iters=32, icp_refine_iters=2,
                refine_subsample=4096)
            ib = torch.tensor([kf[b] for _, b in cands], device=dev)
            ia = torch.tensor([kf[a] for a, _ in cands], device=dev)
            ro = register_pairs(
                PointCloud(points=pts[ib], mask=msk[ib]),
                PointCloud(points=pts[ia], mask=msk[ia]), cfg=rcfg,
                sampler=sampler,
                generator=torch.Generator(device=dev).manual_seed(0),
                device=dev)
            Ts_glob = ro.T.cpu().numpy()
            for k, (a, b) in enumerate(cands):
                inits[(a, b)] = Ts_glob[k].astype(np.float32)

        new_accepts = 0
        rejected = []
        if cands:
            init_arr = np.stack([
                inits.get((a, b), np.linalg.inv(kf_cur[a]) @ kf_cur[b])
                for a, b in cands]).astype(np.float32)
            Ts, fits = validate_closures_batch(cands, init_arr)
            for k, (a, b) in enumerate(cands):
                fit = float(fits[k])
                if fit < cfg.closure_min_fitness:
                    rejected.append((a, b, fit))
                    continue
                accepted[(a, b)] = Ts[k]
                new_accepts += 1

        if res is not None and new_accepts == 0:
            break                 # converged: no new information
        ei = edges_i + [a for a, _ in accepted]
        ej = edges_j + [b for _, b in accepted]
        Tm = T_meas + list(accepted.values())
        res = solve_graph(kf_poses, ei, ej, Tm)
        kf_cur = res.poses.cpu().numpy()

    closures = sorted(accepted.keys())
    edges_i = edges_i + [a for a, _ in accepted]
    edges_j = edges_j + [b for _, b in accepted]
    T_meas = T_meas + list(accepted.values())
    kf_opt = kf_cur

    # propagate the keyframe correction to the frames in between
    poses_opt = poses.copy()
    for a in range(len(kf)):
        corr = kf_opt[a] @ np.linalg.inv(kf_poses[a])
        lo = kf[a]
        hi = kf[a + 1] if a + 1 < len(kf) else n
        for f in range(lo, hi):
            poses_opt[f] = (corr @ poses[f]).astype(np.float32)

    return {"poses": poses, "poses_optimized": poses_opt,
            "keyframes": kf, "keyframe_poses": kf_opt,
            "closures": closures, "closures_rejected": rejected,
            "closure_candidates": candidates_per_round,
            "edges": (np.array(edges_i, np.int32),
                      np.array(edges_j, np.int32), np.stack(T_meas)),
            "final_cost": float(res.final_cost)}


def ate(poses: np.ndarray, gt: np.ndarray) -> float:
    """Absolute trajectory error (translation RMSE after aligning frame
    0)."""
    a = np.linalg.inv(poses[0])[None] @ poses
    g = np.linalg.inv(gt[0])[None] @ gt
    err = np.linalg.norm(a[:, :3, 3] - g[:, :3, 3], axis=1)
    return float(np.sqrt(np.mean(err ** 2)))
