"""Cell code of the `reg-hdl64-single` configuration: builds a cell's pool
of single registration pairs from the seed, calls the port's
`register_pair` on one pair a call, and judges what the calls produced
against the plain reference.

Traffic keys: `entry` ("register_pair"), `pool_pairs` (pairs in the
pool, cycled), `warmup_calls`, `check_calls` (calls judged, drawn from the
seed over the window), `trace_calls` (calls profiled in a traced run) and
`limits` (one per number that `correct` compares)."""
from __future__ import annotations

import torch

from portbench.common import generators as gen
from portbench.common import work
from portbench.common.draws import sampler_for
from portbench.common.plain_geometry import point_gap
from portbench.common.work_windowed import windowed_nn1_work

ENTRY = "register_pair"
ENTRY_MODULE = "pctpu_torch.register.pipeline"
# kernel 5's launches, the windowed phase's then the exact phase's
MEGA = "pctpu_torch.ops.pallas_icp_mega:icp_mega"
# the stage outputs `correct` compares, as named in the entry's module
CAPTURE = ("_cap_uniform", "fpfh", "match_features", "ransac_registration",
           MEGA, "_icp_stats")


class Cell:
    unit = "pairs"
    capture = CAPTURE

    def __init__(self, config: dict, traffic: dict, seed: int, device,
                 reference):
        if traffic["entry"] != ENTRY:
            raise ValueError(f"{config['name']}: this cell code calls {ENTRY}, "
                             f"not {traffic['entry']!r}")
        import importlib
        pipe = importlib.import_module(ENTRY_MODULE)
        from pctpu_torch.core.cloud import PointCloud
        self.pipe = pipe
        self.cfg = config["registration_config"]
        self.k5 = config["kernel5"]
        self.rc = pipe.RegistrationConfig(**self.cfg)
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.ref = seed, torch.device(device), reference
        # one fixed scan, registered against its moved copy; the seed draws
        # each pair's point order, its noise and RANSAC's draws
        scan = gen.lidar_scan(gen.seed_sequence(config["scene_seed"], 0),
                              n_points=int(config["scan_points"]),
                              height=config["scan_height_m"],
                              max_range=config["scan_range_m"])
        src, dst, gt = gen.make_pairs(
            scan, gen.seed_sequence(seed, 1), int(traffic["pool_pairs"]),
            len(scan), config["pair_rotvec_rad"],
            config["pair_translation_m"], config["pair_noise_m"])
        mask = torch.ones(src.shape[1], dtype=torch.bool)
        self.pool = [dict(src=s, dst=d, gt=g,
                          src_pc=PointCloud(torch.from_numpy(s), mask),
                          dst_pc=PointCloud(torch.from_numpy(d), mask))
                     for s, d, g in zip(src, dst, gt)]
        self.units_per_call = 1

    def _pair(self, i: int) -> dict:
        return self.pool[i % len(self.pool)]

    # -- the timed path --------------------------------------------------

    def call(self, i: int):
        p = self._pair(i)
        return self.pipe.register_pair(
            p["src_pc"], p["dst_pc"], self.rc,
            sampler=sampler_for(self.seed, i, self.device),
            device=self.device)

    def final_pose(self, out) -> torch.Tensor:
        return out.T

    def failed(self, poses: dict) -> int:
        """Pairs whose final pose misses the success bound."""
        bound = self.config["success_bound"]
        bad = 0
        for i, T in poses.items():
            rte, rre = gen.rte_rre(T, self._pair(i)["gt"])
            bad += int((rte >= bound["rte_m"]) or (rre >= bound["rre_deg"]))
        return bad

    # -- work, for the rooflines -----------------------------------------

    def work(self, calls) -> dict:
        """The ICP stage's 1-NN work over `calls`, from the pairs' shapes
        and the configuration: kernel 5's windowed iterations (every valid
        source point against its window of `window_blocks` blocks), its
        exact ones and the stats' pass (every valid source point against
        every valid target point)."""
        cfg, k5 = self.cfg, self.k5
        flops = nbytes = 0.0
        for i in calls:
            p = self._pair(i)
            q, n = len(p["src"]), len(p["dst"])
            for f, by in (windowed_nn1_work(
                    q, n, k5["window_blocks"] * k5["block"],
                    cfg["icp_fixed_coarse"]),
                    work.nn1_work(q, n, cfg["icp_fixed_polish"]),
                    work.nn1_work(q, n, 1)):
                flops += f
                nbytes += by
        return {"icp": {"flops": flops, "bytes": nbytes}}

    # -- correctness -----------------------------------------------------

    def program_stages(self, i: int, cap: dict, out) -> dict:
        """The captured stage outputs of call i, in the judge's terms."""
        def outs(name):
            return [c[2] for c in cap[name]]

        (sdown, _), (ddown, _) = outs("_cap_uniform")
        m = outs("match_features")[0]
        coarse_T, polish_T = outs(MEGA)
        return dict(vox=[(sdown.points, sdown.mask),
                         (ddown.points, ddown.mask)],
                    feats=outs("fpfh"), dst_idx=m.dst_idx.long(),
                    valid=m.valid,
                    ransac_T=outs("ransac_registration")[0].T,
                    coarse_T=coarse_T, T=polish_T,
                    rmse=float(outs("_icp_stats")[0][1]))

    def control_stages(self, i: int, cap: dict = None, out=None) -> dict:
        """The control in the program's place for call i: the reference's
        own chain with its matmul operands in TF32 (it needs nothing of
        the program's call)."""
        ref, cfg, k5, dev = self.ref, self.cfg, self.k5, self.device
        p = self._pair(i)
        (sp, sm, _), (dp, dm, _) = vox = [ref.voxels(p[side], cfg, dev,
                                                     tf32=True)
                                          for side in ("src", "dst")]
        feats = [ref.fpfh(pts, msk, cfg, tf32=True) for pts, msk, _ in vox]
        dst_idx, valid = ref.match(feats[0], feats[1], sm, dm, tf32=True)
        rT = ref.ransac(sp, dp[dst_idx], valid,
                        sampler_for(self.seed, i, dev), cfg, tf32=True)
        src, dst, ones = self._clouds(p)
        lay = ref.layout(src, ones, dst, ones, rT, k5["block"],
                         k5["query_tile"], tf32=True)
        coarse_T = ref.icp_kernel5(lay, rT, cfg["icp_fixed_coarse"],
                                   k5["window_blocks"],
                                   cfg["icp_dist_thresh"], tf32=True)
        T = ref.icp_kernel5(lay, coarse_T, cfg["icp_fixed_polish"],
                            lay["nb"], cfg["icp_dist_thresh"], tf32=True)
        _, rmse = ref.icp_stats(T, src, ones, dst, ones,
                                cfg["icp_dist_thresh"], tf32=True)
        return dict(vox=[(sp, sm), (dp, dm)], feats=feats, dst_idx=dst_idx,
                    valid=valid, ransac_T=rT, coarse_T=coarse_T, T=T,
                    rmse=rmse)

    def _clouds(self, p):
        dev = self.device
        src = torch.from_numpy(p["src"]).to(dev)
        return (src, torch.from_numpy(p["dst"]).to(dev),
                torch.ones(src.shape[0], dtype=torch.bool, device=dev))

    def judge(self, i: int, st: dict) -> dict:
        """One call's stages (the program's or the control's) against the
        float32 reference, each reference stage fed what the judged side's
        previous stage produced, the first fed the raw clouds:
          voxel_gap_m, voxel_gap_mean_m  the voxel clouds' centroid gap
              (m), the widest and the mean over the call's voxels; a voxel
              set that differs reads inf;
          feat_gap  the descriptors from the judged voxel clouds, the mean
              absolute gap of a cloud's valid rows, the wider cloud;
          match_gap  the mutual matches from the judged descriptors, the
              share of rows that differ;
          ransac_gap_m  RANSAC from the judged matches with the call's
              draws;
          coarse_gap_m  kernel 5's windowed iterations from the judged
              RANSAC pose (the layout ordered by that pose);
          polish_gap_m  its exact iterations from the judged windowed
              pose, on the same layout;
          rmse_gap_m  the stats' RMSE (m) at the judged final pose.
        A pose gap is the widest distance between where the two poses put
        a point of the pair's source cloud (m)."""
        ref, cfg, k5, dev = self.ref, self.cfg, self.k5, self.device
        p = self._pair(i)
        feat_gap = 0.0
        vox_gaps = []
        for side, (pts, msk), feats in zip(("src", "dst"), st["vox"],
                                           st["feats"]):
            rp, rm, _ = ref.voxels(p[side], cfg, dev)
            if torch.equal(msk, rm):
                vox_gaps.append(torch.linalg.vector_norm(
                    pts[msk].float() - rp[msk], dim=-1))
            else:
                vox_gaps.append(torch.full((1,), float("inf"), device=dev))
            rf = ref.fpfh(pts, msk, cfg)
            feat_gap = max(feat_gap, float(torch.mean(torch.abs(
                feats[msk].float() - rf[msk]))))
        vox_gaps = torch.cat(vox_gaps).double()
        (sp, sm), (dp, dm) = st["vox"]
        r_idx, r_valid = ref.match(st["feats"][0], st["feats"][1], sm, dm)
        differ = (r_valid != st["valid"]) | (r_valid
                                             & (r_idx != st["dst_idx"]))
        share = float(differ.sum()) / max(float(r_valid.sum()), 1.0)
        rT = ref.ransac(sp, dp[st["dst_idx"]], st["valid"],
                        sampler_for(self.seed, i, dev), cfg)
        src, dst, ones = self._clouds(p)
        lay = ref.layout(src, ones, dst, ones, st["ransac_T"], k5["block"],
                         k5["query_tile"])
        coarse_T = ref.icp_kernel5(lay, st["ransac_T"],
                                   cfg["icp_fixed_coarse"],
                                   k5["window_blocks"],
                                   cfg["icp_dist_thresh"])
        T = ref.icp_kernel5(lay, st["coarse_T"], cfg["icp_fixed_polish"],
                            lay["nb"], cfg["icp_dist_thresh"])
        _, rmse = ref.icp_stats(st["T"], src, ones, dst, ones,
                                cfg["icp_dist_thresh"])
        return {"voxel_gap_m": float(vox_gaps.max()),
                "voxel_gap_mean_m": float(vox_gaps.mean()),
                "feat_gap": feat_gap,
                "match_gap": share,
                "ransac_gap_m": point_gap(st["ransac_T"], rT, src),
                "coarse_gap_m": point_gap(st["coarse_T"], coarse_T, src),
                "polish_gap_m": point_gap(st["T"], T, src),
                "rmse_gap_m": abs(st["rmse"] - rmse)}
