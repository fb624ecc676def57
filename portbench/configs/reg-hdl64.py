"""Cell code of the `reg-hdl64` configuration: builds a cell's pool of
registration pairs from the seed, calls the port's `register_pairs` on
it, and judges what the calls produced against the plain reference.

Traffic keys: `entry` ("register_pairs"), `batch` (pairs a call),
`pool_batches` (calls in the pool, cycled), `warmup_calls`,
`check_calls` (calls judged, drawn from the seed over the window),
`trace_calls` (calls profiled in a traced run) and `limits` (one per
number that `correct` compares)."""
from __future__ import annotations

import numpy as np
import torch

from portbench.common import generators as gen
from portbench.common import work
from portbench.common.draws import sampler_for
from portbench.common.plain_geometry import point_gap, point_gaps

ENTRY = "register_pairs"
ENTRY_MODULE = "pctpu_torch.register.pipeline"
# the stage outputs `correct` compares, as named in the entry's module
CAPTURE = ("voxel_downsample_capped", "fpfh_fused", "match_features",
           "ransac_registration_batch", "icp_fixed_iters_banded_mega_batch",
           "_refine_exact_batch")


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
        self.rc = pipe.RegistrationConfig(**self.cfg)
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.ref = seed, torch.device(device), reference
        self.batch = int(traffic["batch"])
        # one fixed scan, registered against its moved copy, as the
        # reference registers a KITTI scan against itself; the seed draws
        # each pair's point order, its noise and RANSAC's draws
        scan = gen.lidar_scan(gen.seed_sequence(config["scene_seed"], 0),
                              n_points=int(config["scan_points"]),
                              height=config["scan_height_m"],
                              max_range=config["scan_range_m"])
        rng = gen.seed_sequence(seed, 1)
        self.pool = []
        for _ in range(int(traffic["pool_batches"])):
            src, dst, gt = gen.make_pairs(
                scan, rng, self.batch, len(scan), config["pair_rotvec_rad"],
                config["pair_translation_m"], config["pair_noise_m"])
            mask = torch.ones(src.shape[:2], dtype=torch.bool)
            self.pool.append(dict(
                src=src, dst=dst, gt=gt,
                src_pc=PointCloud(torch.from_numpy(src), mask),
                dst_pc=PointCloud(torch.from_numpy(dst), mask)))
        self.units_per_call = self.batch
        self._voxel_counts = {}

    # -- the timed path --------------------------------------------------

    def call(self, i: int):
        b = self.pool[i % len(self.pool)]
        return self.pipe.register_pairs(
            b["src_pc"], b["dst_pc"], self.rc,
            sampler=sampler_for(self.seed, i, self.device),
            device=self.device)

    def final_pose(self, out) -> torch.Tensor:
        return out.T

    def failed(self, poses: dict) -> int:
        """Pairs whose final pose misses the success bound."""
        bound = self.config["success_bound"]
        bad = 0
        for i, T in poses.items():
            rte, rre = gen.rte_rre(T, self.pool[i % len(self.pool)]["gt"])
            bad += int(np.sum((rte >= bound["rte_m"])
                              | (rre >= bound["rre_deg"])))
        return bad

    # -- work, for the rooflines -----------------------------------------

    def _voxels(self, i: int):
        """The valid voxel counts of pool batch i's clouds, [2][B], worked
        out from the raw clouds."""
        k = i % len(self.pool)
        if k not in self._voxel_counts:
            b, cfg = self.pool[k], self.cfg
            self._voxel_counts[k] = [
                [min(self.ref.voxel_capped(
                    torch.from_numpy(c).to(self.device), cfg["voxel_size"],
                    1)[2], cfg["downsample_capacity"]) for c in b[side]]
                for side in ("src", "dst")]
        return self._voxel_counts[k]

    def work(self, calls) -> dict:
        """The ICP stage's 1-NN work over `calls`, from the pool's shapes
        and the configuration: the voxel ICP's exact associations of the
        voxel clouds' valid points, the refine subsample's against the
        full target, the stats subsample's."""
        cfg = self.cfg
        flops = nbytes = 0.0
        for i in calls:
            b = self.pool[i % len(self.pool)]
            n_src, n_dst = b["src"].shape[1], b["dst"].shape[1]
            sub = [len(range(0, n_src, max(1, n_src // m))[:m])
                   for m in (cfg["refine_subsample"], cfg["stats_subsample"])]
            for nv_s, nv_d in zip(*self._voxels(i)):
                for q, n, it in ((nv_s, nv_d, cfg["icp_voxel_iters"]),
                                 (sub[0], n_dst, cfg["icp_refine_iters"]),
                                 (sub[1], n_dst, 1)):
                    f, by = work.nn1_work(q, n, it)
                    flops += f
                    nbytes += by
        return {"icp": {"flops": flops, "bytes": nbytes}}

    # -- correctness -----------------------------------------------------

    def program_stages(self, i: int, cap: dict, out) -> dict:
        """The captured stage outputs of call i, in the judge's terms."""
        def outs(name):
            return [c[2] for c in cap[name]]

        m = outs("match_features")[0]
        (sdown, _), (ddown, _) = outs("voxel_downsample_capped")
        return dict(vox=[(sdown.points, sdown.mask),
                         (ddown.points, ddown.mask)],
                    feats=outs("fpfh_fused"), dst_idx=m.dst_idx.long(),
                    valid=m.valid,
                    ransac_T=outs("ransac_registration_batch")[0].T,
                    icp_T=outs("icp_fixed_iters_banded_mega_batch")[0],
                    T=out.T)

    def control_stages(self, i: int, cap: dict = None, out=None) -> dict:
        """The control in the program's place for call i: the reference's
        own chain with its matmul operands in TF32 (it needs nothing of
        the program's call)."""
        ref, cfg, dev = self.ref, self.cfg, self.device
        b = self.pool[i % len(self.pool)]
        (sp, sm), (dp, dm) = vox = [ref.voxels(b[side], cfg, dev, tf32=True)
                                    for side in ("src", "dst")]
        feats = [ref.fpfh(p, m, cfg["feature_radius"], cfg["normal_radius"],
                          True) for p, m in vox]
        dst_idx, valid = ref.match(feats[0], feats[1], sm, dm, tf32=True)
        rT = ref.ransac(sp, ref._rows(dp, dst_idx), valid,
                        sampler_for(self.seed, i, dev), cfg["ransac_dist"],
                        cfg["ransac_hypotheses"], cfg["ransac_m_cap"],
                        tf32=True)
        icp_T, T = self._icp_stages(b, sp, sm, dp, dm, rT, None, tf32=True)
        return dict(vox=vox, feats=feats, dst_idx=dst_idx, valid=valid,
                    ransac_T=rT, icp_T=icp_T, T=T)

    def _icp_stages(self, b, sp, sm, dp, dm, init_T, mid_T, tf32=False):
        """register_pairs' two ICP stages: the voxel-cloud ICP from init_T,
        then the refine of the strided full-resolution source subsample
        against the full target (exact association in the reference), from
        mid_T, or from the first stage's own result when None."""
        ref, cfg, dev = self.ref, self.cfg, self.device
        q = torch.from_numpy(np.ascontiguousarray(
            ref.refine_inputs(b["src"], cfg))).to(dev)
        d = torch.from_numpy(b["dst"]).to(dev)
        icp_T, T = [], []
        for k in range(self.batch):
            t1 = ref.icp(sp[k], sm[k], dp[k], dm[k], init_T[k],
                         cfg["icp_voxel_iters"], cfg["icp_dist_thresh"],
                         tf32)
            start = t1 if mid_T is None else mid_T[k]
            t2 = ref.icp(q[k], torch.ones_like(q[k][:, 0], dtype=torch.bool),
                         d[k], torch.ones_like(d[k][:, 0], dtype=torch.bool),
                         start, cfg["icp_refine_iters"],
                         cfg["icp_dist_thresh"], tf32)
            icp_T.append(t1)
            T.append(t2)
        return torch.stack(icp_T), torch.stack(T)

    def judge(self, i: int, st: dict) -> dict:
        """One call's stages (the program's or the control's) against the
        float32 reference, each reference stage fed what the judged side's
        previous stage produced, the first fed the raw clouds:
          voxel_gap_m, voxel_gap_mean_m  the voxel clouds' centroid gap
              (m), the widest and the mean over the call's voxels; a voxel
              set that differs reads inf;
          feat_gap  the descriptors from the judged voxel clouds, the mean
              absolute gap of a cloud's valid rows, the widest cloud;
          match_gap  the mutual matches from the judged descriptors, the
              share of rows that differ, the widest pair;
          ransac_gap_m  RANSAC from the judged matches with the call's
              draws;
          icp_gap_m, icp_gap_median_m  the voxel ICP from the judged
              RANSAC pose, the widest pair and the median pair;
          refine_gap_m  the refine from the judged voxel ICP's pose.
        A pose gap is the widest distance between where the two poses put
        a point of the pair's source cloud (m), the widest pair unless
        said otherwise."""
        ref, cfg, dev = self.ref, self.cfg, self.device
        b = self.pool[i % len(self.pool)]
        feat_gap = 0.0
        vox_gaps = []
        for side, (pts, msk), feats in zip(("src", "dst"), st["vox"],
                                           st["feats"]):
            rp, rm = ref.voxels(b[side], cfg, dev)
            rf = ref.fpfh(pts, msk, cfg["feature_radius"],
                          cfg["normal_radius"])
            for k in range(self.batch):
                mk = msk[k]
                if torch.equal(mk, rm[k]):
                    vox_gaps.append(torch.linalg.vector_norm(
                        pts[k][mk].float() - rp[k][mk], dim=-1))
                else:
                    vox_gaps.append(torch.full((1,), float("inf"),
                                               device=dev))
                feat_gap = max(feat_gap, float(torch.mean(torch.abs(
                    feats[k][mk].float() - rf[k][mk]))))
        vox_gaps = torch.cat(vox_gaps).double()
        (sp, sm), (dp, dm) = st["vox"]
        r_idx, r_valid = ref.match(st["feats"][0], st["feats"][1], sm, dm)
        differ = (r_valid != st["valid"]) | (r_valid
                                             & (r_idx != st["dst_idx"]))
        share = differ.sum(1).double() / torch.clamp_min(
            r_valid.sum(1).double(), 1.0)
        rT = ref.ransac(sp, ref._rows(dp, st["dst_idx"]), st["valid"],
                        sampler_for(self.seed, i, dev), cfg["ransac_dist"],
                        cfg["ransac_hypotheses"], cfg["ransac_m_cap"])
        icp_T, T = self._icp_stages(b, sp, sm, dp, dm, st["ransac_T"],
                                    st["icp_T"])
        src = torch.from_numpy(b["src"]).to(dev)
        icp_gaps = point_gaps(st["icp_T"], icp_T, src)
        return {"voxel_gap_m": float(vox_gaps.max()),
                "voxel_gap_mean_m": float(vox_gaps.mean()),
                "feat_gap": feat_gap,
                "match_gap": float(share.max()),
                "ransac_gap_m": point_gap(st["ransac_T"], rT, src),
                "icp_gap_m": float(icp_gaps.max()),
                "icp_gap_median_m": float(torch.median(icp_gaps)),
                "refine_gap_m": point_gap(st["T"], T, src)}
