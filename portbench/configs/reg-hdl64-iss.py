"""Cell code of the `reg-hdl64-iss` configuration: `configs/reg-hdl64.py`'s
cell (loaded by path: the same pool, entry call, work counts and ICP
stages) with `keypoints="iss"`, so that `register_pairs` matches and runs
RANSAC only at each voxel cloud's ISS keypoints. It also captures the
entry's `keypoint_sites` and judges the sites against the reference's
`iss`.

Traffic keys: as `configs/reg-hdl64.py`'s."""
from __future__ import annotations

import importlib.util
from pathlib import Path

import torch

from portbench.common.draws import sampler_for


def _load_batched_cell():
    path = Path(__file__).with_name("reg-hdl64.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_config_reg_hdl64_for_iss", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_batched = _load_batched_cell()
CAPTURE = _batched.CAPTURE + ("keypoint_sites",)


def _row_share(differ, rows):
    """[B,N] bool rows that differ over [B] row counts -> the widest
    share."""
    share = differ.sum(1).double() / torch.clamp_min(rows.double(), 1.0)
    return float(share.max())


class Cell(_batched.Cell):
    capture = CAPTURE

    def __init__(self, config, traffic, seed, device, reference):
        if config["registration_config"]["keypoints"] != "iss":
            raise ValueError(f"{config['name']}: this cell code judges ISS "
                             "sites; its configuration must set keypoints "
                             "to 'iss'")
        super().__init__(config, traffic, seed, device, reference)

    def _iss(self, pts, msk, tf32=False):
        """The reference's ISS keypoints of voxel clouds [B,N,3], [B,N]."""
        cfg, c = self.cfg, self.config
        return torch.stack([self.ref.iss(
            p, m, cfg["iss_salient_radius"], cfg["iss_nonmax_radius"],
            c["iss_gamma_21"], c["iss_gamma_32"], cfg["iss_min_neighbors"],
            cfg["iss_k_cap"], tf32=tf32) for p, m in zip(pts, msk)])

    # -- correctness -----------------------------------------------------

    def program_stages(self, i: int, cap: dict, out) -> dict:
        st = super().program_stages(i, cap, out)
        st["sites"] = [c[2] for c in cap["keypoint_sites"]]
        return st

    def control_stages(self, i: int, cap: dict = None, out=None) -> dict:
        """The control in the program's place for call i: the reference's
        own chain, ISS included, with its matmul operands in TF32."""
        ref, cfg, dev = self.ref, self.cfg, self.device
        b = self.pool[i % len(self.pool)]
        (sp, sm), (dp, dm) = vox = [ref.voxels(b[side], cfg, dev, tf32=True)
                                    for side in ("src", "dst")]
        feats = [ref.fpfh(p, m, cfg["feature_radius"], cfg["normal_radius"],
                          True) for p, m in vox]
        sites = [self._iss(p, m, tf32=True) for p, m in vox]
        dst_idx, valid = ref.match(feats[0], feats[1], sites[0], sites[1],
                                   tf32=True)
        rT = ref.ransac(sp, ref._rows(dp, dst_idx), valid,
                        sampler_for(self.seed, i, dev), cfg["ransac_dist"],
                        cfg["ransac_hypotheses"], cfg["ransac_m_cap"],
                        tf32=True)
        icp_T, T = self._icp_stages(b, sp, sm, dp, dm, rT, None, tf32=True)
        return dict(vox=vox, feats=feats, sites=sites, dst_idx=dst_idx,
                    valid=valid, ransac_T=rT, icp_T=icp_T, T=T)

    def judge(self, i: int, st: dict) -> dict:
        """`configs/reg-hdl64.py`'s judge, with the sites judged and
        matching fed them:
          site_gap  the reference's ISS from the judged voxel clouds, the
              share of a cloud's valid voxels whose keypoint flag differs,
              the widest cloud;
          match_gap  the mutual matches from the judged descriptors over
              the judged sites (not the voxel masks), the share of rows
              that differ, the widest pair.
        Reported beside them, not compared: `keypoints_max` and
        `matches_max`, the most keypoints of a cloud and mutual matches of
        a pair, and `keypoints_min_neg` and `matches_min_neg`, the fewest,
        negated (a run keeps the largest of each number over its judged
        calls)."""
        out = super().judge(i, st)     # its match_gap, over the voxel
        site_gap = 0.0                 # masks, is replaced below
        for (pts, msk), sites in zip(st["vox"], st["sites"]):
            r_sites = self._iss(pts, msk)
            site_gap = max(site_gap, _row_share((r_sites != sites) & msk,
                                                msk.sum(1)))
        r_idx, r_valid = self.ref.match(st["feats"][0], st["feats"][1],
                                        *st["sites"])
        differ = (r_valid != st["valid"]) | (r_valid
                                             & (r_idx != st["dst_idx"]))
        kps = torch.cat([s.sum(1) for s in st["sites"]]).double()
        matches = st["valid"].sum(1).double()
        out.update(site_gap=site_gap,
                   match_gap=_row_share(differ, r_valid.sum(1)),
                   keypoints_max=float(kps.max()),
                   keypoints_min_neg=-float(kps.min()),
                   matches_max=float(matches.max()),
                   matches_min_neg=-float(matches.min()))
        return out
