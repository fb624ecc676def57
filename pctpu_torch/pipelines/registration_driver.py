"""Registration-dataset driver: solve every pair of a pair list and write
the result file (port of `pctpu/pipelines/registration_driver.py`, the
counterpart of the reference's `Registration/main.py:183-222`).

For each row (idx1 = target, idx2 = source) of the pair list, the source
is registered onto the target and the row `idx1,idx2,t,q_wxyz` is
written. Clouds are padded to one shared capacity. A pair (or a batch)
that raises is isolated: its batchmates are solved one by one, and a
failed pair is written as the identity and counted in `n_failed`.

    python -m pctpu_torch.pipelines.registration_driver --dataset DIR \\
        --pairs PAIRS --output OUT [--gt GT] [--keypoints {all,iss}] \\
        [--device cpu]
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from pctpu_torch.core import io
from pctpu_torch.core.cloud import PointCloud, round_up
from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.register.pipeline import (RegistrationConfig, register_pair,
                                           register_pairs, result_row)


def load_pair_list(path: str) -> List[Tuple[int, int]]:
    rows = io.read_reg_results(path)
    return [(int(r[0]), int(r[1])) for r in rows[1:]]


def run_registration_dataset(dataset_dir: str, pair_list_path: str,
                             output_path: str,
                             cfg: RegistrationConfig = RegistrationConfig(),
                             capacity: Optional[int] = None,
                             limit: Optional[int] = None,
                             batch_size: int = 1,
                             verbose: bool = True,
                             device: DeviceLike = None) -> dict:
    """dataset_dir must hold point_clouds/<idx>.bin (oxford, 6 floats a
    point). `batch_size` > 1 solves the pairs through `register_pairs`,
    `batch_size` pairs at a time (the last batch padded by repeating its
    last pair); a batch that raises falls back to per-pair solves
    (`register_pair`). RANSAC draws: a `torch.Generator` seeded with the
    pair's index (per pair) or its batch's first index (batched)."""
    dev = resolve_device(device)
    pairs = load_pair_list(pair_list_path)
    if limit:
        pairs = pairs[:limit]
    cloud_dir = os.path.join(dataset_dir, "point_clouds")

    if capacity is None:
        sizes = []
        for trg, src in pairs[: min(len(pairs), 20)]:
            for idx in (trg, src):
                p = os.path.join(cloud_dir, f"{idx}.bin")
                sizes.append(os.path.getsize(p) // 24)
        capacity = round_up(int(max(sizes) * 1.1), 4096)

    def load(idx):
        pts, _ = io.read_oxford_bin(os.path.join(cloud_dir, f"{idx}.bin"))
        return PointCloud.from_numpy(pts, capacity=capacity, device=dev)

    def generator(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def solve_one(i, trg, src, results, failed):
        try:
            out = register_pair(load(src), load(trg), cfg=cfg,
                                generator=generator(i), device=dev)
            results.append(result_row(trg, src, out.T))
            if verbose:
                print(f"[{i+1}/{len(pairs)}] {trg},{src}: "
                      f"fitness={float(out.ransac_fitness):.3f} "
                      f"icp_iters={int(out.icp_iters)}")
        except Exception as e:  # per-pair isolation
            failed.append((trg, src, repr(e)))
            results.append((trg, src, np.zeros(3), np.array([1., 0, 0, 0])))

    results, failed = [], []
    if batch_size <= 1:
        for i, (trg, src) in enumerate(pairs):
            solve_one(i, trg, src, results, failed)
    else:
        for b0 in range(0, len(pairs), batch_size):
            chunk = pairs[b0:b0 + batch_size]
            padded = chunk + [chunk[-1]] * (batch_size - len(chunk))
            try:
                srcs = [load(s) for (_, s) in padded]
                trgs = [load(t) for (t, _) in padded]
                sbatch = PointCloud(
                    points=torch.stack([c.points for c in srcs]),
                    mask=torch.stack([c.mask for c in srcs]))
                tbatch = PointCloud(
                    points=torch.stack([c.points for c in trgs]),
                    mask=torch.stack([c.mask for c in trgs]))
                out = register_pairs(sbatch, tbatch, cfg=cfg,
                                     generator=generator(b0), device=dev)
                Ts = out.T.cpu().numpy()
                for j, (trg, src) in enumerate(chunk):
                    results.append(result_row(trg, src, Ts[j]))
                if verbose:
                    print(f"[{b0+len(chunk)}/{len(pairs)}] batch ok, "
                          f"min matches="
                          f"{int(out.num_matches[:len(chunk)].min())}")
            except Exception:  # batch failed: isolate per pair
                for j, (trg, src) in enumerate(chunk):
                    solve_one(b0 + j, trg, src, results, failed)
    io.write_reg_results(output_path, results)
    return {"n_pairs": len(pairs), "n_failed": len(failed), "failed": failed}


def main(argv=None):
    """Solve a pair list over an oxford-format dataset, write the result
    file, and optionally evaluate it against ground truth (evaluate_rt)."""
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", required=True,
                   help="dir containing point_clouds/<idx>.bin")
    p.add_argument("--pairs", required=True, help="pair list file")
    p.add_argument("--output", required=True, help="result file to write")
    p.add_argument("--gt", help="ground-truth result file to evaluate "
                                "against (evaluate_rt)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--limit", type=int)
    p.add_argument("--voxel-size", type=float, default=2.0)
    p.add_argument("--feature-radius", type=float, default=10.0)
    p.add_argument("--normal-radius", type=float, default=4.0)
    p.add_argument("--ransac-dist", type=float, default=4.0)
    p.add_argument("--downsample-capacity", type=int, default=2048)
    p.add_argument("--keypoints", choices=["all", "iss"], default="all",
                   help="matching sites: all voxel points or ISS keypoints")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)

    cfg = RegistrationConfig(voxel_size=args.voxel_size,
                             feature_radius=args.feature_radius,
                             normal_radius=args.normal_radius,
                             ransac_dist=args.ransac_dist,
                             downsample_capacity=args.downsample_capacity,
                             keypoints=args.keypoints)
    res = run_registration_dataset(args.dataset, args.pairs, args.output,
                                   cfg=cfg, limit=args.limit,
                                   batch_size=args.batch_size,
                                   device=args.device)
    print(f"pairs={res['n_pairs']} failed={res['n_failed']}")
    if args.gt:
        from pctpu_torch.register.evaluate import evaluate_rt
        ev = evaluate_rt(args.gt, args.output)
        print(f"success_rate={ev['success_rate']:.4f} "
              f"n_success={ev['n_success']} avg_rte={ev['avg_rte']:.4f} "
              f"avg_rre={ev['avg_rre']:.4f}")
        res["eval"] = ev
    return res


if __name__ == "__main__":
    main()
