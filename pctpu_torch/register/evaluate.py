"""Registration evaluation — RTE/RRE success criterion: the port's own
numpy copy of `pctpu/register/evaluate.py`.

Parity with `Registration/registration_dataset/evaluate_rt.py:16-18,77-112`:
success iff RTE < 2.0 m AND RRE < 5.0 deg; the script reports the success
rate plus average RTE/RRE over the successes (the reference divides the
success rate by the row count *including* the header — preserved for
number-for-number parity).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from pctpu_torch.core import io

RTE_THRESH = 2.0
RRE_THRESH = 5.0


def pose_from_row(row: List[str]) -> Tuple[int, int, np.ndarray]:
    """Result row -> (idx1, idx2, 4x4 pose). Row quaternion is (w,x,y,z)."""
    from scipy.spatial.transform import Rotation
    idx1, idx2 = int(row[0]), int(row[1])
    t = np.array([float(x) for x in row[2:5]])
    qw, qx, qy, qz = (float(x) for x in row[5:9])
    P = np.eye(4)
    P[:3, :3] = Rotation.from_quat([qx, qy, qz, qw]).as_matrix()
    P[:3, 3] = t
    return idx1, idx2, P


def rte_rre(P_pred: np.ndarray, P_gt: np.ndarray) -> Tuple[float, float]:
    from scipy.spatial.transform import Rotation
    P_diff = np.linalg.inv(P_pred) @ P_gt
    rte = float(np.linalg.norm(P_diff[:3, 3]))
    rre = float(np.sum(np.abs(
        Rotation.from_matrix(P_diff[:3, :3]).as_euler("xyz", degrees=True))))
    return rte, rre


def is_successful(P_pred: np.ndarray, P_gt: np.ndarray):
    rte, rre = rte_rre(P_pred, P_gt)
    return rte < RTE_THRESH and rre < RRE_THRESH, rte, rre


def evaluate_rt(gt_path: str, pred_path: str, verbose: bool = False) -> Dict:
    """File-level evaluation, reference-parity (evaluate_rt.py:77-112)."""
    gt_rows = io.read_reg_results(gt_path)
    pred_rows = io.read_reg_results(pred_path)
    assert len(gt_rows) == len(pred_rows)
    n_success = 0
    rte_sum = rre_sum = 0.0
    for gt_row, pred_row in zip(gt_rows[1:], pred_rows[1:]):
        g1, g2, P_gt = pose_from_row(gt_row)
        p1, p2, P_pred = pose_from_row(pred_row)
        assert (g1, g2) == (p1, p2)
        ok, rte, rre = is_successful(P_pred, P_gt)
        if ok:
            n_success += 1
            rte_sum += rte
            rre_sum += rre
            if verbose:
                print(pred_row)
    # reference divides by len including header (evaluate_rt.py:106)
    rate = n_success / len(gt_rows)
    avg_rte = rte_sum / max(n_success, 1)
    avg_rre = rre_sum / max(n_success, 1)
    return {"success_rate": rate, "n_success": n_success,
            "avg_rte": avg_rte, "avg_rre": avg_rre}
