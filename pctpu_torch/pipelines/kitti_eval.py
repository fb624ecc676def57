"""KITTI object-detection AP evaluation (offline, self-contained).

The reference delegates this to the empty `prclibo/kitti_eval` submodule
(`ObjectDetection_Kitti/.gitmodules:5-7`, used per
`Final_Project/README.md:232-239`). Implemented here natively: the standard
KITTI protocol — difficulty bins (easy/moderate/hard via bbox height,
occlusion, truncation), greedy score-ordered matching at class IoU
thresholds (0.7 car / 0.5 pedestrian+cyclist), and R40 interpolated average
precision — for 2D-bbox, BEV, and full oriented-3D IoU.

The port's numpy copy of `pctpu/pipelines/kitti_eval.py`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

IOU_THRESH = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}

# official devkit: GT of a neighboring class is IGNORED for the class under
# evaluation — a detection matching it is neither TP nor FP
# (capability spec: Final_Project/README.md:232-239 -> prclibo/kitti_eval)
NEIGHBOR_CLASSES = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}

# difficulty: (min bbox height px, max occlusion, max truncation)
DIFFICULTY = {
    "easy": (40.0, 0, 0.15),
    "moderate": (25.0, 1, 0.30),
    "hard": (25.0, 2, 0.50),
}


@dataclasses.dataclass
class Box:
    type: str
    truncated: float
    occluded: int
    bbox: np.ndarray      # [4] left, top, right, bottom
    dims: np.ndarray      # [3] h, w, l
    loc: np.ndarray       # [3] cam-frame x, y, z (bottom center)
    ry: float
    score: float = -1.0


def parse_label_file(path: str, with_score: bool = False) -> List[Box]:
    boxes = []
    with open(path) as f:
        for line in f:
            p = line.split()
            if len(p) < 15:
                continue
            boxes.append(Box(
                type=p[0], truncated=float(p[1]), occluded=int(float(p[2])),
                bbox=np.array([float(x) for x in p[4:8]]),
                dims=np.array([float(x) for x in p[8:11]]),
                loc=np.array([float(x) for x in p[11:14]]),
                ry=float(p[14]),
                score=float(p[15]) if (with_score and len(p) > 15) else -1.0))
    return boxes


def bbox2d_iou(a: np.ndarray, b: np.ndarray) -> float:
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    inter = ix * iy
    ua = (a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter
    return inter / max(ua, 1e-9)


def _bev_corners(box: Box) -> np.ndarray:
    """[4,2] oriented footprint corners in the cam x-z plane."""
    _, w, l = box.dims
    c, s = np.cos(box.ry), np.sin(box.ry)
    xs = np.array([l / 2, l / 2, -l / 2, -l / 2])
    zs = np.array([w / 2, -w / 2, -w / 2, w / 2])
    x = c * xs + s * zs + box.loc[0]
    z = -s * xs + c * zs + box.loc[2]
    return np.stack([x, z], axis=1)


def _cross2(a: np.ndarray, b: np.ndarray) -> float:
    return a[0] * b[1] - a[1] * b[0]


def _polygon_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland-Hodgman convex clip ([N,2] x [M,2] -> [K,2])."""
    out = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        edge = b - a
        inp, out = out, []
        if not inp:
            break
        for j in range(len(inp)):
            p, q = inp[j], inp[(j + 1) % len(inp)]
            p_in = _cross2(edge, p - a) >= 0
            q_in = _cross2(edge, q - a) >= 0
            if p_in:
                out.append(p)
            if p_in != q_in:
                d = q - p
                denom = _cross2(edge, d)
                t = _cross2(edge, a - p) / denom if abs(denom) > 1e-12 else 0.0
                out.append(p + t * d)
    return np.asarray(out)


def _polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def bev_iou(a: Box, b: Box) -> float:
    ca, cb = _bev_corners(a), _bev_corners(b)
    # ensure counter-clockwise ordering for the clipper
    def ccw(c):
        return c if _signed_area(c) > 0 else c[::-1]
    inter = _polygon_area(_polygon_clip(ccw(ca), ccw(cb)))
    ar_a = a.dims[1] * a.dims[2]
    ar_b = b.dims[1] * b.dims[2]
    return inter / max(ar_a + ar_b - inter, 1e-9)


def _signed_area(poly: np.ndarray) -> float:
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * (np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def iou3d(a: Box, b: Box) -> float:
    ca, cb = _bev_corners(a), _bev_corners(b)
    def ccw(c):
        return c if _signed_area(c) > 0 else c[::-1]
    inter_bev = _polygon_area(_polygon_clip(ccw(ca), ccw(cb)))
    # KITTI y points down; box spans [y-h, y]
    ya0, ya1 = a.loc[1] - a.dims[0], a.loc[1]
    yb0, yb1 = b.loc[1] - b.dims[0], b.loc[1]
    ih = max(0.0, min(ya1, yb1) - max(ya0, yb0))
    inter = inter_bev * ih
    va = a.dims[0] * a.dims[1] * a.dims[2]
    vb = b.dims[0] * b.dims[1] * b.dims[2]
    return inter / max(va + vb - inter, 1e-9)


def _gt_in_difficulty(gt: Box, difficulty: str) -> bool:
    min_h, max_occ, max_trunc = DIFFICULTY[difficulty]
    h = gt.bbox[3] - gt.bbox[1]
    return (h >= min_h and gt.occluded <= max_occ
            and gt.truncated <= max_trunc)


def _dontcare_overlap(det: Box, dc: Box) -> float:
    """Official devkit criterion for DontCare regions: 2D intersection over
    the DETECTION's area (boxoverlap criterion=1), not IoU."""
    a, b = det.bbox, dc.bbox
    ix = max(0.0, min(a[2], b[2]) - max(a[0], b[0]))
    iy = max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
    area = max((a[2] - a[0]) * (a[3] - a[1]), 1e-9)
    return ix * iy / area


def _match_frame(gts: List[Box], dets: List[Box], cls: str,
                 difficulty: str, metric) -> Tuple[List[Tuple[float, bool]],
                                                   int]:
    """Greedy best-IoU matching with the official ignore semantics:

    - GT failing the difficulty gate, or of a NEIGHBORING class (Van for
      Car, Person_sitting for Pedestrian): matched detections are neither
      TP nor FP.
    - unmatched detections overlapping a DontCare region (intersection /
      detection area >= the class threshold) are neither TP nor FP.
    - unmatched detections whose 2D bbox is shorter than the difficulty's
      min height are ignored, not FP (they could never match a valid GT).

    Returns ([(score, is_tp)], n_valid_gt).
    """
    thresh = IOU_THRESH.get(cls, 0.5)
    min_h = DIFFICULTY[difficulty][0]
    neighbors = NEIGHBOR_CLASSES.get(cls, ())
    gts_cls = [g for g in gts if g.type == cls or g.type in neighbors]
    valid = [g.type == cls and _gt_in_difficulty(g, difficulty)
             for g in gts_cls]
    dontcare = [g for g in gts if g.type == "DontCare"]
    dets_cls = sorted([d for d in dets if d.type == cls],
                      key=lambda d: -d.score)
    taken = [False] * len(gts_cls)
    out = []
    for d in dets_cls:
        # prefer a valid GT when both a valid and an ignored GT clear the
        # threshold (the devkit assigns TPs from valid GT first)
        best_v, best_vi = 0.0, -1
        best_x, best_xi = 0.0, -1
        for i, g in enumerate(gts_cls):
            if taken[i]:
                continue
            v = metric(d, g)
            if valid[i]:
                if v > best_v:
                    best_v, best_vi = v, i
            elif v > best_x:
                best_x, best_xi = v, i
        if best_v >= thresh:
            taken[best_vi] = True
            out.append((d.score, True))
        elif best_x >= thresh:
            taken[best_xi] = True
            # matched an ignored GT: neither TP nor FP
        elif any(_dontcare_overlap(d, dc) >= thresh for dc in dontcare):
            pass  # inside a DontCare region: neither TP nor FP
        elif (d.bbox[3] - d.bbox[1]) < min_h:
            pass  # too small to ever match a valid GT at this difficulty
        else:
            out.append((d.score, False))
    return out, sum(valid)


def average_precision_r40(scored: List[Tuple[float, bool]],
                          n_gt: int) -> float:
    """R40 interpolated AP: mean of max-precision at 40 recall samples."""
    if n_gt == 0:
        return float("nan")
    scored = sorted(scored, key=lambda x: -x[0])
    tps = np.cumsum([1.0 if t else 0.0 for _, t in scored])
    fps = np.cumsum([0.0 if t else 1.0 for _, t in scored])
    recall = tps / n_gt
    precision = tps / np.maximum(tps + fps, 1e-9)
    ap = 0.0
    for r in np.linspace(1.0 / 40, 1.0, 40):
        mask = recall >= r
        ap += np.max(precision[mask]) if mask.any() else 0.0
    return ap / 40.0


def evaluate_detections(gt_files: Sequence[str], det_files: Sequence[str],
                        classes: Sequence[str] = ("Car", "Pedestrian",
                                                  "Cyclist"),
                        metric: str = "bev") -> Dict[str, Dict[str, float]]:
    """Frame-aligned GT/detection label files -> AP per class x difficulty.

    metric: 'bbox' (2D image IoU), 'bev', or '3d'.
    """
    metric_fn = {"bbox": lambda d, g: bbox2d_iou(d.bbox, g.bbox),
                 "bev": bev_iou, "3d": iou3d}[metric]
    frames = [(parse_label_file(g), parse_label_file(d, with_score=True))
              for g, d in zip(gt_files, det_files)]
    results: Dict[str, Dict[str, float]] = {}
    for cls in classes:
        results[cls] = {}
        for diff in DIFFICULTY:
            scored, n_gt = [], 0
            for gts, dets in frames:
                s, n = _match_frame(gts, dets, cls, diff, metric_fn)
                scored += s
                n_gt += n
            results[cls][diff] = average_precision_r40(scored, n_gt)
    return results
