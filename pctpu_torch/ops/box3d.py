"""Rotated 3D-box ops: BEV and 3D IoU, rotated NMS, ROI point pooling
(port of `pctpu/ops/box3d.py`, the PointRCNN `iou3d` / `roipool3d`
ops). Every pairwise intersection is a fixed-shape masked
Sutherland-Hodgman clip, vectorised over the N x M pair grid.

Box convention (PointRCNN / lidar): (x, y, z, dx, dy, dz, yaw): centre,
full extents, rotation about +z."""
from __future__ import annotations

import torch

_MAX_VERTS = 8  # a convex quad clipped by 4 half-planes has <= 8 vertices


def bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(...,7) boxes -> (...,4,2) CCW BEV corners (x-y plane)."""
    cx, cy = boxes[..., 0], boxes[..., 1]
    hx, hy = boxes[..., 3] * 0.5, boxes[..., 4] * 0.5
    yaw = boxes[..., 6]
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    # CCW local order: (+,+), (-,+), (-,-), (+,-)
    lx = torch.stack([hx, -hx, -hx, hx], -1)
    ly = torch.stack([hy, hy, -hy, -hy], -1)
    px = cx[..., None] + c * lx - s * ly
    py = cy[..., None] + s * lx + c * ly
    return torch.stack([px, py], -1)


def corners3d(boxes: torch.Tensor) -> torch.Tensor:
    """(...,7) boxes -> (...,8,3) corners (bottom 4 CCW, then top 4)."""
    bev = bev_corners(boxes)
    z0 = boxes[..., 2] - boxes[..., 5] * 0.5
    z1 = boxes[..., 2] + boxes[..., 5] * 0.5
    shape = bev.shape[:-1] + (1,)
    bot = torch.cat([bev, z0[..., None, None].expand(shape)], -1)
    top = torch.cat([bev, z1[..., None, None].expand(shape)], -1)
    return torch.cat([bot, top], -2)


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [...,V] or [...,V,2] at per-row vertex indices idx [...,V]."""
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    return torch.gather(x, -2, idx[..., None].expand(x.shape))


def _clip_halfplane(verts, count, n, c):
    """Clip polygons verts [...,MAX,2] (valid up to count [...]) by the
    half-planes n . x >= c (n [...,2], c [...]). Every slot emits its kept
    vertex and its crossing point in cyclic order; a cumsum packs the
    valid ones to the front. The packing writes into a buffer one slot
    longer than the 2*MAX candidates and drops every position >= MAX, as
    the reference's `.at[pos].set(mode="drop")`."""
    idx = torch.arange(_MAX_VERTS, device=verts.device)
    valid = idx < count[..., None]
    nxt = torch.where(idx + 1 >= count[..., None], 0, idx + 1)
    p, q = verts, _take(verts, nxt)
    dp = p[..., 0] * n[..., None, 0] + p[..., 1] * n[..., None, 1] \
        - c[..., None]
    dq = _take(dp, nxt)
    p_in, q_in = dp >= 0, dq >= 0
    denom = dp - dq
    t = dp / torch.where(denom.abs() > 1e-12, denom, 1.0)
    inter = p + t[..., None] * (q - p)
    lead = verts.shape[:-2]
    cand = torch.stack([p, inter], -2).reshape(lead + (2 * _MAX_VERTS, 2))
    cvalid = torch.stack([p_in & valid, (p_in ^ q_in) & valid],
                         -1).reshape(lead + (2 * _MAX_VERTS,))
    pos = torch.where(cvalid, torch.cumsum(cvalid, -1) - 1, 2 * _MAX_VERTS)
    pos = torch.clamp_max(pos, 2 * _MAX_VERTS)
    out = verts.new_zeros(lead + (2 * _MAX_VERTS + 1, 2)).scatter(
        -2, pos[..., None].expand(cand.shape), cand)
    return (out[..., :_MAX_VERTS, :],
            torch.clamp_max(cvalid.sum(-1), _MAX_VERTS))


def _poly_area(verts, count):
    """Shoelace area of the first `count` vertices (CCW positive)."""
    idx = torch.arange(_MAX_VERTS, device=verts.device)
    nxt = torch.where(idx + 1 >= count[..., None], 0, idx + 1)
    p, q = verts, _take(verts, nxt)
    cross = p[..., 0] * q[..., 1] - q[..., 0] * p[..., 1]
    return 0.5 * torch.where(idx < count[..., None], cross, 0.0).sum(-1)


def _rect_intersection_area(ca, cb):
    """Intersection areas of CCW quads ca, cb [...,4,2] -> [...]."""
    verts = torch.cat([ca, ca.new_zeros(ca.shape[:-2]
                                        + (_MAX_VERTS - 4, 2))], -2)
    count = torch.full(ca.shape[:-2], 4, dtype=torch.int64,
                       device=ca.device)
    for i in range(4):
        a, b = cb[..., i, :], cb[..., (i + 1) % 4, :]
        e = b - a
        n = torch.stack([-e[..., 1], e[..., 0]], -1)   # left of the edge
        verts, count = _clip_halfplane(
            verts, count, n, n[..., 0] * a[..., 0] + n[..., 1] * a[..., 1])
    return torch.where(count >= 3, _poly_area(verts, count), 0.0)


def _bev_intersections(boxes_a, boxes_b):
    ca = bev_corners(boxes_a)[:, None]
    cb = bev_corners(boxes_b)[None]
    shape = (ca.shape[0], cb.shape[1], 4, 2)
    return _rect_intersection_area(ca.expand(shape), cb.expand(shape))


def iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated bird's-eye-view IoU matrix: (N,7), (M,7) -> (N,M)."""
    inter = _bev_intersections(boxes_a, boxes_b)
    area_a = (boxes_a[:, 3] * boxes_a[:, 4])[:, None]
    area_b = (boxes_b[:, 3] * boxes_b[:, 4])[None, :]
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-9)


def iou3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Rotated 3D IoU matrix (BEV intersection x z overlap): (N,M)."""
    inter_bev = _bev_intersections(boxes_a, boxes_b)
    za0 = boxes_a[:, 2] - boxes_a[:, 5] * 0.5
    za1 = boxes_a[:, 2] + boxes_a[:, 5] * 0.5
    zb0 = boxes_b[:, 2] - boxes_b[:, 5] * 0.5
    zb1 = boxes_b[:, 2] + boxes_b[:, 5] * 0.5
    ih = torch.clamp_min(torch.minimum(za1[:, None], zb1[None, :])
                         - torch.maximum(za0[:, None], zb0[None, :]), 0.0)
    inter = inter_bev * ih
    vol_a = (boxes_a[:, 3] * boxes_a[:, 4] * boxes_a[:, 5])[:, None]
    vol_b = (boxes_b[:, 3] * boxes_b[:, 4] * boxes_b[:, 5])[None, :]
    return inter / torch.clamp_min(vol_a + vol_b - inter, 1e-9)


def _first_k(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest of each row, equal values lowest index
    first (`lax.top_k`'s order): a stable descending sort cut to k."""
    return torch.sort(values, dim=-1, descending=True, stable=True
                      ).indices[..., :k]


def nms_rotated(boxes: torch.Tensor, scores: torch.Tensor,
                iou_thresh: float, max_out: int, bev: bool = True):
    """Greedy rotated NMS -> (idx [max_out] into `boxes` in descending
    score order, -1 past the kept ones; valid [max_out]). Equal scores
    keep their index order. Suppression by BEV IoU (3D with bev=False).
    The greedy pass is n dependent steps on the device, none of which
    waits for the host."""
    n = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    sb = boxes[order]
    mat = (iou_bev(sb, sb) if bev else iou3d(sb, sb)) > iou_thresh
    later = torch.arange(n, device=boxes.device)
    keep = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    for i in range(n):
        keep = keep & ~(mat[i] & (later > i) & keep[i])
    # the kept entries in descending-score order, then the pads; a budget
    # larger than the candidates is padded
    pad = max(0, max_out - n)
    keep_f = torch.cat([keep.float(),
                        keep.new_zeros(pad, dtype=torch.float32)])
    order_p = torch.cat([order, order.new_full((pad,), -1)])
    kidx = _first_k(keep_f, max_out)
    valid = keep_f[kidx] > 0
    return torch.where(valid, order_p[kidx], -1), valid


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """(N,3) points, (M,7) boxes -> bool (M,N) membership mask."""
    rel = points[None, :, :] - boxes[:, None, :3]
    yaw = boxes[:, 6]
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    lx = c * rel[..., 0] + s * rel[..., 1]
    ly = -s * rel[..., 0] + c * rel[..., 1]
    lz = rel[..., 2]
    return ((lx.abs() <= boxes[:, None, 3] * 0.5)
            & (ly.abs() <= boxes[:, None, 4] * 0.5)
            & (lz.abs() <= boxes[:, None, 5] * 0.5))


def roipool3d(points: torch.Tensor, feats: torch.Tensor, boxes: torch.Tensor,
              cap: int = 512):
    """Pool the first `cap` in-box points per ROI, in point order (the
    CUDA op's first-k scan) -> (xyz [M,cap,3] in the box frame,
    feats [M,cap,C], valid [M,cap], count [M], the true in-box count,
    which may exceed cap). Clouds with fewer than `cap` points are
    padded; padded slots come out invalid."""
    inside = points_in_boxes(points, boxes)                      # (M,N)
    count = inside.sum(-1)
    pad = max(0, cap - inside.shape[1])
    inside_f = torch.cat([inside.float(), inside.new_zeros(
        (inside.shape[0], pad), dtype=torch.float32)], dim=1)
    idx = _first_k(inside_f, cap)
    valid = torch.gather(inside_f, 1, idx) > 0
    idx = torch.clamp_max(idx, points.shape[0] - 1)
    rel = points[idx] - boxes[:, None, :3]
    yaw = boxes[:, 6]
    c, s = torch.cos(yaw)[:, None], torch.sin(yaw)[:, None]
    local = torch.stack([c * rel[..., 0] + s * rel[..., 1],
                         -s * rel[..., 0] + c * rel[..., 1],
                         rel[..., 2]], -1)
    mask3 = valid[..., None]
    return (torch.where(mask3, local, 0.0),
            torch.where(mask3, feats[idx], 0.0), valid, count)
