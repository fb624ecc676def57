"""A minimal PointRCNN-style two-stage detector over `ops.box3d` (port of
`pctpu/models/pointrcnn.py`).

Stage 1 (`ProposalNet`): a window-grouping PointNet++ encoder/decoder
gives every point a foreground logit and a box residual (centre offset,
log-extent ratios against an anchor, yaw as sin/cos);
`decode_proposals` turns every point into a candidate box and
`extract_proposals` keeps the top K by score, then prunes them with
`nms_rotated`. Stage 2 (`RefineNet`): `roipool3d` pools the in-box
points of each proposal in its frame; a shared MLP and a masked max
regress a residual and a confidence.

Window grouping runs no kernel: the input must be Morton-sorted
(`pointnet2.morton_sort_packed`), and the outputs stay in that order.
The torch modules fix their input width at construction (`in_channels`,
`in_features`), where flax infers it at init. `ProposalNet` keeps its
feature-propagation modules in flax's creation order, coarsest first, so
`models/convert.py` maps `FeaturePropagation_0` (level 2) to `fp.0`.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn
from torch.nn import functional as F

from pctpu_torch.models.pointnet2 import (F32, FeaturePropagation,
                                          SetAbstraction, SharedMLP, _dense,
                                          split_pointcloud)
from pctpu_torch.ops.box3d import nms_rotated, points_in_boxes, roipool3d

# anchor extents (l, w, h): PointRCNN's car anchor
CAR_ANCHOR = (3.9, 1.6, 1.56)
SA_MLPS = ((64, 64, 128), (128, 128, 256))
FP_MLP = (128, 128)


class ProposalNet(nn.Module):
    """Stage-1 RPN: pc [B,N,in_channels] (Morton-sorted; KITTI's x, y, z,
    intensity by default) -> (scores [B,N], reg [B,N,8]), reg = (dx, dy,
    dz, dlog_l, dlog_w, dlog_h, sin_yaw, cos_yaw)."""

    def __init__(self, npoints: Sequence[int] = (1024, 256),
                 in_channels: int = 4, dtype: torch.dtype = F32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        self.npoints = tuple(npoints)
        widths = [in_channels - 3]
        self.sa = nn.ModuleList()
        for np_, ch in zip(self.npoints, SA_MLPS):
            self.sa.append(SetAbstraction(np_, [None], [32], [ch],
                                          widths[-1], gen,
                                          grouping="window", dtype=dtype))
            widths.append(self.sa[-1].out_features)
        # created as the reference creates them: level len(npoints) first
        coarse = [widths[-1]] + [FP_MLP[-1]] * (len(self.npoints) - 1)
        self.fp = nn.ModuleList(
            FeaturePropagation(c + widths[i - 1], FP_MLP, gen,
                               grouping="window", dtype=dtype)
            for c, i in zip(coarse, range(len(self.npoints), 0, -1)))
        self.dense = nn.ModuleList([_dense(FP_MLP[-1], 1, True, gen),
                                    _dense(FP_MLP[-1], 8, True, gen)])

    def forward(self, pc: torch.Tensor, bn_momentum: float = 0.1):
        xyz, features = split_pointcloud(pc)
        l_xyz, l_feats = [xyz], [features]
        for sa in self.sa:
            nxyz, nfeat = sa(l_xyz[-1], l_feats[-1], bn_momentum)
            l_xyz.append(nxyz)
            l_feats.append(nfeat)
        for fp, i in zip(self.fp, range(len(self.npoints), 0, -1)):
            l_feats[i - 1] = fp(l_xyz[i - 1], l_xyz[i], l_feats[i - 1],
                                l_feats[i], bn_momentum)
        h = l_feats[0]                                           # [B,N,128]
        return self.dense[0](h)[..., 0], self.dense[1](h)


def decode_proposals(xyz: torch.Tensor, reg: torch.Tensor,
                     anchor=CAR_ANCHOR) -> torch.Tensor:
    """Per-point box decode: [..,N,3] xyz + [..,N,8] residuals -> [..,N,7]
    (x, y, z, l, w, h, yaw) boxes."""
    a = torch.tensor(anchor, dtype=torch.float32, device=xyz.device)
    center = xyz + reg[..., 0:3]
    ext = a * torch.exp(torch.clamp(reg[..., 3:6], -3.0, 3.0))
    yaw = torch.atan2(reg[..., 6], reg[..., 7])
    return torch.cat([center, ext, yaw[..., None]], dim=-1)


def extract_proposals(boxes: torch.Tensor, scores: torch.Tensor,
                      pre_nms_top: int = 256, post_nms: int = 32,
                      iou_thresh: float = 0.7):
    """[N,7] candidate boxes + [N] logits -> (boxes [post_nms,7], scores
    [post_nms], valid [post_nms]): the top `pre_nms_top` by score (equal
    scores lowest index first, as `lax.top_k`), then rotated NMS."""
    k = min(pre_nms_top, scores.shape[0])
    top_i = torch.sort(scores, descending=True, stable=True).indices[:k]
    top_s, cand = scores[top_i], boxes[top_i]
    idx, valid = nms_rotated(cand, top_s, iou_thresh, post_nms)
    safe = torch.clamp_min(idx, 0)
    return (torch.where(valid[:, None], cand[safe], 0.0),
            torch.where(valid, top_s[safe], float("-inf")), valid)


class RefineNet(nn.Module):
    """Stage-2 canonical refinement of one scene: roipool3d -> shared MLP
    -> masked max -> residual [M,8] and confidence [M]. A proposal with
    no point inside pools to 0."""

    def __init__(self, in_features: int, cap: int = 64,
                 dtype: torch.dtype = F32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        self.cap = cap
        self.mlps = nn.ModuleList([SharedMLP(3 + in_features, (128, 128),
                                             gen, dtype=dtype)])
        self.dense = nn.ModuleList([_dense(128, 8, True, gen),
                                    _dense(128, 1, True, gen)])

    def forward(self, points: torch.Tensor, feats: torch.Tensor,
                boxes: torch.Tensor, bn_momentum: float = 0.1):
        """points [N,3], feats [N,in_features], boxes [M,7]."""
        local, pooled, valid, _ = roipool3d(points, feats, boxes,
                                            cap=self.cap)
        g = torch.cat([local, pooled], dim=-1)                   # [M,cap,.]
        h = self.mlps[0](g[None], bn_momentum)[0]                # [M,cap,128]
        h = torch.where(valid[..., None], h, float("-inf")).amax(dim=1)
        h = torch.where(valid.any(dim=1)[:, None], h, 0.0)
        return self.dense[0](h), self.dense[1](h)[..., 0]


def proposal_targets(xyz: torch.Tensor, gt_boxes: torch.Tensor,
                     anchor=CAR_ANCHOR):
    """Per-point RPN targets of one scene: xyz [N,3], gt_boxes [G,7] (rows
    with no extent are padding) -> (fg [N] bool, reg_target [N,8]). A
    point is foreground iff inside a real box; its target points at the
    first such box."""
    a = torch.tensor(anchor, dtype=torch.float32, device=xyz.device)
    real = gt_boxes[:, 3] > 0
    inside = points_in_boxes(xyz, gt_boxes) & real[:, None]      # [G,N]
    fg = inside.any(dim=0)
    owner = torch.argmax(inside.to(torch.uint8), dim=0)   # the first box
    ob = gt_boxes[owner]
    reg = torch.cat([ob[:, :3] - xyz,
                     torch.log(torch.clamp_min(ob[:, 3:6], 1e-3) / a),
                     torch.sin(ob[:, 6:7]), torch.cos(ob[:, 6:7])], dim=-1)
    return fg, reg


def rpn_loss(score: torch.Tensor, reg: torch.Tensor, fg: torch.Tensor,
             reg_target: torch.Tensor, fg_weight: float = 1.0):
    """Balanced BCE on the foreground labels plus smooth-L1 on the
    foreground points' residuals, each summed over the whole batch ->
    (loss, {"cls", "reg"})."""
    p = F.logsigmoid(score)
    q = F.logsigmoid(-score)
    nf = torch.clamp_min(fg.sum().float(), 1.0)
    nb = torch.clamp_min((~fg).sum().float(), 1.0)
    cls = -(fg_weight * torch.where(fg, p, 0.0).sum() / nf
            + torch.where(~fg, q, 0.0).sum() / nb)
    d = reg - reg_target
    ad = d.abs()
    sl1 = torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
    regl = torch.where(fg[..., None], sl1, 0.0).sum() / nf
    return cls + regl, {"cls": cls, "reg": regl}
