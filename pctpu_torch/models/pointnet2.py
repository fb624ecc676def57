"""PointNet++ classifiers (port of `pctpu/models/pointnet2.py`),
channels-last ([B, N, C]) at every public boundary, as the reference.

Ported: `RuntimeBN`, `SharedMLP` (unfolded Dense + BN + ReLU), the
`SetAbstraction` module with ball grouping and group-all, and the
`cls-ssg` / `cls-msg` classifiers. The sampling and grouping ops are
`ops/fps.py` (kernel 11 on CUDA) and, per scale, the fused ball-group
kernel 12 where the reference's rule (`fused_ok`) takes it, else
`ball_query` + `group_points`.

Dense layers keep flax's layout in the converter only: a torch
`nn.Linear` holds the transposed kernel. Initialisation mirrors flax's
(lecun_normal kernels, zero biases, BN scale 1 / bias 0 / mean 0 / var 1)
from an explicit `torch.Generator`; it is not bit-equal to flax's.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from pctpu_torch.ops import pallas_ballgroup
from pctpu_torch.ops.ball_query import ball_query
from pctpu_torch.ops.fps import fps_batched
from pctpu_torch.ops.gather import gather_points, group_points

# flax's truncated-normal correction: the std of a unit normal cut at +-2
TRUNC_STD = 0.87962566103423978


def fused_ok(nsample: int, channels: int, on_device: bool) -> bool:
    """The reference's rule for one SA scale (`pointnet2.py:283-284`): the
    fused ball-group kernel runs when the tensors are on the accelerator
    (CUDA here, the TPU there), nsample is a multiple of 8 and the TPU
    kernel's per-tile output block (nsample x channels rounded up to 8 x
    128 centres x 4 B) is at most 6 MiB. Elsewhere `ball_query` +
    `group_points` run."""
    cp8 = ((channels + 7) // 8) * 8
    return (on_device and nsample % 8 == 0
            and nsample * cp8 * 128 * 4 <= 6 * 2**20)


def _dense(cin: int, cout: int, bias: bool,
           generator: torch.Generator) -> nn.Linear:
    """flax `nn.Dense` as an `nn.Linear`: lecun_normal weight (truncated
    normal at +-2 std, std sqrt(1/fan_in) after the cut), zero bias."""
    lin = nn.Linear(cin, cout, bias=bias)
    std = (1.0 / cin) ** 0.5 / TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
        if bias:
            lin.bias.zero_()
    return lin


class RuntimeBN(nn.Module):
    """BatchNorm over the last axis with torch-convention runtime momentum:
    running <- (1 - momentum) * running + momentum * batch."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            mean = x.mean(dim=dims)
            var = x.var(dim=dims, unbiased=False)
            with torch.no_grad():
                self.mean.copy_((1.0 - momentum) * self.mean + momentum * mean)
                self.var.copy_((1.0 - momentum) * self.var + momentum * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


class SharedMLP(nn.Module):
    """Per-point Dense (1x1 conv) + BN + ReLU per layer
    (`pointnet2_modules.py:9-19`); Dense has no bias ahead of BN."""

    def __init__(self, cin: int, channels: Sequence[int],
                 generator: torch.Generator, bn: bool = True):
        super().__init__()
        dims = [cin, *channels]
        self.dense = nn.ModuleList(
            _dense(a, b, not bn, generator) for a, b in zip(dims, dims[1:]))
        self.bn = nn.ModuleList(RuntimeBN(c) for c in channels) if bn \
            else None

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1):
        for i, dense in enumerate(self.dense):
            x = dense(x)
            if self.bn is not None:
                x = self.bn[i](x, bn_momentum)
            x = torch.relu(x)
        return x


class SetAbstraction(nn.Module):
    """SA module with ball grouping (FPS centres, ball query, grouping) or,
    with npoint=None, group-all. `in_features` is the channel count of the
    incoming features (0 for none); mlps channels exclude the input dim;
    use_xyz adds relative xyz to each scale's input."""

    def __init__(self, npoint: Optional[int], radii, nsamples,
                 mlps: Sequence[Sequence[int]], in_features: int,
                 generator: torch.Generator, use_xyz: bool = True,
                 grouping: str = "ball"):
        super().__init__()
        if grouping != "ball":
            raise NotImplementedError(
                f"grouping={grouping!r} is not ported yet; only 'ball'")
        self.npoint, self.radii, self.nsamples = npoint, radii, nsamples
        self.use_xyz = use_xyz
        cin = 3 + in_features if (use_xyz or not in_features) \
            else in_features
        self.mlps = nn.ModuleList(SharedMLP(cin, spec, generator)
                                  for spec in mlps)
        self.out_features = sum(spec[-1] for spec in mlps)

    def _with_xyz(self, grouped_xyz, grouped_feats):
        if grouped_feats is None:
            return grouped_xyz
        if not self.use_xyz:
            return grouped_feats
        return torch.cat([grouped_xyz, grouped_feats], dim=-1)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                bn_momentum: float = 0.1):
        """xyz [B,N,3]; features [B,N,C] or None -> (new_xyz [B,npoint,3]
        or None, new_features [B,npoint or 1,sum(C_out)])."""
        if self.npoint is None:
            g = self._with_xyz(xyz[:, None],
                               None if features is None else features[:, None])
            return None, self.mlps[0](g, bn_momentum).amax(dim=2)
        new_xyz = gather_points(xyz, fps_batched(xyz, self.npoint))
        packed = xyz if features is None else torch.cat([xyz, features], -1)
        outs = []
        for mlp, radius, nsample in zip(self.mlps, self.radii,
                                        self.nsamples):
            if fused_ok(nsample, packed.shape[-1], xyz.is_cuda):
                g = pallas_ballgroup.ball_group_pallas_batched(
                    new_xyz, packed, radius, nsample)
                if not self.use_xyz and features is not None:
                    g = g[..., 3:]
            else:
                idx, _ = ball_query(new_xyz, xyz, radius, nsample)
                g = self._with_xyz(
                    group_points(xyz, idx) - new_xyz[:, :, None, :],
                    None if features is None else group_points(features, idx))
            outs.append(mlp(g, bn_momentum).amax(dim=2))   # max over nsample
        return new_xyz, torch.cat(outs, dim=-1)


def split_pointcloud(pc: torch.Tensor):
    """[B,N,3+C] -> (xyz [B,N,3], features [B,N,C] or None)."""
    return pc[..., :3], (pc[..., 3:] if pc.shape[-1] > 3 else None)


class _PointNet2Cls(nn.Module):
    """Three SA levels (the last group-all), then Dense-BN-ReLU 512 and
    256, dropout 0.5 and the class Dense. `in_channels` is the input
    cloud's channel count (xyz + features): flax infers it at init, a torch
    module fixes it at construction."""

    SA_SPECS = ()   # (npoint, radii, nsamples, mlps) per level

    def __init__(self, num_classes: int = 40, use_xyz: bool = True,
                 grouping: str = "ball", in_channels: int = 6,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        feats = in_channels - 3
        self.sa = nn.ModuleList()
        for npoint, radii, nsamples, mlps in self.SA_SPECS:
            self.sa.append(SetAbstraction(npoint, radii, nsamples, mlps,
                                          feats, gen, use_xyz=use_xyz,
                                          grouping=grouping))
            feats = self.sa[-1].out_features
        self.dense = nn.ModuleList([_dense(feats, 512, False, gen),
                                    _dense(512, 256, False, gen),
                                    _dense(256, num_classes, True, gen)])
        self.bn = nn.ModuleList([RuntimeBN(512), RuntimeBN(256)])
        self.dropout = nn.Dropout(0.5)

    def forward(self, pc: torch.Tensor, bn_momentum: float = 0.1):
        """pc [B,N,in_channels] -> logits [B,num_classes]."""
        xyz, features = split_pointcloud(pc)
        for sa in self.sa:
            xyz, features = sa(xyz, features, bn_momentum)
        x = features[:, 0, :]
        for dense, bn in zip(self.dense, self.bn):
            x = torch.relu(bn(dense(x), bn_momentum))
        return self.dense[2](self.dropout(x))


class PointNet2ClsSSG(_PointNet2Cls):
    """Single-scale-grouping classifier (`pointnet2_ssg_cls.py:63-98`)."""
    SA_SPECS = ((512, [0.2], [64], [[64, 64, 128]]),
                (128, [0.4], [64], [[128, 128, 256]]),
                (None, [None], [None], [[256, 512, 1024]]))


class PointNet2ClsMSG(_PointNet2Cls):
    """Multi-scale-grouping classifier (`pointnet2_msg_cls.py:11-45`)."""
    SA_SPECS = ((512, [0.1, 0.2, 0.4], [16, 32, 128],
                 [[32, 32, 64], [64, 64, 128], [64, 96, 128]]),
                (128, [0.2, 0.4, 0.8], [32, 64, 128],
                 [[64, 64, 128], [128, 128, 256], [128, 128, 256]]),
                (None, [None], [None], [[256, 512, 1024]]))


MODEL_REGISTRY = {
    "cls-ssg": PointNet2ClsSSG,
    "cls-msg": PointNet2ClsMSG,
}
