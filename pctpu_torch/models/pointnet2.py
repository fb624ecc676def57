"""PointNet++ classifiers and semantic segmentation (port of
`pctpu/models/pointnet2.py`), channels-last ([B, N, C]) at every public
boundary, as the reference.

Ported: `RuntimeBN`, `FoldedDenseBNRelu`, `SharedMLP` (Dense + BN + ReLU,
or the folded layer with `fold_bn=True`), `SetAbstraction` with ball
grouping, window grouping (`WindowScale`) and group-all,
`FeaturePropagation`, `morton_sort_packed`, `strided_windows`, the
`cls-ssg` / `cls-msg` classifiers and the `semseg-ssg` / `semseg-msg`
segmenters, in eval and train mode.

Ball grouping samples centres by FPS (`ops/fps.py`, kernel 11 on CUDA)
and groups each scale with the fused ball-group kernel 12 (backward:
kernel 14) where the reference's rule (`fused_ok`) takes it, else with
`ball_query` + `group_points`, whose gradient flows through
`torch.gather` as the reference's does through XLA's gather. Window
grouping runs no kernel: the cloud is Morton-sorted, the centres are the
block means, each centre's neighbours a contiguous strided window masked
by the radius. Feature propagation interpolates from the three nearest
coarse points (`ops/interpolate.py`) or, after window grouping, copies
each block's parent.

`dtype` (the reference's compute dtype, on the classifiers and their
MLPs): only the Dense layers cast, their inputs and weights, to `dtype`;
the parameters stay float32, each BN takes its input as float32, and a
`SharedMLP` returns float32. The classifier's last Dense and all geometry
(FPS, grouping, Morton codes, windows, masks) stay float32. The casts are
explicit: `torch.autocast` follows other rules than flax. The segmenters
have no `dtype`, as in the reference, and run in float32.

Train mode (`model.train()`): BN normalises with the batch statistics
and moves its running ones by the `bn_momentum` the caller passes;
dropout draws its keep-mask from the explicit `generator` given to
`forward`, or takes the `dropout_mask` given. A window scale's activations
are recomputed in the backward pass (`torch.utils.checkpoint`, as the
reference's `nn.remat`); the BN layers move their running statistics
only in the forward pass, not again in the recomputation.

Global batch statistics: under `global_batch_stats(model, group)` the BN
layers (`RuntimeBN`, `FoldedDenseBNRelu`) take their batch moments over
the whole batch of a `torch.distributed` group, each rank holding an equal
block of it, through the differentiable all-reduce of
`parallel.mesh.AllReduceSum` (the data-parallel train step).

Dense layers keep flax's layout in the converter only: a torch
`nn.Linear` holds the transposed kernel. Initialisation mirrors flax's
(lecun_normal kernels, zero biases, BN scale 1 / bias 0 / mean 0 / var 1)
from an explicit `torch.Generator`; it is not bit-equal to flax's.
"""
from __future__ import annotations

import contextlib
from typing import Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from pctpu_torch.ops import pallas_ballgroup
from pctpu_torch.ops.ball_query import ball_query
from pctpu_torch.ops.fps import fps_batched
from pctpu_torch.ops.gather import gather_points, group_points
from pctpu_torch.ops.interpolate import (interpolation_weights,
                                         three_interpolate, three_nn)
from pctpu_torch.ops.morton import morton_codes
from pctpu_torch.parallel.mesh import AllReduceSum

F32 = torch.float32
# flax's truncated-normal correction: the std of a unit normal cut at +-2
TRUNC_STD = 0.87962566103423978
DROPOUT_RATE = 0.5      # the heads (`pointnet2.py:442, 478, 524, 573`)
GROUPINGS = ("ball", "window")


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


def morton_sort_packed(pc: torch.Tensor) -> torch.Tensor:
    """Sort a [B,N,C>=3] cloud by the Morton code of its xyz, equal codes
    in index order (as the reference's one-key `lax.sort`): a stable sort
    of the codes, then a gather of the rows."""
    _, order = torch.sort(morton_codes(pc[..., :3]), dim=-1, stable=True)
    return torch.gather(pc, -2,
                        order[..., None].expand(*order.shape, pc.shape[-1]))


def strided_windows(x: torch.Tensor, npoint: int,
                    nsample: int) -> torch.Tensor:
    """[B,N,C] (Morton-sorted, N = npoint * stride) -> [B,npoint,nsample,C]
    with window[i, o] = x[(i * stride + o) mod N], stride = N // npoint:
    the first nsample rows of each stride block, or, for nsample >
    stride, the blocks doubled by concatenating each with its neighbour
    `shift` blocks on (wrapping at the end), shift 1, 2, 4, ..."""
    b, n, c = x.shape
    stride = n // npoint
    w = x.reshape(b, npoint, stride, c)
    shift = 1
    while w.shape[2] < nsample:
        w = torch.cat([w, torch.roll(w, -shift, dims=1)], dim=2)
        shift *= 2
    return w[:, :, :nsample, :]


def _lecun_normal(cin: int, cout: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's lecun_normal as a [cout, cin] weight: a truncated normal at
    +-2 std, std sqrt(1/fan_in) after the cut."""
    w = torch.empty(cout, cin)
    std = (1.0 / cin) ** 0.5 / TRUNC_STD
    nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                          generator=generator)
    return w


def _dense(cin: int, cout: int, bias: bool,
           generator: torch.Generator) -> nn.Linear:
    """flax `nn.Dense` as an `nn.Linear`: lecun_normal weight, zero
    bias."""
    lin = nn.Linear(cin, cout, bias=bias)
    with torch.no_grad():
        lin.weight.copy_(_lecun_normal(cin, cout, generator))
        if bias:
            lin.bias.zero_()
    return lin


def _dense_apply(lin: nn.Linear, x: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype)`: the input, weight and bias cast to
    `dtype`, the product, then the bias."""
    if dtype == F32:
        return lin(x)
    y = x.to(dtype) @ lin.weight.to(dtype).t()
    return y if lin.bias is None else y + lin.bias.to(dtype)


def dropout_keep(shape, rate: float, generator: Optional[torch.Generator],
                 device) -> torch.Tensor:
    """The keep-mask of `dropout`: a uniform draw from `generator` below
    1 - rate."""
    if generator is None:
        raise ValueError("dropout draws from an explicit generator: pass "
                         "generator= or dropout_mask=")
    return torch.rand(shape, generator=generator, device=device) < 1.0 - rate


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None,
            keep_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """flax `nn.Dropout(rate)` in train mode: keep an element where a
    uniform draw from `generator` is below 1 - rate, and scale it by
    1 / (1 - rate); zero elsewhere. `keep_mask` (bool, x's shape) stands
    in for the draw."""
    keep = 1.0 - rate
    if keep_mask is None:
        keep_mask = dropout_keep(x.shape, rate, generator, x.device)
    return torch.where(keep_mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                        device=x.device))


@contextlib.contextmanager
def _stats_frozen(module: nn.Module):
    """Within: the BN layers of `module` normalise as usual but do not move
    their running statistics (a checkpoint's recomputation)."""
    layers = [m for m in module.modules() if hasattr(m, "update_stats")]
    for m in layers:
        m.update_stats = False
    try:
        yield
    finally:
        for m in layers:
            m.update_stats = True


def _global_mean(rows_sum: torch.Tensor, count: int, group):
    """(sum over the group's ranks, rows over them) of a per-rank [C] sum
    and row count, both through the differentiable all-reduce."""
    both = AllReduceSum.apply(torch.cat([
        rows_sum, torch.full((1,), float(count), dtype=rows_sum.dtype,
                             device=rows_sum.device)]), group)
    return both[:-1], both[-1]


@contextlib.contextmanager
def global_batch_stats(module: nn.Module, group):
    """Within: the BN layers of `module` take their batch statistics over
    the whole batch of the `torch.distributed` group `group`."""
    layers = [m for m in module.modules()
              if isinstance(m, (RuntimeBN, FoldedDenseBNRelu))]
    old = [m.group for m in layers]
    for m in layers:
        m.group = group
    try:
        yield
    finally:
        for m, g in zip(layers, old):
            m.group = g


class RuntimeBN(nn.Module):
    """BatchNorm over the last axis with torch-convention runtime momentum:
    running <- (1 - momentum) * running + momentum * batch. With `group`
    set to a `torch.distributed` process group (`global_batch_stats`) the
    batch statistics are the group's whole batch's: the per-channel sums
    and the centred sums of squares are all-reduced."""

    def __init__(self, channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon, self.group = epsilon, None
        self.update_stats = True
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("mean", torch.zeros(channels))
        self.register_buffer("var", torch.ones(channels))

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        if self.training:
            dims = tuple(range(x.dim() - 1))
            if self.group is None:
                mean = x.mean(dim=dims)
                var = x.var(dim=dims, unbiased=False)
            else:
                total, n = _global_mean(x.sum(dim=dims),
                                        x.numel() // x.shape[-1], self.group)
                mean = total / n
                var = AllReduceSum.apply(((x - mean) ** 2).sum(dim=dims),
                                         self.group) / n
            if self.update_stats:
                with torch.no_grad():
                    self.mean.copy_((1.0 - momentum) * self.mean
                                    + momentum * mean)
                    self.var.copy_((1.0 - momentum) * self.var
                                   + momentum * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * torch.rsqrt(var + self.epsilon)
        return y * self.scale + self.bias


class FoldedDenseBNRelu(nn.Module):
    """Dense + BatchNorm + ReLU as one product (the reference's moment
    fold, `pointnet2.py:98-180`): in train mode the batch statistics of
    y = xW come from the input's moments over centred rows (every
    `stat_stride`-th row where there are at least 64 * stat_stride),

        mu_y = mu_x W,   var_y = max(diag(W^T Cov(x) W), 0),

    biased, with torch-convention momentum on the running statistics; the
    layer is relu(x @ (W k s) + (beta - mu_y k s)) with k = rsqrt(var_y +
    eps), in `dtype`. The [Cin, N] x [N, Cin] moment product is a plain
    matrix product, as the reference leaves it to XLA. Opt-in and off by
    default (`SharedMLP(fold_bn=True)`), as in the reference.

    With `group` set (see `RuntimeBN`) the input moments are the group's
    whole batch's, each rank holding an equal block of its rows; the
    strided rows are those the stride picks from the whole batch."""

    def __init__(self, cin: int, features: int, generator: torch.Generator,
                 epsilon: float = 1e-5, dtype: torch.dtype = F32,
                 stat_stride: int = 1):
        super().__init__()
        self.epsilon, self.dtype, self.stat_stride = epsilon, dtype, stat_stride
        self.group = None
        self.update_stats = True
        self.weight = nn.Parameter(_lecun_normal(cin, features, generator))
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, momentum: float = 0.1) -> torch.Tensor:
        kernel = self.weight.t()                           # [cin, cout]
        if self.training:
            rows = x.reshape(-1, x.shape[-1])
            group = self.group
            ranks, me = ((dist.get_world_size(group), dist.get_rank(group))
                         if group is not None else (1, 0))
            stride = self.stat_stride
            if stride > 1 and ranks * rows.shape[0] >= 64 * stride:
                # the rows at multiples of the stride in the whole batch
                rows = rows[(-me * rows.shape[0]) % stride::stride]
            rows = rows.float()
            if group is None:
                mu_x = rows.mean(dim=0)
                cen = rows - mu_x
                cov = (cen.t() @ cen) / float(rows.shape[0])
            else:
                total, n = _global_mean(rows.sum(dim=0), rows.shape[0], group)
                mu_x = total / n
                cen = rows - mu_x
                cov = AllReduceSum.apply(cen.t() @ cen, group) / n
            mu_y = mu_x @ kernel
            var_y = torch.clamp_min(torch.sum(kernel * (cov @ kernel),
                                              dim=0), 0.0)
            if self.update_stats:
                with torch.no_grad():
                    self.mean.copy_((1.0 - momentum) * self.mean
                                    + momentum * mu_y)
                    self.var.copy_((1.0 - momentum) * self.var
                                   + momentum * var_y)
        else:
            mu_y, var_y = self.mean, self.var
        k = torch.rsqrt(var_y + self.epsilon) * self.scale
        weff = (kernel * k[None, :]).to(self.dtype)
        beff = (self.bias - mu_y * k).to(self.dtype)
        return torch.relu(x.to(self.dtype) @ weff + beff)


class SharedMLP(nn.Module):
    """Per-point Dense (1x1 conv) + BN + ReLU per layer
    (`pointnet2_modules.py:9-19`); Dense has no bias ahead of BN. With
    `fold_bn` each layer is a `FoldedDenseBNRelu`. Returns float32."""

    def __init__(self, cin: int, channels: Sequence[int],
                 generator: torch.Generator, bn: bool = True,
                 dtype: torch.dtype = F32, fold_bn: bool = False):
        super().__init__()
        self.dtype = dtype
        dims = list(zip([cin, *channels], channels))
        self.folded = self.dense = self.bn = None
        if bn and fold_bn:
            self.folded = nn.ModuleList(
                FoldedDenseBNRelu(a, b, generator, dtype=dtype)
                for a, b in dims)
            return
        self.dense = nn.ModuleList(_dense(a, b, not bn, generator)
                                   for a, b in dims)
        if bn:
            self.bn = nn.ModuleList(RuntimeBN(c) for c in channels)

    def forward(self, x: torch.Tensor, bn_momentum: float = 0.1):
        if self.folded is not None:
            for layer in self.folded:
                x = layer(x, bn_momentum)
            return x.float()
        up = self.dtype != F32          # float32 stays as it is
        for i, dense in enumerate(self.dense):
            x = _dense_apply(dense, x, self.dtype)
            if self.bn is not None:
                x = self.bn[i](x.float() if up else x, bn_momentum)
            x = torch.relu(x)
        return x.float() if up else x


class WindowScale(nn.Module):
    """One window-grouping scale (`pointnet2.py:334-362`): the strided
    windows, relative xyz, the MLP, and the max over each window of the
    rows within the radius (d^2 < r^2); a window with none pools to 0.
    With gradients on, the scale runs under a checkpoint (the reference's
    `nn.remat`) and its BN layers move their running statistics once."""

    def __init__(self, npoint: int, nsample: int, radius: Optional[float],
                 cin: int, mlp: Sequence[int], generator: torch.Generator,
                 use_xyz: bool = True, dtype: torch.dtype = F32):
        super().__init__()
        self.npoint, self.nsample, self.radius = npoint, nsample, radius
        self.use_xyz = use_xyz
        self.mlps = nn.ModuleList([SharedMLP(cin, mlp, generator,
                                             dtype=dtype)])

    def _pooled(self, packed, new_xyz, bn_momentum, has_features):
        win = strided_windows(packed, self.npoint, self.nsample)
        rel = win[..., :3] - new_xyz[:, :, None, :]
        if has_features:
            g = (torch.cat([rel, win[..., 3:]], dim=-1) if self.use_xyz
                 else win[..., 3:])
        else:
            g = rel
        h = self.mlps[0](g, bn_momentum)
        if self.radius is None:
            return h.amax(dim=2)
        inside = torch.sum(rel * rel, dim=-1) < self.radius * self.radius
        h = torch.where(inside[..., None], h, float("-inf"))
        return torch.where(inside.any(dim=2)[..., None], h.amax(dim=2), 0.0)

    def forward(self, packed: torch.Tensor, new_xyz: torch.Tensor,
                bn_momentum: float = 0.1, has_features: bool = True):
        """packed [B,N,3+C], new_xyz [B,npoint,3] -> [B,npoint,C_out]."""
        if not torch.is_grad_enabled():
            return self._pooled(packed, new_xyz, bn_momentum, has_features)
        return checkpoint(
            self._pooled, packed, new_xyz, bn_momentum, has_features,
            use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(),
                                _stats_frozen(self)))


class SetAbstraction(nn.Module):
    """SA module with ball grouping (FPS centres, ball query, grouping),
    window grouping (block-mean centres, strided windows; the input must
    be Morton-sorted) or, with npoint=None, group-all. `in_features` is
    the channel count of the incoming features (0 for none); mlps
    channels exclude the input dim; use_xyz adds relative xyz to each
    scale's input."""

    def __init__(self, npoint: Optional[int], radii, nsamples,
                 mlps: Sequence[Sequence[int]], in_features: int,
                 generator: torch.Generator, use_xyz: bool = True,
                 grouping: str = "ball", dtype: torch.dtype = F32):
        super().__init__()
        if grouping not in GROUPINGS:
            raise ValueError(f"grouping={grouping!r}; one of {GROUPINGS}")
        self.npoint, self.radii, self.nsamples = npoint, radii, nsamples
        self.use_xyz, self.grouping = use_xyz, grouping
        cin = 3 + in_features if (use_xyz or not in_features) \
            else in_features
        if npoint is not None and grouping == "window":
            self.scales = nn.ModuleList(
                WindowScale(npoint, ns, r, cin, spec, generator, use_xyz,
                            dtype)
                for r, ns, spec in zip(radii, nsamples, mlps))
        else:
            self.mlps = nn.ModuleList(SharedMLP(cin, spec, generator,
                                                dtype=dtype)
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
        packed = xyz if features is None else torch.cat([xyz, features], -1)
        if self.grouping == "window":
            return self._window(xyz, packed, features is not None,
                                bn_momentum)
        new_xyz = gather_points(xyz, fps_batched(xyz, self.npoint))
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

    def _window(self, xyz, packed, has_features, bn_momentum):
        b, n, _ = xyz.shape
        if n < self.npoint:
            raise ValueError(f"window grouping needs N >= npoint (got N={n},"
                             f" npoint={self.npoint})")
        stride = n // self.npoint
        new_xyz = xyz.reshape(b, self.npoint, stride, 3).mean(dim=2)
        return new_xyz, torch.cat([scale(packed, new_xyz, bn_momentum,
                                         has_features)
                                   for scale in self.scales], dim=-1)


class FeaturePropagation(nn.Module):
    """FP module (`pointnet2.py:366-400`): the coarse features brought to
    the fine points, then [interpolated, skip] through the MLP. `cin` is
    C2 + C1 (coarse + skip channels): a torch module fixes its input
    width at construction. Without coarse xyz the features are broadcast;
    after window grouping each fine point takes its block's parent
    (stride n // m); else three-NN inverse-distance interpolation."""

    def __init__(self, cin: int, mlp: Sequence[int],
                 generator: torch.Generator, grouping: str = "ball",
                 dtype: torch.dtype = F32):
        super().__init__()
        if grouping not in GROUPINGS:
            raise ValueError(f"grouping={grouping!r}; one of {GROUPINGS}")
        self.grouping = grouping
        self.mlps = nn.ModuleList([SharedMLP(cin, mlp, generator,
                                             dtype=dtype)])
        self.out_features = mlp[-1]

    def forward(self, unknown: torch.Tensor, known: Optional[torch.Tensor],
                unknown_feats: Optional[torch.Tensor],
                known_feats: torch.Tensor, bn_momentum: float = 0.1):
        """unknown [B,n,3], known [B,m,3] or None, unknown_feats [B,n,C1]
        or None, known_feats [B,m,C2] -> [B,n,mlp[-1]]."""
        b, m, c2 = known_feats.shape
        n = unknown.shape[1]
        if known is None:
            interp = known_feats.expand(b, n, c2)
        elif self.grouping == "window":
            interp = known_feats[:, :, None, :].expand(
                b, m, n // m, c2).reshape(b, n, c2)
        else:
            d2, idx = three_nn(unknown, known)
            interp = three_interpolate(known_feats, idx,
                                       interpolation_weights(d2))
        x = (torch.cat([interp, unknown_feats], dim=-1)
             if unknown_feats is not None else interp)
        return self.mlps[0](x, bn_momentum)


def split_pointcloud(pc: torch.Tensor):
    """[B,N,3+C] -> (xyz [B,N,3], features [B,N,C] or None)."""
    return pc[..., :3], (pc[..., 3:] if pc.shape[-1] > 3 else None)


class _PointNet2Cls(nn.Module):
    """Three SA levels (the last group-all), then Dense-BN-ReLU 512 and
    256, dropout 0.5 and the class Dense. `in_channels` is the input
    cloud's channel count (xyz + features): flax infers it at init, a torch
    module fixes it at construction. With window grouping the cloud is
    Morton-sorted first."""

    SA_SPECS = ()   # (npoint, radii, nsamples, mlps) per level

    def __init__(self, num_classes: int = 40, use_xyz: bool = True,
                 grouping: str = "ball", in_channels: int = 6,
                 generator: Optional[torch.Generator] = None,
                 dtype: torch.dtype = F32):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        self.grouping, self.dtype = grouping, dtype
        feats = in_channels - 3
        self.sa = nn.ModuleList()
        for npoint, radii, nsamples, mlps in self.SA_SPECS:
            self.sa.append(SetAbstraction(npoint, radii, nsamples, mlps,
                                          feats, gen, use_xyz=use_xyz,
                                          grouping=grouping, dtype=dtype))
            feats = self.sa[-1].out_features
        self.dense = nn.ModuleList([_dense(feats, 512, False, gen),
                                    _dense(512, 256, False, gen),
                                    _dense(256, num_classes, True, gen)])
        self.bn = nn.ModuleList([RuntimeBN(512), RuntimeBN(256)])

    @staticmethod
    def dropout_shape(pc_shape) -> tuple:
        """The head's dropout mask shape for a batch of `pc_shape`."""
        return (pc_shape[0], 256)

    def forward(self, pc: torch.Tensor, bn_momentum: float = 0.1,
                generator: Optional[torch.Generator] = None,
                dropout_mask: Optional[torch.Tensor] = None):
        """pc [B,N,in_channels] -> logits [B,num_classes]. In train mode
        the head's dropout takes `dropout_mask` ([B,256] bool) or draws
        one from `generator` (on pc's device)."""
        if self.grouping == "window":
            pc = morton_sort_packed(pc)
        xyz, features = split_pointcloud(pc)
        for sa in self.sa:
            xyz, features = sa(xyz, features, bn_momentum)
        x = features[:, 0, :]
        for dense, bn in zip(self.dense, self.bn):
            x = _dense_apply(dense, x, self.dtype)
            x = torch.relu(bn(x.float() if self.dtype != F32 else x,
                              bn_momentum))
        if self.training:
            x = dropout(x, DROPOUT_RATE, generator, dropout_mask)
        return self.dense[2](x)


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


class _PointNet2SemSeg(nn.Module):
    """U-Net-style segmentation: four SA levels, four FP levels applied
    from the coarsest up (FP k joins level k + 1's features to level k's),
    then per point Dense 128 (no bias) - BN - ReLU, dropout 0.5 and the
    class Dense. No `dtype`: float32, as the reference. With window
    grouping the input must already be Morton-sorted (with its labels);
    the logits come back in that order."""

    SA_SPECS = ()   # (npoint, radii, nsamples, mlps) per level
    FP_MLPS = ()    # FP k's mlp, k = 0 (finest) .. 3

    def __init__(self, num_classes: int = 13, use_xyz: bool = True,
                 grouping: str = "ball", in_channels: int = 9,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = generator if generator is not None else torch.Generator()
        widths = [in_channels - 3]          # feature channels per level
        self.sa = nn.ModuleList()
        for npoint, radii, nsamples, mlps in self.SA_SPECS:
            self.sa.append(SetAbstraction(npoint, radii, nsamples, mlps,
                                          widths[-1], gen, use_xyz=use_xyz,
                                          grouping=grouping))
            widths.append(self.sa[-1].out_features)
        # FP k's input: FP k + 1's output (level 4's features for k = 3)
        # beside level k's features
        coarse = [mlp[-1] for mlp in self.FP_MLPS[1:]] + [widths[-1]]
        self.fp = nn.ModuleList(
            FeaturePropagation(c + w, mlp, gen, grouping=grouping)
            for c, w, mlp in zip(coarse, widths, self.FP_MLPS))
        self.dense = nn.ModuleList([
            _dense(self.FP_MLPS[0][-1], 128, False, gen),
            _dense(128, num_classes, True, gen)])
        self.bn = nn.ModuleList([RuntimeBN(128)])

    @staticmethod
    def dropout_shape(pc_shape) -> tuple:
        """The head's dropout mask shape for a batch of `pc_shape`."""
        return (pc_shape[0], pc_shape[1], 128)

    def forward(self, pc: torch.Tensor, bn_momentum: float = 0.1,
                generator: Optional[torch.Generator] = None,
                dropout_mask: Optional[torch.Tensor] = None):
        """pc [B,N,in_channels] -> logits [B,N,num_classes]. In train mode
        the head's dropout takes `dropout_mask` ([B,N,128] bool) or draws
        one from `generator` (on pc's device)."""
        xyz, features = split_pointcloud(pc)
        l_xyz, l_feats = [xyz], [features]
        for sa in self.sa:
            nx, nf = sa(l_xyz[-1], l_feats[-1], bn_momentum)
            l_xyz.append(nx)
            l_feats.append(nf)
        for i in range(-1, -len(self.fp) - 1, -1):
            l_feats[i - 1] = self.fp[i](l_xyz[i - 1], l_xyz[i],
                                        l_feats[i - 1], l_feats[i],
                                        bn_momentum)
        x = torch.relu(self.bn[0](self.dense[0](l_feats[0]), bn_momentum))
        if self.training:
            x = dropout(x, DROPOUT_RATE, generator, dropout_mask)
        return self.dense[1](x)


class PointNet2SemSegSSG(_PointNet2SemSeg):
    """Single-scale-grouping segmenter (`pointnet2_ssg_sem.py:12-94`)."""
    SA_SPECS = ((1024, [0.1], [32], [[32, 32, 64]]),
                (256, [0.2], [32], [[64, 64, 128]]),
                (64, [0.4], [32], [[128, 128, 256]]),
                (16, [0.8], [32], [[256, 256, 512]]))
    FP_MLPS = ([128, 128, 128], [256, 128], [256, 256], [256, 256])


class PointNet2SemSegMSG(_PointNet2SemSeg):
    """Multi-scale-grouping segmenter (`pointnet2_msg_sem.py:12-75`)."""
    SA_SPECS = ((1024, [0.05, 0.1], [16, 32], [[16, 16, 32], [32, 32, 64]]),
                (256, [0.1, 0.2], [16, 32], [[64, 64, 128], [64, 96, 128]]),
                (64, [0.2, 0.4], [16, 32],
                 [[128, 196, 256], [128, 196, 256]]),
                (16, [0.4, 0.8], [16, 32],
                 [[256, 256, 512], [256, 384, 512]]))
    FP_MLPS = ([128, 128], [256, 256], [512, 512], [512, 512])


MODEL_REGISTRY = {
    "cls-ssg": PointNet2ClsSSG,
    "cls-msg": PointNet2ClsMSG,
    "semseg-ssg": PointNet2SemSegSSG,
    "semseg-msg": PointNet2SemSegMSG,
}
