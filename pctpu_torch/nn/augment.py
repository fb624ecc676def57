"""Point-cloud augmentations on the device (port of `pctpu/nn/augment.py`).

Each transform is split in two: `draw_<name>(generator, b, n, device)`
draws the random numbers the reference's transform draws (the same
distributions, one set per cloud, from an explicit `torch.Generator`),
and `apply_<name>(pc, params)` is the reference's formula given those
numbers, over a batch [B, N, C]:

  scale: s ~ U[0.8, 1.25), xyz *= s;
  rotate_y: u ~ U[0, 1), angle 2 pi u about y (normals too);
  rotate_perturbation: z ~ N(0, 1)^3, angles clip(0.06 z, +-0.18) about
      x, y, z, R = Rz Ry Rx (normals too);
  jitter: z ~ N(0, 1) per point and xyz, xyz += clip(0.01 z, +-0.05);
  translate: t ~ U[-0.1, 0.1), one scalar added to all three coordinates
      (the reference's quirk);
  random_dropout: ratio ~ U[0, 1), u ~ U[0, 1) per point; a point with
      u <= 0.875 ratio is replaced by point 0 (the reference's quirk).

The draws are not the reference's bits (`jax.random` and torch differ);
the tests feed both the same numbers.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

DEFAULT_TRAIN_PIPELINE = ("scale", "rotate_y", "rotate_perturbation",
                          "translate", "jitter", "random_dropout")


def angle_axis(angle: torch.Tensor, axis) -> torch.Tensor:
    """Rodrigues rotation matrices [..., 3, 3] for angles [...] about one
    axis (normalised first), as `data_utils.py:5-35`."""
    angle = torch.as_tensor(angle, dtype=torch.float32)
    axis = torch.as_tensor(axis, dtype=torch.float32, device=angle.device)
    axis = axis / torch.linalg.norm(axis)
    x, y, z = axis[0], axis[1], axis[2]
    zero = torch.zeros((), device=angle.device)
    cross = torch.stack([torch.stack([zero, -z, y]),
                         torch.stack([z, zero, -x]),
                         torch.stack([-y, x, zero])])
    c, s = torch.cos(angle)[..., None, None], torch.sin(angle)[..., None, None]
    eye = torch.eye(3, device=angle.device)
    return c * eye + s * cross + (1 - c) * torch.outer(axis, axis)


def _apply_rot(pc: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """pc [B,N,C>=3], R [B,3,3]: rotate xyz, and the normals in channels
    3:6 when present."""
    Rt = R.transpose(-1, -2)
    xyz = pc[..., :3] @ Rt
    if pc.shape[-1] >= 6:
        return torch.cat([xyz, pc[..., 3:6] @ Rt, pc[..., 6:]], dim=-1)
    return torch.cat([xyz, pc[..., 3:]], dim=-1)


def _uniform(generator, shape, device, lo=0.0, hi=1.0):
    u = torch.rand(shape, generator=generator, device=device)
    return u * (hi - lo) + lo


def draw_scale(generator, b, n, device, lo=0.8, hi=1.25):
    return _uniform(generator, (b,), device, lo, hi)


def apply_scale(pc, s):
    return torch.cat([pc[..., :3] * s[:, None, None], pc[..., 3:]], dim=-1)


def draw_rotate_y(generator, b, n, device):
    return _uniform(generator, (b,), device)


def apply_rotate_y(pc, u):
    return _apply_rot(pc, angle_axis(u * 2 * math.pi, [0.0, 1.0, 0.0]))


def draw_rotate_perturbation(generator, b, n, device):
    return torch.randn((b, 3), generator=generator, device=device)


def apply_rotate_perturbation(pc, z, angle_sigma=0.06, angle_clip=0.18):
    ang = torch.clamp(angle_sigma * z, -angle_clip, angle_clip)
    Rx = angle_axis(ang[:, 0], [1.0, 0.0, 0.0])
    Ry = angle_axis(ang[:, 1], [0.0, 1.0, 0.0])
    Rz = angle_axis(ang[:, 2], [0.0, 0.0, 1.0])
    return _apply_rot(pc, Rz @ Ry @ Rx)


def draw_jitter(generator, b, n, device):
    return torch.randn((b, n, 3), generator=generator, device=device)


def apply_jitter(pc, z, std=0.01, clip=0.05):
    noise = torch.clamp(std * z, -clip, clip)
    return torch.cat([pc[..., :3] + noise, pc[..., 3:]], dim=-1)


def draw_translate(generator, b, n, device, rng=0.1):
    return _uniform(generator, (b,), device, -rng, rng)


def apply_translate(pc, t):
    return torch.cat([pc[..., :3] + t[:, None, None], pc[..., 3:]], dim=-1)


def draw_random_dropout(generator, b, n, device):
    return (_uniform(generator, (b,), device),
            _uniform(generator, (b, n), device))


def apply_random_dropout(pc, params, max_ratio=0.875):
    ratio, u = params
    drop = u <= ratio[:, None] * max_ratio
    return torch.where(drop[..., None], pc[:, :1, :], pc)


TRANSFORMS = {
    "scale": (draw_scale, apply_scale),
    "rotate_y": (draw_rotate_y, apply_rotate_y),
    "rotate_perturbation": (draw_rotate_perturbation,
                            apply_rotate_perturbation),
    "jitter": (draw_jitter, apply_jitter),
    "translate": (draw_translate, apply_translate),
    "random_dropout": (draw_random_dropout, apply_random_dropout),
}


def augment_batch(generator: torch.Generator, pc: torch.Tensor,
                  pipeline: Sequence[str] = DEFAULT_TRAIN_PIPELINE
                  ) -> torch.Tensor:
    """[B,N,C] on the generator's device, the transforms in `pipeline`'s
    order (`pointnet2_ssg_cls.py:198-208`), independent draws per cloud."""
    b, n = pc.shape[0], pc.shape[1]
    for name in pipeline:
        draw, apply = TRANSFORMS[name]
        pc = apply(pc, draw(generator, b, n, pc.device))
    return pc


def augment(generator: torch.Generator, pc: torch.Tensor,
            pipeline: Sequence[str] = DEFAULT_TRAIN_PIPELINE) -> torch.Tensor:
    """One cloud [N,C]."""
    return augment_batch(generator, pc[None], pipeline)[0]


def pc_normalize(pc: torch.Tensor) -> torch.Tensor:
    """Centre on the centroid and scale into the unit sphere
    (`ModelNet40Loader.py:17-23`), xyz only, over [..., N, C]."""
    xyz = pc[..., :3]
    xyz = xyz - xyz.mean(dim=-2, keepdim=True)
    m = torch.sqrt((xyz ** 2).sum(-1)).amax(dim=-1)
    return torch.cat([xyz / m[..., None, None], pc[..., 3:]], dim=-1)
