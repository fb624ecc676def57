"""Model construction and the evaluation step (port of the serving part
of `pctpu/nn/train.py`): `build_model`, `cross_entropy`, `accuracy` and
`make_eval_step`. The train step, its schedules and the optimizer are not
ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.models.pointnet2 import MODEL_REGISTRY
from pctpu_torch.nn.config import TrainConfig


def build_model(cfg: TrainConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                in_channels: int = 6) -> torch.nn.Module:
    """The configured classifier in eval mode on `device` (CUDA unless
    "cpu" is asked for). Weights are initialised on the CPU from
    `generator` (default: a CPU generator seeded with `cfg.seed`), then
    moved. `in_channels` is the input cloud's channel count (ModelNet40:
    xyz + normals = 6)."""
    dev = resolve_device(device)
    if cfg.model not in MODEL_REGISTRY:
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet; "
                                  f"ported: {sorted(MODEL_REGISTRY)}")
    if cfg.compute_dtype != "float32":
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r} is not ported yet")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    model = MODEL_REGISTRY[cfg.model](
        num_classes=cfg.num_classes, use_xyz=cfg.use_xyz,
        grouping=cfg.grouping, in_channels=in_channels, generator=generator)
    return model.to(dev).eval()


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE over [B,C] + [B] (or [B,N,C] + [B,N])."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean()


def make_eval_step(model: torch.nn.Module, device: DeviceLike = None):
    """eval_step(pc, labels) -> {"loss", "acc", "logits"}: the model in
    eval mode, under no_grad, on `device` (CUDA unless "cpu" is asked
    for); pc and labels may be numpy arrays or tensors."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"the model is on {model_dev}, the step on {dev}")

    @torch.no_grad()
    def eval_step(pc, labels):
        model.eval()
        pc = torch.as_tensor(pc, dtype=torch.float32, device=model_dev)
        labels = torch.as_tensor(labels, device=model_dev)
        logits = model(pc)
        return {"loss": cross_entropy(logits, labels),
                "acc": accuracy(logits, labels), "logits": logits}
    return eval_step
