"""Training harness (port of `pctpu/nn/train.py`): the train state, the lr
and BN-momentum schedules, the optimizer, model construction, the train
and eval steps.

  * lr schedule: lr * lr_decay^floor(step*bs/decay_step), floored at lr_clip
  * BN-momentum schedule: bnm * bnm_decay^floor(step*bs/decay_step),
    floored at bnm_clip, fed to the model's runtime-momentum BN
  * optimizer: optax's chain, formula for formula (`make_optimizer`)

Both schedules are computed in float32, as the reference's jnp arithmetic
is. The step updates the state in place (parameters, BN statistics,
moments, step) where the reference returns a new one.

`make_data_parallel_train_step` is the reference's data-parallel step
(`jax.jit` with the batch sharded and the parameters replicated): one
process per rank, the batch split over a mesh axis, and the result the
one-process step's on the whole batch.
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import List, Optional

import torch

from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.models.pointnet2 import (DROPOUT_RATE, MODEL_REGISTRY,
                                          dropout_keep, global_batch_stats)
from pctpu_torch.nn.config import TrainConfig
from pctpu_torch.parallel.mesh import all_reduce, broadcast, shard_batch

F32 = torch.float32


def schedule_factor(cfg: TrainConfig, step: int) -> torch.Tensor:
    """Shared decay exponent: floor(step * batch_size / decay_step), the
    product in int32 and the quotient in float32."""
    s = torch.tensor(step, dtype=torch.int32) * cfg.batch_size
    return torch.floor(s / cfg.decay_step)


def _decayed(cfg: TrainConfig, step: int, base: float, decay: float,
             clip: float) -> float:
    f = schedule_factor(cfg, step)
    return float(torch.clamp_min(base * torch.tensor(decay, dtype=F32) ** f,
                                 clip))


def lr_schedule(cfg: TrainConfig, step: int) -> float:
    return _decayed(cfg, step, cfg.lr, cfg.lr_decay, cfg.lr_clip)


def bn_momentum_schedule(cfg: TrainConfig, step: int) -> float:
    return _decayed(cfg, step, cfg.bn_momentum, cfg.bnm_decay, cfg.bnm_clip)


def compute_dtype(cfg: TrainConfig) -> torch.dtype:
    """cfg.compute_dtype ("float32", "bfloat16", ...) as a torch dtype."""
    dtype = getattr(torch, cfg.compute_dtype, None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"compute_dtype={cfg.compute_dtype!r} is not a "
                         "floating dtype")
    return dtype


def build_model(cfg: TrainConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None,
                in_channels: Optional[int] = None) -> torch.nn.Module:
    """The configured model in eval mode on `device` (CUDA unless "cpu" is
    asked for). Weights are initialised on the CPU from `generator`
    (default: a CPU generator seeded with `cfg.seed`), then moved.
    `in_channels` is the input cloud's channel count (default: 9 for the
    segmenters, S3DIS's xyz + rgb + normalised xyz; 6 for the
    classifiers, ModelNet40's xyz + normals). `grouping` goes to every
    model and `compute_dtype` only to the models that take one, as in the
    reference (`pctpu/nn/train.py:56-63`): the segmenters run in float32
    whatever it says."""
    dev = resolve_device(device)
    if cfg.model not in MODEL_REGISTRY:
        raise KeyError(f"model {cfg.model!r}; one of "
                       f"{sorted(MODEL_REGISTRY)}")
    cls = MODEL_REGISTRY[cfg.model]
    if in_channels is None:
        in_channels = 9 if cfg.model.startswith("semseg") else 6
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    kwargs = dict(num_classes=cfg.num_classes, use_xyz=cfg.use_xyz,
                  grouping=cfg.grouping, in_channels=in_channels,
                  generator=generator)
    if "dtype" in inspect.signature(cls).parameters:
        kwargs["dtype"] = compute_dtype(cfg)
    return cls(**kwargs).to(dev).eval()


@dataclasses.dataclass
class AdamState:
    """scale_by_adam's state: the update count and the two moments, one
    tensor per parameter in `model.parameters()` order."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]


class Optimizer:
    """The reference's optax chain (`make_optimizer`), formula for formula:

      clip_by_global_norm(grad_clip)  (when grad_clip): g * max / |g| where
          |g| >= max, with no epsilon;
      scale_by_adam(b1, b2, eps, eps_root = 0): mu = (1-b1) g + b1 mu,
          nu = (1-b2) g^2 + b2 nu, count += 1, u = mu_hat / (sqrt(nu_hat)
          + eps) with mu_hat = mu / (1 - b1^count), likewise nu_hat;
      add_decayed_weights(weight_decay)  (when weight_decay): u += wd * p,
          decoupled, ahead of the learning rate;
      scale_by_learning_rate(lr_schedule): u *= -lr_schedule(n) with n the
          number of earlier updates;

    then p += u. Not torch.optim.Adam: its weight_decay is L2 added to the
    gradient, and clip_grad_norm_ adds 1e-6 to the norm."""

    def __init__(self, cfg: TrainConfig, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.cfg, self.b1, self.b2, self.eps = cfg, b1, b2, eps

    def init(self, params: List[torch.Tensor]) -> AdamState:
        return AdamState(0, [torch.zeros_like(p) for p in params],
                         [torch.zeros_like(p) for p in params])

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], state: AdamState,
               params: List[torch.Tensor]) -> None:
        """Apply one update to `params` and `state`, in place."""
        cfg, b1, b2 = self.cfg, self.b1, self.b2
        g = list(grads)
        if cfg.grad_clip:
            norm = torch.sqrt(sum(torch.sum(t * t) for t in g))
            keep = norm < cfg.grad_clip
            g = [torch.where(keep, t, (t / norm) * cfg.grad_clip) for t in g]
        lr = lr_schedule(cfg, state.count)
        state.mu = torch._foreach_add(torch._foreach_mul(g, 1.0 - b1),
                                      torch._foreach_mul(state.mu, b1))
        sq = torch._foreach_mul(g, g)
        state.nu = torch._foreach_add(torch._foreach_mul(sq, 1.0 - b2),
                                      torch._foreach_mul(state.nu, b2))
        state.count += 1
        bc1 = float(1.0 - torch.tensor(b1, dtype=F32) ** state.count)
        bc2 = float(1.0 - torch.tensor(b2, dtype=F32) ** state.count)
        den = torch._foreach_add(
            torch._foreach_sqrt(torch._foreach_div(state.nu, bc2)), self.eps)
        u = torch._foreach_div(torch._foreach_div(state.mu, bc1), den)
        if cfg.weight_decay:
            u = torch._foreach_add(u, torch._foreach_mul(params,
                                                         cfg.weight_decay))
        torch._foreach_add_(params, torch._foreach_mul(u, -lr))


def make_optimizer(cfg: TrainConfig) -> Optimizer:
    return Optimizer(cfg)


@dataclasses.dataclass
class TrainState:
    """The module (its parameters and BN running statistics), the
    optimizer's moments and the step count."""
    model: torch.nn.Module
    opt_state: AdamState
    step: int

    def state_dict(self) -> dict:
        """Everything a checkpoint holds, as CPU tensors and ints."""
        o = self.opt_state
        return {"model": {k: v.detach().cpu()
                          for k, v in self.model.state_dict().items()},
                "opt_state": {"count": o.count,
                              "mu": [t.cpu() for t in o.mu],
                              "nu": [t.cpu() for t in o.nu]},
                "step": self.step}

    def load_state_dict(self, sd: dict) -> None:
        self.model.load_state_dict(sd["model"], strict=True)
        o, dev = sd["opt_state"], self.opt_state.mu[0].device
        if len(o["mu"]) != len(self.opt_state.mu):
            raise ValueError("checkpoint: optimizer moments do not match "
                             "the model's parameters")
        self.opt_state = AdamState(int(o["count"]),
                                   [t.to(dev) for t in o["mu"]],
                                   [t.to(dev) for t in o["nu"]])
        self.step = int(sd["step"])


def create_train_state(cfg: TrainConfig,
                       generator: Optional[torch.Generator] = None,
                       sample_input=None, device: DeviceLike = None):
    """(model, TrainState): the configured model on `device` (CUDA unless
    "cpu" is asked for), initialised from `generator` (default: seeded
    with cfg.seed), its channel count taken from `sample_input`
    ([..., N, C]; default `build_model`'s), fresh optimizer moments, step
    0."""
    in_channels = (None if sample_input is None
                   else int(sample_input.shape[-1]))
    model = build_model(cfg, device, generator, in_channels)
    opt_state = make_optimizer(cfg).init(list(model.parameters()))
    return model, TrainState(model, opt_state, 0)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax CE over [B,C] + [B] (or [B,N,C] + [B,N])."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels.long()[..., None])[..., 0].mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, dim=-1) == labels).float().mean()


def loss_and_grads(model: torch.nn.Module, pc: torch.Tensor,
                   labels: torch.Tensor, bn_momentum: float,
                   generator: Optional[torch.Generator] = None,
                   dropout_mask: Optional[torch.Tensor] = None):
    """The reference's `loss_fn` and its gradient: the model in train mode
    (BN batch statistics, running ones moved by `bn_momentum`; dropout
    from `generator` or `dropout_mask`) -> (loss, logits, gradients in
    `model.parameters()` order)."""
    model.train()
    params = list(model.parameters())
    logits = model(pc, bn_momentum=bn_momentum, generator=generator,
                   dropout_mask=dropout_mask)
    loss = cross_entropy(logits, labels)
    grads = torch.autograd.grad(loss, params)
    return loss.detach(), logits.detach(), list(grads)


def make_train_step(model: torch.nn.Module, cfg: TrainConfig, tx=None,
                    device: DeviceLike = None):
    """train_step(state, pc, labels, generator, dropout_mask=None) ->
    {"loss", "acc", "lr"}: one step of the reference's recipe on `device`
    (CUDA unless "cpu" is asked for), updating `state` in place. pc and
    labels may be numpy arrays or tensors; `generator` (on the model's
    device) draws the dropout mask unless `dropout_mask` is given."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"the model is on {model_dev}, the step on {dev}")
    tx = make_optimizer(cfg) if tx is None else tx
    params = list(model.parameters())

    def train_step(state: TrainState, pc, labels,
                   generator: Optional[torch.Generator] = None,
                   dropout_mask: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        pc = torch.as_tensor(pc, dtype=torch.float32, device=model_dev)
        labels = torch.as_tensor(labels, device=model_dev)
        lr = lr_schedule(cfg, state.step)
        loss, logits, grads = loss_and_grads(
            model, pc, labels, bn_momentum_schedule(cfg, state.step),
            generator, dropout_mask)
        tx.update(grads, state.opt_state, params)
        state.step += 1
        return {"loss": loss, "acc": accuracy(logits, labels), "lr": lr}
    return train_step


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


def make_data_parallel_train_step(model: torch.nn.Module, cfg: TrainConfig,
                                  mesh, data_axis: str = "data",
                                  device: DeviceLike = None):
    """train_step(state, pc, labels, generator, dropout_mask=None) ->
    {"loss", "acc", "lr"}: `make_train_step`'s step on the whole batch,
    computed by the ranks of `mesh`'s `data_axis` together. Call it on
    every rank with the same arguments: pc and labels are the whole batch
    (B must divide by the axis size), as the reference's signature takes
    the global batch, and each rank slices its contiguous block of rows.

    So that the step is the one-process step on the whole batch: the BN
    layers take their batch statistics over the whole batch
    (`models.pointnet2.global_batch_stats`); each rank's loss is its sum
    over the whole batch's count, and the gradients are summed over the
    ranks, giving the gradient of the whole batch's mean; the dropout mask
    is drawn for the whole batch from `generator` (as the one-process
    step draws it) or given whole, and each rank takes its rows; the loss
    and accuracy are the whole batch's. Rank 0's parameters and BN
    statistics are copied to every rank when the step is made. Runs on
    CUDA unless "cpu" is asked for."""
    dev = resolve_device(device)
    model_dev = next(model.parameters()).device
    if model_dev.type != dev.type:
        raise ValueError(f"the model is on {model_dev}, the step on {dev}")
    tx = make_optimizer(cfg)
    params = list(model.parameters())
    group = mesh.group(data_axis)
    shard = shard_batch(mesh, data_axis)
    with torch.no_grad():
        for t in [*params, *model.buffers()]:
            t.copy_(broadcast(t, group))

    def train_step(state: TrainState, pc, labels,
                   generator: Optional[torch.Generator] = None,
                   dropout_mask: Optional[torch.Tensor] = None):
        if state.model is not model:
            raise ValueError("train_step: the state holds another model")
        pc = torch.as_tensor(pc, dtype=torch.float32, device=model_dev)
        labels = torch.as_tensor(labels, device=model_dev)
        if dropout_mask is None:
            dropout_mask = dropout_keep(model.dropout_shape(pc.shape),
                                        DROPOUT_RATE, generator, model_dev)
        rows = shard.rows(pc.shape[0])
        mask = torch.as_tensor(dropout_mask, device=model_dev)[rows]
        lab = labels[rows]
        count = float(labels.numel())
        lr = lr_schedule(cfg, state.step)
        model.train()
        with global_batch_stats(model, group):
            logits = model(pc[rows], bn_momentum=bn_momentum_schedule(
                cfg, state.step), dropout_mask=mask)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, -1, lab.long()[..., None])[..., 0]
            loss = nll.sum() / torch.tensor(count, device=model_dev)
            grads = torch.autograd.grad(loss, params)
        flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), group)
        grads = list(torch.split(flat, [p.numel() for p in params]))
        grads = [g.view_as(p) for g, p in zip(grads, params)]
        tx.update(grads, state.opt_state, params)
        state.step += 1
        hits = (torch.argmax(logits.detach(), dim=-1) == lab).float().sum()
        sums = all_reduce(torch.stack([loss.detach(), hits]), group)
        return {"loss": sums[0],
                "acc": sums[1] / torch.tensor(count, device=model_dev),
                "lr": lr}
    return train_step
