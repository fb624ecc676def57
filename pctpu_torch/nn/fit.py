"""Evaluation loop (port of `pctpu/nn/fit.py:evaluate`). The training
loop, checkpoints and logging are not ported yet."""
from __future__ import annotations

import numpy as np

from pctpu_torch.device import DeviceLike
from pctpu_torch.nn import train as T
from pctpu_torch.nn.data import iterate_batches


def evaluate(model, dataset, batch_size: int, collect_logits: bool = False,
             device: DeviceLike = None):
    """Mean loss and accuracy of `model` over `dataset` (indexable, items
    (cloud [N,C], label)) in full batches, in order; with
    `collect_logits` also the labels and the predicted classes."""
    ev = T.make_eval_step(model, device)
    losses, accs, ys, preds = [], [], [], []
    for pc, labels in iterate_batches(dataset, batch_size, shuffle=False):
        out = ev(pc, labels)
        losses.append(float(out["loss"]))
        accs.append(float(out["acc"]))
        if collect_logits:
            ys.append(labels)
            preds.append(out["logits"].argmax(dim=-1).cpu().numpy())
    res = {"loss": float(np.mean(losses)) if losses else float("nan"),
           "acc": float(np.mean(accs)) if accs else float("nan")}
    if collect_logits and ys:
        res["labels"] = np.concatenate([y.reshape(-1) for y in ys])
        res["preds"] = np.concatenate([p.reshape(-1) for p in preds])
    return res
