"""Training and evaluation loops (port of `pctpu/nn/fit.py`): `fit` with
on-device augmentation, early stopping and checkpoints on the best val
accuracy, resume and `max_steps`; `Logger`; `evaluate`; `test_report`
(a confusion matrix counted with numpy, sklearn's classification report,
optionally the reference's heatmap PNG).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.nn import augment as aug
from pctpu_torch.nn import checkpoint as ckpt
from pctpu_torch.nn import train as T
from pctpu_torch.nn.config import TrainConfig
from pctpu_torch.nn.data import iterate_batches


class Logger:
    """stdout + `train.log`, JSONL metric history (`metrics.jsonl`) and,
    when asked for and `torch.utils.tensorboard` imports, TensorBoard
    scalars under `tb/`. `close()` releases the files."""

    def __init__(self, workdir: Optional[str], tensorboard: bool = False):
        self.f = self.jsonl = self.tb = None
        if workdir:
            os.makedirs(workdir, exist_ok=True)
            self.f = open(os.path.join(workdir, "train.log"), "a")
            self.jsonl = open(os.path.join(workdir, "metrics.jsonl"), "a")
            if tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    SummaryWriter = None
                if SummaryWriter is not None:
                    self.tb = SummaryWriter(os.path.join(workdir, "tb"))

    def log(self, msg: str):
        print(msg)
        if self.f:
            self.f.write(msg + "\n")
            self.f.flush()

    def metrics(self, record: Dict):
        if self.jsonl:
            self.jsonl.write(json.dumps(record) + "\n")
            self.jsonl.flush()
        if self.tb is not None and "epoch" in record:
            for k, v in record.items():
                if isinstance(v, (int, float)) and k != "epoch":
                    self.tb.add_scalar(k, v, record["epoch"])

    def close(self):
        for handle in (self.f, self.jsonl, self.tb):
            if handle is not None:
                handle.close()


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


def step_generator(seed: int, step: int, stream: int,
                   device: torch.device) -> torch.Generator:
    """The generator of one random stream (0 augmentation, 1 dropout) at
    one global step, seeded from (seed, step, stream): a resumed run draws
    what an uninterrupted one would."""
    s = np.random.SeedSequence([seed, step, stream]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(s))


def fit(cfg: TrainConfig, train_ds, val_ds=None,
        workdir: Optional[str] = None,
        resume: bool = False,
        augment_pipeline=aug.DEFAULT_TRAIN_PIPELINE,
        early_stop_patience: int = 5,
        eval_interval: int = 1,
        ckpt_keep: int = 2,
        max_steps: Optional[int] = None,
        tensorboard: bool = False,
        device: DeviceLike = None) -> Dict[str, Any]:
    """Train to cfg.epochs (or max_steps) on `device` (CUDA unless "cpu"
    is asked for); returns a summary with the best val accuracy. A
    checkpoint is saved at each new best (step = epoch + 1); `resume`
    restarts from the newest one at its epoch."""
    dev = resolve_device(device)
    log = Logger(workdir, tensorboard=tensorboard)
    try:
        sample_pc, _ = train_ds[0]
        model, state = T.create_train_state(
            cfg, torch.Generator().manual_seed(cfg.seed),
            np.asarray(sample_pc), device=dev)
        step_fn = T.make_train_step(model, cfg, device=dev)

        start_epoch = 0
        if resume and workdir:
            latest = ckpt.latest_checkpoint(workdir)
            if latest:
                path, step = latest
                state = ckpt.restore_checkpoint(path, state)
                start_epoch = step
                log.log(f"resumed from {path} (epoch {start_epoch})")

        best_acc, best_epoch, stale = -1.0, -1, 0
        steps_done = 0
        for epoch in range(start_epoch, cfg.epochs):
            t0 = time.time()
            tr_loss, tr_acc, nb = 0.0, 0.0, 0
            for pc, labels in iterate_batches(train_ds, cfg.batch_size,
                                              shuffle=True,
                                              seed=cfg.seed + epoch):
                pc_dev = torch.as_tensor(pc, dtype=torch.float32, device=dev)
                if augment_pipeline:
                    pc_dev = aug.augment_batch(
                        step_generator(cfg.seed, state.step, 0, dev), pc_dev,
                        augment_pipeline)
                metrics = step_fn(state, pc_dev, labels, step_generator(
                    cfg.seed, state.step, 1, dev))
                tr_loss += float(metrics["loss"])
                tr_acc += float(metrics["acc"])
                nb += 1
                steps_done += 1
                if max_steps and steps_done >= max_steps:
                    break
            rec = {"epoch": epoch, "train_loss": tr_loss / max(nb, 1),
                   "train_acc": tr_acc / max(nb, 1),
                   "time_s": round(time.time() - t0, 2)}

            if val_ds is not None and (epoch + 1) % eval_interval == 0:
                val = evaluate(model, val_ds, cfg.batch_size, device=dev)
                rec.update(val_loss=val["loss"], val_acc=val["acc"])
                if val["acc"] > best_acc:
                    best_acc, best_epoch, stale = val["acc"], epoch, 0
                    if workdir:
                        ckpt.save_checkpoint(workdir, state, epoch + 1,
                                             ckpt_keep)
                else:
                    stale += 1
            log.log(f"epoch {epoch}: " + " ".join(
                f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                for k, v in rec.items()))
            log.metrics(rec)
            if max_steps and steps_done >= max_steps:
                break
            if val_ds is not None and stale >= early_stop_patience:
                log.log(f"early stop at epoch {epoch} "
                        f"(best val_acc {best_acc:.4f} @ {best_epoch})")
                break
    finally:
        log.close()

    return {"model": model, "state": state, "best_val_acc": best_acc,
            "best_epoch": best_epoch, "steps": steps_done}


def confusion_matrix(labels: np.ndarray, preds: np.ndarray,
                     ids: Optional[Sequence[int]] = None) -> np.ndarray:
    """sklearn's `confusion_matrix(labels, preds, labels=ids)` counted
    with numpy: [k, k] int64, row = true class, column = predicted, in the
    order of `ids` (default: the sorted classes seen in either); a pair
    with a class outside `ids` is not counted."""
    labels, preds = np.asarray(labels).ravel(), np.asarray(preds).ravel()
    ids = (np.unique(np.concatenate([labels, preds])) if ids is None
           else np.asarray(ids))
    k = len(ids)
    if k == 0:
        return np.zeros((0, 0), np.int64)
    order = np.argsort(ids, kind="stable")

    def position(x):                    # index into ids, -1 if absent
        at = np.clip(np.searchsorted(ids[order], x), 0, k - 1)
        return np.where(ids[order][at] == x, order[at], -1)
    t, p = position(labels), position(preds)
    keep = (t >= 0) & (p >= 0)
    return np.bincount(t[keep] * k + p[keep], minlength=k * k).reshape(
        k, k).astype(np.int64)


def test_report(model, test_ds, batch_size: int,
                class_names: Optional[Iterable[str]] = None,
                heatmap_path: Optional[str] = None,
                device: DeviceLike = None) -> Dict:
    """Accuracy, confusion matrix and sklearn's classification report of
    `model` over `test_ds` on `device` (CUDA unless "cpu" is asked for);
    with `heatmap_path` also the reference's annotated heatmap PNG. With
    class names the label ids are 0..len(names) - 1, so the matrix keeps
    its shape when a class is absent. sklearn is imported here, as the
    reference does: without it this raises ImportError."""
    from sklearn.metrics import classification_report
    res = evaluate(model, test_ds, batch_size, collect_logits=True,
                   device=device)
    labels, preds = res["labels"], res["preds"]
    names = list(class_names) if class_names else None
    ids = list(range(len(names))) if names else None
    cm = confusion_matrix(labels, preds, ids)
    report = classification_report(labels, preds, zero_division=0,
                                   labels=ids, target_names=names)
    if heatmap_path:
        _render_confusion_heatmap(cm, names, heatmap_path)
    return {"acc": res["acc"], "confusion_matrix": cm, "report": report}


def _render_confusion_heatmap(cm: np.ndarray, class_names,
                              path: str) -> None:
    """An annotated confusion-matrix heatmap PNG (the reference's
    artifact), drawn with matplotlib's Agg backend."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    names = list(class_names) if class_names else [
        str(i) for i in range(cm.shape[0])]
    names = names[:cm.shape[0]]
    fig, ax = plt.subplots(figsize=(5, 4.2))
    im = ax.imshow(cm, cmap="Blues")
    ax.set_xticks(range(cm.shape[1]), names, rotation=45, ha="right")
    ax.set_yticks(range(cm.shape[0]), names)
    ax.set_xlabel("predicted")
    ax.set_ylabel("true")
    thresh = cm.max() / 2.0 if cm.size else 0
    for i in range(cm.shape[0]):
        for j in range(cm.shape[1]):
            ax.text(j, i, str(cm[i, j]), ha="center", va="center",
                    color="white" if cm[i, j] > thresh else "black")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fig.savefig(path, dpi=110)
    plt.close(fig)
