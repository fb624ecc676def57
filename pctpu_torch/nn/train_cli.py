"""Training CLI (port of `pctpu/nn/train_cli.py`):

  python -m pctpu_torch.nn.train_cli task=cls model=msg data=/path [key=value ...]

`key=value` overrides over the preset config tree; `workdir=`,
`resume=true`, `mode=train|test` and `device=` (default CUDA; `device=cpu`
runs the plain versions of the kernels) as in the reference. Tasks, each
with models ssg and msg:
  cls    - ModelNet40 classification (`ModelNet40Dataset` layout)
  semseg - S3DIS semantic segmentation (indoor3d HDF5 layout)
  kitti  - the 4-class KITTI object classifier (resampled dataset layout:
           train.txt / test.txt)
mode=test restores the newest checkpoint in `workdir` (fresh weights when
there is none) and prints sklearn's classification report and the
confusion matrix of the test split; it needs scikit-learn.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np
import torch

from pctpu_torch.nn import checkpoint as ckpt
from pctpu_torch.nn import config as C
from pctpu_torch.nn import train as T
from pctpu_torch.nn.data import (KITTIResampledDataset, ModelNet40Dataset,
                                 S3DISDataset)
from pctpu_torch.nn.fit import fit, test_report

PRESETS = {
    ("cls", "ssg"): C.MODELNET40_CLS_SSG,
    ("cls", "msg"): C.MODELNET40_CLS_MSG,
    ("semseg", "ssg"): C.S3DIS_SEMSEG_SSG,
    ("semseg", "msg"): C.S3DIS_SEMSEG_MSG,
    ("kitti", "msg"): C.KITTI_CLS_MSG,
    ("kitti", "ssg"): dataclasses.replace(C.KITTI_CLS_MSG, model="cls-ssg"),
}


def datasets(task: str, root: str, num_points: int):
    """(train, test, class names or None) of a task's layout at `root`."""
    if task == "cls":
        train = ModelNet40Dataset(root, num_points, train=True)
        return train, ModelNet40Dataset(root, num_points, train=False), \
            train.categories
    if task == "semseg":
        return (S3DISDataset(root, num_points, train=True),
                S3DISDataset(root, num_points, train=False), None)
    train = KITTIResampledDataset(root, "train.txt")
    return train, KITTIResampledDataset(root, "test.txt"), train.categories


def parse_overrides(argv):
    kv = {}
    for arg in argv:
        if arg in ("--help", "-h", "help"):
            print(__doc__)
            print("Config keys (override with key=value):")
            for f in dataclasses.fields(C.TrainConfig):
                print(f"  {f.name} (default {f.default!r})")
            raise SystemExit(0)
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg!r}")
        k, v = arg.split("=", 1)
        kv[k] = v
    return kv


def main(argv=None):
    kv = parse_overrides(sys.argv[1:] if argv is None else argv)
    task = kv.pop("task", "cls")
    model = kv.pop("model", "ssg")
    data_root = kv.pop("data", None)
    workdir = kv.pop("workdir", f"runs/{task}_{model}")
    resume = kv.pop("resume", "false").lower() == "true"
    mode = kv.pop("mode", "train")
    device = kv.pop("device", None)
    if (task, model) not in PRESETS:
        raise SystemExit(f"unknown task/model {task}/{model}")
    if mode not in ("train", "test"):
        raise SystemExit(f"unknown mode {mode}")
    cfg = PRESETS[(task, model)]
    fields = {f.name for f in dataclasses.fields(C.TrainConfig)}
    casts = {}
    for k, v in kv.items():
        if k not in fields:
            raise SystemExit(f"unknown config key {k}")
        cur = getattr(cfg, k)
        casts[k] = type(cur)(v) if not isinstance(cur, bool) \
            else v.lower() == "true"
    cfg = dataclasses.replace(cfg, **casts)

    if data_root is None:
        raise SystemExit("data=<dataset root> is required")
    train_ds, test_ds, class_names = datasets(task, data_root,
                                              cfg.num_points)
    if mode == "train":
        out = fit(cfg, train_ds, test_ds, workdir=workdir, resume=resume,
                  tensorboard=True, device=device)
        print(f"best val_acc: {out['best_val_acc']:.4f} "
              f"@ epoch {out['best_epoch']}")
        return out
    sample_pc, _ = test_ds[0]
    model_obj, state = T.create_train_state(
        cfg, torch.Generator().manual_seed(0), np.asarray(sample_pc),
        device=device)
    latest = ckpt.latest_checkpoint(workdir)
    if latest:
        state = ckpt.restore_checkpoint(latest[0], state)
    rep = test_report(model_obj, test_ds, cfg.batch_size,
                      class_names=class_names, device=device)
    print(rep["report"])
    print(rep["confusion_matrix"])
    return rep


if __name__ == "__main__":
    main()
