"""Training CLI (port of `pctpu/nn/train_cli.py`):

  python -m pctpu_torch.nn.train_cli task=cls model=msg data=/path [key=value ...]

`key=value` overrides over the preset config tree; `workdir=`,
`resume=true`, `mode=train` and `device=` (default CUDA; `device=cpu`
runs the plain versions of the kernels) as in the reference. Ported:
task=cls (ModelNet40 classification, `ModelNet40Dataset` layout),
models ssg and msg, mode=train. Not yet: task=semseg (the semseg models
and the S3DIS dataset), task=kitti (the KITTI resampled dataset) and
mode=test (`test_report`), each listed in ROADMAP queue A.
"""
from __future__ import annotations

import dataclasses
import sys

from pctpu_torch.nn import config as C
from pctpu_torch.nn.data import ModelNet40Dataset
from pctpu_torch.nn.fit import fit

PRESETS = {
    ("cls", "ssg"): C.MODELNET40_CLS_SSG,
    ("cls", "msg"): C.MODELNET40_CLS_MSG,
}
NOT_PORTED = {
    "semseg": "the semseg models (FeaturePropagation, ops/interpolate.py) "
              "and the S3DIS dataset (ROADMAP queue A, item 2)",
    "kitti": "the KITTI resampled dataset (ROADMAP queue A, item 2: the "
             "datasets)",
}


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
    if task in NOT_PORTED:
        raise NotImplementedError(f"task={task} waits for {NOT_PORTED[task]}")
    if (task, model) not in PRESETS:
        raise SystemExit(f"unknown task/model {task}/{model}")
    if mode != "train":
        raise NotImplementedError(
            f"mode={mode} waits for test_report (ROADMAP queue A, item 2)")
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
    train_ds = ModelNet40Dataset(data_root, cfg.num_points, train=True)
    val_ds = ModelNet40Dataset(data_root, cfg.num_points, train=False)
    out = fit(cfg, train_ds, val_ds, workdir=workdir, resume=resume,
              tensorboard=True, device=device)
    print(f"best val_acc: {out['best_val_acc']:.4f} "
          f"@ epoch {out['best_epoch']}")
    return out


if __name__ == "__main__":
    main()
