"""Training configuration presets (copy of `pctpu/nn/config.py`).

One dataclass config tree; preset values are the reference's exact
hyperparameters.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str = "cls-ssg"          # key into models.MODEL_REGISTRY
    num_classes: int = 40
    num_points: int = 4096
    batch_size: int = 32
    epochs: int = 200
    lr: float = 1e-3
    lr_decay: float = 0.7
    decay_step: float = 2e4         # in *samples* (step * batch_size)
    lr_clip: float = 1e-5
    bn_momentum: float = 0.5
    bnm_decay: float = 0.5
    bnm_clip: float = 1e-2
    weight_decay: float = 0.0
    grad_clip: float = 0.0          # 0 = off (Final_Project uses 1.0)
    use_xyz: bool = True
    grouping: str = "ball"          # or 'window' (no gathers, no kernel)
    compute_dtype: str = "float32"  # 'bfloat16': the classifiers' Dense
    seed: int = 0


# Reference presets -----------------------------------------------------------

# `config/task/cls.yaml` (+ model group choice)
MODELNET40_CLS_SSG = TrainConfig(model="cls-ssg")
MODELNET40_CLS_MSG = TrainConfig(model="cls-msg")

# `config/task/semseg.yaml`
S3DIS_SEMSEG_SSG = TrainConfig(
    model="semseg-ssg", num_classes=13, batch_size=24, epochs=50,
    lr_decay=0.5, decay_step=3e5)
S3DIS_SEMSEG_MSG = dataclasses.replace(S3DIS_SEMSEG_SSG, model="semseg-msg")

# Final_Project KITTI 4-class classifier
# (`Final_Project/pointnet2/train.py:22-42`: bs 8, 64 pts x 6ch, Adam 1e-3,
#  1/(epoch+1) LR lambda, grad clip 1.0, 20+ epochs; models forked to 4 cls)
KITTI_CLS_MSG = TrainConfig(
    model="cls-msg", num_classes=4, num_points=64, batch_size=8, epochs=20,
    grad_clip=1.0)
