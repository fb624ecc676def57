"""Checkpoint save/restore of the train state (port of
`pctpu/nn/checkpoint.py`): `torch.save` / `torch.load` of
`TrainState.state_dict()` in place of orbax, under the same
`<workdir>/ckpt_{step:08d}` directory names; the newest `keep` stay.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional, Tuple

import torch

STATE_FILE = "state.pt"


def _ckpt_dir(workdir: str, step: int) -> str:
    return os.path.join(os.path.abspath(workdir), f"ckpt_{step:08d}")


def save_checkpoint(workdir: str, state, step: int, keep: int = 2) -> str:
    """Save `state` (a `TrainState`) as checkpoint `step`; prune to the
    newest `keep` checkpoints. The file is written whole, then renamed."""
    path = _ckpt_dir(workdir, step)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(state.state_dict(), tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    existing = sorted(d for d in os.listdir(workdir) if d.startswith("ckpt_"))
    for d in existing[:-keep]:
        shutil.rmtree(os.path.join(workdir, d), ignore_errors=True)
    return path


def latest_checkpoint(workdir: str) -> Optional[Tuple[str, int]]:
    """(path, step) of the newest checkpoint in `workdir`, or None."""
    if not os.path.isdir(workdir):
        return None
    cands = sorted(d for d in os.listdir(workdir) if d.startswith("ckpt_"))
    if not cands:
        return None
    d = cands[-1]
    return os.path.join(workdir, d), int(d.split("_")[1])


def restore_checkpoint(path: str, target):
    """Load checkpoint `path` into `target` (a `TrainState` of the same
    model) in place, its tensors onto the target's devices; returns it."""
    sd = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                    weights_only=True)
    target.load_state_dict(sd)
    return target
