"""Weights of the JAX package's PointNet++ models into the port's
modules.

Input: the flax variables `{"params": ..., "batch_stats": ...}` flattened
to numpy arrays under `/`-joined names, collection first, e.g.
`params/SetAbstraction_0/SharedMLP_1/Dense_0/kernel`,
`params/Dense_2/bias`, `batch_stats/RuntimeBN_0/mean`. Each flax module
`Name_k` is the k-th entry of the port's list attribute for that name
(`SetAbstraction` -> `sa`, `SharedMLP` -> `mlps`, `Dense` -> `dense`,
`RuntimeBN` -> `bn`, `FeaturePropagation` -> `fp`,
`CheckpointWindowScale` -> `scales` (flax's name for `nn.remat` of
`WindowScale`), `FoldedDenseBNRelu` -> `folded`); a `kernel [in, out]`
(of a Dense or a folded layer) becomes a `weight [out, in]`.

The same names cover the PointRCNN modules (`models/pointrcnn.py`):
`ProposalNet`'s window SA levels, feature propagation and its two Dense
heads, `RefineNet`'s shared MLP and heads. flax numbers the modules of a
compact body in creation order, and the reference creates `ProposalNet`'s
feature-propagation modules from the coarsest level down, so
`FeaturePropagation_0` is the one at level 2; the port's `fp` list keeps
that order.
"""
from __future__ import annotations

import re
from typing import Mapping, Tuple

import numpy as np
import torch

MODULES = {"SetAbstraction": "sa", "SharedMLP": "mlps", "Dense": "dense",
           "RuntimeBN": "bn", "FeaturePropagation": "fp",
           "CheckpointWindowScale": "scales", "FoldedDenseBNRelu": "folded"}
LEAVES = {"kernel": "weight", "bias": "bias", "scale": "scale",
          "mean": "mean", "var": "var"}
COLLECTIONS = ("params", "batch_stats")


def torch_name(flax_name: str) -> Tuple[str, bool]:
    """`params/SetAbstraction_0/SharedMLP_1/Dense_0/kernel` ->
    (`sa.0.mlps.1.dense.0.weight`, True); the flag says the value is
    transposed."""
    collection, *path, leaf = flax_name.split("/")
    if collection not in COLLECTIONS or leaf not in LEAVES:
        raise KeyError(f"unknown flax variable {flax_name!r}")
    parts = []
    for p in path:
        match = re.fullmatch(r"([A-Za-z]+)_(\d+)", p)
        if match is None or match.group(1) not in MODULES:
            raise KeyError(f"unknown flax module {p!r} in {flax_name!r}")
        parts += [MODULES[match.group(1)], match.group(2)]
    return ".".join(parts + [LEAVES[leaf]]), leaf == "kernel"


def state_dict_from_flax(flat: Mapping[str, np.ndarray],
                         model: torch.nn.Module) -> dict:
    """The `state_dict` of `model` with every entry taken from `flat`.
    Raises on a flax variable the model has no place for, on a model entry
    no flax variable fills, and on a shape mismatch."""
    want = model.state_dict()
    out = {}
    for name, value in flat.items():
        key, transpose = torch_name(name)
        if key not in want:
            raise KeyError(f"{name!r} -> {key!r}: not in the model")
        if key in out:
            raise KeyError(f"{name!r} -> {key!r}: filled twice")
        t = torch.from_numpy(np.array(value, dtype=np.float32))
        if transpose:
            t = t.T.contiguous()
        if t.shape != want[key].shape:
            raise ValueError(f"{name!r}: shape {tuple(t.shape)}, model "
                             f"{key!r} {tuple(want[key].shape)}")
        out[key] = t
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"model entries with no flax variable: {missing}")
    return out


def load_flax(model: torch.nn.Module,
              flat: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Fill `model` in place from the flattened flax variables."""
    model.load_state_dict(state_dict_from_flax(flat, model), strict=True)
    return model
