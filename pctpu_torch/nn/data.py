"""Host-side data helpers (numpy copies of `pctpu/nn/data.py`'s
`pc_normalize_np`, `split_train_val` and `iterate_batches`). The datasets
themselves wait for their files."""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np


def pc_normalize_np(xyz: np.ndarray) -> np.ndarray:
    """Centre on the centroid and scale into the unit sphere."""
    centroid = xyz.mean(axis=0)
    xyz = xyz - centroid
    m = np.max(np.sqrt((xyz ** 2).sum(-1)))
    return xyz / max(m, 1e-12)


def split_train_val(n: int, val_frac: float = 0.2, seed: int = 0):
    """SubsetRandomSampler-style 80/20 split (resampled_dataset.py:66-78)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = int(np.floor(val_frac * n))
    return perm[n_val:], perm[:n_val]


def iterate_batches(dataset, batch_size: int, shuffle: bool = True,
                    seed: int = 0, drop_last: bool = True,
                    indices: Optional[np.ndarray] = None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Minimal epoch iterator -> (stacked data, stacked labels)."""
    n = len(dataset)
    order = np.asarray(indices) if indices is not None else np.arange(n)
    if shuffle:
        order = np.random.default_rng(seed).permutation(order)
    end = (len(order) // batch_size) * batch_size if drop_last else len(order)
    for s in range(0, end, batch_size):
        chunk = order[s:s + batch_size]
        xs, ys = zip(*(dataset[int(i)] for i in chunk))
        yield np.stack(xs), np.asarray(ys)
