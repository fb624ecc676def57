"""Datasets and host-side batching (numpy copies of `pctpu/nn/data.py`'s
`pc_normalize_np`, `ModelNet40Dataset`, `split_train_val` and
`iterate_batches`). `ModelNet40Dataset` reads an unpacked
`modelnet40_normal_resampled` directory; it does not download one. The
S3DIS and KITTI datasets are not ported yet.
"""
from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np

from pctpu_torch.core.io import read_modelnet_txt


def pc_normalize_np(xyz: np.ndarray) -> np.ndarray:
    """Centre on the centroid and scale into the unit sphere."""
    centroid = xyz.mean(axis=0)
    xyz = xyz - centroid
    m = np.max(np.sqrt((xyz ** 2).sum(-1)))
    return xyz / max(m, 1e-12)


class ModelNet40Dataset:
    """Directory layout of the 'modelnet40_normal_resampled' zip:
    <root>/<category>/<category>_XXXX.txt (x,y,z,nx,ny,nz CSV) with
    modelnet40_{train,test}.txt id lists and modelnet40_shape_names.txt.

    cache=True builds a persistent on-disk cache on first pass (one mmap'd
    `.npy` of concatenated rows plus an offsets `.npz`, the reference's
    file names and format), so later runs skip the CSV parse. An item is
    the reference's (`ModelNet40Loader.py:125-141`): a permutation of the
    first min(rows, 10,000) rows drawn from the dataset's own numpy
    generator, the first `num_points` of it (repeated when the shape has
    fewer), xyz normalised into the unit sphere; returns (cloud
    [num_points, 6] f32, label)."""

    def __init__(self, root: str, num_points: int = 4096, train: bool = True,
                 cache: bool = True, seed: int = 0):
        self.root = root
        self.num_points = num_points
        self.train = train
        self.rng = np.random.default_rng(seed)
        split = "train" if train else "test"
        with open(os.path.join(root, f"modelnet40_{split}.txt")) as f:
            ids = [line.strip() for line in f if line.strip()]
        with open(os.path.join(root, "modelnet40_shape_names.txt")) as f:
            self.categories = [line.strip() for line in f if line.strip()]
        cat_index = {c: i for i, c in enumerate(self.categories)}
        self.items = []
        for sid in ids:
            cat = "_".join(sid.split("_")[:-1])
            self.items.append(
                (os.path.join(root, cat, sid + ".txt"), cat_index[cat]))
        self._points = None     # mmap'd [total_rows, 6]
        self._offsets = None    # [n_items+1]
        if cache:
            self._load_or_build_cache(split)

    def _cache_paths(self, split: str) -> Tuple[str, str]:
        return (os.path.join(self.root, f"_pctpu_{split}_points.npy"),
                os.path.join(self.root, f"_pctpu_{split}_meta.npz"))

    def _load_or_build_cache(self, split: str) -> None:
        pts_path, meta_path = self._cache_paths(split)
        if os.path.exists(pts_path) and os.path.exists(meta_path):
            meta = np.load(meta_path)
            if meta["n_items"] == len(self.items):
                self._offsets = meta["offsets"]
                self._points = np.load(pts_path, mmap_mode="r")
                return
        rows = []
        offsets = np.zeros(len(self.items) + 1, np.int64)
        for i, (path, _) in enumerate(self.items):
            pts, nrm = read_modelnet_txt(path)
            rows.append(np.hstack([pts, nrm]).astype(np.float32))
            offsets[i + 1] = offsets[i] + rows[-1].shape[0]
        data = np.concatenate(rows) if rows else np.zeros((0, 6), np.float32)
        np.save(pts_path, data)
        np.savez(meta_path, offsets=offsets, n_items=len(self.items))
        self._offsets = offsets
        self._points = np.load(pts_path, mmap_mode="r")

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Tuple[np.ndarray, int]:
        path, label = self.items[i]
        if self._points is not None:
            raw = self._points[self._offsets[i]:self._offsets[i + 1]]
        else:
            pts, nrm = read_modelnet_txt(path)
            raw = np.hstack([pts, nrm]).astype(np.float32)
        cap = min(raw.shape[0], 10_000)
        idx = self.rng.permutation(cap)[: self.num_points]
        if idx.shape[0] < self.num_points:
            idx = np.resize(idx, self.num_points)
        item = np.array(raw[idx], np.float32)
        item[:, :3] = pc_normalize_np(item[:, :3])
        return item, label


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
