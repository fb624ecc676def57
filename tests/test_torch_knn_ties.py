"""Tie order of `knn` and `radius_search` (`pctpu_torch/ops/knn.py`)
against the JAX package's `pctpu.ops.knn`, index for index.

Random float inputs almost never tie, so the parity tests elsewhere cannot
see the order of equal distances. On an integer grid nearly every row
ties: the reference's `lax.top_k` puts the lowest index first among equal
distances, and so must the port, on the CPU and on the card alike (one
code path: a stable sort)."""
import torch_threads as _torch_threads  # noqa: F401

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops.normals import estimate_normals as j_estimate_normals
from pctpu_torch.ops.knn import knn, radius_search
from pctpu_torch.ops.normals import estimate_normals

j_knn_mod = importlib.import_module("pctpu.ops.knn")


def _grid(scale=(1.0, 1.0, 1.0)):
    """The 4x4x4 integer grid (64 points), axes scaled by `scale`."""
    axes = [np.arange(4.0) * s for s in scale]
    g = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    return g.astype(np.float32)


def _same(ours, ref):
    """Indices, validity and counts equal; distances within 1e-5, the f32
    rounding of the a^2+b^2-2ab tiles summed in another order at
    |p|^2 <= 3 (exact on the integer grid)."""
    np.testing.assert_array_equal(ours.idx.numpy(), np.asarray(ref.idx))
    np.testing.assert_allclose(ours.dist2.numpy(), np.asarray(ref.dist2),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))
    np.testing.assert_array_equal(ours.count.numpy(), np.asarray(ref.count))


@pytest.mark.parametrize("k", [5, 7, 30])
def test_knn_grid_tie_order_matches_reference(k):
    g = _grid()
    ours = knn(torch.from_numpy(g), torch.from_numpy(g), k, query_chunk=24)
    ref = j_knn_mod.knn(jnp.asarray(g), jnp.asarray(g), k, query_chunk=24)
    _same(ours, ref)


def test_radius_search_grid_tie_order_matches_reference():
    g = _grid()
    ours = radius_search(torch.from_numpy(g), torch.from_numpy(g), 1.01, 5)
    ref = j_knn_mod.radius_search(jnp.asarray(g), jnp.asarray(g), 1.01, 5)
    _same(ours, ref)


def test_knn_masked_db_filler_slots_match_reference():
    """4 of 12 db points valid and k = 8: the 4 invalid slots of each row
    hold the lowest masked-out indices, as the reference's."""
    rng = np.random.default_rng(3)
    db = rng.uniform(-1, 1, (12, 3)).astype(np.float32)
    mask = np.zeros(12, bool)
    mask[[1, 4, 7, 10]] = True
    ours = knn(torch.from_numpy(db), torch.from_numpy(db), 8,
               db_mask=torch.from_numpy(mask))
    ref = j_knn_mod.knn(jnp.asarray(db), jnp.asarray(db), 8,
                        db_mask=jnp.asarray(mask))
    _same(ours, ref)
    assert not ours.valid[:, 4:].any()


@pytest.mark.parametrize("scale", [(1.0, 1.0, 1.0), (1.0, 1.3, 1.7)])
def test_estimate_normals_grid_matches_reference(scale):
    """k = 5 on the grid: the same neighbour sets, so the same normals up
    to sign (|dot| within 1e-5 of 1 on every point)."""
    g = _grid(scale)
    ours = estimate_normals(torch.from_numpy(g)).numpy()
    ref = np.asarray(j_estimate_normals(jnp.asarray(g)))
    dots = np.abs(np.sum(ours * ref, axis=1))
    assert dots.min() > 1.0 - 1e-5, (np.sum(dots < 1.0 - 1e-5), dots.min())
