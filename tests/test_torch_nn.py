"""Kernel K1 (exact batched 1-NN, `pctpu_torch/ops/pallas_nn.py`) against
the JAX package's Pallas kernel `nearest_pallas` run in interpret mode.
On the CPU the wrapper runs K1's plain version; the kernel itself is
compared with it on the card in tests/test_torch_cuda.py."""
import torch_threads as _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops.pallas_nn import nearest_pallas
from pctpu_torch.ops import pallas_nn
from pctpu_torch.ops.knn import nearest


def _case(rng, b=2, m=300, n=1500, masked=True):
    q = rng.uniform(-40, 40, (b, m, 3)).astype(np.float32)
    db = rng.uniform(-40, 40, (b, n, 3)).astype(np.float32)
    mask = (rng.uniform(size=(b, n)) > 0.3) if masked else np.ones((b, n),
                                                                    bool)
    return q, db, mask


@pytest.mark.parametrize("masked", [False, True])
def test_nn1_plain_matches_pallas_interpret(rng, masked):
    """Direct squared differences in the reference's order: idx equal and
    d2 within rtol 1e-6 of the TPU kernel (interpret mode)."""
    q, db, mask = _case(rng, masked=masked)
    d2, idx = nearest(torch.from_numpy(q), torch.from_numpy(db),
                      torch.from_numpy(mask))
    assert d2.dtype == torch.float32 and idx.dtype == torch.int32
    for i in range(q.shape[0]):
        rd2, ridx = nearest_pallas(jnp.asarray(q[i]), jnp.asarray(db[i]),
                                   jnp.asarray(mask[i]), query_tile=128,
                                   db_tile=512, interpret=True)
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(ridx))
        np.testing.assert_allclose(d2[i].numpy(), np.asarray(rd2),
                                   rtol=1e-6)


def test_nn1_ties_lowest_index_and_empty_db(rng):
    """Duplicated db points tie exactly: the lowest index wins (across
    plain-version db tiles too); an all-masked db gives (BIG, 0)."""
    db = rng.uniform(-5, 5, (1, 40, 3)).astype(np.float32)
    db = np.concatenate([db, db, db], axis=1)             # copies at +40, +80
    q = db[:, :40] + 0.01
    pen = torch.zeros((1, 120))
    d2, idx = pallas_nn.nearest_plain(torch.from_numpy(q),
                                      torch.from_numpy(db), pen, db_tile=32)
    ref_d2, ref_idx = nearest_pallas(jnp.asarray(q[0]), jnp.asarray(db[0]),
                                     interpret=True)
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(ref_idx))
    assert int(idx.max()) < 40
    d2e, idxe = nearest(torch.from_numpy(q[0]), torch.from_numpy(db[0]),
                        torch.zeros(120, dtype=torch.bool))
    assert float(d2e.min()) == pytest.approx(1e30)
    assert int(idxe.abs().max()) == 0


def test_nn1_counts_only_kernel_launches(rng):
    """On CPU tensors the wrapper runs the plain version and does not
    count a launch."""
    q, db, mask = _case(rng, b=1, m=10, n=50)
    before = pallas_nn.nn1.launches
    nearest(torch.from_numpy(q), torch.from_numpy(db), torch.from_numpy(mask))
    assert pallas_nn.nn1.launches == before


@pytest.mark.parametrize("masked", [False, True])
def test_nearest_pallas_single_cloud_matches_jax(rng, masked):
    """The single-cloud entry `nearest_pallas` (query [M,3], db [N,3],
    db_mask [N]) == the reference's (interpret mode): idx equal and d2
    within rtol 1e-6, duplicated db points included (the lowest index
    wins); the tile and interpret arguments are accepted."""
    q, db, mask = _case(rng, b=1, m=200, n=700, masked=masked)
    db[0, 350:400] = db[0, 10:60]
    ref_d2, ref_idx = nearest_pallas(jnp.asarray(q[0]), jnp.asarray(db[0]),
                                     jnp.asarray(mask[0]) if masked else None,
                                     query_tile=128, db_tile=256,
                                     interpret=True)
    d2, idx = pallas_nn.nearest_pallas(
        torch.from_numpy(q[0]), torch.from_numpy(db[0]),
        torch.from_numpy(mask[0]) if masked else None, query_tile=128,
        db_tile=256, interpret=True)
    assert d2.shape == (200,) and idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(ref_d2), rtol=1e-6)
