"""Kernels 13 and 14's plain versions and `group_points_pallas` against the
JAX package, on the CPU: `gather_rows_pallas` and
`scatter_add_rows_pallas` on CPU tensors against the reference's
`interpret=True` runs (exact: both copy rows, and both add each row's
entries one at a time in ascending index onto zeros), the
`group_points_pallas` gradient against `jax.grad` of the reference (exact
for the same reason), and `table_fits`. Inputs come from numpy with a
seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops import pallas_gather as jg
from pctpu_torch.ops import pallas_gather as tg


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("b,n,m,c", [(2, 50, 300, 7), (3, 512, 1024, 33),
                                     (1, 16, 5, 1)])
def test_gather_rows_matches_jax(rng, b, n, m, c):
    """Kernel 13's plain version == `gather_rows_pallas(interpret=True)`,
    exactly, with out-of-range indices clipped."""
    table = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(-3, n + 3, (b, m)).astype(np.int32)
    ref = jg.gather_rows_pallas(jnp.asarray(table), jnp.asarray(idx),
                                rows_per_step=64, interpret=True)
    before = tg.gather_rows_pallas.launches
    ours = tg.gather_rows_pallas(_t(table), _t(idx))
    assert tg.gather_rows_pallas.launches == before    # CPU: no launch
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("b,n,m,c", [(2, 50, 300, 7), (2, 512, 4096, 19),
                                     (1, 8, 3, 2)])
def test_scatter_add_rows_matches_jax(rng, b, n, m, c):
    """Kernel 14's plain version == `scatter_add_rows_pallas(interpret=
    True)` bit for bit: the same additions in the same order. Heavy
    buckets (a third of the entries on row 0) and clipped indices
    included; rows nobody hits are 0."""
    g = rng.normal(size=(b, m, c)).astype(np.float32)
    idx = rng.integers(-3, n + 3, (b, m)).astype(np.int32)
    idx[:, ::3] = 0
    ref = jg.scatter_add_rows_pallas(jnp.asarray(g), jnp.asarray(idx), n,
                                     rows_per_step=64, interpret=True)
    before = tg.scatter_add_rows_pallas.launches
    ours = tg.scatter_add_rows_pallas(_t(g), _t(idx), n)
    assert tg.scatter_add_rows_pallas.launches == before
    assert ours.shape == (b, n, c)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", ["one_row", "out_of_range", "c131", "c323",
                                  "c700"])
def test_scatter_add_rows_edge_cases_match_jax(rng, case):
    """Kernel 14's plain version == the reference (interpret mode) bit for
    bit where the kernel's design has edges: every entry on one row (the
    longest chain of adds), indices out of range on both sides (clipped
    to rows 0 and n-1), and widths of 131, 323 and 700 channels (scalar
    loads; more than one channel span per row)."""
    b, m, n = 2, 96, 24
    c = {"c131": 131, "c323": 323, "c700": 700}.get(case, 5)
    g = rng.normal(size=(b, m, c)).astype(np.float32)
    if case == "one_row":
        idx = np.full((b, m), 7, np.int32)
    elif case == "out_of_range":
        idx = rng.choice([-5, -1, n, n + 9, 3], (b, m)).astype(np.int32)
    else:
        idx = rng.integers(-2, n + 2, (b, m)).astype(np.int32)
    ref = jg.scatter_add_rows_pallas(jnp.asarray(g), jnp.asarray(idx), n,
                                     rows_per_step=32, interpret=True)
    ours = tg.scatter_add_rows_pallas(_t(g), _t(idx), n)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    if case == "one_row":
        assert not ours[:, np.arange(n) != 7].any()
    if case == "out_of_range":
        assert set(np.flatnonzero(np.abs(ours.numpy()).sum((0, 2)))) == {
            0, 3, n - 1}


def test_scatter_add_rows_adds_in_ascending_index():
    """The order is the reference's: 1e8 + 1 - 1e8 + ... in f32 depends
    on it. Row 0 receives [1e8, 1, -1e8, 1] in that order: 0."""
    g = torch.tensor([[[1e8], [1.0], [-1e8], [1.0], [5.0]]])
    idx = torch.tensor([[0, 0, 0, 0, 1]], dtype=torch.int32)
    out = tg.scatter_add_rows_pallas(g, idx, 3)
    assert out[0, :, 0].tolist() == [1.0, 5.0, 0.0]


def test_group_points_pallas_gradient_matches_jax(rng):
    """Forward == the reference's `group_points_pallas`; the gradient
    w.r.t. points (kernel 14's plain version) == `jax.grad` of it,
    exactly, and == torch.gather's autograd within 1e-6."""
    b, n, m, k, c = 2, 64, 20, 8, 5
    pts = rng.normal(size=(b, n, c)).astype(np.float32)
    idx = rng.integers(0, n, (b, m, k)).astype(np.int32)
    ct = rng.normal(size=(b, m, k, c)).astype(np.float32)

    def jloss(p):
        return jnp.sum(jg.group_points_pallas(p, jnp.asarray(idx), 64, True)
                       * ct)
    jgrad = jax.grad(jloss)(jnp.asarray(pts))
    p = _t(pts).requires_grad_()
    out = tg.group_points_pallas(p, _t(idx))
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(jg.group_points_pallas(jnp.asarray(pts), jnp.asarray(idx),
                                          64, True)))
    (out * _t(ct)).sum().backward()
    np.testing.assert_array_equal(p.grad.numpy(), np.asarray(jgrad))
    q = _t(pts).requires_grad_()
    ref = torch.gather(q, 1, _t(idx).long().reshape(b, m * k, 1).expand(
        b, m * k, c)).reshape(b, m, k, c)
    (ref * _t(ct)).sum().backward()
    np.testing.assert_allclose(p.grad.numpy(), q.grad.numpy(), atol=1e-6)


@pytest.mark.parametrize("shape", [(512, 3), (4096, 320), (16384, 128),
                                   (16385, 128), (100, 129)])
def test_table_fits_matches_jax(shape):
    assert tg.table_fits(shape) == jg.table_fits(shape)
