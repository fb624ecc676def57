"""Ball query and the fused ball-group kernel's plain version against the
JAX package, on the CPU: the port's `ball_query` against JAX
`ball_query` (idx and valid equal), and `ball_group_plain`,
`ball_group_pallas` and `ball_group_pallas_batched` on CPU tensors
against JAX `ball_group_pallas{,_batched}(interpret=True)`, atol 1e-6 as
`tests/test_pallas_nn.py` holds the kernel. Rows are copied exactly on
both sides; only a point within an ulp of the radius could round to the
other side. The VJP against `jax.grad` of the reference. Inputs come from
numpy with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops.ball_query import ball_query as j_ball_query
from pctpu.ops.pallas_ballgroup import ball_group_pallas as j_bg
from pctpu.ops.pallas_ballgroup import ball_group_pallas_batched as j_bgb
from pctpu_torch.ops import pallas_ballgroup, pallas_gather
from pctpu_torch.ops.ball_query import ball_query
from pctpu_torch.ops.gather import group_points


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("radius,nsample,masked", [(0.2, 16, False),
                                                   (0.4, 32, True),
                                                   (0.05, 8, False)])
def test_ball_query_matches_jax(rng, radius, nsample, masked):
    """idx and valid equal to the reference's, one cloud and a batch of
    two (the reference vmapped), with a mask and with centres whose ball
    holds only themselves or, away from the cloud, nothing."""
    pts = rng.uniform(-1, 1, (2, 600, 3)).astype(np.float32)
    centers = pts[:, rng.choice(600, 100, replace=False)].copy()
    centers[:, :5] += 5.0                                  # empty balls
    mask = rng.random((2, 600)) > 0.2 if masked else None
    ref = [j_ball_query(jnp.asarray(centers[b]), jnp.asarray(pts[b]), radius,
                        nsample, None if mask is None
                        else jnp.asarray(mask[b]), query_chunk=64)
           for b in range(2)]
    idx, valid = ball_query(_t(centers), _t(pts), radius, nsample,
                            None if mask is None else _t(mask),
                            query_chunk=64)
    assert idx.dtype == torch.int32 and idx.shape == (2, 100, nsample)
    for b in range(2):
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ref[b][0]))
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(ref[b][1]))
    one = ball_query(_t(centers[0]), _t(pts[0]), radius, nsample,
                     None if mask is None else _t(mask[0]))
    np.testing.assert_array_equal(one[0].numpy(), np.asarray(ref[0][0]))
    assert not valid[:, :5].any()


def _packed(rng, n, c_feat):
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    feats = rng.normal(size=(n, c_feat)).astype(np.float32)
    return np.hstack([pts, feats]).astype(np.float32)


@pytest.mark.parametrize("c_feat", [5, 10, 0])
@pytest.mark.parametrize("sub_xyz", [True, False])
def test_ball_group_matches_jax(rng, c_feat, sub_xyz):
    """One cloud: `ball_group_pallas` (plain version) == JAX
    `ball_group_pallas(interpret=True)` within 1e-6, for 3 + C channels
    with C = 5 (8 in all), 10 (13, not a multiple of 8) and 0."""
    n, m, k, r = 512, 64, 16, 0.4
    packed = _packed(rng, n, c_feat)
    centers = packed[rng.choice(n, m, replace=False), :3]
    ref = np.asarray(j_bg(jnp.asarray(centers), jnp.asarray(packed), r, k,
                          32, sub_xyz, True))
    ours = pallas_ballgroup.ball_group_pallas(_t(centers), _t(packed), r, k,
                                              sub_xyz=sub_xyz)
    assert ours.shape == (m, k, 3 + c_feat)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


@pytest.mark.parametrize("c_feat", [5, 10])
def test_ball_group_batched_matches_jax(rng, c_feat):
    """A batch: `ball_group_pallas_batched` and `ball_group_plain` ==
    JAX `ball_group_pallas_batched(interpret=True)` within 1e-6; the idx
    equal the port's `ball_query` + `group_points` composition's."""
    b, n, m, k, r = 2, 256, 32, 8, 0.5
    packed = np.stack([_packed(rng, n, c_feat) for _ in range(b)])
    centers = packed[:, :m, :3].copy()
    ref = np.asarray(j_bgb(jnp.asarray(centers), jnp.asarray(packed), r, k,
                           tile=32, interpret=True))
    ours = pallas_ballgroup.ball_group_pallas_batched(_t(centers),
                                                      _t(packed), r, k)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)
    grouped, idx = pallas_ballgroup.ball_group_plain(_t(centers), _t(packed),
                                                     r, k)
    np.testing.assert_array_equal(grouped.numpy(), ours.numpy())
    idx_q, _ = ball_query(_t(centers), _t(packed[..., :3]), r, k)
    np.testing.assert_array_equal(idx.numpy(), idx_q.numpy())
    comp = group_points(_t(packed), idx_q)
    comp[..., :3] -= _t(centers)[:, :, None]
    np.testing.assert_array_equal(grouped.numpy(), comp.numpy())


def test_ball_group_mask_and_empty_ball(rng):
    """Masked points are never grouped. An empty ball follows
    `ball_query`'s contract: idx 0 in every slot, the row `packed[0]`
    minus the centre (the TPU kernel sums all rows there, ROADMAP C)."""
    packed = _packed(rng, 300, 4)[None]
    mask = rng.random((1, 300)) > 0.5
    centers = packed[:, :20, :3].copy()
    centers[0, :3] = [9.0, 9.0, 9.0]                       # empty balls
    grouped, idx = pallas_ballgroup.ball_group(
        _t(centers), _t(packed), 0.5, 16, points_mask=_t(mask))
    assert (idx[0, :3] == 0).all()
    want = packed[0, 0] - np.r_[centers[0, 0], np.zeros(4, np.float32)]
    np.testing.assert_array_equal(grouped[0, 0, 0].numpy(), want)
    assert mask[0][idx[0, 3:].numpy()].all()
    idx_q, valid = ball_query(_t(centers), _t(packed[..., :3]), 0.5, 16,
                              _t(mask))
    np.testing.assert_array_equal(idx.numpy(), idx_q.numpy())
    assert not valid[0, :3].any()


def test_ball_group_refuses_gradients(rng):
    """Kernel 12 no longer refuses inputs that require a gradient: the
    backward runs, counts no launch on CPU tensors, computes only the
    gradients asked for (d_packed: kernel 14's entry, once), and under
    no_grad nothing is recorded."""
    packed = _t(_packed(rng, 100, 3))[None]
    centers = packed[:, :10, :3].clone()
    before = pallas_ballgroup.ball_group.launches
    pallas_ballgroup.ball_group_pallas_batched(centers, packed, 0.5, 8)
    assert pallas_ballgroup.ball_group.launches == before
    calls = []
    real = pallas_gather.scatter_add_rows_pallas

    def counting(*args):
        calls.append(args[2])
        return real(*args)
    p = packed.clone().requires_grad_()
    out = pallas_ballgroup.ball_group_pallas_batched(centers, p, 0.5, 8)
    pallas_gather.scatter_add_rows_pallas = counting
    try:
        out.sum().backward()
        c = centers[0].clone().requires_grad_()
        pallas_ballgroup.ball_group_pallas(c, packed[0], 0.5, 8).sum(
            ).backward()
    finally:
        pallas_gather.scatter_add_rows_pallas = real
    assert calls == [100]                 # only d_packed needs kernel 14
    assert p.grad.shape == packed.shape and c.grad.shape == (10, 3)
    np.testing.assert_array_equal(c.grad.numpy(), -8.0)  # -sum of 8 ones
    with torch.no_grad():
        g = pallas_ballgroup.ball_group_pallas(
            centers[0], packed[0].clone().requires_grad_(), 0.5, 8)
    assert g.grad_fn is None


@pytest.mark.parametrize("sub_xyz", [True, False])
def test_ball_group_vjp_matches_jax(rng, sub_xyz):
    """d_packed and d_centers of `ball_group_pallas_batched` (the plain
    forward, kernel 14's plain version for d_packed) == `jax.grad` of the
    reference's `ball_group_pallas_batched(interpret=True)` within 1e-5
    (XLA's segment_sum on the CPU adds in an unspecified order); and the
    single-cloud `ball_group_pallas` likewise."""
    b, n, m, k, r = 2, 256, 32, 16, 0.4
    packed = np.stack([_packed(rng, n, 4) for _ in range(b)])
    centers = packed[:, :m, :3].copy()
    ct = rng.normal(size=(b, m, k, 7)).astype(np.float32)

    def jloss(c, p):
        return jnp.sum(j_bgb(c, p, r, k, tile=32, sub_xyz=sub_xyz,
                             interpret=True) * ct)
    dc, dp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(centers),
                                             jnp.asarray(packed))
    c_ = _t(centers).requires_grad_()
    p_ = _t(packed).requires_grad_()
    (pallas_ballgroup.ball_group_pallas_batched(c_, p_, r, k,
                                                sub_xyz=sub_xyz)
     * _t(ct)).sum().backward()
    np.testing.assert_allclose(p_.grad.numpy(), np.asarray(dp), atol=1e-5)
    np.testing.assert_allclose(c_.grad.numpy(), np.asarray(dc), atol=1e-5)

    def jloss1(c, p):
        return jnp.sum(j_bg(c, p, r, k, 32, sub_xyz, True) * ct[0])
    dc1, dp1 = jax.grad(jloss1, argnums=(0, 1))(jnp.asarray(centers[0]),
                                                jnp.asarray(packed[0]))
    c1 = _t(centers[0]).requires_grad_()
    p1 = _t(packed[0]).requires_grad_()
    (pallas_ballgroup.ball_group_pallas(c1, p1, r, k, sub_xyz=sub_xyz)
     * _t(ct[0])).sum().backward()
    np.testing.assert_allclose(p1.grad.numpy(), np.asarray(dp1), atol=1e-5)
    np.testing.assert_allclose(c1.grad.numpy(), np.asarray(dc1), atol=1e-5)


def test_jax_ball_group_reference_is_differentiable(rng):
    """The reference's VJP: its gradient w.r.t. packed is a segment-sum
    of the cotangent over the idx (here the hit counts of each point)."""
    packed = jnp.asarray(_packed(rng, 128, 2))
    centers = packed[:16, :3]
    g = jax.grad(lambda p: jnp.sum(j_bg(centers, p, 0.5, 8, 16, True,
                                        True)))(packed)
    _, idx = pallas_ballgroup.ball_group_plain(
        _t(np.asarray(centers))[None], _t(np.asarray(packed))[None], 0.5, 8)
    counts = np.bincount(idx.numpy().ravel(), minlength=128)
    np.testing.assert_allclose(np.asarray(g)[:, 3], counts, atol=0)
