"""The PointRCNN-style detector against the JAX package, on the CPU, at
B 2 x 512 points and npoints (128, 32): `ProposalNet`'s eval forward (3
and 4 input channels) and its train-mode forward with the BN statistics
it moves; `rpn_loss` and its gradient against `jax.value_and_grad`;
`RefineNet`'s forward; `decode_proposals`, `extract_proposals` (tied
scores included) and `proposal_targets`. Weights are drawn with numpy
into the flax variables' shapes (`jax.eval_shape` of the init) and
carried across by `models/convert.py`; scenes are a ground plane and one
car-sized box, Morton-sorted.

Tolerances: outputs within rtol = atol = 1e-4 (the Dense sums run in
another order in the two libraries' CPU BLAS); the running statistics
within 1e-4; the loss within rtol 1e-5; each gradient within 1e-4 of its
norm, floored at 1e-3 of the whole gradient's norm (measured at most
2.0e-6 of a norm at this size: the two libraries sum BN's backward over
a window scale's rows in other orders);
decoded boxes within 1e-5; proposals' order and validity equal; targets
equal."""
import torch_threads as _torch_threads  # noqa: F401

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pctpu.models import pointnet2 as jp
from pctpu.models import pointrcnn as jr
from pctpu_torch.models import convert
from pctpu_torch.models import pointrcnn as tr

B, N, NPOINTS = 2, 512, (128, 32)
GT = np.float32([1.5, -0.8, 0.8, 3.9, 1.6, 1.6, 0.4])


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(rng, channels):
    """Ground (350 points) and a box of GT's shape (the reference test's
    scene, `tests/test_models.py:330-338`), intensity as a 4th channel."""
    ground = np.stack([rng.uniform(-8, 8, 350), rng.uniform(-8, 8, 350),
                       rng.normal(scale=0.05, size=350)], 1)
    c, s = np.cos(GT[6]), np.sin(GT[6])
    local = rng.uniform(-0.5, 0.5, (N - 350, 3)) * GT[3:6]
    obj = local @ np.array([[c, s, 0], [-s, c, 0], [0, 0, 1]]) + GT[:3]
    pts = np.concatenate([ground, obj])
    if channels == 4:
        pts = np.concatenate([pts, rng.uniform(size=(N, 1))], 1)
    return pts.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _pc(channels):
    pc = np.stack([_scene(np.random.default_rng(i), channels)
                   for i in range(B)])
    return np.asarray(jp.morton_sort_packed(jnp.asarray(pc)))


def _fill(shapes, seed):
    """Flat flax variables drawn with numpy: kernels ~ N(0, 1/fan_in),
    biases and means ~ N(0, 0.1), BN scales and variances ~ U(0.5, 2)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, s in flatten_dict(dict(shapes), sep="/").items():
        leaf = k.rsplit("/", 1)[1]
        if leaf == "kernel":
            v = rng.normal(scale=s.shape[0] ** -0.5, size=s.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.5, 2.0, s.shape)
        else:
            v = rng.normal(scale=0.1, size=s.shape)
        flat[k] = v.astype(np.float32)
    return flat


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


@functools.lru_cache(maxsize=None)
def _rpn(channels):
    """(flat variables, port model) for ProposalNet at `channels`."""
    jm = jr.ProposalNet(npoints=NPOINTS)
    pc = jnp.asarray(_pc(channels))
    flat = _fill(jax.eval_shape(lambda x: jm.init(
        jax.random.PRNGKey(0), x, train=True), pc), channels)
    model = tr.ProposalNet(npoints=NPOINTS, in_channels=channels)
    return flat, convert.load_flax(model, flat)


@pytest.mark.parametrize("channels", [3, 4])
def test_proposal_net_eval_matches_jax(channels):
    flat, model = _rpn(channels)
    pc = _pc(channels)
    rs, rreg = jr.ProposalNet(npoints=NPOINTS).apply(
        _tree(flat), jnp.asarray(pc), train=False)
    with torch.no_grad():
        gs, greg = model.eval()(_t(pc))
    assert gs.shape == (B, N) and greg.shape == (B, N, 8)
    np.testing.assert_allclose(gs.numpy(), np.asarray(rs), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(greg.numpy(), np.asarray(rreg), rtol=1e-4,
                               atol=1e-4)


def test_converter_keeps_flax_creation_order_of_fp():
    """`FeaturePropagation_0` is level 2's (384 -> 128 inputs), `_1` level
    1's; the converter fills every entry of the port's model."""
    flat, model = _rpn(4)
    assert flat["params/FeaturePropagation_0/SharedMLP_0/Dense_0/kernel"
                ].shape == (384, 128)
    assert model.fp[0].mlps[0].dense[0].weight.shape == (128, 384)
    assert model.fp[1].mlps[0].dense[0].weight.shape == (128, 129)
    assert set(model.state_dict()) == {convert.torch_name(k)[0]
                                       for k in flat}


def _targets(pc):
    gt = jnp.broadcast_to(jnp.asarray(GT)[None, None], (B, 1, 7))
    return jax.vmap(jr.proposal_targets)(jnp.asarray(pc[..., :3]), gt)


@functools.lru_cache(maxsize=None)
def _jax_train_step():
    """The reference's train-mode forward, BN statistics, loss and
    gradient at channels 4 (BN momentum 0.1)."""
    flat, _ = _rpn(4)
    tree = _tree(flat)
    pc = jnp.asarray(_pc(4))
    fg, regt = _targets(np.asarray(pc))
    jm = jr.ProposalNet(npoints=NPOINTS)

    def loss_fn(params):
        (score, reg), mut = jm.apply(
            {"params": params, "batch_stats": tree["batch_stats"]}, pc,
            train=True, mutable=["batch_stats"])
        loss, parts = jr.rpn_loss(score, reg, fg, regt)
        return loss, (score, reg, mut["batch_stats"], parts)

    (loss, (score, reg, bs, parts)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(tree["params"])
    return (float(loss), np.asarray(score), np.asarray(reg),
            {"batch_stats/" + k: np.asarray(v)
             for k, v in flatten_dict(bs, sep="/").items()},
            {"params/" + k: np.asarray(v)
             for k, v in flatten_dict(grads, sep="/").items()},
            {k: float(v) for k, v in parts.items()}, np.asarray(fg),
            np.asarray(regt))


def test_proposal_net_train_step_matches_jax():
    """Train mode: outputs, every BN's running statistics after the
    forward, the loss and its parts, and every gradient."""
    loss, score, reg, bs, grads, parts, fg, regt = _jax_train_step()
    flat, _ = _rpn(4)
    model = convert.load_flax(tr.ProposalNet(npoints=NPOINTS, in_channels=4),
                              flat).train()
    gs, greg = model(_t(_pc(4)), 0.1)
    np.testing.assert_allclose(gs.detach().numpy(), score, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(greg.detach().numpy(), reg, rtol=1e-4,
                               atol=1e-4)
    t_loss, t_parts = tr.rpn_loss(gs, greg, _t(fg), _t(regt))
    np.testing.assert_allclose(float(t_loss), loss, rtol=1e-5)
    for k in ("cls", "reg"):
        np.testing.assert_allclose(float(t_parts[k]), parts[k], rtol=1e-5)
    t_loss.backward()
    sd = model.state_dict()
    for name, ref in bs.items():
        np.testing.assert_allclose(sd[convert.torch_name(name)[0]].numpy(),
                                   ref, rtol=0, atol=1e-4, err_msg=name)
    by_name = dict(model.named_parameters())
    total = np.sqrt(sum(np.sum(g ** 2) for g in grads.values()))
    assert len(grads) == len(by_name)
    worst = 0.0
    for name, ref in grads.items():
        key, transpose = convert.torch_name(name)
        got = by_name[key].grad.numpy()
        got = got.T if transpose else got
        err = np.abs(got - ref).max()
        worst = max(worst, err / max(np.linalg.norm(ref), 1e-3 * total))
    assert worst <= 1e-4, worst


def test_refine_net_matches_jax():
    """RefineNet (cap 32) on 8 proposals around the box, two of them
    empty (no point inside pools to 0)."""
    pc = _pc(4)[0]
    rng = np.random.default_rng(3)
    props = np.tile(GT, (8, 1)) + rng.normal(scale=0.3, size=(8, 7)) * [
        1, 1, 0.2, 0.3, 0.2, 0.2, 0.3]
    props[6:, :2] += 30.0                                       # empty
    props = props.astype(np.float32)
    feats = rng.normal(size=(N, 4)).astype(np.float32)
    jm = jr.RefineNet(cap=32)
    flat = _fill(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(1), jnp.asarray(pc[:, :3]), jnp.asarray(feats),
        jnp.asarray(props), train=True)), 9)
    r_res, r_conf = jm.apply(_tree(flat), jnp.asarray(pc[:, :3]),
                             jnp.asarray(feats), jnp.asarray(props),
                             train=False)
    model = convert.load_flax(tr.RefineNet(in_features=4, cap=32), flat)
    with torch.no_grad():
        res, conf = model.eval()(_t(pc[:, :3]), _t(feats), _t(props))
    assert res.shape == (8, 8) and conf.shape == (8,)
    np.testing.assert_allclose(res.numpy(), np.asarray(r_res), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(conf.numpy(), np.asarray(r_conf), rtol=1e-4,
                               atol=1e-4)


def test_decode_and_extract_proposals_match_jax():
    """Decoded boxes; top-K with tied scores (the logits rounded to two
    levels) and rotated NMS: proposals in the same order."""
    rng = np.random.default_rng(5)
    xyz = _pc(3)[0]
    reg = rng.normal(scale=0.5, size=(N, 8)).astype(np.float32)
    rb = np.asarray(jr.decode_proposals(jnp.asarray(xyz), jnp.asarray(reg)))
    gb = tr.decode_proposals(_t(xyz), _t(reg)).numpy()
    np.testing.assert_allclose(gb, rb, rtol=0, atol=1e-5)
    for scores in (rng.normal(size=N), np.round(rng.uniform(size=N))):
        scores = scores.astype(np.float32)
        for pre, post in ((64, 16), (40, 48)):      # a budget > candidates
            ref = jr.extract_proposals(jnp.asarray(rb), jnp.asarray(scores),
                                       pre_nms_top=pre, post_nms=post,
                                       iou_thresh=0.3)
            got = tr.extract_proposals(_t(rb), _t(scores), pre_nms_top=pre,
                                       post_nms=post, iou_thresh=0.3)
            for g, r in zip(got, ref):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            assert 0 < int(got[2].sum()) <= min(pre, post)
    assert int(got[2].sum()) < 40                 # NMS suppressed some


def test_proposal_targets_match_jax():
    """Two overlapping real boxes and a padding row: a point inside both
    takes the first (argmax over the mask)."""
    xyz = _pc(3)[0, :, :3]
    gt = np.stack([GT, GT + [0.8, 0.3, 0, 0, 0, 0, 0.2],
                   np.zeros(7, np.float32)]).astype(np.float32)
    rfg, rreg = jr.proposal_targets(jnp.asarray(xyz), jnp.asarray(gt))
    gfg, greg = tr.proposal_targets(_t(xyz), _t(gt))
    np.testing.assert_array_equal(gfg.numpy(), np.asarray(rfg))
    np.testing.assert_allclose(greg.numpy()[gfg.numpy()],
                               np.asarray(rreg)[np.asarray(rfg)], rtol=0,
                               atol=1e-6)
    both = tr.points_in_boxes(_t(xyz), _t(gt[:2])).all(0)
    assert int(both.sum()) > 10 and int(gfg.sum()) > 50
