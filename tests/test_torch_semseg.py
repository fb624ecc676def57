"""The PointNet++ segmentation slice against the JAX package, on the CPU:
`three_nn` (indices bit-exact, ties on a grid included), the
interpolation weights and `three_interpolate` with its gradient,
`FeaturePropagation` in all three branches, the `semseg-ssg` /
`semseg-msg` eval logits at ball and window grouping, one `semseg-ssg`
train step (loss, gradients, running statistics) with the dropout mask
injected, the converter on the segmenters' names, the segmenters'
indifference to `compute_dtype`, and `evaluate` on per-point labels.
Inputs come from numpy with a seed; weights are drawn with numpy into
the flax variables' shapes (`jax.eval_shape` of the init) and carried
across by `models/convert.py`.

Tolerances: logits within rtol = atol = 1e-4 (the Dense sums run in
another order in the two libraries' CPU BLAS; FPS, ball query and
three-NN select the same points on both sides). The train step, set from
each side's float32 error against a float64 run of the port (float32
geometry; measured at this test's B 2 x 1,024): the loss within rtol
1e-4 (JAX 2.7e-5 from float64, the port 3.3e-7), the running statistics
within 3e-4 (JAX 1.5e-4, the port 8.6e-6), each gradient within 5e-2 of its norm, floored at 1e-3 of
the whole gradient's norm (JAX up to 2.55e-2, the port 8.4e-3: SA1's BN
scales and biases sum 65,536 rows that BN's backward makes cancel, and
XLA's fused CPU reductions round more)."""
import torch_threads as _torch_threads  # noqa: F401

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pctpu.models import pointnet2 as jp
from pctpu.nn import train as JT
from pctpu.nn.config import TrainConfig as JConfig
from pctpu.ops import interpolate as jinterp
from pctpu_torch.models import convert
from pctpu_torch.models import pointnet2 as tp
from pctpu_torch.nn import config as tconfig
from pctpu_torch.nn import fit
from pctpu_torch.nn import train as T
from pctpu_torch.ops import interpolate as tinterp
from pctpu_torch.ops.knn import knn

B, N, CLASSES = 2, 1024, 13


def _room(seed, b=B, n=N):
    """[b,n,9] indoor-style clouds: xyz on a floor, two walls and a box in
    a 1 x 1 x 0.6 room, rgb in [0, 1], xyz over the room's extent."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        u = rng.uniform(size=(n, 3)) * [1.0, 1.0, 0.6]
        part = rng.integers(0, 4, n)
        u[part == 0, 2] = 0.0                       # floor
        u[part == 1, 0] = 0.0                       # wall x = 0
        u[part == 2, 1] = 1.0                       # wall y = 1
        box = part == 3
        u[box] = [0.4, 0.3, 0.0] + u[box] * [0.3, 0.3, 0.5]
        xyz = u + rng.normal(scale=0.005, size=u.shape)
        rgb = rng.uniform(size=(n, 3))
        out.append(np.hstack([xyz, rgb, xyz / xyz.max(axis=0)]))
    return np.stack(out).astype(np.float32)


def _fill(shapes, seed):
    """Flat flax variables of the shapes `shapes` (an eval_shape tree),
    drawn with numpy: kernels ~ N(0, 1/fan_in), biases and means ~ N(0,
    0.1), BN scales and variances ~ U(0.5, 2), so every leaf shows in the
    output."""
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


def _random_variables(jm, pc, seed):
    """`_fill` for the model `jm` at the input `pc` (shapes from
    `jax.eval_shape` of the init: nothing runs)."""
    return _fill(jax.eval_shape(lambda x: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, train=True), jnp.asarray(pc)), seed)


def _tree(flat):
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _port(model, grouping, flat, **kw):
    cfg = tconfig.TrainConfig(model=model, num_classes=CLASSES,
                              grouping=grouping, **kw)
    return convert.load_flax(T.build_model(cfg, device="cpu"), flat)


def _sorted_room(seed):
    """The test's room, Morton-sorted (the window path's input)."""
    return tp.morton_sort_packed(torch.from_numpy(_room(seed))).numpy()


@functools.lru_cache(maxsize=None)
def _jax_eval(model, grouping):
    """(flat variables, pc, JAX eval logits) for one segmenter."""
    cfg = JConfig(model=model, num_classes=CLASSES, grouping=grouping)
    jm = JT.build_model(cfg)
    pc = _sorted_room(3) if grouping == "window" else _room(3)
    flat = _random_variables(jm, pc, 5)
    logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        _tree(flat), jnp.asarray(pc))
    return flat, pc, np.asarray(logits)


def _grid_ties():
    """A shuffled 4x4x4 integer grid as the db; queries at its points and
    at offsets equidistant from 2, 4 or 8 of them (all arithmetic exact)."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    db = g[np.random.default_rng(3).permutation(64)]
    q = np.concatenate([g, g + 0.5, g + [0.5, 0, 0], g + [0.5, 0.5, 0]])
    return q.astype(np.float32), db


def test_three_nn_ties_on_a_grid_match_jax():
    """Indices and distances equal the reference's bit for bit where 2,
    4 or 8 db points tie: the lowest index first."""
    q, db = _grid_ties()
    d2, idx = tinterp.three_nn(torch.from_numpy(q), torch.from_numpy(db))
    rd2, ridx = jinterp.three_nn(jnp.asarray(q), jnp.asarray(db))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(rd2))
    assert idx.dtype == torch.int32


def test_three_nn_batched_matches_jax_and_knn(rng):
    """On random clouds, batched (the reference vmaps) and across query
    chunks: indices and distances equal the reference's (the compiled
    reference's rounding); each cloud's indices equal to `knn(query, db,
    3)`'s."""
    q = rng.uniform(-1, 1, (3, 700, 3)).astype(np.float32)
    db = rng.uniform(-1, 1, (3, 200, 3)).astype(np.float32)
    d2, idx = tinterp.three_nn(torch.from_numpy(q), torch.from_numpy(db),
                               query_chunk=256)
    rd2, ridx = jax.vmap(jinterp.three_nn)(jnp.asarray(q), jnp.asarray(db))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ridx))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(rd2))
    for b in range(3):
        ns = knn(torch.from_numpy(q[b]), torch.from_numpy(db[b]), 3)
        assert torch.equal(ns.idx, idx[b])


def test_interpolation_weights_and_gradient_match_jax(rng):
    """The weights (zero distances included) within 1e-6; three_interpolate
    and its gradient in the features within 1e-5."""
    d2 = rng.uniform(0, 0.5, (4, 50, 3)).astype(np.float32)
    d2[0, :5, 0] = 0.0
    w = tinterp.interpolation_weights(torch.from_numpy(d2))
    rw = jinterp.interpolation_weights(jnp.asarray(d2))
    np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=1e-6,
                               atol=1e-7)
    feats = rng.normal(size=(4, 20, 7)).astype(np.float32)
    idx = rng.integers(0, 20, (4, 50, 3)).astype(np.int32)
    ct = rng.normal(size=(4, 50, 7)).astype(np.float32)
    f = torch.from_numpy(feats).requires_grad_()
    out = tinterp.three_interpolate(f, torch.from_numpy(idx), w)
    out.backward(torch.from_numpy(ct))
    ref, vjp = jax.vjp(lambda x: jinterp.three_interpolate(
        x, jnp.asarray(idx), rw), jnp.asarray(feats))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5)
    np.testing.assert_allclose(f.grad.numpy(),
                               np.asarray(vjp(jnp.asarray(ct))[0]), atol=1e-5)


@pytest.mark.parametrize("branch", ["broadcast", "ball", "window",
                                    "no_skip"])
def test_feature_propagation_matches_jax(rng, branch):
    """FeaturePropagation in eval and train mode (output and running
    statistics) within rtol = atol = 1e-4: broadcast of a group-all level (known None),
    three-NN interpolation, block-parent unpooling (n = 4m), and no skip
    features."""
    n, m, c1, c2 = 64, 16, 5, 8
    unknown = rng.uniform(size=(2, n, 3)).astype(np.float32)
    known = None if branch == "broadcast" else unknown[:, ::4] + 0.01
    kf = rng.normal(size=(2, 1 if branch == "broadcast" else m, c2)
                    ).astype(np.float32)
    uf = None if branch == "no_skip" else rng.normal(
        size=(2, n, c1)).astype(np.float32)
    grouping = "window" if branch == "window" else "ball"
    jm = jp.FeaturePropagation([16, 12], grouping=grouping)
    args = [jnp.asarray(a) if a is not None else None
            for a in (unknown, known, uf, kf)]
    flat = _fill(jax.eval_shape(lambda *a: jm.init(
        jax.random.PRNGKey(0), *a, train=False), *args), 4)
    tm = tp.FeaturePropagation(c2 + (0 if uf is None else c1), [16, 12],
                               torch.Generator(), grouping=grouping)
    convert.load_flax(tm, flat)
    targs = [torch.from_numpy(a) if a is not None else None
             for a in (unknown, known, uf, kf)]
    tm.eval()
    np.testing.assert_allclose(
        tm(*targs).detach().numpy(),
        np.asarray(jm.apply(_tree(flat), *args, train=False)), rtol=1e-4,
        atol=1e-4)
    ref, upd = jm.apply(_tree(flat), *args, train=True, bn_momentum=0.3,
                        mutable=["batch_stats"])
    tm.train()
    np.testing.assert_allclose(tm(*targs, 0.3).detach().numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)
    sd = tm.state_dict()
    for k, v in flatten_dict(upd["batch_stats"], sep="/").items():
        key, _ = convert.torch_name("batch_stats/" + k)
        np.testing.assert_allclose(sd[key].numpy(), np.asarray(v), atol=1e-4)


@pytest.mark.parametrize("model", ["semseg-ssg", "semseg-msg"])
@pytest.mark.parametrize("grouping", ["ball", "window"])
def test_semseg_logits_match_jax(model, grouping):
    """Eval logits [2, 1024, 13] of converted weights == JAX's within
    1e-4, at ball grouping (FPS, ball query, three-NN interpolation) and
    at window grouping (a Morton-sorted input, block-mean centres, block
    unpooling)."""
    flat, pc, ref = _jax_eval(model, grouping)
    labels = np.random.default_rng(1).integers(0, CLASSES, (B, N))
    out = T.make_eval_step(_port(model, grouping, flat), "cpu")(pc, labels)
    assert out["logits"].shape == (B, N, CLASSES)
    np.testing.assert_allclose(out["logits"].numpy(), ref, rtol=1e-4,
                               atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_semseg_step():
    """One reference loss_fn + gradient of semseg-ssg (ball) at B 2 x
    1,024 with an injected [B, N, 128] dropout keep-mask."""
    cfg = JConfig(model="semseg-ssg", num_classes=CLASSES)
    jm = JT.build_model(cfg)
    pc = _room(4)
    flat = _random_variables(jm, pc, 6)
    tree = _tree(flat)
    rng = np.random.default_rng(8)
    labels = rng.integers(0, CLASSES, (B, N))
    mask = rng.uniform(size=(B, N, 128)) < 0.5
    bnm = float(JT.bn_momentum_schedule(cfg, jnp.int32(0)))

    def masked_dropout(self, inputs, deterministic=None, rng=None):
        return jnp.where(jnp.asarray(mask), inputs / (1.0 - self.rate), 0.0)

    def loss_fn(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": tree["batch_stats"]},
            jnp.asarray(pc), train=True, bn_momentum=bnm,
            rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"])
        return JT.cross_entropy(out, jnp.asarray(labels)), \
            mutated["batch_stats"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", masked_dropout)
        (loss, new_bs), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tree["params"])
    return (flat, pc, labels, mask, bnm, float(loss),
            {"params/" + k: np.asarray(v)
             for k, v in flatten_dict(grads, sep="/").items()},
            {"batch_stats/" + k: np.asarray(v)
             for k, v in flatten_dict(new_bs, sep="/").items()})


def _check_step(model, flat_g, flat_bs, loss, t_loss, t_grads):
    """The step's loss, gradients and running statistics against the
    reference's, within the module docstring's tolerances."""
    np.testing.assert_allclose(float(t_loss), loss, rtol=1e-4, atol=0)
    by_name = dict(zip([n for n, _ in model.named_parameters()], t_grads))
    assert len(flat_g) == len(by_name)
    total = np.sqrt(sum(np.sum(g ** 2) for g in flat_g.values()))
    for name, ref in flat_g.items():
        key, transpose = convert.torch_name(name)
        got = by_name[key].numpy()
        got = got.T if transpose else got
        err = np.abs(got - ref).max()
        assert err <= 5e-2 * max(np.linalg.norm(ref), 1e-3 * total), \
            (name, err, np.linalg.norm(ref))
    sd = model.state_dict()
    for name, ref in flat_bs.items():
        key, _ = convert.torch_name(name)
        np.testing.assert_allclose(sd[key].numpy(), ref, rtol=0, atol=3e-4,
                                   err_msg=name)


def test_semseg_ssg_train_step_matches_jax():
    """One train step of semseg-ssg on converted weights with the same
    dropout mask: loss, every gradient and every BN's running statistics
    after the step."""
    flat, pc, labels, mask, bnm, loss, grads, new_bs = _jax_semseg_step()
    cfg = tconfig.TrainConfig(model="semseg-ssg", num_classes=CLASSES)
    assert T.bn_momentum_schedule(cfg, 0) == bnm == 0.5
    model = _port("semseg-ssg", "ball", flat)
    t_loss, logits, t_grads = T.loss_and_grads(
        model, torch.from_numpy(pc), torch.from_numpy(labels), bnm,
        dropout_mask=torch.from_numpy(mask))
    assert logits.shape == (B, N, CLASSES)
    _check_step(model, grads, new_bs, loss, t_loss, t_grads)


@pytest.mark.parametrize("model", ["semseg-ssg", "semseg-msg"])
def test_converter_covers_the_segmenters(model):
    """Every flax leaf of a segmenter lands in the port's state_dict (112
    and 167 variables), every port entry is filled."""
    flat, *_ = _jax_eval(model, "ball")
    assert len(flat) == {"semseg-ssg": 112, "semseg-msg": 167}[model]
    sd = _port(model, "ball", flat).state_dict()
    assert len(sd) == len(flat)
    assert convert.torch_name(
        "params/FeaturePropagation_3/SharedMLP_0/Dense_1/kernel") == (
        "fp.3.mlps.0.dense.1.weight", True)


def test_segmenters_ignore_compute_dtype_and_classifiers_take_it():
    """semseg-* run in float32 whatever compute_dtype says (the reference
    passes it only to models with a dtype field): the same logits as a
    float32 build. cls-* at bfloat16 carry it into every SharedMLP."""
    pc = torch.from_numpy(_room(9, b=1, n=256))
    outs = []
    for dtype in ("float32", "bfloat16"):
        cfg = tconfig.TrainConfig(model="semseg-ssg", num_classes=CLASSES,
                                  compute_dtype=dtype)
        model = T.build_model(cfg, device="cpu")
        assert all(m.dtype == torch.float32 for m in model.modules()
                   if isinstance(m, tp.SharedMLP))
        with torch.no_grad():
            outs.append(model(pc))
    assert outs[1].dtype == torch.float32 and torch.equal(*outs)
    cls = T.build_model(tconfig.TrainConfig(compute_dtype="bfloat16"),
                        device="cpu")
    assert {m.dtype for m in cls.modules()
            if isinstance(m, tp.SharedMLP)} == {torch.bfloat16}


def test_evaluate_flattens_per_point_labels():
    """`evaluate(collect_logits=True)` on a segmenter returns the labels
    and predictions of every point, flattened as the reference does."""
    model = T.build_model(tconfig.TrainConfig(
        model="semseg-ssg", num_classes=CLASSES), device="cpu")
    pcs = _room(10, b=4, n=128)
    labels = np.random.default_rng(2).integers(0, CLASSES, (4, 128))
    ds = [(pcs[i], labels[i]) for i in range(4)]
    res = fit.evaluate(model, ds, 2, collect_logits=True, device="cpu")
    np.testing.assert_array_equal(res["labels"], labels.reshape(-1))
    assert res["preds"].shape == (4 * 128,)
    assert np.isfinite(res["loss"]) and 0.0 <= res["acc"] <= 1.0
