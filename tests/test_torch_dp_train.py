"""The data-parallel train step (`nn.train.make_data_parallel_train_step`)
and the BN layers' global batch statistics, in one gloo world of 4 CPU
ranks (`tests/torch_ranks.py:dp_train_checks`, once for the module):
`cls-ssg` at 8 x 128 x 6 on converted flax weights, two clouds a rank, a
first step with an injected dropout keep-mask, another first step with
the mask drawn from a seeded generator, then two more steps.

Tolerances:

  * against the one-process `make_train_step` on the whole batch, the
    same mask or the same generator (`torch_ranks.dp_mismatches`): the
    loss within rtol 1e-6 (measured 4e-7), accuracy and lr equal; each
    gradient within 1e-3 of its norm, floored at 1e-3 of the whole
    gradient's norm (measured 1.3e-4 of its norm: the ranks sum their
    rows, then the ranks, a float32 reordering that BN's backward
    amplifies; each side's own float32 error is ~1.5e-3,
    `tests/test_torch_train.py`); each
    parameter as far as Adam's first step makes of the two gradients,
    lr (|u(g) - u(g')| + 1e-5) + 1e-6 of the tensor's largest entry with
    u(g) = g / (|g| + eps) (a gradient within the rounding of 0, as the BN
    bias ahead of group-all's max-pool, can take either sign and move its
    parameter by lr either way); the BN statistics within 1e-5;
  * against the reference's `make_data_parallel_train_step` on a
    4-device mesh with the same mask (`tests/test_torch_train.py`'s
    bounds): the loss within rtol 1e-5, each gradient (the first Adam
    moment over 1 - b1) within 2e-2 of its norm with a floor of 1e-3 of
    the whole gradient's norm, the BN statistics within 1e-4;
  * `RuntimeBN` and `FoldedDenseBNRelu(stat_stride=3)` under the group
    against themselves on the whole batch: outputs, input and parameter
    gradients and running statistics within 1e-5 (the stride picks the
    same rows: 80 rows a rank start at offsets 0, 2, 1, 0);
  * every rank holds the same parameters (0 apart).
"""
import torch_threads as _torch_threads  # noqa: F401

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from jax.sharding import Mesh

from pctpu.nn import train as JT
from pctpu.nn.config import TrainConfig as JConfig
from pctpu_torch.models import convert
from pctpu_torch.models import pointnet2 as tp
from pctpu_torch.nn import config as tconfig
from pctpu_torch.nn import train as T
from pctpu_torch.parallel.launch import run_world

import torch_ranks
from test_torch_train import _clouds

W, B, N, CLASSES = 4, 8, 128, 10
CFG = dict(model="cls-ssg", num_classes=CLASSES, num_points=N, batch_size=B)


@functools.lru_cache(maxsize=None)
def _reference():
    """The flax variables (BN statistics and scales randomised as in
    `tests/test_torch_train.py`), the batch, the keep-mask, and the
    reference's data-parallel step on 4 devices with that mask: (flat
    variables, pc, labels, mask, loss, flat gradients, flat batch_stats)."""
    cfg = JConfig(**CFG)
    pc = _clouds(21, B, N)
    jm = JT.build_model(cfg)
    key = jax.random.PRNGKey(4)
    variables = jax.jit(lambda x: jm.init({"params": key, "dropout": key},
                                          x, train=True))(jnp.asarray(pc))
    rng = np.random.default_rng(6)
    flat = {k: np.asarray(v) for k, v in flatten_dict(
        dict(variables), sep="/").items()}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if leaf in ("mean", "bias") and "RuntimeBN" in k:
            flat[k] = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        elif leaf in ("var", "scale"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    labels = rng.integers(0, CLASSES, B)
    mask = rng.uniform(size=(B, 256)) < 0.5

    def masked_dropout(self, inputs, deterministic=None, rng=None):
        det = self.deterministic if deterministic is None else deterministic
        if det:
            return inputs
        return jnp.where(jnp.asarray(mask), inputs / (1.0 - self.rate), 0.0)

    tx = JT.make_optimizer(cfg)
    state = JT.TrainState(tree["params"], tree["batch_stats"],
                          tx.init(tree["params"]), jnp.int32(0))
    mesh = Mesh(np.array(jax.devices()[:W]), ("data",))
    with pytest.MonkeyPatch.context() as mp, mesh:
        mp.setattr(fnn.Dropout, "__call__", masked_dropout)
        step = JT.make_data_parallel_train_step(jm, cfg, mesh)
        new, metrics = step(state, jnp.asarray(pc), jnp.asarray(labels),
                            jax.random.PRNGKey(2))
    adam = [s for s in jax.tree_util.tree_leaves(
        new.opt_state, is_leaf=lambda s: hasattr(s, "mu"))
        if hasattr(s, "mu")][0]
    grads = {"params/" + k: np.asarray(v) / 0.1 for k, v in
             flatten_dict(adam.mu, sep="/").items()}
    stats = {"batch_stats/" + k: np.asarray(v) for k, v in
             flatten_dict(new.batch_stats, sep="/").items()}
    return flat, pc, labels, mask, float(metrics["loss"]), grads, stats


def _bn_inputs():
    rng = np.random.default_rng(8)
    x = rng.normal(loc=0.3, scale=2.0, size=(B, 40, 24)).astype(np.float32)
    bn = dict(x=x, features=16, stride=3)
    bn["runtime"] = {"scale": rng.uniform(0.5, 2, 24), "bias":
                     rng.normal(size=24), "mean": rng.normal(size=24),
                     "var": rng.uniform(0.5, 2, 24)}
    bn["folded"] = {"weight": rng.normal(size=(16, 24)) / 5.0, "scale":
                    rng.uniform(0.5, 2, 16), "bias": rng.normal(size=16),
                    "mean": rng.normal(size=16), "var": rng.uniform(0.5, 2,
                                                                    16)}
    for k in ("runtime", "folded"):
        bn[k] = {n: v.astype(np.float32) for n, v in bn[k].items()}
    bn["w"] = {"runtime": rng.normal(size=(B, 40, 24)).astype(np.float32),
               "folded": rng.normal(size=(B, 40, 16)).astype(np.float32)}
    return bn


@pytest.fixture(scope="module")
def setup():
    flat, pc, labels, mask, *_ = _reference()
    cfg = tconfig.TrainConfig(**CFG)
    model = convert.load_flax(T.build_model(cfg, device="cpu"), flat)
    state = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return dict(cfg=CFG, state=state, pc=pc, labels=labels, mask=mask,
                seed=11, more=2, device="cpu", bn=_bn_inputs())


@pytest.fixture(scope="module")
def world(setup):
    return run_world(torch_ranks.dp_train_checks, W, "gloo", "cpu", setup,
                     timeout=300)


@pytest.fixture(scope="module")
def one_process(setup):
    """`make_train_step` on the whole batch: the same two first steps."""
    return torch_ranks.one_process_steps(setup)


@pytest.mark.parametrize("how", ["mask", "generator"])
def test_dp_step_matches_one_process(world, one_process, how):
    """A first step (the injected keep-mask, or the mask drawn from the
    generator) against the one-process step on the whole batch: loss and
    accuracy, each gradient, the parameters whose gradient is clear of the
    rounding, every parameter within Adam's bound, and the BN statistics
    (`torch_ranks.dp_mismatches`); then two more steps with finite
    losses."""
    assert world["spread"] == 0.0
    assert torch_ranks.dp_mismatches(world[how], one_process[how],
                                     one_process["names"]) == []
    assert len(world["losses"]) == 2 and np.isfinite(world["losses"]).all()


def test_dp_step_matches_jax_data_parallel(world, one_process):
    """The first step against the reference's data-parallel step on 4
    devices with the same mask: loss, gradients and BN statistics."""
    _, _, _, _, loss, grads, stats = _reference()
    assert world["mask"]["metrics"]["loss"] == pytest.approx(loss, rel=1e-5)
    by_name = dict(zip(one_process["names"], world["mask"]["grads"]))
    total = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                        for g in grads.values()))
    assert len(grads) == len(by_name)
    for name, ref in grads.items():
        key, transpose = convert.torch_name(name)
        got = by_name[key].numpy()
        got = got.T if transpose else got
        err = np.abs(got - ref).max()
        assert err <= 2e-2 * max(np.linalg.norm(ref), 1e-3 * total), \
            (name, err, np.linalg.norm(ref))
    sd = world["mask"]["state"]
    for name, ref in stats.items():
        key, _ = convert.torch_name(name)
        np.testing.assert_allclose(sd[key].numpy(), ref, rtol=0, atol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["runtime", "folded"])
def test_bn_global_batch_stats_match_whole_batch(setup, world, name):
    """The layer under the group equals itself on the whole batch: output,
    input gradient, parameter gradients and running statistics within
    1e-5."""
    bn = setup["bn"]
    gen = torch.Generator().manual_seed(3)
    c = bn["x"].shape[-1]
    layer = (tp.RuntimeBN(c) if name == "runtime" else
             tp.FoldedDenseBNRelu(c, bn["features"], gen,
                                  stat_stride=bn["stride"]))
    layer.load_state_dict({k: torch.from_numpy(v)
                           for k, v in bn[name].items()})
    layer.train()
    x = torch.from_numpy(bn["x"]).requires_grad_()
    y = layer(x, 0.5)
    grads = torch.autograd.grad((y * torch.from_numpy(bn["w"][name])).sum(),
                                [x, *layer.parameters()])
    got = world["bn"][name]
    for a, b in [(got["y"], y), (got["dx"], grads[0]),
                 *zip(got["dparams"], grads[1:]),
                 *zip(got["stats"], [layer.mean, layer.var])]:
        np.testing.assert_allclose(a.numpy(), b.detach().numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_dp_step_raises_without_a_card():
    """The step defaults to CUDA and raises without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model = T.build_model(tconfig.TrainConfig(**CFG), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_data_parallel_train_step(model, tconfig.TrainConfig(**CFG),
                                        None)
