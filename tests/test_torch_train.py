"""The PointNet++ training step against the JAX package, on the CPU: one
`cls-ssg` step's loss, gradients and updated BN statistics on converted
flax weights with the same dropout mask (unfused grouping, and the fused
ball-group branch forced on, whose backward is kernel 14's plain
version), `RuntimeBN` in train mode at the schedule's momentum, the lr
and BN-momentum schedules, and the optimizer against the optax chain.
Inputs come from numpy with a seed.

Tolerances of the step, set from the float32 error of each side against
a float64 run of the port on the same input (B 8 x 512, measured): the
loss within rtol 1e-5 (JAX 4.9e-6 relative from float64, the port
6.6e-7), the BN statistics within 1e-4 (1.6e-5, 3.4e-6), each gradient
within 2e-2 of its norm (JAX up to 9.0e-3, the port 1.5e-3: a BN bias or
scale gradient sums ~2.6e5 terms that BN's backward makes cancel, and
XLA's fused CPU reductions round more), with a floor of 1e-3 of the whole
gradient's norm for the gradients that are zero in exact arithmetic (the
bias of the BN ahead of group-all's max-pool). BN over B = 2 clouds
amplifies rounding further, so the step is held at B = 8. The optimizer
within 1e-6 on identical gradients."""
import torch_threads as _torch_threads  # noqa: F401

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pctpu.models.pointnet2 import RuntimeBN as JRuntimeBN
from pctpu.nn import train as JT
from pctpu.nn.config import TrainConfig as JConfig
from pctpu_torch.models import convert
from pctpu_torch.models import pointnet2 as tp
from pctpu_torch.nn import config as tconfig
from pctpu_torch.nn import data as tdata
from pctpu_torch.nn import train as T
from pctpu_torch.ops import pallas_gather

B, N, CLASSES = 8, 512, 10


def _clouds(seed, b=B, n=N):
    """[b,n,6]: points and unit normals on the surface of a random box,
    cylinder or sphere (in turn), randomly rotated, xyz normalised. A
    batch of different shapes keeps train-mode BN well conditioned
    (near-equal clouds give channels whose batch variance is small, where
    float32 rounding is amplified)."""
    from scipy.spatial.transform import Rotation
    rng = np.random.default_rng(seed)
    out = []
    for k in range(b):
        a = rng.uniform(0.3, 1.0, 3)
        u = rng.uniform(-1, 1, (n, 3))
        if k % 3 == 0:          # box: a face per point, by area
            area = np.array([a[1] * a[2], a[0] * a[2], a[0] * a[1]])
            ax = rng.choice(3, n, p=area / area.sum())
            sgn = rng.choice([-1.0, 1.0], n)
            p = u * a
            p[np.arange(n), ax] = sgn * a[ax]
            nrm = np.zeros_like(p)
            nrm[np.arange(n), ax] = sgn
        elif k % 3 == 1:        # cylinder side along z
            th = rng.uniform(0, 2 * np.pi, n)
            p = np.stack([a[0] * np.cos(th), a[0] * np.sin(th),
                          a[2] * u[:, 2]], 1)
            nrm = np.stack([np.cos(th), np.sin(th), 0 * th], 1)
        else:                   # sphere
            nrm = rng.normal(size=(n, 3))
            nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
            p = a[0] * nrm
        R = Rotation.random(random_state=rng).as_matrix()
        out.append(np.hstack([tdata.pc_normalize_np(p @ R.T), nrm @ R.T]))
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_step():
    """One reference loss_fn + gradient (`pctpu/nn/train.py:110-119`) with
    an injected dropout keep-mask: (flat variables before the step, pc,
    labels, mask, loss, flat gradients, flat updated batch_stats)."""
    cfg = JConfig(model="cls-ssg", num_classes=CLASSES, num_points=N,
                  batch_size=B)
    pc = _clouds(3)
    jm = JT.build_model(cfg)
    key = jax.random.PRNGKey(1)      # create_train_state's init, jitted
    variables = jax.jit(lambda x: jm.init({"params": key, "dropout": key},
                                          x, train=True))(jnp.asarray(pc))
    rng = np.random.default_rng(5)
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
    bnm = JT.bn_momentum_schedule(cfg, jnp.int32(0))

    def masked_dropout(self, inputs, deterministic=None, rng=None):
        det = self.deterministic if deterministic is None else deterministic
        if det:
            return inputs
        keep = 1.0 - self.rate
        return jnp.where(jnp.asarray(mask), inputs / keep, 0.0)

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
    flat_g = {"params/" + k: np.asarray(v)
              for k, v in flatten_dict(grads, sep="/").items()}
    flat_bs = {"batch_stats/" + k: np.asarray(v)
               for k, v in flatten_dict(new_bs, sep="/").items()}
    return flat, pc, labels, mask, float(loss), flat_g, flat_bs, float(bnm)


@pytest.mark.parametrize("fused", [False, True])
def test_cls_ssg_train_step_matches_jax(fused, monkeypatch):
    """Loss, every parameter's gradient and the BN running statistics
    after the step, within the tolerances of the module docstring. With
    `fused` the rule is read as on the card, so both SA levels go through
    kernel 12's plain version and SA2's backward through kernel 14's."""
    flat, pc, labels, mask, loss, grads, new_bs, bnm = _jax_step()
    assert bnm == 0.5
    if fused:
        rule = tp.fused_ok
        monkeypatch.setattr(tp, "fused_ok", lambda n, c, on: rule(n, c, True))
    calls = []
    real = pallas_gather.scatter_add_rows_pallas

    def counting(*args):
        calls.append(args[0].shape)
        return real(*args)
    monkeypatch.setattr(pallas_gather, "scatter_add_rows_pallas", counting)
    cfg = tconfig.TrainConfig(model="cls-ssg", num_classes=CLASSES,
                              num_points=N, batch_size=B)
    model = convert.load_flax(T.build_model(cfg, device="cpu"), flat)
    t_loss, logits, t_grads = T.loss_and_grads(
        model, torch.from_numpy(pc), torch.from_numpy(labels),
        T.bn_momentum_schedule(cfg, 0), dropout_mask=torch.from_numpy(mask))
    # SA2's packed input needs a gradient, SA1's (the cloud) does not
    assert calls == ([(B, 128 * 64, 131)] if fused else [])
    assert logits.shape == (B, CLASSES)
    np.testing.assert_allclose(float(t_loss), loss, rtol=1e-5, atol=0)
    names = [n for n, _ in model.named_parameters()]
    by_name = dict(zip(names, t_grads))
    assert len(grads) == len(names)
    total = np.sqrt(sum(np.sum(g ** 2) for g in grads.values()))
    for name, ref in grads.items():
        key, transpose = convert.torch_name(name)
        got = by_name[key].numpy()
        got = got.T if transpose else got
        err = np.abs(got - ref).max()
        assert err <= 2e-2 * max(np.linalg.norm(ref), 1e-3 * total), \
            (name, err, np.linalg.norm(ref))
    sd = model.state_dict()
    for name, ref in new_bs.items():
        key, _ = convert.torch_name(name)
        np.testing.assert_allclose(sd[key].numpy(), ref, rtol=0, atol=1e-4,
                                   err_msg=name)


def test_runtime_bn_train_at_schedule_momentum():
    """RuntimeBN in train mode at the schedule's first momentum (0.5) and
    a later one (0.125): output and updated statistics == flax within
    1e-5."""
    rng = np.random.default_rng(12)
    x = rng.normal(loc=-0.5, scale=3.0, size=(3, 40, 24)).astype(np.float32)
    stats = {"mean": rng.normal(size=24).astype(np.float32),
             "var": rng.uniform(0.5, 2, 24).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 2, 24).astype(np.float32),
              "bias": rng.normal(size=24).astype(np.float32)}
    for m in (0.5, 0.125):
        ref, upd = JRuntimeBN().apply(
            {"params": params, "batch_stats": stats}, jnp.asarray(x),
            train=True, momentum=m, mutable=["batch_stats"])
        bn = tp.RuntimeBN(24)
        bn.load_state_dict({k: torch.from_numpy(a) for k, a in
                            {**params, **stats}.items()})
        out = bn.train()(torch.from_numpy(x), m)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                                   atol=1e-5)
        for k in ("mean", "var"):
            np.testing.assert_allclose(getattr(bn, k).numpy(),
                                       np.asarray(upd["batch_stats"][k]),
                                       atol=1e-5)


@pytest.mark.parametrize("preset", ["MODELNET40_CLS_SSG", "KITTI_CLS_MSG",
                                    "S3DIS_SEMSEG_SSG"])
def test_schedules_match_jax(preset):
    """lr and BN momentum at step 0, the first decay step and 10^7 (the
    clipped floor), exactly the reference's float32 values."""
    tcfg = getattr(tconfig, preset)
    jcfg = JConfig(**{f: getattr(tcfg, f) for f in tcfg.__dataclass_fields__})
    first = int(np.ceil(tcfg.decay_step / tcfg.batch_size))
    for step in (0, first - 1, first, 10 ** 7):
        assert T.lr_schedule(tcfg, step) == float(
            JT.lr_schedule(jcfg, jnp.int32(step))), (preset, step)
        assert T.bn_momentum_schedule(tcfg, step) == float(
            JT.bn_momentum_schedule(jcfg, jnp.int32(step))), (preset, step)
    assert T.bn_momentum_schedule(tcfg, 0) == 0.5
    assert T.lr_schedule(tcfg, 10 ** 7) == float(np.float32(tcfg.lr_clip))


@pytest.mark.parametrize("grad_clip,weight_decay", [(0.0, 0.0), (0.5, 1e-2),
                                                    (100.0, 1e-4)])
def test_optimizer_matches_optax(grad_clip, weight_decay):
    """Three updates on identical gradients: the parameters and both
    moments == the reference's optax chain (`make_optimizer`) within
    1e-6, with the clip binding (0.5), not binding (100) and off. The lr
    schedule decays after the first step (decay_step 64, batch 32)."""
    cfg = tconfig.TrainConfig(grad_clip=grad_clip, weight_decay=weight_decay,
                              decay_step=64.0, batch_size=32)
    jcfg = JConfig(grad_clip=grad_clip, weight_decay=weight_decay,
                   decay_step=64.0, batch_size=32)
    rng = np.random.default_rng(9)
    shapes = [(7, 3), (5,), (4, 4, 2)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    tx = JT.make_optimizer(jcfg)
    jp = {str(i): jnp.asarray(p) for i, p in enumerate(params)}
    jstate = tx.init(jp)
    tp_ = [torch.from_numpy(p.copy()) for p in params]
    opt = T.make_optimizer(cfg)
    tstate = opt.init(tp_)
    for step in range(3):
        grads = [rng.normal(scale=0.3, size=s).astype(np.float32)
                 for s in shapes]
        upd, jstate = tx.update({str(i): jnp.asarray(g)
                                 for i, g in enumerate(grads)}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        opt.update([torch.from_numpy(g) for g in grads], tstate, tp_)
        assert tstate.count == step + 1
        for i, p in enumerate(tp_):
            np.testing.assert_allclose(p.numpy(), np.asarray(jp[str(i)]),
                                       rtol=1e-6, atol=1e-6)
    adam = [s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    for i in range(len(shapes)):
        np.testing.assert_allclose(tstate.mu[i].numpy(),
                                   np.asarray(adam.mu[str(i)]), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(tstate.nu[i].numpy(),
                                   np.asarray(adam.nu[str(i)]), rtol=1e-6,
                                   atol=1e-9)


def test_train_step_updates_state_and_draws_dropout_from_its_generator():
    """make_train_step: metrics, step and moments advance, every parameter
    moves, the BN statistics move; the same generator seed gives the same
    step; train mode without a generator or mask raises."""
    cfg = tconfig.TrainConfig(model="cls-ssg", num_classes=CLASSES,
                              batch_size=B)
    pc, labels = _clouds(4, b=2, n=256), np.array([1, 7])
    results = []
    for _ in range(2):
        model, state = T.create_train_state(
            cfg, torch.Generator().manual_seed(3), pc, device="cpu")
        before = {k: v.clone() for k, v in model.state_dict().items()}
        step = T.make_train_step(model, cfg, device="cpu")
        out = step(state, pc, labels, torch.Generator().manual_seed(11))
        assert state.step == 1 and state.opt_state.count == 1
        assert out["lr"] == float(np.float32(cfg.lr))
        assert np.isfinite(float(out["loss"]))
        after = model.state_dict()
        assert all(not torch.equal(before[k], after[k]) for k in after)
        results.append(float(out["loss"]))
    assert results[0] == results[1]
    with pytest.raises(ValueError, match="generator"):
        step(state, pc, labels)
