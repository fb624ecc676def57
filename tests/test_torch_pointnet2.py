"""The PointNet++ classification serving slice against the JAX package, on
the CPU: the weight converter, the `cls-ssg` / `cls-msg` logits from
converted weights (unfused grouping, and the fused ball-group branch
forced on), the reference's fused-kernel rule, `RuntimeBN`, the loss and
accuracy, the numpy data helpers, and the entry points' device rule.
Inputs come from numpy with a seed.

Logits agree within rtol = atol = 1e-4: the Dense layers' sums run in
another order in the two libraries' CPU BLAS; the neighbour selection
(FPS, ball query) is exact on both sides."""
import torch_threads as _torch_threads  # noqa: F401

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from pctpu.models.pointnet2 import RuntimeBN as JRuntimeBN
from pctpu.nn import data as jdata
from pctpu.nn import train as JT
from pctpu.nn.config import TrainConfig as JConfig
from pctpu_torch.entry import entry
from pctpu_torch.models import convert
from pctpu_torch.models import pointnet2 as tp
from pctpu_torch.nn import config as tconfig
from pctpu_torch.nn import data as tdata
from pctpu_torch.nn import fit
from pctpu_torch.nn import train as T
from pctpu_torch.ops import pallas_ballgroup

B, N, CLASSES = 2, 512, 10
MODELS = ["cls-ssg", "cls-msg"]


def _clouds(seed, b=B, n=N):
    """[b,n,6]: normalised xyz (a noisy ellipsoid surface) + unit normals."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(b):
        nrm = rng.normal(size=(n, 3))
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        xyz = nrm * rng.uniform(0.4, 1.0, 3) + rng.normal(scale=0.02,
                                                         size=(n, 3))
        out.append(np.hstack([tdata.pc_normalize_np(xyz), nrm]))
    return np.stack(out).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_reference(model, use_xyz):
    """(flat flax variables, pc, labels, JAX eval output) for one model.
    BN statistics, scales and biases are drawn at random so the
    conversion of every leaf shows in the logits."""
    cfg = JConfig(model=model, num_classes=CLASSES, num_points=N,
                  batch_size=B, use_xyz=use_xyz)
    pc = _clouds(3)
    jm, state = JT.create_train_state(cfg, jax.random.PRNGKey(1),
                                      jnp.asarray(pc))
    rng = np.random.default_rng(5)
    flat = {k: np.asarray(v) for k, v in flatten_dict(
        {"params": state.params, "batch_stats": state.batch_stats},
        sep="/").items()}
    for k, v in flat.items():
        leaf = k.rsplit("/", 1)[1]
        if leaf in ("mean", "bias") and "RuntimeBN" in k:
            flat[k] = rng.normal(scale=0.1, size=v.shape).astype(np.float32)
        elif leaf in ("var", "scale"):
            flat[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})
    state.params, state.batch_stats = tree["params"], tree["batch_stats"]
    labels = rng.integers(0, CLASSES, B)
    out = JT.make_eval_step(jm)(state, jnp.asarray(pc), jnp.asarray(labels))
    return flat, pc, labels, {k: np.asarray(v) for k, v in out.items()}


def _port_model(model, use_xyz, flat):
    cfg = tconfig.TrainConfig(model=model, num_classes=CLASSES,
                              num_points=N, batch_size=B, use_xyz=use_xyz)
    return convert.load_flax(T.build_model(cfg, device="cpu"), flat)


@pytest.mark.parametrize("model", MODELS)
def test_converter_round_trips_every_leaf(model):
    """Every flax leaf lands in the port's state_dict with its value (a
    Dense kernel transposed), every port entry is filled, and a leftover
    on either side raises."""
    flat, *_ = _jax_reference(model, True)
    n_params = sum(k.startswith("params/") for k in flat)
    assert n_params == {"cls-ssg": 35, "cls-msg": 71}[model]
    tm = _port_model(model, True, flat)
    sd = tm.state_dict()
    assert len(sd) == len(flat)
    for name, value in flat.items():
        key, transpose = convert.torch_name(name)
        got = sd[key].numpy()
        np.testing.assert_array_equal(got.T if transpose else got, value)
    extra = dict(flat, **{"params/Dense_3/kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="not in the model"):
        convert.state_dict_from_flax(extra, tm)
    short = {k: v for k, v in flat.items() if not k.endswith("Dense_2/bias")}
    with pytest.raises(KeyError, match="no flax variable"):
        convert.state_dict_from_flax(short, tm)
    assert convert.torch_name(
        "params/SetAbstraction_0/SharedMLP_1/Dense_0/kernel") == (
        "sa.0.mlps.1.dense.0.weight", True)


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("use_xyz", [True, False])
def test_logits_match_jax(model, use_xyz):
    """Logits, loss and accuracy of `make_eval_step` on converted weights
    == JAX `make_eval_step` within 1e-4 (the unfused CPU path: plain FPS,
    ball_query, group_points)."""
    flat, pc, labels, ref = _jax_reference(model, use_xyz)
    out = T.make_eval_step(_port_model(model, use_xyz, flat), "cpu")(
        pc, labels)
    assert out["logits"].shape == (B, CLASSES)
    np.testing.assert_allclose(out["logits"].numpy(), ref["logits"],
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(out["loss"]), float(ref["loss"]),
                               rtol=1e-4, atol=1e-4)
    assert float(out["acc"]) == float(ref["acc"])


@pytest.mark.parametrize("model", MODELS)
@pytest.mark.parametrize("use_xyz", [True, False])
def test_fused_branch_matches_jax(model, use_xyz, monkeypatch):
    """The fused ball-group branch forced on the CPU (the rule read as if
    the tensors were on the card, so the scales the card fuses take
    kernel 12's plain version) == JAX's unfused CPU path within 1e-4."""
    flat, pc, labels, ref = _jax_reference(model, use_xyz)
    rule = tp.fused_ok
    monkeypatch.setattr(tp, "fused_ok", lambda n, c, on: rule(n, c, True))
    calls = []
    real = pallas_ballgroup.ball_group_pallas_batched

    def counting(*args, **kw):
        calls.append(args[3])
        return real(*args, **kw)
    monkeypatch.setattr(pallas_ballgroup, "ball_group_pallas_batched",
                        counting)
    out = T.make_eval_step(_port_model(model, use_xyz, flat), "cpu")(
        pc, labels)
    assert calls == {"cls-ssg": [64, 64], "cls-msg": [16, 32, 128, 32]}[model]
    np.testing.assert_allclose(out["logits"].numpy(), ref["logits"],
                               rtol=1e-4, atol=1e-4)


def test_fused_ok_picks_the_reference_scales():
    """The rule fuses exactly these scales (packed channels 3 + features,
    rounded up to 8): cls-msg SA1 all three (cp8 8), SA2 nsample 32 only
    (cp8 328: 5.37 MB; 64 and 128 exceed 6 MiB); cls-ssg both (cp8 8,
    136); semseg-ssg all four (packed 9, 67, 131, 259); semseg-msg all
    but SA4's nsample 32 (packed 515: 32 x 520 x 512 B > 6 MiB); and
    nothing off the card."""
    channels = {"cls-msg": [6, 323], "cls-ssg": [6, 131],
                "semseg-ssg": [9, 67, 131, 259],
                "semseg-msg": [9, 99, 259, 515]}
    want = {"cls-msg": [[True, True, True], [True, False, False]],
            "cls-ssg": [[True], [True]],
            "semseg-ssg": [[True]] * 4,
            "semseg-msg": [[True, True]] * 3 + [[True, False]]}
    assert set(tp.MODEL_REGISTRY) == set(want)
    for name, cls in tp.MODEL_REGISTRY.items():
        got = [[tp.fused_ok(ns, ch, True) for ns in spec[2]]
               for spec, ch in zip(cls.SA_SPECS, channels[name])]
        assert got == want[name], name
        assert not any(tp.fused_ok(ns, ch, False) for spec, ch in
                       zip(cls.SA_SPECS, channels[name]) for ns in spec[2])


def test_runtime_bn_matches_flax():
    """RuntimeBN, eval and train (batch statistics, torch-convention
    momentum on the running ones), == the reference's within 1e-5."""
    rng = np.random.default_rng(2)
    x = rng.normal(loc=1.0, scale=2.0, size=(4, 7, 16)).astype(np.float32)
    jbn = JRuntimeBN()
    v = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    stats = {"mean": rng.normal(size=16).astype(np.float32),
             "var": rng.uniform(0.5, 2, 16).astype(np.float32)}
    params = {"scale": rng.uniform(0.5, 2, 16).astype(np.float32),
              "bias": rng.normal(size=16).astype(np.float32)}
    v = {"params": params, "batch_stats": stats}
    tbn = tp.RuntimeBN(16)
    tbn.load_state_dict({k: torch.from_numpy(a) for k, a in
                         {**params, **stats}.items()})
    tbn.eval()
    np.testing.assert_allclose(
        tbn(torch.from_numpy(x)).detach().numpy(),
        np.asarray(jbn.apply(v, jnp.asarray(x), train=False)), atol=1e-5)
    ref, upd = jbn.apply(v, jnp.asarray(x), train=True, momentum=0.3,
                         mutable=["batch_stats"])
    tbn.train()
    np.testing.assert_allclose(tbn(torch.from_numpy(x), 0.3).detach().numpy(),
                               np.asarray(ref), atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(getattr(tbn, k).numpy(),
                                   np.asarray(upd["batch_stats"][k]),
                                   atol=1e-5)


@pytest.mark.parametrize("shape", [(6, 40), (2, 50, 13)])
def test_cross_entropy_and_accuracy_match_jax(shape):
    rng = np.random.default_rng(4)
    logits = rng.normal(scale=3.0, size=shape).astype(np.float32)
    labels = rng.integers(0, shape[-1], shape[:-1])
    np.testing.assert_allclose(
        float(T.cross_entropy(torch.from_numpy(logits),
                              torch.from_numpy(labels))),
        float(JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))),
        rtol=1e-6)
    assert float(T.accuracy(torch.from_numpy(logits),
                            torch.from_numpy(labels))) == float(
        JT.accuracy(jnp.asarray(logits), jnp.asarray(labels)))


def test_data_helpers_match_jax():
    """pc_normalize_np, split_train_val and iterate_batches are copies."""
    rng = np.random.default_rng(6)
    xyz = rng.normal(loc=3.0, size=(100, 3))
    np.testing.assert_array_equal(tdata.pc_normalize_np(xyz),
                                  jdata.pc_normalize_np(xyz))
    for a, b in zip(tdata.split_train_val(53, seed=2),
                    jdata.split_train_val(53, seed=2)):
        np.testing.assert_array_equal(a, b)
    ds = [(rng.normal(size=(4, 6)), i % 3) for i in range(11)]
    for kw in (dict(shuffle=True, seed=1), dict(shuffle=False,
                                                drop_last=False)):
        got = list(tdata.iterate_batches(ds, 4, **kw))
        ref = list(jdata.iterate_batches(ds, 4, **kw))
        assert len(got) == len(ref)
        for (gx, gy), (rx, ry) in zip(got, ref):
            np.testing.assert_array_equal(gx, rx)
            np.testing.assert_array_equal(gy, ry)


def test_evaluate_and_entry_on_cpu():
    """`evaluate` over a small dataset and the flagship `entry()` forward
    run on device='cpu'."""
    model = T.build_model(tconfig.TrainConfig(model="cls-ssg",
                                              num_classes=CLASSES),
                          device="cpu", generator=torch.Generator(
                              ).manual_seed(0))
    pcs = _clouds(8, b=4, n=256)
    ds = [(pcs[i], i % CLASSES) for i in range(4)]
    res = fit.evaluate(model, ds, 2, collect_logits=True, device="cpu")
    assert np.isfinite(res["loss"]) and 0.0 <= res["acc"] <= 1.0
    np.testing.assert_array_equal(res["labels"], [0, 1, 2, 3])
    assert res["preds"].shape == (4,)
    fwd, (pc,) = entry(device="cpu")
    assert pc.shape == (4, 1024, 6)
    logits = fwd(pc)
    assert logits.shape == (4, 40) and bool(torch.isfinite(logits).all())


def test_entry_points_raise_without_cuda(monkeypatch):
    """No silent CPU fallback: without a card, build_model,
    make_eval_step, evaluate and entry raise unless given device='cpu'."""
    cpu_model = T.build_model(tconfig.MODELNET40_CLS_SSG, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.build_model(tconfig.MODELNET40_CLS_SSG)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_eval_step(cpu_model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fit.evaluate(cpu_model, [], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_build_model_refuses_what_is_not_ported():
    """What build_model refused before the segmenters, window grouping
    and bfloat16 were ported now builds on the CPU and runs a forward:
    finite float32 logits of the model's shape."""
    pc = torch.from_numpy(_clouds(2, b=1, n=512))
    for cfg, shape in ((tconfig.S3DIS_SEMSEG_SSG, (1, 512, 13)),
                       (tconfig.TrainConfig(compute_dtype="bfloat16"),
                        (1, 40)),
                       (tconfig.TrainConfig(grouping="window"), (1, 40))):
        model = T.build_model(cfg, device="cpu")
        x = torch.cat([pc, pc[..., :3]], -1) if shape[-1] == 13 else pc
        with torch.no_grad():
            logits = model(x)
        assert logits.shape == shape and logits.dtype == torch.float32
        assert bool(torch.isfinite(logits).all())
