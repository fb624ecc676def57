"""Window grouping, bf16 MLPs and the folded BN layer against the JAX
package, on the CPU: Morton codes, `morton_sort` and `morton_sort_packed`
(bit-exact, equal codes in index order), `strided_windows` (bit-exact,
nsample <= stride and > stride), a window scale's masked max (an empty
window pools to 0), `SetAbstraction`'s N < npoint error, the `cls-ssg` /
`cls-msg` logits at window grouping, one `cls-ssg` train step at window
grouping whose running statistics show that the checkpointed scales move
them once, the bf16 logits against JAX's bf16, and `FoldedDenseBNRelu`
(`SharedMLP(fold_bn=True)`) in train and eval mode. Inputs come from
numpy with a seed; weights are drawn with numpy into the flax variables'
shapes and carried across by `models/convert.py`.

Tolerances: data that only moves (codes, sorts, windows) bit-exact;
float32 logits within rtol = atol = 1e-4 (the Dense sums run in another
order in the two libraries' CPU BLAS). The train step at B 4 x 1,024, set
from each side's float32 error against a float64 run of the port
(float32 geometry): the loss within rtol 1e-4 (JAX 7.4e-8 from float64,
the port 9.9e-7), the running statistics within 1e-4 (JAX 1.2e-5, the
port 1.1e-5), each gradient within 2e-2 of its norm, floored at 1e-3 of
the whole gradient's norm (JAX 1.5e-5, the port 2.7e-3: SA2's BN biases
sum 32,768 rows in float32 on the CPU). bf16 logits within 1e-2 of the
largest |logit| (at least 1): both libraries round each Dense product to
bf16 after a float32 sum, in other orders, and a one-ulp (2^-8) flip in
one activation moves the layers after it; measured 2.9e-3 at window
grouping and 2.2e-3 at ball grouping, on logits up to 0.81. The folded
layer within the
reference's own 2e-4 (`tests/test_models.py:265-312`)."""
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
from pctpu.ops import morton as jmorton
from pctpu_torch.models import convert
from pctpu_torch.models import pointnet2 as tp
from pctpu_torch.nn import config as tconfig
from pctpu_torch.nn import train as T
from pctpu_torch.ops import morton as tmorton

CLASSES = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs in several worker processes at
    once, and torch's CPU thread pools would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clouds(seed, b, n):
    """[b,n,6]: points and unit normals on random ellipsoids, xyz in the
    unit sphere."""
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(b, n, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    xyz = nrm * rng.uniform(0.4, 1.0, (b, 1, 3)) + rng.normal(
        scale=0.02, size=(b, n, 3))
    xyz /= np.abs(xyz).max(axis=(1, 2), keepdims=True)
    return np.concatenate([xyz, nrm], -1).astype(np.float32)


def _fill(shapes, seed):
    """Flat flax variables of an eval_shape tree, drawn with numpy:
    kernels ~ N(0, 1/fan_in), biases and means ~ N(0, 0.1), BN scales and
    variances ~ U(0.5, 2)."""
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


def _model_variables(jm, pc, seed):
    return _fill(jax.eval_shape(lambda x: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, train=True), jnp.asarray(pc)), seed)


def _cfgs(model, grouping, dtype="float32"):
    kw = dict(model=model, num_classes=CLASSES, grouping=grouping,
              compute_dtype=dtype)
    return JConfig(**kw), tconfig.TrainConfig(**kw)


@functools.lru_cache(maxsize=None)
def _jax_eval(model, grouping, dtype):
    """(flat variables, pc, JAX eval logits as float32)."""
    jcfg, _ = _cfgs(model, grouping, dtype)
    jm = JT.build_model(jcfg)
    pc = _clouds(3, 2, 1024)
    flat = _model_variables(jm, pc, 5)
    logits = jax.jit(lambda v, x: jm.apply(v, x, train=False))(
        _tree(flat), jnp.asarray(pc))
    return flat, pc, np.asarray(logits, np.float32)


def _tie_cloud():
    """4,096 points on 64 distinct positions, each repeated 64 times with
    its own payload: 4,032 repeated Morton codes."""
    rng = np.random.default_rng(11)
    pos = rng.uniform(-1, 1, (64, 3))
    xyz = np.repeat(pos, 64, axis=0)[rng.permutation(4096)]
    return np.concatenate([xyz, rng.normal(size=(4096, 2)),
                           np.arange(4096)[:, None]], 1)[None].astype(
        np.float32)


def test_morton_codes_and_sort_match_jax(rng):
    """Codes bit-exact (masked points 2**31 - 1, a degenerate axis, points
    on the box's faces) and the stable argsort equal."""
    pts = rng.uniform(-3, 5, (3, 500, 3)).astype(np.float32)
    pts[1, :, 2] = 0.25                          # a flat axis: scale 1e-9
    pts[2, :40] = pts[2, :40].round()            # repeated points
    mask = rng.uniform(size=(3, 500)) > 0.2
    for m in (None, mask):
        tm = None if m is None else torch.from_numpy(m)
        jm_ = None if m is None else jnp.asarray(m)
        codes = tmorton.morton_codes(torch.from_numpy(pts), tm)
        ref = jmorton.morton_codes(jnp.asarray(pts), jm_)
        assert codes.dtype == torch.int32
        np.testing.assert_array_equal(codes.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(
            tmorton.morton_sort(torch.from_numpy(pts), tm).numpy(),
            np.asarray(jmorton.morton_sort(jnp.asarray(pts), jm_)))
    assert (codes.numpy()[~mask] == 2**31 - 1).all()


@pytest.mark.parametrize("case", ["random", "ties"])
def test_morton_sort_packed_matches_jax(case):
    """The sorted cloud equals the reference's bit for bit, payload
    included: on the tie cloud equal codes keep index order, as the
    reference's one-key `lax.sort` does on the CPU."""
    pc = (_tie_cloud() if case == "ties"
          else _clouds(4, 2, 1024))
    if case == "ties":
        codes = tmorton.morton_codes(torch.from_numpy(pc[..., :3]))
        assert 4096 - torch.unique(codes).numel() == 4032
    got = tp.morton_sort_packed(torch.from_numpy(pc)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jp.morton_sort_packed(jnp.asarray(pc))))


@pytest.mark.parametrize("npoint,nsample", [(16, 4), (16, 3), (16, 8),
                                            (8, 40), (64, 32), (4, 16)])
def test_strided_windows_match_jax(rng, npoint, nsample):
    """window[i, o] = x[(i * stride + o) mod N] at N = 64: nsample below,
    at and above the stride (8 x 40: five blocks, past a power of two;
    64 x 32: stride 1), bit-exact against the reference."""
    x = rng.normal(size=(2, 64, 5)).astype(np.float32)
    got = tp.strided_windows(torch.from_numpy(x), npoint, nsample).numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.strided_windows(
        jnp.asarray(x), npoint, nsample)))
    stride = 64 // npoint
    want = x[:, (np.arange(npoint)[:, None] * stride
                 + np.arange(nsample)[None]) % 64]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("radius", [0.3, 0.02, None])
def test_window_set_abstraction_matches_jax(rng, radius):
    """A window SA level (two scales, nsample below and above the stride)
    in eval and train mode within 1e-4, output and running statistics;
    at radius 0.02 some windows hold no point within the radius and pool
    to 0, at None the max is unmasked."""
    pc = tp.morton_sort_packed(torch.from_numpy(_clouds(6, 2, 256))).numpy()
    xyz, feats = pc[..., :3], pc[..., 3:]
    radii, nsamples = [radius, radius], [2, 16]
    jm = jp.SetAbstraction(64, radii, nsamples, [[8, 16], [8, 12]],
                           grouping="window")
    args = (jnp.asarray(xyz), jnp.asarray(feats))
    flat = _fill(jax.eval_shape(lambda *a: jm.init(
        jax.random.PRNGKey(0), *a, train=False), *args), 3)
    tm = tp.SetAbstraction(64, radii, nsamples, [[8, 16], [8, 12]], 3,
                           torch.Generator(), grouping="window")
    convert.load_flax(tm, flat)
    targs = (torch.from_numpy(xyz), torch.from_numpy(feats))
    tm.eval()
    nx, nf = tm(*targs)
    rx, rf = jm.apply(_tree(flat), *args, train=False)
    np.testing.assert_allclose(nx.numpy(), np.asarray(rx), atol=1e-6)
    np.testing.assert_allclose(nf.detach().numpy(), np.asarray(rf),
                               rtol=1e-4, atol=1e-4)
    if radius == 0.02:
        assert (nf == 0).all(-1).any()
    (_, ref), upd = jm.apply(_tree(flat), *args, train=True, bn_momentum=0.3,
                             mutable=["batch_stats"])
    tm.train()
    np.testing.assert_allclose(tm(*targs, 0.3)[1].detach().numpy(),
                               np.asarray(ref), rtol=1e-4, atol=1e-4)
    sd = tm.state_dict()
    for k, v in flatten_dict(upd["batch_stats"], sep="/").items():
        key, _ = convert.torch_name("batch_stats/" + k)
        np.testing.assert_allclose(sd[key].numpy(), np.asarray(v), atol=1e-4)


def test_window_set_abstraction_needs_npoint_points():
    """N < npoint raises ValueError, as the reference does."""
    sa = tp.SetAbstraction(64, [0.2], [8], [[8]], 0, torch.Generator(),
                           grouping="window")
    with pytest.raises(ValueError, match="N >= npoint"):
        sa(torch.zeros(1, 32, 3), None)
    with pytest.raises(ValueError, match="N >= npoint"):
        jp.SetAbstraction(64, [0.2], [8], [[8]], grouping="window").init(
            jax.random.PRNGKey(0), jnp.zeros((1, 32, 3)), None, train=False)


@pytest.mark.parametrize("model", ["cls-ssg", "cls-msg"])
def test_window_logits_match_jax(model):
    """Eval logits of converted weights at window grouping (the
    classifier Morton-sorts its input) == JAX's within 1e-4."""
    flat, pc, ref = _jax_eval(model, "window", "float32")
    _, tcfg = _cfgs(model, "window")
    tm = convert.load_flax(T.build_model(tcfg, device="cpu"), flat)
    with torch.no_grad():
        out = tm(torch.from_numpy(pc))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("grouping", ["window", "ball"])
def test_bf16_logits_match_jax(grouping):
    """cls-ssg with compute_dtype bfloat16 (workload 6's classifier at
    window grouping) against JAX's bfloat16 logits, within the module
    docstring's 1e-2; float32 logits, float32 parameters."""
    flat, pc, ref = _jax_eval("cls-ssg", grouping, "bfloat16")
    _, tcfg = _cfgs("cls-ssg", grouping, "bfloat16")
    tm = convert.load_flax(T.build_model(tcfg, device="cpu"), flat)
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    with torch.no_grad():
        out = tm(torch.from_numpy(pc))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-2 * max(1.0, np.abs(ref).max()))
    _, f32 = _cfgs("cls-ssg", grouping)
    with torch.no_grad():
        full = convert.load_flax(T.build_model(f32, device="cpu"), flat)(
            torch.from_numpy(pc))
    assert not torch.equal(out, full)          # bf16 did run


@functools.lru_cache(maxsize=None)
def _jax_window_step():
    """One reference loss_fn + gradient of cls-ssg at window grouping,
    B 4 x 1,024, with an injected dropout keep-mask."""
    jcfg, _ = _cfgs("cls-ssg", "window")
    jm = JT.build_model(jcfg)
    pc = _clouds(7, 4, 1024)
    flat = _model_variables(jm, pc, 8)
    tree = _tree(flat)
    rng = np.random.default_rng(9)
    labels = rng.integers(0, CLASSES, 4)
    mask = rng.uniform(size=(4, 256)) < 0.5

    def masked_dropout(self, inputs, deterministic=None, rng=None):
        if self.deterministic if deterministic is None else deterministic:
            return inputs
        return jnp.where(jnp.asarray(mask), inputs / (1.0 - self.rate), 0.0)

    def loss_fn(params):
        out, mutated = jm.apply(
            {"params": params, "batch_stats": tree["batch_stats"]},
            jnp.asarray(pc), train=True, bn_momentum=0.5,
            rngs={"dropout": jax.random.PRNGKey(2)}, mutable=["batch_stats"])
        return JT.cross_entropy(out, jnp.asarray(labels)), \
            mutated["batch_stats"]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnn.Dropout, "__call__", masked_dropout)
        (loss, new_bs), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(tree["params"])
    return (flat, pc, labels, mask, float(loss),
            {"params/" + k: np.asarray(v)
             for k, v in flatten_dict(grads, sep="/").items()},
            {"batch_stats/" + k: np.asarray(v)
             for k, v in flatten_dict(new_bs, sep="/").items()})


def test_window_train_step_matches_jax_and_moves_stats_once():
    """One cls-ssg train step at window grouping: loss, every gradient
    and every BN's running statistics after the step == the reference's
    (whose `nn.remat` moves them once). The checkpointed scales recompute
    their forward in the backward pass; the statistics equal those of a
    forward alone, without gradients (no checkpoint, one move)."""
    flat, pc, labels, mask, loss, grads, new_bs = _jax_window_step()
    _, tcfg = _cfgs("cls-ssg", "window")
    model = convert.load_flax(T.build_model(tcfg, device="cpu"), flat)
    t_loss, _, t_grads = T.loss_and_grads(
        model, torch.from_numpy(pc), torch.from_numpy(labels), 0.5,
        dropout_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(float(t_loss), loss, rtol=1e-4, atol=0)
    by_name = dict(zip([n for n, _ in model.named_parameters()], t_grads))
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
    once = convert.load_flax(T.build_model(tcfg, device="cpu"), flat).train()
    with torch.no_grad():
        once(torch.from_numpy(pc), 0.5, dropout_mask=torch.from_numpy(mask))
    for key, v in once.state_dict().items():
        if key.endswith((".mean", ".var")):
            assert torch.equal(v, sd[key]), key


@pytest.mark.parametrize("stat_stride", [1, 4])
def test_folded_bn_matches_jax_and_unfolded(stat_stride):
    """The folded layer == the reference's in train mode (output and
    running statistics, from input moments; every 4th of the 256 rows at
    stat_stride 4) and eval mode (the running-statistics fold), within
    2e-4: at stat_stride 1 as `SharedMLP(fold_bn=True)` of two layers,
    also == the port's unfolded Dense + BN + ReLU; at 4 one
    `FoldedDenseBNRelu`."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 64, 24)) * 3.0 + 1.5).astype(np.float32)
    if stat_stride == 1:
        jm = jp.SharedMLP((32, 48), fold_bn=True)
        tm = tp.SharedMLP(24, (32, 48), torch.Generator(), fold_bn=True)
    else:
        jm = jp.FoldedDenseBNRelu(32, stat_stride=stat_stride)
        tm = tp.FoldedDenseBNRelu(24, 32, torch.Generator(),
                                  stat_stride=stat_stride)
    flat = _fill(jax.eval_shape(lambda a: jm.init(
        jax.random.PRNGKey(0), a, train=True), jnp.asarray(x)), 1)
    convert.load_flax(tm, flat)
    ref, upd = jm.apply(_tree(flat), jnp.asarray(x), train=True,
                        momentum=0.3, mutable=["batch_stats"]) \
        if stat_stride > 1 else jm.apply(
            _tree(flat), jnp.asarray(x), train=True, bn_momentum=0.3,
            mutable=["batch_stats"])
    tm.train()
    out = tm(torch.from_numpy(x), 0.3)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=2e-4, rtol=2e-4)
    sd = tm.state_dict()
    for k, v in flatten_dict(upd["batch_stats"], sep="/").items():
        key, _ = convert.torch_name("batch_stats/" + k)
        np.testing.assert_allclose(sd[key].numpy(), np.asarray(v),
                                   atol=2e-4, rtol=2e-3)
    tm.eval()
    ref_e = jm.apply({"params": _tree(flat)["params"],
                      "batch_stats": upd["batch_stats"]}, jnp.asarray(x),
                     train=False)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(ref_e), atol=2e-4, rtol=2e-3)
    if stat_stride == 1:
        assert convert.torch_name("params/FoldedDenseBNRelu_1/kernel") == (
            "folded.1.weight", True)
        plain = tp.SharedMLP(24, (32, 48), torch.Generator()).train()
        with torch.no_grad():
            for i, layer in enumerate(tm.folded):
                plain.dense[i].weight.copy_(layer.weight)
                plain.bn[i].scale.copy_(layer.scale)
                plain.bn[i].bias.copy_(layer.bias)
        np.testing.assert_allclose(plain(torch.from_numpy(x), 0.3).detach()
                                   .numpy(), out.detach().numpy(),
                                   atol=2e-4, rtol=2e-4)


def test_converter_names_window_scales():
    """flax's `CheckpointWindowScale_k` (nn.remat of WindowScale) is the
    port's `scales.k`; a window model converts with no leftover."""
    flat, *_ = _jax_eval("cls-ssg", "window", "float32")
    assert convert.torch_name("params/SetAbstraction_0/CheckpointWindowScale"
                              "_0/SharedMLP_0/Dense_0/kernel") == (
        "sa.0.scales.0.mlps.0.dense.0.weight", True)
    _, tcfg = _cfgs("cls-ssg", "window")
    assert len(T.build_model(tcfg, device="cpu").state_dict()) == len(flat)
