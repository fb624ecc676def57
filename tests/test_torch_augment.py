"""The port's augmentations against the JAX package, on the CPU: each
transform's `apply_<name>` given the random numbers the reference's
transform draws (fed to the reference by replacing its `jax.random` draw
for the call) == the reference transform, within 1e-6; `angle_axis`,
`pc_normalize` and the default pipeline likewise. Inputs come from numpy
with a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.nn import augment as jaug
from pctpu_torch.nn import augment as aug

B, N = 3, 200


def _pc(rng, c=6):
    return rng.normal(scale=0.5, size=(B, N, c)).astype(np.float32)


def _feed(monkeypatch, values):
    """Make the reference's `jax.random.uniform` / `normal` return the
    given arrays, in call order."""
    queue = [jnp.asarray(v) for v in values]

    def draw(key, shape=(), *args, **kw):
        v = queue.pop(0)
        assert v.shape == tuple(shape), (v.shape, shape)
        return v
    monkeypatch.setattr(jax.random, "uniform", draw)
    monkeypatch.setattr(jax.random, "normal", draw)


@pytest.mark.parametrize("name", ["scale", "rotate_y", "rotate_perturbation",
                                  "jitter", "translate", "random_dropout"])
@pytest.mark.parametrize("channels", [6, 3, 9])
def test_apply_matches_jax(rng, monkeypatch, name, channels):
    """apply_<name>(pc, draws) over a batch == the reference transform of
    each cloud given the same draws, within 1e-6 (6 channels rotate the
    normals too; 3 and 9 channels as the reference treats them)."""
    pc = _pc(rng, channels)
    draw, apply = aug.TRANSFORMS[name]
    params = draw(torch.Generator().manual_seed(4), B, N, "cpu")
    ours = apply(torch.from_numpy(pc), params).numpy()
    parts = params if isinstance(params, tuple) else (params,)
    key = jax.random.PRNGKey(0)
    fn = getattr(jaug, name)
    for i in range(B):
        _feed(monkeypatch, [p[i].numpy() for p in parts])
        ref = fn(key, jnp.asarray(pc[i]))
        monkeypatch.undo()
        np.testing.assert_allclose(ours[i], np.asarray(ref), rtol=1e-6,
                                   atol=1e-6, err_msg=f"{name} cloud {i}")


def test_draws_are_per_cloud_and_from_the_generator(rng):
    """The draws have the reference's ranges, differ between clouds of a
    batch, and repeat exactly from a generator seeded alike."""
    g = torch.Generator().manual_seed(1)
    s = aug.draw_scale(g, 1000, N, "cpu")
    assert float(s.min()) >= 0.8 and float(s.max()) < 1.25
    t = aug.draw_translate(g, 1000, N, "cpu")
    assert float(t.min()) >= -0.1 and float(t.max()) < 0.1
    pc = torch.from_numpy(_pc(rng))
    a = aug.augment_batch(torch.Generator().manual_seed(7), pc)
    b = aug.augment_batch(torch.Generator().manual_seed(7), pc)
    assert torch.equal(a, b) and not torch.equal(a[0], a[1])
    one = aug.augment(torch.Generator().manual_seed(7), pc[0])
    assert one.shape == pc[0].shape
    assert aug.DEFAULT_TRAIN_PIPELINE == jaug.DEFAULT_TRAIN_PIPELINE
    assert aug.augment_batch(g, pc, ()) is pc


def test_angle_axis_and_pc_normalize_match_jax(rng):
    angles = rng.uniform(-4, 4, 5).astype(np.float32)
    axis = rng.normal(size=3)
    ours = aug.angle_axis(torch.from_numpy(angles), axis)
    for i, a in enumerate(angles):
        np.testing.assert_allclose(ours[i].numpy(),
                                   np.asarray(jaug.angle_axis(a, axis)),
                                   atol=1e-6)
    pc = _pc(rng) + 2.0
    np.testing.assert_allclose(aug.pc_normalize(torch.from_numpy(pc)).numpy(),
                               np.asarray(jaug.pc_normalize(jnp.asarray(pc))),
                               atol=1e-6)
