"""Furthest-point sampling against the JAX package, on the CPU: the port's
`fps`, `fps_batched` and kernel 10/11's plain version (`fps_pallas`,
`fps_pallas_batched` on CPU tensors) against JAX `fps`, `fps_batched` and
the Pallas kernels in interpret mode. The picks must be equal exactly:
one differently rounded distance moves a pick and every pick after it.
Inputs come from numpy with a seed."""
import torch_threads as _torch_threads  # noqa: F401

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops.fps import fps as j_fps
from pctpu.ops.fps import fps_batched as j_fps_batched
from pctpu.ops.pallas_fps import fps_pallas as j_fps_pallas
from pctpu.ops.pallas_fps import fps_pallas_batched as j_fps_pallas_batched
from pctpu_torch.ops import pallas_fps
from pctpu_torch.ops.fps import fps, fps_batched


def _cloud(rng, n, case):
    """(points [N,3] f32, mask [N] bool or None, skip_near_origin)."""
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    mask, skip = None, False
    if case == "mask":
        mask = rng.random(n) > 0.15
    elif case == "near_origin":
        pts[rng.choice(n, n // 8, replace=False)] *= 0.01
        skip = True
    elif case == "ties":       # every point twice, and a symmetric grid
        pts[n // 2:] = pts[:n // 2]
        pts[:64] = np.stack(np.meshgrid(*[[-0.5, 0.5]] * 3), -1).reshape(
            -1, 3).repeat(8, axis=0)
    elif case == "few_eligible":    # fewer eligible points than m
        mask = np.zeros(n, bool)
        mask[rng.choice(n, 40, replace=False)] = True
    return pts, mask, skip


CASES = ["plain", "mask", "near_origin", "ties", "few_eligible"]


@pytest.mark.parametrize("n,m", [(512, 64), (1024, 256)])
@pytest.mark.parametrize("case", CASES)
def test_fps_matches_jax(rng, n, m, case):
    """One cloud: the port's `fps` and `fps_pallas` (plain version) ==
    JAX `fps` == JAX `fps_pallas(interpret=True)`, exactly."""
    pts, mask, skip = _cloud(rng, n, case)
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref = np.asarray(j_fps(jnp.asarray(pts), m, mask=jm,
                           skip_near_origin=skip))
    ref_k = np.asarray(j_fps_pallas(jnp.asarray(pts), m, mask=jm,
                                    skip_near_origin=skip, interpret=True))
    np.testing.assert_array_equal(ref, ref_k)
    ours = fps(torch.from_numpy(pts), m, mask=tm, skip_near_origin=skip)
    ours_k = pallas_fps.fps_pallas(torch.from_numpy(pts), m, mask=tm,
                                   skip_near_origin=skip)
    assert ours.dtype == torch.int32 and ours.shape == (m,)
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours_k.numpy(), ref)
    if case == "few_eligible":
        assert set(ref[1:].tolist()) <= set(np.flatnonzero(mask).tolist())


@pytest.mark.parametrize("case", ["plain", "mask", "ties"])
def test_fps_batched_matches_jax(rng, case):
    """A batch of 3 clouds: the port's `fps_batched` and
    `fps_pallas_batched` (plain version) == JAX `fps_batched` (the vmapped
    loop) == JAX `fps_pallas_batched(interpret=True)`, exactly."""
    clouds = [_cloud(rng, 512, case) for _ in range(3)]
    pts = np.stack([c[0] for c in clouds])
    mask = None if clouds[0][1] is None else np.stack([c[1]
                                                       for c in clouds])
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)
    ref = np.asarray(j_fps_batched(jnp.asarray(pts), 128, mask=jm))
    ref_k = np.asarray(j_fps_pallas_batched(jnp.asarray(pts), 128, mask=jm,
                                            interpret=True))
    np.testing.assert_array_equal(ref, ref_k)
    for fn in (fps_batched, pallas_fps.fps_pallas_batched):
        np.testing.assert_array_equal(
            fn(torch.from_numpy(pts), 128, mask=tm).numpy(), ref)


def test_fps_cpu_tensors_launch_nothing(rng):
    """On CPU tensors the wrappers run the plain version and count no
    launch; bad shapes raise."""
    before = (pallas_fps.fps_pallas.launches,
              pallas_fps.fps_pallas_batched.launches)
    pts = torch.from_numpy(rng.uniform(-1, 1, (2, 100, 3)).astype(np.float32))
    pallas_fps.fps_pallas_batched(pts, 10)
    pallas_fps.fps_pallas(pts[0], 10)
    assert (pallas_fps.fps_pallas.launches,
            pallas_fps.fps_pallas_batched.launches) == before
    with pytest.raises(ValueError):
        pallas_fps.fps_pallas_batched(pts[0], 10)
    with pytest.raises(ValueError):
        pallas_fps.fps_pallas(pts, 10)
