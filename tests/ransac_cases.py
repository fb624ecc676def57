"""Inputs of RANSAC's select-and-refine step (`ransac_refine`), numpy only,
shared by the CPU parity tests (`test_torch_register.py`) and the card's
tests (`test_torch_cuda.py`). Not a test module.

Each case gives every pair of the batch its own draw of one geometry:
- "random": a box of points (20 x 20 x 6 m) moved by a rigid transform,
  2 cm of noise, 30% outliers; each hypothesis row a random share of the
  true inliers and a few outliers;
- "zero": no hypothesis has an inlier (H = 0, `wsum`'s clamp);
- "collinear": points on the x axis moved to the y axis by a 90 deg turn
  and a whole-metre shift, on quarter-metre coordinates, so H is exactly
  rank 1 and H^T H exactly diagonal (the fallback's identity branch; a
  rank-1 H in general position determines no rotation, and its result is
  decided by float32 noise);
- "coplanar": points on the plane z = 0 (20 x 10 m), so H has an exact
  zero column (the fallback's rank-2 branch);
- "reflection": a box of 20 x 8 x 2 m mirrored, so det H < 0 with well
  separated singular values (the Newton path's flip);
- "ties": as "random", with the maximum score taken by three rows, the
  first of them past row 0.
At M = 3 a row holds no inlier or all three: two points would make a
rank-1 H in general position."""
import numpy as np
from scipy.spatial.transform import Rotation

CASES = ("random", "zero", "collinear", "coplanar", "reflection", "ties")
DIST = 0.5


def _pair(rng, h, m, case):
    R = Rotation.from_rotvec(rng.normal(scale=0.5, size=3)).as_matrix()
    t = rng.normal(scale=3.0, size=3)
    true = np.ones(m, bool)
    if case == "collinear":
        x = rng.integers(-80, 81, m) / 4.0
        src = np.stack([x, 0 * x, 0 * x], -1)
        dst = np.stack([0 * x + 3.0, x - 2.0, 0 * x + 1.0], -1)
    else:
        ext = {"coplanar": (20, 10, 0), "reflection": (20, 8, 2)}.get(
            case, (20, 20, 6))
        src = rng.uniform(-1, 1, (m, 3)) * ext
        if m == 3:     # a well-shaped triangle
            src = np.array([[-10, -6, 0], [10, -4, 0], [1, 9, 0]]) \
                + rng.normal(scale=0.5, size=(3, 3)) * [1, 1, case != "coplanar"]
        M = R @ np.diag([1, 1, -1]) if case == "reflection" else R
        dst = src @ M.T + t + rng.normal(scale=0.02, size=(m, 3))
        if case in ("random", "ties") and m > 3:
            true = rng.uniform(size=m) > 0.3
            dst[~true] = rng.uniform(-40, 40, (int((~true).sum()), 3))
    valid = rng.uniform(size=m) > 0.15 if m > 3 else np.ones(m, bool)
    if m == 3:
        inl = np.repeat(rng.uniform(size=(h, 1)) > 0.3, 3, axis=1)
    else:
        keep = rng.uniform(0.3, 1.0, (h, 1))
        inl = (rng.uniform(size=(h, m)) < keep) & true
        inl |= (rng.uniform(size=(h, m)) < 0.02) & ~true
        inl &= valid
    if case == "zero":
        inl[:] = False
    scores = inl.sum(-1).astype(np.int32) * (rng.uniform(size=h) > 0.1)
    if case == "ties" and h > 1:
        rows = np.sort(rng.choice(np.arange(1, h), size=min(3, h - 1),
                                  replace=False))
        scores[rows] = scores.max() + 1
    return (scores.astype(np.int32), inl, src.astype(np.float32),
            dst.astype(np.float32), valid)


def refine_inputs(rng, b, h, m, case):
    """(scores [B,H] int32, inl [B,H,M] bool, src, dst [B,M,3] f32, valid
    [B,M] bool, n_valid [B] f32, thresh2) for `ransac_refine`, at
    dist_thresh `DIST`."""
    if case not in CASES:
        raise ValueError(case)
    parts = [_pair(rng, h, m, case) for _ in range(b)]
    scores, inl, src, dst, valid = (np.stack(x) for x in zip(*parts))
    n_valid = np.maximum(valid.sum(1), 1).astype(np.float32)
    thresh2 = float(np.float32(DIST)) ** 2
    return scores, inl, src, dst, valid, n_valid, thresh2


def unsure_rows(Ts, src, dst, dist=DIST, margin=1e-4):
    """[B,M] rows whose residual under any of the poses Ts ([B,4,4] numpy
    each) lies within `margin` (m) of dist, in float64: the rows where two
    poses within the tests' tolerances may fairly disagree on the mask."""
    out = np.zeros(src.shape[:2], bool)
    for T in Ts:
        T = np.asarray(T, np.float64)
        r = np.linalg.norm(np.einsum("bij,bmj->bmi", T[:, :3, :3], src)
                           + T[:, None, :3, 3] - dst, axis=-1)
        out |= np.abs(r - dist) <= margin
    return out
