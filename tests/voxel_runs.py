"""Clouds for `voxel_run_means` (the centroids of `voxel_downsample`) and
its host reference, shared by the CPU tests and the card tests (numpy and
the port only; not a test).

`recorded_runs` runs `voxel_downsample` and keeps the inputs it handed
`voxel_run_means`; `in_order_means` sums each run of those inputs on the
host in float64, one row after another in ascending row order onto 0.0,
divides once by the run's length and rounds once to float32."""
import contextlib

import numpy as np
import torch

from pctpu_torch.ops import voxel

CASES = ("hdl64_leaf2", "hdl64_leaf0.5", "masked_middle_and_end",
         "single_point_voxels", "one_voxel", "n_not_a_multiple_of_256",
         "n_1")


def hdl64_scan(n_points: int, seed: int = 3) -> np.ndarray:
    """A synthetic HDL-64E scan (`portbench/common/generators.py`), the
    benchmark's clouds: points crowd near the sensor, so a 2 m voxel there
    holds thousands."""
    from portbench.common.generators import lidar_scan
    return lidar_scan(np.random.default_rng(seed), n_points)


def case_cloud(case: str, scan: np.ndarray):
    """(points [N,3] f32, mask [N] bool, leaf) of one of CASES; the two
    HDL-64E cases and the masked one take `scan`."""
    rng = np.random.default_rng(11)
    n = len(scan)
    if case == "hdl64_leaf2":
        return scan, np.ones(n, bool), 2.0
    if case == "hdl64_leaf0.5":
        return scan, np.ones(n, bool), 0.5
    if case == "masked_middle_and_end":
        mask = rng.uniform(size=n) > 0.2
        mask[n // 3: n // 3 + 500] = False
        mask[-700:] = False
        return scan, mask, 2.0
    if case == "single_point_voxels":
        g = np.stack(np.meshgrid(*[np.arange(12)] * 3, indexing="ij"),
                     -1).reshape(-1, 3)
        pts = (g[rng.permutation(len(g))] * 3.0 + rng.uniform(
            0.2, 0.8, (len(g), 3))).astype(np.float32)
        return pts, np.ones(len(pts), bool), 1.0
    if case == "one_voxel":
        pts = rng.uniform(10.0, 10.9, (5000, 3)).astype(np.float32)
        return pts, np.ones(len(pts), bool), 1.0
    if case == "n_not_a_multiple_of_256":
        pts = rng.uniform(-30, 30, (1000, 3)).astype(np.float32)
        return pts, rng.uniform(size=1000) > 0.1, 4.0
    if case == "n_1":
        return np.array([[1.5, -2.25, 0.125]], np.float32), \
            np.ones(1, bool), 2.0
    raise ValueError(case)


class _Recorder:
    """Stands in for `voxel_run_means` and keeps each call's inputs; the
    wrapper counts its launches on the name it is bound to, so
    `launches` passes through."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args):
        self.calls.append(args)
        return self.fn(*args)

    @property
    def launches(self):
        return self.fn.launches

    @launches.setter
    def launches(self, value):
        self.fn.launches = value


@contextlib.contextmanager
def _recording():
    rec = _Recorder(voxel.voxel_run_means)
    voxel.voxel_run_means = rec
    try:
        yield rec.calls
    finally:
        voxel.voxel_run_means = rec.fn


def recorded_runs(points, mask, leaf, device):
    """`voxel_downsample` of one cloud on `device` -> (its PointCloud, the
    inputs (ps, ms, new_run, s_v, nv) it gave `voxel_run_means`)."""
    with _recording() as calls:
        down = voxel.voxel_downsample(torch.from_numpy(points).to(device),
                                      torch.from_numpy(mask).to(device),
                                      leaf)
    assert len(calls) == 1
    return down, calls[0]


def in_order_means(ps, ms, new_run, s_v, nv) -> np.ndarray:
    """Host reference of `voxel_run_means` for its rows below nv: [nv,3]
    f32. Voxel v's run: the rows from s_v[v] on up to the first row that
    is masked out or starts a run, or the end."""
    ps, ms, new_run, s_v = (x.cpu().numpy() for x in (ps, ms, new_run, s_v))
    nv = int(nv)
    starts = s_v[:nv]
    stops = np.append(np.flatnonzero(~ms | new_run), len(ms))
    ends = stops[np.searchsorted(stops, starts, side="right")]
    lens = ends - starts
    order = np.argsort(-lens, kind="stable")   # the live runs a prefix
    st, ln = starts[order], lens[order]
    p64 = ps.astype(np.float64)
    acc = np.zeros((nv, 3))
    for k in range(int(ln.max()) if nv else 0):
        m = int(np.searchsorted(-ln, -k, side="left"))   # runs longer than k
        acc[:m] = acc[:m] + p64[st[:m] + k]
    out = np.empty((nv, 3), np.float32)
    out[order] = (acc / np.maximum(ln, 1)[:, None]).astype(np.float32)
    return out


def within_one_ulp(got: np.ndarray, want: np.ndarray) -> bool:
    """Every entry of got within one float32 ulp of want's."""
    return bool(np.all((got >= np.nextafter(want, -np.inf))
                       & (got <= np.nextafter(want, np.inf))))


def plain_gap_ok(got: np.ndarray, want: np.ndarray, ps, ms) -> bool:
    """The plain version's centroids `got` [nv,3] against the in-order
    ones `want`: within one float32 ulp of want, plus the float64 ulp of
    the column's sum of |x| over the valid rows. A float64 prefix carries
    a rounding of up to half that ulp at each row, so a run's difference
    of two prefixes carries up to its length times that, and its mean up
    to the ulp itself: more than a float32 ulp for coordinates near 0."""
    ps64 = ps.cpu().numpy()[ms.cpu().numpy()].astype(np.float64)
    atol = np.spacing(np.abs(ps64).sum(0))
    tol = np.spacing(np.abs(want)).astype(np.float64) + atol
    return bool(np.all(np.abs(got.astype(np.float64) - want) <= tol))
