"""`voxel_downsample`'s centroids on the CPU: the plain version of
`voxel_run_means` (float64 cumsum differences at each run's ends) against
a host float64 sum of each run in row order, rounded once
(`tests/voxel_runs.py`). The prefix differences cancel against sums of up
to ~1e7 m, so they may land one float32 ulp from the in-order sum, and
near 0 up to the float64 ulp of that sum (`plain_gap_ok`); the voxel set
and every row past it are held exactly. Kernel V is held to the
same sums bit for bit on the card (`tests/test_torch_cuda.py`)."""
import torch_threads as _torch_threads  # noqa: F401

import numpy as np
import pytest
import torch

from voxel_runs import (CASES, case_cloud, hdl64_scan, in_order_means,
                        plain_gap_ok, recorded_runs)


@pytest.fixture(scope="module")
def scan():
    return hdl64_scan(30_000)


@pytest.mark.parametrize("case", CASES)
def test_plain_run_means_match_in_order_sums(scan, case):
    pts, mask, leaf = case_cloud(case, scan)
    down, args = recorded_runs(pts, mask, leaf, "cpu")
    ps, ms, new_run, s_v, nv = args
    nv = int(nv)
    assert nv == int(down.mask.sum()) and bool(down.mask[:nv].all())
    want = in_order_means(*args)
    got = down.points[:nv].numpy()
    assert plain_gap_ok(got, want, ps, ms), np.abs(got - want).max()
    # padding rows repeat voxel 0
    assert torch.equal(down.points[nv:],
                       down.points[:1].expand(len(pts) - nv, 3))
    if case == "single_point_voxels":
        assert nv == len(pts)
        np.testing.assert_array_equal(np.sort(got, 0), np.sort(pts, 0))
    if case == "one_voxel":
        assert nv == 1
    if case == "n_1":
        np.testing.assert_array_equal(got, pts)


def test_plain_run_means_of_a_masked_out_cloud_are_zero():
    pts = np.random.default_rng(2).uniform(-5, 5, (300, 3)).astype(np.float32)
    down, args = recorded_runs(pts, np.zeros(300, bool), 1.0, "cpu")
    assert int(args[4]) == 0 and not bool(down.mask.any())
    assert torch.equal(down.points, torch.zeros(300, 3))
