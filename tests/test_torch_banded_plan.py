"""How K8 (`icp_moments_banded_v2`, `csrc/banded.cu`) spreads a launch
over the card: `moments_v2_plan` and `unit_queries` in
`pctpu_torch/ops/pallas_banded.py`, which mirror the kernel's unit and
thread arithmetic. They run here without a card; the kernel itself is
held against its plain version in tests/test_torch_cuda.py."""
import torch_threads as _torch_threads  # noqa: F401

import pytest

from pctpu_torch.ops.pallas_banded import (MOMENTS_MAX_LANES,
                                           MOMENTS_QPT, MOMENTS_THREADS,
                                           MOMENTS_UNITS_PER_SM,
                                           moments_v2_plan,
                                           unit_queries)

H100_SMS = 132

# (queries Mp, query tile): P5 (workload 1's pair, chip_smoke.py BANDED),
# the card tests' shapes (the v2 kernel test, the banded loops), P5 with
# workload 1's tile, and tiles that a unit's slice does not divide
SHAPES = [(16384, 512), (1024, 128), (3072, 256), (16384, 1024),
          (3000, 100), (700, 7), (1536, 768), (96, 96)]


@pytest.mark.parametrize("mp,tq", SHAPES)
def test_every_query_falls_in_exactly_one_unit(mp, tq):
    plan = moments_v2_plan(mp, tq, H100_SMS)
    cols = [q for u in range(plan["units"])
            for q in unit_queries(plan, tq, u)]
    assert sorted(cols) == list(range(mp))
    assert plan["units"] == plan["tiles"] * plan["slices"]
    assert plan["slice"] * plan["lanes"] == MOMENTS_THREADS * MOMENTS_QPT


@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
@pytest.mark.parametrize("mp,tq", [(16384, 512), (1536, 384)])
def test_every_lane_count_covers_every_query(lanes, mp, tq):
    """The lanes tools/fps_k8_sweep.py (P5) and the card tests (tiles of
    384) launch."""
    plan = moments_v2_plan(mp, tq, H100_SMS, lanes=lanes)
    assert plan["lanes"] == lanes
    cols = [q for u in range(plan["units"])
            for q in unit_queries(plan, tq, u)]
    assert sorted(cols) == list(range(mp))


def test_p5_fills_the_card():
    """P5's launch: at least MOMENTS_UNITS_PER_SM units per SM, every
    unit's query slots live (the slice divides the tile)."""
    plan = moments_v2_plan(16384, 512, H100_SMS)
    assert plan["units"] >= MOMENTS_UNITS_PER_SM * H100_SMS
    assert 512 % plan["slice"] == 0
    assert (plan["lanes"], plan["slices"], plan["units"]) == (32, 16, 512)


@pytest.mark.parametrize("mp,tq", SHAPES)
def test_slice_divides_the_tile_where_it_can(mp, tq):
    """Lanes are first raised until a unit's slice divides the tile, for
    a tile with a power-of-two part of at least the smallest slice."""
    plan = moments_v2_plan(mp, tq, H100_SMS)
    floor = MOMENTS_THREADS * MOMENTS_QPT // MOMENTS_MAX_LANES
    if tq % floor == 0:
        assert tq % plan["slice"] == 0
        for u in range(plan["units"]):
            assert len(unit_queries(plan, tq, u)) == plan["slice"]
    else:   # the uneven tile: only each tile's last unit is short
        sizes = [len(unit_queries(plan, tq, u))
                 for u in range(plan["slices"])]
        assert sizes[:-1] == [plan["slice"]] * (plan["slices"] - 1)
        assert 0 < sizes[-1] < plan["slice"]


def test_small_launch_stops_at_max_lanes():
    plan = moments_v2_plan(1024, 128, H100_SMS)
    assert plan["lanes"] == MOMENTS_MAX_LANES


@pytest.mark.parametrize("lanes", [0, 3, 6, 64])
def test_lanes_the_kernel_does_not_take(lanes):
    assert moments_v2_plan(16384, 512, H100_SMS, lanes=lanes) is None
