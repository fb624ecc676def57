"""How the whole-loop ICP kernel (K4, kernel 5: `csrc/icp_mega.cu`)
spreads a launch over the card: `unit_plan` and `unit_queries` in
`pctpu_torch/ops/pallas_icp_mega.py`, which mirror the kernel's unit and
thread arithmetic. They run here without a card; the kernel itself is held
against its plain version in tests/test_torch_cuda.py."""
import pytest

from pctpu_torch.ops.pallas_icp_mega import (MAX_LANES, QUERIES_PER_THREAD,
                                             THREADS, UNITS_PER_SM,
                                             unit_plan, unit_queries)

H100_SMS, H100_CTAS = 132, 528      # 132 SMs, 4 CTAs of the kernel each

# (pairs, queries per pair, query tile): workload 1 (P2), workload 4 (P3),
# register_pairs' voxel stage and exact refine (P1), workload 2 (P4), a
# small test shape, and tiles that are not powers of two
SHAPES = [(1, 16384, 1024), (1, 131072, 1024), (16, 2048, 2048),
          (16, 2048, 512), (16, 4096, 512), (3, 1024, 128), (1, 700, 7),
          (2, 1536, 768), (5, 96, 96)]


@pytest.mark.parametrize("bsz,mp,tq", SHAPES)
def test_every_query_falls_in_exactly_one_unit(bsz, mp, tq):
    plan = unit_plan(bsz, mp, tq, H100_SMS, H100_CTAS)
    cols = [q for u in range(plan["units_per_pair"])
            for q in unit_queries(plan, tq, u)]
    assert sorted(cols) == list(range(mp))
    assert plan["units"] == bsz * plan["units_per_pair"]
    assert plan["grid"] == min(plan["units"], H100_CTAS)


@pytest.mark.parametrize("bsz,mp,tq", SHAPES)
def test_plan_holds_no_dead_query_slot_where_the_tile_allows(bsz, mp, tq):
    """A unit's slice divides a tile that has a power-of-two part of at
    least 16 (THREADS * QUERIES_PER_THREAD / MAX_LANES); then every
    thread's query slots are live."""
    plan = unit_plan(bsz, mp, tq, H100_SMS, H100_CTAS)
    assert plan["slice"] * plan["lanes"] == THREADS * QUERIES_PER_THREAD
    assert 1 <= plan["lanes"] <= MAX_LANES
    assert plan["lanes"] & (plan["lanes"] - 1) == 0
    floor = THREADS * QUERIES_PER_THREAD // MAX_LANES
    if tq % floor == 0:
        assert tq % plan["slice"] == 0
        for u in range(plan["units_per_pair"]):
            assert len(unit_queries(plan, tq, u)) == plan["slice"]


@pytest.mark.parametrize("bsz,mp,tq", SHAPES[:5])
def test_main_path_launches_fill_the_card(bsz, mp, tq):
    """Workloads 1, 4 and 2 and register_pairs' two launches: at least
    UNITS_PER_SM units per SM, so at least one CTA per SM works."""
    plan = unit_plan(bsz, mp, tq, H100_SMS, H100_CTAS)
    assert plan["units"] >= UNITS_PER_SM * H100_SMS
    assert plan["grid"] >= H100_SMS


def test_plan_stops_at_max_lanes_on_a_small_launch():
    plan = unit_plan(1, 512, 512, H100_SMS, H100_CTAS)
    assert plan["lanes"] == MAX_LANES and plan["units"] == 32
