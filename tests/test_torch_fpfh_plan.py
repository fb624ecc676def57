"""How K2 (`spfh`) and K3 (`wsum`) of `csrc/fpfh.cu` shape a launch:
`fpfh_plan` in `pctpu_torch/features/pallas_fpfh.py`, which the kernels'
C entries check and follow. It runs here without a card; the kernels
themselves are held against their plain versions at every shape the plan
takes in tests/test_torch_cuda.py."""
import re
from pathlib import Path

import pytest

from pctpu_torch.features import pallas_fpfh as pf

H100_SMS = 132
CSRC = Path(pf.__file__).resolve().parents[1] / "csrc" / "fpfh.cu"

# chip_smoke.py's launches: (B, Np) -> ((K2 threads, queries a warp),
# (K3 threads, queries a warp))
PATH_SHAPES = {
    (16, 2048): ((256, 4), (1024, 4)),    # P1 register_pairs
    (15, 2048): ((256, 4), (1024, 4)),    # P13's round-0 closures
    (8, 2048): ((256, 2), (1024, 2)),     # P15, batches of 8
    (32, 2048): ((256, 4), (1024, 4)),    # the kernel-9 phase
    (2, 1024): ((256, 1), (256, 1)),      # the card test's unbanded shape
    (1, 2048): ((256, 1), (256, 1)),      # one pair
}
# every launch shape the card tests run: threads x queries a warp
SHAPES = [(t, wq) for t in (32, 64, 128, 256, 512, 1024) for wq in (1, 2, 4)]


def _cta_rows(p, cta):
    """The rows (of one cloud) CTA `cta` of a launch of shape `p` takes,
    as the kernels map them: the CTAs go through each 256-query tile in
    parts of cta_queries; warp w of a CTA takes warp_queries consecutive
    rows from r0 + w * warp_queries."""
    per_tile = pf.FPFH_Q_TILE // p["cta_queries"]
    tile, part = divmod(cta, per_tile)
    r0 = tile * pf.FPFH_Q_TILE + part * p["cta_queries"]
    return [r0 + w * p["warp_queries"] + s for w in range(p["threads"] // 32)
            for s in range(p["warp_queries"])]


def _constant(name):
    m = re.search(rf"constexpr int {name} = (\d+);", CSRC.read_text())
    assert m, name
    return int(m.group(1))


def test_plan_constants_follow_the_source():
    """The shared memory the plan counts is the kernels' own."""
    assert pf.FPFH_RING == _constant("kRing")
    assert pf.FPFH_QUERY_RING == _constant("kQRing")
    assert pf.FPFH_Q_TILE == _constant("kQT")
    assert pf.FPFH_TABLE_BYTES == (3 * _constant("kChunkSteps") + 4) * 4
    assert "__launch_bounds__(1024)" in CSRC.read_text()
    assert pf.FPFH_MAX_THREADS == 1024


@pytest.mark.parametrize("shape", list(PATH_SHAPES))
def test_plan_at_the_paths_shapes(shape):
    b, np_ = shape
    plan = pf.fpfh_plan(b, np_, H100_SMS)
    got = tuple((plan[k]["threads"], plan[k]["warp_queries"])
                for k in ("spfh", "wsum"))
    assert got == PATH_SHAPES[shape]
    for k in ("spfh", "wsum"):
        p = plan[k]
        assert p["threads"] % 32 == 0 and 32 <= p["threads"] <= 1024
        assert p["cta_queries"] == p["threads"] // 32 * p["warp_queries"]
        assert pf.FPFH_Q_TILE % p["cta_queries"] == 0
        assert p["ctas"] * p["cta_queries"] == b * np_
        assert p["smem_bytes"] <= pf.SMEM_BLOCK == 232448
    # K3's CTAs leave one for each SM where the batch allows it
    assert plan["wsum"]["ctas"] >= H100_SMS or plan["wsum"]["threads"] == 256


@pytest.mark.parametrize("shape", list(PATH_SHAPES))
@pytest.mark.parametrize("kernel", ["spfh", "wsum"])
def test_every_query_falls_in_exactly_one_cta(shape, kernel):
    """Each row of a cloud is one query of one CTA, at the default shape
    and at every shape the card tests force."""
    b, np_ = shape
    plans = [pf.fpfh_plan(b, np_, H100_SMS)]
    plans += [pf.fpfh_plan(b, np_, H100_SMS, threads=t, warp_queries=wq)
              for t, wq in SHAPES]
    for plan in plans:
        assert plan is not None
        p = plan[kernel]
        per_cloud = np_ // p["cta_queries"]
        rows = []
        for cta in range(per_cloud):
            got = _cta_rows(p, cta)
            assert len(got) == p["cta_queries"]           # no idle warp
            tile = {r // pf.FPFH_Q_TILE for r in got}
            assert len(tile) == 1                          # one query tile
            rows.extend(got)
        assert sorted(rows) == list(range(np_))


@pytest.mark.parametrize("threads,warp_queries",
                         [(48, 1), (0, 1), (2048, 1), (256, 3), (1056, 1)])
def test_plan_refuses_shapes_the_kernels_do_not_take(threads, warp_queries):
    assert pf.fpfh_plan(16, 2048, H100_SMS, threads=threads,
                        warp_queries=warp_queries) is None


def test_k3_stages_a_step_of_rows_a_warp():
    """K3's shared memory: the table, 64 ring entries of 8 bytes a query,
    and a step (32 columns) a warp of SPFH rows (33 floats) and test
    columns (5 floats); the widest CTA still fits a block."""
    p = pf.fpfh_plan(16, 2048, H100_SMS, threads=1024, warp_queries=4)
    w = p["wsum"]
    assert w["smem_bytes"] == (pf.FPFH_TABLE_BYTES + 128 * 64 * 8
                               + 32 * 32 * (33 + 5) * 4)
    assert w["smem_bytes"] <= pf.SMEM_BLOCK
