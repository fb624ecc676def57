"""How K6 (`nearest_banded`, `csrc/banded.cu`) spreads a launch and
combines its lanes, without a card: `nearest_banded_plan` and
`unit_queries` mirror the kernel's unit and thread arithmetic, and
`_lanes_rule` below is the kernel's scan written out in torch (each of a
query's `lanes` lanes scans every lanes-th window column with a strict
'<', then the lanes take the lexicographic (d2, column) minimum in the
kernel's xor order). That rule must equal `nearest_banded_plain` exactly,
and the JAX package's Pallas kernel (interpret mode) on a tie-heavy
input. The kernel itself is held against the plain version on the card
in tests/test_torch_cuda.py."""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.ops import pallas_banded as jb
from pctpu_torch.ops import pallas_banded as tb

H100_SMS = 132
LANES = [1, 2, 4, 8, 16, 32]
CSRC = Path(tb.__file__).resolve().parents[1] / "csrc" / "banded.cu"
# (queries Mp, query tile): P5 (chip_smoke.py BANDED), the card tests'
# shapes, and tiles a unit's slice does not divide
SHAPES = [(16384, 512), (1024, 128), (3072, 256), (512, 64), (3000, 100),
          (700, 7), (96, 96)]


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("mp,tq", SHAPES)
def test_every_query_falls_in_exactly_one_unit(mp, tq, lanes):
    plan = tb.nearest_banded_plan(mp, tq, H100_SMS, lanes=lanes)
    assert plan["lanes"] == lanes and plan["qpt"] == tb.NEAREST_QPT
    cols = [q for u in range(plan["units"])
            for q in tb.unit_queries(plan, tq, u)]
    assert sorted(cols) == list(range(mp))
    assert plan["units"] == plan["tiles"] * plan["slices"]
    assert plan["slice"] * lanes == tb.MOMENTS_THREADS * tb.NEAREST_QPT


@pytest.mark.parametrize("mp,tq", SHAPES)
def test_default_plan_covers_every_query(mp, tq):
    plan = tb.nearest_banded_plan(mp, tq, H100_SMS)
    cols = [q for u in range(plan["units"])
            for q in tb.unit_queries(plan, tq, u)]
    assert sorted(cols) == list(range(mp))


def test_p5_fills_the_card_in_one_wave():
    """P5's launch: at least MOMENTS_UNITS_PER_SM units per SM, no more
    than the 4 a SM keeps resident (one wave), every query slot live."""
    plan = tb.nearest_banded_plan(16384, 512, H100_SMS)
    assert plan["units"] >= tb.MOMENTS_UNITS_PER_SM * H100_SMS
    assert plan["units"] <= 4 * H100_SMS
    assert 512 % plan["slice"] == 0
    assert (plan["lanes"], plan["slices"], plan["units"]) == (32, 16, 512)


def test_plan_constants_follow_the_source():
    """The plan's CTA shape is the kernel's: 256 threads, NEAREST_QPT
    queries a thread, 4 units an SM resident."""
    src = CSRC.read_text()
    assert re.search(rf"constexpr int kNnQpt = {tb.NEAREST_QPT};", src)
    assert re.search(rf"constexpr int kMomThreads = {tb.MOMENTS_THREADS};",
                     src)
    assert re.search(r"__launch_bounds__\(kMomThreads, 4\)\s*\n"
                     r"banded_nn_kernel", src)


@pytest.mark.parametrize("lanes", [0, 3, 6, 64, -1])
def test_lanes_the_kernel_does_not_take(lanes):
    assert tb.nearest_banded_plan(16384, 512, H100_SMS, lanes=lanes) is None


def _lanes_rule(q, dbt, pen, offsets, block, wb, query_tile, lanes):
    """The kernel's scan and combine, in torch (see the module note)."""
    tq, w = query_tile, wb * block
    d2_out = torch.empty(q.shape[0], dtype=torch.float32)
    idx_out = torch.empty(q.shape[0], dtype=torch.int32)
    pad = -w % lanes                  # a lane past the window's end: no column
    for t in range(q.shape[0] // tq):
        g0 = int(offsets[t]) * block
        qt = q[t * tq:(t + 1) * tq]
        x, y, z = (dbt[k, g0:g0 + w] for k in range(3))
        dx, dy, dz = (qt[:, k:k + 1] - c[None] for k, c in enumerate((x, y,
                                                                      z)))
        d2 = ((dx * dx + dy * dy) + dz * dz) + pen[None, g0:g0 + w]
        d2 = torch.nn.functional.pad(d2, (0, pad), value=float("nan"))
        d2 = d2.reshape(tq, -1, lanes)               # column k * lanes + l
        best = torch.full((tq, lanes), tb.BIG, dtype=torch.float32)
        bi = torch.zeros((tq, lanes), dtype=torch.int64)
        for k in range(d2.shape[1]):                 # each lane ascending
            lt = d2[:, k] < best                     # strict
            bi = torch.where(lt, k * lanes + torch.arange(lanes), bi)
            best = torch.where(lt, d2[:, k], best)
        o = lanes // 2
        while o:                                     # the xor butterfly
            part = torch.arange(lanes) ^ o
            od, oi = best[:, part], bi[:, part]
            take = (od < best) | ((od == best) & (oi < bi))
            best, bi = torch.where(take, od, best), torch.where(take, oi, bi)
            o //= 2
        d2_out[t * tq:(t + 1) * tq] = best[:, 0]
        idx_out[t * tq:(t + 1) * tq] = torch.where(
            best[:, 0] < tb.BIG, g0 + bi[:, 0], 0).int()
    return d2_out, idx_out


def _tie_case(rng, n=1500, dup=3, masked=0.3):
    """db points on a 1/4 grid, each `dup` times over side by side in
    the sorted order (exact d2 ties inside a block, across a query's lanes
    and across block edges), some masked; queries on the same grid."""
    g = np.round(rng.uniform(0, 10, (n // dup, 3)) * 4) / 4
    g[:, 0] *= 10
    db = np.repeat(g, dup, axis=0).astype(np.float32)
    mask = rng.uniform(size=db.shape[0]) > masked
    q = db[rng.integers(0, db.shape[0], 600)]
    q = (q + np.round(rng.normal(scale=0.5, size=q.shape) * 4) / 4).astype(
        np.float32)
    return db, mask, q[np.argsort(q[:, 0])]


def _tied_queries(q, dbt, pen, offsets, d2, block, wb, tq):
    """How many queries have two or more window columns at their
    minimum d2 (below 1e30)."""
    n = 0
    for t in range(q.shape[0] // tq):
        g0 = int(offsets[t]) * block
        qt = q[t * tq:(t + 1) * tq]
        dd = [qt[:, k:k + 1] - dbt[k, None, g0:g0 + wb * block]
              for k in range(3)]
        full = ((dd[0] * dd[0] + dd[1] * dd[1]) + dd[2] * dd[2]) \
            + pen[None, g0:g0 + wb * block]
        best = d2[t * tq:(t + 1) * tq, None]
        n += int(((full == best).sum(1) > 1)[best[:, 0] < tb.BIG].sum())
    return n


@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("block,wb,tq", [(256, 2, 128), (128, 3, 64)])
def test_lanes_rule_equals_plain_on_ties(rng, lanes, block, wb, tq):
    db, mask, q = _tie_case(rng)
    bdb = tb.build_banded(torch.from_numpy(db), torch.from_numpy(mask),
                          block=block)
    args = tb._nearest_banded_args(bdb, torch.from_numpy(q), block, wb, tq)
    d2p, ip = tb.nearest_banded_plain(*args, block, wb, tq)
    d2l, il = _lanes_rule(*args, block, wb, tq, lanes)
    assert torch.equal(d2l, d2p) and torch.equal(il, ip)
    assert _tied_queries(*args, d2p, block, wb, tq) > 100


@pytest.mark.parametrize("lanes", [1, 4, 32])
def test_lanes_rule_window_of_penalised_columns(rng, lanes):
    """A query tile whose window holds only masked and pad columns gets
    (1e30, 0) from the plain version and from the lanes' rule."""
    db, mask, q = _tie_case(rng, n=900, masked=0.45)
    block, wb, tq = 128, 2, 64
    bdb = tb.build_banded(torch.from_numpy(db), torch.from_numpy(mask),
                          block=block)
    q_, dbt, pen, offsets = tb._nearest_banded_args(
        bdb, torch.from_numpy(q), block, wb, tq)
    nb = dbt.shape[1] // block
    offsets = offsets.clone()
    offsets[1] = nb - wb                              # the last blocks
    assert bool((pen[(nb - wb) * block:] > 1e29).all())
    args = (q_, dbt, pen, offsets)
    d2p, ip = tb.nearest_banded_plain(*args, block, wb, tq)
    d2l, il = _lanes_rule(*args, block, wb, tq, lanes)
    assert torch.equal(d2l, d2p) and torch.equal(il, ip)
    assert bool((d2p[tq:2 * tq] == tb.BIG).all())
    assert not bool(ip[tq:2 * tq].any())


def test_lanes_rule_matches_pallas_interpret_on_ties(rng):
    """The same tie-heavy input through the JAX package's K6 (Pallas,
    interpret mode) and the port's lanes rule at 32 lanes: d2 and the
    original index equal."""
    db, mask, q = _tie_case(rng)
    kw = dict(block=256, window_blocks=2, query_tile=128)
    j = jb.build_banded(jnp.asarray(db), jnp.asarray(mask), block=256)
    d2_j, idx_j = jb.nearest_banded(j, jnp.asarray(q), interpret=True, **kw)
    bdb = tb.build_banded(torch.from_numpy(db), torch.from_numpy(mask),
                          block=256)
    args = tb._nearest_banded_args(bdb, torch.from_numpy(q), **kw)
    d2l, il = _lanes_rule(*args, 256, 2, 128, 32)
    m = q.shape[0]
    np.testing.assert_array_equal(d2l[:m].numpy(), np.asarray(d2_j))
    np.testing.assert_array_equal(bdb.order[il[:m].long()].numpy(),
                                  np.asarray(idx_j))
