"""How the exact 1-NN kernel (K1, `csrc/nn1.cu`) spreads a launch over the
card: `nn1_plan` in `pctpu_torch/ops/pallas_nn.py`, which mirrors the
kernel's arithmetic, and the rule its CTAs follow -- each scans one db
slice in ascending index with a strict '<' from (1e30, 0), and the
partials are merged in slice order with a strict '<'. A pure-torch
emulation of that rule is held here against `nearest_plain` bit for bit;
the kernel itself is held against it in tests/test_torch_cuda.py."""
import numpy as np
import pytest
import torch

from pctpu_torch.ops.pallas_nn import (BIG, CTAS_PER_SM, MAX_SLICES,
                                       MIN_SLICE, QPT, THREADS,
                                       nearest_plain, nn1_plan)

H100_SMS = 132
P13, P1 = (1, 4096, 4096), (16, 1024, 16384)   # front end; register_pairs
# (B, M, N): the paths' shapes (P13's and P14's front ends and closure
# batches, P1, P3), a single query, N not a multiple of anything, no db
SHAPES = [P13, (15, 1024, 4096), (1, 2048, 2048), (118, 1024, 2048), P1,
          (1, 16384, 124668), (1, 64, 124668), (1, 1, 5), (3, 777, 1001),
          (2, 10, 0)]


def slices_of(plan, n):
    """The db indices each slice of a plan scans, in scan order."""
    return [list(range(s * plan["slice_len"],
                       min(n, (s + 1) * plan["slice_len"])))
            for s in range(plan["slices"])]


@pytest.mark.parametrize("b,m,n", SHAPES)
def test_every_db_point_in_exactly_one_slice_in_order(b, m, n):
    plan = nn1_plan(b, m, n, H100_SMS)
    assert [i for sl in slices_of(plan, n) for i in sl] == list(range(n))
    assert all(slices_of(plan, n)) or n == 0     # no empty slice
    assert plan["tiles"] * THREADS * QPT >= max(m, 1)
    assert plan["grid"] == b * plan["tiles"] * plan["slices"]
    assert plan["slices"] <= MAX_SLICES
    assert plan["slices"] == 1 or plan["slice_len"] >= MIN_SLICE
    assert plan["grid"] <= max(CTAS_PER_SM * H100_SMS, b * plan["tiles"])


@pytest.mark.parametrize("shape", [P13, P1])
def test_main_path_launches_fill_the_card(shape):
    """The SLAM front end's and register_pairs' launches cut the db into
    slices until the warps reach about one per scheduler (4 per SM) or
    more: P13's 8 query tiles become 128 CTAs of 4 warps, one wave."""
    plan = nn1_plan(*shape, H100_SMS)
    assert plan["slices"] > 1
    assert plan["grid"] * THREADS // 32 >= 3.5 * H100_SMS


@pytest.mark.parametrize("shape", [(512, 4096, 4096), (4, 524288, 16384),
                                   (64, 16384, 2048)])
def test_one_slice_where_the_query_tiles_fill_the_card(shape):
    plan = nn1_plan(*shape, H100_SMS)
    assert plan["slices"] == 1 and plan["slice_len"] == shape[2]
    assert plan["grid"] >= H100_SMS


def sliced_nearest(q, db, pen, slices):
    """The kernel's rule in torch: db slices of ceil(N / slices) points,
    each reduced to its (d2, idx) with the plain version (ascending index,
    strict '<', lowest index on ties; (BIG, 0) when nothing is valid),
    then merged in slice order with a strict '<' from (BIG, 0)."""
    b, m, _ = q.shape
    n = db.shape[1]
    best = torch.full((b, m), BIG, dtype=torch.float32)
    bi = torch.zeros((b, m), dtype=torch.int32)
    step = max(1, -(-n // slices))
    for lo in range(0, n, step):
        d, i = nearest_plain(q, db[:, lo:lo + step], pen[:, lo:lo + step])
        better = d < best
        best = torch.where(better, d, best)
        bi = torch.where(better, i + lo, bi)
    return best, bi


def _grid(b=1):
    """A 4x4x4 integer grid as the db (shuffled, so equal distances land
    in different slices) and queries at its points and at half-integer
    offsets, which lie at equal distance from 2, 4 or 8 db points."""
    g = np.stack(np.meshgrid(*[np.arange(4)] * 3, indexing="ij"),
                 -1).reshape(-1, 3).astype(np.float32)
    rng = np.random.default_rng(3)
    db = np.stack([g[rng.permutation(64)] for _ in range(b)])
    q = np.concatenate([g, g + 0.5, g + [0.5, 0, 0], g + [0.5, 0.5, 0]]
                       ).astype(np.float32)
    return (torch.from_numpy(np.stack([q] * b)), torch.from_numpy(db))


def _assert_same(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("slices", [1, 2, 3, 7, 16, 64])
def test_slice_then_merge_equals_one_scan_on_grid_ties(slices):
    q, db = _grid(b=2)
    pen = torch.zeros(db.shape[:2])
    want = nearest_plain(q, db, pen)
    _assert_same(sliced_nearest(q, db, pen, slices), want)
    # the ties are real: some queries have several db points at their d2
    d2 = ((q[:, :, None] - db[:, None]) ** 2).sum(-1)
    assert int((d2 == want[0][..., None]).sum(-1).max()) == 8


@pytest.mark.parametrize("slices", [1, 4, 13])
def test_slice_then_merge_on_an_all_masked_db(rng, slices):
    q = torch.from_numpy(rng.uniform(-5, 5, (2, 30, 3)).astype(np.float32))
    db = torch.from_numpy(rng.uniform(-5, 5, (2, 50, 3)).astype(np.float32))
    pen = torch.full((2, 50), BIG)
    got = sliced_nearest(q, db, pen, slices)
    _assert_same(got, nearest_plain(q, db, pen))
    assert bool((got[0] == BIG).all()) and int(got[1].abs().max()) == 0


@pytest.mark.parametrize("slices", [2, 5, 9])
def test_slice_then_merge_when_the_first_slices_are_masked(rng, slices):
    q = torch.from_numpy(rng.uniform(-5, 5, (1, 40, 3)).astype(np.float32))
    db = torch.from_numpy(rng.uniform(-5, 5, (1, 90, 3)).astype(np.float32))
    pen = torch.zeros((1, 90))
    pen[:, :60] = BIG                      # every slice up to index 59
    got = sliced_nearest(q, db, pen, slices)
    _assert_same(got, nearest_plain(q, db, pen))
    assert int(got[1].min()) >= 60


@pytest.mark.parametrize("b,m,n", [(2, 37, 1001), (1, 1, 300), (3, 1, 7)])
def test_slice_then_merge_at_the_plans_slices(rng, b, m, n):
    """N not a multiple of the slice length, and M = 1, at the slices the
    plan picks and at a few others; duplicated db points tie exactly."""
    db = rng.uniform(-3, 3, (b, n, 3)).astype(np.float32)
    db[:, n // 2:n // 2 + n // 4] = db[:, :n // 4]
    q = (db[:, rng.integers(0, n, m)] + rng.normal(scale=0.3, size=(b, m, 3))
         ).astype(np.float32)
    pen = torch.where(torch.from_numpy(rng.uniform(size=(b, n)) > 0.2), 0.0,
                      BIG).float()
    q, db = torch.from_numpy(q), torch.from_numpy(db)
    want = nearest_plain(q, db, pen)
    plan = nn1_plan(b, m, n, H100_SMS)
    for slices in {plan["slices"], 2, 6, n}:
        _assert_same(sliced_nearest(q, db, pen, slices), want)
