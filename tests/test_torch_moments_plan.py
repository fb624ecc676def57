"""How K9 (`moments`, `csrc/fpfh.cu`) shapes a launch and which columns
it visits, without a card: `moments_plan` mirrors the kernel's CTA and
warp arithmetic (every query in exactly one warp's slot, a CTA's queries
in one tile), and `_visited` below writes out the kernel's x-window
pruning (the step tables of each chunk of a band, `window`'s radius,
`visit_range`): no pair within the radius may lie in a step the warp
skips, on x-sorted clouds (where the tables prune), shuffled ones (where
they cannot) and x-banded ones. The visited pairs' counts must equal the
plain version's count channel. The kernel itself is held against the
plain version on the card in tests/test_torch_cuda.py."""
import torch_threads as _torch_threads  # noqa: F401

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from pctpu_torch.features import pallas_fpfh as pf

H100_SMS = 132
CSRC = Path(pf.__file__).resolve().parents[1] / "csrc" / "fpfh.cu"
THREADS = [32, 64, 128, 256, 512, 1024]
WARP_QUERIES = [1, 2, 4]
CHUNK_STEPS = 128


def _rows(p, q_tile):
    """{cta: rows}, as the kernel maps them: CTA c takes rows c *
    cta_queries onwards, warp w of it warp_queries rows from there."""
    out = {}
    for c in range(p["ctas"] // p["b"]):
        r0 = c * p["cta_queries"]
        out[c] = [r0 + w * p["warp_queries"] + s
                  for w in range(p["threads"] // 32)
                  for s in range(p["warp_queries"])]
    return out


@pytest.mark.parametrize("q_tile", [32, 64, 96, 128, 256])
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("wq", WARP_QUERIES)
def test_every_query_in_exactly_one_slot(q_tile, threads, wq):
    b, np_ = 3, 1536
    p = pf.moments_plan(b, np_, q_tile, H100_SMS, threads=threads,
                        warp_queries=wq)
    if q_tile % (threads // 32 * wq):
        assert p is None
        return
    assert p["cta_queries"] == threads // 32 * wq
    assert p["ctas"] == b * np_ // p["cta_queries"]
    rows = _rows(dict(p, b=b), q_tile)
    flat = sorted(r for rs in rows.values() for r in rs)
    assert flat == list(range(np_))
    for rs in rows.values():          # a CTA's queries share one tile
        assert len({r // q_tile for r in rs}) == 1


@pytest.mark.parametrize("b,np_,q_tile", [(32, 4096, 256), (32, 2048, 256),
                                          (2, 3072, 256), (2, 3072, 64),
                                          (1, 1024, 32), (4, 768, 96)])
def test_default_plan_covers_every_query(b, np_, q_tile):
    p = pf.moments_plan(b, np_, q_tile, H100_SMS)
    assert q_tile % p["cta_queries"] == 0
    rows = _rows(dict(p, b=b), q_tile)
    assert sorted(r for rs in rows.values() for r in rs) == list(range(np_))
    assert p["smem_bytes"] <= 48 * 1024       # no opt-in attribute needed


def test_plan_at_the_kernel_9_phase():
    """(a) P13's frames [32, 4,096] and (b) P1's voxels [32, 2,048]: 4
    queries a warp, CTAs of 1,024 threads, at least one CTA an SM."""
    for np_ in (4096, 2048):
        p = pf.moments_plan(32, np_, 256, H100_SMS)
        assert (p["threads"], p["warp_queries"]) == (1024, 4)
        assert p["ctas"] >= H100_SMS


def test_small_launch_takes_narrower_ctas_and_warps():
    p = pf.moments_plan(1, 1024, 256, H100_SMS)
    assert p["warp_queries"] == 1 and p["threads"] == 256


@pytest.mark.parametrize("kw", [dict(q_tile=48), dict(q_tile=288),
                                dict(q_tile=0), dict(threads=48),
                                dict(threads=2048), dict(warp_queries=3),
                                dict(np_=1000)])
def test_shapes_the_kernel_does_not_take(kw):
    args = dict(b=2, np_=1024, q_tile=256, sms=H100_SMS)
    args.update(kw)
    assert pf.moments_plan(**args) is None


def test_plan_constants_follow_the_source():
    src = CSRC.read_text()
    assert re.search(r"constexpr int kMomLanes = 5;", src)
    assert re.search(rf"constexpr int kChunkSteps = {CHUNK_STEPS};", src)
    assert "warps * 32 * 10 * 4" in src
    p = pf.moments_plan(2, 1024, 256, H100_SMS, threads=1024)
    assert p["smem_bytes"] == pf.FPFH_TABLE_BYTES + 32 * 32 * 10 * 4


def _window(r2, qq, pp):
    """csrc/fpfh.cu `window`: in f64, rounded up to f32."""
    u = 1.0 / (1 << 24)
    m = (math.sqrt(max(qq, 0.0)) + math.sqrt(max(pp, 0.0))) * (1.0 + 4 * u)
    r = math.sqrt(max(r2, 0.0) + 16.0 * u * m * m)
    v = (r + 8.0 * u * m) * (1.0 + 1e-6)
    f = np.float32(v)
    return f if float(f) >= v else np.nextafter(f, np.float32(np.inf))


def _tables(x, pp, pen):
    """One chunk's step tables (`fill_table`): the running maximum of the
    valid columns' x from the chunk's start, the running minimum from its
    end, and the largest valid |p|^2."""
    valid = (pen < 1e20) & ~np.isnan(x) & ~np.isnan(pp)
    xs = x.reshape(-1, 32)
    v = valid.reshape(-1, 32)
    hi = np.maximum.accumulate(np.where(v, xs, -np.inf).max(1))
    lo = np.minimum.accumulate(np.where(v, xs, np.inf).min(1)[::-1])[::-1]
    return hi, lo, np.float32(np.where(valid, np.maximum(pp, 0), 0).max())


def _visited(amat, dbmat, base, nt, q_tile, db_tile, r2, wq):
    """[B,Np,Np] bool: the columns each query's warp visits."""
    b, np_, _ = amat.shape
    out = np.zeros((b, np_, np_), dtype=bool)
    a, d = amat.numpy(), dbmat.numpy()
    r2f = np.float32(r2)
    for i in range(b):
        for t in range(np_ // q_tile):
            start = int(base[i, t]) * db_tile
            ncols = int(nt[i, t]) * db_tile
            for c0 in range(0, ncols, CHUNK_STEPS * 32):
                cols = slice(start + c0, start + min(ncols, c0
                                                     + CHUNK_STEPS * 32))
                hi, lo, pp = _tables(d[i, 0, cols], d[i, 3, cols],
                                     d[i, 4, cols])
                for g in range(t * q_tile, (t + 1) * q_tile, wq):
                    qx = a[i, g:g + wq, 0]
                    R = _window(float(r2f), float(a[i, g:g + wq, 3].max()
                                                  .clip(0)), float(pp))
                    lo_x = np.float32(qx.min() - R)
                    hi_x = np.float32(qx.max() + R)
                    first = int(np.searchsorted(hi >= lo_x, True))
                    last = first + int(np.searchsorted(
                        lo[first:] > hi_x, True))
                    s0 = cols.start + 32 * first
                    out[i, g:g + wq, s0:cols.start + 32 * last] = True
    return out


def _within(amat, dbmat, r2, q_tile):
    """[B,Np,Np] bool: the kernel's (and the plain version's) test, one
    query tile at a time."""
    b, np_, _ = amat.shape
    out = np.zeros((b, np_, np_), dtype=bool)
    for t in range(np_ // q_tile):
        a = amat[:, t * q_tile:(t + 1) * q_tile]
        d2 = a[..., 3:4] + dbmat[:, None, 3] - 2.0 * pf._dot3(
            a[..., :3], dbmat[:, :3])
        out[:, t * q_tile:(t + 1) * q_tile] = (
            d2 + dbmat[:, None, 4] <= r2).numpy()
    return out


def _case(rng, order, banded, b=1, n=4400, radius=1.5):
    """Kernel 9's operands on a ground-like cloud 40 m across (Np 4,608:
    an unbanded band is two chunks of steps, 128 and 16), x-sorted,
    shuffled, or x-sorted with the band tables; ~15% of rows masked."""
    g = rng.uniform(-20, 20, (b, n, 2))
    pts = np.concatenate([g, 0.05 * g[..., :1] + rng.normal(
        scale=0.1, size=(b, n, 1))], axis=-1).astype(np.float32)
    for i in range(b):
        pts[i] = pts[i][np.argsort(pts[i, :, 0]) if order == "sorted"
                        else rng.permutation(n)]
    mask = rng.uniform(size=(b, n)) > 0.15
    amat, dbmat, cent, valid = pf._moments_inputs(
        torch.from_numpy(pts), torch.from_numpy(mask), 4608, 256)
    base, nt = pf._band(amat[..., 0], valid, radius, 256, 512, banded, 0.0)
    return (amat, dbmat, cent, base, nt, 256, 512, radius ** 2)


@pytest.mark.parametrize("wq", [1, 4])
@pytest.mark.parametrize("order,banded", [("sorted", False),
                                          ("shuffled", False),
                                          ("sorted", True)])
def test_no_within_pair_lies_in_a_skipped_step(rng, order, banded, wq):
    args = _case(rng, order, banded)
    amat, dbmat, cent, base, nt, q_tile, db_tile, r2 = args
    seen = _visited(amat, dbmat, base, nt, q_tile, db_tile, r2, wq)
    plain = pf.moments_plain(*args)
    within = _within(amat, dbmat, r2, q_tile)
    in_band = np.zeros_like(within)
    for i in range(amat.shape[0]):
        for t in range(amat.shape[1] // q_tile):
            s = int(base[i, t]) * db_tile
            in_band[i, t * q_tile:(t + 1) * q_tile,
                    s:s + int(nt[i, t]) * db_tile] = True
    assert not (within & in_band & ~seen).any()
    assert not (seen & ~in_band).any()
    counts = (within & seen).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(counts, plain[..., 9].numpy())
    frac = seen.sum() / in_band.sum()
    # the tables prune an x-sorted cloud (less inside a band already cut
    # to the tile's x range, and where a warp's group holds a masked row
    # at the origin) and cannot prune a shuffled one
    assert frac < {"sorted": 0.6 if banded else 0.35,
                   "shuffled": 1.01}[order], frac
    if order == "shuffled":
        assert frac > 0.9, frac
