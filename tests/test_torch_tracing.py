"""The program's spans (`pctpu_torch/utils/profiling.py`: `span`, `TRACE`,
`Timer`) on the CPU: silent and free while no profiler records; inside
`register_pairs` and `register_pair` under a profiler, the whole tree of
stages with its counts, nested on the host's clock and in the profiler's
ranges, and the outputs unchanged bit for bit; the Chrome trace of
`profiler_trace`; the ISS spans and counter of `keypoints="iss"`; and the
benchmark's readers of the spans and of the ISS stage's kernels."""
import torch_threads as _torch_threads  # noqa: F401

import contextlib
import dataclasses
import itertools
import json
import sys
import threading
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.features import iss
from pctpu_torch.register import pipeline
from pctpu_torch.utils import profiling

TREE = {  # path -> occurrences in one call
    "register_pairs": 1, "register_pairs/inputs": 1,
    "register_pairs/voxel": 2, "register_pairs/fpfh": 2,
    **{f"register_pairs/fpfh/{s}": 2
       for s in ("normals", "band", "spfh", "wsum", "normalise")},
    "register_pairs/sites": 1, "register_pairs/match": 1,
    "register_pairs/gather": 1, "register_pairs/ransac": 1,
    **{f"register_pairs/ransac/{s}": 1
       for s in ("compact", "sample", "solve", "score", "refine")},
    "register_pairs/icp_voxel": 1, "register_pairs/icp_refine": 1,
    "register_pairs/icp_stats": 1}
READERS = {"inputs_ms_per_pair.reg": "register_pairs/inputs",
           "voxel_dispatch_ms_per_pair.reg": "register_pairs/voxel",
           "fpfh_dispatch_ms_per_pair.reg": "register_pairs/fpfh",
           "ransac_dispatch_ms_per_pair.reg": "register_pairs/ransac"}
CFG = pipeline.RegistrationConfig(
    voxel_size=1.0, feature_radius=5.0, ransac_dist=1.5,
    ransac_hypotheses=256, icp_dist_thresh=2.0, downsample_capacity=512,
    refine_subsample=512, stats_subsample=256, icp_fixed_coarse=4,
    icp_fixed_polish=2)
SINGLE_TREE = {  # register_pair's paths -> occurrences in one call
    "register_pair": 1, "register_pair/inputs": 1,
    "register_pair/voxel": 2, "register_pair/fpfh": 2,
    **{f"register_pair/fpfh/{s}": 2 for s in ("normals", "radius", "spfh")},
    "register_pair/sites": 2, "register_pair/match": 1,
    "register_pair/gather": 1, "register_pair/ransac": 1,
    **{f"register_pair/ransac/{s}": 1
       for s in ("compact", "sample", "solve", "score", "refine")},
    "register_pair/icp": 1,
    **{f"register_pair/icp/{s}": 1 for s in ("layout", "coarse", "polish")},
    "register_pair/icp_stats": 1}
SINGLE_READERS = {
    "fpfh_dispatch_ms_per_pair.single": "register_pair/fpfh",
    "icp_layout_ms_per_pair.single": "register_pair/icp/layout"}


def _pairs():
    """Two pairs of a 1,200-point ground-and-walls scene, moved 10 deg
    and [1, -0.5, 0.1] m."""
    rng = np.random.default_rng(3)
    g = rng.uniform(-15, 15, (600, 3))
    g[:, 2] = rng.normal(scale=0.05, size=600)
    walls = rng.uniform(-15, 15, (600, 3))
    walls[:, 0] = np.round(walls[:, 0] / 10) * 10
    walls[:, 2] = np.abs(walls[:, 2]) / 3
    src = np.concatenate([g, walls]).astype(np.float32)
    c, s = np.cos(np.radians(10)), np.sin(np.radians(10))
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    dst = src @ R.T + np.array([1.0, -0.5, 0.1], np.float32)
    src2, dst2 = np.stack([src, src]), np.stack([dst, dst[::-1]])
    mask = torch.ones(src2.shape[:2], dtype=torch.bool)
    return (PointCloud(torch.from_numpy(src2), mask),
            PointCloud(torch.from_numpy(np.ascontiguousarray(dst2)), mask))


def _call(src, dst):
    return pipeline.register_pairs(
        src, dst, CFG, generator=torch.Generator().manual_seed(0),
        device="cpu")


@pytest.fixture(scope="module")
def traced():
    """One call with no profiler, one under a CPU profiler: (outputs off,
    outputs on, the spans' totals and counts, the `pct:` events as
    (name, start_ns, end_ns))."""
    src, dst = _pairs()
    return _record(lambda: _call(src, dst))


def _call_single(src, dst):
    return pipeline.register_pair(
        PointCloud(src.points[0], src.mask[0]),
        PointCloud(dst.points[0], dst.mask[0]), CFG,
        generator=torch.Generator().manual_seed(0), device="cpu")


def _record(call):
    """One call with no profiler, one under a CPU profiler: (outputs off,
    outputs on, the spans' totals and counts, the `pct:` events as
    (name, start_ns, end_ns))."""
    profiling.TRACE.reset()
    off = call()
    assert not profiling.TRACE.totals
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = call()
    totals = dict(profiling.TRACE.totals)
    counts = dict(profiling.TRACE.counts)
    events = [(e.name()[4:], e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.name().startswith("pct:")]
    profiling.TRACE.reset()
    return off, on, totals, counts, events


@pytest.fixture(scope="module")
def traced_single():
    """`register_pair` on the first of `_pairs()`, as `traced` records
    `register_pairs` (kernel 5 at 4 windowed and 2 exact iterations)."""
    src, dst = _pairs()
    return _record(lambda: _call_single(src, dst))


def test_span_off_is_the_shared_noop_and_calls_no_range(monkeypatch):
    assert profiling.span("a") is profiling.span("b") is profiling._OFF

    def no_range(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    profiling.TRACE.reset()
    _call(*_pairs())
    assert profiling.TRACE.totals == {} and profiling.TRACE.counts == {}


def _peak_bytes(loop):
    """Peak bytes traced over a second run of `loop`, above where it
    started."""
    tracemalloc.start()
    try:
        loop()
        tracemalloc.reset_peak()
        before, _ = tracemalloc.get_traced_memory()
        loop()
        _, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return peak - before


def test_span_off_allocates_nothing():
    """`span` itself allocates nothing, and a `with` on it no more than a
    `with` on a context made beforehand (the statement's own bound
    method)."""
    span, off = profiling.span, profiling._OFF
    n = 1000

    def empty():
        for _ in itertools.repeat(None, n):
            pass

    def calls():
        for _ in itertools.repeat(None, n):
            span("a")

    def spans():
        for _ in itertools.repeat(None, n):
            with span("a"):
                pass

    def plain_with():
        for _ in itertools.repeat(None, n):
            with off:
                pass
    assert _peak_bytes(calls) == _peak_bytes(empty)
    assert _peak_bytes(spans) == _peak_bytes(plain_with)


@pytest.mark.parametrize("path", sorted(TREE))
def test_profiled_call_records_each_path(traced, path):
    _, _, totals, counts, events = traced
    assert counts.get(path) == TREE[path], (path, counts)
    assert totals[path] > 0
    assert sum(1 for n, _, _ in events if n == path) == TREE[path]


@pytest.mark.parametrize("refine", [True, False])
def test_ransac_spans_follow_refine(refine):
    """`ransac_registration_batch` alone: with `refine` its select and
    refine are one step under `ransac/refine` (on the card one kernel);
    with `refine=False` the select has its own span `ransac/select`."""
    from pctpu_torch.register.ransac import (generator_sampler,
                                             ransac_registration_batch)
    rng = np.random.default_rng(5)
    src = rng.uniform(-10, 10, (2, 64, 3)).astype(np.float32)
    dst = src + np.float32(0.5)
    profiling.TRACE.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        ransac_registration_batch(
            torch.from_numpy(src), torch.from_numpy(dst),
            torch.ones((2, 64), dtype=torch.bool),
            generator_sampler(torch.Generator().manual_seed(0)),
            num_hypotheses=32, refine=refine)
    counts = dict(profiling.TRACE.counts)
    profiling.TRACE.reset()
    last = "refine" if refine else "select"
    assert counts == {"ransac": 1, **{f"ransac/{s}": 1 for s in (
        "compact", "sample", "solve", "score", last)}}


def test_profiled_call_records_no_other_path(traced):
    assert set(traced[3]) == set(TREE)


def _parents_cover_children(totals, tree):
    for path in tree:
        kids = [p for p in tree if p.rpartition("/")[0] == path]
        assert totals[path] >= sum(totals[k] for k in kids), path


def _children_inside_parents(events):
    for name, s, e in events:
        parent = name.rpartition("/")[0]
        if not parent:
            continue
        holders = [(ps, pe) for n, ps, pe in events
                   if n == parent and ps <= s and e <= pe]
        assert len(holders) == 1, (name, s, e)


def _outputs_equal(off, on):
    for name, a, b in zip(off._fields, off, on):
        assert torch.equal(a, b), name


def test_parent_total_covers_its_children(traced):
    _parents_cover_children(traced[2], TREE)


def test_child_ranges_lie_inside_their_parents(traced):
    _children_inside_parents(traced[4])


def test_outputs_equal_with_the_profiler_on_and_off(traced):
    _outputs_equal(traced[0], traced[1])


@pytest.mark.parametrize("path", sorted(SINGLE_TREE))
def test_register_pair_records_each_path(traced_single, path):
    _, _, totals, counts, events = traced_single
    assert counts.get(path) == SINGLE_TREE[path], (path, counts)
    assert totals[path] > 0
    assert sum(1 for n, _, _ in events if n == path) == SINGLE_TREE[path]


def test_register_pair_records_no_other_path(traced_single):
    assert set(traced_single[3]) == set(SINGLE_TREE)


def test_register_pair_parent_total_covers_its_children(traced_single):
    _parents_cover_children(traced_single[2], SINGLE_TREE)


def test_register_pair_child_ranges_lie_inside_their_parents(traced_single):
    _children_inside_parents(traced_single[4])


def test_register_pair_outputs_equal_with_the_profiler_on_and_off(
        traced_single):
    _outputs_equal(traced_single[0], traced_single[1])


def test_profiler_trace_writes_the_program_ranges(tmp_path):
    src, dst = _pairs()
    with profiling.profiler_trace(str(tmp_path)):
        _call(src, dst)
    profiling.TRACE.reset()
    (trace_file,) = tmp_path.glob("trace-*.json")
    names = {e.get("name") for e in
             json.loads(trace_file.read_text())["traceEvents"]}
    assert "pct:register_pairs/ransac/score" in names
    assert "pct:register_pairs/fpfh/spfh" in names


def test_a_raising_span_closes_its_path():
    profiling.TRACE.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            with profiling.span("a"):
                raise ValueError
        with profiling.span("b"):
            pass
    assert set(profiling.TRACE.counts) == {"a", "b"}
    profiling.TRACE.reset()


def test_each_thread_keeps_its_own_path(monkeypatch):
    """Spans on four threads at once (the profiler's state is per thread,
    so it is read as on for the test) nest on their own thread only."""
    monkeypatch.setattr(profiling, "_profiler_on", lambda: True)
    profiling.TRACE.reset()
    barrier = threading.Barrier(4)

    def work(i):
        with profiling.span(f"t{i}"):
            barrier.wait(timeout=30)
            with profiling.span("x"):
                pass
            barrier.wait(timeout=30)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert profiling.TRACE.counts == {
        **{f"t{i}": 1 for i in range(4)}, **{f"t{i}/x": 1 for i in range(4)}}
    profiling.TRACE.reset()


def test_timer_self_time_on_a_tree():
    t = profiling.Timer()
    for path, s in (("a", 10.0), ("a/b", 3.0), ("a/c", 2.0), ("a/b/d", 1.0),
                    ("ab", 5.0), ("a", 4.0)):
        t.add(path, s)
    assert t.totals["a"] == 14.0 and t.counts["a"] == 2
    assert t.self_time("a") == 9.0          # 14 - (3 + 2): not a/b/d, ab
    assert t.self_time("a/b") == 2.0
    assert t.self_time("ab") == 5.0
    lines = t.report().splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["a", "a/b", "a/b/d", "a/c",
                                                  "ab"]
    assert lines[0] == "a: 14000.000 ms (2 calls, self 9000.000 ms)"
    t.reset()
    assert t.totals == {} and t.counts == {} and t.report() == ""


def test_timer_add_loses_no_update_across_threads():
    t = profiling.Timer()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [t.add("p", 1.0) for _ in range(2000)])
            for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert t.counts["p"] == 32000 and t.totals["p"] == 32000.0


# -- the benchmark's readers of the spans -----------------------------------

def _reader(name):
    from portbench.common.harness import BENCH_DIR, load_module
    return load_module(BENCH_DIR / "metrics" / f"{name}.py",
                       "portbench_metric_" + name.replace(".", "_"))


@pytest.fixture(scope="module")
def traced_cell():
    """A traced run of `reg-b16-35deg` on the CPU at 2 pairs of 4,096
    points, one profiled call."""
    from portbench.common.harness import run_cell
    profiling.TRACE.reset()
    res = run_cell("reg-b16-35deg", 2**31 + 91, 0.0, True, device="cpu",
                   traffic_overrides=dict(batch=2, pool_batches=1,
                                          warmup_calls=1, check_calls=1,
                                          trace_calls=1),
                   config_overrides=dict(scan_points=4096),
                   log=lambda m: None)
    totals = dict(profiling.TRACE.totals)
    profiling.TRACE.reset()
    return res, totals


@pytest.mark.parametrize("name", sorted(READERS))
def test_reader_reads_its_span_in_a_traced_run(traced_cell, name):
    res, totals = traced_cell
    v = res["metrics"][name]
    assert v["unit"] == "ms" and v["value"] > 0
    # the span's host ms over the profiled call's 2 pairs
    assert v["value"] == pytest.approx(totals[READERS[name]] * 1e3 / 2)


def test_readers_find_nothing_without_a_trace_or_a_span(monkeypatch):
    from portbench.common.harness import RunView

    class Trace:
        units = 2
    profiling.TRACE.reset()
    traced_run = RunView("pairs", 1, 2, [0.1], 0.1, 1.0, Trace())
    untraced = RunView("pairs", 1, 2, [0.1], 0.1, 1.0, None)
    for name in READERS:
        assert _reader(name).read(untraced) is None
        assert _reader(name).read(traced_run) is None    # never ran
    profiling.TRACE.add("register_pairs/ransac", 0.004)
    assert _reader("ransac_dispatch_ms_per_pair.reg").read(
        traced_run) == pytest.approx(2.0)
    profiling.TRACE.reset()
    monkeypatch.delattr(profiling, "TRACE")              # a program
    assert _reader("ransac_dispatch_ms_per_pair.reg").read(  # without spans
        traced_run) is None


@pytest.fixture(scope="module")
def traced_single_cell():
    """A traced run of `reg-single-35deg` on the CPU at 2,048 points a
    cloud, kernel 5 at 4 windowed and 1 exact iterations, one profiled
    call."""
    from portbench.common.harness import cell_files, run_cell
    config = cell_files("reg-single-35deg")[1]
    rc = {**config["registration_config"], "icp_fixed_coarse": 4,
          "icp_fixed_polish": 1}
    profiling.TRACE.reset()
    res = run_cell("reg-single-35deg", 2**31 + 93, 0.0, True, device="cpu",
                   traffic_overrides=dict(pool_pairs=1, warmup_calls=1,
                                          check_calls=1, trace_calls=1),
                   config_overrides=dict(scan_points=2048,
                                         registration_config=rc),
                   log=lambda m: None)
    totals = dict(profiling.TRACE.totals)
    profiling.TRACE.reset()
    return res, totals


@pytest.mark.parametrize("name", sorted(SINGLE_READERS))
def test_single_reader_reads_its_span_in_a_traced_run(traced_single_cell,
                                                      name):
    res, totals = traced_single_cell
    v = res["metrics"][name]
    assert v["unit"] == "ms" and v["value"] > 0
    # the span's host ms over the profiled call's one pair
    assert v["value"] == pytest.approx(totals[SINGLE_READERS[name]] * 1e3)


def test_single_readers_find_nothing_without_a_trace_or_a_span(monkeypatch):
    from portbench.common.harness import RunView

    class Trace:
        units = 1
    profiling.TRACE.reset()
    traced_run = RunView("pairs", 1, 1, [0.1], 0.1, 1.0, Trace())
    untraced = RunView("pairs", 1, 1, [0.1], 0.1, 1.0, None)
    for name in SINGLE_READERS:
        assert _reader(name).read(untraced) is None
        assert _reader(name).read(traced_run) is None    # never ran
    profiling.TRACE.add("register_pair/icp/layout", 0.003)
    assert _reader("icp_layout_ms_per_pair.single").read(
        traced_run) == pytest.approx(3.0)
    profiling.TRACE.reset()
    monkeypatch.delattr(profiling, "TRACE")              # a program
    assert _reader("icp_layout_ms_per_pair.single").read(  # without spans
        traced_run) is None


# -- ISS keypoints: spans, counter, readers ---------------------------------

ISS_CFG = dataclasses.replace(CFG, keypoints="iss")
ISS_TREE = {**TREE, **{f"register_pairs/sites/iss{s}": 4   # 2B, B = 2
                       for s in ("", "/radius", "/scatter", "/eig", "/nms")}}


def _call_iss(src, dst):
    return pipeline.register_pairs(
        src, dst, ISS_CFG, generator=torch.Generator().manual_seed(0),
        device="cpu")


@pytest.fixture(scope="module")
def traced_iss():
    """`register_pairs(keypoints="iss")` on `_pairs()`, as `traced`
    records the default sites."""
    src, dst = _pairs()
    return _record(lambda: _call_iss(src, dst))


@pytest.mark.parametrize("path", sorted(ISS_TREE))
def test_iss_call_records_each_path(traced_iss, path):
    _, _, totals, counts, events = traced_iss
    assert counts.get(path) == ISS_TREE[path], (path, counts)
    assert totals[path] > 0
    assert sum(1 for n, _, _ in events if n == path) == ISS_TREE[path]


def test_iss_call_records_no_other_path(traced_iss):
    assert set(traced_iss[3]) == set(ISS_TREE)


def test_iss_parent_total_covers_its_children(traced_iss):
    _parents_cover_children(traced_iss[2], ISS_TREE)


def test_iss_child_ranges_lie_inside_their_parents(traced_iss):
    _children_inside_parents(traced_iss[4])


def test_iss_outputs_equal_with_the_profiler_on_and_off(traced_iss):
    _outputs_equal(traced_iss[0], traced_iss[1])


@pytest.mark.parametrize("profiled", [False, True])
def test_iss_keypoints_calls_rise_by_2b_a_call(profiled):
    """`iss_keypoints.calls`: once a cloud, 2B a `register_pairs` call,
    whether a profiler records or not."""
    src, dst = _pairs()
    before = iss.iss_keypoints.calls
    with (profile(activities=[ProfilerActivity.CPU]) if profiled
          else contextlib.nullcontext()):
        _call_iss(src, dst)
    profiling.TRACE.reset()
    assert iss.iss_keypoints.calls - before == 2 * src.points.shape[0]


@pytest.fixture(scope="module")
def traced_iss_cell():
    """A traced run of `reg-iss-b16` on the CPU at 2 pairs of 4,096
    points, one profiled call."""
    from portbench.common.harness import run_cell
    profiling.TRACE.reset()
    res = run_cell("reg-iss-b16", 2**31 + 95, 0.0, True, device="cpu",
                   traffic_overrides=dict(batch=2, pool_batches=1,
                                          warmup_calls=1, check_calls=1,
                                          trace_calls=1),
                   config_overrides=dict(scan_points=4096),
                   log=lambda m: None)
    totals = dict(profiling.TRACE.totals)
    profiling.TRACE.reset()
    return res, totals


def test_iss_readers_read_in_a_traced_run(traced_iss_cell):
    res, totals = traced_iss_cell
    v = res["metrics"]["iss_ms_per_pair.iss"]
    assert v["unit"] == "ms" and v["value"] > 0
    # the 2B spans' host ms over the profiled call's 2 pairs
    assert v["value"] == pytest.approx(
        totals["register_pairs/sites/iss"] * 1e3 / 2)
    k = res["metrics"]["iss_kernels_per_pair.iss"]
    assert k["unit"] == "kernels/pair"
    assert k["value"] == 0.0          # the CPU launches no device kernel


def test_iss_kernel_reader_counts_kernels_started_in_the_sites_spans():
    """Kernels that start inside a `pb:frontend/keypoint_sites` span count
    (its start inclusive, its end not); others, and spans of other names,
    do not; over the profiled pairs."""
    from portbench.common.harness import RunView
    from portbench.common.trace import TraceView
    kernels = [("k", 5, 6), ("k", 10, 11), ("k", 15, 16), ("k", 20, 21),
               ("k", 31, 32), ("k", 45, 46), ("k", 52, 53)]
    spans = {"frontend/keypoint_sites": [(30, 40), (10, 20)],
             "frontend/match_features": [(40, 60)]}
    t = TraceView(kernels, kernels, spans, [(0, 100)], 4, {}, set(), {})
    run = RunView("pairs", 1, 4, [0.1], 0.1, 1.0, t)
    assert _reader("iss_kernels_per_pair.iss").read(run) == 3 / 4


def test_iss_readers_find_nothing_without_a_trace_or_a_span(monkeypatch):
    from portbench.common.harness import RunView
    from portbench.common.trace import TraceView
    empty = TraceView([("k", 1, 2)], [], {}, [(0, 10)], 2, {}, set(), {})
    traced_run = RunView("pairs", 1, 2, [0.1], 0.1, 1.0, empty)
    untraced = RunView("pairs", 1, 2, [0.1], 0.1, 1.0, None)
    profiling.TRACE.reset()
    for name in ("iss_ms_per_pair.iss", "iss_kernels_per_pair.iss"):
        assert _reader(name).read(untraced) is None
        assert _reader(name).read(traced_run) is None    # never ran
    profiling.TRACE.add("register_pairs/sites/iss", 0.006)
    assert _reader("iss_ms_per_pair.iss").read(traced_run) == pytest.approx(
        3.0)
    profiling.TRACE.reset()
    monkeypatch.delattr(profiling, "TRACE")              # a program
    assert _reader("iss_ms_per_pair.iss").read(traced_run) is None
