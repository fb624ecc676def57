"""CPU tests of the harness: files found by name, the window's
arithmetic, the idle share as a union of intervals, the work counted from
shapes, and the generators' determinism in the seed."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.common import generators as gen
from portbench.common import harness, peaks, trace, work
from portbench.common.draws import draw_seed, sampler_for
from portbench.common.plain_geometry import point_gap, tf32_round

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(wl):
    w, config, traffic, spans, drv, ref, e2e, per_layer = \
        harness.cell_files(wl)
    assert w["name"] == wl and config["name"] == w["config"]
    assert (ROOT / "portbench" / "spans" / f"{traffic['entry']}.json").exists()
    assert spans["groups"] and all(spans["groups"].values())
    assert hasattr(drv, "Cell") and traffic["limits"]
    assert {m["name"] for m in e2e} >= {"setup_s"}
    assert per_layer
    for m in e2e + per_layer:
        assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()


def test_every_config_file_lies_under_paths():
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        assert (ROOT / c["file"]).exists()
        data = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in data and key in data["reduced"]


def _reader(name):
    return harness.load_module(ROOT / "portbench" / "metrics" / f"{name}.py",
                               "t_" + name.replace(".", "_"))


def test_window_rate_is_all_work_over_all_time():
    run = harness.RunView("pairs", calls=4, units=64,
                          latencies_s=[0.5, 0.5, 0.5, 0.5], window_s=2.0,
                          setup_s=3.0, trace=None)
    assert _reader("pairs_per_s").read(run) == pytest.approx(32.0)
    assert _reader("setup_s").read(run) == 3.0


def test_p95_is_over_every_call():
    lat = [0.010] * 95 + [0.100] * 5
    run = harness.RunView("pairs", 100, 1600, lat, sum(lat), 1.0, None)
    v = _reader("pair_call_ms_p95").read(run)
    assert v == pytest.approx(np.percentile(np.asarray(lat) * 1e3, 95))
    assert 10.0 <= v <= 100.0


def test_union_of_intervals():
    assert trace.union_ns([(0, 10), (5, 15), (20, 30)]) == 25
    assert trace.union_ns([(0, 10), (2, 3), (10, 12)]) == 12
    assert trace.union_ns([]) == 0


def _view():
    kernels = [("k1", 10, 20), ("k2", 15, 30), ("k3", 60, 70)]
    device = kernels + [("Memcpy HtoD", 0, 5)]
    spans = {"frontend/a": [(0, 40)], "icp/b": [(50, 100)]}
    return trace.TraceView(kernels, device, spans, calls=[(0, 100)],
                           units=4, span_wall={"frontend": 0.2, "icp": 0.1},
                           missing=set(),
                           work={"icp": {"flops": 67e12 * 5e-9,
                                         "bytes": 0.0}})


def test_idle_share_and_span_device_time():
    t = _view()
    assert t.busy_s == pytest.approx(35e-9)
    run = harness.RunView("pairs", 1, 4, [1.0], 1.0, 1.0, t)
    assert _reader("device_idle_pct.reg").read(run) == pytest.approx(65.0)
    assert t.device_s_in("icp") == pytest.approx(10e-9)
    assert t.device_s_in("frontend") == pytest.approx(25e-9)
    assert _reader("icp_roofline_pct.reg").read(run) == pytest.approx(50.0)
    assert _reader("kernels_per_pair.reg").read(run) == pytest.approx(0.75)
    assert _reader("frontend_ms_per_pair.reg").read(run) == \
        pytest.approx(50.0)
    bd = t.breakdown()
    assert bd["device_ops"][0] == ["k2", 15e-9]
    assert sum(v for _, v in bd["idle_gaps"]) == pytest.approx(65e-9)


def test_missing_span_reads_none():
    t = _view()
    t.missing = {"icp"}
    run = harness.RunView("pairs", 1, 4, [1.0], 1.0, 1.0, t)
    assert _reader("icp_ms_per_pair.reg").read(run) is None
    assert _reader("icp_roofline_pct.reg").read(run) is None


def test_probe_reports_a_missing_name_and_restores(monkeypatch):
    import sys
    import types
    mod = types.ModuleType("pb_fake_entry")
    mod.f = lambda x: x + 1
    other = types.ModuleType("pb_fake_other")
    other.g = lambda x: 2 * x
    monkeypatch.setitem(sys.modules, "pb_fake_entry", mod)
    monkeypatch.setitem(sys.modules, "pb_fake_other", other)
    logs = []
    p = harness.Probe("pb_fake_entry", ("f",),
                      {"a": ["f", "gone"], "b": ["pb_fake_other:g"]},
                      lambda: None, logs.append)
    assert p.missing_groups == {"a"} and logs
    p.capturing = {}
    assert mod.f(1) == 2 and other.g(2) == 4
    assert p.capturing == {"f": [((1,), {}, 2)]}
    p.restore()
    assert not hasattr(mod.f, "__wrapped__")
    assert not hasattr(other.g, "__wrapped__")


def test_nn1_work_from_shapes():
    f, b = work.nn1_work(700, 800, 14)
    assert f == 6 * 700 * 800 * 14
    assert b == 16 * (2 * 700 + 800) * 14
    assert peaks.least_seconds(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)


def test_reg_work_counts_voxels_not_capacity():
    _, config, traffic, _, drv, ref, _, _ = harness.cell_files(
        "reg-b16-35deg")
    config = {**config, "scan_points": 4096}
    cell = drv.Cell(config, {**traffic, "batch": 1, "pool_batches": 1},
                    3, torch.device("cpu"), ref)
    w = cell.work([0])["icp"]
    b = cell.pool[0]
    nv = [ref.voxel_capped(torch.from_numpy(c[0]), 2.0, 1)[2]
          for c in (b["src"], b["dst"])]
    cfg = config["registration_config"]
    n = 4096
    expect = (14 * nv[0] * nv[1] + cfg["icp_refine_iters"]
              * 2048 * n + 1024 * n) * 6
    assert w["flops"] == expect


def test_generators_are_deterministic_in_the_seed():
    big = 2**31 + 12345
    a = gen.lidar_scan(gen.seed_sequence(big, 0), n_points=5000)
    b = gen.lidar_scan(gen.seed_sequence(big, 0), n_points=5000)
    c = gen.lidar_scan(gen.seed_sequence(big + 1, 0), n_points=5000)
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    p1 = gen.make_pairs(a, gen.seed_sequence(big, 1), 2, 1000,
                        [0.05, -0.03, 0.61], [3, -2, 0.5], 0.02)
    p2 = gen.make_pairs(a, gen.seed_sequence(big, 1), 2, 1000,
                        [0.05, -0.03, 0.61], [3, -2, 0.5], 0.02)
    for x, y in zip(p1, p2):
        assert np.array_equal(x, y)


def test_rotvec_and_pose_errors():
    R = gen.rotvec_matrix([0.0, 0.0, np.pi / 2])
    assert np.allclose(R @ [1, 0, 0], [0, 1, 0], atol=1e-6)
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, [1.0, 0.0, 0.0]
    rte, rre = gen.rte_rre(T, np.eye(4))
    assert rte == pytest.approx(1.0) and rre == pytest.approx(90.0)
    pts = torch.tensor([[[2.0, 0.0, 0.0], [0.0, 0.0, 0.0]]])
    assert point_gap(torch.tensor(T)[None], torch.eye(4)[None], pts) == \
        pytest.approx(np.sqrt(5.0))
    assert point_gap(torch.tensor(T)[None], torch.eye(4)[None], pts,
                     torch.tensor([[False, True]])) == pytest.approx(1.0)


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -12])
    assert tf32_round(x).tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                      -3.0]


def test_draws_replay_for_the_reference():
    nv = torch.tensor([5, 100], dtype=torch.int32)
    a = sampler_for(2**40 + 3, 7, "cpu")(nv, 64)
    b = sampler_for(2**40 + 3, 7, "cpu")(nv, 64)
    assert torch.equal(a, b) and a.shape == (2, 64, 3)
    assert int(a[0].max()) < 5 and int(a.min()) >= 0
    assert draw_seed(1, 0) != draw_seed(1, 1) != draw_seed(2, 1)
