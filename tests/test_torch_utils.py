"""The port's host utilities against the JAX package's, on the CPU: the
PLY writers (`utils.viz`) byte for byte, the timers and the MFU helper
(`utils.profiling`, mirroring `tests/test_utils.py`: a matmul's FLOP
count within 20% of 2MNK), the profiler trace, and the neighbour-search
CLI (`pipelines.nn_benchmark`) on the CPU, every row printed."""

import numpy as np
import pytest
import torch

from pctpu.utils import viz as jviz
from pctpu_torch import utils as tutils
from pctpu_torch.pipelines import nn_benchmark
from pctpu_torch.utils import profiling, viz


def _same_file(tmp_path, name, fn, *args):
    a, b = tmp_path / f"ref_{name}.ply", tmp_path / f"got_{name}.ply"
    getattr(jviz, fn)(str(a), *args)
    getattr(viz, fn)(str(b), *args)
    assert b.stat().st_size > 0
    assert a.read_bytes() == b.read_bytes()
    return b.read_text()


def test_utils_exports_the_reference_names():
    for name in ("viz", "sync", "time_fn", "profiler_trace", "Timer"):
        assert hasattr(tutils, name)


def test_viz_writers_match_jax_byte_for_byte(tmp_path):
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    labels = rng.integers(-1, 15, size=50)
    assert "element vertex 50" in _same_file(
        tmp_path, "c", "write_clusters_ply", pts, labels)
    T = np.eye(4)
    T[:3, 3] = [0.5, -1.0, 2.0]
    assert "element vertex 80" in _same_file(
        tmp_path, "r", "write_registration_ply", pts, pts[:30], T)
    _same_file(tmp_path, "r0", "write_registration_ply", pts, pts[:30])
    _same_file(tmp_path, "k", "write_keypoints_ply", pts,
               rng.uniform(size=50) > 0.7)
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    boxes = [{"center": [0, 0, 0], "dims": [2, 1, 1], "R": None,
              "class_id": 0},
             {"center": [3, 1, 0], "dims": [4, 1.5, 1.8], "R": R,
              "class_id": 14}]
    _same_file(tmp_path, "d", "write_detections_ply", pts, boxes)
    poses = np.tile(np.eye(4), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5)
    assert "element vertex 5" in _same_file(
        tmp_path, "t", "write_trajectory_ply", poses)
    np.testing.assert_array_equal(
        viz.bbox_line_points(np.zeros(3), np.ones(3), R, 7),
        jviz.bbox_line_points(np.zeros(3), np.ones(3), R, 7))


def test_timer_and_time_fn():
    t = tutils.Timer()
    with t.section("a"):
        pass
    with t.section("a"):
        pass
    assert t.counts["a"] == 2
    assert "a:" in t.report()
    out = tutils.time_fn(lambda x: torch.sum(x), torch.ones((128,)),
                         warmup=1, reps=2)
    assert out["mean_s"] >= 0 and out["per_sec"] > 0


def test_sync_fetches_a_tree():
    tree = {"a": torch.ones(3), "b": (torch.zeros(2, dtype=torch.int32),
                                      [torch.arange(4)]), "c": 1.5}
    out = tutils.sync(tree)
    assert isinstance(out["a"], np.ndarray) and out["c"] == 1.5
    np.testing.assert_array_equal(out["b"][1][0], np.arange(4))


def test_measure_mfu_matmul():
    """The FLOP count of a matmul is ~2MNK and MFU lands in (0, 1]
    against an explicit peak."""
    a = torch.ones((256, 128))
    b = torch.ones((128, 64))

    def f(x, y):
        return x @ y
    fl = profiling.flops_of(f, a, b)
    assert abs(fl - 2 * 256 * 128 * 64) / (2 * 256 * 128 * 64) < 0.2
    out = profiling.measure_mfu(f, a, b, reps=2)
    assert out["flops"] == fl and out["mean_s"] > 0
    assert 0 < profiling.mfu(fl, 1.0, peak=1e12) < 1
    assert profiling.PEAK_FLOPS["float32"] == 67e12


def test_profiler_trace_writes_a_trace(tmp_path):
    logdir = tmp_path / "trace"
    with tutils.profiler_trace(str(logdir)):
        torch.ones((64, 64)) @ torch.ones((64, 64))
    files = list(logdir.iterdir())
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "aten::" in files[0].read_text()


def test_nn_benchmark_on_the_cpu_prints_every_row(tmp_path, capsys):
    scan = np.random.default_rng(0).uniform(
        -20, 20, (3000, 4)).astype(np.float32)
    path = tmp_path / "000000.bin"
    scan.tofile(path)
    nn_benchmark.main(["--bin", str(path), "--n", "2048", "--queries",
                       "256", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "db=2048 queries=256" in out and "note:" not in out
    for row in ("pctpu_torch knn:", "pctpu_torch radius:",
                "pctpu_torch 1-NN:", "c++ kd build:", "c++ kd knn:",
                "c++ kd radius:", "c++ oct build:", "c++ oct knn:",
                "c++ oct radius:", "scipy build:", "scipy knn:",
                "scipy radius:", "numpy brute:"):
        assert row in out, row
    nn_benchmark.main(["--bin", str(tmp_path / "missing.bin"), "--n",
                       "512", "--queries", "64", "--device", "cpu"])
    assert "not found; using a synthetic" in capsys.readouterr().out


def test_nn_benchmark_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        nn_benchmark.main(["--n", "512", "--queries", "64"])
