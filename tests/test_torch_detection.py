"""The port's KITTI detection chain against the JAX package, on the CPU:
`pipelines.detect` (the cluster filters and resample, `predict_clusters`
on JAX `cls-ssg` weights carried across by `models/convert.py:load_flax`,
`detect_frame`, `to_kitti_rows`), `pipelines.kitti_eval`'s AP, and
`pipelines.miniworld.run_task_loop` at a small size. Inputs come from
numpy with a seed (a mini-world frame); the plane's triples are JAX's own
Gumbel top-3, injected into the port.

Tolerances: probabilities within 1e-5 (the Dense layers' sums run in
another order in the two libraries' CPU BLAS), the KITTI rows and the AP
equal."""
import torch_threads as _torch_threads  # noqa: F401

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from pctpu.core import io as jio
from pctpu.nn import train as JT
from pctpu.nn.config import TrainConfig as JConfig
from pctpu.pipelines import detect as jdetect
from pctpu.pipelines import kitti_eval as jeval
from pctpu.pipelines import miniworld as jworld
from pctpu_torch.core import io as tio
from pctpu_torch.models import convert
from pctpu_torch.nn import train as T
from pctpu_torch.nn.config import TrainConfig
from pctpu_torch.pipelines import detect as tdetect
from pctpu_torch.pipelines import kitti_eval as teval
from pctpu_torch.pipelines import miniworld as tworld

BATCH = 4


def jax_plane_sampler(key):
    """The reference's Gumbel top-3 triples on the port's vote mask."""
    def sample(vote_mask, h):
        m = jnp.asarray(vote_mask.cpu().numpy())
        g = jax.random.gumbel(key, (h, m.shape[0])) + jnp.where(
            m, 0.0, -1e9)[None, :]
        return torch.from_numpy(np.array(jax.lax.top_k(g, 3)[1]))
    return sample


@functools.lru_cache(maxsize=None)
def models():
    """A JAX `cls-ssg` (4 classes, 64 points) from PRNGKey(0) and the
    port's model holding its weights, on the CPU."""
    jcfg = JConfig(model="cls-ssg", num_classes=4, num_points=64,
                   batch_size=BATCH)
    key = jax.random.PRNGKey(0)
    jm, jstate = JT.create_train_state(jcfg, key,
                                       jax.random.normal(key, (BATCH, 64, 6)))
    flat = {k: np.asarray(v) for k, v in flatten_dict(
        {"params": jstate.params, "batch_stats": jstate.batch_stats},
        sep="/").items()}
    tm = T.build_model(TrainConfig(model="cls-ssg", num_classes=4,
                                   num_points=64, batch_size=BATCH),
                       device="cpu")
    convert.load_flax(tm, flat)
    return jm, jstate, tm


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("world")
    ids = jworld.generate_dataset(str(root), 1, seed=3)
    pts = jio.read_velodyne_bin(str(root / "velodyne" / (ids[0] + ".bin")))
    calib = jio.read_kitti_calib(str(root / "calib" / (ids[0] + ".txt")))
    return root, ids[0], pts, calib


def test_predict_clusters_matches_jax():
    jm, jstate, tm = models()
    rng = np.random.default_rng(0)
    X = rng.normal(size=(6, 64, 6)).astype(np.float32)   # pads to 8
    cfg = jdetect.DetectConfig(batch_size=BATCH)
    ref = jdetect.predict_clusters(jm, jstate, X, cfg)
    ours = tdetect.predict_clusters(tm, None, X,
                                    tdetect.DetectConfig(batch_size=BATCH))
    assert ours.shape == ref.shape == (6, 4)
    np.testing.assert_allclose(ours, ref, atol=1e-5)
    assert tdetect.predict_clusters(tm, None, X[:0], cfg).shape == (0, 4)


def test_detect_frame_matches_jax(world):
    """The whole frame: the same KITTI rows from the same draws; on the
    way, the preprocessed clusters and their probabilities agree."""
    root, fid, pts, calib = world
    jm, jstate, tm = models()
    key = jax.random.PRNGKey(0)
    cfg = jdetect.DetectConfig(batch_size=BATCH)
    ref = jdetect.detect_frame(pts, calib, jm, jstate, cfg=cfg,
                               seg_cfg=jworld.seg_config(), seed=0)
    ours = tdetect.detect_frame(pts, tio.read_kitti_calib(
        str(root / "calib" / (fid + ".txt"))), tm, None,
        cfg=tdetect.DetectConfig(batch_size=BATCH),
        seg_cfg=tworld.seg_config(), seed=0, device="cpu",
        sampler=jax_plane_sampler(key))
    assert ours == ref
    assert ours               # a random model calls some clusters misc
    for row in ours:
        parts = row.split()
        assert len(parts) == 16 and parts[0] in ("Car", "Pedestrian",
                                                 "Cyclist")


def test_preprocess_and_rows_match_jax():
    rng = np.random.default_rng(1)
    pts = np.concatenate([rng.normal(loc=c, scale=0.4, size=(n, 3))
                          for c, n in (((8, 2, -1), 40), ((12, -3, -1), 3),
                                       ((30, 0, -1), 20))]).astype(np.float32)
    ids = np.repeat([0, 1, 2], [40, 3, 20]).astype(np.int32)
    normals = rng.normal(size=pts.shape).astype(np.float32)
    xj, kj = jdetect.preprocess_clusters(pts, normals, ids,
                                         jdetect.DetectConfig(),
                                         np.random.default_rng(2))
    xt, kt = tdetect.preprocess_clusters(pts, normals, ids,
                                         tdetect.DetectConfig(),
                                         np.random.default_rng(2))
    assert kt == kj == [0]          # too few points, beyond 25 m
    np.testing.assert_array_equal(xt, xj)
    calib = jworld.make_calib()
    preds = {0: {0: 0.9}, 1: {2: 0.6}, 3: {1: 0.5}}
    assert (tdetect.to_kitti_rows(pts, ids, calib, preds)
            == jdetect.to_kitti_rows(pts, ids, calib, preds))
    xz = rng.normal(size=(30, 3))
    assert tdetect.camera_yaw_pca(xz) == jdetect.camera_yaw_pca(xz)


def test_kitti_eval_matches_jax(world, tmp_path):
    """AP per class and difficulty, every metric, on the frame's labels
    against jittered, rescored and partly dropped detections."""
    root, fid, _, _ = world
    gt = str(root / "label_2" / (fid + ".txt"))
    rng = np.random.default_rng(3)
    rows = []
    for line in open(gt).read().splitlines():
        p = line.split()
        vals = [float(x) for x in p[4:15]]
        vals = [v + rng.normal(scale=0.15) for v in vals]
        rows.append(" ".join([p[0], "-1", "-1", "-10"]
                             + [f"{v:.2f}" for v in vals]
                             + [f"{rng.uniform(10, 99):.2f}"]))
    rows.append("Car -1 -1 -10 10 10 90 90 1.5 1.7 3.9 5 1.7 30 0 40.00")
    det = tmp_path / "det.txt"
    det.write_text("\n".join(rows[1:]) + "\n")
    for metric in ("bbox", "bev", "3d"):
        ours = teval.evaluate_detections([gt], [str(det)], metric=metric)
        ref = jeval.evaluate_detections([gt], [str(det)], metric=metric)
        assert ours.keys() == ref.keys()
        for cls in ref:
            np.testing.assert_array_equal(
                [ours[cls][d] for d in jeval.DIFFICULTY],
                [ref[cls][d] for d in jeval.DIFFICULTY])


def test_run_task_loop_on_the_cpu(tmp_path):
    """The mini-world loop on the port's CPU at a small size: it runs end
    to end and returns the reference's keys. 8 train frames are the fewest
    whose test split (16 clouds) fills one batch of 16; with fewer,
    `test_report` raises KeyError in the reference and the port alike,
    as `evaluate` drops a partial batch."""
    res = tworld.run_task_loop(str(tmp_path), n_train_frames=8,
                               n_eval_frames=1, epochs=1, max_steps=2,
                               heatmap=False, device="cpu")
    assert set(res) == {"val_acc", "test_acc", "ap", "report", "fit"}
    assert set(res["ap"]) == {"Car", "Pedestrian", "Cyclist"}
    assert res["fit"]["steps"] == 2
    assert os.path.exists(tmp_path / "detections" / "000008.txt")


def test_detection_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tm = models()
    pts = np.zeros((10, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdetect.detect_frame(pts, jworld.make_calib(), tm, None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tworld.run_task_loop(str(tmp_path), 1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tworld.main(["--workdir", str(tmp_path)])
