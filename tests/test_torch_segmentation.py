"""The port's segmentation chain against the JAX package, on the CPU:
`pipelines.segmentation.segment_ground_and_objects`, the KITTI ETL's
`process_frame` on a mini-world frame, the numpy copies the ETL and the
training set rest on (`kitti_frames`, `trainset`, `analytics`, the
mini-world's writer) and the voxel leftovers (`voxel_downsample`'s random
method, `voxel_downsample_cloud`, `voxel_downsample_batch`). Inputs come
from numpy with a seed; the plane's triples and the voxel priorities are
JAX's own draws, injected into the port.

Tolerances: ground, object ids and foreground equal; normals within 1e-4
in |cos| where the neighbourhood is well conditioned (the two libraries'
eigenvectors of a degenerate scatter are arbitrary, and a 9th neighbour
within the d^2 expansion's rounding of the 10th may differ); the ETL's files
equal, their xyz within 1e-6 and their normals within 1e-4 in |cos|
where well conditioned; the numpy copies' outputs equal; the voxel
picks equal, one cloud's centroids within 1e-6 and the batched ones within
1e-4 (their f32 cell-relative cumsums differ in rounding order, as
`tests/test_torch_core.py` holds `voxel_downsample_capped`)."""
import torch_threads as _torch_threads  # noqa: F401

import csv
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.core.cloud import PointCloud as JCloud
from pctpu.ops import voxel as jvoxel
from pctpu.pipelines import analytics as janalytics
from pctpu.pipelines import kitti_etl as jetl
from pctpu.pipelines import kitti_frames as jframes
from pctpu.pipelines import miniworld as jworld
from pctpu.pipelines import trainset as jtrainset
from pctpu.pipelines.segmentation import SegmentationConfig as JSegConfig
from pctpu.pipelines.segmentation import \
    segment_ground_and_objects as j_segment
from pctpu_torch.core.cloud import PointCloud
from pctpu_torch.ops import voxel as tvoxel
from pctpu_torch.pipelines import analytics as tanalytics
from pctpu_torch.pipelines import kitti_etl as tetl
from pctpu_torch.pipelines import kitti_frames as tframes
from pctpu_torch.pipelines import miniworld as tworld
from pctpu_torch.pipelines import trainset as ttrainset
from pctpu_torch.pipelines.segmentation import (SegmentationConfig,
                                                segment_ground_and_objects)

SEG = dict(dbscan_eps=0.8, dbscan_min_pts=5, dbscan_k_cap=48)


def make_frame(rng, n_ground=2000, objects=3):
    """tests/test_pipelines.py's frame: a ground plane + dense boxes."""
    pts = []
    g = np.zeros((n_ground, 3), np.float32)
    g[:, 0] = rng.uniform(2, 60, n_ground)
    g[:, 1] = rng.uniform(-25, 25, n_ground)
    g[:, 2] = rng.normal(scale=0.03, size=n_ground) - 1.7
    pts.append(g)
    for i in range(objects):
        c = np.array([10.0 + 12 * i, -8.0 + 8 * i, -0.8])
        box = rng.uniform(-0.8, 0.8, (300, 3)).astype(np.float32) * \
            np.array([1.8, 0.8, 0.8]) + c
        pts.append(box.astype(np.float32))
    return np.concatenate(pts).astype(np.float32)


def jax_plane_sampler(key):
    """The reference's Gumbel top-3 triples on the port's vote mask."""
    def sample(vote_mask, h):
        m = jnp.asarray(vote_mask.cpu().numpy())
        g = jax.random.gumbel(key, (h, m.shape[0])) + jnp.where(
            m, 0.0, -1e9)[None, :]
        return torch.from_numpy(np.array(jax.lax.top_k(g, 3)[1]))
    return sample


def well_conditioned(points, k=9):
    """Points whose k-NN neighbourhood is well defined, by float64 numpy:
    its scatter has a clear least eigenvalue (the gap to the middle one
    > 1e-2 of the largest), and its k-th and (k+1)-th neighbours lie
    farther apart in d^2 than 4 f32 ulps of |p|^2 + |q|^2, the rounding of
    the |p|^2 + |q|^2 - 2pq expansion both libraries sort by."""
    p = points.astype(np.float64)
    d2 = np.sum((p[:, None] - p[None]) ** 2, axis=-1)
    order = np.argsort(d2, axis=1, kind="stable")
    nn = order[:, :k]
    nb = p[nn]
    c = nb - nb.mean(1, keepdims=True)
    w = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c) / k)
    rows = np.arange(len(p))
    sq = np.sum(p * p, axis=1)
    gap = d2[rows, order[:, k]] - d2[rows, order[:, k - 1]]
    scale = sq + np.maximum(sq[order[:, k]], sq[order[:, k - 1]])
    return ((w[:, 1] - w[:, 0]) > 1e-2 * w[:, 2]) & (
        gap > 4 * 2.0 ** -23 * scale)


@pytest.fixture(scope="module")
def frame_pair():
    """One frame through both packages, with the same plane draws."""
    pts = make_frame(np.random.default_rng(0))
    jpc = JCloud.from_numpy(pts)
    key = jax.random.PRNGKey(0)
    jres = j_segment(jpc.points, jpc.mask, key=key, cfg=JSegConfig(**SEG))
    tpc = PointCloud.from_numpy(pts, device="cpu")
    tres = segment_ground_and_objects(tpc.points, tpc.mask,
                                      sampler=jax_plane_sampler(key),
                                      cfg=SegmentationConfig(**SEG))
    return pts, tpc, jres, tres


def test_segment_ground_and_objects_matches_jax(frame_pair):
    pts, tpc, jres, tres = frame_pair
    for name in ("ground_mask", "object_ids", "foreground"):
        np.testing.assert_array_equal(getattr(tres, name).numpy(),
                                      np.asarray(getattr(jres, name)),
                                      err_msg=name)
    ids = tres.object_ids.numpy()
    assert len(np.unique(ids[ids >= 0])) >= 3
    assert tres.ground_mask.numpy()[:2000].mean() > 0.9


def test_segmentation_normals_match_jax(frame_pair):
    pts, tpc, jres, tres = frame_pair
    n = len(pts)
    good = well_conditioned(tpc.points.numpy()[:n])
    cos = np.abs(np.sum(tres.normals.numpy()[:n] * np.asarray(
        jres.normals)[:n], axis=1))
    assert good.mean() > 0.8
    np.testing.assert_allclose(cos[good], 1.0, atol=1e-4)


def test_segmentation_default_draws_repeat(frame_pair):
    """Without a sampler the plane's triples come from a generator: one
    seed, one result."""
    pts, tpc, _, _ = frame_pair
    cfg = SegmentationConfig(**SEG)
    a, b = (segment_ground_and_objects(
        tpc.points, tpc.mask, generator=torch.Generator().manual_seed(7),
        cfg=cfg) for _ in range(2))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.ground_mask.numpy()[:2000].mean() > 0.9


@pytest.fixture(scope="module")
def mini_world(tmp_path_factory):
    """Two mini-world frames, written by each package's writer."""
    root = tmp_path_factory.mktemp("world")
    ids_j = jworld.generate_dataset(str(root / "jax"), 2, seed=0)
    ids_t = tworld.generate_dataset(str(root / "torch"), 2, seed=0)
    return root, ids_j, ids_t


def test_generate_dataset_bytes_match(mini_world):
    root, ids_j, ids_t = mini_world
    assert ids_j == ids_t
    for sub in ("velodyne", "calib", "label_2"):
        names = sorted(os.listdir(root / "jax" / sub))
        assert names == sorted(os.listdir(root / "torch" / sub))
        _, bad, err = filecmp.cmpfiles(root / "jax" / sub,
                                       root / "torch" / sub, names,
                                       shallow=False)
        assert not bad and not err, (sub, bad, err)


def test_process_frame_matches_jax(mini_world):
    """One frame through the ETL: the same object files and metadata, the
    points within 1e-6 and the normals in |cos| within 1e-4 where
    well conditioned."""
    root, ids, _ = mini_world
    raw = str(root / "jax")
    args = [os.path.join(raw, s) for s in ("velodyne", "calib", "label_2")]
    out_j, out_t = root / "etl_jax", root / "etl_torch"
    cj, mj, ct, mt = {}, {}, {}, {}
    nj = jetl.process_frame(ids[0], *args, str(out_j), cj, mj,
                            seg_cfg=jworld.seg_config(),
                            rng=np.random.default_rng(0))
    nt = tetl.process_frame(ids[0], *args, str(out_t), ct, mt,
                            seg_cfg=tworld.seg_config(),
                            rng=np.random.default_rng(0), device="cpu",
                            sampler=jax_plane_sampler(jax.random.PRNGKey(0)))
    assert nt == nj >= 4
    assert ct == cj and mt == mj
    for cat in sorted(os.listdir(out_j)):
        names = sorted(os.listdir(out_j / cat))
        assert names == sorted(os.listdir(out_t / cat))
        for fn in names:
            a = np.loadtxt(out_j / cat / fn, delimiter=",", skiprows=1)
            b = np.loadtxt(out_t / cat / fn, delimiter=",", skiprows=1)
            assert a.shape == b.shape
            np.testing.assert_allclose(b[:, :3], a[:, :3], atol=1e-6)
            good = well_conditioned(a[:, :3]) if len(a) >= 9 else \
                np.zeros(len(a), bool)
            cos = np.abs(np.sum(a[:, 3:] * b[:, 3:], axis=1))
            np.testing.assert_allclose(cos[good], 1.0, atol=1e-4)


def test_extract_dataset_writes_metadata(mini_world, tmp_path):
    """The whole ETL on the port's CPU: every frame extracted, one
    metadata CSV a category seen."""
    root, ids, _ = mini_world
    stats = tetl.extract_dataset(str(root / "torch"), str(tmp_path),
                                 seg_cfg=tworld.seg_config(), device="cpu")
    assert stats.frames_ok == 2 and stats.frames_failed == 0
    assert stats.objects >= 8
    csvs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".csv"))
    assert csvs and "misc.csv" in csvs


def test_kitti_frames_match_jax():
    rng = np.random.default_rng(0)
    calib = {"P2": np.array([[700.0, 0, 600, 40], [0, 700, 180, 1],
                             [0, 0, 1, 0.003]]),
             "R0_rect": np.eye(3),
             "Tr_velo_to_cam": np.hstack([
                 np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float),
                 np.array([[0.1], [-0.05], [0.27]])])}
    X = rng.uniform(-10, 10, (50, 3))
    t = rng.normal(size=3)
    for fn, args in (("velo_to_cam", (X, calib)), ("cam_to_velo", (X, calib)),
                     ("cam_to_pixel", (X + [0, 0, 20], calib)),
                     ("ry_rotation", (0.7,)),
                     ("velo_to_obj", (X, calib, t, 0.3))):
        np.testing.assert_array_equal(getattr(tframes, fn)(*args),
                                      getattr(jframes, fn)(*args))


def test_trainset_files_match_jax(tmp_path):
    rng = np.random.default_rng(1)
    src = tmp_path / "extracted"
    for cat, n in [("vehicle", 3), ("misc", 6), ("pedestrian", 2),
                   ("cyclist", 2)]:
        os.makedirs(src / cat)
        for i in range(n):
            arr = rng.normal(size=(int(rng.integers(10, 40)), 6))
            arr[:, :2] *= 3.0
            np.savetxt(src / cat / f"{i:06d}.txt", arr.astype(np.float32),
                       delimiter=",", header="vx,vy,vz,nx,ny,nz",
                       comments="")
    cj = jtrainset.generate_training_set(str(src), str(tmp_path / "j"))
    ct = ttrainset.generate_training_set(str(src), str(tmp_path / "t"))
    assert ct == cj
    jtrainset.generate_train_test_split(str(tmp_path / "j"))
    ttrainset.generate_train_test_split(str(tmp_path / "t"))
    for cat in ("vehicle", "pedestrian", "cyclist", "misc"):
        names = sorted(os.listdir(tmp_path / "j" / cat))
        _, bad, err = filecmp.cmpfiles(tmp_path / "j" / cat,
                                       tmp_path / "t" / cat, names,
                                       shallow=False)
        assert names and not bad and not err, (cat, bad)
    for fn in ("object_names.txt", "train.txt", "test.txt"):
        assert filecmp.cmp(tmp_path / "j" / fn, tmp_path / "t" / fn,
                           shallow=False), fn


def test_analytics_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    for cat, n in [("vehicle", 30), ("misc", 50)]:
        with open(tmp_path / f"{cat}.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=["frame", "num_measurements",
                                              "vx", "vy", "vz", "type"])
            w.writeheader()
            for i in range(n):
                d, ang = rng.uniform(2, 40), rng.uniform(0, 2 * np.pi)
                w.writerow({"frame": f"{i:06d}",
                            "num_measurements": int(2000 / d),
                            "vx": d * np.cos(ang), "vy": d * np.sin(ang),
                            "vz": 0.5, "type": cat})
    meta_j = janalytics.load_metadata(str(tmp_path))
    meta_t = tanalytics.load_metadata(str(tmp_path))
    assert meta_t == meta_j
    assert (tanalytics.class_distribution(meta_t)
            == janalytics.class_distribution(meta_j))
    assert (tanalytics.distance_stats(meta_t)
            == janalytics.distance_stats(meta_j))
    out = tanalytics.plot_analytics(str(tmp_path), str(tmp_path / "plots"))
    assert out["class_distribution"] == {"vehicle": 30, "misc": 50}
    assert (tmp_path / "plots" / "points_vs_distance.png").exists()


def _voxel_cloud(seed=0, n=600):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    pts[::7] = pts[1::7][:len(pts[::7])]          # duplicated points
    mask = rng.uniform(size=n) > 0.15
    return pts, mask


def test_voxel_downsample_random_matches_jax():
    """JAX's own priorities (`randint` under the key) injected: the picks
    and masks equal."""
    pts, mask = _voxel_cloud()
    key = jax.random.PRNGKey(4)
    ref = jvoxel.voxel_downsample(jnp.asarray(pts), jnp.asarray(mask), 1.0,
                                  method="random", key=key)
    prio = np.array(jax.random.randint(key, (len(pts),), 0, 2**31 - 1,
                                         dtype=jnp.int32))
    ours = tvoxel.voxel_downsample(torch.from_numpy(pts),
                                   torch.from_numpy(mask), 1.0,
                                   method="random",
                                   prio=torch.from_numpy(prio.copy()))
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(ours.points.numpy(), np.asarray(ref.points))
    # every pick is a valid member of the cloud
    valid = pts[mask]
    picks = ours.points.numpy()[ours.mask.numpy()]
    assert all((np.abs(valid - p).sum(1) == 0).any() for p in picks)


def test_voxel_downsample_random_default_draw_repeats():
    pts, mask = _voxel_cloud(seed=1)
    a, b = (tvoxel.voxel_downsample(
        torch.from_numpy(pts), torch.from_numpy(mask), 0.7, method="random",
        generator=torch.Generator().manual_seed(3)) for _ in range(2))
    assert torch.equal(a.points, b.points) and torch.equal(a.mask, b.mask)
    c = tvoxel.voxel_downsample(torch.from_numpy(pts), torch.from_numpy(mask),
                                0.7)
    assert torch.equal(a.mask, c.mask)      # one pick a voxel, as centroids


def test_voxel_downsample_cloud_matches_jax():
    pts, mask = _voxel_cloud(seed=2)
    ref = jvoxel.voxel_downsample_cloud(
        JCloud(jnp.asarray(pts), jnp.asarray(mask)), 0.8)
    ours = tvoxel.voxel_downsample_cloud(
        PointCloud(torch.from_numpy(pts), torch.from_numpy(mask)), 0.8)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(ours.points.numpy(), np.asarray(ref.points),
                               atol=1e-6)


def test_voxel_downsample_batch_matches_jax():
    rng = np.random.default_rng(3)
    pts = rng.uniform(-4, 4, (2, 512, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, 512)) > 0.1
    ref = jvoxel.voxel_downsample_batch(jnp.asarray(pts), jnp.asarray(mask),
                                        1.0)
    ours = tvoxel.voxel_downsample_batch(torch.from_numpy(pts),
                                         torch.from_numpy(mask), 1.0)
    np.testing.assert_array_equal(ours.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_allclose(ours.points.numpy(), np.asarray(ref.points),
                               atol=1e-4)


def test_segmentation_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tetl.extract_dataset(str(tmp_path), str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tetl.process_frame("0", "v", "c", "l", str(tmp_path), {}, {})


def test_knn_chunks_keep_only_their_k_columns():
    """Fault C3: `ops/knn.py:_smallest` returned views of each chunk's
    whole sorted row block, so `knn` and `radius_search` held every
    chunk's sort alive until they returned (at the 124,668-point scan,
    122 chunks of 1.5 GB: out of memory on an 80 GB card). Its k columns
    now own their storage."""
    from pctpu_torch.ops.knn import _smallest
    d2 = torch.rand((64, 5000), generator=torch.Generator().manual_seed(0))
    d, i = _smallest(d2, 9)
    for t in (d, i):
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    ref_d, ref_i = torch.sort(d2, dim=1, stable=True)
    assert torch.equal(d, ref_d[:, :9]) and torch.equal(i, ref_i[:, :9])
