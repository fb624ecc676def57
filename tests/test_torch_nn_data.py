"""The rest of the training CLI's pieces against the JAX package, on the
CPU: `S3DISDataset` and `KITTIResampledDataset` on tiny HDF5 and CSV
layouts the tests write, `distance_weighted_resample`, the confusion
matrix against sklearn's, `test_report` with its heatmap, the CLI's
`task=semseg` (train, checkpoint, then `mode=test` against the
reference's `test_report` on the same weights and data) and `task=kitti`
(whose `cls-msg` preset asks FPS for 512 picks of 64 points: kernel 11's
plain version against the reference at that shape), and the leftovers
`quat_to_rotmat`, `tq_to_transform` and `mask_group`. Inputs come from
numpy with a seed."""
import torch_threads as _torch_threads  # noqa: F401

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict
from sklearn.metrics import confusion_matrix as sk_confusion_matrix

from pctpu.core import se3 as jse3
from pctpu.nn import data as jdata
from pctpu.nn import fit as jfit
from pctpu.nn import train as JT
from pctpu.nn.config import TrainConfig as JConfig
from pctpu.ops import gather as jgather
from pctpu.ops.ball_query import ball_query as j_ball_query
from pctpu.ops.fps import fps_batched as j_fps_batched
from pctpu_torch.core import se3 as tse3
from pctpu_torch.models import convert
from pctpu_torch.nn import checkpoint as ckpt
from pctpu_torch.nn import config as tconfig
from pctpu_torch.nn import data as tdata
from pctpu_torch.nn import fit as F
from pctpu_torch.nn import train as T
from pctpu_torch.nn import train_cli
from pctpu_torch.ops import gather as tgather
from pctpu_torch.ops import pallas_ballgroup, pallas_fps
from pctpu_torch.ops.ball_query import ball_query


def _s3dis_layout(root, rng, blocks=(3, 3), points=256):
    """Two HDF5 files of indoor-style blocks [k, points, 9] and 13-class
    labels; the second file's rooms are Area_5's (the test split)."""
    os.makedirs(root)
    files, rooms = [], []
    for f, k in enumerate(blocks):
        data = rng.uniform(size=(k, points, 9)).astype(np.float32)
        label = rng.integers(0, 13, (k, points)).astype(np.uint8)
        with h5py.File(os.path.join(root, f"ply_data_all_{f}.h5"), "w") as h:
            h["data"], h["label"] = data, label
        files.append(f"indoor3d_sem_seg_hdf5_data/ply_data_all_{f}.h5")
        rooms += [f"Area_{5 if f else 1}_office_{i}" for i in range(k)]
    for name, lines in (("all_files.txt", files),
                        ("room_filelist.txt", rooms)):
        with open(os.path.join(root, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")


def _kitti_layout(root, rng, per_split=8):
    """object_names.txt, train.txt / test.txt rows `{category}_{idx}` and
    64 x 6 CSV clouds at <category>/{idx:06d}.txt."""
    cats = ["Car", "Pedestrian", "Cyclist", "Misc"]
    os.makedirs(root)
    with open(os.path.join(root, "object_names.txt"), "w") as f:
        f.write("\n".join(cats) + "\n")
    for c in cats:
        os.makedirs(os.path.join(root, c))
    for split in ("train", "test"):
        rows = []
        for i in range(per_split):
            c, idx = cats[i % 4], (i + (100 if split == "test" else 0))
            np.savetxt(os.path.join(root, c, f"{idx:06d}.txt"),
                       rng.normal(size=(64, 6)), delimiter=",", fmt="%.6f")
            rows.append(f"{c}_{idx}")
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(rows) + "\n")


@pytest.mark.parametrize("train", [True, False])
def test_s3dis_dataset_matches_jax(tmp_path, train):
    """Split (Area_5 held out), length and every item (a seeded
    permutation's first num_points: cloud and labels) equal the
    reference's, item after item from the same generator."""
    root = str(tmp_path / "s3dis")
    _s3dis_layout(root, np.random.default_rng(1))
    ours = tdata.S3DISDataset(root, num_points=100, train=train, seed=3)
    ref = jdata.S3DISDataset(root, num_points=100, train=train, seed=3)
    assert len(ours) == len(ref) == 3
    for i in [0, 1, 2, 0]:
        (a, la), (b, lb) = ours[i], ref[i]
        assert a.shape == (100, 9) and a.dtype == np.float32
        assert la.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(la, lb)


def test_kitti_dataset_and_resample_match_jax(tmp_path):
    """KITTIResampledDataset: categories, items and labels equal the
    reference's; distance_weighted_resample equals it draw for draw (down-
    and upsampling, with an extra payload, and a cloud of one repeated
    point, whose weights are uniform)."""
    root = str(tmp_path / "kitti")
    _kitti_layout(root, np.random.default_rng(2))
    for split in ("train.txt", "test.txt"):
        ours = tdata.KITTIResampledDataset(root, split)
        ref = jdata.KITTIResampledDataset(root, split)
        assert ours.categories == ref.categories and len(ours) == len(ref)
        for i in range(len(ours)):
            (a, la), (b, lb) = ours[i], ref[i]
            assert la == lb and a.shape == (64, 6)
            np.testing.assert_array_equal(a, b)
    pts = np.random.default_rng(3).normal(size=(40, 3))
    extra = np.arange(40)
    for num, x, e in ((16, pts, None), (64, pts, extra),
                      (8, np.ones((5, 3)), None)):
        got = tdata.distance_weighted_resample(
            x, num, np.random.default_rng(4), e)
        want = jdata.distance_weighted_resample(
            x, num, np.random.default_rng(4), e)
        for g, w in zip(got if e is not None else (got,),
                        want if e is not None else (want,)):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("ids", [None, list(range(6)), [4, 1, 2]])
def test_confusion_matrix_equals_sklearn(ids):
    """The numpy count equals sklearn's confusion_matrix (values, shape,
    dtype), with explicit ids (a class absent from both, an order of its
    own, classes outside the ids dropped) and without."""
    rng = np.random.default_rng(5)
    labels, preds = rng.integers(0, 5, 400), rng.integers(0, 5, 400)
    got = F.confusion_matrix(labels, preds, ids)
    want = sk_confusion_matrix(labels, preds, labels=ids)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype and got.shape == want.shape


def test_test_report_renders_and_keeps_absent_classes(tmp_path):
    """test_report on a tiny classifier run: the matrix has one row per
    class name though the split holds two of them, sums to the points
    seen, and the heatmap PNG is written."""
    model = T.build_model(tconfig.TrainConfig(num_classes=4), device="cpu")
    rng = np.random.default_rng(6)
    ds = [(rng.normal(size=(128, 6)).astype(np.float32), i % 2)
          for i in range(4)]
    png = str(tmp_path / "cm" / "heat.png")
    rep = F.test_report(model, ds, 2, class_names=["a", "b", "c", "d"],
                        heatmap_path=png, device="cpu")
    assert rep["confusion_matrix"].shape == (4, 4)
    assert rep["confusion_matrix"].sum() == 4
    assert "a" in rep["report"] and os.path.getsize(png) > 0


def _flax_from_port(model, jm, pc):
    """The port model's weights as flax variables of the JAX model `jm`
    (names from `jax.eval_shape` of its init), through the converter's
    name map."""
    shapes = jax.eval_shape(lambda x: jm.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(0)},
        x, train=True), jnp.asarray(pc))
    sd = model.state_dict()
    tree = {}
    for name in flatten_dict(dict(shapes), sep="/"):
        key, transpose = convert.torch_name(name)
        v = sd[key].numpy()
        tree[tuple(name.split("/"))] = jnp.asarray(v.T if transpose else v)
    return unflatten_dict(tree)


def test_cli_semseg_trains_checkpoints_and_reports_like_jax(tmp_path,
                                                             capsys):
    """`task=semseg model=ssg device=cpu epochs=1` on a tiny HDF5 layout
    trains a step and checkpoints; `mode=test` restores it and prints a
    confusion matrix equal to the reference's `test_report` on the same
    weights and data."""
    root, work = str(tmp_path / "s3dis"), str(tmp_path / "w")
    _s3dis_layout(root, np.random.default_rng(7), blocks=(2, 2))
    common = ["task=semseg", "model=ssg", f"data={root}", "device=cpu",
              "batch_size=2", "num_points=128", f"workdir={work}"]
    out = train_cli.main(common + ["epochs=1"])
    assert out["steps"] == 1 and out["state"].step == 1
    latest = ckpt.latest_checkpoint(work)
    assert latest is not None and latest[1] == 1
    capsys.readouterr()
    rep = train_cli.main(common + ["mode=test"])
    printed = capsys.readouterr().out
    assert str(rep["confusion_matrix"]) in printed
    assert rep["report"] in printed

    cfg = tconfig.TrainConfig(model="semseg-ssg", num_classes=13)
    model = T.build_model(cfg, device="cpu")
    model.load_state_dict(torch.load(os.path.join(latest[0], ckpt.STATE_FILE),
                                     weights_only=True)["model"])
    jm = JT.build_model(JConfig(model="semseg-ssg", num_classes=13))
    ds = jdata.S3DISDataset(root, num_points=128, train=False)
    variables = _flax_from_port(model, jm, ds.data[:2, :128])
    ds[0]           # the CLI's sample input draws one permutation first
    state = JT.TrainState(variables["params"], variables["batch_stats"],
                          None, jnp.int32(0))
    ref = jfit.test_report(jm, state, ds, 2)
    np.testing.assert_array_equal(rep["confusion_matrix"],
                                  ref["confusion_matrix"])
    assert rep["report"] == ref["report"]


def test_cli_kitti_trains_cls_msg_on_64_points(tmp_path):
    """`task=kitti model=msg device=cpu epochs=1 batch_size=2`: the preset
    (cls-msg, 4 classes, 64 points, grad clip 1; batch cut from 8 to 2)
    trains a step on the CSV layout and checkpoints, its SA1 asking FPS
    for 512 picks of 64."""
    root, work = str(tmp_path / "kitti"), str(tmp_path / "w")
    _kitti_layout(root, np.random.default_rng(8), per_split=2)
    calls = []
    real = pallas_fps.fps_plain

    def counting(points, m, eligible):
        calls.append((points.shape[1], m))
        return real(points, m, eligible)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_fps, "fps_plain", counting)
        out = train_cli.main(["task=kitti", "model=msg", f"data={root}",
                              "device=cpu", "epochs=1", "batch_size=2",
                              f"workdir={work}"])
    assert out["steps"] == 1 and np.isfinite(out["best_val_acc"])
    assert (64, 512) in calls and ckpt.latest_checkpoint(work)[1] == 1


def test_fps_more_picks_than_points_at_the_kitti_shape():
    """Kernel 11's plain version at [2, 64, 3], m = 512 == the reference's
    fps_batched: all 64 points, then index 0 for every later pick. SA1's
    nsample-128 scale then asks `ball_query` for 128 of 64 points: the
    slots past the hits repeat the first, as kernel 12's plain version
    gives them (the reference's `ball_query` raises at nsample > N)."""
    pts = np.random.default_rng(9).normal(size=(2, 64, 3)).astype(
        np.float32)
    ours = pallas_fps.fps_pallas_batched(torch.from_numpy(pts), 512).numpy()
    ref = np.asarray(j_fps_batched(jnp.asarray(pts), 512))
    np.testing.assert_array_equal(ours, ref)
    for b in range(2):
        assert sorted(ours[b, :64]) == list(range(64))
        assert (ours[b, 64:] == 0).all()
    p = torch.from_numpy(pts)
    centers = tgather.gather_points(p, torch.from_numpy(ours))
    idx, valid = ball_query(centers, p, 0.8, 128)
    _, want = pallas_ballgroup.ball_group_plain(centers, p, 0.8, 128)
    assert torch.equal(idx, want) and not valid[..., 64:].any()
    with pytest.raises(ValueError, match="top_k"):
        j_ball_query(jnp.asarray(pts[0]), jnp.asarray(pts[0]), 0.8, 128)


def test_quaternion_helpers_and_mask_group_match_jax():
    """quat_to_rotmat (unnormalised input) and tq_to_transform within
    1e-6 of the reference's; mask_group equal, with its fill."""
    rng = np.random.default_rng(10)
    q = rng.normal(size=(5, 4)).astype(np.float32) * 3.0
    t = rng.normal(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tse3.quat_to_rotmat(torch.from_numpy(q)).numpy(),
        np.asarray(jse3.quat_to_rotmat(jnp.asarray(q))), atol=1e-6)
    T_ = tse3.tq_to_transform(torch.from_numpy(t), torch.from_numpy(q))
    np.testing.assert_allclose(T_.numpy(), np.asarray(jse3.tq_to_transform(
        jnp.asarray(t), jnp.asarray(q))), atol=1e-6)
    _, q2 = tse3.transform_to_tq(T_)
    np.testing.assert_allclose(np.abs((q2.numpy() * q).sum(-1)),
                               np.linalg.norm(q, axis=-1), rtol=1e-5)
    g = rng.normal(size=(2, 7, 5, 3)).astype(np.float32)
    valid = rng.uniform(size=(2, 7, 5)) > 0.4
    for fill in (0.0, -1.5):
        np.testing.assert_array_equal(
            tgather.mask_group(torch.from_numpy(g), torch.from_numpy(valid),
                               fill).numpy(),
            np.asarray(jgather.mask_group(jnp.asarray(g), jnp.asarray(valid),
                                          fill)))
