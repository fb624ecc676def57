"""The port's training loop and its pieces on the CPU: checkpoints (save,
prune, latest, restore), `fit` on the toy disk/column task of
`tests/test_fit.py` with resume, `ModelNet40Dataset` against the
reference's on a tiny layout written under tmp_path, the training CLI,
FPS with more picks than points against the reference, and the entry
points' device rule. Inputs come from numpy with a seed."""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pctpu.nn.data import ModelNet40Dataset as JModelNet40
from pctpu.ops.fps import fps as j_fps
from pctpu_torch.nn import checkpoint as ckpt
from pctpu_torch.nn import fit as F
from pctpu_torch.nn import train as T
from pctpu_torch.nn import train_cli
from pctpu_torch.nn.config import TrainConfig
from pctpu_torch.nn.data import ModelNet40Dataset
from pctpu_torch.ops import pallas_fps


class ToyPointDataset:
    """Two easily separable classes: flat disks vs tall columns (the toy
    task of `tests/test_fit.py:9-31`)."""

    def __init__(self, n=32, num_points=128, seed=0):
        rng = np.random.default_rng(seed)
        self.items = []
        for i in range(n):
            label = i % 2
            pts = np.zeros((num_points, 6), np.float32)
            if label == 0:
                pts[:, :2] = rng.uniform(-1, 1, (num_points, 2))
                pts[:, 2] = rng.normal(scale=0.02, size=num_points)
            else:
                pts[:, 2] = rng.uniform(-1, 1, num_points)
                pts[:, :2] = rng.normal(scale=0.05, size=(num_points, 2))
            pts[:, 3:] = rng.normal(scale=0.1, size=(num_points, 3))
            self.items.append((pts, label))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


TOY = TrainConfig(model="cls-ssg", num_classes=2, num_points=128,
                  batch_size=8, epochs=3, lr=1e-3, decay_step=1e9)


def test_checkpoint_round_trip(tmp_path):
    """save -> latest -> restore gives back parameters, BN statistics,
    moments and step; only the newest `keep` checkpoints stay."""
    cfg = TrainConfig(model="cls-ssg", num_classes=4, batch_size=2)
    pc = np.random.default_rng(0).normal(size=(2, 128, 6)).astype(np.float32)
    model, state = T.create_train_state(
        cfg, torch.Generator().manual_seed(1), pc, device="cpu")
    step = T.make_train_step(model, cfg, device="cpu")
    wd = str(tmp_path / "run")
    for s in (1, 2, 3):
        step(state, pc, np.array([0, 3]), torch.Generator().manual_seed(s))
        path = ckpt.save_checkpoint(wd, state, s, keep=2)
    assert sorted(os.listdir(wd)) == ["ckpt_00000002", "ckpt_00000003"]
    assert ckpt.latest_checkpoint(wd) == (path, 3)
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None
    _, fresh = T.create_train_state(cfg, torch.Generator().manual_seed(9),
                                    pc, device="cpu")
    ckpt.restore_checkpoint(path, fresh)
    assert fresh.step == 3 and fresh.opt_state.count == 3
    want = state.model.state_dict()
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    for a, b in zip(fresh.opt_state.mu + fresh.opt_state.nu,
                    state.opt_state.mu + state.opt_state.nu):
        assert torch.equal(a, b)


def test_fit_toy_task_and_resume(tmp_path):
    """One epoch of `fit` on device='cpu' (2 steps, the default
    augmentation on) writes a checkpoint at its best val accuracy,
    train.log and metrics.jsonl; a resumed run starts at epoch 1 from
    that checkpoint and trains one more epoch."""
    import dataclasses
    train, val = ToyPointDataset(n=16, seed=0), ToyPointDataset(n=8, seed=1)
    wd = str(tmp_path / "run")
    out = F.fit(dataclasses.replace(TOY, epochs=1), train, val, workdir=wd,
                device="cpu")
    assert out["steps"] == 2 and out["state"].step == 2
    assert 0.0 <= out["best_val_acc"] <= 1.0 and out["best_epoch"] == 0
    assert ckpt.latest_checkpoint(wd)[1] == 1
    recs = [json.loads(x) for x in open(os.path.join(wd, "metrics.jsonl"))]
    assert [r["epoch"] for r in recs] == [0] and "val_acc" in recs[0]
    assert "epoch 0:" in open(os.path.join(wd, "train.log")).read()
    out2 = F.fit(dataclasses.replace(TOY, epochs=2), train, val, workdir=wd,
                 resume=True, augment_pipeline=(), device="cpu")
    assert out2["steps"] == 2 and out2["state"].step == 4
    assert "resumed from" in open(os.path.join(wd, "train.log")).read()
    recs = [json.loads(x) for x in open(os.path.join(wd, "metrics.jsonl"))]
    assert [r["epoch"] for r in recs] == [0, 1]


def test_fit_max_steps_and_step_generators():
    """max_steps stops mid-epoch; the per-step generators are a function
    of (seed, step, stream) alone."""
    out = F.fit(TOY, ToyPointDataset(n=16), None, max_steps=1, device="cpu")
    assert out["steps"] == 1 and out["best_val_acc"] == -1.0
    a = F.step_generator(0, 5, 0, torch.device("cpu"))
    b = F.step_generator(0, 5, 0, torch.device("cpu"))
    c = F.step_generator(0, 5, 1, torch.device("cpu"))
    ra, rb, rc = (torch.rand(4, generator=g) for g in (a, b, c))
    assert torch.equal(ra, rb) and not torch.equal(ra, rc)


def _modelnet_layout(root, rng):
    cats = ["chair", "table_lamp"]
    os.makedirs(root)
    with open(os.path.join(root, "modelnet40_shape_names.txt"), "w") as f:
        f.write("\n".join(cats) + "\n")
    ids = {"train": [], "test": []}
    for c in cats:
        os.makedirs(os.path.join(root, c))
        for i in range(3):
            sid = f"{c}_{i + 1:04d}"
            rows = rng.normal(size=(rng.integers(40, 90), 6))
            np.savetxt(os.path.join(root, c, sid + ".txt"), rows,
                       delimiter=",", fmt="%.6f")
            ids["train" if i < 2 else "test"].append(sid)
    for split, names in ids.items():
        with open(os.path.join(root, f"modelnet40_{split}.txt"), "w") as f:
            f.write("\n".join(names) + "\n")


@pytest.mark.parametrize("cache", [True, False])
def test_modelnet40_dataset_matches_jax(tmp_path, cache):
    """Items (cloud and label), categories and length equal the
    reference's on the same layout and seed, with the on-disk cache built
    and then reused, and without it; a shape with fewer rows than
    num_points repeats its permutation."""
    root = str(tmp_path / "mn40")
    _modelnet_layout(root, np.random.default_rng(3))
    for train in (True, False):
        for _ in range(2):      # the second pass reads the cache
            ours = ModelNet40Dataset(root, num_points=64, train=train,
                                     cache=cache, seed=2)
            ref = JModelNet40(root, num_points=64, train=train, cache=cache,
                              seed=2)
            assert len(ours) == len(ref) == (4 if train else 2)
            assert ours.categories == ref.categories
            for i in range(len(ours)):
                (a, la), (b, lb) = ours[i], ref[i]
                assert la == lb and a.shape == (64, 6)
                np.testing.assert_array_equal(a, b)


def test_train_cli(tmp_path, monkeypatch):
    """task=cls model=msg with key=value overrides trains through `fit`
    on device=cpu; task=semseg and task=kitti hand `fit` their presets
    and datasets (S3DIS HDF5 and KITTI CSV layouts written here);
    mode=test reports on the test split; an unknown key exits."""
    root = str(tmp_path / "mn40")
    _modelnet_layout(root, np.random.default_rng(4))
    seen = {}

    def fake_fit(cfg, train_ds, val_ds, **kw):
        seen.update(cfg=cfg, n=len(train_ds), **kw)
        return {"best_val_acc": 0.5, "best_epoch": 0}
    monkeypatch.setattr(train_cli, "fit", fake_fit)
    train_cli.main(["task=cls", "model=msg", f"data={root}", "epochs=2",
                    "lr=0.01", "use_xyz=false", "device=cpu",
                    f"workdir={tmp_path / 'w'}"])
    assert seen["cfg"].model == "cls-msg" and seen["cfg"].epochs == 2
    assert seen["cfg"].lr == 0.01 and seen["cfg"].use_xyz is False
    assert seen["device"] == "cpu" and seen["n"] == 4
    s3dis, kitti = str(tmp_path / "s3dis"), str(tmp_path / "kitti")
    rng = np.random.default_rng(5)
    _s3dis_layout(s3dis)
    _kitti_layout(kitti, rng)
    train_cli.main(["task=semseg", f"data={s3dis}", "device=cpu"])
    assert seen["cfg"].model == "semseg-ssg" and seen["n"] == 2
    assert seen["cfg"].num_classes == 13 and seen["cfg"].batch_size == 24
    train_cli.main(["task=kitti", "model=msg", f"data={kitti}",
                    "device=cpu"])
    assert seen["cfg"].model == "cls-msg" and seen["n"] == 4
    assert seen["cfg"].num_points == 64 and seen["cfg"].grad_clip == 1.0
    rep = train_cli.main(["task=cls", "mode=test", f"data={root}",
                          "device=cpu", "batch_size=2", "num_points=64",
                          "num_classes=2", f"workdir={tmp_path / 'none'}"])
    assert rep["confusion_matrix"].shape == (2, 2)
    assert rep["confusion_matrix"].sum() == 2
    with pytest.raises(SystemExit, match="unknown config key"):
        train_cli.main(["task=cls", f"data={root}", "nope=1"])


def _s3dis_layout(root):
    """One HDF5 file of 4 blocks [4, 32, 9], the last two Area_5's."""
    import h5py
    os.makedirs(root)
    rng = np.random.default_rng(3)
    with h5py.File(os.path.join(root, "ply_data_all_0.h5"), "w") as h:
        h["data"] = rng.uniform(size=(4, 32, 9)).astype(np.float32)
        h["label"] = rng.integers(0, 13, (4, 32)).astype(np.uint8)
    with open(os.path.join(root, "all_files.txt"), "w") as f:
        f.write("indoor3d_sem_seg_hdf5_data/ply_data_all_0.h5\n")
    with open(os.path.join(root, "room_filelist.txt"), "w") as f:
        f.write("Area_1_a\nArea_2_b\nArea_5_c\nArea_5_d\n")


def _kitti_layout(root, rng):
    """Four 64 x 6 CSV clouds a split, one per category."""
    cats = ["Car", "Pedestrian", "Cyclist", "Misc"]
    for c in cats:
        os.makedirs(os.path.join(root, c))
    with open(os.path.join(root, "object_names.txt"), "w") as f:
        f.write("\n".join(cats) + "\n")
    for split, base in (("train", 0), ("test", 10)):
        for i, c in enumerate(cats):
            np.savetxt(os.path.join(root, c, f"{base + i:06d}.txt"),
                       rng.normal(size=(64, 6)), delimiter=",")
        with open(os.path.join(root, f"{split}.txt"), "w") as f:
            f.write("\n".join(f"{c}_{base + i}"
                              for i, c in enumerate(cats)) + "\n")


@pytest.mark.parametrize("n,m", [(128, 512), (5, 9)])
def test_fps_more_picks_than_points_matches_jax(rng, n, m):
    """With m > N (the toy task's 128 points at SA1's npoint 512) the
    reference repeats its selections: every point once, then index 0
    (all distances 0, the first index wins). Kernel 11's plain version
    gives the same idx."""
    pts = rng.uniform(-1, 1, (2, n, 3)).astype(np.float32)
    ours = pallas_fps.fps_pallas_batched(torch.from_numpy(pts), m)
    for b in range(2):
        ref = np.asarray(j_fps(jnp.asarray(pts[b]), m))
        np.testing.assert_array_equal(ours[b].numpy(), ref)
        assert sorted(set(ref[:n].tolist())) == list(range(n))
        assert (ref[n:] == 0).all()


def test_training_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    """No silent CPU fallback: without a card, create_train_state,
    make_train_step, fit and the CLI raise unless given device='cpu'."""
    model, _ = T.create_train_state(TOY, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.create_train_state(TOY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.make_train_step(model, TOY)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        F.fit(TOY, ToyPointDataset(n=8), None)
    root = str(tmp_path / "mn40")
    _modelnet_layout(root, np.random.default_rng(5))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["task=cls", f"data={root}",
                        f"workdir={tmp_path / 'w'}"])
