"""The ISS cell `reg-iss-b16` on the CPU at a small size (2 pairs of
8,192-point clouds, the fewest whose voxel clouds gamma21 at 0.9 moves
by over 1%): sound it comes out correct; with the control in the
program's place (the reference with its matmul operands in TF32) and
with a fault planted in the ISS stage of the timed path it comes out not
correct, once for each of three faults: gamma21 at 0.9, the NMS radius
halved, and every voxel taken as a site. The reference of the cell
imports nothing of the program."""
import ast
import importlib

import pytest

from portbench.common.harness import BENCH_DIR, run_cell

CELL = "reg-iss-b16"
SMALL = dict(batch=2, pool_batches=1, warmup_calls=0, check_calls=1)
SMALL_CONFIG = dict(scan_points=8192)
PIPE = "pctpu_torch.register.pipeline"


def _run(control=False):
    return run_cell(CELL, 2**31 + 79, 0.0, False, device="cpu",
                    traffic_overrides=SMALL, config_overrides=SMALL_CONFIG,
                    log=lambda m: None, control=control)


def _gamma_09(fn):
    def iss_keypoints(points, **kw):
        return fn(points, **kw, gamma_21=0.9)
    return iss_keypoints


def _nms_halved(fn):
    def iss_keypoints(points, **kw):
        return fn(points, **{**kw, "non_max_radius":
                             kw["non_max_radius"] / 2})
    return iss_keypoints


def _every_voxel(fn):
    def keypoint_sites(down, cfg):
        return down.mask
    return keypoint_sites


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0
    assert res["checks"]["site_gap"]["value"] == 0.0


def test_tf32_control_is_not_correct():
    res = _run(control=True)
    assert not res["correct"], res["checks"]
    assert res["checks"]["site_gap"]["value"] > res["checks"]["site_gap"][
        "limit"]


FAULTS = [("iss_keypoints", _gamma_09), ("iss_keypoints", _nms_halved),
          ("keypoint_sites", _every_voxel)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    mod = importlib.import_module(PIPE)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    res = _run()
    assert not res["correct"], res["checks"]
    assert res["checks"]["site_gap"]["value"] > res["checks"]["site_gap"][
        "limit"]


def test_reference_imports_nothing_of_the_program():
    path = BENCH_DIR / "reference" / "reg-hdl64-iss.py"
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert tops and not tops & {"pctpu_torch", "pctpu", "jax"}, tops
