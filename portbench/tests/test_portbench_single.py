"""The single-pair cell `reg-single-35deg` on the CPU at a small size
(4,096-point clouds; kernel 5 at 6 windowed and 2 exact iterations, so
that its windowed phase still moves when it ends, as it may not at 47):
sound it comes out correct; with the control in the program's place (the
reference with its matmul operands in TF32) and with a fault planted in
the timed path it comes out not correct, once for each of three faults:
kernel 5's windowed phase cut to half its iterations, the descriptors
altered where they are produced, and RANSAC's pose moved."""
import importlib

import pytest
import torch

from portbench.common.harness import cell_files, run_cell

CELL = "reg-single-35deg"
SMALL = dict(pool_pairs=1, warmup_calls=0, check_calls=1)
SMALL_CONFIG = dict(scan_points=4096, registration_config={
    **cell_files(CELL)[1]["registration_config"], "icp_fixed_coarse": 6,
    "icp_fixed_polish": 2})
PIPE = "pctpu_torch.register.pipeline"


def _run(control=False):
    return run_cell(CELL, 2**31 + 77, 0.0, False, device="cpu",
                    traffic_overrides=SMALL, config_overrides=SMALL_CONFIG,
                    log=lambda m: None, control=control)


def _half_coarse(fn):
    def icp(*args, coarse_iters, **kw):
        return fn(*args, coarse_iters=coarse_iters // 2, **kw)
    return icp


def _altered(fn):
    def fpfh(points, **kw):
        out = fn(points, **kw).clone()
        out[0] = torch.roll(out[0], 1)
        out[:, :11] = out[:, :11].flip(-1)
        return out
    return fpfh


def _moved_pose(fn):
    def ransac(*args, **kw):
        r = fn(*args, **kw)
        T = r.T.clone()
        T[0, 3] += 0.5
        return r._replace(T=T)
    return ransac


def test_sound_run_is_correct():
    res = _run()
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


def test_tf32_control_is_not_correct():
    res = _run(control=True)
    assert not res["correct"], res["checks"]


FAULTS = [("icp_fixed_iters_banded_mega", _half_coarse),
          ("fpfh", _altered),
          ("ransac_registration", _moved_pose)]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f.__name__.strip("_") for _, f in FAULTS])
def test_fault_is_not_correct(name, fault, monkeypatch):
    mod = importlib.import_module(PIPE)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    res = _run()
    assert not res["correct"], res["checks"]
