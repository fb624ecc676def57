"""Runs of the registration cells on the CPU at a small size, past the
look for a card: sound they come out correct, and with the timed path
broken underneath they come out not correct, once for each fault the
cells can have: a step that returns its state unchanged (the voxel ICP,
the refine), half of the batch left out (its answers taken from the
other half), and an answer altered where it is produced. (The cells run
on one chip, so no exchange between chips can be left out.)"""
import importlib

import pytest
import torch

from portbench.common.harness import run_cell

SMALL = {"reg-b16-35deg": dict(batch=2, pool_batches=1, warmup_calls=0,
                               check_calls=1),
         "reg-b64-35deg": dict(batch=2, pool_batches=1, warmup_calls=0,
                               check_calls=1)}
SMALL_CONFIG = dict(scan_points=4096)
PIPE = "pctpu_torch.register.pipeline"


def _run(cell):
    return run_cell(cell, 2**31 + 77, 0.0, False, device="cpu",
                    traffic_overrides=SMALL[cell],
                    config_overrides=SMALL_CONFIG, log=lambda m: None)


def _unchanged(fn):
    def icp(src, src_mask, dst, dst_mask, init_T=None, **kw):
        return init_T.float().clone()
    return icp


def _unchanged_refine(fn):
    def refine(T, src, dst, cfg):
        return T.clone()
    return refine


def _half_batch(fn):
    def ransac(src, dst, valid, sampler, **kw):
        h = src.shape[0] // 2
        r = fn(src[:h], dst[:h], valid[:h], sampler, **kw)
        return type(r)(*(torch.cat([f, f]) for f in r))
    return ransac


def _altered(fn):
    def fpfh(points, **kw):
        out = fn(points, **kw).clone()
        out[..., 0, :] = torch.roll(out[..., 0, :], 1, dims=-1)
        out[..., :11] = out[..., :11].flip(-1)
        return out
    return fpfh


def _altered_pose(fn):
    def refine(T, src, dst, cfg):
        out = fn(T, src, dst, cfg).clone()
        out[0, 0, 3] += 0.05
        return out
    return refine


@pytest.fixture(scope="module", params=sorted(SMALL))
def sound(request):
    return request.param, _run(request.param)


def test_sound_run_is_correct(sound):
    cell, res = sound
    assert res["correct"], res["checks"]
    assert res["failed"] == 0


FAULTS = [
    ("reg-b16-35deg", PIPE, "icp_fixed_iters_banded_mega_batch", _unchanged),
    ("reg-b16-35deg", PIPE, "ransac_registration_batch", _half_batch),
    ("reg-b16-35deg", PIPE, "fpfh_fused", _altered),
    ("reg-b16-35deg", PIPE, "_refine_exact_batch", _altered_pose),
    ("reg-b16-35deg", PIPE, "_refine_exact_batch", _unchanged_refine)]


@pytest.mark.parametrize("cell,module,name,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}"
                              for c, _, _, f in FAULTS])
def test_fault_is_not_correct(cell, module, name, fault, monkeypatch):
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, fault(getattr(mod, name)))
    res = _run(cell)
    assert not res["correct"], res["checks"]
