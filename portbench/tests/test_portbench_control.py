"""The control of the registration cells: the plain reference put in the
program's place with its matmul operands rounded to TF32 (the precision
below the configuration's float32), judged by the harness's own
comparison, comes out not correct, at a size a CPU test can hold. On the
card the same readings come from `portbench/control.py` at the cell's
own size."""
from portbench.common.harness import run_cell


def test_tf32_control_is_not_correct():
    res = run_cell("reg-b16-35deg", 2**31 + 5, 0.0, False, device="cpu",
                   traffic_overrides=dict(batch=2, pool_batches=1,
                                          warmup_calls=0, check_calls=1),
                   config_overrides=dict(scan_points=4096),
                   log=lambda m: None, control=True)
    assert not res["correct"], res["checks"]
    over = [k for k, c in res["checks"].items()
            if not c["value"] <= c["limit"]]
    assert over, res["checks"]
