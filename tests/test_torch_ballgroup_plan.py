"""How kernel 12 (`csrc/ballgroup.cu`) shapes a launch: `ball_group_plan`
in `pctpu_torch/ops/pallas_ballgroup.py`, which the kernel's C entry
checks and follows. It runs here without a card; the kernel itself is
held against `ball_group_plain` in tests/test_torch_cuda.py in both of
the plan's modes."""
import torch_threads as _torch_threads  # noqa: F401

import pytest

from pctpu_torch.ops.pallas_ballgroup import (CTA_RESERVED, MODES,
                                              SCAN_STEP, SM_THREADS,
                                              SMEM_BLOCK, SMEM_SM,
                                              THREADS_MAX, THREADS_MIN,
                                              ball_group_plan)

H100_SMS = 132

# chip_smoke.py's launches: (B, M, N, C, K) -> (threads, centres a CTA)
PATH_SHAPES = {
    (32, 512, 4096, 6, 16): (1024, 64),    # P7 cls-msg SA1, r 0.1
    (32, 512, 4096, 6, 32): (1024, 64),    # r 0.2
    (32, 512, 4096, 6, 128): (1024, 64),   # r 0.4
    (32, 128, 512, 323, 32): (1024, 32),   # P7 SA2
    (32, 512, 4096, 6, 64): (1024, 64),    # P8 cls-ssg SA1
    (32, 128, 512, 131, 64): (1024, 32),   # P8 SA2
    (4, 512, 1024, 6, 16): (512, 16),      # P9 entry(), B 4 x 1,024
    (4, 512, 1024, 6, 128): (512, 16),
    (4, 128, 512, 323, 32): (128, 4),      # P9 SA2
    (8, 512, 128, 6, 32): (1024, 32),      # P12's toy cls-ssg SA1, N < M
    (8, 128, 512, 131, 64): (256, 8),      # P12's toy SA2
}
# shapes around the plan's limits: (B, M, N, C, K)
EDGE_SHAPES = [(1, 1, 1, 3, 1), (1, 7, 5, 3, 16), (3, 1001, 700, 7, 3),
               (2, 33, 128, 4, 8), (1, 4096, 13000, 3, 32),
               (2, 100, 20000, 6, 32), (64, 2048, 8192, 10, 64)]


def _round_up(x, k):
    return -(-x // k) * k


@pytest.mark.parametrize("shape", list(PATH_SHAPES))
def test_plan_at_the_paths_shapes(shape):
    """Every path's launch keeps its cloud in shared memory, within a
    block's 232,448 bytes, with 16-byte stores (K * C % 4 == 0 at every
    path shape), in one wave of the card."""
    b, m, n, c, k = shape
    plan = ball_group_plan(*shape, H100_SMS)
    assert (plan["threads"], plan["centres"]) == PATH_SHAPES[shape]
    assert plan["mode"] == "shared" and plan["store_bytes"] == 16
    assert plan["smem_bytes"] <= SMEM_BLOCK == 232448
    assert plan["smem_bytes"] >= _round_up(n, SCAN_STEP) * 16
    resident = min(SM_THREADS // plan["threads"],
                   SMEM_SM // (plan["smem_bytes"] + CTA_RESERVED))
    assert plan["ctas"] == b * plan["ctas_per_cloud"]
    assert plan["ctas"] <= resident * H100_SMS


@pytest.mark.parametrize("shape", list(PATH_SHAPES) + EDGE_SHAPES)
def test_every_centre_falls_in_exactly_one_cta(shape):
    b, m, n, c, k = shape
    plan = ball_group_plan(*shape, H100_SMS)
    for mode in MODES:
        p = ball_group_plan(*shape, H100_SMS, mode=mode)
        if p is None:
            continue
        seen = []
        for cta in range(p["ctas_per_cloud"]):
            chunk = range(cta * p["centres"],
                          min(m, (cta + 1) * p["centres"]))
            assert len(chunk) > 0                  # no idle CTA
            seen.extend(chunk)
        assert sorted(seen) == list(range(m))     # each centre once
        assert p["ctas"] == b * p["ctas_per_cloud"]
    t = plan["threads"]
    assert t % 32 == 0 and THREADS_MIN <= t <= THREADS_MAX
    assert t & (t - 1) == 0


@pytest.mark.parametrize("shape", list(PATH_SHAPES) + EDGE_SHAPES)
def test_shared_mode_stays_within_a_block(shape):
    b, m, n, c, k = shape
    plan = ball_group_plan(*shape, H100_SMS)
    slots = plan["threads"] // 32 * k * 4
    cloud = _round_up(n, SCAN_STEP) * 16
    if plan["mode"] == "shared":
        assert plan["smem_bytes"] <= SMEM_BLOCK
        assert plan["smem_bytes"] >= cloud + slots
    else:
        assert cloud + slots > SMEM_BLOCK
        assert plan["smem_bytes"] < cloud


@pytest.mark.parametrize("n,mode", [(4096, "shared"), (14400, "shared"),
                                    (14600, "global"), (20000, "global")])
def test_global_mode_past_the_shared_limit(n, mode):
    """About 14,500 points of 16 bytes fit a block beside 4 warps' slots
    (13,500 beside 32 warps' of nsample 128); past that the cloud is read
    from device memory, and "shared" is refused."""
    plan = ball_group_plan(2, 256, n, 6, 32, H100_SMS)
    assert plan["mode"] == mode
    forced = ball_group_plan(2, 256, n, 6, 32, H100_SMS, mode="shared")
    assert (forced is None) == (mode == "global")
    glob = ball_group_plan(2, 256, n, 6, 32, H100_SMS, mode="global")
    assert glob["mode"] == "global"
    assert glob["smem_bytes"] < _round_up(n, SCAN_STEP) * 16


@pytest.mark.parametrize("c,k", [(6, 16), (323, 32), (131, 64), (5, 3),
                                 (3, 1), (3, 4), (7, 2), (4, 1), (5, 8)])
def test_16_byte_stores_exactly_where_k_c_is_a_multiple_of_4(c, k):
    for mode in MODES:
        plan = ball_group_plan(2, 64, 512, c, k, H100_SMS, mode=mode)
        assert plan["store_bytes"] == (16 if k * c % 4 == 0 else 4)


@pytest.mark.parametrize("kw", [dict(threads=48), dict(threads=16),
                                dict(threads=2048), dict(mode="texture"),
                                dict(mode="shared", threads=1024)])
def test_a_plan_the_kernel_cannot_take_is_refused(kw):
    """Widths off the warp grid or past 1,024 threads, an unknown mode,
    and a cloud of 14,600 points forced into shared memory:
    None, as `fps_plan` refuses a width it cannot run."""
    assert ball_group_plan(2, 256, 14600, 6, 32, H100_SMS, **kw) is None


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512, 1024])
def test_every_width_is_a_valid_plan(threads):
    """The widths tools/k7_k12_sweep.py launches."""
    plan = ball_group_plan(32, 512, 4096, 6, 128, H100_SMS, threads=threads)
    assert plan["threads"] == threads and plan["mode"] == "shared"
    assert plan["centres"] * plan["ctas_per_cloud"] >= 512
    assert plan["smem_bytes"] <= SMEM_BLOCK
