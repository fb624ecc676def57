"""How kernels 10/11 (`csrc/fps.cu`) shape a launch: `fps_plan` in
`pctpu_torch/ops/pallas_fps.py`, which the kernel's C entry checks and
follows. It runs here without a card; the kernel itself is held against
`fps_plain` in tests/test_torch_cuda.py at every width the plan takes."""
import pytest

from pctpu_torch.ops.pallas_fps import (MAX_THREADS, MIN_THREADS, MODES,
                                        PER_CHOICES, REG_BUDGET,
                                        SMEM_POINTS_MAX, WIDE_THREADS,
                                        fps_plan)

H100_SMS = 132

# chip_smoke.py's launches: (B, N, m) -> (threads, per, mode)
PATH_SHAPES = {
    (32, 4096, 512): (256, 16, "registers"),   # SA1 of P7, P8, P10, P11
    (32, 512, 128): (128, 4, "registers"),     # their SA2
    (1, 1024, 512): (256, 4, "registers"),     # P9's kernel 10
    (4, 1024, 512): (256, 4, "registers"),     # P9's batched SA1
    (8, 128, 512): (128, 1, "registers"),      # P12's toy SA1, N < m
    (8, 512, 128): (128, 4, "registers"),      # P12's toy SA2
}
# N around each limit of the rule
BOUNDARY_N = [1, 31, 32, 33, 255, 256, 257, 1024, 1025, 4096, 4097, 8192,
              8193, 16384, 16385, SMEM_POINTS_MAX // 12,
              SMEM_POINTS_MAX // 12 + 1, 20000, 100000]


@pytest.mark.parametrize("shape", list(PATH_SHAPES))
def test_plan_at_the_paths_shapes(shape):
    plan = fps_plan(*shape, H100_SMS)
    assert (plan["threads"], plan["per"], plan["mode"]) == PATH_SHAPES[shape]
    assert plan["ctas"] == shape[0] and plan["steps"] == shape[2] - 1
    assert plan["sms_busy"] == min(shape[0], H100_SMS)


@pytest.mark.parametrize("n", BOUNDARY_N)
def test_plan_owns_every_point_within_the_kernels_limits(n):
    plan = fps_plan(2, n, 64, H100_SMS)
    t, per, mode = plan["threads"], plan["per"], plan["mode"]
    assert mode in MODES
    assert t % 32 == 0 and MIN_THREADS <= t <= MAX_THREADS
    assert t & (t - 1) == 0
    if mode in ("registers", "shared"):
        assert per in PER_CHOICES and per * t >= n
        assert (per // 2) * t < n or per == 1    # no wholly idle round
        assert 12 * n <= SMEM_POINTS_MAX == plan["smem_bytes"] or \
            plan["smem_bytes"] == 12 * n
    else:
        assert per == 0
    if mode == "registers":
        assert 4 * per * t <= REG_BUDGET


@pytest.mark.parametrize("n,mode", [
    (8192, "registers"),                   # 1,024 x 8 points: the budget
    (8193, "shared"),                      # 16 a thread: xyz from smem
    (16384, "shared"),
    (16385, "scratch"),                    # past 16 a thread
    (SMEM_POINTS_MAX // 12, "scratch"),
    (SMEM_POINTS_MAX // 12 + 1, "global"),  # past shared memory
    (20000, "global"),                     # the card test's large cloud
])
def test_mode_changes_at_the_limits(n, mode):
    plan = fps_plan(1, n, 16, H100_SMS)
    assert plan["mode"] == mode
    assert plan["smem_bytes"] == (12 * n if mode != "global" else 0)


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512, 1024])
@pytest.mark.parametrize("n", [128, 512, 1024, 4096])
def test_every_width_is_a_valid_plan(threads, n):
    """The widths the card tests and tools/fps_k8_sweep.py launch."""
    plan = fps_plan(4, n, 32, H100_SMS, threads=threads)
    assert plan["threads"] == threads
    if n > PER_CHOICES[-1] * threads:       # past 16 points a thread
        assert (plan["per"], plan["mode"]) == (0, "scratch")
        return
    assert plan["per"] * threads >= n and plan["per"] in PER_CHOICES
    assert plan["mode"] == ("registers" if 4 * plan["per"] * threads
                            <= REG_BUDGET else "shared")


@pytest.mark.parametrize("threads", [0, 16, 31, 48, 1056, 2048])
def test_widths_the_kernel_does_not_take(threads):
    assert fps_plan(4, 4096, 512, H100_SMS, threads=threads) is None


def test_default_width_follows_points_per_thread():
    """Wider clouds get wider CTAs up to WIDE_THREADS, then more points a
    thread up to 16, then wider CTAs again up to MAX_THREADS."""
    widths = [fps_plan(1, n, 8, H100_SMS)["threads"]
              for n in (64, 256, 1024, 4096, 8192, 16384, 50000)]
    assert widths == [MIN_THREADS, MIN_THREADS, WIDE_THREADS, WIDE_THREADS,
                      512, MAX_THREADS, MAX_THREADS]
