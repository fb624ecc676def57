"""The device's idle share (%): one minus the union of its activity
intervals (kernels, copies, sets) over the profiled stretch of whole
calls."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
