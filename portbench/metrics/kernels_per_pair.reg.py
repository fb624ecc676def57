"""Device kernels a pair: every kernel the profiler saw in the profiled
calls (copies and sets not counted), over their pairs."""


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    n = sum(1 for _, s, _e in t.kernels if t.start <= s < t.end)
    return n / t.units
