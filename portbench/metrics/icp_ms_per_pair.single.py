"""Host ms a pair in the single pair's ICP spans (kernel 5's layout,
windowed and exact launches; the K1 stats), each closed after a
synchronize."""


def read(run):
    t = run.trace
    if t is None or t.span_wall("icp") is None:
        return None
    return t.span_wall("icp") * 1e3 / t.units
