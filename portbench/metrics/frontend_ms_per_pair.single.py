"""Host ms a pair in the single pair's front-end spans (the voxel grid and
its cap, neighbour-list FPFH, sites, matching, the gather, RANSAC), each
closed after a synchronize."""


def read(run):
    t = run.trace
    if t is None or t.span_wall("frontend") is None:
        return None
    return t.span_wall("frontend") * 1e3 / t.units
