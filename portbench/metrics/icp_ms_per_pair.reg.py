"""Host ms a pair in the ICP spans (voxel-cloud ICP, full-resolution
refine, stats), each closed after a synchronize."""


def read(run):
    t = run.trace
    if t is None or t.span_wall("icp") is None:
        return None
    return t.span_wall("icp") * 1e3 / t.units
