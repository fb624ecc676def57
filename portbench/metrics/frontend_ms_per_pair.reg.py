"""Host ms a pair in the front end's spans (voxel grid, normals and
descriptors, matching, RANSAC), each closed after a synchronize."""


def read(run):
    t = run.trace
    if t is None or t.span_wall("frontend") is None:
        return None
    return t.span_wall("frontend") * 1e3 / t.units
