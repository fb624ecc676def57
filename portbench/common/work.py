"""Work of an operation, counted from its inputs' shapes and never from a
kernel's launch arguments, so a kernel that is re-tiled, fused or
replaced is measured against the same work."""

# one candidate of an exact 1-NN: |b|^2 - 2 b.q needs 3 multiplies and 3
# adds once |b|^2 is known (the cheapest exact form); the comparison is
# not counted
NN1_FLOPS_PER_CANDIDATE = 6
# a point or a query: 3 float32 coordinates and one float32 of its own
POINT_BYTES = 16


def nn1_work(queries: int, db: int, iterations: int = 1):
    """(FLOPs, bytes) of `iterations` exact 1-NN associations of `queries`
    valid query points against `db` valid points: every candidate pair is
    scored once, every point read once and every match written once."""
    flops = NN1_FLOPS_PER_CANDIDATE * queries * db * iterations
    nbytes = POINT_BYTES * (2 * queries + db) * iterations
    return float(flops), float(nbytes)
