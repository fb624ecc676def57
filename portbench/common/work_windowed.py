"""Work of a windowed 1-NN association, counted from its inputs' shapes
and the configuration's window, never from a kernel's launch arguments
(the rules of `work.py`, beside which it stands)."""
from portbench.common.work import NN1_FLOPS_PER_CANDIDATE, POINT_BYTES


def windowed_nn1_work(queries: int, db: int, window: int,
                      iterations: int = 1):
    """(FLOPs, bytes) of `iterations` 1-NN associations of `queries` valid
    query points, each scored against a window of `window` db points (at
    most the `db` valid ones): every candidate pair is scored once, every
    point read once and every match written once."""
    cands = min(window, db)
    flops = NN1_FLOPS_PER_CANDIDATE * queries * cands * iterations
    nbytes = POINT_BYTES * (2 * queries + db) * iterations
    return float(flops), float(nbytes)
