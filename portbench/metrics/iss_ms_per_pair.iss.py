"""Host ms a pair in the program's `register_pairs/sites/iss` spans
(`features/iss.py:iss_keypoints` on one voxel cloud: the radius search
and weights, the scatter, the eigenvalues, the NMS; 2B spans a call),
summed over the profiled calls: their dispatch and any wait for the card
inside them (a span closes without a synchronize)."""
from portbench.common.program_spans import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "register_pairs/sites/iss")
