"""Device kernels a pair that started inside the benchmark's
`pb:frontend/keypoint_sites` spans (the matching sites of each side's
voxel clouds: ISS a cloud; each span closed after a synchronize, and
opened after the previous stage's), over the profiled calls' pairs.
Copies and sets are not counted."""
import bisect

from portbench.common.trace import merged

SPAN = "frontend/keypoint_sites"


def read(run):
    t = run.trace
    if t is None or not t.units:
        return None
    ivs = merged(t.spans.get(SPAN, []))
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    n = 0
    for _, s, _e in t.kernels:
        j = bisect.bisect_right(starts, s) - 1
        if j >= 0 and s < ivs[j][1]:
            n += 1
    return n / t.units
