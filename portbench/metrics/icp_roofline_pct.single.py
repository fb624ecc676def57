"""The single pair's ICP share of its roofline (%): its least time (kernel
5's windowed and exact 1-NN work and the stats' exact pass, counted from
the pairs' shapes and the configuration, at the H100's float32 and HBM
peaks) over the device time of the kernels launched inside the ICP
spans."""
from portbench.common.peaks import least_seconds


def read(run):
    t = run.trace
    if t is None or "icp" not in t.work:
        return None
    dev = t.device_s_in("icp")
    if not dev:
        return None
    w = t.work["icp"]
    return 100.0 * least_seconds(w["flops"], w["bytes"]) / dev
