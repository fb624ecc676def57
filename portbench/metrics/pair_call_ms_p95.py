"""The 95th percentile of one call's latency over every call of the
window (ms, host clock, each call closed by a synchronize; numpy's linear
interpolation between order statistics)."""
import numpy as np


def read(run):
    if run.unit != "pairs" or not run.latencies_s:
        return None
    return float(np.percentile(np.asarray(run.latencies_s) * 1e3, 95))
