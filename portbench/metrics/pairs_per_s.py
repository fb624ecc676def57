"""Pairs registered a second: every pair of the window over all of its
time (host clock; the window ends with its last whole call)."""


def read(run):
    if run.unit != "pairs" or run.window_s <= 0:
        return None
    return run.units / run.window_s
