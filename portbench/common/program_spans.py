"""Reading the program's own spans: the stages that `pctpu_torch` times
itself (`pctpu_torch/utils/profiling.py`: `span`, `TRACE`). The program
adds a span's host seconds to `profiling.TRACE` only while a torch
profiler records, so in a traced run `TRACE` holds exactly the profiled
calls. A span never synchronizes: it reads the stage's dispatch and
whatever blocks the host inside it. A program that keeps no such record
reads None."""
from __future__ import annotations

import importlib


def host_ms_per_unit(run, path: str):
    """Host ms a unit of work (a pair) in the program's span `path` over
    the profiled calls, or None where the run was not traced, the program
    keeps no span record, or the path never ran."""
    t = run.trace
    if t is None or not t.units:
        return None
    try:
        profiling = importlib.import_module("pctpu_torch.utils.profiling")
    except ImportError:
        return None
    totals = getattr(getattr(profiling, "TRACE", None), "totals", {})
    total = totals.get(path)
    return None if total is None else total * 1e3 / t.units
