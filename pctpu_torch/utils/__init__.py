"""Host utilities (port of `pctpu/utils/__init__.py`): PLY writers and
timing / profiling helpers."""
from pctpu_torch.utils import viz  # noqa: F401
from pctpu_torch.utils.profiling import (  # noqa: F401
    Timer, profiler_trace, sync, time_fn)
