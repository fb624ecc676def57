"""Host ms a pair in the program's `register_pair/icp/layout` span (kernel
5's layout in `register/icp.py:icp_fixed_iters_banded_mega`: the pow-2
padding, the db's band sort and LUT, the source's axis sort, the query
tiles): its dispatch and any wait for the card inside it (the span closes
without a synchronize)."""
from portbench.common.program_spans import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "register_pair/icp/layout")
