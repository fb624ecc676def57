"""Host ms a pair in the program's `register_pairs/inputs` span: the copy of
both clouds from pageable host memory to the card, which blocks the host
(a program span, closed without a synchronize)."""
from portbench.common.program_spans import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "register_pairs/inputs")
