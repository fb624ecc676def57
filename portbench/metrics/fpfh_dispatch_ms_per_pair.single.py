"""Host ms a pair in the program's `register_pair/fpfh` spans
(`features/fpfh.py:fpfh`: kNN normals, radius lists, SPFH and their
weighted sum; one span a cloud): its dispatch and any wait for the card
inside it (the span closes without a synchronize)."""
from portbench.common.program_spans import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "register_pair/fpfh")
