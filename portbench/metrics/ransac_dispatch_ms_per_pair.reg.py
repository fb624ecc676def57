"""Host ms a pair in the program's `register_pairs/ransac` span
(`ransac_registration_batch`: compaction, draws, triad solves, scoring,
selection, refine): its dispatch and any wait for the card inside it
(the span closes without a synchronize)."""
from portbench.common.program_spans import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "register_pairs/ransac")
