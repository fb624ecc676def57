"""Host ms a pair in the program's `register_pairs/voxel` spans (the voxel
grid, `voxel_downsample_capped`, one span a cloud): its dispatch and any
wait for the card inside it (the span closes without a synchronize)."""
from portbench.common.program_spans import host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, "register_pairs/voxel")
