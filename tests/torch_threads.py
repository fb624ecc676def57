"""The port's CPU tests' torch thread policy. Not a test module: every
`test_torch_*.py` and `torch_ranks.py` imports it on its first lines, and
it imports only torch, so the card tests' `--noconftest` run and the
spawned ranks can import it too.

Under an xdist worker torch runs one intra-op thread for the whole
process, because several workers each running torch's CPU pool at the
machine's width oversubscribe the cores many times over. A single-process
run keeps torch's own width. The CPU ranks that `run_world` spawns get one
thread from `pctpu_torch/parallel/launch.py:_rank_main` whatever this
module does; `torch_ranks.py` imports it so that its code follows the same
rule when it runs outside `run_world`."""
import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
