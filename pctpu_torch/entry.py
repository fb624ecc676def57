"""The flagship forward as `(fn, example_args)` (port of
`__graft_entry__.py:entry`): the PointNet++ MSG classifier, eval mode."""
from __future__ import annotations

import torch

from pctpu_torch.device import DeviceLike, resolve_device
from pctpu_torch.nn import train as T
from pctpu_torch.nn.config import TrainConfig


def entry(device: DeviceLike = None):
    """(forward, (pc,)): `cls-msg` with 40 classes on B = 4 random clouds
    of 1,024 points x 6 channels, weights from a generator seeded with 0;
    forward(pc) -> logits [4,40] under no_grad. On CUDA unless "cpu" is
    asked for."""
    dev = resolve_device(device)
    cfg = TrainConfig(model="cls-msg", num_classes=40, num_points=1024,
                      batch_size=4)
    gen = torch.Generator().manual_seed(0)
    model = T.build_model(cfg, device=dev, generator=gen)
    pc = torch.randn((4, 1024, 6), generator=gen).to(dev)

    @torch.no_grad()
    def forward(pc):
        return model(pc)

    return forward, (pc,)
