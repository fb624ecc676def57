"""RANSAC's draws for a call of a run, the same on both sides of the
judge."""
import numpy as np
import torch


def draw_seed(seed: int, call: int) -> int:
    """The RANSAC generator's seed for one call of a run."""
    ss = np.random.SeedSequence([int(seed), 2, int(call)])
    return int(ss.generate_state(1, np.uint64)[0] & np.uint64(2**63 - 1))


def sampler_for(seed: int, call: int, device):
    """Uniform draws in [0, nv) from a device generator seeded per call:
    the rule of the port's default sampler, handed to the entry as its
    `sampler` and replayed for the reference."""
    g = torch.Generator(device=device).manual_seed(draw_seed(seed, call))

    def sample(nv: torch.Tensor, H: int) -> torch.Tensor:
        u = torch.rand((nv.shape[0], H, 3), generator=g, device=nv.device,
                       dtype=torch.float64)
        nvl = nv.long()[:, None, None]
        return torch.minimum((u * nvl).long(), nvl - 1)
    return sample
