"""Points on the faces of 0.1 cells, for the grid-hash tests and
`chip_smoke.py` P26 (numpy only: no JAX, no torch)."""
import numpy as np


def faces_cloud():
    """Multiples of 0.1 in float32, with the lattice's origin at 0, and
    copies whose nonzero coordinates are nudged by one ulp either way
    (zeros stay: XLA's CPU backend flushes denormals)."""
    k = np.arange(0, 64, dtype=np.float32)
    g = np.stack(np.meshgrid(k, k[:8], k[:8], indexing="ij"),
                 -1).reshape(-1, 3) * np.float32(0.1)
    g = g.astype(np.float32)
    up, down = (np.where(g > 0, np.nextafter(g, np.float32(d)), g)
                for d in (1e9, -1e9))
    return np.concatenate([g, up, down]).astype(np.float32)
