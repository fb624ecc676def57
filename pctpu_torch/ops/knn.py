"""1-NN search, the ICP association primitive (port of
`pctpu/ops/knn.py:nearest`). It always goes through kernel K1
(`ops/pallas_nn.py`); on CPU tensors that is K1's plain version."""
from __future__ import annotations

from typing import Optional

import torch

from pctpu_torch.ops.pallas_nn import nearest_batch


def nearest(query: torch.Tensor, db: torch.Tensor,
            db_mask: Optional[torch.Tensor] = None):
    """query [...,M,3], db [...,N,3], db_mask [...,N] -> (dist2 [...,M],
    idx [...,M] int32), with one leading batch axis or none."""
    if query.dim() == 2:
        d2, idx = nearest_batch(query[None], db[None],
                                None if db_mask is None else db_mask[None])
        return d2[0], idx[0]
    return nearest_batch(query, db, db_mask)
