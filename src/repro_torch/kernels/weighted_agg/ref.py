"""Plain PyTorch version of the weighted aggregation kernel.

The CPU tests use it, the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.  Same
arithmetic as the kernel: f32 accumulation, clients in order.
"""
from __future__ import annotations

from typing import Optional

import torch


def weighted_agg_ref(g: torch.Tensor, rows: torch.Tensor,
                     coefs: torch.Tensor,
                     cids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out = coefs[0]·g + Σ_c coefs[c+1]·rows[r(c)], r(c) = cids[c] or c;
    f32 accumulate, output in g's dtype."""
    c = coefs.float()
    if cids is not None:
        rows = rows.index_select(0, cids.long())
    acc = c[0] * g.float()
    for k in range(rows.shape[0]):
        acc = acc + c[k + 1] * rows[k].float()
    return acc.to(g.dtype)
