"""Plain PyTorch versions of the SSD chunk-scan kernel: twin of
``repro/kernels/ssd_scan/ref.py``.

Re-exports the model's chunked SSD (``models.mamba2.ssd_chunked``, the
kernel's plain version) and adds the exact O(L) sequential recurrence
(slow, ground truth).  The CPU tests use them, the wrapper takes
``ssd_chunked`` for tensors on the CPU, and ``chip_smoke.py`` holds the
CUDA kernel against both on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.models.mamba2 import ssd_chunked  # noqa: F401  (the plain op)


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact sequential recurrence, one position at a time.
    x (Bt,L,H,P); dt (Bt,L,H); A (H,); B/C (Bt,L,G,N).
    Returns (y (Bt,L,H,P) f32, final_state (Bt,H,P,N) f32)."""
    Bt, L, H, P = x.shape
    G, N = B.shape[-2], B.shape[-1]
    rep = H // G
    Bh = B.float().repeat_interleave(rep, dim=2)
    Ch = C.float().repeat_interleave(rep, dim=2)
    dtf, xf, Af = dt.float(), x.float(), A.float()
    state = torch.zeros(Bt, H, P, N, dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        dA = torch.exp(dtf[:, t] * Af[None, :])             # (Bt,H)
        state = state * dA[..., None, None] + torch.einsum(
            "bhp,bhn->bhpn", xf[:, t] * dtf[:, t, :, None], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(Bt, 0, H, P)
    return y, state
