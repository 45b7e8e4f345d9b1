"""Differentiable entry point of the SSD chunk-scan kernel: twin of
``repro/kernels/ssd_scan/ops.py``.

``_SSD`` is the twin of the reference's ``custom_vjp``: its forward runs
``ssd_scan_fwd`` (the kernel on the card, the plain chunked op on the
CPU), its backward recomputes the forward with autograd through the
plain ``models.mamba2.ssd_chunked``, which computes the same function.
The reference has no backward kernel, so neither has the port.  The
TPU-only ``interpret`` argument has no counterpart.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.ssd_scan.ref import ssd_chunked
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_fwd


class _SSD(torch.autograd.Function):
    """x (Bt,L,H,P), dt (Bt,L,H), A (H,), B/C (Bt,L,G,N) -> (y, state)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return ssd_scan_fwd(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dstate):
        ins = [t.detach().requires_grad_(True) for t in ctx.saved_tensors]
        with torch.enable_grad():
            outs = ssd_chunked(*ins, chunk=ctx.chunk)
        return (*torch.autograd.grad(outs, ins, (dy, dstate)), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, chunk: int = 128
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (Bt,L,H,P) f32, final_state (Bt,H,P,N) f32), differentiable in
    every tensor argument."""
    return _SSD.apply(x, dt, A, B, C, chunk)
