"""Model-layout entry point of the flash-attention kernels, with their
backward: twin of ``repro/kernels/flash_attention/ops.py``.

``_FlashAttention`` is the twin of the reference's ``custom_vjp``: its
forward emits (out, lse) through ``flash_attention_fwd``, its backward
runs the backward kernels through ``flash_attention_bwd`` (dQ; dK/dV per
query head, each GQA group then summed by the group-sum kernel), so no
(S, S) residual is kept.

q (B,S,H,D) and k/v (B,S,Hkv,D) with unrepeated KV heads go to the
kernels as transposed views of the same memory, and the output comes
back in (B,S,H,D) without a copy; the gradients take the inputs'
layouts.  The TPU-only ``block_q``, ``block_k`` and ``interpret``
arguments have no counterpart: the kernels' tiles are fixed.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bwd, flash_attention_fwd)


class _FlashAttention(torch.autograd.Function):
    """q (B,H,Sq,D), k/v (B,Hkv,Sk,D) -> (B,H,Sq,D)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale, logit_cap):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       scale=scale, logit_cap=logit_cap,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, scale=scale,
                      logit_cap=logit_cap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,Hkv,D) -> (B,S,H,D), differentiable."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    out = _FlashAttention.apply(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal, window, scale,
                                logit_cap)
    return out.transpose(1, 2)
