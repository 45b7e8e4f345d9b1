"""Model-layout entry point of the flash-attention kernel: twin of
``repro/kernels/flash_attention/ops.py`` (forward only).

q (B,S,H,D) and k/v (B,S,Hkv,D) with unrepeated KV heads go to the
kernel as transposed views of the same memory, and the output comes back
in (B,S,H,D) without a copy.  The TPU-only ``block_q``, ``block_k`` and
``interpret`` arguments have no counterpart: the kernel's tiles are fixed.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_fwd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """q (B,S,H,D), k/v (B,S,Hkv,D) -> (B,S,H,D)."""
    out = flash_attention_fwd(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=causal,
                              window=window, scale=scale,
                              logit_cap=logit_cap)
    return out.transpose(1, 2)
