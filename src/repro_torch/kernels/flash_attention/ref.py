"""Plain PyTorch version of the flash-attention forward kernel: twin of
``repro/kernels/flash_attention/ref.py``.

The CPU tests use it, the wrapper takes it for tensors on the CPU, and
``chip_smoke.py`` holds the CUDA kernel against it on the card.  It
materializes the full (Sq, Sk) logits in f32.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -2.0e38


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None, logit_cap: float = 0.0,
                  return_lse: bool = False):
    """q (B,H,Sq,D); k/v (B,Hkv,Sk,D).  Returns (B,H,Sq,D) in q's dtype
    and, with ``return_lse``, the per-row log-sum-exp (B,H,Sq) in f32."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if Hkv != H:     # each kv head serves H/Hkv consecutive query heads
        k, v = (x[:, :, None].expand(B, Hkv, H // Hkv, Sk, D)
                .reshape(B, H, Sk, D) for x in (k, v))
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if logit_cap > 0.0:
        logits = logit_cap * torch.tanh(logits / logit_cap)
    qpos = torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out
