"""Plain PyTorch versions of the flash-attention kernels: twin of
``repro/kernels/flash_attention/ref.py``, plus the plain backward.

The CPU tests use them, the wrappers take them for tensors on the CPU,
and ``chip_smoke.py`` holds the CUDA kernels against them on the card.
They materialize the full (Sq, Sk) logits in f32.
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
    mask = _mask(Sq, Sk, causal, window, q.device)
    logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", w, v.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(logits, dim=-1)
    return out


def _mask(Sq: int, Sk: int, causal: bool, window: int,
          device) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device)[:, None]
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    return mask


def attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      out: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, causal: bool = True,
                      window: int = 0, scale: Optional[float] = None,
                      logit_cap: float = 0.0):
    """The flash VJP in plain tensor ops, as ``flash_attention_bwd``
    computes it (not autograd through ``attention_ref``): p recomputed
    from ``lse`` with the raw product scaled after the dot, the softcap
    jacobian 1 − (s/cap)², δ = rowsum(dO·O) in f32, dK and dV summed over
    each GQA group.  q/out/dout (B,H,Sq,D), k/v (B,Hkv,Sk,D), lse
    (B,H,Sq).  Returns (dq, dk, dv) in the dtypes of q, k and v."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    # query heads as (kv head, member of its group): h = g·rep + r
    grp = lambda x: x.float().unflatten(1, (Hkv, H // Hkv))
    qf, of, dof = grp(q), grp(out), grp(dout)
    kf, vf = k.float(), v.float()
    raw = torch.einsum("bgrqd,bgkd->bgrqk", qf, kf) * scale
    if logit_cap > 0.0:
        s = logit_cap * torch.tanh(raw / logit_cap)
        jac = 1.0 - (s / logit_cap) ** 2
    else:
        s, jac = raw, None
    mask = _mask(Sq, Sk, causal, window, q.device)
    p = torch.where(mask, torch.exp(s - grp(lse)[..., None]), 0.0)
    delta = (dof * of).sum(-1)
    dp = torch.einsum("bgrqd,bgkd->bgrqk", dof, vf)
    ds = p * (dp - delta[..., None])
    if jac is not None:
        ds = ds * jac
    dq = torch.einsum("bgrqk,bgkd->bgrqd", ds, kf) * scale
    dk = torch.einsum("bgrqk,bgrqd->bgkd", ds, qf) * scale
    dv = torch.einsum("bgrqk,bgrqd->bgkd", p, dof)
    return dq.flatten(1, 2).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
