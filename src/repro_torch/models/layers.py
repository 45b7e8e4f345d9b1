"""Primitive layers as functions over explicit parameter dicts: twin of
``repro/models/layers.py``.

Parameters are dicts of tensors under the reference's names and shapes,
so ``transformer.params_from_jax`` carries them over unchanged.  Init
functions take a ``torch.Generator`` and create their tensors on its
device; they cannot draw the reference's numbers (``jax.random`` is
another generator), so parity tests convert the reference's parameters.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Init helpers
# ---------------------------------------------------------------------------
def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               dtype=torch.float32, scale: Optional[float] = None
               ) -> torch.Tensor:
    """Truncated-normal (±2σ) fan-in init, σ = 1/sqrt(d_in)."""
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    w = torch.empty(d_in, d_out, device=gen.device)
    torch.nn.init.trunc_normal_(w, generator=gen)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32) -> torch.Tensor:
    w = torch.empty(vocab, d, device=gen.device)
    return (torch.nn.init.normal_(w, generator=gen) * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def rmsnorm_init(d: int, device=None) -> Params:
    return {"scale": torch.zeros(d, dtype=torch.float32, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMSNorm in f32 with the (1 + scale) parameterization."""
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"])).to(dt)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0.0:
        return x
    return cap * torch.tanh(x / cap)


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved pairs)
# ---------------------------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    expo = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)   # (D/2,)
    angles = positions[..., None].float() * freqs              # (..., S, D/2)
    angles = angles[..., None, :]                              # (..., S, 1, D/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (gated or plain; jax.nn.gelu's default is the tanh approximation)
# ---------------------------------------------------------------------------
def mlp_init(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, dtype=torch.float32) -> Params:
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype=dtype),
         "w_out": dense_init(gen, d_ff, d_model, dtype=dtype)}
    if gated:
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype=dtype)
    return p


def mlp(params: Params, x: torch.Tensor, *, gated: bool = True
        ) -> torch.Tensor:
    h = x @ params["w_in"]
    if gated:
        h = F.gelu(x @ params["w_gate"], approximate="tanh") * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ params["w_out"]


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------
def embed_lookup(embedding: torch.Tensor, ids: torch.Tensor, *,
                 scale_by_sqrt_dim: bool = False) -> torch.Tensor:
    x = embedding[ids]
    if scale_by_sqrt_dim:
        x = x * torch.tensor(math.sqrt(embedding.shape[1]), dtype=x.dtype,
                             device=x.device)
    return x


def unembed(x: torch.Tensor, table: torch.Tensor,
            final_softcap: float = 0.0) -> torch.Tensor:
    """table is always (vocab, d_model)."""
    return softcap(x @ table.t(), final_softcap)


# ---------------------------------------------------------------------------
# Cross entropy (stable, fp32 accumulation)
# ---------------------------------------------------------------------------
def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL; ``labels`` may be int32 (gathered as int64)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()
