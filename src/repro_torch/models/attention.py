"""Attention: GQA / MHA, full and sliding-window, prefill and decode.
Twin of ``repro/models/attention.py``.

Paths of ``attention_forward``:

* ``naive``  — plain einsum softmax, the oracle; O(S²) memory;
* ``pallas`` — the flash-attention kernels (``kernels/flash_attention``),
  the reference's Pallas path: on the card a launch of the CUDA forward
  kernel and, under autograd, one of each backward kernel (dQ, dK/dV),
  all reading the (B, S, H, D) projections through strides; on the CPU
  their plain versions;
* ``auto``   — ``naive`` up to S = 2048, as in the reference; above that
  the reference takes ``blockwise``, which the port does not have yet.

Decode (one query against the cache) and the projections are plain
torch, as they are einsums outside any kernel in the reference.

KV caches: full layers (B, S_max, Hkv, D) and window layers a ring of
(B, W, Hkv, D) with slot = pos mod W; ``slot_pos`` holds each slot's
absolute position, -1 when empty.  Caches are written in place and
returned (the reference's functional update without a copy).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import apply_rope, dense_init, softcap

Params = Dict[str, Any]
NEG_INF = -2.0e38
BLOCKWISE_TODO = ("blockwise attention is not ported yet "
                  "(ROADMAP Queue 1 #13b)")


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------
def attention_init(gen: torch.Generator, cfg: ModelConfig, *,
                   dtype=torch.float32) -> Params:
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": dense_init(gen, d, h * hd, dtype=dtype).reshape(d, h, hd),
        "wk": dense_init(gen, d, hkv * hd, dtype=dtype).reshape(d, hkv, hd),
        "wv": dense_init(gen, d, hkv * hd, dtype=dtype).reshape(d, hkv, hd),
        "wo": dense_init(gen, h * hd, d, dtype=dtype).reshape(h, hd, d),
    }
    if cfg.attention.qkv_bias:
        for name, heads in (("bq", h), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(heads, hd, dtype=dtype, device=gen.device)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_qkv(params: Params, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,D), k/v (B,S,Hkv,D), RoPE applied."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    theta = cfg.attention.rope_theta
    return apply_rope(q, positions, theta), apply_rope(k, positions, theta), v


def _out_proj(ctx: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return ctx.reshape(*ctx.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _q_scale(cfg: ModelConfig) -> float:
    s = cfg.attention.query_pre_attn_scalar
    return 1.0 / math.sqrt(s if s > 0 else cfg.resolved_head_dim)


def _repeat_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B,S,Hkv,D) -> (B,S,H,D) by repeating each kv head H/Hkv times."""
    hkv = k.shape[-2]
    if hkv == num_heads:
        return k
    return k.repeat_interleave(num_heads // hkv, dim=-2)


# ---------------------------------------------------------------------------
# Masks and the naive oracle
# ---------------------------------------------------------------------------
def causal_window_mask(q_pos: torch.Tensor, k_pos: torch.Tensor,
                       window: int) -> torch.Tensor:
    """bool (…, Sq, Sk): True = attend.  window <= 0 means full causal."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = diff >= 0
    if window > 0:
        mask &= diff < window
    return mask


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, *, scale: float,
                    logit_cap: float = 0.0) -> torch.Tensor:
    """q (B,Sq,H,D), k/v (B,Sk,H,D), mask (B?,Sq,Sk) or (Sq,Sk)."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = softcap(logits, logit_cap)
    if mask.dim() == 2:
        mask = mask[None, None]
    elif mask.dim() == 3:
        mask = mask[:, None]
    logits = logits.masked_fill(~mask, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", w, v.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Full attention layer (prefill)
# ---------------------------------------------------------------------------
def attention_forward(params: Params, x: torch.Tensor, cfg: ModelConfig,
                      *, window: int,
                      positions: Optional[torch.Tensor] = None,
                      impl: str = "auto", kv_cache_out: bool = False):
    """Self-attention over a full sequence.  Returns out, and (k, v)
    un-repeated (Hkv heads) for the cache when ``kv_cache_out``."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, device=x.device)
    q, k, v = _project_qkv(params, x, cfg, positions)
    scale = _q_scale(cfg)
    cap = cfg.attention.attn_logit_softcap
    if impl == "auto":
        impl = "blockwise" if S > 2048 else "naive"
    if impl == "naive":
        mask = causal_window_mask(positions, positions, window)
        ctx = naive_attention(q, _repeat_kv(k, cfg.num_heads),
                              _repeat_kv(v, cfg.num_heads), mask,
                              scale=scale, logit_cap=cap)
    elif impl == "blockwise":
        raise NotImplementedError(BLOCKWISE_TODO)
    elif impl == "pallas":
        from repro_torch.kernels.flash_attention import ops as fa_ops
        ctx = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                     scale=scale, logit_cap=cap)
    else:
        raise ValueError(f"unknown attention impl {impl}")
    out = _out_proj(ctx, params["wo"])
    if kv_cache_out:
        return out, (k, v)
    return out


# ---------------------------------------------------------------------------
# KV cache (full + ring) and decode
# ---------------------------------------------------------------------------
def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, window: int,
                  dtype=torch.bfloat16, device=None) -> Params:
    """window > 0 => ring buffer of size min(window, max_len)."""
    L = min(window, max_len) if window > 0 else max_len
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return {
        "k": torch.zeros(batch, L, hkv, hd, dtype=dtype, device=device),
        "v": torch.zeros(batch, L, hkv, hd, dtype=dtype, device=device),
        "slot_pos": torch.full((L,), -1, dtype=torch.int32, device=device),
    }


def fill_kv_cache(cache: Params, k: torch.Tensor, v: torch.Tensor,
                  start_pos: int = 0) -> Params:
    """Write a prefill's k/v (B,S,Hkv,D) into the cache (ring-aware).

    The cache is written in place and returned: the reference's
    functional update without a copy of the whole cache."""
    L = cache["k"].shape[1]
    S = k.shape[1]
    pos = start_pos + torch.arange(S, device=k.device)
    if S >= L:
        # keep the last L entries, rotated so slot = pos mod L
        k, v, pos = k[:, -L:], v[:, -L:], pos[-L:]
    slots = pos % L
    cache["k"][:, slots] = k.to(cache["k"].dtype)
    cache["v"][:, slots] = v.to(cache["v"].dtype)
    cache["slot_pos"][slots] = pos.to(torch.int32)
    return cache


def decode_attention(params: Params, x: torch.Tensor, cache: Params,
                     cfg: ModelConfig, *, pos: int, window: int
                     ) -> Tuple[torch.Tensor, Params]:
    """One-token decode.  x: (B, 1, d); pos: the current absolute
    position.  Returns (out (B,1,d), cache): the new slot is written into
    ``cache`` in place, as ``fill_kv_cache`` writes."""
    pos = int(pos)
    positions = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, k_new, v_new = _project_qkv(params, x, cfg, positions)
    L = cache["k"].shape[1]
    slot = pos % L
    ck, cv, sp = cache["k"], cache["v"], cache["slot_pos"]
    ck[:, slot] = k_new[:, 0].to(ck.dtype)
    cv[:, slot] = v_new[:, 0].to(cv.dtype)
    sp[slot] = pos

    kr = _repeat_kv(ck, cfg.num_heads)          # (B, L, H, D)
    vr = _repeat_kv(cv, cfg.num_heads)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float() * _q_scale(cfg),
                          kr.float())
    logits = softcap(logits, cfg.attention.attn_logit_softcap)
    valid = (sp >= 0) & (sp <= pos)
    if window > 0:
        valid &= (pos - sp) < window
    logits = logits.masked_fill(~valid, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", w, vr.float())
    return _out_proj(ctx.to(x.dtype), params["wo"]), cache
