"""Transformer and Mamba2 block construction and application: twin of
``repro/models/blocks.py``.

The reference groups layers into ``n_full`` periods of
``cfg.block_pattern``, stacked for ``lax.scan``, plus a remainder.  On
one card the port keeps one parameter dict (and one cache dict) per
layer, in layer order, under ``"layers"``, and loops over them in
Python; ``stack_layout`` is kept for converting the reference's stacked
parameters (``transformer.params_from_jax``).  Sharding constraints have
no counterpart on one card.  ``cfg.remat`` checkpoints each layer while
grad is on (``stack_forward``).  MAMBA blocks run in the SSM family
(mamba2-780m); the hybrid family (zamba2) and MoE raise where they would
be built (``block_init``, ``block_init_cache``) until their slices
(ROADMAP Queue 1 #13d, #13c).  A MAMBA block's prefill runs its
projection, conv and SSD once and takes y and both caches from that pass
(the reference runs them a second time for the caches,
``_mamba_prefill_state``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ATTN_LOCAL, MAMBA, SSM, ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import mamba2
from repro_torch.models.layers import mlp, mlp_init, rmsnorm, rmsnorm_init

Params = Dict[str, Any]
HYBRID_TODO = ("Mamba2 blocks beside attention blocks (the hybrid family) "
               "are not ported yet (ROADMAP Queue 1 #13d (zamba2))")
MOE_TODO = "MoE blocks are not ported yet (ROADMAP Queue 1 #13c)"


def check_kind(kind: str, cfg: ModelConfig) -> None:
    """Raise for a block the port does not have yet."""
    if kind == MAMBA and cfg.family != SSM:
        raise NotImplementedError(HYBRID_TODO)
    if cfg.moe is not None:
        raise NotImplementedError(MOE_TODO)


# ---------------------------------------------------------------------------
# Per-block init and forward
# ---------------------------------------------------------------------------
def block_init(gen: torch.Generator, kind: str, cfg: ModelConfig, *,
               dtype=torch.float32) -> Params:
    check_kind(kind, cfg)
    dev = gen.device
    if kind == MAMBA:
        return {"norm": rmsnorm_init(cfg.d_model, dev),
                "mixer": mamba2.mamba2_init(gen, cfg, dtype=dtype)}
    p = {"norm1": rmsnorm_init(cfg.d_model, dev),
         "attn": attn.attention_init(gen, cfg, dtype=dtype),
         "norm2": rmsnorm_init(cfg.d_model, dev)}
    if cfg.use_post_norms:
        p["post_norm1"] = rmsnorm_init(cfg.d_model, dev)
        p["post_norm2"] = rmsnorm_init(cfg.d_model, dev)
    p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, gated=cfg.mlp_gated,
                        dtype=dtype)
    return p


def _block_window(kind: str, cfg: ModelConfig) -> int:
    return cfg.attention.sliding_window if kind == ATTN_LOCAL else 0


def _ffn(params: Params, x: torch.Tensor, h: torch.Tensor,
         cfg: ModelConfig) -> torch.Tensor:
    """x + h, then the pre-norm MLP residual (post-norms where set)."""
    if cfg.use_post_norms:
        h = rmsnorm(params["post_norm1"], h, cfg.norm_eps)
    x = x + h
    h = mlp(params["mlp"], rmsnorm(params["norm2"], x, cfg.norm_eps),
            gated=cfg.mlp_gated)
    if cfg.use_post_norms:
        h = rmsnorm(params["post_norm2"], h, cfg.norm_eps)
    return x + h


def block_forward(params: Params, x: torch.Tensor, kind: str,
                  cfg: ModelConfig, *,
                  positions: Optional[torch.Tensor] = None,
                  attn_impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y, aux_loss); aux is 0 for dense and Mamba2 blocks."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == MAMBA:
        h = rmsnorm(params["norm"], x, cfg.norm_eps)
        return x + mamba2.mamba2_forward(params["mixer"], h, cfg), aux
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    h = attn.attention_forward(params["attn"], h, cfg,
                               window=_block_window(kind, cfg),
                               positions=positions, impl=attn_impl)
    return _ffn(params, x, h, cfg), aux


# ---------------------------------------------------------------------------
# Per-block decode (one token, cache update)
# ---------------------------------------------------------------------------
def block_init_cache(kind: str, cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> Params:
    check_kind(kind, cfg)
    if kind == MAMBA:
        return mamba2.init_mamba_cache(cfg, batch, dtype, device)
    return attn.init_kv_cache(cfg, batch, max_len, _block_window(kind, cfg),
                              dtype, device)


def block_decode(params: Params, x: torch.Tensor, cache: Params, kind: str,
                 cfg: ModelConfig, *, pos: int
                 ) -> Tuple[torch.Tensor, Params]:
    if kind == MAMBA:
        h = rmsnorm(params["norm"], x, cfg.norm_eps)
        y, cache = mamba2.mamba2_decode(params["mixer"], h, cache, cfg)
        return x + y, cache
    h = rmsnorm(params["norm1"], x, cfg.norm_eps)
    h, new_cache = attn.decode_attention(params["attn"], h, cache, cfg,
                                         pos=pos,
                                         window=_block_window(kind, cfg))
    return _ffn(params, x, h, cfg), new_cache


# ---------------------------------------------------------------------------
# The stack: one dict per layer
# ---------------------------------------------------------------------------
def stack_layout(cfg: ModelConfig
                 ) -> Tuple[int, Tuple[str, ...], Tuple[str, ...]]:
    """(n_full, pattern, remainder_kinds) of the reference's stacking."""
    pat = cfg.block_pattern
    n_full = cfg.num_layers // len(pat)
    return n_full, pat, cfg.blocks[n_full * len(pat):]


def stack_init(gen: torch.Generator, cfg: ModelConfig, *,
               dtype=torch.float32) -> Params:
    return {"layers": [block_init(gen, kind, cfg, dtype=dtype)
                       for kind in cfg.blocks]}


def stack_forward(params: Params, x: torch.Tensor, cfg: ModelConfig, *,
                  positions: Optional[torch.Tensor] = None,
                  attn_impl: str = "auto"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply all blocks.  Returns (y, total_aux_loss).

    With ``cfg.remat`` and grad on, each layer is checkpointed: backward
    keeps only the layer inputs and recomputes each layer's forward once
    (with ``attn_impl="pallas"`` that is a second flash-forward launch per
    layer).  The reference groups its scanned periods two-level (√L
    groups of checkpointed periods), a schedule for TPU memory that
    changes no number; the port checkpoints per layer."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and torch.is_grad_enabled()
    for p, kind in zip(params["layers"], cfg.blocks):
        kw = dict(positions=positions, attn_impl=attn_impl)
        if remat:
            x, a = checkpoint(block_forward, p, x, kind, cfg,
                              use_reentrant=False, **kw)
        else:
            x, a = block_forward(p, x, kind, cfg, **kw)
        aux = aux + a
    return x, aux


def stack_init_cache(cfg: ModelConfig, batch: int, max_len: int,
                     dtype=torch.bfloat16, device=None) -> Params:
    return {"layers": [block_init_cache(kind, cfg, batch, max_len, dtype,
                                        device) for kind in cfg.blocks]}


def stack_decode(params: Params, x: torch.Tensor, cache: Params,
                 cfg: ModelConfig, *, pos: int
                 ) -> Tuple[torch.Tensor, Params]:
    """One decode step through every layer; the caches are written in
    place and ``cache`` is returned."""
    for p, c, kind in zip(params["layers"], cache["layers"], cfg.blocks):
        x, _ = block_decode(p, x, c, kind, cfg, pos=pos)
    return x, cache


def stack_prefill(params: Params, x: torch.Tensor, cfg: ModelConfig,
                  cache: Params, *, attn_impl: str = "auto"
                  ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence forward that also fills the KV caches and the Mamba2
    conv and SSM states (prefill), in place; ``cache`` is returned."""
    positions = torch.arange(x.shape[1], device=x.device)
    for p, c, kind in zip(params["layers"], cache["layers"], cfg.blocks):
        if kind == MAMBA:
            hn = rmsnorm(p["norm"], x, cfg.norm_eps)
            x = x + mamba2.mamba2_forward(p["mixer"], hn, cfg, cache=c)
            continue
        hn = rmsnorm(p["norm1"], x, cfg.norm_eps)
        out, (k_new, v_new) = attn.attention_forward(
            p["attn"], hn, cfg, window=_block_window(kind, cfg),
            positions=positions, impl=attn_impl, kv_cache_out=True)
        x = _ffn(p, x, out, cfg)
        attn.fill_kv_cache(c, k_new, v_new)
    return x, cache
