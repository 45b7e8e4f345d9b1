"""Top-level model: the decoder-only LM.  Twin of
``repro/models/transformer.py`` for the DENSE and SSM (Mamba2) families.

Public API:
  init_params(cfg, gen, device=None)          -> params
  forward(params, cfg, batch)                 -> (logits, aux_loss)
  hidden_forward(params, cfg, batch)          -> (x, aux_loss)
  loss_fn(params, cfg, batch)                 -> (loss, metrics)
  init_cache(cfg, batch, max_len)             -> cache
  prefill(params, cfg, batch, cache)          -> (logits_last, cache)
  decode_step(params, cfg, token, cache, pos) -> (logits, cache)
  params_from_jax / params_to_numpy / caches_from_jax / caches_to_numpy

``batch`` is a dict with ``"tokens"`` (B, S) and, for the loss,
``"labels"`` (B, S) and optionally ``"row_weights"`` (B,) or
``"loss_mask"`` (B, S).  Parameters follow the
reference's names and shapes, except that the stack holds one dict per
layer (``params["stack"]["layers"]``); ``params_from_jax`` and
``caches_from_jax`` unstack the reference's scanned periods (attention
or Mamba2 blocks alike), ``params_to_numpy`` and ``caches_to_numpy``
restack them.  A Mamba2 layer's cache is its conv and SSM state
(``models.mamba2.init_mamba_cache``).  Parameters live on the card unless
``init_params`` is given ``device="cpu"``; prefill and decode run where
the parameters are, under ``torch.inference_mode()``.  The hybrid
family (zamba2) and MoE raise until their slices (ROADMAP Queue 1 #13d,
#13c), the encoder-decoder and VLM families until theirs (#13e).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch._device import DeviceLike, resolve_device
from repro_torch._tree import leaves, tree_map
from repro_torch.configs.base import ENCDEC, VLM, ModelConfig
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (cross_entropy, embed_init,
                                       embed_lookup, rmsnorm, rmsnorm_init,
                                       softcap, unembed)

Params = Dict[str, Any]


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family in (ENCDEC, VLM):
        raise NotImplementedError(
            f"the {cfg.family} family is not ported yet (ROADMAP Queue 1 "
            f"#13e)")
    for kind in set(cfg.blocks):      # MoE and hybrid Mamba2 blocks raise
        blk.check_kind(kind, cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def init_params(cfg: ModelConfig, gen: torch.Generator, *,
                dtype=None, device: DeviceLike = None) -> Params:
    """Random parameters (f32 unless ``dtype``), drawn on ``gen``'s
    device and placed on the card unless ``device`` says otherwise.
    Full-f32 matmuls, as the reference computes them: TF32 off."""
    _check_family(cfg)
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dtype = dtype or torch.float32
    p: Params = {
        "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, dtype=dtype),
        "stack": blk.stack_init(gen, cfg, dtype=dtype),
        "final_norm": rmsnorm_init(cfg.d_model, gen.device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model,
                                  dtype=dtype)
    return tree_map(lambda t: t.to(dev), p)


# ---------------------------------------------------------------------------
# Embedding, head, forward
# ---------------------------------------------------------------------------
def _embed_inputs(params: Params, cfg: ModelConfig, batch: Dict[str, Any]
                  ) -> torch.Tensor:
    _check_family(cfg)
    # tied tables scale the input embedding by sqrt(d_model)
    return embed_lookup(params["embed"], batch["tokens"],
                        scale_by_sqrt_dim=cfg.tie_embeddings)


def _lm_head_table(params: Params, cfg: ModelConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["lm_head"]


def forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            attn_impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    x = _embed_inputs(params, cfg, batch)
    x, aux = blk.stack_forward(params["stack"], x, cfg, attn_impl=attn_impl)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return unembed(x, _lm_head_table(params, cfg),
                   cfg.final_logit_softcap), aux


# ---------------------------------------------------------------------------
# Training loss
# ---------------------------------------------------------------------------
def hidden_forward(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
                   *, attn_impl: str = "auto"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward up to the final norm (no unembed).  Returns (x, aux)."""
    x = _embed_inputs(params, cfg, batch)
    x, aux = blk.stack_forward(params["stack"], x, cfg, attn_impl=attn_impl)
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _chunk_nll(xc: torch.Tensor, table: torch.Tensor, lc: torch.Tensor,
               final_softcap: float,
               row_weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Σ of one sequence chunk's (weighted) token NLL.  The reference's
    one-hot contraction is a gather here: only the label's column is
    non-zero, so the sum is exact; a label < 0 marks an invalid token."""
    logits = softcap((xc @ table.t()).float(), final_softcap)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, lc.long().clamp_min(0)[..., None])[..., 0]
    nll = (lse - ll) * (lc >= 0).float()
    if row_weights is not None:
        nll = nll * row_weights[:, None].float()
    return nll.sum()


def chunked_cross_entropy(x: torch.Tensor, table: torch.Tensor,
                          labels: torch.Tensor, *,
                          final_softcap: float = 0.0, chunk: int = 128,
                          row_weights: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """CE without materializing (B, S, V): one sequence chunk at a time,
    each checkpointed while grad is on, so backward recomputes a chunk's
    logits instead of keeping them.  The reference pads the last chunk
    with invalid labels; the port takes a shorter last chunk, which adds
    the same terms.

    ``row_weights`` (B,): returns Σ_r w_r · Σ_t nll_rt (the fused
    federated step's c_client / tokens-per-client weights); without it,
    the mean over valid tokens."""
    tot = x.new_zeros((), dtype=torch.float32)
    for s0 in range(0, x.shape[1], chunk):
        args = (x[:, s0:s0 + chunk], table, labels[:, s0:s0 + chunk],
                final_softcap, row_weights)
        tot = tot + (checkpoint(_chunk_nll, *args, use_reentrant=False)
                     if torch.is_grad_enabled() else _chunk_nll(*args))
    if row_weights is not None:
        return tot
    return tot / (labels >= 0).float().sum().clamp_min(1.0)


def loss_fn(params: Params, cfg: ModelConfig, batch: Dict[str, Any], *,
            attn_impl: str = "auto", chunked: Optional[bool] = None):
    """``batch["row_weights"]`` (B,), when present, switches to weighted-sum
    semantics (federated fused step): loss = Σ_r w_r Σ_t nll_rt + aux.
    Returns (loss, {"ce", "aux"})."""
    labels = batch["labels"]
    row_weights = batch.get("row_weights")
    if chunked is None:
        # chunk whenever the full (B, S, V) logits would be large
        chunked = labels.shape[0] * labels.shape[1] * cfg.vocab_size \
            > (1 << 28)
    if chunked or row_weights is not None:
        x, aux = hidden_forward(params, cfg, batch, attn_impl=attn_impl)
        loss = chunked_cross_entropy(x, _lm_head_table(params, cfg), labels,
                                     final_softcap=cfg.final_logit_softcap,
                                     row_weights=row_weights)
    else:
        logits, aux = forward(params, cfg, batch, attn_impl=attn_impl)
        loss = cross_entropy(logits, labels, batch.get("loss_mask"))
    return loss + aux, {"ce": loss, "aux": aux}


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------
def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device: DeviceLike = None) -> Params:
    """KV caches (attention) or conv and SSM states (Mamba2) of every
    layer; on the card unless ``device`` says."""
    _check_family(cfg)
    return {"dec": blk.stack_init_cache(cfg, batch, max_len, dtype,
                                        resolve_device(device))}


@torch.inference_mode()
def prefill(params: Params, cfg: ModelConfig, batch: Dict[str, Any],
            cache: Optional[Params] = None, *, attn_impl: str = "auto"):
    """Run the full prompt, fill the caches, return (last_logits, cache)."""
    x = _embed_inputs(params, cfg, batch)
    if cache is None:
        cache = init_cache(cfg, x.shape[0], x.shape[1], device=x.device)
    h, _ = blk.stack_prefill(params["stack"], x, cfg, cache["dec"],
                             attn_impl=attn_impl)
    h = rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
    logits = unembed(h, _lm_head_table(params, cfg), cfg.final_logit_softcap)
    return logits, cache


@torch.inference_mode()
def decode_step(params: Params, cfg: ModelConfig, token: torch.Tensor,
                cache: Params, pos: int):
    """token (B, 1) int; pos the absolute position of ``token``.
    Returns (logits (B,1,V), cache), the cache written in place."""
    _check_family(cfg)
    x = embed_lookup(params["embed"], token,
                     scale_by_sqrt_dim=cfg.tie_embeddings)
    h, _ = blk.stack_decode(params["stack"], x, cache["dec"], cfg, pos=pos)
    h = rmsnorm(params["final_norm"], h, cfg.norm_eps)
    logits = unembed(h, _lm_head_table(params, cfg), cfg.final_logit_softcap)
    return logits, cache


def num_params(params: Any) -> int:
    return sum(t.numel() for t in leaves(params))


# ---------------------------------------------------------------------------
# Conversion from and to the reference's layout (numpy arrays)
# ---------------------------------------------------------------------------
def _unstack(stack: Params, cfg: ModelConfig) -> List[Any]:
    """The reference's {"period": [...], "rem": [...]} as one entry per
    layer, in layer order: period i, pattern slot j is layer i·P + j."""
    if not stack["period"]:
        return list(stack["rem"])
    n_full, pat, _ = blk.stack_layout(cfg)
    layers = [tree_map(lambda a, i=i: a[i], stack["period"][j])
              for i in range(n_full) for j in range(len(pat))]
    return layers + list(stack["rem"])


def _restack(layers: List[Any], cfg: ModelConfig) -> Params:
    """Inverse of ``_unstack`` for the reference's layout of ``cfg``."""
    n_full, pat, _ = blk.stack_layout(cfg)
    if not (cfg.scan_layers and n_full > 1):
        return {"period": [], "rem": list(layers)}
    P = len(pat)

    def stack(*xs):
        if isinstance(xs[0], dict):
            return {k: stack(*[x[k] for x in xs]) for k in xs[0]}
        return np.stack(xs)

    period = [stack(*[layers[i * P + j] for i in range(n_full)])
              for j in range(P)]
    return {"period": period, "rem": list(layers[n_full * P:])}


def _to_torch(device):
    def convert(a):
        a = np.array(a)
        if a.dtype.name == "bfloat16":      # ml_dtypes' bf16, bit for bit
            return torch.from_numpy(a.view(np.uint16)).view(
                torch.bfloat16).to(device)
        return torch.from_numpy(a).to(device)
    return convert


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """numpy has no bf16: bf16 leaves come back as (exact) float32."""
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_from_jax(tree: Params, cfg: ModelConfig, device) -> Params:
    """The reference's parameters (numpy arrays, unrolled or stacked) as
    the port's, values unchanged."""
    _check_family(cfg)
    out = {k: tree_map(_to_torch(device), v) for k, v in tree.items()
           if k != "stack"}
    out["stack"] = {"layers": tree_map(_to_torch(device),
                                   _unstack(tree["stack"], cfg))}
    return out


def params_to_numpy(params: Params, cfg: ModelConfig) -> Params:
    """Inverse of ``params_from_jax``: the port's parameters as numpy
    arrays in the reference's layout (unrolled or stacked per ``cfg``;
    bf16 leaves as float32)."""
    out = {k: tree_map(_to_numpy, v) for k, v in params.items()
           if k != "stack"}
    out["stack"] = _restack(tree_map(_to_numpy, params["stack"]["layers"]),
                            cfg)
    return out


def caches_from_jax(tree: Params, cfg: ModelConfig, device) -> Params:
    """The reference's cache (numpy arrays) as the port's."""
    return {"dec": {"layers": tree_map(_to_torch(device),
                                   _unstack(tree["dec"], cfg))}}


def caches_to_numpy(cache: Params, cfg: ModelConfig) -> Params:
    """The port's cache as numpy arrays in the reference's layout
    (bf16 leaves as float32)."""
    layers = tree_map(_to_numpy, cache["dec"]["layers"])
    return {"dec": _restack(layers, cfg)}
