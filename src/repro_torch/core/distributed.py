"""The fused CSMAAFL step on one device: twin of the one-device part of
``repro/core/distributed.py`` (docs/DESIGN.md §3).

The control plane (``core.scheduler`` + ``core.aggregation``) decides
which clients' updates fold into this step and computes the scalar blend
coefficients; the step applies them:

    w_new = c0 · w_global + Σ_c c_c · w_c,
    w_c   = LocalSGD_K(w_global, batch_c)

* K = 1: the algebraic fast path (exact, since Σ coefs = 1),
  w_new = w − lr · Σ_c c_c ∇mean_c.  Clients fold into the batch rows with
  per-row loss weights c_client / tokens_per_client, so one backward pass
  computes the blend; ``fed.grad_accum`` micro-batches accumulate the
  gradient in f32.
* K > 1: each client runs K local SGD steps from ``w_global`` in turn,
  and ``agg_engine.weighted_sum_leaves`` blends the C local models, one
  weighted-aggregation kernel launch per parameter leaf.

``make_sfl_step`` is FedAvg (coefs = [0, α_1..α_C]) through the same step.

The reference compiles one SPMD program over a data × model mesh, with
ZeRO sharding, sharding constraints on activations and parameters, a
vmap over clients and the serving step builders; all of that is the
multi-device plane, ROADMAP Queue 1 #14.  Here the builders take a
``device`` instead of ``mesh``, ``mesh_cfg``, ``params_shape`` and
``param_pspecs``, and the step runs eagerly where the parameters are.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device, to_device
from repro_torch._tree import leaves, tree_map
from repro_torch.configs.base import FederatedConfig, ModelConfig
from repro_torch.core import agg_engine
from repro_torch.models import transformer as tmod

Params = Dict[str, Any]


def _value_and_grad(params: Params, cfg: ModelConfig,
                    batch: Dict[str, torch.Tensor], attn_impl: str
                    ) -> Tuple[torch.Tensor, Params]:
    """(loss, grads) of ``tmod.loss_fn``; grads in the tree of params."""
    live = [t.detach().requires_grad_(True) for t in leaves(params)]
    it = iter(live)
    p = tree_map(lambda _: next(it), params)
    loss, _ = tmod.loss_fn(p, cfg, batch, attn_impl=attn_impl)
    grads = iter(torch.autograd.grad(loss, live))
    return loss.detach(), tree_map(lambda _: next(grads), params)


def _sgd(params: Params, grads: Params, lr: float) -> Params:
    """w − lr·g in f32, back to each leaf's dtype."""
    return tree_map(
        lambda w, g: (w.float() - lr * g.float()).to(w.dtype), params, grads)


# ---------------------------------------------------------------------------
# Local training: K SGD steps for one client
# ---------------------------------------------------------------------------
def _local_sgd(params: Params, batches: Dict[str, torch.Tensor], lr: float,
               cfg: ModelConfig, local_steps: int, attn_impl: str
               ) -> Tuple[Params, torch.Tensor]:
    """K plain-SGD steps (paper eq. 1).  ``batches``: leaves with leading
    dim K (one micro-batch per local step).  Returns (params, mean loss)."""
    losses = []
    for k in range(local_steps):
        loss, grads = _value_and_grad(
            params, cfg, {n: x[k] for n, x in batches.items()}, attn_impl)
        params = _sgd(params, grads, lr)
        losses.append(loss)
    return params, torch.stack(losses).mean()


def fused_value_and_grad(global_params: Params,
                         batches: Dict[str, torch.Tensor],
                         client_coefs: torch.Tensor, *, cfg: ModelConfig,
                         fed: FederatedConfig, attn_impl: str = "auto"
                         ) -> Tuple[torch.Tensor, Params]:
    """(loss, gradient) of the K = 1 path: the C clients' (C, 1, b, S)
    batches fold into C·b rows with per-row loss weights
    c_client / tokens_per_client (``client_coefs`` is (C,)), so the
    gradient is Σ_c c_c ∇mean_c; with ``fed.grad_accum`` = M > 1 (and
    M | C·b) M micro-batches of rows are summed in f32."""
    C = batches["tokens"].shape[0]
    b, seq = batches["labels"].shape[2], batches["labels"].shape[3]
    flat = {n: x.reshape(C * b, *x.shape[3:]) for n, x in batches.items()}
    flat["row_weights"] = client_coefs.float().repeat_interleave(b) \
        / (b * seq)
    M, R = fed.grad_accum, C * b
    if M <= 1 or R % M:
        return _value_and_grad(global_params, cfg, flat, attn_impl)
    loss, grads = None, None
    for m in range(M):
        micro = {n: x[m * (R // M):(m + 1) * (R // M)]
                 for n, x in flat.items()}
        l, g = _value_and_grad(global_params, cfg, micro, attn_impl)
        if grads is None:
            loss, grads = l, tree_map(lambda x: x.float(), g)
        else:
            loss = loss + l
            grads = tree_map(lambda a, x: a + x.float(), grads, g)
    return loss, grads


# ---------------------------------------------------------------------------
# Fused CSMAAFL train step
# ---------------------------------------------------------------------------
def csmaafl_train_step(global_params: Params,
                       batches: Dict[str, torch.Tensor],
                       coefs: torch.Tensor, lr: float, *, cfg: ModelConfig,
                       fed: FederatedConfig, attn_impl: str = "auto"
                       ) -> Tuple[Params, Dict[str, torch.Tensor]]:
    """One fused federated step.

    global_params : the global model (nested dicts of tensors)
    batches       : {"tokens", "labels"}, (C, K, b, S) int tensors —
                    per client, per local step, on the parameters' device
    coefs         : (C+1,) float32 — [c0, c_1..c_C] from the control plane
                    (c0 = Πβ_j; c_c = folded (1-β)·Πβ weights; Σ == 1)
    lr            : learning rate

    Returns (new_global_params, metrics)."""
    C = batches["tokens"].shape[0]
    coefs = coefs.float()
    c0, cc = coefs[0], coefs[1:]
    if fed.local_steps == 1:
        loss, grads = fused_value_and_grad(global_params, batches, cc,
                                           cfg=cfg, fed=fed,
                                           attn_impl=attn_impl)
        losses = loss[None]
        new_global = _sgd(global_params, grads, lr)
    else:
        # clients one after another; each local model lands in the
        # stacked (C, ...) leaves the blend reads, and is then dropped
        stacked = tree_map(
            lambda t: t.new_empty((C, *t.shape)), global_params)
        losses = []
        for c in range(C):
            local, loss = _local_sgd(
                global_params, {n: x[c] for n, x in batches.items()}, lr,
                cfg, fed.local_steps, attn_impl)
            tree_map(lambda s, w: s[c].copy_(w), stacked, local)
            losses.append(loss)
            del local
        losses = torch.stack(losses)
        new_global = agg_engine.weighted_sum_leaves(c0, global_params, cc,
                                                    stacked)
    metrics = {"loss_per_client": losses,
               "loss": losses.mean(),
               "coef0": c0,
               "num_clients": torch.tensor(C, dtype=torch.int32)}
    return new_global, metrics


def make_csmaafl_step(cfg: ModelConfig, fed: FederatedConfig, *,
                      attn_impl: str = "auto", device: DeviceLike = None
                      ) -> Callable:
    """The fused step bound to ``cfg``, ``fed`` and a device (the card
    unless ``device`` says otherwise; no card raises).  The returned
    ``step(params, batches, coefs, lr)`` takes batches as numpy arrays or
    tensors (moved to the device as int64) and coefs as a sequence or a
    tensor (moved as float32); the parameters must already be there.
    Full-f32 matmuls, as the reference computes them: TF32 off."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def step(params: Params, batches, coefs, lr: float):
        where = leaves(params)[0].device
        if where.type != dev.type:
            raise ValueError(f"the step runs on {dev}; the parameters are "
                             f"on {where}")
        batches = {n: _on(x, dev, torch.int64) for n, x in batches.items()}
        return csmaafl_train_step(params, batches,
                                  _on(coefs, dev, torch.float32), lr,
                                  cfg=cfg, fed=fed, attn_impl=attn_impl)

    return step


def _on(x, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return to_device(np.asarray(x), dev, dtype)


def make_sfl_step(cfg: ModelConfig, fed: FederatedConfig, *,
                  attn_impl: str = "auto", device: DeviceLike = None
                  ) -> Callable:
    """FedAvg: the same fused step with coefs = [0, α_1..α_C]."""
    return make_csmaafl_step(cfg, fed, attn_impl=attn_impl, device=device)
