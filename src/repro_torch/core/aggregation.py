"""Model-aggregation mathematics of CSMAAFL (paper Sections III-A/B/C).

Twin of ``repro/core/aggregation.py``.  The coefficients are host-side
float64 numpy math, exactly as in the reference; applying them to
parameters is the data plane (``core/agg_engine.py`` over the flat
buffer, through the CUDA ``weighted_agg`` kernel), with the per-leaf
oracles ``blend_pytree`` / ``weighted_sum_pytrees`` below over dicts of
tensors.

* ``sfl_alpha``             — eq. (5): α_m = |D_m| / Σ|D_c|.
* ``solve_betas``           — eqs. (7)-(10), closed form.
* ``staleness_coefficient`` — eq. (11): (1-β_j) = min(1, μ/(γ·j·(j-i))).
* ``StalenessTracker``      — the moving average μ_ji.
* ``fold_sequential_blends``— a trunk of sequential blends as one
  weighted sum.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def sfl_alpha(samples: Sequence[int]) -> np.ndarray:
    """α_m = |D_m| / Σ_c |D_c|   (eq. 5)."""
    d = np.asarray(samples, np.float64)
    if np.any(d <= 0):
        raise ValueError("all clients need positive sample counts")
    return d / d.sum()


def solve_betas(alpha: np.ndarray, schedule: Sequence[int]) -> np.ndarray:
    """Solve β_1..β_M (eqs. 9-10) so that M sequential AFL blends
    reproduce the SFL aggregation Σ α_m w^m exactly (eq. 7).

    ``schedule[j]`` is the client uploaded at iteration j (0-based).  The
    backward recurrence telescopes — Π_{k>j} β_k = Σ_{k<=j} α_φ(k) — so
    β_j = 1 - α_φ(j) / Σ_{k<=j} α_φ(k), and β_1 = 0."""
    M = len(schedule)
    if sorted(schedule) != list(range(M)):
        raise ValueError("schedule must be a permutation of range(M)")
    if abs(float(np.sum(alpha)) - 1.0) > 1e-9:
        raise ValueError("alpha must sum to 1")
    perm = np.asarray(alpha, np.float64)[list(schedule)]
    if np.any(perm < 0):
        raise ValueError("alpha must be nonnegative")
    prefix = np.cumsum(perm)
    betas = np.ones(M, np.float64)   # zero-prefix entries are don't-cares
    nz = prefix > 0.0
    betas[nz] = 1.0 - perm[nz] / prefix[nz]
    return betas


def staleness_coefficient(j: int, i: int, mu: float, gamma: float) -> float:
    """(1-β_j) = min(1, μ_ji / (γ · j · (j-i))) — eq. (11)."""
    if j < 1:
        raise ValueError("iterations are 1-based")
    stale = max(j - i, 1)        # j-i >= 1 once the first upload happens
    return float(min(1.0, mu / (gamma * j * stale)))


@dataclasses.dataclass
class StalenessTracker:
    """Moving average μ_ji of observed staleness values (j - i)."""
    momentum: float = 0.9
    mu: float = 1.0
    count: int = 0

    def update(self, staleness: float) -> float:
        staleness = max(float(staleness), 1.0)
        if self.count == 0:
            self.mu = staleness
        else:
            self.mu = self.momentum * self.mu + (1 - self.momentum) * staleness
        self.count += 1
        return self.mu


def fold_sequential_blends(betas: Sequence[float]
                           ) -> Tuple[float, np.ndarray]:
    """Fold w ← β_j w + (1-β_j) w_{c_j} applied for j = 1..J into
    (c0, coefs): w_final = c0·w_initial + Σ_j coefs[j]·w_{c_j}."""
    betas = np.asarray(betas, np.float64)
    J = len(betas)
    coefs = np.empty(J, np.float64)
    suffix = 1.0
    for j in range(J - 1, -1, -1):
        coefs[j] = (1.0 - betas[j]) * suffix
        suffix *= betas[j]
    return float(suffix), coefs


# ---------------------------------------------------------------------------
# Per-leaf reference oracles over dicts of tensors
# ---------------------------------------------------------------------------
Params = Dict[str, torch.Tensor]


def blend_pytree(global_params: Params, client_params: Params,
                 beta: float) -> Params:
    """eq. (3): w ← β·w_global + (1-β)·w_client  (single client)."""
    return weighted_sum_pytrees(beta, global_params, [1.0 - beta],
                                [client_params])


def weighted_sum_pytrees(coef0: float, global_params: Params,
                         coefs: Sequence[float], client_params_list
                         ) -> Params:
    """w ← c0·w_global + Σ_j c_j·w_j, leaf by leaf; coefficients are
    rounded to float32 and the sum accumulates in float32.  CPU tensors
    only: on the card every MAC goes through the ``weighted_agg`` kernel
    (``use_engine=True`` or a client plane)."""
    if any(t.device.type != "cpu" for t in global_params.values()):
        raise ValueError("the per-leaf oracle runs on CPU tensors only; "
                         "use use_engine=True on the card")
    c0 = float(np.float32(coef0))
    cs = [float(np.float32(c)) for c in coefs]
    out = {}
    for k, g in global_params.items():
        acc = c0 * g.float()
        for c, params in zip(cs, client_params_list):
            acc = acc + c * params[k].float()
        out[k] = acc.to(g.dtype)
    return out
