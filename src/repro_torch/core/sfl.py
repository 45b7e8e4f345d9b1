"""Synchronous federated learning (FedAvg) — the paper's SFL baseline.

Twin of ``repro/core/sfl.py`` (§II-A): each round the server broadcasts
w_t, every client runs local SGD from w_t, and the server aggregates with
the sample-count coefficients α_m (eq. 2/5).  Virtual time follows the
§II-C TDMA timing model so SFL and AFL curves share the time axis.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import aggregation as agg
from repro_torch.core.scheduler import ClientSpec, sfl_round_time

LocalTrainFn = Callable[[Any, int, int, int], Any]
# (params, cid, num_steps, round_seed) -> new_params
EvalFn = Callable[[Any], Dict[str, float]]


@dataclasses.dataclass
class FLHistory:
    """Common result record for all algorithms."""
    times: List[float] = dataclasses.field(default_factory=list)
    iterations: List[int] = dataclasses.field(default_factory=list)
    metrics: List[Dict[str, float]] = dataclasses.field(default_factory=list)

    def add(self, t: float, it: int, m: Dict[str, float]) -> None:
        self.times.append(t)
        self.iterations.append(it)
        self.metrics.append(m)

    def series(self, key: str) -> np.ndarray:
        return np.asarray([m[key] for m in self.metrics])


def run_fedavg(params0, fleet: Sequence[ClientSpec],
               local_train_fn: Optional[LocalTrainFn], *,
               rounds: int, tau_u: float, tau_d: float,
               eval_fn: Optional[EvalFn] = None, eval_every: int = 1,
               local_steps_override: Optional[int] = None,
               use_engine: bool = True,
               client_plane=None, use_client_plane: bool = True,
               seed: int = 0):
    """Classical FedAvg (paper eq. 1-2); twin of the reference's
    ``_run_fedavg_impl``.  Returns (params, FLHistory).

    ``client_plane`` (used when ``use_client_plane``): one round of local
    SGD over the (M, n) fleet buffer, and eq. (2) as one C=M kernel launch
    over its rows.  Without a plane, ``use_engine`` applies eq. (2) as one
    launch over the flattened client models, else leaf by leaf."""
    alpha = agg.sfl_alpha([c.num_samples for c in fleet])
    plane = client_plane if (use_client_plane and client_plane is not None) \
        else None
    if plane is None and local_train_fn is None:
        raise ValueError("local_train_fn is required without a client plane")
    params = params0
    engine = g_flat = None
    if plane is not None:
        engine = plane.engine
        g_flat = engine.flatten(params0)
    elif use_engine:
        from repro_torch.core.agg_engine import engine_for
        engine = engine_for(params0)
        g_flat = engine.flatten(params0)
    hist = FLHistory()
    t = 0.0
    if eval_fn is not None:
        hist.add(t, 0, eval_fn(params))
    for rnd in range(1, rounds + 1):
        if plane is not None:
            fleet_buf = plane.train_all(g_flat, seed * 100003 + rnd,
                                        local_steps_override)
            # eq. (2) straight off the fleet buffer's rows
            g_flat = engine.weighted_sum_rows_flat(
                0.0, g_flat, list(alpha), fleet_buf)
        else:
            locals_ = []
            for c in fleet:
                k = local_steps_override or c.local_steps
                locals_.append(local_train_fn(params, c.cid, k,
                                              seed * 100003 + rnd))
            # eq. (2): w_{t+1} = Σ α_m w_t^m
            if engine is not None:
                g_flat, params = engine.weighted_sum_flat(
                    0.0, g_flat, list(alpha), locals_)
            else:
                params = agg.weighted_sum_pytrees(
                    0.0, params, list(alpha), locals_)
        t += sfl_round_time(fleet, tau_u=tau_u, tau_d=tau_d,
                            local_steps=local_steps_override or 1)
        if eval_fn is not None and rnd % eval_every == 0:
            if plane is not None:
                params = engine.unflatten(g_flat)
            hist.add(t, rnd, eval_fn(params))
    if plane is not None:
        params = engine.unflatten(g_flat)
    return params, hist
