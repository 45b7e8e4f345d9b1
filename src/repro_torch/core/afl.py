"""Asynchronous federated learning loops (paper §II-B, §III).

Twin of the windowed loop of ``repro/core/afl.py``.  Three AFL
aggregation modes over the same event-driven scheduler:

* ``afl_alpha``    — §III-A: naive reuse of SFL's α as (1-β) (the
  geometric contribution decay, the paper's negative result).
* ``afl_baseline`` — §III-B: strict-cycle scheduling + the triangular-
  solved β_j, so every M iterations reproduce one FedAvg round exactly.
* ``csmaafl``      — §III-C: fairness scheduling + eq. (11) staleness-
  aware coefficients (Algorithm 1).

The server stores only the global model and the scalar staleness
tracker; each client holds its own model (a row of the plane's fleet
buffer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import aggregation as agg
from repro_torch.core import faults as flt
from repro_torch.core.agg_engine import engine_for
from repro_torch.core.scheduler import (AFLScheduler, BaselineAFLScheduler,
                                        ClientSpec, UploadEvent)
from repro_torch.core.sfl import EvalFn, FLHistory, LocalTrainFn


@dataclasses.dataclass
class AFLResult:
    params: Any
    history: FLHistory
    events: List[UploadEvent]
    betas: List[float]
    # plane runs return the device state: {"fleet_buf", "g_flat", "cursor"}
    state: Optional[Dict[str, Any]] = None
    # participation accounting under ``stats["faults"]`` plus the plane's
    # memory counters
    stats: Optional[Dict[str, Any]] = None


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet ({item})")


def run_afl(params0, fleet: Sequence[ClientSpec],
            local_train_fn: Optional[LocalTrainFn], *,
            algorithm: str,              # afl_alpha | afl_baseline | csmaafl
            iterations: int, tau_u: float, tau_d: float,
            gamma: float = 0.4, mu_momentum: float = 0.9,
            eval_fn: Optional[EvalFn] = None, eval_every: int = 10,
            server_opt: Optional[str] = None, server_lr: float = 1.0,
            max_staleness: Optional[int] = None,
            use_engine: bool = True,
            client_plane=None, use_client_plane: bool = True,
            compiled_loop: bool = False,
            resume_state: Optional[Dict[str, Any]] = None,
            faults=None, guards=None,
            autosave_every: Optional[int] = None,
            autosave_dir: Optional[str] = None,
            autosave_keep_last: Optional[int] = 3,
            stop_flag=None,
            seed: int = 0) -> AFLResult:
    """Run one AFL variant; one event == one global iteration (eq. 3).
    Twin of the reference's windowed ``_run_afl_impl``.

    Data planes, most fused first (all the same math):

    * ``client_plane`` (used when ``use_client_plane``): the fleet lives
      as one (M, n) device buffer; each event is one C=1 kernel launch
      reading the uploader's row in place, and retrains are queued per
      event window.
    * ``use_engine=True`` (no plane): per-event blend over the flat
      buffer through the kernel; local training is the task's
      per-minibatch loop.
    * neither: the per-leaf ``aggregation.blend_pytree`` reference path.

    ``max_staleness`` drops uploads staler than the bound (the client
    still receives the fresh global model).  The compiled loop, server
    optimizer, faults, guards, autosave/resume and stop flag raise
    ``NotImplementedError``."""
    if compiled_loop or resume_state is not None:
        raise _not_ported("the compiled loop and resume",
                          "ROADMAP Queue 1 #6")
    if server_opt is not None:
        raise _not_ported("the server optimizer", "ROADMAP Queue 1 #6")
    if guards is not None:
        raise _not_ported("update guards", "ROADMAP Queue 1 #7")
    if autosave_every is not None or autosave_dir is not None \
            or stop_flag is not None:
        raise _not_ported("autosave and stop", "ROADMAP Queue 1 #7")
    flt.resolve_faults(faults)

    M = len(fleet)
    alpha = agg.sfl_alpha([c.num_samples for c in fleet])
    plane = client_plane if (use_client_plane and client_plane is not None) \
        else None
    if plane is None and local_train_fn is None:
        raise ValueError("local_train_fn is required without a client plane")

    if algorithm == "afl_baseline":
        sched = BaselineAFLScheduler(fleet, tau_u=tau_u, tau_d=tau_d)
        cycle_betas = agg.solve_betas(alpha, sched.cycle_order())
    elif algorithm in ("afl_alpha", "csmaafl"):
        sched = AFLScheduler(fleet, tau_u=tau_u, tau_d=tau_d)
    else:
        raise ValueError(f"unknown AFL algorithm '{algorithm}'")

    tracker = agg.StalenessTracker(momentum=mu_momentum)
    global_params = params0
    engine = g_flat = fleet_buf = None
    if plane is not None:
        # fleet-resident mode: global model AND every client model live
        # as flat device buffers; parameter dicts exist only for eval
        engine = plane.engine
        global_params = None
        g_flat = engine.flatten(params0)
        # every client immediately trains on the initial broadcast w_0
        fleet_buf = plane.init_fleet(g_flat, seed * 100003)
    else:
        if use_engine:
            engine = engine_for(params0)
            g_flat = engine.flatten(params0)
        client_models: Dict[int, Any] = {}
        for c in fleet:
            client_models[c.cid] = local_train_fn(
                params0, c.cid, c.local_steps, seed * 100003)

    def cur_params():
        return engine.unflatten(g_flat) if global_params is None \
            else global_params

    # --- event-window retrain batching (plane mode) ---------------------
    # A client's retrain is only consumed at its NEXT upload, so retrains
    # for a window of events with distinct uploaders are independent:
    # queue (cid, g-snapshot, K, seed) and flush when a cid repeats, when
    # the window hits the plane's ``window_cap``, or at loop end.
    pending: List[tuple] = []
    pending_cids = set()

    def flush_pending():
        nonlocal fleet_buf
        if pending:
            fleet_buf = plane.train_rows(fleet_buf, pending)
            pending.clear()
            pending_cids.clear()

    def queue_retrain(cid, steps, seed_j):
        # every blend allocates a new g_flat (out of place), so a plain
        # reference is a stable snapshot; a blend made in place would
        # have to clone here (the reference copies because it donates)
        pending.append((cid, g_flat, steps, seed_j))
        pending_cids.add(cid)
        cap = plane.window_cap
        if cap is not None and len(pending) >= cap:
            flush_pending()

    hist = FLHistory()
    events: List[UploadEvent] = []
    betas: List[float] = []
    stale_flags: List[bool] = []
    if eval_fn is not None:
        hist.add(0.0, 0, eval_fn(cur_params()))

    for ev in sched.events(iterations):
        events.append(ev)
        if ev.outcome != flt.OUTCOME_OK:
            # fault-dropped upload (none without fault injection)
            betas.append(1.0)
            stale_flags.append(False)
        else:
            # ---- choose the aggregation coefficient ----
            if algorithm == "afl_alpha":
                one_minus_beta = float(alpha[ev.cid])      # §III-A naive
            elif algorithm == "afl_baseline":
                pos_in_cycle = (ev.j - 1) % M
                one_minus_beta = 1.0 - float(cycle_betas[pos_in_cycle])
            else:  # csmaafl, eq. (11)
                mu = tracker.update(ev.staleness)
                one_minus_beta = agg.staleness_coefficient(
                    ev.j, ev.i, mu, gamma)
            stale = (max_staleness is not None
                     and ev.staleness > max_staleness)
            stale_flags.append(stale)
            if stale:
                one_minus_beta = 0.0      # admission control: drop update
            beta = 1.0 - one_minus_beta
            betas.append(beta)

            # ---- eq. (3): w_{j+1} = β w_j + (1-β) w_i^m ----
            if plane is not None:
                if ev.cid in pending_cids:
                    # this uploader's pending retrain feeds this blend
                    flush_pending()
                g_flat = engine.blend_row_flat(g_flat, fleet_buf, ev.cid,
                                               beta)
            elif engine is not None:
                g_flat, global_params = engine.blend_flat(
                    g_flat, client_models[ev.cid], beta)
            else:
                global_params = agg.blend_pytree(
                    global_params, client_models[ev.cid], beta)

            # ---- §II-B: only the uploader receives w_{j+1} (eq. 4) ----
            if algorithm != "afl_baseline":
                if plane is not None:
                    queue_retrain(ev.cid, ev.local_steps,
                                  seed * 100003 + ev.j)
                else:
                    client_models[ev.cid] = local_train_fn(
                        global_params, ev.cid, ev.local_steps,
                        seed * 100003 + ev.j)

        # ---- §III-B requirement (c): broadcast to *all* clients every
        # M iterations; mid-cycle, clients keep the cycle-start model
        if algorithm == "afl_baseline" and ev.j % M == 0:
            if plane is not None:
                fleet_buf = plane.train_all(g_flat, seed * 100003 + ev.j)
            else:
                for c in fleet:
                    client_models[c.cid] = local_train_fn(
                        global_params, c.cid, c.local_steps,
                        seed * 100003 + ev.j)

        if eval_fn is not None and ev.j % eval_every == 0:
            hist.add(ev.t_complete, ev.j, eval_fn(cur_params()))

    state = None
    if plane is not None:
        flush_pending()       # leave the fleet buffer fully retrained
        state = {"fleet_buf": fleet_buf, "g_flat": g_flat,
                 "cursor": len(events)}
    stats = {"faults": flt.participation_stats(
        [e.cid for e in events], betas,
        [e.outcome != flt.OUTCOME_OK for e in events], stale_flags, M,
        attempts=[e.attempts for e in events],
        outcomes=[e.outcome for e in events],
        staleness=[e.staleness for e in events])}
    stats.update(plane.memory_stats() if plane is not None
                 else {"peak_device_rows": M, "prefetch_stalls": 0})
    return AFLResult(cur_params(), hist, events, betas, state, stats)
