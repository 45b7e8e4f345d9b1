"""Client scheduling for AFL (paper §II-C timing model + §III-C policy).

Twin of ``repro/core/scheduler.py``: an event-driven virtual-time
simulator of the heterogeneous client fleet, pure host code.  Its
timelines must equal the reference's field by field.

* Each client m has compute time ``tau_m`` per local iteration, a shared
  TDMA upload channel (one upload at a time, ``tau_u`` each) and download
  time ``tau_d``.
* AFL: a client computes, requests the upload channel, uploads; the
  server aggregates and sends the fresh global model back to that client
  only, which immediately starts its next local round.
* Tie-breaking (§III-C): among waiting clients the one whose model is
  older (smaller previous upload slot) goes first.
* Adaptive local iterations (§III-C): clients far from the median speed
  run more (fast) or fewer (slow) local iterations.
* SFL timing (§II-C): one round = tau_d + max_m(K_m·tau_m) + M·tau_u.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class ClientSpec:
    """Static description of one client.  ``batch_size`` (optional) is
    this client's local minibatch size; None keeps the task default."""
    cid: int
    tau_compute: float          # seconds per local iteration
    num_samples: int
    local_steps: int = 1        # K_m (possibly adapted)
    batch_size: Optional[int] = None   # B_m (None = task default)


@dataclasses.dataclass
class UploadEvent:
    """One approved upload == one AFL global iteration."""
    j: int                      # global iteration index (1-based)
    cid: int                    # uploading client
    i: int                      # iteration at which the client got its model
    t_request: float            # when the client finished computing
    t_complete: float           # when upload finished (aggregation instant)
    staleness: int              # j - i
    local_steps: int            # local iterations this round
    attempts: int = 1           # upload attempts (retries included)
    outcome: int = 0            # faults.OUTCOME_* code


@dataclasses.dataclass
class _Pending:
    """A client waiting for the channel."""
    t_ready: float
    cid: int
    last_slot: int              # previous upload slot (m'), -1 if never


def make_fleet(num_clients: int, *, tau: float, hetero_a: float,
               samples_per_client: Sequence[int], seed: int = 0,
               adaptive: bool = True, min_steps: int = 1,
               max_steps: int = 8, base_local_steps: int = 1,
               batch_sizes: Optional[Sequence[int]] = None
               ) -> List[ClientSpec]:
    """Sample a heterogeneous fleet: compute time log-uniform in
    [tau, a·tau] (paper: fastest = τ, slowest = a·τ)."""
    rng = np.random.default_rng(seed)
    if num_clients == 1:
        taus = np.array([tau])
    else:
        taus = np.exp(rng.uniform(np.log(tau), np.log(hetero_a * tau),
                                  num_clients))
        taus[rng.integers(num_clients)] = tau            # fastest
        taus[rng.integers(num_clients)] = hetero_a * tau  # slowest
    fleet = []
    median = float(np.median(taus))
    for cid in range(num_clients):
        k = base_local_steps
        if adaptive:
            # §III-C: equalize wall time per upload opportunity
            k = int(np.clip(round(base_local_steps * median / taus[cid]),
                            min_steps, max_steps))
        fleet.append(ClientSpec(cid=cid, tau_compute=float(taus[cid]),
                                num_samples=int(samples_per_client[cid]),
                                local_steps=k,
                                batch_size=(None if batch_sizes is None
                                            else int(batch_sizes[cid]))))
    return fleet


class _TraceExportMixin:
    """The event stream is a pure function of (fleet, tau_u, tau_d), so
    the whole timeline can be materialized once on the host."""

    def trace(self, max_iterations: int) -> List[UploadEvent]:
        return list(self.events(max_iterations))


class AFLScheduler(_TraceExportMixin):
    """Event-driven AFL channel scheduler (paper §III-C)."""

    def __init__(self, fleet: Sequence[ClientSpec], *, tau_u: float,
                 tau_d: float):
        self.fleet = list(fleet)
        self.tau_u = tau_u
        self.tau_d = tau_d

    def events(self, max_iterations: int) -> Iterator[UploadEvent]:
        tau_u, tau_d = self.tau_u, self.tau_d
        # (finish_time, cid): initial broadcast then first local round
        heap: List[Tuple[float, int]] = []
        model_iter = {c.cid: 0 for c in self.fleet}   # i per client
        last_slot = {c.cid: -1 for c in self.fleet}
        for c in self.fleet:
            heapq.heappush(heap,
                           (tau_d + c.local_steps * c.tau_compute, c.cid))
        t_channel_free = 0.0
        j = 0
        pending: List[_Pending] = []
        while j < max_iterations:
            # if nobody is waiting, advance to the next finisher
            if not pending:
                if not heap:
                    return
                t, cid = heapq.heappop(heap)
                pending.append(_Pending(t, cid, last_slot[cid]))
            # gather every client that has finished by the time the
            # channel can serve the earliest requester
            t_serve = max(t_channel_free, min(p.t_ready for p in pending))
            while heap and heap[0][0] <= t_serve:
                t, cid = heapq.heappop(heap)
                pending.append(_Pending(t, cid, last_slot[cid]))
            # §III-C tie-break: the older model (smaller m') wins
            j += 1
            ready = [p for p in pending if p.t_ready <= t_serve]
            choice = min(ready, key=lambda p: (p.last_slot, p.t_ready, p.cid))
            pending.remove(choice)
            cid = choice.cid
            spec = self.fleet[cid]
            t_done = t_serve + tau_u
            i = model_iter[cid]
            yield UploadEvent(j=j, cid=cid, i=i, t_request=choice.t_ready,
                              t_complete=t_done, staleness=j - i,
                              local_steps=spec.local_steps)
            # server sends fresh model back; client starts next local round
            model_iter[cid] = j
            last_slot[cid] = j
            t_channel_free = t_done
            t_next = t_done + tau_d + spec.local_steps * spec.tau_compute
            heapq.heappush(heap, (t_next, cid))


class BaselineAFLScheduler(_TraceExportMixin):
    """§III-B baseline: (a) strict cycles, faster clients first, (b) each
    cycle's schedule fixed by completion order, (c) the global model is
    redistributed every M iterations.  ``i`` is the iteration at the
    start of the client's cycle."""

    def __init__(self, fleet: Sequence[ClientSpec], *, tau_u: float,
                 tau_d: float):
        self.fleet = list(fleet)
        self.tau_u = tau_u
        self.tau_d = tau_d

    def cycle_order(self) -> List[int]:
        """Completion order within a cycle: fastest first."""
        return [c.cid for c in sorted(
            self.fleet, key=lambda c: (c.local_steps * c.tau_compute, c.cid))]

    def events(self, max_iterations: int) -> Iterator[UploadEvent]:
        tau_u, tau_d = self.tau_u, self.tau_d
        order = self.cycle_order()
        model_iter = {c.cid: 0 for c in self.fleet}
        t = 0.0
        j = 0
        while j < max_iterations:
            t_ready = {c.cid: t + tau_d + c.local_steps * c.tau_compute
                       for c in self.fleet}
            t_channel = 0.0
            for cid in order:
                if j >= max_iterations:
                    return
                j += 1
                spec = self.fleet[cid]
                t_serve = max(t_channel, t_ready[cid])
                t_done = t_serve + tau_u
                yield UploadEvent(j=j, cid=cid, i=model_iter[cid],
                                  t_request=t_ready[cid], t_complete=t_done,
                                  staleness=j - model_iter[cid],
                                  local_steps=spec.local_steps)
                t_channel = t_done
                model_iter[cid] = j
            t = t_channel   # next cycle starts after last upload
            # requirement (c): every client now holds iteration j's model
            for c in self.fleet:
                model_iter[c.cid] = j


def sfl_round_time(fleet: Sequence[ClientSpec], *, tau_u: float,
                   tau_d: float, local_steps: int = 1) -> float:
    """One SFL round: τ_d + max_m(K·τ_m) + M·τ_u  (TDMA uploads)."""
    slowest = max(local_steps * c.tau_compute for c in fleet)
    return tau_d + slowest + len(fleet) * tau_u
