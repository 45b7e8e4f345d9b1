"""Client-fleet training plane — the client-side data plane.

Twin of the dense ``ClientPlane`` of ``repro/core/client_plane.py``.  The
whole fleet's models live as one device-resident (M, n) buffer of flat
rows (row m is client m's model), sharing the ``AggEngine``'s layout; the
server blend reads the uploader's row in place.

Local SGD runs the task's functional step over the flat row, one real
minibatch after another.  The reference pads step counts (and event
windows) to powers of two only so XLA compiles few program variants, and
its padded steps are masked no-ops; eager torch compiles nothing, so the
port runs exactly the real steps, with equal results.

The plane is built by a task (``CNNTask.client_plane``) from two
callables:

``step_fn(flat_row, batch) -> flat_row``
    one minibatch of local SGD on the (n,) flat row.
``batch_fn(cid, num_steps, seed) -> np.ndarray``
    the client's staged minibatch indices for one round, one row per
    minibatch; the same draws as the task's per-minibatch path.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch._device import to_device
from repro_torch.core.agg_engine import AggEngine
from repro_torch.core.scheduler import ClientSpec

StepFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
BatchFn = Callable[[int, int, int], np.ndarray]

# fleet rows start on 256-byte boundaries, so every row (not only the
# even ones) takes the kernel's 16-byte vector path whatever n is
_ROW_ALIGN_BYTES = 256


class ClientPlane:
    """Device-resident (M, n) client-state matrix + local training."""

    def __init__(self, engine: AggEngine, fleet: Sequence[ClientSpec],
                 step_fn: StepFn, batch_fn: BatchFn, *,
                 device: torch.device):
        self.engine = engine
        self.fleet = list(fleet)
        self.M = len(self.fleet)
        self.device = device
        # row m of the fleet buffer IS client m's model
        if any(c.cid != i for i, c in enumerate(self.fleet)):
            raise ValueError("client plane requires fleet[i].cid == i "
                             "(rows are addressed by cid)")
        if any(c.batch_size is not None for c in self.fleet):
            raise NotImplementedError(
                "per-client batch sizes (ClientSpec.batch_size) need the "
                "masked-mean loss, not ported yet (ROADMAP Queue 1 #3)")
        self.step_fn = step_fn
        self.batch_fn = batch_fn
        # cap on the AFL event-window length before a forced retrain
        # flush (None = only flush on uploader repeat)
        self.window_cap: Optional[int] = None

    # -- fleet buffer ---------------------------------------------------------
    def _alloc_fleet(self) -> torch.Tensor:
        """(M, n) view of an (M, n_pad) buffer whose rows are aligned."""
        dt = self.engine.storage_dtype
        per = _ROW_ALIGN_BYTES // torch.empty(0, dtype=dt).element_size()
        n = self.engine.n
        n_pad = -(-n // per) * per
        return torch.empty((self.M, n_pad), dtype=dt,
                           device=self.device)[:, :n]

    def memory_stats(self) -> dict:
        """The dense plane keeps all M rows resident, never prefetches."""
        return {"peak_device_rows": self.M, "prefetch_stalls": 0}

    # -- local training ------------------------------------------------------
    def _train_flat(self, flat: torch.Tensor, cid: int, num_steps: int,
                    seed: int) -> torch.Tensor:
        """Client ``cid``'s local SGD from ``flat``: one step per staged
        minibatch (the round's batches go to the device in one copy)."""
        batches = self.batch_fn(cid, num_steps, seed)
        if len(batches) == 0:
            raise ValueError("a training round needs at least one batch")
        staged = to_device(batches, self.device)
        for s in range(staged.shape[0]):
            flat = self.step_fn(flat, staged[s])
        return flat

    def init_fleet(self, g_flat: torch.Tensor, seed: int) -> torch.Tensor:
        """Every client trains from the initial broadcast w_0."""
        return self.train_all(g_flat, seed)

    def train_all(self, g_flat: torch.Tensor, seed: int,
                  local_steps_override: Optional[int] = None
                  ) -> torch.Tensor:
        """One fleet-wide round (FedAvg round / baseline-AFL broadcast):
        every client trains from ``g_flat``; returns a new fleet buffer."""
        buf = self._alloc_fleet()
        for c in self.fleet:
            k = local_steps_override or c.local_steps
            buf[c.cid] = self._train_flat(g_flat, c.cid, k, seed)
        return buf

    def train_row(self, fleet_buf: torch.Tensor, g_flat: torch.Tensor,
                  cid: int, num_steps: int, seed: int) -> torch.Tensor:
        """Client ``cid`` trains from the fresh global (eq. 4); its row is
        overwritten in place."""
        fleet_buf[cid] = self._train_flat(g_flat, cid, num_steps, seed)
        return fleet_buf

    def train_rows(self, fleet_buf: torch.Tensor,
                   entries: Sequence) -> torch.Tensor:
        """Event-window retrain: ``entries`` is a list of ``(cid, g_flat,
        num_steps, seed)`` with DISTINCT cids, each client training from
        the global it received at its own event; rows are overwritten in
        place.  Same math as sequential ``train_row`` calls."""
        cids = [e[0] for e in entries]
        if len(set(cids)) != len(cids):
            raise ValueError("event-window entries must have distinct cids")
        for cid, g, k, seed in entries:
            fleet_buf[cid] = self._train_flat(g, cid, k, seed)
        return fleet_buf
