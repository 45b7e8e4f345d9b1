"""Fused flat-buffer aggregation engine — the server-blend data plane.

Twin of ``repro/core/agg_engine.py``.  The model's parameter dict is
flattened into one contiguous (n,) buffer, and every server blend is one
launch of the CUDA ``weighted_agg`` kernel over it:

* ``blend_flat`` / ``blend_row_flat`` — single-event eq. (3), C=1; the row
  form reads row ``cid`` of the (M, n) fleet buffer in place (a view, no
  copy);
* ``blend_rows_flat`` / ``blend_rows_fleet`` — a trunk of K sequential
  eq.-(3) blends folded (``aggregation.fold_sequential_blends``) into one
  C=K launch; the fleet form hands the kernel the cids and lets it read
  the rows in place;
* ``weighted_sum_flat`` / ``weighted_sum_rows_flat`` — eq. (2) over C=M
  clients; the row form reads the fleet buffer itself;
* ``weighted_sum_leaves`` — the per-leaf twin used by the fused LM step
  (``core/distributed.py``): one launch per parameter leaf.

Leaf order is the reference's: ``jax.tree.flatten`` sorts dict keys, so
the CNN row is ``conv1_b, conv1_w, conv2_b, conv2_w, fc1_b, fc1_w, fc2_b,
fc2_w`` at the same offsets, and a port row compares with a reference row
element by element.

Coefficients are built exactly as the reference builds them: a single
blend uses ``[f32(β), 1 − f32(β)]`` with the subtraction in float32, a
folded trunk is folded in float64 and then rounded to float32.

``mode="kernel"`` (the default) goes through the kernel's wrapper, which
takes the plain version for CPU tensors; ``mode="torch"`` (the twin of
the reference's ``"xla"``) calls the plain version ``weighted_agg_ref``
directly, for CPU tensors only.
Every blend is out of place: the result is a new buffer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import to_device
from repro_torch._tree import leaves, tree_map
from repro_torch.core import aggregation as agg
from repro_torch.kernels.weighted_agg.ref import weighted_agg_ref
from repro_torch.kernels.weighted_agg.weighted_agg import weighted_agg_flat2d

Params = Dict[str, torch.Tensor]


def pow2_bucket(n: int) -> int:
    """Next power of two ≥ n (the reference's bucketing policy; the port
    pads neither C nor step counts, since nothing is compiled per size)."""
    if n <= 0:
        raise ValueError("bucket size must be positive")
    return 1 << (n - 1).bit_length()


def _blend_coefs(beta: float) -> np.ndarray:
    """[f32(β), 1 − f32(β)], the subtraction in float32."""
    b = np.float32(beta)
    return np.array([b, np.float32(1.0) - b], np.float32)


def _cat_coefs(coef0, coefs) -> np.ndarray:
    return np.concatenate([np.reshape(np.float32(coef0), (1,)),
                           np.asarray(coefs, np.float32)])


class AggEngine:
    """Flat-buffer blend engine for one parameter layout.

    ``template`` is a dict of tensors with the target names, shapes and
    dtypes (values are not read)."""

    def __init__(self, template: Params, *, mode: str = "kernel"):
        if not template:
            raise ValueError("template has no leaves")
        if mode not in ("kernel", "torch"):
            raise ValueError(f"unknown engine mode '{mode}'")
        self.mode = mode
        self.names = tuple(sorted(template))
        self.shapes = tuple(tuple(template[k].shape) for k in self.names)
        self.dtypes = tuple(template[k].dtype for k in self.names)
        self.sizes = tuple(int(np.prod(s)) if s else 1 for s in self.shapes)
        self.offsets = tuple(np.cumsum((0,) + self.sizes[:-1]).tolist())
        self.n = int(sum(self.sizes))
        # storage follows the leaves (bf16 leaves, bf16 storage; the MAC
        # accumulates in f32 either way)
        dt = self.dtypes[0]
        for d in self.dtypes[1:]:
            dt = torch.promote_types(dt, d)
        self.storage_dtype = dt

    # -- flat store ---------------------------------------------------------
    def flatten(self, tree: Params) -> torch.Tensor:
        """Dict of tensors -> contiguous (n,) storage buffer."""
        return torch.cat([tree[k].reshape(-1).to(self.storage_dtype)
                          for k in self.names])

    def unflatten(self, flat: torch.Tensor) -> Params:
        """(n,) buffer -> dict of views (leaf dtypes restored).  Works on
        any tensor, including ``torch.func`` transformed ones, so a loss
        over the flat vector differentiates straight to a flat gradient."""
        return {k: flat[off:off + sz].view(sh).to(dt)
                for k, off, sz, sh, dt in zip(self.names, self.offsets,
                                              self.sizes, self.shapes,
                                              self.dtypes)}

    # -- the MAC --------------------------------------------------------------
    def _mac(self, g_flat: torch.Tensor, rows: torch.Tensor,
             coefs: np.ndarray, cids: Optional[np.ndarray] = None
             ) -> torch.Tensor:
        dev = g_flat.device
        if self.mode == "torch":
            if dev.type != "cpu":
                raise ValueError("engine mode 'torch' runs on CPU tensors "
                                 "only; use mode='kernel' on the card")
            return weighted_agg_ref(
                g_flat, rows, torch.from_numpy(coefs),
                None if cids is None else torch.from_numpy(cids))
        cids_t = None
        if cids is not None:
            if cids.size and (cids.min() < 0 or cids.max() >= rows.shape[0]):
                raise IndexError(f"cids out of range for {rows.shape[0]} "
                                 f"rows: {cids.tolist()}")
            cids_t = to_device(cids.astype(np.int32), dev)
        return weighted_agg_flat2d(g_flat, rows, to_device(coefs, dev),
                                   cids_t)

    # -- fused blends over the flat store -----------------------------------
    def blend_flat(self, g_flat, client_tree: Params, beta
                   ) -> Tuple[torch.Tensor, Params]:
        """Single-event eq. (3) on the flat store; returns (flat, tree)."""
        new = self._mac(g_flat, self.flatten(client_tree)[None],
                        _blend_coefs(beta))
        return new, self.unflatten(new)

    def weighted_sum_flat(self, coef0, g_flat, coefs,
                          client_trees: Sequence[Params]
                          ) -> Tuple[torch.Tensor, Params]:
        """Baseline cycle (eq. 2/7): w ← c0·w + Σ c_m·w_m, one launch."""
        rows = torch.stack([self.flatten(t) for t in client_trees])
        new = self._mac(g_flat, rows, _cat_coefs(coef0, coefs))
        return new, self.unflatten(new)

    # -- row-addressed blends over a (M, n) fleet buffer --------------------
    def blend_row_flat(self, g_flat, fleet_buf, cid: int, beta
                       ) -> torch.Tensor:
        """Single-event eq. (3) against row ``cid`` of the fleet buffer,
        read in place."""
        if not 0 <= cid < fleet_buf.shape[0]:
            raise IndexError(f"cid {cid} out of range for "
                             f"{fleet_buf.shape[0]} rows")
        return self._mac(g_flat, fleet_buf[cid:cid + 1], _blend_coefs(beta))

    def blend_rows_flat(self, g_flat, rows: torch.Tensor,
                        betas: Sequence[float]) -> torch.Tensor:
        """Trunk of K sequential eq.-(3) blends whose client models are
        the (K, n) ``rows``, folded into one C=K launch."""
        K = rows.shape[0]
        if K != len(betas):
            raise ValueError("one beta per queued row")
        if K == 1:
            return self._mac(g_flat, rows, _blend_coefs(betas[0]))
        c0, coefs = agg.fold_sequential_blends([float(b) for b in betas])
        return self._mac(g_flat, rows, _cat_coefs(c0, coefs))

    def weighted_sum_rows_flat(self, coef0, g_flat, coefs,
                               rows: torch.Tensor) -> torch.Tensor:
        """Baseline cycle (eq. 2/7) where the M client models are the
        (M, n) fleet buffer itself: w ← c0·w + Σ c_m·rows[m]."""
        return self._mac(g_flat, rows, _cat_coefs(coef0, coefs))

    def blend_rows_fleet(self, g_flat, fleet_buf, cids: Sequence[int],
                         betas: Sequence[float]) -> torch.Tensor:
        """Trunk of K sequential eq.-(3) blends whose client models are
        rows ``cids`` of the fleet buffer, read in place by the kernel."""
        if len(cids) != len(betas):
            raise ValueError("one beta per queued row")
        c0, coefs = agg.fold_sequential_blends([float(b) for b in betas])
        return self._mac(g_flat, fleet_buf, _cat_coefs(c0, coefs),
                         np.asarray(cids, np.int32))

    # -- FedOpt pseudo-gradient on the flat buffer ---------------------------
    def delta_row_flat(self, g_flat, fleet_buf, cid: int, scale
                       ) -> torch.Tensor:
        """(n,) f32 pseudo-gradient scale·(w − row_cid)."""
        return float(np.float32(scale)) * (g_flat.float()
                                           - fleet_buf[cid].float())


_ENGINES: Dict[Any, AggEngine] = {}


def engine_for(template: Params, *, mode: str = "kernel") -> AggEngine:
    """Fetch (or build) the cached engine for ``template``'s layout."""
    key = (tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted(template.items())), mode)
    eng = _ENGINES.get(key)
    if eng is None:
        eng = AggEngine(template, mode=mode)
        _ENGINES[key] = eng
    return eng


# ---------------------------------------------------------------------------
# Per-leaf twin for the fused LM step
# ---------------------------------------------------------------------------
def weighted_sum_leaves(coef0, global_tree, coefs, clients_stacked_tree):
    """w ← c0·w + Σ_c c_c·w_c with a leading client dim on every leaf of
    ``clients_stacked_tree`` (nested dicts and lists of tensors).

    Used by the fused step (``core/distributed.py``).  The reference keeps
    separate per-leaf ``tensordot``s so that GSPMD lowers each to a
    weighted all-reduce; here each leaf is one launch of the
    weighted-aggregation kernel, global leaf (n,), client leaves (C, n),
    coefficients [c0, c_1..c_C] in f32 (on a CPU tensor the wrapper takes
    the plain version).  f32 accumulation, output in the leaf's dtype."""
    dev = leaves(global_tree)[0].device
    c = torch.cat([torch.as_tensor(coef0, dtype=torch.float32,
                                   device=dev).reshape(1),
                   torch.as_tensor(coefs, dtype=torch.float32,
                                   device=dev).reshape(-1)])

    def leaf(g, w):
        out = weighted_agg_flat2d(g.reshape(-1), w.reshape(w.shape[0], -1),
                                  c)
        return out.reshape(g.shape)

    return tree_map(leaf, global_tree, clients_stacked_tree)
