"""Federated data partitioners (paper §IV settings + a Dirichlet extension).

Twin of ``repro/data/federated.py``; every draw is the reference's, so
partitions and batch index arrays are bit-equal across the two packages
(that equality is what lets both draw identical minibatches).

* ``partition_iid``      — images randomly allocated equally (paper IID).
* ``partition_label``    — each client gets ``classes_per_client`` classes
  (paper non-IID: 2 classes, ≈600 images per client with 100 clients).
* ``partition_dirichlet``— Dir(α) label skew (beyond-paper).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence

import numpy as np

PartitionFn = Callable[..., List[np.ndarray]]


def partition_iid(labels: np.ndarray, num_clients: int, *, seed: int = 0
                  ) -> List[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, num_clients)]


def partition_label(labels: np.ndarray, num_clients: int, *,
                    classes_per_client: int = 2, seed: int = 0
                    ) -> List[np.ndarray]:
    """Paper non-IID: sort by label, split into num_clients*cpc shards,
    deal ``classes_per_client`` shards to each client (McMahan et al.)."""
    rng = np.random.default_rng(seed)
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, num_clients * classes_per_client)
    shard_ids = rng.permutation(num_clients * classes_per_client)
    out = []
    for c in range(num_clients):
        take = shard_ids[c * classes_per_client:(c + 1) * classes_per_client]
        out.append(np.sort(np.concatenate([shards[s] for s in take])))
    return out


def partition_dirichlet(labels: np.ndarray, num_clients: int, *,
                        alpha: float = 0.5, seed: int = 0,
                        min_per_client: int = 0) -> List[np.ndarray]:
    """Dir(α) label skew.  ``min_per_client`` > 0 rebalances after the
    draw: clients below the minimum take samples from the richest
    clients, deterministically."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    buckets: List[List[int]] = [[] for _ in range(num_clients)]
    for cls in classes:
        idx = np.where(labels == cls)[0]
        rng.shuffle(idx)
        props = rng.dirichlet([alpha] * num_clients)
        cuts = (np.cumsum(props) * len(idx)).astype(int)[:-1]
        for cid, chunk in enumerate(np.split(idx, cuts)):
            buckets[cid].extend(chunk.tolist())
    if min_per_client > 0:
        if min_per_client * num_clients > len(labels):
            raise ValueError(
                f"min_per_client={min_per_client} x {num_clients} clients "
                f"exceeds the {len(labels)}-sample dataset")
        for cid in range(num_clients):
            while len(buckets[cid]) < min_per_client:
                donor = max(range(num_clients),
                            key=lambda c: len(buckets[c]))
                buckets[cid].append(buckets[donor].pop())
    return [np.sort(np.asarray(b, np.int64)) for b in buckets]


PARTITIONERS: Dict[str, PartitionFn] = {
    "iid": partition_iid,
    "label": partition_label,
    "dirichlet": partition_dirichlet,
}


def partition(name: str, labels: np.ndarray, num_clients: int, *,
              seed: int = 0, **kw) -> List[np.ndarray]:
    """Dispatch by name: ``partition("dirichlet", y, M, alpha=.5)``."""
    if name not in PARTITIONERS:
        raise KeyError(f"unknown partitioner '{name}' — known: "
                       f"{sorted(PARTITIONERS)}")
    return PARTITIONERS[name](labels, num_clients, seed=seed, **kw)


@dataclasses.dataclass
class ClientDataset:
    """One client's local shard with reproducible batch sampling.

    ``images``/``labels`` are the FULL dataset arrays (shared across all
    clients, never copied) and ``indices`` this client's sample indices
    into them."""
    images: np.ndarray
    labels: np.ndarray
    cid: int
    indices: np.ndarray

    @property
    def num_samples(self) -> int:
        return len(self.indices)

    def batch_indices(self, batch_size: int, num_batches: int, seed: int
                      ) -> np.ndarray:
        """(num_batches, batch_size) sample indices into this shard —
        without replacement per epoch (reshuffling across epochs),
        deterministic given seed; the single source of batch order."""
        rng = np.random.default_rng((seed * 9176 + self.cid) % (2**63))
        rows = []
        order = rng.permutation(self.num_samples)
        ptr = 0
        for _ in range(num_batches):
            if ptr + batch_size > self.num_samples:
                order = rng.permutation(self.num_samples)
                ptr = 0
            rows.append(order[ptr:ptr + batch_size])
            ptr += batch_size
        if not rows:
            return np.zeros((0, batch_size), np.int64)
        return np.stack(rows)


def make_clients(images: np.ndarray, labels: np.ndarray,
                 partitions: Sequence[np.ndarray]) -> List[ClientDataset]:
    return [ClientDataset(images, labels, cid, np.asarray(p))
            for cid, p in enumerate(partitions)]
