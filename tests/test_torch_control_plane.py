"""The port's host control plane equals the reference's.

Dataset arrays, partitions, batch indices, fleets, both schedulers'
timelines and the coefficient math must be EQUAL (not close) between
``repro_torch`` and ``repro``: that equality is what makes the two
packages draw identical minibatches and blend with identical βs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import aggregation as j_agg
from repro.core import faults as j_flt
from repro.core import scheduler as j_sched
from repro.data import federated as j_fd
from repro.data import mnist_like as j_mnist
from repro_torch.core import aggregation as t_agg
from repro_torch.core import faults as t_flt
from repro_torch.core import scheduler as t_sched
from repro_torch.data import federated as t_fd
from repro_torch.data import mnist_like as t_mnist

torch.set_num_threads(2)


@pytest.mark.parametrize("variant,seed", [("digits", 0), ("fashion", 3)])
def test_dataset_arrays_equal(variant, seed):
    a = j_mnist.make_dataset(variant, train_n=200, test_n=50, seed=seed)
    b = t_mnist.make_dataset(variant, train_n=200, test_n=50, seed=seed)
    for f in ("train_x", "train_y", "test_x", "test_y"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name,kw", [
    ("iid", {}),
    ("label", {"classes_per_client": 2}),
    ("dirichlet", {"alpha": 0.3, "min_per_client": 5}),
])
def test_partitions_equal(name, kw):
    labels = np.random.default_rng(11).integers(0, 10, 500).astype(np.int32)
    a = j_fd.partition(name, labels, 7, seed=5, **kw)
    b = t_fd.partition(name, labels, 7, seed=5, **kw)
    assert len(a) == len(b) == 7
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("batch_size,num_batches,seed",
                         [(5, 8, 0), (7, 30, 12), (3, 0, 4)])
def test_batch_indices_equal(batch_size, num_batches, seed):
    """Including reshuffles across epochs (30 batches of 7 > 40 samples)."""
    labels = np.random.default_rng(2).integers(0, 10, 200).astype(np.int32)
    images = np.zeros((200, 1), np.float32)
    parts = j_fd.partition_label(labels, 5, seed=1)
    a = j_fd.make_clients(images, labels, parts)
    b = t_fd.make_clients(images, labels, parts)
    for ca, cb in zip(a, b):
        assert ca.num_samples == cb.num_samples
        x = ca.batch_indices(batch_size, num_batches, seed)
        y = cb.batch_indices(batch_size, num_batches, seed)
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


FLEETS = [
    dict(num_clients=6, tau=1.0, hetero_a=6.0, seed=7),
    dict(num_clients=9, tau=0.5, hetero_a=8.0, seed=2, adaptive=False),
    dict(num_clients=5, tau=1.0, hetero_a=4.0, seed=1,
         batch_sizes=[4, 5, 6, 7, 8]),
    dict(num_clients=1, tau=2.0, hetero_a=3.0, seed=0),
]


def _fleets(kw):
    samples = [60 + 10 * m for m in range(kw["num_clients"])]
    return (j_sched.make_fleet(samples_per_client=samples, **kw),
            t_sched.make_fleet(samples_per_client=samples, **kw))


@pytest.mark.parametrize("kw", FLEETS)
def test_make_fleet_equal(kw):
    a, b = _fleets(kw)
    assert [dataclasses.asdict(c) for c in a] == \
        [dataclasses.asdict(c) for c in b]


@pytest.mark.parametrize("kw", FLEETS[:3])
@pytest.mark.parametrize("which", ["AFLScheduler", "BaselineAFLScheduler"])
def test_scheduler_traces_equal(kw, which):
    a, b = _fleets(kw)
    sa = getattr(j_sched, which)(a, tau_u=0.2, tau_d=0.1)
    sb = getattr(t_sched, which)(b, tau_u=0.2, tau_d=0.1)
    ta, tb = sa.trace(40), sb.trace(40)
    assert [dataclasses.asdict(e) for e in ta] == \
        [dataclasses.asdict(e) for e in tb]
    assert [dataclasses.asdict(e) for e in sb.events(40)] == \
        [dataclasses.asdict(e) for e in tb]
    if which == "BaselineAFLScheduler":
        assert sa.cycle_order() == sb.cycle_order()
    assert j_sched.sfl_round_time(a, tau_u=0.2, tau_d=0.1, local_steps=2) \
        == t_sched.sfl_round_time(b, tau_u=0.2, tau_d=0.1, local_steps=2)


def test_sfl_alpha_and_solve_betas_equal():
    alpha_a = j_agg.sfl_alpha([60, 80, 100, 120, 3])
    alpha_b = t_agg.sfl_alpha([60, 80, 100, 120, 3])
    np.testing.assert_array_equal(alpha_a, alpha_b)
    for order in ([0, 1, 2, 3, 4], [4, 2, 0, 3, 1]):
        np.testing.assert_array_equal(j_agg.solve_betas(alpha_a, order),
                                      t_agg.solve_betas(alpha_b, order))
    with pytest.raises(ValueError):
        t_agg.solve_betas(alpha_b, [0, 0, 1, 2, 3])


def test_staleness_coefficient_and_tracker_equal():
    stale = np.random.default_rng(4).integers(1, 30, 200)
    ta, tb = j_agg.StalenessTracker(0.9), t_agg.StalenessTracker(0.9)
    for j, s in enumerate(stale, start=1):
        mu_a, mu_b = ta.update(s), tb.update(s)
        assert mu_a == mu_b
        i = max(j - int(s), 0)
        assert j_agg.staleness_coefficient(j, i, mu_a, 0.4) == \
            t_agg.staleness_coefficient(j, i, mu_b, 0.4)


@pytest.mark.parametrize("betas", [[0.3], [0.9, 0.5, 0.8, 0.95, 0.7],
                                   list(np.linspace(0.0, 1.0, 33))])
def test_fold_sequential_blends_equal(betas):
    c0a, ca = j_agg.fold_sequential_blends(betas)
    c0b, cb = t_agg.fold_sequential_blends(betas)
    assert c0a == c0b
    np.testing.assert_array_equal(ca, cb)


def test_participation_stats_equal():
    rng = np.random.default_rng(9)
    E, M = 50, 6
    args = (rng.integers(0, M, E), rng.uniform(0, 1, E),
            rng.uniform(size=E) < 0.1, rng.uniform(size=E) < 0.1, M)
    kw = dict(attempts=rng.integers(1, 3, E),
              outcomes=rng.integers(0, 3, E),
              staleness=rng.integers(1, 9, E))
    assert j_flt.participation_stats(*args, **kw) == \
        t_flt.participation_stats(*args, **kw)


def test_resolve_faults_accepts_only_clean():
    assert t_flt.resolve_faults(None) is None
    with pytest.raises(NotImplementedError, match="Queue 1 #7"):
        t_flt.resolve_faults("lossy")
