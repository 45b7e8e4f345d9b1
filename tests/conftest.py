"""Shared test fixtures.

NOTE: no XLA_FLAGS here on purpose — smoke tests and benches must see the
host's real single device; only launch/dryrun.py forces 512 placeholder
devices (per the deliverable spec).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax
import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def key():
    return jax.random.PRNGKey(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "slow: long-running integration test")
    config.addinivalue_line("markers", "gpu: needs an NVIDIA GPU and nvcc; skipped without them")
