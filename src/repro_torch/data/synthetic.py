"""Synthetic LM token streams for federated LM training.

Twin of ``repro/data/synthetic.py``: the same numpy draws in the same
order, so both packages see equal batches for a given (seed, cid) — the
RNG call order is the contract, and nothing here is vectorized
differently.  Per-client *non-IID topic mixture*: the vocabulary is
divided into T topic blocks; each client draws tokens from a Zipf-like
marginal tilted toward its own topic subset, with a simple bigram
structure (next token depends on the current token's block).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


class TokenStream:
    def __init__(self, vocab_size: int, *, num_topics: int = 16,
                 topics_per_client: int = 2, cid: int = 0, seed: int = 0):
        self.vocab = vocab_size
        rng = np.random.default_rng(seed * 7919 + cid)
        self.rng = rng
        topics = rng.choice(num_topics, size=topics_per_client, replace=False)
        block = max(vocab_size // num_topics, 1)
        # Zipf marginal, boosted inside the client's topic blocks
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        boost = np.ones(vocab_size)
        for t in topics:
            boost[t * block:(t + 1) * block] *= 20.0
        p *= boost
        self.p = p / p.sum()
        self.block = block

    def sample_batch(self, batch: int, seq_len: int) -> Dict[str, np.ndarray]:
        """{"tokens", "labels"}: (batch, seq_len) int32, labels shifted by
        one.  Costs one ``rng.choice`` over the vocabulary per position."""
        rng = self.rng
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=batch, p=self.p)
        # bigram-ish: with prob .5 stay inside current token's block
        for s in range(1, seq_len + 1):
            fresh = rng.choice(self.vocab, size=batch, p=self.p)
            local = (toks[:, s - 1] // self.block) * self.block \
                + rng.integers(0, self.block, size=batch)
            stay = rng.random(batch) < 0.5
            toks[:, s] = np.where(stay, local % self.vocab, fresh)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
