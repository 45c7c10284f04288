# Copied from repro/data/pipeline.py (numpy only); SyntheticLM.batch(step) gives its bytes.
"""Synthetic LM data pipeline: deterministic, sharded, checkpointable.

Generates a structured token stream (a stochastic block-grammar over the
vocab: zipf-distributed unigram base + Markov bigram structure) so a small
model has something non-trivial to learn — loss decreases measurably within
a few hundred steps, which the integration tests assert.

Determinism + fault tolerance: the iterator is a pure function of
(seed, step), so its "state" is one integer; restart-from-checkpoint resumes
the exact stream (test-verified). Per-host sharding slices the global batch
by (host_index, host_count) the way a real multi-host input pipeline would.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_batch"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    zipf_a: float = 1.3
    markov_weight: float = 0.7  # bigram structure strength


class SyntheticLM:
    """Deterministic batches: batch(step) is reproducible in isolation."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.global_batch % cfg.host_count:
            raise ValueError("global_batch must divide by host_count")
        self.local_batch = cfg.global_batch // cfg.host_count
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # zipf unigram distribution
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = ranks ** (-cfg.zipf_a)
        self._unigram /= self._unigram.sum()
        # sparse Markov structure: each token prefers a few successors
        self._succ = base.integers(0, v, size=(v, 4))

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * 131 + cfg.host_index
        )
        b, s, v = self.local_batch, cfg.seq_len, cfg.vocab_size
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.choice(v, size=b, p=self._unigram)
        for t in range(1, s + 1):
            use_markov = rng.random(b) < cfg.markov_weight
            succ_pick = self._succ[toks[:, t - 1], rng.integers(0, 4, size=b)]
            uni_pick = rng.choice(v, size=b, p=self._unigram)
            toks[:, t] = np.where(use_markov, succ_pick, uni_pick)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1

    # fault-tolerance contract: state == the step counter, nothing else.
    @staticmethod
    def state_at(step: int) -> dict:
        return {"data_step": step}


def make_batch(cfg: DataConfig, step: int) -> Dict[str, np.ndarray]:
    return SyntheticLM(cfg).batch(step)
