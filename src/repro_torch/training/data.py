"""Deterministic, shardable synthetic token pipeline. The port's copy of the
JAX package's ``training/data.py`` (numpy only), held equal to it by the
tests.

Produces a reproducible LM stream (Zipf-distributed tokens with Markov-ish
local structure so the loss actually decreases) partitioned by (host, step):
every host computes only its shard, any host can recompute any step — the
property elastic re-scaling and straggler reassignment rely on (no data
server to fail over).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_alpha: float = 1.1


class SyntheticLM:
    """step/shard-addressable synthetic corpus."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
        w = ranks ** (-cfg.zipf_alpha)
        self.probs = w / w.sum()
        self.cdf = np.cumsum(self.probs)
        # fixed random "grammar": each token strongly predicts a successor
        self.successor = rng.integers(0, cfg.vocab, cfg.vocab)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1):
        """(tokens, labels) for this host's shard of global batch ``step``."""
        c = self.cfg
        per = c.global_batch // n_shards
        rng = np.random.default_rng((c.seed, step, shard))
        u = rng.random((per, c.seq_len))
        toks = np.searchsorted(self.cdf, u).astype(np.int32)
        # 60%: successor structure (learnable signal)
        follow = rng.random((per, c.seq_len - 1)) < 0.6
        nxt = self.successor[toks[:, :-1]]
        toks[:, 1:] = np.where(follow, nxt, toks[:, 1:])
        labels = np.concatenate([toks[:, 1:], np.full((per, 1), -1, np.int32)], axis=1)
        return toks, labels
