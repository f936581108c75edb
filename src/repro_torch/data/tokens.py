"""Synthetic LM data pipeline (deterministic, seekable, shardable).

A Zipf-distributed token stream with injected n-gram structure so models
actually have something learnable (loss decreases over a few hundred steps
in examples/train_smollm.py). The pipeline is *stateless-resumable*: batch i
is a pure function of (seed, i), so restart-from-checkpoint replays exactly
and data order is independent of host count (batch sharding happens at
device_put).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    ngram_order: int = 3
    ngram_bias: float = 0.7      # prob of following the planted n-gram table


class TokenPipeline:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # planted bigram successor table: makes next-token partially
        # predictable -> a real learning signal
        self._succ = rng.integers(0, v, size=v, dtype=np.int64)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = ranks ** (-cfg.zipf_a)
        self._zipf_p = p / p.sum()

    def batch(self, index: int) -> dict:
        """Batch `index` -> {tokens, labels} (numpy, global shapes)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, index))
        b, t = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, t + 1), p=self._zipf_p)
        follow = rng.random((b, t + 1)) < cfg.ngram_bias
        for j in range(1, t + 1):
            prev = toks[:, j - 1]
            toks[:, j] = np.where(follow[:, j], self._succ[prev], toks[:, j])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}
