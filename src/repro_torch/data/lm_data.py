"""Synthetic LM token pipeline: deterministic, shardable, restart-safe.

The port's copy of ``repro.data.lm_data`` (numpy only): the same config
gives the same batches, bit for bit.

Markov-chain token stream (power-law unigram marginals, per-state successor
tables) — enough structure that a small model's loss visibly falls, cheap
enough to generate on the fly.  The iterator is keyed by (seed, step) so a
restarted job regenerates the exact batch sequence (checkpoint/restart
determinism: data state needs no checkpointing).
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class LMDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_successors: int = 64
    seed: int = 0


class MarkovLM:
    def __init__(self, cfg: LMDataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # Zipfian start distribution.
        ranks = np.arange(1, v + 1)
        self.start_p = (1.0 / ranks) / (1.0 / ranks).sum()
        self.successors = rng.integers(0, v, (v, cfg.n_successors))
        w = rng.exponential(1.0, (v, cfg.n_successors))
        self.succ_p = w / w.sum(axis=1, keepdims=True)

    def batch(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), dtype=np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=b, p=self.start_p)
        sel = rng.integers(0, cfg.n_successors, (b, s))
        for t in range(s):
            # cheap successor draw: pick column then lookup (not exact
            # categorical per-row, but preserves the chain structure)
            toks[:, t + 1] = self.successors[toks[:, t], sel[:, t]]
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterator(self, start_step: int = 0) -> Iterator[dict]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
