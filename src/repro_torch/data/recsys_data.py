"""Synthetic recsys pipelines: CTR batches, behavior sequences, candidates.

A numpy copy of ``repro.data.recsys_data``: the same ``(seed, step)`` gives
byte-identical arrays.  Deterministic per (seed, step) — restart-safe
without data-state checkpoints.  Labels follow a planted logistic model
over field embeddings so AUC/NDCG visibly improve during smoke training.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class CTRDataConfig:
    n_fields: int
    vocab_per_field: int
    batch: int
    n_multi_hot: int = 0
    multi_hot_len: int = 8
    seed: int = 0


def ctr_batch(cfg: CTRDataConfig, step: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    # Zipf-ish id popularity (hot rows — the embedding-bag stress pattern).
    ids = (rng.pareto(1.2, (cfg.batch, cfg.n_fields)) * 17
           ).astype(np.int64) % cfg.vocab_per_field
    # planted label: parity-ish interaction of two fields + noise
    h = ((ids[:, 0] % 7) + (ids[:, 1] % 5) + (ids[:, 0] % 3) * (ids[:, 1] % 2))
    p = 1.0 / (1.0 + np.exp(-(h.astype(np.float64) - 6.0) / 2.0))
    out = {
        "ids": ids.astype(np.int32),
        "labels": (rng.random(cfg.batch) < p).astype(np.int32),
    }
    if cfg.n_multi_hot:
        out["mh_ids"] = (rng.integers(
            0, cfg.vocab_per_field,
            (cfg.batch, cfg.n_multi_hot, cfg.multi_hot_len))).astype(np.int32)
        out["mh_mask"] = rng.random(
            (cfg.batch, cfg.n_multi_hot, cfg.multi_hot_len)) < 0.6
    return out


@dataclasses.dataclass(frozen=True)
class SeqDataConfig:
    n_items: int
    seq_len: int
    batch: int
    n_negs: int = 20
    seed: int = 0


def seq_batch(cfg: SeqDataConfig, step: int) -> dict:
    """SASRec-style: history items + per-position positives/negatives."""
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
    b, s = cfg.batch, cfg.seq_len
    # sessions drift through item space — next item correlates with current
    base = rng.integers(0, cfg.n_items, (b, 1))
    walk = rng.integers(-50, 51, (b, s + 1)).cumsum(axis=1)
    items = (base + walk) % cfg.n_items
    return {
        "items": items[:, :-1].astype(np.int32),
        "pos": items[:, 1:].astype(np.int32),
        "neg": rng.integers(0, cfg.n_items, (b, s)).astype(np.int32),
        "mask": np.ones((b, s), bool),
    }


def mind_batch(cfg: SeqDataConfig, step: int) -> dict:
    rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step, 7]))
    b, s = cfg.batch, cfg.seq_len
    base = rng.integers(0, cfg.n_items, (b, 1))
    walk = rng.integers(-50, 51, (b, s + 1)).cumsum(axis=1)
    items = (base + walk) % cfg.n_items
    return {
        "hist": items[:, :-1].astype(np.int32),
        "hist_mask": np.ones((b, s), bool),
        "pos": items[:, -1].astype(np.int32),
        "negs": rng.integers(0, cfg.n_items, (b, cfg.n_negs)).astype(np.int32),
    }


def iterator(batch_fn, cfg, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield batch_fn(cfg, step)
        step += 1
