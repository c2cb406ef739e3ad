"""Synthetic IR test collection — the paper's §4 protocol (Tague et al. 1980).

A numpy copy of ``repro.data.synthetic_ir`` (which imports no JAX, but the
port imports nothing of the JAX package): the same draws in the same order,
so a seed gives byte-identical collections, scores and runs in both.

Collection construction (paper defaults in brackets):
  * vocabulary V of symbolic tokens [|V| = 10,000];
  * collection-wide unigram and bigram pseudo-counts ~ Exp(λ=1) — term
    specificity: few frequent, most infrequent;
  * per document: |d| ~ Poisson(μ_d=200); unigram + bigram doc LMs ~
    Dirichlet(collection pseudo-counts); tokens drawn with P(n=1)=0.9,
    P(n=2)=0.1;
  * queries: r=5 uniformly-random relevant docs R_q; |q| ~ Poisson(μ_q=3);
    terms ~ P(w|R_q)·(1 − P(w|D)) (specific to R_q, uncommon in D).

Memory adaptation (documented in DESIGN.md): the paper's dense |V|² bigram
pseudo-count table is infeasible at |V|=10k × float; we keep a *sparse*
successor table (``n_successors`` per token, default 32) — the same
specificity skew with O(|V|·k) memory.  Dense mode is used automatically for
small vocabularies.

Ranking model for the demo environment: Dirichlet-smoothed query likelihood
(Indri's default, μ=2500) over the term-document count matrix — the Pyndri
stand-in, on the host in numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class CollectionConfig:
    vocab_size: int = 10_000
    n_docs: int = 100
    avg_doc_len: float = 200.0
    avg_query_len: float = 3.0
    n_queries: int = 1000
    n_relevant: int = 5
    p_bigram: float = 0.1
    n_successors: int = 32
    dense_bigram_threshold: int = 512  # |V| below this → dense bigram table
    seed: int = 0


@dataclasses.dataclass
class Collection:
    cfg: CollectionConfig
    doc_term: np.ndarray  # [n_docs, V] term counts
    doc_len: np.ndarray  # [n_docs]
    coll_freq: np.ndarray  # [V] collection term counts
    qrels: Dict[str, Dict[str, int]]
    query_terms: Dict[str, np.ndarray]

    @property
    def n_docs(self) -> int:
        return self.doc_term.shape[0]

    def doc_id(self, i: int) -> str:
        return f"d{i:06d}"


def build_collection(cfg: Optional[CollectionConfig] = None) -> Collection:
    cfg = cfg or CollectionConfig()
    rng = np.random.default_rng(cfg.seed)
    v = cfg.vocab_size

    # Collection-wide pseudo counts (term specificity).
    uni_pseudo = rng.exponential(1.0, v)
    dense_bigram = v <= cfg.dense_bigram_threshold
    if dense_bigram:
        bi_pseudo = rng.exponential(1.0, (v, v))
        successors = None
    else:
        successors = rng.integers(0, v, (v, cfg.n_successors))
        bi_pseudo = rng.exponential(1.0, (v, cfg.n_successors))

    doc_term = np.zeros((cfg.n_docs, v), dtype=np.int32)
    doc_len = np.zeros(cfg.n_docs, dtype=np.int32)
    for d in range(cfg.n_docs):
        target = max(1, rng.poisson(cfg.avg_doc_len))
        # document language models ~ Dirichlet(collection pseudo counts)
        uni_lm = rng.dirichlet(uni_pseudo)
        tokens = []
        while len(tokens) < target:
            if rng.random() < cfg.p_bigram:
                x = rng.choice(v, p=uni_lm)
                if dense_bigram:
                    p = bi_pseudo[x] / bi_pseudo[x].sum()
                    y = rng.choice(v, p=p)
                else:
                    p = bi_pseudo[x] / bi_pseudo[x].sum()
                    y = successors[x][rng.choice(cfg.n_successors, p=p)]
                tokens.extend((int(x), int(y)))
            else:
                tokens.append(int(rng.choice(v, p=uni_lm)))
        tokens = tokens[:target]
        np.add.at(doc_term[d], tokens, 1)
        doc_len[d] = len(tokens)

    coll_freq = doc_term.sum(axis=0)
    coll_total = max(coll_freq.sum(), 1)
    p_w_coll = coll_freq / coll_total

    qrels: Dict[str, Dict[str, int]] = {}
    query_terms: Dict[str, np.ndarray] = {}
    for qi in range(cfg.n_queries):
        qid = f"q{qi:06d}"
        rel_docs = rng.choice(cfg.n_docs, size=cfg.n_relevant, replace=False)
        qrels[qid] = {f"d{d:06d}": 1 for d in rel_docs}
        rq_counts = doc_term[rel_docs].sum(axis=0)
        p_w_rq = rq_counts / max(rq_counts.sum(), 1)
        weights = p_w_rq * (1.0 - p_w_coll)
        total = weights.sum()
        qlen = max(1, rng.poisson(cfg.avg_query_len))
        if total <= 0:
            terms = rng.integers(0, v, qlen)
        else:
            terms = rng.choice(v, size=qlen, replace=True, p=weights / total)
        query_terms[qid] = terms.astype(np.int32)

    return Collection(cfg=cfg, doc_term=doc_term, doc_len=doc_len,
                      coll_freq=coll_freq, qrels=qrels,
                      query_terms=query_terms)


def ql_scores(coll: Collection, terms: np.ndarray, mu: float = 2500.0
              ) -> np.ndarray:
    """Dirichlet-smoothed query-likelihood scores for all docs (Indri-style).

    score(q, d) = Σ_w log( (tf_{w,d} + μ·P(w|C)) / (|d| + μ) )
    """
    if len(terms) == 0:
        return np.zeros(coll.n_docs, dtype=np.float32)
    p_c = coll.coll_freq / max(coll.coll_freq.sum(), 1)
    tf = coll.doc_term[:, terms].astype(np.float64)  # [D, |q|]
    smooth = mu * p_c[terms][None, :]
    denom = (coll.doc_len + mu)[:, None]
    return np.log((tf + smooth) / denom).sum(axis=1).astype(np.float32)


def run_from_scores(coll: Collection, qid_scores: Dict[str, np.ndarray],
                    depth: int = 10) -> Dict[str, Dict[str, float]]:
    """Top-``depth`` run dict from per-query score vectors."""
    run: Dict[str, Dict[str, float]] = {}
    for qid, scores in qid_scores.items():
        top = np.argsort(-scores)[:depth]
        run[qid] = {f"d{d:06d}": float(scores[d]) for d in top}
    return run


def synthesize_run(n_queries: int, n_docs: int, seed: int = 0):
    """The paper's *benchmark* synthesis (§3): every document gets a distinct
    integer score and relevance level 1.  Used by RQ1/RQ2 benchmarks."""
    rng = np.random.default_rng(seed)
    run, qrel = {}, {}
    for qi in range(n_queries):
        qid = f"q{qi}"
        scores = rng.permutation(n_docs)
        run[qid] = {f"d{j}": float(scores[j]) for j in range(n_docs)}
        qrel[qid] = {f"d{j}": 1 for j in range(n_docs)}
    return run, qrel
