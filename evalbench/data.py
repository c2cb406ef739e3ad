"""The benchmark's data: a test collection and score sets, from a seed.

One general generator reads a configuration file (``configs/<name>.json``,
``"kind": "ir_collection"``) and builds, with the docnos in the style
that ``docnos/<style>.py`` makes:

* qrels: flat ``(qid, docno, grade)`` string / integer arrays;
* a run: flat ``(qid, docno)`` arrays, query by query, each query's
  candidates in a shuffled order;
* a pool of score sets for that run, float32, rounded to the decimals run
  files print, so that equal scores, and trec_eval's docno tie rule, occur.

The sizes of the work (queries, judgments, candidate pairs, relevant and
judged candidates) are one fixed multiset per configuration: the seed
only deals them out to queries, draws the ids and draws the scores. So
every seed gives the same amount of work in another order.
"""

from __future__ import annotations

import json
from pathlib import Path
from statistics import NormalDist
from typing import Dict, NamedTuple

import numpy as np

from evalbench import found

CONFIGS = Path(__file__).resolve().parent / "configs"


def load_config(name: str) -> dict:
    with open(CONFIGS / f"{name}.json") as f:
        return json.load(f)


class Collection(NamedTuple):
    qrel_qid: np.ndarray    # [m] str
    qrel_doc: np.ndarray    # [m] str
    qrel_grade: np.ndarray  # [m] int64
    run_qid: np.ndarray     # [n] str, grouped by query
    run_doc: np.ndarray     # [n] str
    run_grade: np.ndarray   # [n] int64, -1 where unjudged (scores only)


# -- fixed multisets of sizes ----------------------------------------------

def fixed_total(weights, total: int, lo, hi) -> np.ndarray:
    """Integers proportional to ``weights`` within ``[lo, hi]`` (numbers
    or arrays) that sum to ``total`` exactly."""
    w = np.asarray(weights, dtype=np.float64)
    lo = np.broadcast_to(np.asarray(lo, dtype=np.int64), w.shape)
    hi = np.broadcast_to(np.asarray(hi, dtype=np.int64), w.shape)
    if total < int(lo.sum()) or total > int(hi.sum()):
        raise ValueError(f"cannot split {total} into {len(w)} parts "
                         f"within their bounds")
    exact = w / w.sum() * total
    x = np.clip(np.floor(exact).astype(np.int64), lo, hi)
    order = np.argsort(-(exact - np.floor(exact)), kind="stable")
    while int(x.sum()) != total:
        step = 1 if x.sum() < total else -1
        room = (x < hi) if step > 0 else (x > lo)
        cand = order[room[order]]
        x[cand[:abs(total - int(x.sum()))]] += step
    return x


def spread(n: int, sigma: float) -> np.ndarray:
    """``n`` fixed lognormal weights (quantiles, not draws): the same for
    every seed."""
    z = NormalDist()
    return np.exp(sigma * np.array([z.inv_cdf((i + 0.5) / n)
                                    for i in range(n)]))


def plan(cfg: dict) -> Dict[str, np.ndarray]:
    """The per-query sizes, before the seed deals them out.

    Returns arrays of one entry a query: ``rel`` (relevant judgments),
    ``judged`` (all judgments), ``cands`` (candidates retrieved),
    ``rel_ret`` (relevant among the candidates), ``judged_ret`` (judged
    among the candidates, relevant included).
    """
    nq = int(cfg["queries"])
    r = cfg["relevant"]
    if "histogram" in r:
        rel = np.concatenate([np.full(int(n), int(k), dtype=np.int64)
                              for k, n in r["histogram"]])
    else:
        rel = fixed_total(spread(nq, r["spread"]), int(r["total"]),
                          int(r["min"]), int(r.get("max", 10**9)))
    if len(rel) != nq:
        raise ValueError(f"relevant counts for {len(rel)} of {nq} queries")
    j = cfg.get("judged")
    if j is None:
        judged = rel.copy()
    else:
        # the topics with the most relevant documents judge the most
        w = np.sort(spread(nq, j["spread"]))[np.argsort(np.argsort(rel))]
        judged = fixed_total(w, int(j["total"]),
                             rel + int(j.get("min_nonrelevant", 0)),
                             int(j["max"]))
    c = cfg["candidates"]
    depth, total = int(c["depth"]), int(c["total"])
    deficit = nq * depth - total
    n_short = min(nq, int(round(deficit / (depth / 2)))) if deficit else 0
    cands = np.full(nq, depth, dtype=np.int64)
    if n_short:
        short = np.linspace(1, depth - 1, n_short)
        cands[:n_short] = fixed_total(short, total - (nq - n_short) * depth,
                                      1, depth - 1)
    if int(cands.sum()) != total:
        raise ValueError("candidate lengths miss their total")
    rr = cfg["retrieved_relevant"]
    if rr["per"] == "query":
        hits = int(round(rr["share"] * nq))
        rel_ret = np.zeros(nq, dtype=np.int64)
        rel_ret[:hits] = 1  # which queries hit is dealt by the seed
    else:
        rel_ret = fixed_total(np.maximum(rel, 1) * 1.0,
                              int(round(rr["share"] * rel.sum())), 0, rel)
    js = cfg.get("judged_share_of_candidates")
    if js is None:
        judged_ret = None
    else:
        judged_ret = fixed_total(spread(nq, js["spread"]),
                                 int(round(js["mean"] * total)), 0, cands)
    return {"rel": rel, "judged": judged, "cands": cands,
            "rel_ret": rel_ret, "judged_ret": judged_ret}


# -- identifiers -----------------------------------------------------------

def decimal_strings(ids: np.ndarray) -> np.ndarray:
    """Non-negative integers as decimal strings (``str(i)``), built from
    their digits, one column of characters at a time."""
    ids = np.asarray(ids, dtype=np.int64)
    width = len(str(int(ids.max()))) if len(ids) else 1
    ndig = np.ones(len(ids), dtype=np.int8)
    for p in range(1, width):
        ndig += ids >= 10 ** p
    p10 = 10 ** np.arange(width, dtype=np.int64)
    chars = np.zeros((len(ids), width), dtype=np.uint32)
    for c in range(width):
        e = ndig.astype(np.int64) - 1 - c  # power of ten of column c
        digit = (ids // p10[np.maximum(e, 0)]) % 10 + 48
        chars[:, c] = np.where(e >= 0, digit, 0)
    return chars.view(f"<U{width}").reshape(len(ids))


def _qids(cfg: dict, rng) -> np.ndarray:
    q = cfg["qid"]
    nq = int(cfg["queries"])
    if q["style"] == "ranges":
        ids = np.concatenate([np.arange(a, b + 1) for a, b in q["ranges"]])
        ids = ids[~np.isin(ids, q.get("skip", []))]
        if len(ids) != nq:
            raise ValueError(f"{len(ids)} topic numbers for {nq} queries")
        return ids.astype(str)
    ids = rng.choice(int(q["below"]), size=nq, replace=False)
    return decimal_strings(np.sort(ids))


def _unique_draws(rng, qidx: np.ndarray, pool: int, fixed: np.ndarray,
                  ids: np.ndarray) -> np.ndarray:
    """Redraw the ids in ``[0, pool)`` that repeat within their query;
    rows where ``fixed`` is true keep theirs (and win over the others)."""
    ids = ids.copy()
    while True:
        key = qidx * np.int64(pool) + ids
        order = np.lexsort((~fixed, key))  # fixed rows first among equals
        dup = np.zeros(len(ids), dtype=bool)
        dup[order[1:]] = key[order[1:]] == key[order[:-1]]
        if not dup.any():
            return ids
        if np.any(dup & fixed):
            raise ValueError("fixed ids repeat within a query")
        ids[dup] = rng.integers(0, pool, int(dup.sum()))


def collection(cfg: dict, seed: int) -> Collection:
    """The collection of ``cfg`` drawn from ``seed``."""
    rng = np.random.default_rng([int(seed), 0])
    sizes = plan(cfg)
    nq = int(cfg["queries"])
    # deal the fixed sizes out to queries: the tuples of judgments move
    # together, candidate depths and the hits apart
    perm = rng.permutation(nq)
    rel, judged = sizes["rel"][perm], sizes["judged"][perm]
    if cfg["retrieved_relevant"]["per"] == "query":
        rel_ret = np.minimum(rng.permutation(sizes["rel_ret"]) * rel,
                             rel)
        cands = rng.permutation(sizes["cands"])
    else:
        rel_ret = sizes["rel_ret"][perm]
        cands = sizes["cands"][perm]
    rel_ret = np.minimum(rel_ret, cands)
    if sizes["judged_ret"] is None:
        judged_ret = rel_ret.copy()
    else:
        judged_ret = sizes["judged_ret"][rng.permutation(nq)]
        judged_ret = np.clip(judged_ret, rel_ret,
                             np.minimum(cands, rel_ret + judged - rel))

    qids = _qids(cfg, rng)
    pool, doc = found("docnos", cfg["docno"]["style"]).make(cfg["docno"])

    # judgments: relevant first in each query, then judged non-relevant
    jq = np.repeat(np.arange(nq, dtype=np.int64), judged)
    jstart = np.concatenate([[0], np.cumsum(judged)[:-1]])
    jpos = np.arange(len(jq)) - jstart[jq]
    is_rel = jpos < rel[jq]
    grades = np.zeros(len(jq), dtype=np.int64)
    levels = np.array([g for g, _ in cfg["grades"]], dtype=np.int64)
    shares = np.array([s for _, s in cfg["grades"]], dtype=np.float64)
    n_rel = int(is_rel.sum())
    per = fixed_total(shares, n_rel, 0, n_rel)
    grades[is_rel] = rng.permutation(np.repeat(levels, per))
    jids = _unique_draws(rng, jq, pool, np.zeros(len(jq), bool),
                         rng.integers(0, pool, len(jq)))

    # candidates: the retrieved judgments, then unjudged ids
    rel_pick = jpos < rel_ret[jq]
    nonrel_pick = (~is_rel) & (jpos - rel[jq] < (judged_ret - rel_ret)[jq])
    pick = rel_pick | nonrel_pick
    n_unj = cands - judged_ret
    uq = np.repeat(np.arange(nq, dtype=np.int64), n_unj)
    all_q = np.concatenate([jq, uq])
    all_ids = np.concatenate([jids, rng.integers(0, pool, len(uq))])
    fixed = np.concatenate([np.ones(len(jq), bool),
                            np.zeros(len(uq), bool)])
    all_ids = _unique_draws(rng, all_q, pool, fixed, all_ids)
    keep = np.concatenate([pick, np.ones(len(uq), bool)])
    cq, cid = all_q[keep], all_ids[keep]
    cgrade = np.concatenate([grades[pick], np.full(len(uq), -1, np.int64)])
    # shuffle candidates within each query
    order = np.argsort(cq + rng.random(len(cq)))
    cq, cid, cgrade = cq[order], cid[order], cgrade[order]

    return Collection(
        qrel_qid=qids[jq], qrel_doc=doc(jids), qrel_grade=grades,
        run_qid=qids[cq], run_doc=doc(cid), run_grade=cgrade)


def score_pool(cfg: dict, col: Collection, seed: int, n: int) -> np.ndarray:
    """``[n, len(run)]`` float32 score sets: a reranker's scores, relevant
    candidates lifted by grade, rounded as run files print them."""
    s = cfg["scores"]
    grade = np.maximum(col.run_grade, 0).astype(np.float64)
    out = np.empty((n, len(col.run_grade)), dtype=np.float32)
    for i in range(n):
        rng = np.random.default_rng([int(seed), 1, i])
        x = s["noise"] * rng.standard_normal(len(grade)) + s["gain"] * grade
        out[i] = np.round(x, int(s["decimals"]))
    return out


def qrel_dict(col: Collection) -> Dict[str, Dict[str, int]]:
    """The qrels as pytrec_eval's ``{qid: {docno: grade}}``."""
    out: Dict[str, Dict[str, int]] = {}
    for q, d, g in zip(col.qrel_qid.tolist(), col.qrel_doc.tolist(),
                       col.qrel_grade.tolist()):
        out.setdefault(q, {})[d] = g
    return out
