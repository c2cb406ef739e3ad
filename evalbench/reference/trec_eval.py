"""trec_eval's measures, written plainly in NumPy and float64.

This is the benchmark's yardstick for ``correct``. It imports nothing of
the program under test: it starts again from the strings (query ids,
docnos) and the scores that the benchmark handed to both sides, and works
out again everything the program derives from them: the docno tie rule,
the join of the run with the qrels, the per-query relevant and judged
counts, and the ideal gains.

Semantics are trec_eval's:

* a query's documents are ranked by score, descending; equal scores go to
  the lexicographically larger docno first (``strcmp`` order);
* a document is relevant iff it is judged with a grade >= the relevance
  level; unjudged documents are non-relevant;
* ``map``, ``recall``, ``Rprec`` and ``bpref`` divide by R, the relevant
  count in the qrels; ``P_k`` always divides by k;
* ``ndcg`` is linear gain, grade / log2(rank + 1), over the ideal ranking
  of every judgment of the query; ``ndcg_cut_k`` cuts both at k;
* ``iprec_at_recall_l`` is the largest precision at any rank at or below
  the first rank whose recall reaches l;
* ``gm_map`` is given per query as ``log(max(AP, 1e-5))``, the form in
  which per-query results carry it (its summary is ``exp`` of the mean).

Only queries that are both in the run and in the qrels are evaluated.
Work is flat over all queries at once: one integer sort ranks every
query, and per-query values are read off segmented prefix sums.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np

CUTOFFS: Tuple[int, ...] = (5, 10, 15, 20, 30, 100, 200, 500, 1000)
SUCCESS_CUTOFFS: Tuple[int, ...] = (1, 5, 10)
IPREC_PERCENT: Tuple[int, ...] = tuple(range(0, 101, 10))
GM_MIN = 1e-5

#: families with one value a query and no parameter
_SINGLE = ("num_ret", "num_rel", "num_rel_ret", "map", "gm_map", "Rprec",
           "bpref", "recip_rank", "ndcg")
#: families with integer cutoffs, and their default cutoffs
_CUT = {"P": CUTOFFS, "recall": CUTOFFS, "ndcg_cut": CUTOFFS,
        "map_cut": CUTOFFS, "success": SUCCESS_CUTOFFS}


def parse(measures: Sequence[str]) -> List[Tuple[str, Tuple[int, ...]]]:
    """trec_eval measure names (``P``, ``P.10``, ``ndcg_cut.10,20``,
    ``iprec_at_recall``) → ``[(family, params)]``; the params of
    ``iprec_at_recall`` are recall levels in percent."""
    out = []
    for m in measures:
        fam, _, arg = m.partition(".")
        if fam in _SINGLE:
            if arg:
                raise ValueError(f"{fam} takes no parameter: {m!r}")
            out.append((fam, ()))
        elif fam in _CUT:
            params = (tuple(int(a) for a in arg.split(",")) if arg
                      else _CUT[fam])
            out.append((fam, params))
        elif fam == "iprec_at_recall":
            params = (tuple(int(round(float(a) * 100))
                            for a in arg.split(",")) if arg
                      else IPREC_PERCENT)
            out.append((fam, params))
        else:
            raise ValueError(f"measure {m!r} is not in the reference")
    return out


def keys(measures: Sequence[str]) -> List[str]:
    """The output keys of ``measures``, in trec_eval's spelling."""
    out = []
    for fam, params in parse(measures):
        if not params:
            out.append(fam)
        elif fam == "iprec_at_recall":
            out.extend(f"iprec_at_recall_{p / 100:.2f}" for p in params)
        else:
            out.extend(f"{fam}_{k}" for k in params)
    return out


def lex_words(strings) -> np.ndarray:
    """``[n, W]`` uint64 words whose row order is the strings' ``strcmp``
    order: 8 ASCII characters a word, 7 bits each, NUL-padded on the
    right (so a prefix sorts first)."""
    a = np.asarray(strings)
    if a.dtype.kind != "U":
        a = a.astype(str)
    a = np.ascontiguousarray(a)
    width = max(a.dtype.itemsize // 4, 1)
    cp = a.view(np.uint32).reshape(len(a), width) if len(a) else \
        np.zeros((0, width), np.uint32)
    if cp.size and int(cp.max()) >= 128:
        raise ValueError("the reference compares ASCII identifiers only")
    n_words = -(-width // 8)
    cp = np.pad(cp, ((0, 0), (0, n_words * 8 - width))).astype(np.uint64)
    shifts = np.array([7 * (7 - i) for i in range(8)], dtype=np.uint64)
    cp = cp.reshape(len(a), n_words, 8) << shifts
    return np.bitwise_or.reduce(cp, axis=2)


def dense_rank(*groups) -> List[np.ndarray]:
    """Rank every string of several arrays in one ``strcmp`` order: equal
    strings share a rank, ranks are 0, 1, 2, ... without gaps."""
    words = [lex_words(g) for g in groups]
    w = max(x.shape[1] for x in words)
    allw = np.concatenate(
        [np.pad(x, ((0, 0), (0, w - x.shape[1]))) for x in words])
    order = np.lexsort(tuple(allw[:, i] for i in range(w - 1, -1, -1)))
    srt = allw[order]
    new = np.any(srt[1:] != srt[:-1], axis=1)
    rank = np.empty(len(allw), dtype=np.int64)
    rank[order] = np.concatenate([[0], np.cumsum(new)])
    out, lo = [], 0
    for x in words:
        out.append(rank[lo:lo + len(x)])
        lo += len(x)
    return out


class Prepared(NamedTuple):
    """The score-independent half of an evaluation: run rows joined with
    the qrels, and each query's qrel statistics."""

    qids: List[str]           # evaluated queries, in strcmp order
    q: np.ndarray             # [n] run row → index into qids
    docdesc: np.ndarray       # [n] row's place in its query by docno,
    #                           0 for the strcmp-largest
    grade: np.ndarray         # [n] judgment of the row (0 if unjudged)
    judged: np.ndarray        # [n] bool
    keep: np.ndarray          # [n_run] bool: the row's query is judged
    n_rel: np.ndarray         # [Q] R
    n_nonrel: np.ndarray      # [Q] judged, not relevant
    idcg: np.ndarray          # [Q, 1 + len(CUT_ALL)] ideal DCG: full, @k
    relevance_level: int


#: every cutoff any family may ask for an ideal DCG at
_IDCG_CUTS: Tuple[int, ...] = CUTOFFS


def prepare(qrel_qid, qrel_doc, qrel_grade, run_qid, run_doc,
            relevance_level: int = 1) -> Prepared:
    """Join a flat run with flat qrels, from the strings."""
    if relevance_level <= 0:
        raise ValueError("relevance_level must be > 0")
    qrel_grade = np.asarray(qrel_grade, dtype=np.int64)
    qr_q, run_q = dense_rank(qrel_qid, run_qid)
    qr_d, run_d = dense_rank(qrel_doc, run_doc)
    # queries: those in both the run and the qrels
    judged_q = np.zeros(int(max(qr_q.max(initial=-1),
                                run_q.max(initial=-1))) + 1, dtype=bool)
    judged_q[qr_q] = True
    keep = judged_q[run_q]
    used = np.unique(run_q[keep])
    remap = np.full(len(judged_q), -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    uq, first = np.unique(qr_q, return_index=True)
    qids = [str(s) for s in
            np.asarray(qrel_qid)[first[np.searchsorted(uq, used)]]]
    nq = len(used)

    q = remap[run_q[keep]]
    docrank = run_d[keep]
    # join on (query, docno rank)
    span = np.int64(max(int(qr_d.max(initial=0)),
                        int(run_d.max(initial=0))) + 1)
    qq = remap[qr_q]
    inq = qq >= 0
    qkey = qq[inq] * span + qr_d[inq]
    qval = qrel_grade[inq]
    order = np.argsort(qkey, kind="stable")
    qkey, qval = qkey[order], qval[order]
    if len(qkey) and np.any(qkey[1:] == qkey[:-1]):
        raise ValueError("a (query, docno) pair is judged twice")
    rkey = q * span + docrank
    pos = np.minimum(np.searchsorted(qkey, rkey), max(len(qkey) - 1, 0))
    judged = (qkey[pos] == rkey) if len(qkey) else np.zeros(len(rkey), bool)
    grade = np.where(judged, qval[pos] if len(qval) else 0, 0)
    # each row's place in its query by docno, descending
    order = np.argsort(rkey, kind="stable")
    counts = np.bincount(q, minlength=nq)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    docdesc = np.empty(len(q), dtype=np.int64)
    docdesc[order] = counts[q[order]] - 1 - (np.arange(len(q))
                                             - start[q[order]])

    # qrel statistics of the evaluated queries
    g_rel = (qval >= relevance_level).astype(np.float64)
    qk = qkey // span
    n_rel = np.bincount(qk, weights=g_rel, minlength=nq)
    n_nonrel = np.bincount(qk, minlength=nq) - n_rel
    # ideal DCG: every judgment of the query, grades descending
    iord = np.lexsort((-qval, qk))
    iq, ig = qk[iord], np.maximum(qval[iord], 0).astype(np.float64)
    istart = np.searchsorted(iq, np.arange(nq))
    ipos = np.arange(len(iq)) - istart[iq] + 1
    gain = ig / np.log2(ipos + 1.0)
    idcg = np.zeros((nq, 1 + len(_IDCG_CUTS)))
    idcg[:, 0] = np.bincount(iq, weights=gain, minlength=nq)
    for i, k in enumerate(_IDCG_CUTS):
        idcg[:, 1 + i] = np.bincount(iq, weights=gain * (ipos <= k),
                                     minlength=nq)
    return Prepared(qids, q, docdesc, grade, judged, keep, n_rel, n_nonrel,
                    idcg, int(relevance_level))


def rank_order(prep: Prepared, scores: np.ndarray) -> np.ndarray:
    """Row order ranking every query: by query, then score descending
    (equal floats tie, so -0.0 ties 0.0), then docno descending. One
    integer key when its three parts fit in 62 bits, a lexsort if not."""
    uniq, srank = np.unique(scores, return_inverse=True)
    sdesc = len(uniq) - 1 - srank.reshape(-1)
    bits = [max(int(x).bit_length(), 1) for x in
            (len(prep.qids), len(uniq), int(prep.docdesc.max(initial=0)) + 1)]
    if sum(bits) > 62:
        return np.lexsort((prep.docdesc, sdesc, prep.q))
    key = ((prep.q.astype(np.int64) << (bits[1] + bits[2]))
           | (sdesc.astype(np.int64) << bits[2]) | prep.docdesc)
    return np.argsort(key, kind="stable")


def _div(num, den):
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)


def evaluate(prep: Prepared, scores,
             measures: Sequence[str]) -> Dict[str, np.ndarray]:
    """Per-query values of ``measures`` for one score set of the run:
    key → float64 ``[Q]`` aligned with ``prep.qids``.

    ``scores`` is the run's flat score array, in the run's row order.
    """
    scores = np.asarray(scores)[prep.keep].astype(np.float64)
    nq = len(prep.qids)
    order = rank_order(prep, scores)
    q = prep.q[order]
    rel = (prep.judged[order]
           & (prep.grade[order] >= prep.relevance_level)).astype(np.float64)
    judged = prep.judged[order]
    grade = np.maximum(prep.grade[order], 0).astype(np.float64)
    n = len(q)
    counts = np.bincount(q, minlength=nq)
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n) - start[q] + 1  # 1-based rank

    def seg_cumsum(x):
        c = np.cumsum(x)
        before = np.concatenate([[0.0], c])[start]
        return c - before[q]

    def at_depth(cum, k):
        """``cum`` at rank min(k, retrieved) of every query."""
        return cum[start + np.minimum(k, counts) - 1]

    cum = seg_cumsum(rel)
    prec = cum / pos
    ap_cum = seg_cumsum(rel * prec)
    dcg_cum = seg_cumsum(grade / np.log2(pos + 1.0))
    R = prep.n_rel
    n_rel_ret = at_depth(cum, n)
    ap = _div(at_depth(ap_cum, n), R)

    out: Dict[str, np.ndarray] = {}
    for fam, params in parse(measures):
        if fam == "num_ret":
            out[fam] = counts.astype(np.float64)
        elif fam == "num_rel":
            out[fam] = R.copy()
        elif fam == "num_rel_ret":
            out[fam] = n_rel_ret
        elif fam == "map":
            out[fam] = ap
        elif fam == "gm_map":
            out[fam] = np.log(np.maximum(ap, GM_MIN))
        elif fam == "Rprec":
            rk = np.maximum(R, 1).astype(np.int64)
            out[fam] = _div(at_depth(cum, rk), R)
        elif fam == "recip_rank":
            first = (rel > 0) & (cum == 1)
            rr = np.zeros(nq)
            rr[q[first]] = 1.0 / pos[first]
            out[fam] = rr
        elif fam == "bpref":
            jn = (judged & (rel == 0)).astype(np.float64)
            above = seg_cumsum(jn) - jn
            den = np.minimum(prep.n_nonrel, R)[q]
            term = np.where(above > 0,
                            1.0 - _div(np.minimum(above, R[q]), den), 1.0)
            out[fam] = _div(np.bincount(q, weights=term * rel,
                                        minlength=nq), R)
        elif fam == "ndcg":
            out[fam] = _div(at_depth(dcg_cum, n), prep.idcg[:, 0])
        elif fam == "iprec_at_recall":
            # suffix max of precision within each query, on the reversed
            # array with an offset per query that no precision can cross
            off = (nq - 1 - q)[::-1] * 2.0
            suf = (np.maximum.accumulate(prec[::-1] + off) - off)[::-1]
            for pct in params:
                target = (pct * R.astype(np.int64) + 99) // 100
                below = np.bincount(q, weights=cum < target[q],
                                    minlength=nq).astype(np.int64)
                reached = (target <= n_rel_ret) & (R > 0)
                idx = start + np.minimum(below, counts - 1)
                out[f"iprec_at_recall_{pct / 100:.2f}"] = np.where(
                    reached, suf[idx], 0.0)
        else:
            for k in params:
                key = f"{fam}_{k}"
                if fam == "P":
                    out[key] = at_depth(cum, k) / k
                elif fam == "recall":
                    out[key] = _div(at_depth(cum, k), R)
                elif fam == "success":
                    out[key] = (at_depth(cum, k) > 0).astype(np.float64)
                elif fam == "map_cut":
                    out[key] = _div(at_depth(ap_cum, k), R)
                elif fam == "ndcg_cut":
                    ideal = prep.idcg[:, 1 + _IDCG_CUTS.index(k)]
                    out[key] = _div(at_depth(dcg_cum, k), ideal)
    return out


def summary(per_query: Dict[str, np.ndarray]) -> Dict[str, float]:
    """trec_eval's ``all`` row: the mean over queries (for ``gm_map``,
    ``exp`` of the mean log)."""
    out = {}
    for k, v in per_query.items():
        m = float(np.mean(v)) if len(v) else 0.0
        out[k] = math.exp(m) if k == "gm_map" else m
    return out


def bfloat16(x) -> np.ndarray:
    """``x`` rounded to bfloat16 (nearest, ties to even), held in float32:
    the precision one step below float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    lsb = (b >> np.uint32(16)) & np.uint32(1)
    r = (b + np.uint32(0x7FFF) + lsb) & np.uint32(0xFFFF0000)
    return r.view(np.float32)
