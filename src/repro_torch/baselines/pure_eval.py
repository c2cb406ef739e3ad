"""Pure-Python trec_eval measure engine (no numpy, torch or jax).

Semantics identical to ``repro_torch.core.measures`` (trec_eval reference):
score-descending ranking, ties broken by docno descending; unjudged docs are
non-relevant; map/recall/Rprec normalized by R from the qrels; linear-gain
NDCG with the ideal drawn from the qrels.

This module intentionally avoids every scientific library so that:
  (1) the RQ1 subprocess baseline has trec_eval-like startup cost (a C binary
      starts in milliseconds; importing numpy/torch would not be comparable);
  (2) it is an *independent* oracle for cross-validating the measure core.
"""

from __future__ import annotations

from math import log2
from typing import Dict, Iterable, Mapping

DEFAULT_CUTOFFS = (5, 10, 15, 20, 30, 100, 200, 500, 1000)
SUCCESS_CUTOFFS = (1, 5, 10)


def rank_documents(doc_scores: Mapping[str, float]) -> list:
    """trec_eval ordering: score desc, docno desc."""
    return sorted(doc_scores, key=lambda doc: (-doc_scores[doc], _neg_str(doc)))


class _neg_str(str):
    """Sort helper: reverses lexicographic comparison (descending docno)."""

    __slots__ = ()

    def __lt__(self, other):  # type: ignore[override]
        return str.__gt__(self, other)


def evaluate_query(
    doc_scores: Mapping[str, float],
    qrel: Mapping[str, int],
    measures: Iterable[str] = ("map", "ndcg"),
    relevance_level: int = 1,
) -> Dict[str, float]:
    """All requested measures for one query.  One pass over the ranking."""
    ranking = rank_documents(doc_scores)
    rels = [qrel.get(doc) for doc in ranking]

    n_rel = sum(1 for r in qrel.values() if r >= relevance_level)
    n_judged_nonrel = sum(
        1 for r in qrel.values() if r < relevance_level
    )

    # --- single pass, trec_eval style -------------------------------------
    cum_rel = 0
    nonrel_above = 0
    ap_sum = 0.0
    bpref_sum = 0.0
    dcg_val = 0.0
    first_rel_rank = 0
    rprec_num = 0
    cut_hits = {}  # cutoff -> relevant count at cutoff
    dcg_cuts = {}
    map_cut_sums = {}
    cutoffs = sorted(set(DEFAULT_CUTOFFS) | set(SUCCESS_CUTOFFS))
    ci = 0
    bpref_bound = min(n_rel, n_judged_nonrel)
    for rank0, rel in enumerate(rels):
        rank = rank0 + 1
        judged_rel = rel is not None and rel >= relevance_level
        judged_nonrel = rel is not None and rel < relevance_level
        if judged_rel:
            cum_rel += 1
            ap_sum += cum_rel / rank
            if first_rel_rank == 0:
                first_rel_rank = rank
            if nonrel_above > 0:
                bpref_sum += 1.0 - min(nonrel_above, n_rel) / bpref_bound
            else:
                bpref_sum += 1.0
        if judged_nonrel:
            nonrel_above += 1
        if rel is not None and rel > 0:
            dcg_val += rel / log2(rank + 1)
        if rank == n_rel:
            rprec_num = cum_rel
        while ci < len(cutoffs) and rank == cutoffs[ci]:
            cut_hits[cutoffs[ci]] = cum_rel
            dcg_cuts[cutoffs[ci]] = dcg_val
            map_cut_sums[cutoffs[ci]] = ap_sum
            ci += 1
    n_ret = len(rels)
    if n_ret < n_rel:
        rprec_num = cum_rel
    for c in cutoffs[ci:]:
        cut_hits[c] = cum_rel
        dcg_cuts[c] = dcg_val
        map_cut_sums[c] = ap_sum

    ideal = sorted((r for r in qrel.values() if r > 0), reverse=True)
    idcg = 0.0
    idcg_cuts = {}
    ci = 0
    for rank0, rel in enumerate(ideal):
        rank = rank0 + 1
        idcg += rel / log2(rank + 1)
        while ci < len(cutoffs) and rank == cutoffs[ci]:
            idcg_cuts[cutoffs[ci]] = idcg
            ci += 1
    for c in cutoffs[ci:]:
        idcg_cuts[c] = idcg

    out: Dict[str, float] = {}
    for m in measures:
        if m == "map":
            out["map"] = ap_sum / n_rel if n_rel else 0.0
        elif m == "ndcg":
            out["ndcg"] = dcg_val / idcg if idcg > 0 else 0.0
        elif m == "recip_rank":
            out["recip_rank"] = 1.0 / first_rel_rank if first_rel_rank else 0.0
        elif m == "Rprec":
            out["Rprec"] = rprec_num / n_rel if n_rel else 0.0
        elif m == "bpref":
            out["bpref"] = bpref_sum / n_rel if n_rel else 0.0
        elif m == "num_ret":
            out["num_ret"] = float(n_ret)
        elif m == "num_rel":
            out["num_rel"] = float(n_rel)
        elif m == "num_rel_ret":
            out["num_rel_ret"] = float(cum_rel)
        elif m == "P":
            for k in DEFAULT_CUTOFFS:
                out[f"P_{k}"] = cut_hits[k] / k
        elif m == "recall":
            for k in DEFAULT_CUTOFFS:
                out[f"recall_{k}"] = cut_hits[k] / n_rel if n_rel else 0.0
        elif m == "success":
            for k in SUCCESS_CUTOFFS:
                out[f"success_{k}"] = 1.0 if cut_hits[k] > 0 else 0.0
        elif m == "ndcg_cut":
            for k in DEFAULT_CUTOFFS:
                ic = idcg_cuts[k]
                out[f"ndcg_cut_{k}"] = dcg_cuts[k] / ic if ic > 0 else 0.0
        elif m == "map_cut":
            for k in DEFAULT_CUTOFFS:
                out[f"map_cut_{k}"] = map_cut_sums[k] / n_rel if n_rel else 0.0
        else:
            raise ValueError(f"unsupported measure: {m}")
    return out


def evaluate(
    run: Mapping[str, Mapping[str, float]],
    qrel: Mapping[str, Mapping[str, int]],
    measures: Iterable[str] = ("map", "ndcg"),
    relevance_level: int = 1,
) -> Dict[str, Dict[str, float]]:
    measures = tuple(measures)
    return {
        qid: evaluate_query(docs, qrel[qid], measures, relevance_level)
        for qid, docs in run.items()
        if qid in qrel
    }
