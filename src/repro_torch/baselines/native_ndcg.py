"""The paper's RQ2 baseline: fastest native-Python NDCG, no numpy.

The paper adapted "the fastest open-source implementation" of NDCG in plain
Python; this is our equivalent — hand-tuned dict/sort code with local-variable
caching, computing a single measure for a single query, matching trec_eval
semantics (linear gain, score-desc/docno-desc ordering, qrel-side ideal).
"""

from __future__ import annotations

from math import log2
from typing import Mapping


def ndcg(doc_scores: Mapping[str, float], qrel: Mapping[str, int]) -> float:
    """NDCG over the full ranking (trec_eval 'ndcg' measure)."""
    get = qrel.get
    items = sorted(doc_scores.items(), key=_key)
    _log2 = log2
    dcg = 0.0
    rank = 1
    for doc, _score in items:
        rel = get(doc)
        if rel is not None and rel > 0:
            dcg += rel / _log2(rank + 1)
        rank += 1
    idcg = 0.0
    rank = 1
    for rel in sorted(qrel.values(), reverse=True):
        if rel <= 0:
            break
        idcg += rel / _log2(rank + 1)
        rank += 1
    return dcg / idcg if idcg > 0.0 else 0.0


def _key(item):
    doc, score = item
    return (-score, _RevStr(doc))


class _RevStr(str):
    __slots__ = ()

    def __lt__(self, other):  # descending docno on score ties
        return str.__gt__(self, other)
