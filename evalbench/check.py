"""The comparison that decides ``correct``.

The program's outputs from calls of the measured window are held against
the plain reference (``reference/trec_eval.py``), which works every score
set out again from the strings and the scores the benchmark generated.
Two numbers come out of a comparison, each beside its limit from the
traffic file:

* ``max_gap``: the widest absolute gap between a value the program
  returned and the reference's value for it, over every query, measure
  and score set compared (for a step that returns corpus means, over
  every mean);
* ``missing``: values the reference has and the program did not return,
  or returned as a number that is not finite (limit 0).

The control (``put_control``) is the reference one precision below the
configuration's float32, put in the program's place: scores rounded to
bfloat16 before ranking, every value it returns rounded to bfloat16.
"""

from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from evalbench.reference import trec_eval


class Reference:
    """The reference for one collection: the string work done once, then
    any score set of the pool on demand."""

    def __init__(self, col, measures, relevance_level: int,
                 lower_precision: bool = False):
        self.prep = trec_eval.prepare(
            col.qrel_qid, col.qrel_doc, col.qrel_grade, col.run_qid,
            col.run_doc, relevance_level)
        self.measures = list(measures)
        self.keys = trec_eval.keys(self.measures)
        self.lower = lower_precision
        self.index = {q: i for i, q in enumerate(self.prep.qids)}

    def per_query(self, scores) -> Dict[str, np.ndarray]:
        """key → ``[Q]`` float64 for one score set. As the control, the
        scores are rounded to bfloat16 before ranking and every value to
        bfloat16 after."""
        if self.lower:
            scores = trec_eval.bfloat16(scores)
        out = trec_eval.evaluate(self.prep, scores, self.measures)
        if self.lower:
            out = {k: trec_eval.bfloat16(v).astype(np.float64)
                   for k, v in out.items()}
        return out


def compare(kind, qids, keys, table, want: List[Dict[str, np.ndarray]],
            ref: Reference) -> Dict[str, float]:
    """Gaps between one call's output and the reference's values for the
    score sets it used (``want``, one dict a set)."""
    col = {k: i for i, k in enumerate(keys)}
    missing, max_gap = 0, 0.0
    if kind == "per_query":
        pos = np.array([ref.index.get(q, -1) for q in qids], dtype=np.int64)
        found = pos >= 0
        missing += (len(ref.prep.qids) - len(set(pos[found].tolist()))) \
            * len(ref.keys) * len(want)
    for s, w in enumerate(want):
        for k in ref.keys:
            if k not in col:
                missing += len(ref.prep.qids) if kind == "per_query" else 1
                continue
            if kind == "mean":
                got = np.asarray([table[s, col[k]]])
                exp = np.asarray([np.mean(w[k])])
            else:
                got = table[s, found, col[k]]
                exp = w[k][pos[found]]
            ok = np.isfinite(got)
            missing += int((~ok).sum())
            if ok.any():
                gap = float(np.max(np.abs(got[ok] - exp[ok])))
                max_gap = max(max_gap, gap)
    return {"max_gap": max_gap, "missing": float(missing)}


class _Sweep:
    """The control's answer in the form of ``evaluate_sweep``'s."""

    def __init__(self, qids, keys, vals):
        self.qids, self.measure_keys = qids, keys
        self.table = np.stack([np.stack([v[k] for k in keys], -1)
                               for v in vals])


def put_control(session, col, pool, measures, relevance_level) -> None:
    """Put the control in the place of the session's calls, answering in
    the form the session's entry answers in: per-query dicts, a sweep's
    table, or corpus means (the mean of the bfloat16 values, itself
    rounded to bfloat16)."""
    low = Reference(col, measures, relevance_level, lower_precision=True)
    kind = session.values(session.call(0))[0]
    keys = low.keys

    def call(i):
        vals = [low.per_query(pool[s]) for s in session.score_sets(i)]
        if kind == "mean":
            return trec_eval.bfloat16([np.mean(vals[0][k]) for k in keys])
        if len(vals) == 1:
            return {q: {k: float(vals[0][k][j]) for k in keys}
                    for j, q in enumerate(low.prep.qids)}
        return _Sweep(low.prep.qids, keys, vals)

    def values(out):
        if kind == "mean":
            return "mean", None, keys, np.asarray(out, np.float64)[None]
        if isinstance(out, dict):
            qids = list(out)
            return ("per_query", qids, keys,
                    np.array([[out[q][k] for k in keys] for q in qids])[None])
        return "per_query", list(out.qids), keys, out.table

    session.call, session.values = call, values


def judge(readings: Dict[str, float], limits: Dict[str, float]):
    """(correct, checks): every reading at or under its limit; the checks
    in the order they print, each ``{"value", "limit"}``."""
    checks = {name: {"value": readings[name], "limit": float(limits[name])}
              for name in limits}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks


def print_checks(checks) -> None:
    """Each number compared beside its limit, as the last lines of
    standard error."""
    for name, c in checks.items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
