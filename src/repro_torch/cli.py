"""trec_eval-compatible command line: ``python -m repro_torch <qrel> <run>``.

The PyTorch port of ``python -m repro``, with the same flags and output::

    python -m repro_torch [-q] [-c] [-l N] [-m MEASURE ...] [-J] [--sharded]
                          [--device {cuda,cpu}] qrel run

Flags mirror trec_eval:

* ``-q`` — print per-query results (query-major blocks, run-file order)
  before the ``all`` summary.
* ``-c`` — average over every query in the qrels; queries with no results
  contribute 0 to every measure (and their R to ``num_rel``).
* ``-l N`` — relevance level: judgments >= N count as relevant (default 1).
* ``-J`` — judged-docs-only: unjudged retrieved documents are removed from
  every ranking before scoring (trec_eval's ``-J``).
* ``-m MEASURE`` — repeatable measure selector in either dialect: a
  trec_eval family (``map``, ``ndcg_cut``), a parameterized family
  (``P.5,10``), an output-style key (``ndcg_cut_10``), an ir-measures
  spelling (``nDCG@10``, ``AP(rel=2)``, ``RBP(p=0.8)``), or ``all`` (every
  supported measure, the default).  Aggregate-only measures (``gm_map``,
  the geometric-mean MAP) print a summary line only — never per-query
  lines — exactly like trec_eval.
* ``--sharded`` — evaluate through the fused-measure kernel
  (``repro_torch.distributed.sharded_evaluator``) instead of the measure
  core; the printed output does not change.
* ``--device`` — where to evaluate: ``cuda`` (default; fails without a
  GPU) or ``cpu`` (the kernels' plain PyTorch versions).

Output format is trec_eval's: ``measure<tab>qid<tab>value`` with the measure
name left-justified to 22 columns, floats printed with 4 decimals and the
count measures (``num_q``, ``num_ret``, ``num_rel``, ``num_rel_ret``) as
integers.  In the summary, count measures are sums over queries; everything
else is the arithmetic mean.  ``runid`` is the tag column of the run file.

Print order, the integer/sum/aggregate-only measure sets, and the ``-c``
missing-query contributions are all derived from
:mod:`repro_torch.core.registry` — the CLI holds no measure tables of its
own.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core import (RelevanceEvaluator, measures as M, registry,
                              supported_measures, trec)

#: summary/per-query print order == registry declaration order (trec_eval
#: prints its registry order; so do we, stable under any -m combination)
FAMILY_ORDER = registry.family_order()

#: measures printed as integers (trec_eval uses %ld for these)
INT_MEASURES = frozenset({"num_q"}) | registry.integer_keys()

#: measures summarized by summation rather than the mean over queries
SUM_MEASURES = registry.sum_families()

#: aggregate-only measures: suppressed from per-query (-q) blocks, and their
#: summary is exp(mean(log contributions)) — trec_eval's geometric mean
AGGREGATE_ONLY = M.AGGREGATE_ONLY_MEASURES


def ordered_keys(measures: Sequence[str]) -> List[str]:
    """Output keys for a measure set (either dialect), in print order."""
    # canonicalize merges repeated same-family selectors (-m P_5 -m P@10)
    # into one entry with the union of params; this only reorders families.
    # The rel= level (if any) is resolved again by the evaluator.
    parsed: Dict[str, tuple] = dict(registry.canonicalize(measures)[0])
    keys: List[str] = []
    for fam in FAMILY_ORDER:
        if fam in parsed:
            keys.extend(M.family_keys(fam, parsed[fam]))
    return keys


def format_line(measure: str, qid: str, value) -> str:
    """One trec_eval output line: %-22s\\t%s\\t%value."""
    if measure == "runid":
        val = str(value)
    elif measure in INT_MEASURES:
        val = str(int(round(float(value))))
    else:
        val = f"{float(value):.4f}"
    return f"{measure:<22}\t{qid}\t{val}"


def _summarize(results: Dict[str, Dict[str, float]], keys: Sequence[str],
               qrel: Dict[str, Dict[str, int]], complete: bool,
               relevance_level: int) -> Dict[str, float]:
    """The 'all' row: sums for count measures, means for the rest.

    With ``complete`` (-c), queries judged in the qrels but absent from the
    run divide every mean and contribute their R to ``num_rel``.
    """
    n_q = len(qrel) if complete else len(results)
    summary: Dict[str, float] = {"num_q": float(n_q)}
    denom = float(max(n_q, 1))
    n_missing = n_q - len(results)
    for k in keys:
        total = sum(res[k] for res in results.values())
        contrib = registry.missing_contribution(k)
        if contrib == "n_rel" and complete:
            # a missing query still contributes its R to num_rel
            total += sum(
                float(sum(r >= relevance_level for r in docs.values()))
                for qid, docs in qrel.items() if qid not in results)
        elif contrib == "log_gm_min":
            # missing queries under -c have AP 0, clipped to GM_MIN
            total += np.log(M.GM_MIN) * n_missing
        summary[k] = total if k in SUM_MEASURES else total / denom
    out = M.finalize_aggregates(summary)
    if n_q == 0:  # no queries: report 0, not exp(empty mean) = 1
        for k in AGGREGATE_ONLY & set(out):
            out[k] = 0.0
    return out


def summary_lines(results: Dict[str, Dict[str, float]], keys: Sequence[str],
                  qrel: Dict[str, Dict[str, int]], runid: str, *,
                  complete: bool = False,
                  relevance_level: int = 1) -> List[str]:
    """trec_eval's summary block: the ``runid`` and ``num_q`` lines, then
    one ``all`` line per key."""
    summary = _summarize(results, keys, qrel, complete, relevance_level)
    return ([format_line("runid", "all", runid),
             format_line("num_q", "all", summary["num_q"])]
            + [format_line(k, "all", summary[k]) for k in keys])


def add_measure_args(ap: argparse.ArgumentParser) -> None:
    """The measure-selection flags: ``-l``, repeatable ``-m``, ``-J``."""
    ap.add_argument("-l", dest="level", type=int, default=1, metavar="N",
                    help="relevance level: judgment >= N is relevant "
                         "(default 1)")
    ap.add_argument("-m", dest="measures", action="append", metavar="MEASURE",
                    help="measure family/key in either dialect — trec_eval "
                         "(map, P.5,10, ndcg_cut_10) or ir-measures "
                         "(AP, P@5, nDCG@10, RBP(p=0.8)) — repeatable; "
                         "default: all supported measures")
    ap.add_argument("-J", dest="judged_docs_only", action="store_true",
                    help="judged docs only: remove unjudged retrieved "
                         "documents from every ranking before scoring")


def resolve_measures(selected: Optional[Sequence[str]]) -> List[str]:
    """Expand the ``-m`` selections (``None``/``all`` → every family)."""
    selected = list(selected or ["all"])
    if "all" in selected:
        return sorted(supported_measures)
    return selected


def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch",
        description="trec_eval-compatible evaluation of a TREC run file "
                    "against a qrel file (in-process, on a CUDA device).")
    ap.add_argument("qrel_path", metavar="qrel", help="TREC qrel file")
    ap.add_argument("run_path", metavar="run", help="TREC run file")
    ap.add_argument("-q", dest="per_query", action="store_true",
                    help="print per-query results before the summary")
    ap.add_argument("-c", dest="complete", action="store_true",
                    help="average over all qrel queries (missing queries "
                         "count as 0)")
    add_measure_args(ap)
    ap.add_argument("--sharded", action="store_true",
                    help="evaluate through the fused-measure kernel")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to evaluate (default: cuda)")
    args = ap.parse_args(argv)
    out = out or sys.stdout

    selected = resolve_measures(args.measures)
    try:
        keys = ordered_keys(selected)
    except ValueError as e:
        ap.error(str(e))

    qrel = trec.load_qrel(args.qrel_path)
    runid = trec.run_id(args.run_path)
    try:
        ev = RelevanceEvaluator(qrel, selected, relevance_level=args.level,
                                judged_docs_only=args.judged_docs_only,
                                device=args.device)
    except (ValueError, RuntimeError) as e:  # bad measure / no CUDA device
        ap.error(str(e))
    # Tokenized ingest: run file → flat arrays → RunBuffer (no dict-of-dicts).
    qids_arr, docnos, scores = trec.load_run_arrays(args.run_path)
    # trec_eval rejects duplicate (qid, docno) rows; the array fast path does
    # not re-check, so the CLI must (silently-wrong measures otherwise).
    pairs = np.char.add(np.char.add(qids_arr.astype(str), "\x1f"),
                        docnos.astype(str))
    if np.unique(pairs).size != pairs.size:
        ap.error(f"duplicate (qid, docno) rows in run file {args.run_path}")
    buf = ev.buffer_from_arrays(qids_arr, docnos, scores)
    if args.sharded:
        from repro_torch.distributed import ShardedEvaluator

        results = ShardedEvaluator(ev).evaluate_buffer(buf).per_query
    else:
        results = ev.evaluate_buffer(buf)

    lines: List[str] = []
    if args.per_query:
        # Query-major blocks, queries in run-file first-appearance order.
        # Aggregate-only measures (gm_map) have no per-query line, like
        # trec_eval.
        pq_keys = [k for k in keys if k not in AGGREGATE_ONLY]
        for qid in dict.fromkeys(qids_arr.tolist()):
            if qid not in results:
                continue
            lines.extend(
                format_line(k, qid, results[qid][k]) for k in pq_keys)
    # the evaluator resolved rel= annotations against -l; use its level so
    # num_rel's missing-query R matches what was actually scored
    lines.extend(summary_lines(results, keys, qrel, runid,
                               complete=args.complete,
                               relevance_level=ev.relevance_level))
    out.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
