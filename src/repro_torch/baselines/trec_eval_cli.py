"""File-based evaluation CLI — the subprocess target of RQ1.

Mimics ``trec_eval``'s interface and output format::

    python -m repro_torch.baselines.trec_eval_cli [-q] [-m MEASURE]... qrel_file run_file

Output lines: ``measure \t qid \t value`` (with qid ``all`` for the mean),
exactly the stream a serialize-invoke-parse workflow has to parse.

Keep imports minimal: this process's startup cost is part of what RQ1
measures, and the reference trec_eval is a small C binary.  The process
imports no torch, numpy or jax: ``repro_torch`` and ``repro_torch.core``
resolve their heavy names lazily, and ``core.trec`` imports numpy only in
its array parsers.
"""

from __future__ import annotations

import argparse
import sys

from repro_torch.baselines import pure_eval
from repro_torch.core import trec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="trec_eval_cli")
    ap.add_argument("-q", action="store_true", help="per-query output")
    ap.add_argument("-m", action="append", default=None, metavar="MEASURE")
    ap.add_argument("-l", type=int, default=1, metavar="REL_LEVEL")
    ap.add_argument("qrel_file")
    ap.add_argument("run_file")
    args = ap.parse_args(argv)

    measures = tuple(args.m) if args.m else ("map", "ndcg")
    if "all_trec" in measures:
        measures = ("map", "ndcg", "ndcg_cut", "P", "recall", "recip_rank",
                    "Rprec", "bpref", "success", "map_cut", "num_ret",
                    "num_rel", "num_rel_ret")

    qrel = trec.load_qrel(args.qrel_file)
    run = trec.load_run(args.run_file)
    results = pure_eval.evaluate(run, qrel, measures, args.l)

    out = sys.stdout
    if not results:
        return 0
    keys = list(next(iter(results.values())).keys())
    if args.q:
        for qid, vals in results.items():
            for k in keys:
                out.write(f"{k}\t{qid}\t{vals[k]:.4f}\n")
    nq = len(results)
    for k in keys:
        mean = sum(results[q][k] for q in results) / nq
        out.write(f"{k}\tall\t{mean:.4f}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
