"""Significance-table CLI: ``python -m repro_torch.compare <qrel> <run> ...``.

The PyTorch port of ``python -m repro.compare``, with the same flags and
output plus ``--device``.  K TREC run files are scored against one qrel in
a single batched sweep (:func:`repro_torch.core.sweep.evaluate_sweep`) and
every system pair is tested with :mod:`repro_torch.stats`::

    python -m repro_torch.compare tests/fixtures/conformance.qrel \\
        run_a.run run_b.run run_c.run -m map -m ndcg

Flags:

* ``-m MEASURE`` — repeatable, in either dialect (``map`` or ``AP``,
  ``ndcg_cut_10`` or ``nDCG@10``): one comparison block per resulting
  output key, default ``map`` (``all`` expands to every supported measure).
* ``-l N`` — relevance level; ``-J`` removes unjudged retrieved documents
  before scoring, as in ``python -m repro_torch``.
* ``--test {t,permutation,both}`` — which paired test(s) to run (default
  ``t``; the permutation test samples ``--permutations`` sign flips from a
  generator on the device seeded with ``--seed``).
* ``--alpha A`` — threshold for the trailing ``*`` marker, applied to the
  Holm-corrected t-test p-value (default 0.05).
* ``--sharded`` — evaluate the sweep through the fused-measure kernel.
* ``--device`` — where to evaluate and test: ``cuda`` (default; fails
  without a GPU) or ``cpu``.

Output is deterministic, tab-separated, and byte-matches
``tests/fixtures/compare.golden``::

    runid   <run-name>      <tag from the run file>          (one per run)
    num_q   all     <number of common judged queries>
    measure all     <key>                                    (block start)
    mean    <run-name>      <summary value, 4 decimals>
    pair    <a>:<b> diff=+0.1234  t=+2.0000  p=0.2952  p_holm=0.2952  p_bonf=0.2952 [*]

Runs are named by file basename (minus a trailing ``.run``/``.txt``);
pairs are listed in run order, upper triangle only.  Queries compared are
the intersection of the runs' query sets with the judged set.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Sequence

from repro_torch import cli
from repro_torch.core import trec
from repro_torch.core.sweep import evaluate_sweep


def _run_name(path: str, taken: List[str]) -> str:
    """File basename (extension-stripped), de-duplicated by suffixing."""
    base = os.path.basename(path)
    for ext in (".run", ".txt", ".gz"):
        if base.endswith(ext):
            base = base[: -len(ext)]
            break
    name = base or "run"
    i = 2
    while name in taken:
        name = f"{base}.{i}"
        i += 1
    return name


def _fmt(value: float, signed: bool = False) -> str:
    return f"{value:+.4f}" if signed else f"{value:.4f}"


def main(argv: Optional[Sequence[str]] = None, out=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.compare",
        description="Evaluate K TREC run files against one qrel in a single "
                    "batched sweep and print paired-significance tables "
                    "for every system pair.")
    ap.add_argument("qrel_path", metavar="qrel", help="TREC qrel file")
    ap.add_argument("run_paths", metavar="run", nargs="+",
                    help="two or more TREC run files to compare")
    cli.add_measure_args(ap)
    ap.add_argument("--test", choices=("t", "permutation", "both"),
                    default="t",
                    help="paired test(s) to report (default: t)")
    ap.add_argument("--permutations", type=int, default=2000, metavar="N",
                    help="Monte-Carlo sign flips for the permutation test "
                         "(default 2000)")
    ap.add_argument("--seed", type=int, default=0, metavar="S",
                    help="generator seed for the permutation test "
                         "(default 0)")
    ap.add_argument("--alpha", type=float, default=0.05, metavar="A",
                    help="Holm-corrected significance threshold for the "
                         "'*' marker (default 0.05)")
    ap.add_argument("--sharded", action="store_true",
                    help="evaluate the sweep through the fused-measure "
                         "kernel")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where to evaluate (default: cuda)")
    args = ap.parse_args(argv)
    out = out or sys.stdout
    if len(args.run_paths) < 2:
        ap.error("compare needs at least two run files")

    selected = cli.resolve_measures(args.measures if args.measures
                                    else ["map"])
    try:
        keys = cli.ordered_keys(selected)
    except ValueError as e:
        ap.error(str(e))
    tests = {"t": ("t",), "permutation": ("t", "permutation"),
             "both": ("t", "permutation")}[args.test]
    show_perm = "permutation" in tests

    qrel = trec.load_qrel(args.qrel_path)
    names: List[str] = []
    tags: List[str] = []
    runs = []
    for path in args.run_paths:
        names.append(_run_name(path, names))
        tags.append(trec.run_id(path))
        runs.append(trec.load_run(path))

    try:
        result = evaluate_sweep(
            qrel, runs, measures=selected, relevance_level=args.level,
            backend="sharded" if args.sharded else "single",
            run_names=names, judged_docs_only=args.judged_docs_only,
            device=args.device)
    except (ValueError, RuntimeError) as e:  # bad input / no CUDA device
        ap.error(str(e))

    lines: List[str] = []
    for name, tag in zip(names, tags):
        lines.append(f"runid\t{name}\t{tag}")
    lines.append(f"num_q\tall\t{len(result.qids)}")
    aggs = result.aggregates()
    k = len(names)
    for key in keys:
        report = result.compare(key, tests=tests,
                                n_permutations=args.permutations,
                                seed=args.seed)
        lines.append(f"measure\tall\t{key}")
        for name in names:
            lines.append(f"mean\t{name}\t{_fmt(aggs[name][key])}")
        diff, t, p = report["diff"], report["t"], report["p"]
        holm, bonf = report["p_holm"], report["p_bonferroni"]
        for i in range(k):
            for j in range(i + 1, k):
                cells = [
                    f"pair\t{names[i]}:{names[j]}",
                    f"diff={_fmt(float(diff[i, j]), signed=True)}",
                    f"t={_fmt(float(t[i, j]), signed=True)}",
                    f"p={_fmt(float(p[i, j]))}",
                    f"p_holm={_fmt(float(holm[i, j]))}",
                    f"p_bonf={_fmt(float(bonf[i, j]))}",
                ]
                if show_perm:
                    cells.append(
                        f"p_perm={_fmt(float(report['p_permutation'][i, j]))}")
                    cells.append("p_perm_holm=" + _fmt(float(
                        report["p_permutation_holm"][i, j])))
                if float(holm[i, j]) < args.alpha:
                    cells.append("*")
                lines.append("\t".join(cells))
    out.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
