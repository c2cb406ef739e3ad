"""K-run sweep evaluation: one batched call → a ``[K, Q, M]`` score tensor.

The port of ``repro.core.sweep``.  A hyperparameter sweep produces K system
variants that must all be scored against ONE qrel and then compared
statistically.  The K runs are tokenized once each, stacked end to end on
the query axis (:func:`repro_torch.core.evaluator.concat_run_buffers`), and
pushed through the measure core on the evaluator's device in groups of
whole runs.  Every measure is computed row-independently, so the table is
**bit-identical** to K independent
:meth:`~repro_torch.core.evaluator.RelevanceEvaluator.evaluate_buffer`
calls on the same device whenever those take the full sort (the
``"single"`` backend never takes the top-k route).

The ``"sharded"`` backend sends each group through
:meth:`repro_torch.distributed.ShardedEvaluator.evaluate_table`, the
fused-measure kernel: count columns are the same, float sums within a few
ulp.

The output :class:`SweepResult` hands ``[K, Q]`` slices straight to
:mod:`repro_torch.stats` — ``result.compare("map")`` is the one-call
sweep-and-test entry point that ``python -m repro_torch.compare`` wraps.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import measures as M, registry
from repro_torch.core.evaluator import (RelevanceEvaluator, RunBuffer,
                                        concat_run_buffers)


class SweepResult(NamedTuple):
    """Aligned per-query scores for K runs: names + a ``[K, Q, M]`` tensor.

    ``table[k, q, m]`` is measure ``measure_keys[m]`` for run
    ``run_names[k]`` on query ``qids[q]`` — float32, exactly the values the
    single-run evaluator would report.  Aggregate-only measures (``gm_map``)
    store their per-query *log contributions*; :meth:`aggregates` applies
    the geometric-mean finalization.  ``device`` is where the sweep was
    evaluated, and where :meth:`compare` runs its tests.
    """

    run_names: Tuple[str, ...]
    qids: Tuple[str, ...]
    measure_keys: Tuple[str, ...]
    table: np.ndarray
    device: Optional[torch.device] = None

    def measure(self, key: str) -> np.ndarray:
        """The ``[K, Q]`` per-query slice for one measure key.

        Accepts either dialect: ``"ndcg_cut_10"`` and ``"nDCG@10"`` name
        the same column.
        """
        lookup = key
        if lookup not in self.measure_keys:
            try:
                lookup = registry.canonical_key(key)[0]
            except registry.MeasureError:
                pass
        try:
            m = self.measure_keys.index(lookup)
        except ValueError:
            raise KeyError(
                f"measure {key!r} not in sweep (have {self.measure_keys})"
            ) from None
        return self.table[:, :, m]

    def per_query(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """pytrec_eval layout per run: ``{run: {qid: {measure: value}}}``."""
        return {
            name: {
                qid: {k: float(self.table[i, j, m])
                      for m, k in enumerate(self.measure_keys)}
                for j, qid in enumerate(self.qids)
            }
            for i, name in enumerate(self.run_names)
        }

    def aggregates(self) -> Dict[str, Dict[str, float]]:
        """Mean-over-queries summary per run (geometric for ``gm_map``)."""
        mean = self.table.mean(axis=1, dtype=np.float64)  # [K, M]
        return {
            name: M.finalize_aggregates(
                {k: float(mean[i, m])
                 for m, k in enumerate(self.measure_keys)})
            for i, name in enumerate(self.run_names)
        }

    def compare(self, measure: str = "map", *,
                tests: Sequence[str] = ("t",), n_permutations: int = 2000,
                seed: int = 0) -> Dict[str, np.ndarray]:
        """Paired significance tests between all run pairs on one measure.

        Returns :func:`repro_torch.stats.significance_report` for the
        ``[K, Q]`` slice of ``measure``, computed on the sweep's device,
        with the aligned ``run_names`` / ``measure`` / ``qids`` added so
        the bundle is self-describing.
        """
        from repro_torch import stats

        report = stats.significance_report(
            self.measure(measure), tests=tests,
            n_permutations=n_permutations, seed=seed, device=self.device)
        report["run_names"] = self.run_names
        report["measure"] = measure
        report["qids"] = self.qids
        return report


def common_qids(qrel_qids: Mapping[str, int],
                runs: Sequence[Mapping]) -> List[str]:
    """Queries every run retrieved and the qrels judged, first-run order.

    Paired statistics only make sense on queries every system answered, so
    the sweep's query axis is the intersection of the runs' query sets with
    the judged set, ordered by the first run.
    """
    qids = [q for q in runs[0] if q in qrel_qids]
    for other in runs[1:]:
        qids = [q for q in qids if q in other]
    return qids


def evaluate_sweep(
    qrel_or_evaluator,
    runs,
    measures: Optional[Sequence[str]] = None,
    relevance_level: int = 1,
    backend: str = "single",
    run_names: Optional[Sequence[str]] = None,
    judged_docs_only: bool = False,
    device=None,
) -> SweepResult:
    """Evaluate K runs against one qrel as a single batched sweep.

    ``qrel_or_evaluator`` is a qrel mapping (a
    :class:`~repro_torch.core.evaluator.RelevanceEvaluator` is built from it
    with ``measures``/``relevance_level``/``judged_docs_only``/``device``)
    or an existing evaluator whose interned state and device are reused
    (then those arguments must be left at their defaults).  ``measures``
    accepts either dialect; output keys are canonical trec_eval keys.

    ``runs`` is a sequence or ``{name: run}`` mapping of K >= 1 runs, all
    dict runs (``{qid: {docno: score}}``) or all pre-tokenized
    :class:`~repro_torch.core.evaluator.RunBuffer`\\ s.  Dict runs are
    aligned to their **common** judged query set (first run's order);
    buffers must already share one qid list and carry scores.
    ``run_names`` (or the mapping keys) label the rows; default
    ``run_0 .. run_{K-1}``.

    ``backend`` is ``"single"`` (measure core, full sort), ``"sharded"``
    (the fused-measure kernel), or ``"auto"`` (sharded iff the evaluator
    is on CUDA and more than one CUDA device is visible; see
    :func:`~repro_torch.distributed.select_backend`).  Work is dispatched
    in groups of whole runs
    bounded by the evaluator's ``chunk_queries``.

    >>> qrel = {'q1': {'d1': 1, 'd2': 0}, 'q2': {'d1': 0, 'd2': 1}}
    >>> runs = {'good': {'q1': {'d1': 2.0, 'd2': 1.0},
    ...                  'q2': {'d1': 1.0, 'd2': 2.0}},
    ...         'bad':  {'q1': {'d1': 1.0, 'd2': 2.0},
    ...                  'q2': {'d1': 2.0, 'd2': 1.0}}}
    >>> res = evaluate_sweep(qrel, runs, measures={'map'}, device='cpu')
    >>> res.run_names, res.qids, res.table.shape
    (('good', 'bad'), ('q1', 'q2'), (2, 2, 1))
    >>> res.aggregates()['good']['map'], res.aggregates()['bad']['map']
    (1.0, 0.5)
    """
    if isinstance(qrel_or_evaluator, RelevanceEvaluator):
        if (measures is not None or relevance_level != 1 or judged_docs_only
                or device is not None):
            raise ValueError(
                "pass measures/relevance_level/judged_docs_only/device only "
                "with a qrel mapping; an evaluator already owns them")
        ev = qrel_or_evaluator
    else:
        ev = RelevanceEvaluator(
            qrel_or_evaluator,
            measures if measures is not None else sorted(M.SUPPORTED_MEASURES),
            relevance_level=relevance_level,
            judged_docs_only=judged_docs_only, device=device)

    if isinstance(runs, Mapping):
        if run_names is not None:
            raise ValueError("run_names conflicts with a {name: run} mapping")
        run_names = list(runs)
        runs = list(runs.values())
    else:
        runs = list(runs)
    if not runs:
        raise ValueError("no runs to sweep")
    if run_names is None:
        run_names = [f"run_{i}" for i in range(len(runs))]
    run_names = [str(n) for n in run_names]
    if len(run_names) != len(runs):
        raise ValueError(f"{len(run_names)} names for {len(runs)} runs")

    if isinstance(runs[0], RunBuffer):
        bufs: List[RunBuffer] = []
        for name, buf in zip(run_names, runs):
            if not isinstance(buf, RunBuffer):
                raise TypeError("cannot mix dict runs and RunBuffers")
            if buf.scores is None:
                raise ValueError(f"run {name!r}: buffer has no scores; "
                                 "use with_scores()")
            if list(buf.qids) != list(runs[0].qids):
                raise ValueError(
                    f"run {name!r} covers different queries than "
                    f"{run_names[0]!r}; sweep rows must share one qid list")
            bufs.append(buf)
        qids = list(runs[0].qids)
    else:
        if any(isinstance(r, RunBuffer) for r in runs):
            raise TypeError("cannot mix dict runs and RunBuffers")
        qids = common_qids(ev._qid_index, runs)
        if not qids:
            raise ValueError("no common judged queries across the runs")
        bufs = [ev.tokenize_run({q: run[q] for q in qids}) for run in runs]

    k, nq = len(bufs), len(qids)
    keys = ev.measure_keys
    table = np.empty((k, nq, len(keys)), dtype=np.float32)

    sev = None
    if _resolve_backend(backend, ev.device) == "sharded":
        from repro_torch.distributed import ShardedEvaluator

        sev = ShardedEvaluator(ev)

    # Whole-run groups bounded by chunk_queries: consecutive sweep points
    # share one padded dispatch, and a run larger than the chunk budget
    # still goes through in one piece (same as evaluate_buffer).
    group = max(1, ev.chunk_queries // max(nq, 1))
    for lo in range(0, k, group):
        chunk = bufs[lo:lo + group]
        big = concat_run_buffers(chunk)
        if sev is not None:
            rows = sev.evaluate_table([big])
        else:
            batch = ev.batch_from_buffer(big)
            per_query = M.compute_measures(batch, ev.measures,
                                           ev.relevance_level,
                                           ev.judged_docs_only)
            rows = torch.stack([per_query[key][:len(big.qids)]
                                for key in keys], dim=-1).cpu().numpy()
        table[lo:lo + len(chunk)] = rows.reshape(len(chunk), nq, len(keys))

    return SweepResult(tuple(run_names), tuple(qids), tuple(keys), table,
                       ev.device)


def _resolve_backend(backend: str, device=None) -> str:
    from repro_torch.distributed.sharded_evaluator import select_backend

    return select_backend(backend, device)
