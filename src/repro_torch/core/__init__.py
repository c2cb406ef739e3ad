"""Batched IR evaluation in PyTorch (the port of ``repro.core``).

Public API mirrors pytrec_eval:

* :class:`RelevanceEvaluator` — dict-in / dict-out evaluation.
* :data:`supported_measures` — measure families available.
* ``registry`` — the declarative measure table (both dialects).
* ``measures`` / ``streaming`` — batched device entry points.
* :func:`evaluate_sweep` — K runs against one qrel in one batched sweep.
"""

from repro_torch.core.evaluator import (RelevanceEvaluator, RunBuffer,
                                        aggregate_results, concat_run_buffers)
from repro_torch.core.measures import (
    AGGREGATE_ONLY_MEASURES,
    DEFAULT_CUTOFFS,
    GM_MIN,
    SUPPORTED_MEASURES as supported_measures,
    EvalBatch,
    batch_from_dense,
    batch_from_flat,
    batch_from_numpy,
    compute_measures,
    compute_measures_topk,
    finalize_aggregates,
    measure_keys,
    parse_measures,
)
from repro_torch.core.registry import MeasureError, MeasureSpec, REGISTRY
from repro_torch.core.sweep import SweepResult, evaluate_sweep
from repro_torch.core import registry, streaming, trec, sorting

__all__ = [
    "RelevanceEvaluator",
    "RunBuffer",
    "SweepResult",
    "aggregate_results",
    "concat_run_buffers",
    "evaluate_sweep",
    "batch_from_flat",
    "batch_from_numpy",
    "supported_measures",
    "AGGREGATE_ONLY_MEASURES",
    "DEFAULT_CUTOFFS",
    "GM_MIN",
    "EvalBatch",
    "batch_from_dense",
    "compute_measures",
    "compute_measures_topk",
    "finalize_aggregates",
    "measure_keys",
    "parse_measures",
    "MeasureError",
    "MeasureSpec",
    "REGISTRY",
    "registry",
    "streaming",
    "trec",
    "sorting",
]
