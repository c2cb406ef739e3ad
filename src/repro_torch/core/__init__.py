"""Batched IR evaluation in PyTorch (the port of ``repro.core``).

Public API mirrors pytrec_eval:

* :class:`RelevanceEvaluator` — dict-in / dict-out evaluation.
* :data:`supported_measures` — measure families available.
* ``registry`` — the declarative measure table (both dialects).
* ``measures`` / ``streaming`` — batched device entry points.
* :func:`evaluate_sweep` — K runs against one qrel in one batched sweep.

The names below resolve on first use (PEP 562), so importing one light
submodule — ``repro_torch.core.trec`` for the trec_eval baseline's child
process — does not import torch.
"""

import importlib

#: exported name -> (submodule, attribute in it)
_EXPORTS = {
    "RelevanceEvaluator": ("evaluator", "RelevanceEvaluator"),
    "RunBuffer": ("evaluator", "RunBuffer"),
    "aggregate_results": ("evaluator", "aggregate_results"),
    "concat_run_buffers": ("evaluator", "concat_run_buffers"),
    "AGGREGATE_ONLY_MEASURES": ("measures", "AGGREGATE_ONLY_MEASURES"),
    "DEFAULT_CUTOFFS": ("measures", "DEFAULT_CUTOFFS"),
    "GM_MIN": ("measures", "GM_MIN"),
    "supported_measures": ("measures", "SUPPORTED_MEASURES"),
    "EvalBatch": ("measures", "EvalBatch"),
    "batch_from_dense": ("measures", "batch_from_dense"),
    "batch_from_flat": ("measures", "batch_from_flat"),
    "batch_from_numpy": ("measures", "batch_from_numpy"),
    "compute_measures": ("measures", "compute_measures"),
    "compute_measures_topk": ("measures", "compute_measures_topk"),
    "finalize_aggregates": ("measures", "finalize_aggregates"),
    "measure_keys": ("measures", "measure_keys"),
    "parse_measures": ("measures", "parse_measures"),
    "MeasureError": ("registry", "MeasureError"),
    "MeasureSpec": ("registry", "MeasureSpec"),
    "REGISTRY": ("registry", "REGISTRY"),
    "SweepResult": ("sweep", "SweepResult"),
    "evaluate_sweep": ("sweep", "evaluate_sweep"),
}
_SUBMODULES = ("registry", "streaming", "trec", "sorting")

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


def __getattr__(name):
    if name in _EXPORTS:
        module, attr = _EXPORTS[name]
        value = getattr(importlib.import_module(f"{__name__}.{module}"), attr)
    elif name in _SUBMODULES:
        value = importlib.import_module(f"{__name__}.{name}")
    else:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    globals()[name] = value
    return value
