"""Fused-kernel evaluation on the tokenized (``RunBuffer``) path, one device.

The port of ``repro.distributed.sharded_evaluator`` for a single GPU: the
pipeline per batch is

    RunBuffer ──batch_from_buffer──► EvalBatch            (on the device)
    EvalBatch: sort_batch → make_scalars → fused CUDA kernel (all measures)
    aggregates: metric_update_cols → metric_finalize      (sum / count)

Measures without a fused-kernel column (``num_ret``, ``num_rel``,
``iprec_at_recall_*``, non-standard cutoffs) ride the reference measure
core on the same batch.  The fused kernel divides exactly where the measure
core divides, so count columns are bit-identical to
:meth:`RelevanceEvaluator.evaluate`; sums of float gains may associate
differently and drift by a few ulp.  Splitting the query axis over several
GPUs with ``torch.distributed`` is not ported yet.

Usage::

    from repro_torch.core import RelevanceEvaluator
    from repro_torch.distributed import ShardedEvaluator

    ev = RelevanceEvaluator(qrel, {"map", "ndcg"})   # device="cuda"
    result = ShardedEvaluator(ev).evaluate(run)
    result.per_query["q1"]["map"], result.aggregates["map"]
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import measures as M
from repro_torch.core import streaming
from repro_torch.core.evaluator import RunBuffer, concat_run_buffers
from repro_torch.kernels import ops


class ShardedResult(NamedTuple):
    """Per-query results (pytrec_eval layout) + corpus-mean aggregates."""

    per_query: Dict[str, Dict[str, float]]
    aggregates: Dict[str, float]


def select_backend(backend: str = "auto", device=None) -> str:
    """Resolve an evaluation-backend name to ``"single"`` or ``"sharded"``.

    ``"auto"`` picks the fused pipeline exactly when the evaluation runs on
    CUDA (``device`` is the evaluator's device; ``None`` means CUDA) and
    more than one CUDA device is visible, as the JAX package picks its
    sharded pipeline when its backend has more than one device.  An
    evaluator on the CPU always gets ``"single"``.  The fused pipeline
    still runs on the evaluator's one device.

    >>> select_backend("single")
    'single'
    >>> select_backend("auto", device="cpu")
    'single'
    """
    if backend in ("single", "sharded"):
        return backend
    if backend != "auto":
        raise ValueError(f"unknown backend {backend!r} "
                         "(expected auto|single|sharded)")
    if device is not None and torch.device(device).type != "cuda":
        return "single"
    return "sharded" if torch.cuda.device_count() > 1 else "single"


class ShardedEvaluator:
    """Evaluate a :class:`RelevanceEvaluator`'s batches with the fused kernel.

    The wrapped evaluator supplies the interned qrel state, the measure
    set, the relevance level and the device.
    """

    def __init__(self, evaluator):
        self.evaluator = evaluator
        self.device = evaluator.device
        self.keys: Tuple[str, ...] = tuple(evaluator.measure_keys)
        # Measures the fused kernel does not emit ride the reference core.
        rest = tuple(k for k in self.keys if k not in ops.FUSED_COLUMNS)
        self._rest_parsed = M.parse_measures(rest) if rest else ()

    @classmethod
    def from_files(cls, qrel_path: str, run_path: str, measures=None,
                   relevance_level: int = 1, device=None):
        """Build (ShardedEvaluator, RunBuffer) straight from TREC files."""
        from repro_torch.core import RelevanceEvaluator, supported_measures
        from repro_torch.core import trec

        qrel = trec.load_qrel(qrel_path)
        ev = RelevanceEvaluator(qrel, measures or supported_measures,
                                relevance_level=relevance_level,
                                device=device)
        buf = ev.buffer_from_arrays(*trec.load_run_arrays(run_path))
        return cls(ev), buf

    # -- the fused computation -----------------------------------------------

    def _dispatch(self, batch: M.EvalBatch):
        """One batch: rank, one fused pass for all standard measures,
        reference core for the rest.  Returns ([Q, K] table, aggregates)."""
        level = self.evaluator.relevance_level
        judged_only = self.evaluator.judged_docs_only
        s = M.sort_batch(batch, level, judged_only)
        scal = ops.make_scalars(batch.n_rel, batch.n_judged_nonrel,
                                batch.ideal_rel)
        cols = ops.fused_measures_cols(s.rel, s.judged, scal,
                                       relevance_level=level)
        qm = batch.query_mask
        per_query = {
            name: torch.where(qm, cols[:, i], 0.0)
            for i, name in enumerate(ops.FUSED_COLUMNS) if name in self.keys
        }
        if self._rest_parsed:
            per_query.update(M.compute_measures(
                batch, self._rest_parsed, level, judged_only))
        stacked = torch.stack([per_query[k] for k in self.keys], dim=-1)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        state = {k: zero for k in self.keys}
        state["__count"] = zero
        state = streaming.metric_update_cols(state, per_query, qm)
        return stacked, streaming.metric_finalize(state)

    def _table(self, batch: M.EvalBatch, nq: int):
        stacked, aggs = self._dispatch(batch)
        return stacked[:nq].to("cpu", torch.float32).numpy(), aggs

    # -- entry points ---------------------------------------------------------

    def evaluate(self, run_or_buffer) -> ShardedResult:
        """Evaluate a ``{qid: {docno: score}}`` run or a ``RunBuffer``."""
        if isinstance(run_or_buffer, RunBuffer):
            return self.evaluate_buffer(run_or_buffer)
        return self.evaluate_buffer(
            self.evaluator.tokenize_run(run_or_buffer))

    def evaluate_buffer(self, buf, scores=None) -> ShardedResult:
        """Evaluate a pre-tokenized buffer (optionally with fresh scores)."""
        if not len(buf):
            return ShardedResult({}, {})
        batch = self.evaluator.batch_from_buffer(buf, scores)
        table, aggs = self._table(batch, len(buf.qids))
        keys = list(aggs)
        values = torch.stack([aggs[k] for k in keys]).cpu().tolist()
        return ShardedResult(self._rows_to_dicts(buf.qids, table),
                             M.finalize_aggregates(dict(zip(keys, values))))

    def evaluate_buffers(self, bufs: Sequence) -> List[ShardedResult]:
        """Evaluate several buffers in ONE fused dispatch.

        Buffers are stacked on the query axis; per-query rows split back by
        each buffer's query count, and per-request aggregates are
        recomputed on the host from each request's rows (sum / count).
        """
        bufs = list(bufs)
        if not bufs:
            return []
        nonempty = [b for b in bufs if len(b)]
        if not nonempty:
            return [ShardedResult({}, {}) for _ in bufs]
        big = concat_run_buffers(nonempty)
        table, _ = self._table(self.evaluator.batch_from_buffer(big),
                               len(big.qids))
        results: List[ShardedResult] = []
        lo = 0
        for buf in bufs:
            nq = len(buf.qids)
            rows = table[lo:lo + nq]
            lo += nq
            if not nq:
                results.append(ShardedResult({}, {}))
                continue
            aggs = {k: float(rows[:, j].sum(dtype=np.float32) / np.float32(nq))
                    for j, k in enumerate(self.keys)}
            results.append(ShardedResult(
                self._rows_to_dicts(buf.qids, rows),
                M.finalize_aggregates(aggs)))
        return results

    def evaluate_table(self, bufs: Sequence) -> np.ndarray:
        """Raw ``[sum(len(b)), len(self.keys)]`` float32 rows for several
        buffers in ONE dispatch (no per-query dicts)."""
        bufs = [b for b in bufs if len(b)]
        if not bufs:
            return np.empty((0, len(self.keys)), dtype=np.float32)
        big = concat_run_buffers(bufs)
        return self._table(self.evaluator.batch_from_buffer(big),
                           len(big.qids))[0]

    def _rows_to_dicts(self, qids, table) -> Dict[str, Dict[str, float]]:
        return {
            qid: {k: float(table[i, j]) for j, k in enumerate(self.keys)}
            for i, qid in enumerate(qids)
        }
