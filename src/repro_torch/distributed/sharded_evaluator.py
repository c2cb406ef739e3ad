"""Fused-kernel evaluation on the tokenized (``RunBuffer``) path, sharded
over the query axis of a 1-D device mesh.

The port of ``repro.distributed.sharded_evaluator``.  A mesh is a
sequence of ``torch.device``; repeats are allowed (``["cpu"] * 4``,
``["cuda:0"] * 2``), and the default spans every visible card
(:func:`default_mesh`).  The pipeline per batch is

    RunBuffer ──batch_from_buffer(q_multiple=n)──► EvalBatch  (one densify)
    EvalBatch ──n contiguous blocks of the query axis──► one per mesh entry
    block, on its device: sort_batch → make_scalars → fused kernel (B1)
    aggregates: metric_update_cols per block → summed in mesh order
                → metric_finalize                        (sum / count)

The batch is densified once, on the evaluator's device (the host
scatters, one copy moves it there).  A block whose mesh entry is that
device is a view of it; a block for another card is a peer copy from it.
Every block is launched before any result is fetched, and each kernel
launches under its block's device, on that device's current stream.  The
per-query rows are gathered on the mesh's first device in mesh order
(peer copies from the other cards), and the aggregates are each block's
(sum, count), copied there and added in mesh order: the in-process form of
the JAX package's psum (``collectives`` has the process-group form).

Measures without a fused-kernel column (``num_ret``, ``num_rel``,
``iprec_at_recall_*``, non-standard cutoffs) ride the reference measure
core on the same block.  Every measure is computed row by row, so the
per-query rows are bit-identical for every mesh size; against
:meth:`RelevanceEvaluator.evaluate` the count columns are bit-identical and
sums of float gains may associate differently and drift by a few ulp.

Usage::

    from repro_torch.core import RelevanceEvaluator
    from repro_torch.distributed import ShardedEvaluator

    ev = RelevanceEvaluator(qrel, {"map", "ndcg"})   # device="cuda"
    result = ShardedEvaluator(ev).evaluate(run)      # every visible card
    result.per_query["q1"]["map"], result.aggregates["map"]
"""

from __future__ import annotations

import functools
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


@functools.lru_cache(maxsize=None)
def default_mesh() -> Tuple[torch.device, ...]:
    """The 1-D mesh of every visible card, ``(cuda:0, ..., cuda:n-1)``.

    Memoized like the JAX package's, so every :class:`ShardedEvaluator`
    built without a mesh shares one tuple.  Raises without CUDA.
    """
    if not torch.cuda.is_available():
        raise RuntimeError(
            "default_mesh() spans the visible CUDA devices, and "
            "torch.cuda.is_available() is False; pass mesh=['cpu']")
    return tuple(torch.device("cuda", i)
                 for i in range(torch.cuda.device_count()))


def mesh_device(entry) -> torch.device:
    """One mesh entry as a device with an index: ``"cuda"`` is the current
    card.  A card that is not visible raises; nothing falls back.

    >>> mesh_device("cpu")
    device(type='cpu')
    """
    dev = torch.device(entry)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"unsupported mesh device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh entry {entry!r} names a CUDA device and "
                           "torch.cuda.is_available() is False")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise ValueError(f"mesh entry {entry!r} names an absent card "
                         f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", index)


def select_backend(backend: str = "auto", device=None) -> str:
    """Resolve an evaluation-backend name to ``"single"`` or ``"sharded"``.

    ``"auto"`` picks the sharded pipeline exactly when the evaluation runs
    on CUDA (``device`` is the evaluator's device; ``None`` means CUDA) and
    more than one card is visible: it then splits the query axis over
    :func:`default_mesh`, as the JAX package splits it over its devices.
    On one card the single-device evaluator computes the same values
    without the split.  An evaluator on the CPU always gets ``"single"``.

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
    """Shard a :class:`RelevanceEvaluator`'s batches over a device mesh.

    ``mesh`` is a sequence of devices, one per shard of the query axis;
    ``None`` means :func:`default_mesh` for an evaluator on CUDA and the
    evaluator's own device on the CPU.  The wrapped evaluator supplies the
    interned qrel state, the measure set and the relevance level.
    """

    def __init__(self, evaluator, mesh=None):
        self.evaluator = evaluator
        if mesh is None:
            mesh = (default_mesh() if evaluator.device.type == "cuda"
                    else (evaluator.device,))
        if isinstance(mesh, (str, torch.device)):
            raise TypeError("mesh is a sequence of devices, one per shard")
        self.mesh: Tuple[torch.device, ...] = tuple(
            mesh_device(d) for d in mesh)
        if not self.mesh:
            raise ValueError("empty mesh")
        self.n_shards = len(self.mesh)
        self.keys: Tuple[str, ...] = tuple(evaluator.measure_keys)
        # Measures the fused kernel does not emit ride the reference core.
        rest = tuple(k for k in self.keys if k not in ops.FUSED_COLUMNS)
        self._rest_parsed = M.parse_measures(rest) if rest else ()

    @classmethod
    def from_files(cls, qrel_path: str, run_path: str, measures=None,
                   relevance_level: int = 1, mesh=None, device=None):
        """Build (ShardedEvaluator, RunBuffer) straight from TREC files."""
        from repro_torch.core import RelevanceEvaluator, supported_measures
        from repro_torch.core import trec

        qrel = trec.load_qrel(qrel_path)
        ev = RelevanceEvaluator(qrel, measures or supported_measures,
                                relevance_level=relevance_level,
                                device=device)
        buf = ev.buffer_from_arrays(*trec.load_run_arrays(run_path))
        return cls(ev, mesh=mesh), buf

    # -- the sharded computation ---------------------------------------------

    def _local(self, batch: M.EvalBatch):
        """One shard on its device: rank, one fused pass for all standard
        measures, reference core for the rest.  Returns the ``[q, K]``
        table and the ``(sum, count)`` state."""
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
        zero = torch.zeros((), dtype=torch.float32, device=qm.device)
        state = {k: zero for k in self.keys}
        state["__count"] = zero
        return stacked, streaming.metric_update_cols(state, per_query, qm)

    def _dispatch(self, batch: M.EvalBatch):
        """A padded batch (query axis a multiple of the mesh size) → the
        ``[Q, K]`` table on the mesh's first device and the aggregates."""
        q = batch.query_mask.shape[0]
        if q % self.n_shards:
            raise ValueError(f"{q} queries do not split into "
                             f"{self.n_shards} equal shards")
        rows = q // self.n_shards
        outs = []
        for i, dev in enumerate(self.mesh):  # launch every shard first
            block = M.EvalBatch(*(f[i * rows:(i + 1) * rows].to(dev)
                                  for f in batch))
            outs.append(self._local(block))
        first = self.mesh[0]
        tables = [t.to(first) for t, _ in outs]
        stacked = tables[0] if len(tables) == 1 else torch.cat(tables)
        state = streaming.metric_merge([s for _, s in outs], first)
        return stacked, streaming.metric_finalize(state)

    def _batch(self, buf: RunBuffer, scores=None) -> M.EvalBatch:
        return self.evaluator.batch_from_buffer(
            buf, scores, q_multiple=self.n_shards)

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
        table, aggs = self._table(self._batch(buf, scores), len(buf.qids))
        keys = list(aggs)
        values = torch.stack([aggs[k] for k in keys]).cpu().tolist()
        return ShardedResult(self._rows_to_dicts(buf.qids, table),
                             M.finalize_aggregates(dict(zip(keys, values))))

    def evaluate_buffers(self, bufs: Sequence) -> List[ShardedResult]:
        """Evaluate several buffers in ONE sharded dispatch.

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
        table, _ = self._table(self._batch(big), len(big.qids))
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
        buffers in ONE sharded dispatch (no per-query dicts)."""
        bufs = [b for b in bufs if len(b)]
        if not bufs:
            return np.empty((0, len(self.keys)), dtype=np.float32)
        big = concat_run_buffers(bufs)
        return self._table(self._batch(big), len(big.qids))[0]

    def _rows_to_dicts(self, qids, table) -> Dict[str, Dict[str, float]]:
        return {
            qid: {k: float(table[i, j]) for j, k in enumerate(self.keys)}
            for i, qid in enumerate(qids)
        }
