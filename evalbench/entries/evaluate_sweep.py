"""A closed loop of ``core.sweep.evaluate_sweep(ev, buffers)``.

The run is tokenized once in set-up; each call is a new sweep over
``runs_per_call`` score sets of the pool (call i takes sets i, i+1, ...,
wrapping around), on the backend the traffic names.
"""

from __future__ import annotations

import time

from evalbench import yardstick
from evalbench.entries import buffer_order


class Session:
    def __init__(self, ctx):
        self.device = ctx.device
        from repro_torch.core import RelevanceEvaluator

        t0 = time.perf_counter()
        self.ev = RelevanceEvaluator(
            ctx.qrel, ctx.traffic["measures"],
            relevance_level=ctx.cfg["relevance_level"], device=ctx.device)
        col = ctx.col
        self.buf = self.ev.buffer_from_arrays(col.run_qid, col.run_doc,
                                              ctx.pool[0])
        self.ingest_s = time.perf_counter() - t0
        self.pool = buffer_order(self.buf, col.run_qid, ctx.pool)
        self.k = int(ctx.traffic["runs_per_call"])
        if self.k > len(self.pool):
            raise ValueError("the score pool is smaller than a sweep")
        self.backend = ctx.traffic["backend"]
        nq = len(self.buf)
        self.rankings_per_call = self.k * nq
        self._bytes = self.k * yardstick.core_bytes(
            pairs=len(col.run_qid), judgments=len(col.qrel_qid), queries=nq,
            outputs=nq * len(self.ev.measure_keys))

    def score_sets(self, i):
        return [(i + j) % len(self.pool) for j in range(self.k)]

    def call(self, i):
        from repro_torch.core.sweep import evaluate_sweep

        bufs = [self.buf.with_scores(self.pool[s])
                for s in self.score_sets(i)]
        return evaluate_sweep(self.ev, bufs, backend=self.backend)

    def values(self, out):
        return ("per_query", list(out.qids), list(out.measure_keys),
                out.table.astype("float64"))

    def core_bytes(self):
        return self._bytes

    def instrument(self, spans):
        from repro_torch.core import measures, sweep

        spans.wrap(sweep, "concat_run_buffers", "concat")
        spans.wrap(self.ev, "batch_from_buffer", "densify")
        spans.wrap(measures, "compute_measures", "measure")

    def release(self):
        self.ev = self.buf = None
