"""A closed loop of ``RelevanceEvaluator.evaluate_buffer(buf, scores=...)``.

The run is tokenized once in set-up (``buffer_from_arrays``); each call
rescores it with the next set of the score pool and returns pytrec_eval's
per-query dicts.
"""

from __future__ import annotations

import time

import numpy as np

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
        self.rankings_per_call = len(self.buf)
        self._bytes = yardstick.core_bytes(
            pairs=len(col.run_qid), judgments=len(col.qrel_qid),
            queries=self.rankings_per_call,
            outputs=self.rankings_per_call * len(self.ev.measure_keys))

    def score_sets(self, i):
        return [i % len(self.pool)]

    def call(self, i):
        return self.ev.evaluate_buffer(self.buf,
                                       scores=self.pool[i % len(self.pool)])

    def values(self, out):
        qids = list(out)
        keys = list(next(iter(out.values()))) if out else []
        table = np.array([[out[q][k] for k in keys] for q in qids],
                         dtype=np.float64).reshape(1, len(qids), len(keys))
        return "per_query", qids, keys, table

    def core_bytes(self):
        return self._bytes

    def instrument(self, spans):
        from repro_torch.core import measures

        spans.wrap(self.ev, "batch_from_buffer", "densify")
        spans.wrap(measures, "compute_measures", "measure")
        spans.wrap(measures, "compute_measures_topk", "measure")

    def release(self):
        self.ev = self.buf = None
