"""A closed loop of the evaluation step of ``get_arch("pytrec-eval")``.

Set-up builds the padded batch once with the program's own
``batch_from_buffer`` and one score tensor on the card for every set of
the pool (the program's layout). Each call swaps the next score tensor
into the batch, runs ``make_step(cfg, shape).step_fn(batch)`` and reads
the corpus means back, as a training loop that validates on the card
would.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from evalbench import yardstick
from evalbench.entries import buffer_order


class Session:
    def __init__(self, ctx):
        self.device = ctx.device
        import torch

        from repro_torch.configs import pytrec_paper
        from repro_torch.core import RelevanceEvaluator
        from repro_torch.launch.api import ShapeSpec, get_arch

        if list(ctx.traffic["measures"]) != list(pytrec_paper.MEASURES):
            raise ValueError("the step evaluates pytrec_paper.MEASURES; the "
                             "traffic must name the same measures")
        t0 = time.perf_counter()
        ev = RelevanceEvaluator(
            ctx.qrel, ctx.traffic["measures"],
            relevance_level=ctx.cfg["relevance_level"], device=ctx.device)
        col = ctx.col
        buf = ev.buffer_from_arrays(col.run_qid, col.run_doc, ctx.pool[0])
        self.ingest_s = time.perf_counter() - t0
        pool = buffer_order(buf, col.run_qid, ctx.pool)
        self.batch = ev.batch_from_buffer(buf, scores=pool[0])
        self.scores = [self.batch.scores] + [
            ev.batch_from_buffer(buf, scores=s).scores for s in pool[1:]]
        q, d = self.batch.scores.shape
        j = self.batch.ideal_rel.shape[1]
        shape = ShapeSpec("evalbench", "serve", (("n_queries", q),
                                                 ("n_docs", d),
                                                 ("n_judged", j)))
        arch = get_arch("pytrec-eval")
        cfg = dataclasses.replace(arch.make_config(False),
                                  engine=ctx.traffic["engine"],
                                  relevance_level=float(
                                      ctx.cfg["relevance_level"]))
        self.step = arch.make_step(cfg, shape, ctx.device).step_fn
        self.keys = list(ev.measure_keys)
        self.rankings_per_call = len(buf)
        self._bytes = yardstick.core_bytes(
            pairs=len(col.run_qid), judgments=len(col.qrel_qid),
            queries=len(buf), outputs=len(self.keys))
        self._torch = torch

    def score_sets(self, i):
        return [i % len(self.scores)]

    def call(self, i):
        out = self.step(self.batch._replace(
            scores=self.scores[i % len(self.scores)]))
        return self._torch.stack([out[k] for k in self.keys]).cpu().numpy()

    def values(self, out):
        return "mean", None, self.keys, np.asarray(out,
                                                   np.float64)[None, :]

    def core_bytes(self):
        return self._bytes

    def instrument(self, spans):
        spans.wrap(self, "step", "measure")

    def release(self):
        self.batch = self.scores = self.step = None
