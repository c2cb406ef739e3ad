"""The asyncio evaluation service: collections, coalescing, backpressure.

:class:`EvaluationService` turns the library's session API into serving
infrastructure.  The request lifecycle (documented end to end in
``docs/SERVING.md``):

1. **register** — ``register_qrel`` interns a qrel once into a
   :class:`repro_torch.core.RelevanceEvaluator` held in a bounded LRU cache
   (:mod:`repro_torch.serve.cache`); registering more collections than
   ``max_collections`` evicts the least-recently-used one.
2. **prepare** — each ``evaluate`` request is tokenized against the cached
   vocabulary into a :class:`repro_torch.core.RunBuffer` (dict run, flat token
   payload, or a pre-registered run re-scored via ``run_ref`` + fresh
   ``scores`` — the zero-string-work hot path).
3. **coalesce** — concurrent requests for the same collection are
   micro-batched (:mod:`repro_torch.serve.batcher`): everything arriving within
   ``window`` seconds (or until ``max_batch``) becomes ONE backend
   ``evaluate_buffers`` call on an executor thread.
4. **respond** — per-query rows split back per request; every response
   carries the pytrec_eval-style per-query mapping plus trec_eval's summary
   aggregates (geometric-mean measures exponentiated).

Backpressure: at most ``max_pending`` requests may be in flight; beyond
that, ``evaluate`` awaits a semaphore slot, so socket clients see their
submissions delayed rather than the service growing an unbounded queue.

Device: every collection's evaluator runs on the service's ``device``
(``None`` means CUDA, which raises on a host without it; pass ``"cpu"`` to
serve from the CPU).  Nothing moves to the CPU on its own.

Backend selection: per collection, ``"single"`` (the in-process evaluator),
``"sharded"`` (:class:`repro_torch.distributed.ShardedEvaluator`: the fused
measure kernel, the query axis split over every visible card on CUDA),
or ``"auto"`` (sharded exactly when the service runs on CUDA and more
than one card is visible).
Coalescing itself never changes values (either backend returns results
bit-identical to its own per-request calls); between the two backends the
usual fused-kernel caveat applies — count columns exact, float sums
within a few ulp.
"""

from __future__ import annotations

import asyncio
from typing import (Dict, List, Mapping, NamedTuple, Optional, Sequence,
                    Tuple)

import numpy as np

from repro_torch.core import RelevanceEvaluator, aggregate_results
from repro_torch.core.evaluator import RunBuffer
from repro_torch.core.sweep import common_qids
from repro_torch.device import resolve_device
from repro_torch.serve.batcher import MicroBatcher
from repro_torch.serve.cache import LRUCache


class ServeResult(NamedTuple):
    """One request's evaluation: per-query values + summary aggregates."""

    per_query: Dict[str, Dict[str, float]]
    aggregates: Dict[str, float]


class _Collection:
    """One registered qrel: its evaluator, backend, and named run buffers."""

    __slots__ = ("qrel_id", "evaluator", "backend", "runs", "_sharded")

    def __init__(self, qrel_id: str, evaluator: RelevanceEvaluator,
                 backend: str):
        self.qrel_id = qrel_id
        self.evaluator = evaluator
        self.backend = backend
        self.runs: Dict[str, RunBuffer] = {}
        self._sharded = None

    @property
    def sharded(self):
        if self._sharded is None:
            from repro_torch.distributed.sharded_evaluator import ShardedEvaluator

            self._sharded = ShardedEvaluator(self.evaluator)
        return self._sharded

    def release(self) -> None:
        """Drop everything reachable only through this collection.

        Called by the service's cache ``on_evict`` hook — on LRU eviction
        AND on re-registration of the same ``qrel_id``.  Registered run
        buffers and the lazily built sharded evaluator (which pins
        device-resident qrel slabs) are the
        heavyweight references; clearing them here means a displaced
        collection's memory is reclaimable as soon as in-flight requests
        holding it finish, not whenever the GC finds the cycle.
        """
        self.runs.clear()
        self._sharded = None


class EvaluationService:
    """Async evaluation over cached collections with request coalescing.

    Single-event-loop by design (create it inside the loop that serves).
    Collection registration is synchronous (the string work happens in the
    caller); ``evaluate`` is a coroutine resolving to a
    :class:`ServeResult`.

    >>> import asyncio
    >>> from repro_torch.serve import EvaluationService
    >>> async def demo():
    ...     svc = EvaluationService(window=0.005, device='cpu')
    ...     svc.register_qrel('web', {'q1': {'d1': 1, 'd2': 0}}, ('map',))
    ...     a, b = await asyncio.gather(
    ...         svc.evaluate('web', run={'q1': {'d1': 9.0, 'd2': 1.0}}),
    ...         svc.evaluate('web', run={'q1': {'d1': 0.0, 'd2': 1.0}}))
    ...     return (a.per_query['q1']['map'], b.per_query['q1']['map'],
    ...             svc.stats()['backend_calls'])
    >>> asyncio.run(demo())  # two concurrent requests, ONE backend call
    (1.0, 0.5, 1)
    """

    def __init__(self, *, max_collections: int = 8, window: float = 0.002,
                 max_batch: int = 64, max_pending: int = 256,
                 backend: str = "auto", device=None):
        from repro_torch.distributed.sharded_evaluator import select_backend

        self.device = resolve_device(device)
        self._select_backend = select_backend
        self.default_backend = backend
        self._collections = LRUCache(max_collections,
                                     on_evict=self._release_collection)
        self._released = 0  # collections displaced (evicted or replaced)
        self._batcher = MicroBatcher(self._flush, window=window,
                                     max_batch=max_batch)
        self.max_pending = int(max_pending)
        self._sem = asyncio.Semaphore(self.max_pending)
        self._active = 0  # evaluate() coroutines between entry and exit
        self._stats = {"requests": 0, "backend_calls": 0, "in_flight": 0,
                       "peak_in_flight": 0}

    # -- registration ---------------------------------------------------------

    def register_qrel(self, qrel_id: str, qrel, measures=None,
                      relevance_level: float = 1,
                      backend: Optional[str] = None,
                      judged_docs_only: bool = False) -> Dict[str, object]:
        """Intern a qrel into a cached evaluator; returns collection info.

        ``measures`` defaults to every supported family and accepts either
        dialect (``"map"``/``"AP"``, ``"ndcg_cut_10"``/``"nDCG@10"``).
        ``relevance_level`` accepts int or float exactly like the CLI's
        ``-l`` flag — the single conversion to float happens inside
        :class:`RelevanceEvaluator`.  ``backend`` overrides the service
        default for this collection (``auto``/``single``/``sharded``);
        ``judged_docs_only`` mirrors trec_eval's ``-J``.  Re-registering a
        ``qrel_id`` replaces the collection (and drops its registered runs).
        """
        from repro_torch.core import supported_measures

        resolved = self._select_backend(backend or self.default_backend,
                                        self.device)
        ev = RelevanceEvaluator(qrel, measures or supported_measures,
                                relevance_level=relevance_level,
                                judged_docs_only=judged_docs_only,
                                device=self.device)
        self._collections.put(qrel_id, _Collection(qrel_id, ev, resolved))
        return {"qrel_id": qrel_id, "n_queries": len(ev._qrel),
                "vocab_size": int(len(ev.vocab)), "backend": resolved,
                "relevance_level": ev.relevance_level,
                "judged_docs_only": ev.judged_docs_only,
                "measure_keys": list(ev.measure_keys)}

    def register_run(self, qrel_id: str, run_id: str, run=None,
                     tokens=None) -> Dict[str, object]:
        """Tokenize a run once and pin it under ``run_id`` for re-scoring.

        Subsequent ``evaluate(qrel_id, run_ref=run_id, scores=[...])`` calls
        skip ALL string work — the serving analogue of the session API's
        ``RunBuffer`` contract.
        """
        col = self._require(qrel_id)
        buf = self._prepare(col, run=run, tokens=tokens, run_ref=None,
                            scores=None, allow_unscored=True)
        col.runs[run_id] = buf
        return {"qrel_id": qrel_id, "run_id": run_id,
                "n_queries": len(buf), "n_docs": int(buf.qidx.shape[0])}

    def drop_qrel(self, qrel_id: str) -> bool:
        """Explicitly release a collection (True if it was resident)."""
        col = self._collections.pop(qrel_id)
        if col is None:
            return False
        self._release_collection(qrel_id, col)
        return True

    def _release_collection(self, qrel_id: str, col: _Collection) -> None:
        """Cache ``on_evict`` hook: a collection left the resident set.

        Fires for LRU eviction, for replacement via re-registration of the
        same ``qrel_id``, and for explicit ``drop_qrel``.  Without this the
        displaced collection's run buffers and sharded dispatch stayed
        strongly referenced by whatever still pointed at the old object —
        the slow leak this hook exists to close.
        """
        self._released += 1
        col.release()

    # -- evaluation -----------------------------------------------------------

    async def evaluate(self, qrel_id: str, run=None, tokens=None,
                       run_ref: Optional[str] = None,
                       scores=None) -> ServeResult:
        """Evaluate one request; coalesced with concurrent same-qrel calls.

        Exactly one of ``run`` (dict ``{qid: {docno: score}}``), ``tokens``
        (a ``{"qids", "counts", "tokens", "scores"}`` payload for
        ``buffer_from_tokens``), or ``run_ref`` (a ``register_run`` name)
        selects the documents; ``scores`` optionally replaces the scores
        (required with ``run_ref`` unless the registered run carried its
        own).
        """
        col = self._require(qrel_id)
        self._stats["requests"] += 1  # counted at arrival, before any await
        self._active += 1
        try:
            return await self._evaluate(col, qrel_id, run, tokens, run_ref,
                                        scores)
        finally:
            self._active -= 1

    async def _evaluate(self, col: "_Collection", qrel_id: str, run, tokens,
                        run_ref, scores) -> ServeResult:
        if run is not None:
            # Dict-run tokenization (~100ms at Q=1000×D=1000) runs on an
            # executor thread so it never stalls the event loop — other
            # connections keep reading and coalescing window timers keep
            # firing.  Safe: the evaluator is immutable after construction.
            # The tokens/run_ref payloads stay on-loop: their preparation
            # is a bounds check plus at most one float32 copy.
            buf = await asyncio.to_thread(
                self._prepare, col, run=run, tokens=tokens, run_ref=run_ref,
                scores=scores, allow_unscored=False)
        else:
            buf = self._prepare(col, run=run, tokens=tokens, run_ref=run_ref,
                                scores=scores, allow_unscored=False)
        async with self._sem:
            n = self._stats["in_flight"] = self._stats["in_flight"] + 1
            self._stats["peak_in_flight"] = max(
                self._stats["peak_in_flight"], n)
            try:
                return await self._batcher.submit(qrel_id, (col, buf))
            finally:
                self._stats["in_flight"] -= 1

    # -- statistical comparison -----------------------------------------------

    async def compare(self, qrel_id: str, runs=None,
                      run_refs: Optional[Sequence[str]] = None, *,
                      measure: str = "map", tests: Sequence[str] = ("t",),
                      n_permutations: int = 2000, seed: int = 0,
                      alpha: float = 0.05,
                      run_names: Optional[Sequence[str]] = None
                      ) -> Dict[str, object]:
        """Paired significance tests across K >= 2 runs on one collection.

        Exactly one of ``runs`` (a ``{name: run}`` mapping or a sequence of
        dict runs, aligned to their common judged query set) or ``run_refs``
        (names from :meth:`register_run` — the buffers must cover one shared
        qid list and carry scores) selects the systems.  The K per-run
        evaluations go through the SAME micro-batcher as ``evaluate``
        requests, so one ``compare`` typically costs one coalesced backend
        call; the K×K statistics (:mod:`repro_torch.stats`) then run on an
        executor thread.

        Returns a JSON-friendly bundle: ``run_names``, ``measure``,
        ``qids``, per-run ``means``, the ``t`` / ``p`` / ``p_holm`` /
        ``p_bonferroni`` matrices (plus ``p_permutation*`` when
        ``"permutation"`` is in ``tests``), and ``significant`` —
        ``p_holm < alpha`` off the diagonal.
        """
        col = self._require(qrel_id)
        self._stats["requests"] += 1
        self._active += 1
        try:
            return await self._compare(col, qrel_id, runs, run_refs, measure,
                                       tests, n_permutations, seed, alpha,
                                       run_names)
        finally:
            self._active -= 1

    async def _compare(self, col: "_Collection", qrel_id: str, runs,
                       run_refs, measure, tests, n_permutations, seed,
                       alpha, run_names) -> Dict[str, object]:
        from repro_torch.core import registry

        ev = col.evaluator
        measure = str(measure)
        if measure not in ev.measure_keys:
            # either dialect; a malformed string raises MeasureError (a
            # ValueError → wire code "invalid") naming the offending input
            measure = registry.canonical_key(measure)[0]
        if measure not in ev.measure_keys:
            raise ValueError(
                f"measure {registry.both_dialects(measure)} is not computed "
                f"by collection {qrel_id!r} "
                f"(have: {list(ev.measure_keys)})")
        given = [n for n, v in (("runs", runs), ("run_refs", run_refs))
                 if v is not None]
        if len(given) != 1:
            raise ValueError(
                f"need exactly one of runs/run_refs, got {given or 'none'}")
        if runs is not None:
            if isinstance(runs, Mapping):
                if run_names is not None:
                    raise ValueError(
                        "run_names conflicts with a {name: run} mapping")
                run_names = list(runs)
                runs = list(runs.values())
            else:
                runs = list(runs)
            if len(runs) < 2:
                raise ValueError(f"compare needs >= 2 runs, got {len(runs)}")
            if run_names is None:
                run_names = [f"run_{i}" for i in range(len(runs))]
            # dict-run tokenization off-loop, like evaluate's dict path
            bufs = await asyncio.to_thread(self._aligned_buffers, ev, runs)
        else:
            refs = [str(r) for r in run_refs]
            if len(refs) < 2:
                raise ValueError(
                    f"compare needs >= 2 run_refs, got {len(refs)}")
            missing = [r for r in refs if r not in col.runs]
            if missing:
                raise KeyError(
                    f"unknown run_ref {missing[0]!r} for qrel "
                    f"{col.qrel_id!r} (registered: {sorted(col.runs)})")
            bufs = [col.runs[r] for r in refs]
            base = list(bufs[0].qids)
            for r, buf in zip(refs, bufs):
                if buf.scores is None:
                    raise ValueError(
                        f"registered run {r!r} has no scores; re-register "
                        "with scores or pass dict runs")
                if list(buf.qids) != base:
                    raise ValueError(
                        f"run_ref {r!r} covers different queries than "
                        f"{refs[0]!r}; compared runs must share one qid "
                        "list")
            if run_names is None:
                run_names = refs
        run_names = [str(n) for n in run_names]
        if len(run_names) != len(bufs):
            raise ValueError(
                f"{len(run_names)} run_names for {len(bufs)} runs")
        qids = list(bufs[0].qids)
        if len(qids) < 2:
            raise ValueError(
                f"paired tests need >= 2 common judged queries, got "
                f"{len(qids)}")

        # ONE backpressure slot for the whole request: the K coalesced
        # submissions resolve together, and taking K slots could deadlock
        # compare requests against max_pending.
        async with self._sem:
            n = self._stats["in_flight"] = self._stats["in_flight"] + 1
            self._stats["peak_in_flight"] = max(
                self._stats["peak_in_flight"], n)
            try:
                results = await asyncio.gather(
                    *(self._batcher.submit(qrel_id, (col, buf))
                      for buf in bufs))
            finally:
                self._stats["in_flight"] -= 1

        x = np.array([[res.per_query[q][measure] for q in qids]
                      for res in results], dtype=np.float32)
        report = await asyncio.to_thread(self._significance, x, tuple(tests),
                                         int(n_permutations), int(seed),
                                         self.device)
        out: Dict[str, object] = {
            "run_names": run_names, "measure": measure, "qids": qids,
            "n_queries": len(qids), "alpha": float(alpha),
        }
        out.update({k: np.asarray(v, dtype=float).tolist()
                    for k, v in report.items()})
        k = len(run_names)
        holm = np.asarray(report["p_holm"])
        sig = (holm < float(alpha)) & ~np.eye(k, dtype=bool)
        out["significant"] = sig.tolist()
        return out

    @staticmethod
    def _aligned_buffers(ev: RelevanceEvaluator, runs) -> List[RunBuffer]:
        """Tokenize dict runs on their common judged query set."""
        qids = common_qids(ev._qid_index, runs)
        if not qids:
            raise ValueError("no common judged queries across the runs")
        return [ev.tokenize_run({q: r[q] for q in qids}) for r in runs]

    @staticmethod
    def _significance(x: np.ndarray, tests: Tuple[str, ...],
                      n_permutations: int, seed: int,
                      device) -> Dict[str, object]:
        from repro_torch import stats

        return stats.significance_report(x, tests=tests,
                                         n_permutations=n_permutations,
                                         seed=seed, device=device)

    async def _flush(self, qrel_id: str,
                     items: List[Tuple[_Collection, RunBuffer]]):
        """One coalesced backend call per collection generation."""
        out: List[Optional[ServeResult]] = [None] * len(items)
        groups: Dict[int, List[int]] = {}
        for i, (col, _) in enumerate(items):
            groups.setdefault(id(col), []).append(i)
        for idxs in groups.values():
            col = items[idxs[0]][0]
            bufs = [items[i][1] for i in idxs]
            self._stats["backend_calls"] += 1
            if col.backend == "sharded":
                results = await asyncio.to_thread(
                    col.sharded.evaluate_buffers, bufs)
                packed = [ServeResult(r.per_query, r.aggregates)
                          for r in results]
            else:
                tables = await asyncio.to_thread(
                    col.evaluator.evaluate_buffers, bufs)
                packed = [ServeResult(pq, aggregate_results(pq))
                          for pq in tables]
            for i, res in zip(idxs, packed):
                out[i] = res
        return out

    async def drain(self) -> None:
        """Resolve once every accepted request has been answered.

        "Accepted" spans the whole ``evaluate`` lifecycle — tokenization on
        an executor thread, waiting for a backpressure slot, sitting in a
        coalescing window, and the backend flush itself.  Front-ends call
        this on shutdown so in-flight batches complete before the process
        exits; it does NOT block new submissions, so stop accepting first.
        """
        while self._active or not self._batcher.idle():
            await asyncio.sleep(0.002)

    # -- plumbing -------------------------------------------------------------

    def _require(self, qrel_id: str) -> _Collection:
        col = self._collections.get(qrel_id)
        if col is None:
            raise KeyError(
                f"unknown qrel_id {qrel_id!r}: register_qrel first "
                f"(resident: {sorted(self._collections.keys())})")
        return col

    def _prepare(self, col: _Collection, *, run, tokens, run_ref, scores,
                 allow_unscored: bool) -> RunBuffer:
        given = [name for name, v in
                 (("run", run), ("tokens", tokens), ("run_ref", run_ref))
                 if v is not None]
        if len(given) != 1:
            raise ValueError(
                f"need exactly one of run/tokens/run_ref, got {given or 'none'}")
        ev = col.evaluator
        if run is not None:
            buf = ev.tokenize_run(run)
        elif tokens is not None:
            if not isinstance(tokens, dict):
                raise ValueError("tokens must be a mapping with "
                                 "qids/counts/tokens[/scores]")
            buf = ev.buffer_from_tokens(
                tokens["qids"], tokens["counts"], tokens["tokens"],
                scores=tokens.get("scores"))
        else:
            if run_ref not in col.runs:
                raise KeyError(
                    f"unknown run_ref {run_ref!r} for qrel "
                    f"{col.qrel_id!r} (registered: {sorted(col.runs)})")
            buf = col.runs[run_ref]
        if scores is not None:
            buf = buf.with_scores(scores)
        if buf.scores is None and not allow_unscored:
            raise ValueError("request has no scores: the run/tokens payload "
                             "carried none and no scores= were given")
        return buf

    def stats(self) -> Dict[str, object]:
        """Counters for monitoring and the protocol's ``stats`` op."""
        out = dict(self._stats)
        out["flushes"] = self._batcher.flushes
        out["coalesced"] = self._batcher.submitted - self._batcher.flushes
        out["window"] = self._batcher.window
        out["max_batch"] = self._batcher.max_batch
        out["max_pending"] = self.max_pending
        out["cache"] = self._collections.stats()
        out["released_collections"] = self._released
        out["collections"] = sorted(self._collections.keys())
        return out
