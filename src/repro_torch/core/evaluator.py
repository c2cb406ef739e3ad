"""pytrec_eval-compatible evaluator front-end (PyTorch port).

:class:`RelevanceEvaluator` reproduces the pytrec_eval API:

    >>> qrel = {'q1': {'d1': 0, 'd2': 1}, 'q2': {'d1': 1}}
    >>> evaluator = RelevanceEvaluator(qrel, {'map', 'ndcg'}, device='cpu')
    >>> run = {'q1': {'d1': 1.0, 'd2': 0.0}, 'q2': {'d1': 1.5, 'd2': 0.2}}
    >>> results = evaluator.evaluate(run)
    >>> sorted(results['q1'])
    ['map', 'ndcg']

Internally the dict-of-dicts run is densified on the host (numpy) into a
padded ``EvalBatch``, which moves to the evaluator's ``device`` (CUDA by
default) in one copy per batch; the batched measure core
(``core.measures``) runs there, and every batch's results come back in one
copy as float32.  Padding is bucketed to powers of two, as in the JAX
package, so both engines see identically shaped batches.

Densification is the analogue of pytrec_eval's "conversion to trec_eval's
internal format", and — like the paper's — it dominates for tiny rankings
(RQ2 crossover).  It is therefore built as a *flat* pipeline with all string
work hoisted to construction time:

* at construction, every qrel docno is interned into one sorted global
  vocabulary (``np.unique``), and the qrel side is laid out as contiguous
  slabs: a sorted ``(query, token)`` key array with judgment values for the
  run→qrel join, per-query ideal-gain rows, and R / judged-non-relevant
  count vectors;
* at ``evaluate`` time the whole run chunk is flattened into single
  ``(qid_idx, docno, score)`` arrays; ONE lexicographic argsort produces the
  trec_eval tie-break ranks, ONE ``searchsorted`` against the interned
  vocabulary plus ONE ``searchsorted`` against the key slab performs the
  run→qrel join, and the results are scattered into the padded ``[Q, D]``
  tensors with fancy indexing.  No Python loop touches individual documents;
  per-query work is limited to O(Q) dict lookups on the mapping input.

The seed per-query densifier is retained as the ``reference`` path
(``RelevanceEvaluator(..., densify="reference")``) for bit-identity tests.

Session API (persistent, string-free re-evaluation):

* :meth:`RelevanceEvaluator.evaluate_many` evaluates a sequence (or mapping)
  of runs against the cached qrel state;
* :meth:`RelevanceEvaluator.tokenize_run` /
  :meth:`RelevanceEvaluator.buffer_from_arrays` /
  :meth:`RelevanceEvaluator.buffer_from_tokens` build a :class:`RunBuffer` —
  a pre-tokenized run whose docnos have been resolved against the interned
  vocabulary once.  :meth:`RelevanceEvaluator.evaluate_buffer` (optionally
  with fresh scores) then skips all string work, and
  :meth:`RelevanceEvaluator.batch_from_buffer` yields an ``EvalBatch``;
* :meth:`RelevanceEvaluator.evaluate_buffers` evaluates SEVERAL buffers
  with one coalesced measure-core call (:func:`concat_run_buffers` stacks
  them on the query axis).
"""

from __future__ import annotations

import threading
from itertools import chain, repeat
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from repro_torch.core import measures as M
from repro_torch.core import registry
from repro_torch.device import resolve_device
from repro_torch.kernels import bucketing

RunType = Mapping[str, Mapping[str, float]]
QrelType = Mapping[str, Mapping[str, int]]

# Padding classes come from the shared bucketing module, the same classes
# the JAX package uses (see kernels/bucketing.py).
_bucket = bucketing.bucket_docs


class RunBuffer:
    """A run pre-tokenized against an evaluator's interned docno vocabulary.

    Holds the flat, string-free representation of one run chunk: query
    indices, padded-column positions, qrel join results (judgment values and
    judged flags), trec_eval tie-break ranks, and (optionally) scores.  The
    expensive docno work — string materialization, the lexicographic
    tie-break sort, and the vocabulary join — happened exactly once at
    construction; re-evaluating the same collection with new scores is pure
    numeric scatter + the measure core.

    Construct via :meth:`RelevanceEvaluator.tokenize_run`,
    :meth:`RelevanceEvaluator.buffer_from_arrays`, or
    :meth:`RelevanceEvaluator.buffer_from_tokens`.
    """

    __slots__ = ("qids", "gidx", "qidx", "col", "counts", "rel", "judged",
                 "tiebreak", "scores")

    def __init__(self, qids, gidx, qidx, col, counts, rel, judged, tiebreak,
                 scores):
        self.qids: List[str] = qids  # chunk qids, evaluation order
        self.gidx = gidx  # [nq] i64 — evaluator-global query indices
        self.qidx = qidx  # [n] i64 — flat doc → chunk-local query index
        self.col = col  # [n] i64 — flat doc → column in the padded tensor
        self.counts = counts  # [nq] i64 — retrieved docs per query
        self.rel = rel  # [n] f32 — joined judgment (0 for unjudged)
        self.judged = judged  # [n] bool — doc appears in the qrels
        self.tiebreak = tiebreak  # [n] i32 — docno desc-lex rank in query
        self.scores = scores  # [n] f32 or None — default scores

    def __len__(self) -> int:
        return len(self.qids)

    def with_scores(self, scores) -> "RunBuffer":
        """Same collection, new flat scores (concatenated in query order)."""
        scores = np.ascontiguousarray(scores, dtype=np.float32).reshape(-1)
        if scores.shape[0] != self.qidx.shape[0]:
            raise ValueError(
                f"expected {self.qidx.shape[0]} scores, got {scores.shape[0]}")
        return RunBuffer(self.qids, self.gidx, self.qidx, self.col,
                         self.counts, self.rel, self.judged, self.tiebreak,
                         scores)


def concat_run_buffers(bufs: Sequence[RunBuffer]) -> RunBuffer:
    """Stack several :class:`RunBuffer`\\ s (same evaluator) into one.

    The micro-batching primitive of the serve layer: N pending requests for
    the same collection become ONE buffer whose query axis is the requests
    laid end to end, so a single ``batch_from_buffer`` + measure-core call
    evaluates them all.  Queries are kept per-request (the same qid may
    appear in several buffers without collision); split results back by the
    per-buffer query counts (``len(b)``).

    Every buffer must carry scores (re-score first via
    :meth:`RunBuffer.with_scores` if needed).  Buffers must come from the
    same evaluator — ``gidx``/``rel``/``judged`` refer to its interned qrel
    state, and nothing here can re-check that.
    """
    if not bufs:
        raise ValueError("no buffers to concatenate")
    if any(b.scores is None for b in bufs):
        raise ValueError("every buffer needs scores; use with_scores()")
    if len(bufs) == 1:
        return bufs[0]
    qids: List[str] = []
    for b in bufs:
        qids.extend(b.qids)
    q_off = np.cumsum([0] + [len(b) for b in bufs[:-1]])
    return RunBuffer(
        qids,
        np.concatenate([b.gidx for b in bufs]),
        np.concatenate([b.qidx + off for b, off in zip(bufs, q_off)]),
        np.concatenate([b.col for b in bufs]),
        np.concatenate([b.counts for b in bufs]),
        np.concatenate([b.rel for b in bufs]),
        np.concatenate([b.judged for b in bufs]),
        np.concatenate([b.tiebreak for b in bufs]),
        np.concatenate([b.scores for b in bufs]),
    )


class RelevanceEvaluator:
    """Evaluate rankings against relevance judgments, trec_eval semantics.

    ``device`` is where every batch is evaluated: ``None`` means CUDA, and
    asking for CUDA without it raises (there is no CPU fallback); pass
    ``device="cpu"`` to run the plain PyTorch versions of the kernels.

    Thread-safety: after construction the evaluator's interned qrel state is
    immutable; the one lazy mutation — the seed reference-densifier state —
    is built under a lock.
    """

    def __init__(
        self,
        query_relevance: QrelType,
        measures: Iterable[str],
        relevance_level: int = 1,
        densify: str = "vectorized",
        judged_docs_only: bool = False,
        judged_docs_only_flag: Optional[bool] = None,
        device=None,
    ):
        self.device = resolve_device(device)
        if not isinstance(query_relevance, Mapping):
            raise TypeError("query_relevance must be a mapping qid -> {doc: rel}")
        if densify not in ("vectorized", "reference"):
            raise ValueError(f"unknown densify path {densify!r}")
        self.densify_path = densify
        # upstream pytrec_eval spells the constructor flag judged_docs_only
        # (trec_eval -J); accept the _flag alias some callers use.
        if judged_docs_only_flag is not None:
            judged_docs_only = bool(judged_docs_only_flag)
        self.judged_docs_only = bool(judged_docs_only)
        # Measures may arrive in either dialect; rel= annotations (AP(rel=2))
        # resolve the relevance level together with the explicit argument.
        self.measures, self.relevance_level = registry.canonicalize(
            tuple(measures), relevance_level)
        self.measure_keys = registry.keys_for(self.measures)
        #: max ranking depth the measure set reads (None = full sort needed);
        #: drives the top-k kernel routing in :meth:`batch_from_buffer` users
        self._topk_depth = registry.topk_depth(self.measures)
        # Normalize keys only when needed (the copy is O(total judgments);
        # pytrec_eval's C conversion pays the same cost, ~10× cheaper).
        needs_norm = any(
            not isinstance(q, str)
            or any(not isinstance(d, str) for d in docs)
            for q, docs in list(query_relevance.items())[:1])
        if needs_norm:
            self._qrel: Dict[str, Dict[str, int]] = {
                str(q): {str(d): int(r) for d, r in docs.items()}
                for q, docs in query_relevance.items()
            }
        else:
            self._qrel = dict(query_relevance)
        self._build_interned()
        self._reference_state_built = False
        self._reference_lock = threading.Lock()

    #: queries per device batch: bounds padding waste (pytrec_eval's C loop
    #: analogue)
    chunk_queries: int = 2048

    #: max entries for the dense (query, token) join tables (f32 + bool)
    _DENSE_JOIN_CAP: int = 1 << 24

    #: max bincount size for the counting-sort tie-break rank
    _COUNTING_RANK_CAP: int = 1 << 24

    # -- construction-time qrel interning ------------------------------------

    def _build_interned(self) -> None:
        """One-time qrel parse into flat slabs (pytrec_eval's C conversion).

        Builds: the sorted docno vocabulary; a sorted ``(query, token)`` key
        array + value array for the vectorized run→qrel join; per-query
        ideal-gain rows ``[Q, Jmax]``; and the R / judged-non-relevant
        vectors.  Everything downstream indexes these slabs with fancy
        indexing — no per-query recomputation at evaluate time.
        """
        self._qids: List[str] = list(self._qrel)
        self._qid_index: Dict[str, int] = {
            q: i for i, q in enumerate(self._qids)}
        nq = len(self._qids)
        counts = np.fromiter((len(self._qrel[q]) for q in self._qids),
                             dtype=np.int64, count=nq)
        total = int(counts.sum())
        self._judged_counts = counts
        if total == 0:
            self._vocab = np.empty(0, dtype="U1")
            self._tok = {}
            self._qrel_key = np.empty(0, dtype=np.int64)
            self._qrel_val = np.empty(0, dtype=np.float32)
            self._rel_table = None
            self._judged_table = None
            self._ideal = np.zeros((nq, 0), dtype=np.float32)
            self._n_rel = np.zeros(nq, dtype=np.float32)
            self._n_nonrel = np.zeros(nq, dtype=np.float32)
            return
        docnos = np.array(list(chain.from_iterable(
            self._qrel[q] for q in self._qids)))
        vals = np.fromiter(
            chain.from_iterable(self._qrel[q].values() for q in self._qids),
            dtype=np.float32, count=total)
        qidx = np.repeat(np.arange(nq, dtype=np.int64), counts)
        qptr = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(counts, out=qptr[1:])

        # Interned vocabulary: one sorted array of all distinct qrel docnos,
        # plus the docno→token hash map for O(1) per-doc interning of runs.
        self._vocab = np.unique(docnos)
        self._tok: Dict[str, int] = {
            d: i for i, d in enumerate(self._vocab.tolist())}
        tok = np.searchsorted(self._vocab, docnos)  # exact by construction
        key = qidx * np.int64(len(self._vocab)) + tok
        order = np.argsort(key)  # (query, token) keys are unique
        self._qrel_key = key[order]
        self._qrel_val = vals[order]
        # Dense join tables (rel value + judged flag indexed by the same
        # (query, token) key) when the qrel is small enough; searchsorted
        # over the sorted key slab otherwise.
        if nq * len(self._vocab) <= self._DENSE_JOIN_CAP:
            self._rel_table = np.zeros(nq * len(self._vocab), dtype=np.float32)
            self._judged_table = np.zeros(nq * len(self._vocab), dtype=bool)
            self._rel_table[self._qrel_key] = self._qrel_val
            self._judged_table[self._qrel_key] = True
        else:
            self._rel_table = None
            self._judged_table = None

        # Per-query statistics, vectorized over the whole qrel at once.
        binrel = (vals >= self.relevance_level).astype(np.float64)
        n_rel = np.bincount(qidx, weights=binrel, minlength=nq)
        self._n_rel = n_rel.astype(np.float32)
        self._n_nonrel = (counts - n_rel).astype(np.float32)

        # Ideal-gain rows: judgments sorted descending per query, scattered
        # into one contiguous [Q, Jmax] slab.
        jmax = int(counts.max())
        ideal = np.zeros((nq, jmax), dtype=np.float32)
        iorder = np.lexsort((-vals, qidx))
        icol = np.arange(total, dtype=np.int64) - qptr[qidx]
        ideal[qidx[iorder], icol] = vals[iorder]
        self._ideal = ideal

    @property
    def vocab(self) -> np.ndarray:
        """The interned docno vocabulary (sorted; token id = position)."""
        return self._vocab

    # -- pytrec_eval API -----------------------------------------------------

    def evaluate(self, run: RunType) -> Dict[str, Dict[str, float]]:
        """Evaluate a run: ``{qid: {docno: score}}`` → ``{qid: {measure: value}}``.

        The pytrec_eval-compatible entry point.  Only queries present in both
        the run and the qrels are evaluated (intersection semantics); docnos
        absent from the qrels count as unjudged/non-relevant.  Scores may be
        any floats — ranking is by descending score with trec_eval's
        descending-docno tie-break.  Values are plain Python floats.

        >>> ev = RelevanceEvaluator({'q1': {'d1': 1, 'd2': 0}}, {'map'},
        ...                         device='cpu')
        >>> ev.evaluate({'q1': {'d1': 0.2, 'd2': 0.9}})['q1']['map']
        0.5
        """
        qids = [q for q in run if q in self._qrel]
        if not qids:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        for lo in range(0, len(qids), self.chunk_queries):
            chunk = qids[lo:lo + self.chunk_queries]
            if self.densify_path == "reference":
                batch, _ = self._densify(run, chunk)
                self._emit(out, chunk, batch)
            else:
                buf = self._tokenize_chunk(run, chunk)
                topk = self._route_topk(buf)
                batch = self.batch_from_buffer(buf, topk_layout=topk)
                self._emit(out, chunk, batch, topk=topk)
        return out

    def evaluate_many(
        self,
        runs: Union[Mapping[str, RunType], Sequence[RunType]],
    ) -> Union[Dict[str, Dict], List[Dict]]:
        """Evaluate several runs against the same cached qrel state.

        The persistent-session entry point: qrel interning, measure parsing,
        and the measure set are shared across all runs.  Accepts either a
        mapping ``{run_name: run}`` (returns a mapping of results) or a
        sequence of runs (returns a list of results).

        >>> ev = RelevanceEvaluator({'q1': {'d1': 1, 'd2': 0}}, {'recip_rank'},
        ...                         device='cpu')
        >>> res = ev.evaluate_many({'a': {'q1': {'d1': 1.0, 'd2': 0.5}},
        ...                         'b': {'q1': {'d1': 0.5, 'd2': 1.0}}})
        >>> res['a']['q1']['recip_rank'], res['b']['q1']['recip_rank']
        (1.0, 0.5)
        """
        if isinstance(runs, Mapping):
            return {name: self.evaluate(r) for name, r in runs.items()}
        return [self.evaluate(r) for r in runs]

    # -- session API: pre-tokenized runs -------------------------------------

    def tokenize_run(self, run: RunType) -> RunBuffer:
        """Do the string work for a run once, yielding a reusable buffer.

        ``run`` is a ``{qid: {docno: score}}`` mapping; queries absent from
        the qrels are dropped (same intersection semantics as
        :meth:`evaluate`).  The returned :class:`RunBuffer` keeps documents in
        query-major dict-iteration order — that is the flat order fresh
        ``scores`` passed to :meth:`evaluate_buffer` /
        :meth:`batch_from_buffer` must follow.

        >>> ev = RelevanceEvaluator({'q1': {'d1': 1, 'd2': 0}}, {'map'},
        ...                         device='cpu')
        >>> buf = ev.tokenize_run({'q1': {'d1': 1.0, 'd2': 0.5}})
        >>> len(buf), buf.counts.tolist()
        (1, [2])
        """
        return self._tokenize_chunk(run, [q for q in run if q in self._qrel])

    def buffer_from_arrays(self, qids, docnos, scores) -> RunBuffer:
        """Tokenize a flat ``(qid, docno, score)`` triple-array run.

        The array analogue of :meth:`tokenize_run` — pairs with
        ``core.trec.parse_run_arrays`` so a TREC run file goes straight into
        the tokenized form without ever building a dict-of-dicts.  Rows may
        arrive in any order; queries are grouped with a stable sort, and rows
        for queries absent from the qrels are dropped (pytrec_eval
        intersection semantics).

        Shapes/dtypes: all three arguments are flat, equal-length 1-D arrays
        — ``qids`` and ``docnos`` string-convertible, ``scores`` cast to
        float32.  ``(qid, docno)`` pairs must be unique (trec_eval rejects
        duplicates; this fast path does not re-check).

        >>> import numpy as np
        >>> ev = RelevanceEvaluator({'q1': {'d1': 1, 'd2': 0}}, {'recip_rank'},
        ...                         device='cpu')
        >>> buf = ev.buffer_from_arrays(np.array(['q1', 'q1']),
        ...                             np.array(['d2', 'd1']),
        ...                             np.array([0.2, 0.9], dtype=np.float32))
        >>> ev.evaluate_buffer(buf)['q1']['recip_rank']
        1.0
        """
        qids = np.asarray(qids)
        docnos = np.asarray(docnos)
        scores = np.asarray(scores, dtype=np.float32)
        uniq, inv = np.unique(qids, return_inverse=True)
        known = np.fromiter((q in self._qid_index for q in uniq.tolist()),
                            dtype=bool, count=len(uniq))
        keep = known[inv]
        inv = inv[keep]
        order = np.argsort(inv, kind="stable")
        grouped_counts = np.bincount(inv, minlength=len(uniq))
        kept_uniq = [q for q, k in zip(uniq.tolist(), known.tolist()) if k]
        counts = grouped_counts[known].astype(np.int64)
        return self._make_buffer(kept_uniq, counts, docnos[keep][order],
                                 scores[keep][order])

    def buffer_from_tokens(self, qids: Sequence[str], counts, tokens,
                           scores=None) -> RunBuffer:
        """Build a buffer from *pre-tokenized* integer docnos — no strings.

        ``tokens`` is the flat concatenation (query order given by ``qids`` /
        ``counts``) of indices into :attr:`vocab`; out-of-vocabulary documents
        are ``-1``.  Tokens must be unique within a query.  Tie-break ranks
        are derived from token order — exact for in-vocabulary docnos (the
        vocabulary is lex-sorted), while OOV documents rank after all
        in-vocabulary docs at equal score.  OOV docs are unjudged, so this
        only reorders unjudged-vs-unjudged pairs relative to trec_eval, which
        no measure observes; score ties between an OOV and a judged doc are
        the one divergence, documented here.

        Shapes/dtypes: ``qids`` is a length-``nq`` sequence of qrel query
        ids; ``counts`` (``[nq]``, int) gives retrieved docs per query;
        ``tokens`` (``[sum(counts)]``, int) and optional ``scores`` (same
        length, cast to float32) are flat in that query order.

        >>> ev = RelevanceEvaluator({'q1': {'d1': 1, 'd2': 0}}, {'recip_rank'},
        ...                         device='cpu')
        >>> ev.vocab.tolist()  # token id = position; -1 = out-of-vocabulary
        ['d1', 'd2']
        >>> buf = ev.buffer_from_tokens(['q1'], counts=[2], tokens=[0, -1],
        ...                             scores=[0.9, 0.2])
        >>> ev.evaluate_buffer(buf)['q1']['recip_rank']
        1.0
        """
        qids = [str(q) for q in qids]
        missing = [q for q in qids if q not in self._qid_index]
        if missing:
            raise KeyError(f"qids not in qrels: {missing[:3]}")
        counts = np.asarray(counts, dtype=np.int64)
        tokens = np.asarray(tokens, dtype=np.int64)
        total = int(counts.sum())
        if tokens.shape[0] != total:
            raise ValueError(
                f"token count {tokens.shape[0]} != sum(counts) {total}")
        nq = len(qids)
        gidx = np.fromiter((self._qid_index[q] for q in qids),
                           dtype=np.int64, count=nq)
        qidx = np.repeat(np.arange(nq, dtype=np.int64), counts)
        qptr = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(counts, out=qptr[1:])
        col = np.arange(total, dtype=np.int64) - qptr[qidx]
        in_vocab = tokens >= 0
        rel, judged = self._join_tokens(gidx, qidx,
                                        np.maximum(tokens, 0), in_vocab)
        # Desc-token rank == desc-lex rank for in-vocab docs; OOV (-1) sorts
        # first ascending → last descending.
        tiebreak = self._desc_ranks(np.lexsort((tokens, qidx)), qidx, qptr,
                                    counts)
        if scores is not None:
            scores = np.ascontiguousarray(scores,
                                          dtype=np.float32).reshape(-1)
            if scores.shape[0] != total:
                raise ValueError(
                    f"score count {scores.shape[0]} != sum(counts) {total}")
        return RunBuffer(qids, gidx, qidx, col, counts, rel, judged, tiebreak,
                         scores)

    def batch_from_buffer(self, buf: RunBuffer, scores=None,
                          q_multiple: int = 1,
                          topk_layout: bool = False) -> M.EvalBatch:
        """Padded ``EvalBatch`` from a buffer (numeric work only).

        Feed the result to ``core.measures.compute_measures``.  The batch
        lives on the evaluator's device.

        ``q_multiple`` pads the query axis to a multiple of it (on top of the
        usual power-of-two bucketing); padded queries carry
        ``query_mask == False`` and are ignored by every measure and
        aggregate.

        ``topk_layout`` scatters each document at column == its tiebreak
        rank (a permutation of ``[0, count)``, so the counts-derived mask
        stays valid).  Under that layout the top-k kernel's
        smaller-index-wins tie rule IS trec_eval's tie rule, which is what
        ``core.measures.compute_measures_topk`` requires; the layout is
        measure-invariant for the full-sort path (``tiebreak`` still rides
        along as its own field).
        """
        if scores is not None:
            buf = buf.with_scores(scores)
        if buf.scores is None:
            raise ValueError("buffer has no scores; pass scores=")
        nq = len(buf.qids)
        max_d = int(buf.counts.max()) if nq else 0
        jcounts = self._judged_counts[buf.gidx]
        max_j = int(jcounts.max()) if nq else 0
        q_pad = bucketing.bucket_queries(nq, multiple=q_multiple)
        return M.batch_from_flat(
            qidx=buf.qidx,
            col=buf.tiebreak if topk_layout else buf.col,
            scores=buf.scores,
            tiebreak=buf.tiebreak, rel=buf.rel, judged=buf.judged,
            ideal_rows=self._ideal[buf.gidx],
            n_rel=self._n_rel[buf.gidx],
            n_judged_nonrel=self._n_nonrel[buf.gidx],
            n_queries=nq, q_pad=q_pad, d_pad=_bucket(max_d),
            j_pad=_bucket(max(max_j, 1)), counts=buf.counts,
            device=self.device)

    def _route_topk(self, buf: RunBuffer) -> bool:
        """Should this buffer take the top-k kernel path?

        Yes iff every requested measure is depth-bounded (ROADMAP item 2:
        ``*_cut`` / ``@k`` measures stop sorting the full document axis) and
        the padded document axis is wide enough that ranking only the top-k
        prefix beats the full multi-key sort.  Both routes rank alike:
        score descending, ties to the lower tiebreak, and every NaN score
        after every number and after the top-k layout's -inf padding, as
        the full sort puts it after the padding.  So the selected prefix is
        the full sort's first k rows and the values are the same either way
        (parity-tested against the JAX full-sort route in
        tests/test_torch_evaluator.py, NaN and +-inf scores included).
        """
        if self._topk_depth is None or not len(buf):
            return False
        d_pad = _bucket(int(buf.counts.max()))
        k2 = bucketing.next_pow2(self._topk_depth, 128)
        return d_pad > max(2 * k2, 512)

    def evaluate_buffer(self, buf: RunBuffer,
                        scores=None) -> Dict[str, Dict[str, float]]:
        """Evaluate a pre-tokenized buffer; optional fresh flat scores.

        The zero-string-work half of the session API: all docno
        interning/tie-breaking happened when ``buf`` was built, so this call
        is a numeric scatter plus the measure core.  ``scores``, when
        given, replaces the buffer's scores — a flat float array in the
        buffer's query-major document order (``buf.counts[i]`` docs for
        ``buf.qids[i]``, concatenated).

        >>> ev = RelevanceEvaluator({'q1': {'d1': 1, 'd2': 0}}, {'recip_rank'},
        ...                         device='cpu')
        >>> buf = ev.tokenize_run({'q1': {'d1': 1.0, 'd2': 0.5}})
        >>> ev.evaluate_buffer(buf)['q1']['recip_rank']
        1.0
        >>> ev.evaluate_buffer(buf, scores=[0.1, 0.9])['q1']['recip_rank']
        0.5
        """
        if not len(buf):
            return {}
        topk = self._route_topk(buf)
        batch = self.batch_from_buffer(buf, scores, topk_layout=topk)
        out: Dict[str, Dict[str, float]] = {}
        self._emit(out, buf.qids, batch, topk=topk)
        return out

    def evaluate_buffers(
        self,
        bufs: Sequence[RunBuffer],
        scores_list: Optional[Sequence] = None,
    ) -> List[Dict[str, Dict[str, float]]]:
        """Evaluate several buffers with ONE densify + measure-core call.

        The coalescing hook for the serve layer
        (:mod:`repro.serve`): the buffers are stacked end to end on the query
        axis (:func:`concat_run_buffers`), scattered into one padded
        ``EvalBatch``, and dispatched to the measure core once; the
        per-query columns are then split back by each buffer's query count.
        Results are bit-identical to calling :meth:`evaluate_buffer` once per
        buffer — measures are computed row-independently, so stacking the
        query axis (like sharding it) cannot change any value.

        ``scores_list``, when given, pairs each buffer with fresh flat scores
        (``None`` entries keep the buffer's own scores).

        >>> ev = RelevanceEvaluator({'q1': {'d1': 1, 'd2': 0}}, {'map'},
        ...                         device='cpu')
        >>> a = ev.tokenize_run({'q1': {'d1': 1.0, 'd2': 0.5}})
        >>> b = ev.tokenize_run({'q1': {'d1': 0.1, 'd2': 0.9}})
        >>> [r['q1']['map'] for r in ev.evaluate_buffers([a, b])]
        [1.0, 0.5]
        """
        bufs = list(bufs)
        if scores_list is not None:
            if len(scores_list) != len(bufs):
                raise ValueError(
                    f"{len(scores_list)} score sets for {len(bufs)} buffers")
            bufs = [b if s is None else b.with_scores(s)
                    for b, s in zip(bufs, scores_list)]
        if not bufs:
            return []
        nonempty = [b for b in bufs if len(b)]
        if not nonempty:
            return [{} for _ in bufs]
        big = concat_run_buffers(nonempty)
        topk = self._route_topk(big)
        cols = self._columns(self.batch_from_buffer(big, topk_layout=topk),
                             len(big.qids), topk)
        results: List[Dict[str, Dict[str, float]]] = []
        lo = 0
        for buf in bufs:
            out: Dict[str, Dict[str, float]] = {}
            for i, qid in enumerate(buf.qids):
                out[qid] = {k: cols[k][lo + i] for k in self.measure_keys}
            lo += len(buf.qids)
            results.append(out)
        return results

    def evaluate_sharded(self, run_or_buffer, mesh=None):
        """Evaluate with the query axis split over a device mesh.

        Builds a :class:`repro_torch.distributed.ShardedEvaluator` over
        ``mesh`` (a sequence of devices; default: every visible card for
        an evaluator on CUDA, the evaluator's device on the CPU) and
        evaluates ``run_or_buffer`` (a run mapping or a
        :class:`RunBuffer`).  Returns a ``ShardedResult``: per-query rows
        plus corpus-mean aggregates.

        >>> ev = RelevanceEvaluator({'q1': {'d1': 1, 'd2': 0}}, {'map'},
        ...                         device='cpu')
        >>> res = ev.evaluate_sharded({'q1': {'d1': 0.2, 'd2': 0.9}},
        ...                           mesh=['cpu'] * 2)
        >>> res.per_query['q1']['map'], res.aggregates['map']
        (0.5, 0.5)
        """
        from repro_torch.distributed.sharded_evaluator import ShardedEvaluator

        return ShardedEvaluator(self, mesh=mesh).evaluate(run_or_buffer)

    # -- densification --------------------------------------------------------

    def _densify(self, run: RunType, qids: Sequence[str]):
        if self.densify_path == "reference":
            return self._densify_reference(run, qids)
        return self._densify_vectorized(run, qids)

    def _densify_vectorized(self, run: RunType, qids: Sequence[str]):
        """Flat pipeline: one tie-break lexsort, one vocab join, one scatter."""
        batch = self.batch_from_buffer(self._tokenize_chunk(run, qids))
        return batch, batch.query_mask.cpu().numpy()

    def _tokenize_chunk(self, run: RunType, qids: Sequence[str]) -> RunBuffer:
        """Dict-of-dicts chunk → RunBuffer via the interned token map.

        The hot path does NOT materialize a docno string array: every docno
        is interned through the construction-time hash map in one C-level
        ``map`` pass, after which tie-break ranks and the qrel join are pure
        integer work.  Only runs containing out-of-vocabulary docnos (absent
        from the qrels) fall back to the exact string pipeline, because OOV
        tie-breaks need real lexicographic comparisons.
        """
        doc_maps = [run[q] for q in qids]
        nq = len(qids)
        counts = np.fromiter(map(len, doc_maps), dtype=np.int64, count=nq)
        total = int(counts.sum())
        if not total:
            return self._make_buffer(list(qids), counts,
                                     np.empty(0, dtype="U1"),
                                     np.empty(0, dtype=np.float32))
        tokens = np.fromiter(
            map(self._tok.get, chain.from_iterable(doc_maps), repeat(-1)),
            dtype=np.int64, count=total)
        scores = np.fromiter(
            chain.from_iterable(m.values() for m in doc_maps),
            dtype=np.float32, count=total)
        if int(tokens.min()) < 0:  # OOV docs → exact string pipeline
            docnos = np.array(list(chain.from_iterable(doc_maps)))
            return self._make_buffer(list(qids), counts, docnos, scores)
        return self._buffer_from_exact_tokens(list(qids), counts, tokens,
                                              scores)

    def _make_buffer(self, qids: List[str], counts: np.ndarray,
                     docnos: np.ndarray, scores: np.ndarray) -> RunBuffer:
        """Exact string tokenization core: grouped flat arrays → RunBuffer."""
        nq = len(qids)
        total = int(counts.sum())
        gidx = np.fromiter((self._qid_index[q] for q in qids),
                           dtype=np.int64, count=nq)
        qidx = np.repeat(np.arange(nq, dtype=np.int64), counts)
        qptr = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(counts, out=qptr[1:])
        col = np.arange(total, dtype=np.int64) - qptr[qidx]

        # ONE searchsorted against the interned vocabulary.
        v = len(self._vocab)
        if v and total:
            tok = np.searchsorted(self._vocab, docnos)
            tok_c = np.minimum(tok, v - 1)
            in_vocab = self._vocab[tok_c] == docnos
            rel, judged = self._join_tokens(gidx, qidx, tok_c, in_vocab)
        else:
            rel = np.zeros(total, dtype=np.float32)
            judged = np.zeros(total, dtype=bool)

        # ONE lexicographic argsort for the trec_eval tie-break ranks
        # (score ties broken by docno descending → smaller rank wins).
        tiebreak = self._desc_ranks(np.lexsort((docnos, qidx)), qidx, qptr,
                                    counts)
        return RunBuffer(qids, gidx, qidx, col, counts, rel, judged, tiebreak,
                         scores)

    def _buffer_from_exact_tokens(self, qids: List[str], counts: np.ndarray,
                                  tokens: np.ndarray,
                                  scores: np.ndarray) -> RunBuffer:
        """Integer-only tokenization core: every docno is in the vocabulary.

        Token order equals lexicographic docno order (the vocabulary is
        sorted), so tie-break ranks come from a counting sort over the unique
        ``(query, token)`` keys — O(n + Q·V), no comparison sort at all —
        and the qrel join is a table gather (or one integer searchsorted).
        """
        nq = len(qids)
        total = int(counts.sum())
        v = len(self._vocab)
        gidx = np.fromiter((self._qid_index[q] for q in qids),
                           dtype=np.int64, count=nq)
        qidx = np.repeat(np.arange(nq, dtype=np.int64), counts)
        qptr = np.zeros(nq + 1, dtype=np.int64)
        np.cumsum(counts, out=qptr[1:])
        col = np.arange(total, dtype=np.int64) - qptr[qidx]

        rel, judged = self._join_tokens(
            gidx, qidx, tokens, np.ones(total, dtype=bool))

        key = qidx * np.int64(v) + tokens  # unique: docnos unique per query
        if nq * v <= self._COUNTING_RANK_CAP:
            # counting-sort rank: position of each key in sorted order
            asc = np.cumsum(np.bincount(key, minlength=nq * v))[key] - 1
            asc -= qptr[qidx]
        else:
            order = np.argsort(key)
            asc = np.empty(total, dtype=np.int64)
            asc[order] = np.arange(total, dtype=np.int64)
            asc -= qptr[qidx]
        tiebreak = (counts[qidx] - 1 - asc).astype(np.int32)
        return RunBuffer(qids, gidx, qidx, col, counts, rel, judged, tiebreak,
                         scores)

    def _join_tokens(self, gidx, qidx, tok_c, in_vocab):
        """Vectorized run→qrel join on (query, token) keys: one table gather
        when the dense tables fit, one integer searchsorted otherwise."""
        total = qidx.shape[0]
        rel = np.zeros(total, dtype=np.float32)
        judged = np.zeros(total, dtype=bool)
        if not len(self._qrel_key) or not total:
            return rel, judged
        key = gidx[qidx] * np.int64(len(self._vocab)) + tok_c
        if self._rel_table is not None:
            rel = np.where(in_vocab, self._rel_table[key], 0.0)
            judged = in_vocab & self._judged_table[key]
            return rel, judged
        pos = np.searchsorted(self._qrel_key, key)
        pos_c = np.minimum(pos, len(self._qrel_key) - 1)
        hit = in_vocab & (self._qrel_key[pos_c] == key)
        rel[hit] = self._qrel_val[pos_c[hit]]
        judged = hit
        return rel, judged

    @staticmethod
    def _desc_ranks(order, qidx, qptr, counts) -> np.ndarray:
        """Per-query descending ranks from an ascending within-query sort."""
        total = qidx.shape[0]
        asc = np.arange(total, dtype=np.int64) - qptr[qidx[order]]
        tiebreak = np.empty(total, dtype=np.int32)
        tiebreak[order] = (counts[qidx[order]] - 1 - asc).astype(np.int32)
        return tiebreak

    # -- reference (seed) densifier, kept for benchmarks + bit-identity ------

    def _ensure_reference_state(self) -> None:
        if self._reference_state_built:
            return
        with self._reference_lock:
            if self._reference_state_built:
                return
            qstats = {}
            qrel_sorted = {}
            for qid, docs in self._qrel.items():
                rels = np.array(sorted(docs.values(), reverse=True),
                                dtype=np.float32)
                n_rel = float((rels >= self.relevance_level).sum())
                n_nonrel = float(len(rels)) - n_rel
                qstats[qid] = (rels, n_rel, n_nonrel)
                docnos = np.array(list(docs.keys()))
                vals = np.fromiter(docs.values(), dtype=np.float32,
                                   count=len(docs))
                order = np.argsort(docnos)
                qrel_sorted[qid] = (docnos[order], vals[order])
            self._qstats = qstats
            self._qrel_sorted = qrel_sorted
            self._reference_state_built = True

    def _densify_reference(self, run: RunType, qids: Sequence[str]):
        """The seed per-query-loop densifier (unchanged semantics)."""
        self._ensure_reference_state()
        nq = len(qids)
        max_d = max(len(run[q]) for q in qids)
        max_j = max(len(self._qstats[q][0]) for q in qids)
        qb, db, jb = _bucket(nq, 1), _bucket(max_d), _bucket(max(max_j, 1))

        scores = np.zeros((qb, db), dtype=np.float32)
        tiebreak = np.zeros((qb, db), dtype=np.int32)
        rel = np.zeros((qb, db), dtype=np.float32)
        judged = np.zeros((qb, db), dtype=bool)
        mask = np.zeros((qb, db), dtype=bool)
        ideal = np.zeros((qb, jb), dtype=np.float32)
        n_rel = np.zeros((qb,), dtype=np.float32)
        n_nonrel = np.zeros((qb,), dtype=np.float32)
        qmask = np.zeros((qb,), dtype=bool)

        for i, qid in enumerate(qids):
            docs = run[qid]
            d = len(docs)
            docnos = np.array(list(docs.keys()))
            # trec_eval tie-break: larger docno (desc lex) wins → order rank.
            order = np.empty(d, dtype=np.int32)
            order[np.argsort(docnos)[::-1]] = np.arange(d, dtype=np.int32)
            scores[i, :d] = np.fromiter(docs.values(), dtype=np.float32,
                                        count=d)
            tiebreak[i, :d] = order
            # vectorized run→qrel join (sorted-array searchsorted, C speed)
            qrel_docnos, qrel_vals = self._qrel_sorted[qid]
            if len(qrel_docnos):
                pos = np.searchsorted(qrel_docnos, docnos)
                pos_c = np.minimum(pos, len(qrel_docnos) - 1)
                hit = qrel_docnos[pos_c] == docnos
                rel[i, :d] = np.where(hit, qrel_vals[pos_c], 0.0)
                judged[i, :d] = hit
            mask[i, :d] = True
            rels, r, n = self._qstats[qid]
            ideal[i, : len(rels)] = rels
            n_rel[i], n_nonrel[i] = r, n
            qmask[i] = True

        batch = M.batch_from_numpy(dict(
            scores=scores, tiebreak=tiebreak, rel=rel, judged=judged,
            mask=mask, ideal_rel=ideal, n_rel=n_rel,
            n_judged_nonrel=n_nonrel, query_mask=qmask), self.device)
        return batch, qmask

    # -- output ---------------------------------------------------------------

    def _columns(self, batch: M.EvalBatch, nq: int,
                 topk: bool = False) -> Dict[str, List[float]]:
        """Measure core on the device, then ONE float32 copy to the host.

        ``.tolist()`` of float32 values gives the same Python floats as the
        JAX package's ``np.asarray(column).tolist()``.
        """
        compute = M.compute_measures_topk if topk else M.compute_measures
        per_query = compute(batch, self.measures, self.relevance_level,
                            self.judged_docs_only)
        keys = self.measure_keys
        if not keys:
            return {}
        table = torch.stack([per_query[k][:nq] for k in keys])
        rows = table.to("cpu", torch.float32).numpy().tolist()
        return dict(zip(keys, rows))

    def _emit(self, out: Dict[str, Dict[str, float]], qids: Sequence[str],
              batch: M.EvalBatch, topk: bool = False) -> None:
        cols = self._columns(batch, len(qids), topk)
        for i, qid in enumerate(qids):
            out[qid] = {k: cols[k][i] for k in self.measure_keys}


def aggregate_results(results: Dict[str, Dict[str, float]]) -> Dict[str, float]:
    """Mean of every measure over queries (trec_eval's 'all' summary row).

    Geometric-mean measures (``gm_map``) carry per-query *log* contributions
    and are exponentiated after averaging (``measures.finalize_aggregates``),
    matching trec_eval's summary semantics.

    >>> res = {'q1': {'map': 1.0, 'gm_map': 0.0},
    ...        'q2': {'map': 0.25, 'gm_map': float(np.log(0.25))}}
    >>> agg = aggregate_results(res)
    >>> agg['map'], round(agg['gm_map'], 6)  # arithmetic vs geometric mean
    (0.625, 0.5)
    """
    if not results:
        return {}
    keys = next(iter(results.values())).keys()
    return M.finalize_aggregates({
        k: float(np.mean([results[q][k] for q in results])) for k in keys
    })
