"""Batched trec_eval evaluation measures on dense ``[Q, D]`` tensors (PyTorch).

The port of ``repro.core.measures``: trec_eval's measure definitions as
vectorized tensor code over a whole batch of queries at once.  Semantics
follow trec_eval (and therefore pytrec_eval):

* documents are ranked by decreasing score, ties broken by docno (descending
  lex — encoded in the ``tiebreak`` field, see ``core.sorting``);
* unjudged documents count as non-relevant;
* a document is *relevant* iff its judgment >= ``relevance_level`` (default 1);
* ``map`` / ``recall`` / ``Rprec`` normalize by R = number of relevant docs in
  the **qrels** (including unretrieved ones);
* ``ndcg`` uses trec_eval's linear gain (rel / log2(rank+1)) with the ideal
  ranking drawn from the full qrels;
* cutoffs match trec_eval: 5,10,15,20,30,100,200,500,1000 (success: 1,5,10).

All measure functions take a :class:`SortedBatch` and return per-query
float32 tensors ``[Q]``; padded queries (``query_mask == False``) return 0.
Every tensor of a batch lives on one device; the functions run there.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import registry, sorting
from repro_torch.device import resolve_device

DEFAULT_CUTOFFS: Tuple[int, ...] = registry.DEFAULT_CUTOFFS
SUCCESS_CUTOFFS: Tuple[int, ...] = registry.SUCCESS_CUTOFFS
IPREC_LEVELS: Tuple[float, ...] = registry.IPREC_LEVELS
GM_MIN: float = registry.GM_MIN
SUPPORTED_MEASURES = registry.supported_families()
AGGREGATE_ONLY_MEASURES = registry.aggregate_only_families()

_F32 = torch.float32


class EvalBatch(NamedTuple):
    """Dense, padded representation of a batch of rankings + ground truth.

    Axes: Q = queries (padded), D = retrieved docs per query (padded),
    J = judged docs per query (padded; used only for the ideal DCG).
    """

    scores: torch.Tensor  # [Q, D] f32 — retrieval scores (order irrelevant)
    tiebreak: torch.Tensor  # [Q, D] i32 — smaller wins ties
    rel: torch.Tensor  # [Q, D] f32 — judgment of each retrieved doc
    judged: torch.Tensor  # [Q, D] bool — retrieved doc appears in the qrels
    mask: torch.Tensor  # [Q, D] bool — retrieved doc is real (not padding)
    ideal_rel: torch.Tensor  # [Q, J] f32 — qrel judgments, sorted descending
    n_rel: torch.Tensor  # [Q] f32 — R: relevant docs in qrels
    n_judged_nonrel: torch.Tensor  # [Q] f32 — judged non-relevant in qrels
    query_mask: torch.Tensor  # [Q] bool — query is real (not padding)


class SortedBatch(NamedTuple):
    """EvalBatch after ranking: everything ordered by trec_eval rank."""

    rel: torch.Tensor  # [Q, D] f32, rank order
    binrel: torch.Tensor  # [Q, D] f32 (0/1), rank order
    judged: torch.Tensor  # [Q, D] f32 (0/1), rank order
    mask: torch.Tensor  # [Q, D] f32 (0/1), rank order
    cum_rel: torch.Tensor  # [Q, D] f32 — inclusive cumulative relevant count
    ideal_rel: torch.Tensor  # [Q, J] f32
    n_rel: torch.Tensor  # [Q] f32
    n_judged_nonrel: torch.Tensor  # [Q] f32
    n_ret: torch.Tensor  # [Q] f32
    query_mask: torch.Tensor  # [Q] bool


#: dtype of every EvalBatch field (the JAX package's dtypes)
BATCH_DTYPES: Dict[str, torch.dtype] = {
    "scores": _F32, "tiebreak": torch.int32, "rel": _F32,
    "judged": torch.bool, "mask": torch.bool, "ideal_rel": _F32,
    "n_rel": _F32, "n_judged_nonrel": _F32, "query_mask": torch.bool,
}

_PACK_OFFSET = 4.0  # rel values ≥ -4 supported (trec_eval uses ≥ -2)


def sort_batch(batch: EvalBatch, relevance_level: float = 1.0,
               judged_only: bool = False) -> SortedBatch:
    """Rank every query's documents under trec_eval ordering.

    ``judged_only`` implements trec_eval's ``-J``: unjudged retrieved
    documents sort to the tail with rel=0/judged=0 — indistinguishable from
    padding, hence inert for every measure — and ``n_ret`` counts only the
    kept docs.  (rel, judged) ride the sort as ONE packed f32 payload,
    ``(rel+4)·2 + judged``, exactly as in the JAX package.
    """
    if not relevance_level > 0:
        raise ValueError("relevance_level must be > 0: padding has rel 0")
    mask = batch.mask & batch.judged if judged_only else batch.mask
    packed = ((batch.rel * mask.to(_F32) + _PACK_OFFSET) * 2.0
              + (batch.judged & mask).to(_F32))
    packed = torch.where(mask, packed, _PACK_OFFSET * 2.0)
    (packed_s,) = sorting.rank_sort(
        batch.scores, batch.tiebreak, mask, packed)[1:]
    half = torch.floor(packed_s / 2.0)
    judged_s = packed_s - 2.0 * half
    rel_s = half - _PACK_OFFSET
    binrel = (rel_s >= relevance_level).to(_F32)
    return SortedBatch(
        rel=rel_s,
        binrel=binrel,
        judged=judged_s,
        mask=torch.ones_like(rel_s),
        cum_rel=torch.cumsum(binrel, dim=-1),
        ideal_rel=batch.ideal_rel,
        n_rel=batch.n_rel,
        n_judged_nonrel=batch.n_judged_nonrel,
        n_ret=mask.to(_F32).sum(dim=-1),
        query_mask=batch.query_mask,
    )


# ---------------------------------------------------------------------------
# Individual measures (each: SortedBatch -> [Q] f32).
# ---------------------------------------------------------------------------


def _ranks(d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(1, d + 1, dtype=_F32, device=like.device)


def _safe_div(num, den):
    return torch.where(den > 0, num / torch.clamp(den, min=1e-30), 0.0)


def _per_k(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x / k`` for a static cutoff k, rounded as the JAX package rounds it.

    XLA rewrites a division by a constant into a multiply by the constant's
    float32 reciprocal (``x * f32(1/k)``, which differs from ``x / k`` in
    the last bit for k = 15, 30, 1000, ...), in the measure core and in the
    Pallas kernel alike.  The port multiplies by the same reciprocal on
    every device, so P@k and Judged@k are bit-identical to the reference.
    """
    return x * float(np.float32(1.0) / np.float32(k))


def _at_rank(cum: torch.Tensor, k: int) -> torch.Tensor:
    """cum value at 1-based rank k (clipped to the retrieved-depth D)."""
    return cum[..., min(k, cum.shape[-1]) - 1]


def average_precision(s: SortedBatch) -> torch.Tensor:
    prec = s.cum_rel / _ranks(s.binrel.shape[-1], s.binrel)
    return _safe_div(torch.sum(s.binrel * prec, dim=-1), s.n_rel)


def gm_map_contrib(s: SortedBatch) -> torch.Tensor:
    """Per-query geometric-MAP contribution: ``log(max(AP, GM_MIN))``."""
    return torch.log(torch.clamp(average_precision(s), min=GM_MIN))


def map_cut(s: SortedBatch, k: int) -> torch.Tensor:
    ranks = _ranks(s.binrel.shape[-1], s.binrel)
    within = (ranks <= k).to(_F32)
    prec = s.cum_rel / ranks
    return _safe_div(torch.sum(s.binrel * prec * within, dim=-1), s.n_rel)


def precision_at(s: SortedBatch, k: int) -> torch.Tensor:
    # trec_eval always divides by k, even when fewer than k docs were retrieved.
    return _per_k(_at_rank(s.cum_rel, k), k)


def recall_at(s: SortedBatch, k: int) -> torch.Tensor:
    return _safe_div(_at_rank(s.cum_rel, k), s.n_rel)


def success_at(s: SortedBatch, k: int) -> torch.Tensor:
    return (_at_rank(s.cum_rel, k) > 0).to(_F32)


def reciprocal_rank(s: SortedBatch) -> torch.Tensor:
    any_rel = torch.sum(s.binrel, dim=-1) > 0
    # argmax returns the first maximal index, as jnp.argmax does
    first = torch.argmax(s.binrel, dim=-1).to(_F32) + 1.0
    return torch.where(any_rel, 1.0 / first, 0.0)


def r_precision(s: SortedBatch) -> torch.Tensor:
    d = s.cum_rel.shape[-1]
    idx = torch.clamp(s.n_rel.to(torch.int64), 1, d) - 1
    at_r = torch.gather(s.cum_rel, -1, idx[:, None])[:, 0]
    return _safe_div(at_r, s.n_rel)


def bpref(s: SortedBatch) -> torch.Tensor:
    """trec_eval bpref: judged-only preference measure."""
    judged_nonrel = s.judged * (1.0 - s.binrel)
    # judged non-relevant docs ranked strictly above each position.
    nr_above = torch.cumsum(judged_nonrel, dim=-1) - judged_nonrel
    r = s.n_rel[:, None]
    denom = torch.minimum(r, s.n_judged_nonrel[:, None])
    bounded = torch.minimum(nr_above, r)
    term = torch.where(nr_above > 0, 1.0 - _safe_div(bounded, denom), 1.0)
    return _safe_div(torch.sum(term * s.binrel, dim=-1), s.n_rel)


def _discounts(d: int, like: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.log2(_ranks(d, like) + 1.0)


def dcg(s: SortedBatch, k: int | None = None) -> torch.Tensor:
    """trec_eval DCG: linear gain rel / log2(rank + 1)."""
    d = s.rel.shape[-1]
    gains = torch.clamp(s.rel, min=0.0) * _discounts(d, s.rel)
    if k is not None:
        gains = gains * (_ranks(d, s.rel) <= k).to(_F32)
    return torch.sum(gains, dim=-1)


def ideal_dcg(s: SortedBatch, k: int | None = None) -> torch.Tensor:
    j = s.ideal_rel.shape[-1]
    gains = torch.clamp(s.ideal_rel, min=0.0) * _discounts(j, s.ideal_rel)
    if k is not None:
        gains = gains * (_ranks(j, s.ideal_rel) <= k).to(_F32)
    return torch.sum(gains, dim=-1)


def ndcg(s: SortedBatch) -> torch.Tensor:
    return _safe_div(dcg(s), ideal_dcg(s))


def ndcg_cut(s: SortedBatch, k: int) -> torch.Tensor:
    return _safe_div(dcg(s, k), ideal_dcg(s, k))


def iprec_at_recall(s: SortedBatch, level: float) -> torch.Tensor:
    """Interpolated precision at a recall level (11-pt PR curve point)."""
    prec = s.cum_rel / _ranks(s.cum_rel.shape[-1], s.cum_rel)
    # Reverse running max: best precision achievable at this rank or deeper.
    rev_max = torch.flip(
        torch.cummax(torch.flip(prec, dims=(-1,)), dim=-1).values, dims=(-1,))
    target = torch.ceil(level * s.n_rel)[:, None]
    reached = s.cum_rel >= torch.clamp(target, min=0.0)
    any_reach = torch.any(reached, dim=-1)
    first_idx = torch.argmax(reached.to(torch.uint8), dim=-1)
    val = torch.gather(rev_max, -1, first_idx[:, None])[:, 0]
    val = torch.where(any_reach, val, 0.0)
    return torch.where(s.n_rel > 0, val, 0.0)


def num_ret(s: SortedBatch) -> torch.Tensor:
    return s.n_ret


def num_rel(s: SortedBatch) -> torch.Tensor:
    return s.n_rel


def num_rel_ret(s: SortedBatch) -> torch.Tensor:
    return s.cum_rel[:, -1]


def judged_at(s: SortedBatch, k: int) -> torch.Tensor:
    """Judged@k: fraction of the top k that appears in the qrels (÷ k)."""
    return _per_k(_at_rank(torch.cumsum(s.judged, dim=-1), k), k)


def rbp(s: SortedBatch, p: float) -> torch.Tensor:
    """Rank-biased precision: ``(1-p)·Σ rel_i·p^(i-1)`` (binary relevance)."""
    ranks = _ranks(s.binrel.shape[-1], s.binrel)
    weights = (1.0 - p) * torch.pow(p, ranks - 1.0)
    return torch.sum(s.binrel * weights, dim=-1)


def err_at(s: SortedBatch, k: int) -> torch.Tensor:
    """Expected reciprocal rank at k (cascade model, per-query max grade).

    Slices to the cutoff BEFORE reducing, so the top-k path (d == k) and the
    full-sort path reduce the same k values.
    """
    kk = min(int(k), s.rel.shape[-1])
    g = torch.clamp(s.ideal_rel[:, 0], min=1.0)[:, None]
    rel_k = s.rel[:, :kk]
    stop = ((torch.pow(2.0, torch.clamp(rel_k, min=0.0)) - 1.0)
            / torch.pow(2.0, g))
    no_stop = torch.cumprod(1.0 - stop, dim=-1)
    prior = torch.cat([torch.ones_like(no_stop[:, :1]), no_stop[:, :-1]],
                      dim=-1)
    return torch.sum(stop * prior / _ranks(kk, rel_k), dim=-1)


# ---------------------------------------------------------------------------
# Measure-set plumbing (delegated to the declarative registry).
# ---------------------------------------------------------------------------


def parse_measures(measures: Sequence[str]):
    """Normalize measure strings (either dialect) into (family, params)."""
    return registry.parse_measures(measures)


def family_keys(fam: str, params: Tuple[float, ...]) -> Tuple[str, ...]:
    return registry.family_keys(fam, params)


def measure_keys(measures: Sequence[str]) -> Tuple[str, ...]:
    return registry.measure_keys(measures)


def _mask_queries(out: Dict[str, torch.Tensor],
                  s: SortedBatch) -> Dict[str, torch.Tensor]:
    return {k: torch.where(s.query_mask, v, 0.0) for k, v in out.items()}


def compute_measures(batch: EvalBatch, measures, relevance_level: float = 1.0,
                     judged_only: bool = False) -> Dict[str, torch.Tensor]:
    """Every requested measure for every query: key → ``[Q]`` f32 tensor.

    ``measures`` is the output of :func:`parse_measures`; column dispatch is
    table-driven by :mod:`repro_torch.core.registry`.
    """
    s = sort_batch(batch, relevance_level, judged_only)
    return _mask_queries(registry.apply_columns(s, measures), s)


def compute_measures_topk(batch: EvalBatch, measures,
                          relevance_level: float = 1.0,
                          judged_only: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """Depth-bounded measure computation via the top-k kernel.

    Requires every family in ``measures`` to be depth-bounded and the batch
    to use the tiebreak-column layout (``RelevanceEvaluator.
    batch_from_buffer(..., topk_layout=True)``), under which the kernel's
    smaller-index-wins tie rule IS trec_eval's rule: the selected prefix
    equals the full sort's first k rows.
    """
    from repro_torch.kernels import ops

    depth = registry.topk_depth(measures)
    assert depth is not None, "top-k path needs depth-bounded measures"
    d = batch.scores.shape[1]
    k = min(depth, d)
    eff = batch.mask & batch.judged if judged_only else batch.mask
    scores_m = torch.where(eff, batch.scores, -torch.inf)
    _, idx = ops.topk(scores_m, k)
    idx = idx.to(torch.int64)
    in_range = (idx >= 0) & (idx < d)
    idx_c = torch.clamp(idx, 0, d - 1)
    valid = in_range & torch.gather(eff, -1, idx_c)
    rel_s = torch.where(valid, torch.gather(batch.rel, -1, idx_c), 0.0)
    judged_s = (valid & torch.gather(batch.judged, -1, idx_c)).to(_F32)
    binrel = (rel_s >= relevance_level).to(_F32) * valid
    s = SortedBatch(
        rel=rel_s,
        binrel=binrel,
        judged=judged_s,
        mask=torch.ones_like(rel_s),
        cum_rel=torch.cumsum(binrel, dim=-1),
        ideal_rel=batch.ideal_rel,
        n_rel=batch.n_rel,
        n_judged_nonrel=batch.n_judged_nonrel,
        n_ret=eff.to(_F32).sum(dim=-1),
        query_mask=batch.query_mask,
    )
    return _mask_queries(registry.apply_columns(s, measures), s)


def aggregate(per_query: Dict[str, torch.Tensor],
              query_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Mean over real queries (trec_eval 'all' row)."""
    qm = query_mask.to(_F32)
    n = torch.clamp(qm.sum(), min=1.0)
    return {k: torch.sum(v * qm, dim=-1) / n for k, v in per_query.items()}


def finalize_aggregates(aggs: Dict[str, float]) -> Dict[str, float]:
    """Averaged per-query columns → summary values (``gm_map`` → exp)."""
    return {k: float(np.exp(v)) if k in AGGREGATE_ONLY_MEASURES else v
            for k, v in aggs.items()}


# ---------------------------------------------------------------------------
# Batch construction helpers.
# ---------------------------------------------------------------------------


def batch_from_numpy(fields: Mapping[str, np.ndarray],
                     device=None) -> EvalBatch:
    """An ``EvalBatch`` on ``device`` from per-field numpy arrays.

    ``fields`` maps every EvalBatch field name to an array (for instance
    ``{f: np.asarray(getattr(jax_batch, f)) for f in EvalBatch._fields}``);
    each is cast to the JAX package's dtype (f32 / i32 / bool) on the host,
    so float64 scores become float32 here and tie exactly as they do there.
    """
    dev = resolve_device(device)
    np_dtypes = {torch.float32: np.float32, torch.int32: np.int32,
                 torch.bool: np.bool_}
    return EvalBatch(**{
        name: torch.from_numpy(np.ascontiguousarray(
            fields[name], dtype=np_dtypes[dt])).to(dev)
        for name, dt in BATCH_DTYPES.items()})


def batch_from_flat(*, qidx: np.ndarray, col: np.ndarray, scores: np.ndarray,
                    tiebreak: np.ndarray, rel: np.ndarray, judged: np.ndarray,
                    ideal_rows: np.ndarray, n_rel: np.ndarray,
                    n_judged_nonrel: np.ndarray, n_queries: int, q_pad: int,
                    d_pad: int, j_pad: int, counts: np.ndarray | None = None,
                    device=None) -> EvalBatch:
    """Scatter flat per-document arrays into a padded ``EvalBatch``.

    All per-document vectors are flat (concatenated in query order), with
    ``(qidx, col)`` giving each document's position in the padded
    ``[q_pad, d_pad]`` tensors.  The scatter runs on the host in numpy
    (one fancy-indexed assignment per field, or a reshape when every query
    retrieved the same depth in query-major order); the finished batch then
    moves to ``device`` once.
    """
    scores2 = np.zeros((q_pad, d_pad), dtype=np.float32)
    tiebreak2 = np.zeros((q_pad, d_pad), dtype=np.int32)
    rel2 = np.zeros((q_pad, d_pad), dtype=np.float32)
    judged2 = np.zeros((q_pad, d_pad), dtype=bool)
    mask2 = np.zeros((q_pad, d_pad), dtype=bool)
    total = qidx.shape[0]
    uniform = (counts is not None and n_queries
               and int(counts.min()) == int(counts.max()))
    if uniform:
        # the reshape shortcut assumes query-major flat order; verify it
        d = int(counts[0])
        seq = np.arange(total, dtype=np.int64)
        uniform = (np.array_equal(qidx, seq // d)
                   and np.array_equal(col, seq % d))
    if uniform:
        d = int(counts[0])
        scores2[:n_queries, :d] = scores.reshape(n_queries, d)
        tiebreak2[:n_queries, :d] = tiebreak.reshape(n_queries, d)
        rel2[:n_queries, :d] = rel.reshape(n_queries, d)
        judged2[:n_queries, :d] = judged.reshape(n_queries, d)
        mask2[:n_queries, :d] = True
    else:
        scores2[qidx, col] = scores
        tiebreak2[qidx, col] = tiebreak
        rel2[qidx, col] = rel
        judged2[qidx, col] = judged
        if counts is not None:
            mask2[:n_queries] = (np.arange(d_pad, dtype=np.int64)[None, :]
                                 < counts[:, None])
        else:
            mask2[qidx, col] = True

    ideal = np.zeros((q_pad, j_pad), dtype=np.float32)
    w = min(j_pad, ideal_rows.shape[1])
    ideal[:n_queries, :w] = ideal_rows[:, :w]
    n_rel2 = np.zeros((q_pad,), dtype=np.float32)
    n_rel2[:n_queries] = n_rel
    n_nonrel2 = np.zeros((q_pad,), dtype=np.float32)
    n_nonrel2[:n_queries] = n_judged_nonrel
    qmask = np.zeros((q_pad,), dtype=bool)
    qmask[:n_queries] = True
    return batch_from_numpy(dict(
        scores=scores2, tiebreak=tiebreak2, rel=rel2, judged=judged2,
        mask=mask2, ideal_rel=ideal, n_rel=n_rel2,
        n_judged_nonrel=n_nonrel2, query_mask=qmask), device)


def batch_from_dense(scores: torch.Tensor, rel: torch.Tensor,
                     mask: torch.Tensor | None = None,
                     judged: torch.Tensor | None = None,
                     query_mask: torch.Tensor | None = None,
                     tiebreak: torch.Tensor | None = None,
                     relevance_level: float = 1.0) -> EvalBatch:
    """Build an EvalBatch from dense score/relevance tensors (same device).

    Assumes the candidate set *is* the judged set (in-loop model
    evaluation): the ideal ranking is ``rel`` sorted descending.
    """
    q, d = scores.shape
    dev = scores.device
    if mask is None:
        mask = torch.ones((q, d), dtype=torch.bool, device=dev)
    if judged is None:
        judged = mask
    if query_mask is None:
        query_mask = torch.ones((q,), dtype=torch.bool, device=dev)
    if tiebreak is None:
        tiebreak = torch.arange(d, dtype=torch.int32,
                                device=dev).expand(q, d)
    # unjudged docs are non-relevant by definition (trec_eval)
    rel = rel.to(_F32) * mask * judged
    ideal = torch.sort(rel, dim=-1, descending=True).values
    binrel = (rel >= relevance_level) & mask & judged
    n_rel = binrel.to(_F32).sum(dim=-1)
    n_nonrel = (judged & mask).to(_F32).sum(dim=-1) - n_rel
    return EvalBatch(
        scores=scores.to(_F32), tiebreak=tiebreak.to(torch.int32), rel=rel,
        judged=judged, mask=mask, ideal_rel=ideal, n_rel=n_rel,
        n_judged_nonrel=n_nonrel, query_mask=query_mask)
