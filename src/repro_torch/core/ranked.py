"""Rank-reduction evaluation: measures from judged-document ranks only.

The port of ``repro.core.ranked``.  Every trec_eval measure is a function of
(a) the *ranks of the judged documents* (≤ J per query, typically ≪ D) and
(b) per-query scalars (R, N, n_ret).  Unjudged documents only matter through
how many of them outrank each judged one, so instead of sorting the D-deep
ranking this engine computes

    rank_j = 1 + Σ_d  mask_d · [ s_d > s_j  or  (s_d = s_j and tb_d < tb_j) ]

with one compare-reduce over the scores (IEEE comparisons: ``-0.0 == +0.0``
and the tiebreak decides, as in ``sorting.rank_sort``), and rebuilds every
measure from the ``[Q, J]`` rank matrix with O(J²) pairwise work.

XLA fuses the ``[Q, J, D]`` comparison into its reduction; eager torch
materializes it, so both the compare-reduce and the ``[Q, J, J]`` pairwise
counts run over query chunks sized to keep each intermediate near
``_CHUNK_ELEMS`` elements.  The pairwise counts are broadcast products
summed in float32 (sums of at most J 0/1 terms: exact), not matrix
products, so no result depends on TF32.  The count columns divide exactly
where ``core.measures`` divides (``_safe_div``, ``_per_k``), so they are
bit-identical to the sorted engine.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.core import measures as M

INF_RANK = 2.0**30  # rank assigned to judged docs not retrieved

#: elements of one chunk's [c, J, D] comparison (≈ 256 MiB of bool)
_CHUNK_ELEMS = 1 << 28

_F32 = torch.float32


class RankedBatch(NamedTuple):
    """Inputs for rank-reduction evaluation (axes: Q queries, D docs in the
    run, J judged docs per query — all padded)."""

    scores: torch.Tensor  # [Q, D] f32 — retrieval scores of the run
    tiebreak: torch.Tensor  # [Q, D] i32 — trec_eval tie order (smaller wins)
    mask: torch.Tensor  # [Q, D] bool — real run entries
    judged_scores: torch.Tensor  # [Q, J] f32 — scores of judged docs in run
    judged_tiebreak: torch.Tensor  # [Q, J] i32
    judged_rel: torch.Tensor  # [Q, J] f32 — relevance judgments
    judged_retrieved: torch.Tensor  # [Q, J] bool — judged doc is in the run
    judged_mask: torch.Tensor  # [Q, J] bool — real judged entries
    ideal_rel: torch.Tensor  # [Q, J'] f32 — qrel judgments sorted desc
    n_rel: torch.Tensor  # [Q] f32
    n_judged_nonrel: torch.Tensor  # [Q] f32
    query_mask: torch.Tensor  # [Q] bool


def from_eval_batch(batch: M.EvalBatch, j: int | None = None) -> RankedBatch:
    """Build a RankedBatch from a dense EvalBatch.

    The judged retrieved documents come first, each group in column order
    (what ``lax.top_k`` of the JAX package's judged-key-plus-ramp picks);
    the first ``j`` (default: the ideal-gain width) are kept.
    """
    j = j or batch.ideal_rel.shape[-1]
    judged = batch.judged & batch.mask
    idx = torch.sort(judged.to(torch.uint8), dim=-1, descending=True,
                     stable=True).indices[:, :j]

    def take(a):
        return torch.gather(a, -1, idx)

    judged_mask = take(judged)
    return RankedBatch(
        scores=batch.scores, tiebreak=batch.tiebreak, mask=batch.mask,
        judged_scores=take(batch.scores),
        judged_tiebreak=take(batch.tiebreak),
        judged_rel=take(batch.rel) * judged_mask,
        judged_retrieved=judged_mask,
        judged_mask=judged_mask,
        ideal_rel=batch.ideal_rel,
        n_rel=batch.n_rel, n_judged_nonrel=batch.n_judged_nonrel,
        query_mask=batch.query_mask)


def _chunk_rows(rb: RankedBatch) -> int:
    q, d = rb.scores.shape
    j = max(rb.judged_scores.shape[-1], 1)
    return max(1, min(q, _CHUNK_ELEMS // (j * max(d, j))))


def _rows(rb: RankedBatch, lo: int, hi: int) -> RankedBatch:
    return RankedBatch(*(f[lo:hi] for f in rb))


def _judged_ranks(rb: RankedBatch) -> torch.Tensor:
    s = rb.scores[:, None, :]
    tb = rb.tiebreak[:, None, :]
    js = rb.judged_scores[:, :, None]
    jtb = rb.judged_tiebreak[:, :, None]
    above = (s > js) | ((s == js) & (tb < jtb))
    above &= rb.mask[:, None, :]
    ranks = 1.0 + above.sum(dim=-1, dtype=torch.int32).to(_F32)
    return torch.where(rb.judged_retrieved, ranks, INF_RANK)


def judged_ranks(rb: RankedBatch) -> torch.Tensor:
    """[Q, J] 1-based ranks of judged docs in the run (INF if unretrieved)."""
    step = _chunk_rows(rb)
    return torch.cat([_judged_ranks(_rows(rb, lo, lo + step))
                      for lo in range(0, max(rb.scores.shape[0], 1), step)])


def compute_measures_ranked(
    rb: RankedBatch,
    measures: Tuple[Tuple[str, Tuple[float, ...]], ...],
    relevance_level: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Same contract as ``measures.compute_measures``, via rank reduction."""
    step = _chunk_rows(rb)
    q = rb.scores.shape[0]
    parts = [_ranked_chunk(_rows(rb, lo, lo + step), measures,
                           relevance_level) for lo in range(0, max(q, 1), step)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _ranked_chunk(rb: RankedBatch, measures, relevance_level: float
                  ) -> Dict[str, torch.Tensor]:
    ranks = _judged_ranks(rb)  # [Q, J]
    jm = rb.judged_mask.to(_F32)
    retrieved = rb.judged_retrieved.to(_F32) * jm
    rel = (rb.judged_rel >= relevance_level).to(_F32) * jm
    rel_ret = rel * retrieved
    nonrel_ret = (1.0 - rel) * retrieved  # judged non-relevant, retrieved
    gains = torch.clamp(rb.judged_rel, min=0.0) * jm

    n_ret = rb.mask.to(_F32).sum(dim=-1)
    r = rb.n_rel

    # pairwise [Q, J, J]: how many judged-X docs rank at-or-above each doc
    le = (ranks[:, :, None] <= ranks[:, None, :]).to(_F32)
    lt = (ranks[:, :, None] < ranks[:, None, :]).to(_F32)
    # cnt_i = #rel-retrieved docs with rank ≤ rank_i (includes self if rel)
    cnt = (rel_ret[:, :, None] * le).sum(dim=1)
    nonrel_above = (nonrel_ret[:, :, None] * lt).sum(dim=1)

    finite = ranks < INF_RANK
    prec_at_i = torch.where(finite, cnt / torch.clamp(ranks, min=1.0), 0.0)
    log_disc = torch.log2(torch.clamp(ranks, max=INF_RANK) + 1.0)

    out: Dict[str, torch.Tensor] = {}

    def rel_in_top(k):
        return (rel_ret * (ranks <= k)).sum(dim=-1)

    for fam, params in measures:
        if fam == "map":
            out["map"] = M._safe_div((rel_ret * prec_at_i).sum(dim=-1), r)
        elif fam == "map_cut":
            for k in params:
                apk = (rel_ret * prec_at_i * (ranks <= k)).sum(dim=-1)
                out[f"map_cut_{int(k)}"] = M._safe_div(apk, r)
        elif fam == "ndcg":
            dcg = (gains * retrieved / log_disc).sum(dim=-1)
            out["ndcg"] = M._safe_div(dcg, _ideal_dcg(rb, None))
        elif fam == "ndcg_cut":
            for k in params:
                dcg = (gains * retrieved * (ranks <= k) / log_disc
                       ).sum(dim=-1)
                out[f"ndcg_cut_{int(k)}"] = M._safe_div(
                    dcg, _ideal_dcg(rb, int(k)))
        elif fam == "P":
            for k in params:
                out[f"P_{int(k)}"] = M._per_k(rel_in_top(k), int(k))
        elif fam == "recall":
            for k in params:
                out[f"recall_{int(k)}"] = M._safe_div(rel_in_top(k), r)
        elif fam == "success":
            for k in params:
                out[f"success_{int(k)}"] = (rel_in_top(k) > 0).to(_F32)
        elif fam == "recip_rank":
            first = torch.where(rel_ret > 0, ranks, INF_RANK).amin(dim=-1)
            out["recip_rank"] = torch.where(first < INF_RANK, 1.0 / first,
                                            0.0)
        elif fam == "Rprec":
            out["Rprec"] = M._safe_div(
                (rel_ret * (ranks <= r[:, None])).sum(dim=-1), r)
        elif fam == "bpref":
            denom = torch.minimum(r, rb.n_judged_nonrel)[:, None]
            bounded = torch.minimum(nonrel_above, r[:, None])
            term = torch.where(nonrel_above > 0,
                               1.0 - M._safe_div(bounded, denom), 1.0)
            out["bpref"] = M._safe_div((term * rel_ret).sum(dim=-1), r)
        elif fam == "iprec_at_recall":
            for lv in params:
                target = torch.ceil(lv * r)[:, None]
                ok = (cnt >= torch.clamp(target, min=0.0)) & (rel_ret > 0)
                val = torch.where(ok, prec_at_i, 0.0).amax(dim=-1)
                out[f"iprec_at_recall_{lv:.2f}"] = torch.where(r > 0, val,
                                                               0.0)
        elif fam == "num_ret":
            out["num_ret"] = n_ret
        elif fam == "num_rel":
            out["num_rel"] = r
        elif fam == "num_rel_ret":
            out["num_rel_ret"] = rel_ret.sum(dim=-1)
        elif fam == "judged":
            # every doc in the top k that is judged IS a row of this matrix
            for k in params:
                out[f"judged_{int(k)}"] = M._per_k(
                    (retrieved * (ranks <= k)).sum(dim=-1), int(k))
        elif fam == "rbp":
            for p in params:
                w = torch.pow(p, torch.clamp(ranks, max=INF_RANK) - 1.0)
                out[f"rbp_{p:.2f}"] = (1.0 - p) * (rel_ret * w).sum(dim=-1)
        elif fam == "err":
            # cascade model: unjudged docs have stop probability 0, so the
            # prior over each judged doc is the product over the *judged*
            # docs ranked above it — a [Q, J, J] pairwise log-sum
            g = torch.clamp(rb.ideal_rel[:, 0], min=1.0)[:, None]
            stop = ((torch.pow(2.0, torch.clamp(rb.judged_rel, min=0.0))
                     - 1.0) / torch.pow(2.0, g) * retrieved)
            log_keep = torch.log1p(-stop)
            prior = torch.exp((log_keep[:, :, None] * lt).sum(dim=1))
            term = stop * prior / torch.clamp(ranks, min=1.0)
            for k in params:
                out[f"err_{int(k)}"] = (term * (ranks <= k)).sum(dim=-1)
        else:  # pragma: no cover
            raise ValueError(fam)
    return {k: torch.where(rb.query_mask, v, 0.0) for k, v in out.items()}


def _ideal_dcg(rb: RankedBatch, k: int | None) -> torch.Tensor:
    """Ideal DCG from the full qrel judgments (already sorted descending)."""
    ideal = torch.clamp(rb.ideal_rel, min=0.0)
    j = ideal.shape[-1]
    ranks = torch.arange(1, j + 1, dtype=_F32, device=ideal.device)
    disc = 1.0 / torch.log2(ranks + 1.0)
    if k is not None:
        disc = disc * (ranks <= k)
    return (ideal * disc).sum(dim=-1)
