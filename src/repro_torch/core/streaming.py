"""Streaming (in-loop) evaluation: metrics as (sum, count) sufficient statistics.

The port of ``repro.core.streaming``.  Every trec_eval measure is a
per-query scalar, so the sufficient statistic for the corpus mean is just
(sum, count): each step adds its queries' sums, one division at the end;
shards add their states (:func:`metric_merge` in one process, one
``all_reduce`` in :func:`metric_finalize` over a process group).

Usage inside a loop::

    state = metric_init(("ndcg", "recip_rank"), device="cuda")
    ...
    state = metric_update(state, batch, ("ndcg", "recip_rank"))
    ...
    means = metric_finalize(state)               # dict of scalars

The state lives on the batches' device; nothing is copied to the host until
the caller reads the means.  :func:`rank_metrics` gives the GNN (and LM)
train steps' metrics from gold ranks (``core.sorting.gold_rank``), with no
sort.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core import measures as M
from repro_torch.device import resolve_device

MetricState = Dict[str, torch.Tensor]  # keys + "__count"


def metric_init(measure_names: Tuple[str, ...], device=None) -> MetricState:
    """Zero (sum, count) state for every output key of ``measure_names``.

    >>> sorted(metric_init(("P_5", "map"), device="cpu"))
    ['P_5', '__count', 'map']
    """
    dev = resolve_device(device)
    keys = M.measure_keys(measure_names)
    state = {k: torch.zeros((), dtype=torch.float32, device=dev)
             for k in keys}
    state["__count"] = torch.zeros((), dtype=torch.float32, device=dev)
    return state


def metric_update(
    state: MetricState,
    batch: M.EvalBatch,
    measure_names: Tuple[str, ...],
    relevance_level: float = 1.0,
) -> MetricState:
    """Add one batch's per-query measures (full sort + measure core)."""
    parsed = M.parse_measures(measure_names)
    per_query = M.compute_measures(batch, parsed, relevance_level)
    qm = batch.query_mask.to(torch.float32)
    new = dict(state)
    for k, v in per_query.items():
        new[k] = state[k] + torch.sum(v * qm)
    new["__count"] = state["__count"] + torch.sum(qm)
    return new


def metric_update_run(
    state: MetricState,
    evaluator,
    buf,
    scores,
    measure_names: Tuple[str, ...],
    relevance_level: float | None = None,
) -> MetricState:
    """In-loop update from a pre-tokenized ``RunBuffer`` + fresh scores.

    The session fast path for evaluating the *same* collection every step:
    the buffer paid the string cost once; each step here is a numeric
    scatter (``evaluator.batch_from_buffer``) plus the measure core on the
    evaluator's device.  ``scores`` is the flat per-document score array in
    the buffer's query order.  ``relevance_level`` defaults to the
    evaluator's own level, at which the buffer's qrel-side statistics were
    counted.
    """
    if relevance_level is None:
        relevance_level = evaluator.relevance_level
    batch = evaluator.batch_from_buffer(buf, scores)
    return metric_update(state, batch, measure_names, relevance_level)


def metric_update_cols(state: MetricState,
                       per_query: Dict[str, torch.Tensor],
                       query_mask: torch.Tensor) -> MetricState:
    """Accumulate precomputed per-query ``[Q]`` vectors into a MetricState.

    Every key in ``state`` except ``"__count"`` must be present in
    ``per_query``; padded queries are excluded via ``query_mask``.
    """
    qm = query_mask.to(torch.float32)
    new = dict(state)
    for k in state:
        if k == "__count":
            continue
        new[k] = state[k] + torch.sum(per_query[k] * qm)
    new["__count"] = state["__count"] + torch.sum(qm)
    return new


def metric_merge(states: Sequence[MetricState], device) -> MetricState:
    """Several states' (sum, count) added in order on ``device``: the
    shards of one evaluation, reduced in one process.

    >>> a = {"map": torch.tensor(1.5), "__count": torch.tensor(2.0)}
    >>> b = {"map": torch.tensor(0.5), "__count": torch.tensor(1.0)}
    >>> {k: float(v) for k, v in metric_merge([a, b], "cpu").items()}
    {'map': 2.0, '__count': 3.0}
    """
    total = {k: v.to(device) for k, v in states[0].items()}
    for state in states[1:]:
        total = {k: v + state[k].to(device) for k, v in total.items()}
    return total


def metric_finalize(state: MetricState,
                    group=None) -> Dict[str, torch.Tensor]:
    """Means over all accumulated queries.

    With a ``torch.distributed`` process group, every rank's (sum, count)
    is first summed over the group by one ``all_reduce`` of the stacked
    ``[sums..., count]`` vector: the torch form of the JAX package's
    ``psum`` over ``axis_name``.  Every rank gets the same means.
    """
    if group is not None:
        import torch.distributed as dist

        keys = list(state)
        vec = torch.stack([state[k] for k in keys])
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=group)
        state = dict(zip(keys, vec.unbind()))
    denom = torch.clamp(state["__count"], min=1.0)
    return {k: v / denom for k, v in state.items() if k != "__count"}


# ---------------------------------------------------------------------------
# Cheap in-loop metrics from gold ranks (GNN / LM / sequential recsys path).
# ---------------------------------------------------------------------------


def rank_metrics(gold_ranks: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 ks: Tuple[int, ...] = (1, 5, 10),
                 reduce=None) -> Dict[str, torch.Tensor]:
    """MRR, NDCG and success@k from 1-based gold-item ranks (no sort).

    The single-relevant-document case of trec_eval's measures:
    ``recip_rank == 1/rank``, ``success_k == rank <= k``,
    ``ndcg == 1/log2(rank+1)``; means over the entries ``mask`` keeps (at
    least 1).  Used for the next-item / node-class evaluation fused into
    the train step.  ``reduce``: a function of the stacked sums (the
    measures' and the count), applied before the division (a sharded
    step's sum over its ranks).

    >>> r = rank_metrics(torch.tensor([1, 2, 20]))
    >>> round(float(r["recip_rank"]), 4), float(r["success_5"])
    (0.5167, 0.6666666865348816)
    """
    r = gold_ranks.to(torch.float32)
    if mask is None:
        mask = torch.ones_like(r, dtype=torch.bool)
    m = mask.to(torch.float32)
    sums = {"recip_rank": torch.sum(m / r),
            "ndcg": torch.sum(m / torch.log2(r + 1.0))}
    for k in ks:
        sums[f"success_{k}"] = torch.sum(m * (r <= k))
    count = torch.sum(m)
    if reduce is not None:
        total = reduce(torch.stack(list(sums.values()) + [count]))
        sums = dict(zip(sums, total[:-1]))
        count = total[-1]
    n = torch.clamp(count, min=1.0)
    return {k: v / n for k, v in sums.items()}
