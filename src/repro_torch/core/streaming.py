"""Streaming evaluation: metrics as (sum, count) sufficient statistics.

The port's slice of ``repro.core.streaming``: the two functions the fused
(sharded) evaluator needs, on one device.  Every trec_eval measure is a
per-query scalar, so the sufficient statistic for the corpus mean is just
(sum, count).
"""

from __future__ import annotations

from typing import Dict

import torch

MetricState = Dict[str, torch.Tensor]  # keys + "__count"


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


def metric_finalize(state: MetricState) -> Dict[str, torch.Tensor]:
    """Means over all accumulated queries."""
    denom = torch.clamp(state["__count"], min=1.0)
    return {k: v / denom for k, v in state.items() if k != "__count"}
