"""Oracles for the kernels, independent of their plain versions.

``topk_ref`` orders on the host with numpy's lexsort; ``fused_measures_ref``
rebuilds every fused column from the measure core's column functions;
``embedding_bag_ref`` and ``embedding_bag_fixed_ref`` sum each bag on the
host in float64.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import measures as M
from repro_torch.kernels import fused_measures as FM


def topk_ref(scores: torch.Tensor, k: int):
    """Top-k by (value desc, index asc), padded with -inf / zero indices.

    ``-0.0`` and ``+0.0`` compare equal here (numpy's float comparison),
    as in the kernel.
    """
    s = scores.detach().cpu().numpy().astype(np.float32)
    q, d = s.shape
    cols = np.broadcast_to(np.arange(d), (q, d))
    order = np.lexsort((cols, -s), axis=-1)[:, :k]
    vals = np.take_along_axis(s, order, axis=-1)
    idx = order.astype(np.int32)
    if k > d:
        vals = np.concatenate([vals, np.full((q, k - d), -np.inf,
                                             np.float32)], -1)
        idx = np.concatenate([idx, np.zeros((q, k - d), np.int32)], -1)
    return (torch.from_numpy(vals).to(scores.device),
            torch.from_numpy(idx).to(scores.device))


def fused_measures_ref(rel_sorted, judged_sorted, scalars,
                       relevance_level: float = 1.0) -> torch.Tensor:
    """Column-for-column oracle of the fused kernel via ``core.measures``."""
    q, d = rel_sorted.shape
    binrel = (rel_sorted >= relevance_level).to(torch.float32)
    s = M.SortedBatch(
        rel=rel_sorted,
        binrel=binrel,
        judged=judged_sorted,
        mask=torch.ones_like(rel_sorted),
        cum_rel=torch.cumsum(binrel, dim=-1),
        ideal_rel=torch.zeros((q, 1), device=rel_sorted.device),
        n_rel=scalars[:, 0],
        n_judged_nonrel=scalars[:, 1],
        n_ret=torch.full((q,), float(d), device=rel_sorted.device),
        query_mask=torch.ones((q,), dtype=torch.bool,
                              device=rel_sorted.device),
    )
    cols = {
        "map": M.average_precision(s),
        "recip_rank": M.reciprocal_rank(s),
        "ndcg": M._safe_div(M.dcg(s), scalars[:, 2]),
        "bpref": M.bpref(s),
        "num_rel_ret": s.cum_rel[:, -1],
        "Rprec": M.r_precision(s),
    }
    for j, k in enumerate(FM.CUTOFFS):
        cols[f"P_{k}"] = M.precision_at(s, k)
        cols[f"recall_{k}"] = M.recall_at(s, k)
        cols[f"map_cut_{k}"] = M.map_cut(s, k)
        cols[f"ndcg_cut_{k}"] = M._safe_div(M.dcg(s, k), scalars[:, 3 + j])
        cols[f"judged_{k}"] = M.judged_at(s, k)
    for k in FM.SUCCESS_CUTOFFS:
        cols[f"success_{k}"] = M.success_at(s, k)
    cols[f"rbp_{FM.DEFAULT_RBP_P:.2f}"] = M.rbp(s, FM.DEFAULT_RBP_P)
    out = torch.stack([cols[name] for name in FM.COLUMNS], dim=-1)
    return torch.nn.functional.pad(out, (0, FM.OUT_WIDTH - out.shape[-1]))


def embedding_bag_ref(table, indices, segment_ids, n_bags, weights=None):
    """Per-bag weighted row sums with ``np.add.at`` in float64, rounded
    to f32 once: within f32 rounding of the kernel, not bit-identical."""
    tab = table.detach().cpu().numpy().astype(np.float64)
    idx = indices.detach().cpu().numpy().astype(np.int64)
    seg = segment_ids.detach().cpu().numpy().astype(np.int64)
    rows = tab[idx]
    if weights is not None:
        w = weights.detach().cpu().numpy().astype(np.float64)
        rows = rows * w[:, None]
    out = np.zeros((n_bags, tab.shape[1]), np.float64)
    np.add.at(out, seg, rows)
    return torch.from_numpy(out.astype(np.float32)).to(table.device)


def embedding_bag_fixed_ref(table, ids, mask=None, fields=1,
                            field_rows=0):
    """Fixed-length bags ``ids [N, m]`` (bag n's ids offset by
    ``(n % fields) · field_rows``, lookups weighed by ``mask``) summed in
    float64 on the host, rounded to f32 once: within f32 rounding of the
    kernel, not bit-identical."""
    tab = table.detach().cpu().numpy().astype(np.float64)
    rows = ids.detach().cpu().numpy().astype(np.int64)
    n = rows.shape[0]
    rows = rows + (np.arange(n) % fields * field_rows)[:, None]
    x = tab[rows]  # [N, m, E]
    if mask is not None:
        with np.errstate(invalid="ignore"):  # inf · 0 is NaN, as on the card
            x = x * mask.detach().cpu().numpy().astype(np.float64)[..., None]
    out = x.sum(axis=1) if rows.shape[1] else np.zeros((n, tab.shape[1]))
    return torch.from_numpy(out.astype(np.float32)).to(table.device)
