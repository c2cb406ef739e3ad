"""Public wrappers over the CUDA kernels, dispatched on the tensor's device.

Where the JAX package chose between a compiled Pallas kernel and its
interpreter (``repro.kernels.ops.INTERPRET``), the port chooses by device:
a CUDA tensor launches the hand-written kernel, a CPU tensor runs the
kernel's plain PyTorch version.  There is no switch and no fallback: a
CUDA kernel that fails to build or launch raises.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import measures as M
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import fused_measures as _fm
from repro_torch.kernels import topk as _topk

FUSED_COLUMNS: Tuple[str, ...] = tuple(_fm.COLUMNS)


def topk(scores: torch.Tensor, k: int):
    """Per-row top-k (values, indices), ties to the lower index."""
    return _topk.topk(scores, k)


def embedding_bag(table: torch.Tensor, indices: torch.Tensor,
                  segment_ids: torch.Tensor, n_bags: int,
                  weights: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted sum of table rows per bag, ``[n_bags, E]`` f32."""
    return _eb.embedding_bag(table, indices, segment_ids, n_bags, weights)


def embedding_bag_fixed(table: torch.Tensor, ids: torch.Tensor,
                        mask: torch.Tensor | None = None, fields: int = 1,
                        field_rows: int = 0) -> torch.Tensor:
    """Masked sum of the rows of fixed-length bags ``ids [N, m]``, bag n's
    ids offset by ``(n % fields) · field_rows``; ``[N, E]`` f32."""
    return _eb.embedding_bag_fixed(table, ids, mask, fields, field_rows)


def embedding_bag_fixed_grad(table: torch.Tensor, ids: torch.Tensor,
                             mask: torch.Tensor | None = None,
                             fields: int = 1,
                             field_rows: int = 0) -> torch.Tensor:
    """:func:`embedding_bag_fixed` with a gradient for ``table`` (the
    backward kernel on CUDA, its plain version on the CPU)."""
    return _eb.embedding_bag_fixed_grad(table, ids, mask, fields, field_rows)


def fused_measures_cols(rel_sorted, judged_sorted, scalars,
                        relevance_level: float = 1.0) -> torch.Tensor:
    """All fused measure columns, ``[Q, 64]`` f32."""
    return _fm.fused_measures(rel_sorted, judged_sorted, scalars,
                              relevance_level=relevance_level)


def make_scalars(n_rel, n_judged_nonrel, ideal_rel) -> torch.Tensor:
    """Pack the per-query ``[Q, 16]`` scalar block the fused kernel reads.

    The ideal DCG sums use the measure core's exact expression
    (``core.measures.ideal_dcg``), so both engines divide by the same
    numbers.
    """
    j = ideal_rel.shape[-1]
    ranks = torch.arange(1, j + 1, dtype=torch.float32,
                         device=ideal_rel.device)
    gains = torch.clamp(ideal_rel, min=0.0) * (1.0 / torch.log2(ranks + 1.0))
    scal = [n_rel, n_judged_nonrel, torch.sum(gains, dim=-1)]
    for k in _fm.CUTOFFS:
        within = (ranks <= k).to(torch.float32)
        scal.append(torch.sum(gains * within, dim=-1))
    out = torch.stack(scal, dim=-1)  # [Q, 12]
    return torch.nn.functional.pad(out, (0, _fm.SCALAR_WIDTH - out.shape[-1]))


def evaluate_fused(batch: M.EvalBatch, relevance_level: float = 1.0,
                   judged_only: bool = False) -> Dict[str, torch.Tensor]:
    """EvalBatch → per-query measures via the fused kernel path.

    Rank with the measure core's sort (exact trec_eval order), then one
    fused pass for all standard columns.  ``judged_only`` (trec_eval
    ``-J``) drops unjudged docs to the tail as inert padding.
    """
    s = M.sort_batch(batch, relevance_level, judged_only)
    scal = make_scalars(batch.n_rel, batch.n_judged_nonrel, batch.ideal_rel)
    cols = fused_measures_cols(s.rel, s.judged, scal,
                               relevance_level=relevance_level)
    qm = batch.query_mask
    return {name: torch.where(qm, cols[:, i], 0.0)
            for i, name in enumerate(FUSED_COLUMNS)}
