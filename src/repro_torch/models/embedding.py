"""EmbeddingBag and field lookups — the recsys sparse front end.

The counterpart of ``repro.models.embedding``.  Tables for the CTR models
are one concatenated ``[Σ vocab_f, dim]`` tensor; field offsets turn
per-field ids into global rows.  Where the JAX package chose the Pallas
kernel with ``use_kernel``, the port chooses by device through
:func:`repro_torch.kernels.ops.embedding_bag` (lookups in any order) and
:func:`repro_torch.kernels.ops.embedding_bag_fixed` (bags of a fixed
length, as multi-hot fields are): a CUDA table launches the hand-written
kernel, a CPU table runs its plain version.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import normal


@dataclasses.dataclass(frozen=True)
class TableConfig:
    n_fields: int
    vocab_per_field: int
    dim: int

    @property
    def total_rows(self) -> int:
        return self.n_fields * self.vocab_per_field


def init_table(gen: torch.Generator | None, cfg: TableConfig,
               dtype=torch.float32, scale: float = 0.01,
               device=None) -> torch.Tensor:
    return normal(gen, (cfg.total_rows, cfg.dim), scale, dtype, device)


def field_lookup(table, ids, cfg: TableConfig) -> torch.Tensor:
    """Single-hot lookup: ids ``[B, n_fields]`` per field → ``[B, n_fields,
    dim]``."""
    offsets = torch.arange(cfg.n_fields, dtype=ids.dtype,
                           device=ids.device) * cfg.vocab_per_field
    rows = ids + offsets[None, :]
    return torch.index_select(table, 0, rows.reshape(-1)).reshape(
        *rows.shape, table.shape[1])


def embedding_bag(table, indices, segment_ids, n_bags: int,
                  weights: Optional[torch.Tensor] = None,
                  combiner: str = "sum") -> torch.Tensor:
    """Bag-combine table rows: ``[L]`` indices into ``[n_bags]`` bags →
    ``[n_bags, dim]``; ``combiner="mean"`` divides by the bag's weight sum
    (its count without weights), at least 1."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got "
                         f"{combiner!r}")
    out = ops.embedding_bag(table, indices, segment_ids, n_bags, weights)
    if combiner == "mean":
        ones = (weights if weights is not None
                else torch.ones(segment_ids.shape, dtype=out.dtype,
                                device=out.device))
        counts = torch.zeros((n_bags,), dtype=out.dtype, device=out.device)
        counts.index_add_(0, segment_ids.long(), ones)
        out = out / torch.clamp(counts, min=1.0)[:, None]
    return out


def multi_hot_lookup(table, ids, mask, cfg: TableConfig, field: int,
                     combiner: str = "sum") -> torch.Tensor:
    """Multi-hot field: ids ``[B, M]`` (padded, mask ``[B, M]``) →
    ``[B, dim]``."""
    b, m = ids.shape
    rows = ids + field * cfg.vocab_per_field
    segs = torch.arange(b, device=ids.device)[:, None].expand(b, m)
    w = mask.reshape(-1).to(table.dtype)
    return embedding_bag(table, rows.reshape(-1), segs.reshape(-1), b,
                         weights=w, combiner=combiner)


def multi_hot_lookup_all(table, ids, mask, cfg: TableConfig,
                         combiner: str = "sum") -> torch.Tensor:
    """Every multi-hot field at once: ids ``[B, F_mh, M]`` (padded, mask
    ``[B, F_mh, M]``) → ``[B, F_mh, dim]``.  Field f is
    :func:`multi_hot_lookup` of field f (its ids offset by
    ``f · vocab_per_field``, each bag summed in lookup order): one kernel
    launch over the ``B · F_mh`` bags, which the layout already groups.
    With grad enabled and a table that requires grad, the call is
    recorded for autograd, and the backward is one launch of the backward
    kernel for every field."""
    if combiner not in ("sum", "mean"):
        raise ValueError(f"combiner must be 'sum' or 'mean', got "
                         f"{combiner!r}")
    b, f, m = ids.shape
    # under autograd a table that trains takes the differentiable entry
    bag = (ops.embedding_bag_fixed_grad
           if torch.is_grad_enabled() and table.requires_grad
           else ops.embedding_bag_fixed)
    out = bag(table, ids.reshape(b * f, m), mask.reshape(b * f, m), fields=f,
              field_rows=cfg.vocab_per_field)
    out = out.reshape(b, f, table.shape[1])
    if combiner == "mean":  # a mask's count is exact in any order
        counts = mask.to(out.dtype).sum(-1, keepdim=True)
        out = out / torch.clamp(counts, min=1.0)
    return out
