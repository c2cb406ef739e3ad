"""EmbeddingBag and field lookups — the recsys sparse front end.

The counterpart of ``repro.models.embedding``.  Tables for the CTR models
are one concatenated ``[Σ vocab_f, dim]`` tensor; field offsets turn
per-field ids into global rows.  Where the JAX package chose the Pallas
kernel with ``use_kernel``, the port chooses by device through
:func:`repro_torch.kernels.ops.embedding_bag` (lookups in any order) and
:func:`repro_torch.kernels.ops.embedding_bag_fixed` (bags of a fixed
length, as multi-hot fields are): a CUDA table launches the hand-written
kernel, a CPU table runs its plain version.

Vocab-parallel tables.  On a mesh a table is row-sharded over ``model``
(``RecSysSharding.p_table``): :class:`VocabParallel` holds a rank's block
of rows.  A lookup is JAX's "local gather + masked psum" (which GSPMD
forms for ``jnp.take`` on such a table): each rank launches B3
(``ops.embedding_bag_fixed``) on its own block, with the ids shifted by
the block's first row and a zero weight for every row it does not hold,
then the partial sums are summed over ``model``.  :func:`field_lookup`
and :func:`multi_hot_lookup_all` take such a table in place of a tensor;
``mean`` divides by the whole bag's count after the sum.  A zero weight
times a non-finite row is NaN, so a lookup a rank does not hold reads a
row of its bag that the rank does hold (see :meth:`VocabParallel.partial`).

A trainable block (``local``: a leaf that requires grad, as
``sharding.leaf_block`` makes) is looked up through
``ops.embedding_bag_fixed_grad`` under autograd: B3 forward, B3-bwd on
the rank's rows backward (a lookup it does not hold has mask 0 and adds
nothing; a bag with none gets a zero gradient through the
``torch.where``), and the sum over ``model`` passes the whole cotangent
to each rank's partial sums (``spmd.psum``'s backward).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
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


class VocabParallel:
    """Rows ``[row0, row0 + V_loc)`` of a ``[V, E]`` float32 table split
    over ``axis`` of ``mesh`` (torch.chunk's rule), as this rank's block
    ``local``.  With ``blocks`` each rank's lookups are its own block of
    a list split evenly over ``axis`` (a candidate set) instead of the
    same on every rank: :meth:`lookup` then all-gathers them, takes every
    rank's partial rows and reduce-scatters the sums back."""

    def __init__(self, table: torch.Tensor, mesh, axis: str = "model",
                 blocks: bool = False, local: torch.Tensor | None = None):
        self.blocks = blocks
        spec = (axis, None)
        self.rows = table.shape[0]
        self.dim = table.shape[1]
        self.row0 = SH.local_bounds(table.shape, spec, mesh)[0][0]
        self.local = (SH.local_input(table, spec, mesh).detach()
                      if local is None else local)
        self.mesh, self.axis = mesh, axis

    @property
    def dtype(self):
        return self.local.dtype

    @property
    def device(self):
        return self.local.device

    def local_ids(self, rows: torch.Tensor, mask=None):
        """B3's inputs for the bags ``rows [N, m]`` (global rows, bool
        ``mask`` or all 1) on this block: (int32 ids into the block, the
        lookups it holds as the mask, whether each bag holds one ``[N,
        1]``).  A lookup it does not hold reads the bag's first held row
        with weight 0, so a non-finite row of the block reaches only the
        bags that hold it; in a bag with none held, the lookups read rows
        spread over the block (the bag is set to 0 after the kernel), so
        that B3-bwd, which walks the lookups of each row in turn, meets no
        long run of one row."""
        n_loc = self.local.shape[0]
        hit = (rows >= self.row0) & (rows < self.row0 + n_loc)
        if mask is not None:
            hit &= mask
        local = rows - self.row0
        held = hit.any(-1, keepdim=True)
        first = torch.gather(local, -1, hit.to(torch.uint8).argmax(
            -1, keepdim=True))
        spread = torch.arange(rows.numel(), device=rows.device).reshape(
            rows.shape) % max(n_loc, 1)
        fill = torch.where(held, first, spread)
        ids = torch.where(hit, local, fill).to(torch.int32)
        return ids.contiguous(), hit.contiguous(), held

    def partial(self, rows: torch.Tensor, mask=None) -> torch.Tensor:
        """This rank's share of the bags ``rows [N, m]`` (global rows,
        bool ``mask`` or all 1): B3 on the rows it holds
        (:meth:`local_ids`), 0 elsewhere."""
        ids, hit, held = self.local_ids(rows, mask)
        bag = (ops.embedding_bag_fixed_grad
               if torch.is_grad_enabled() and self.local.requires_grad
               else ops.embedding_bag_fixed)
        out = bag(self.local, ids, hit)
        return torch.where(held, out, torch.zeros_like(out))

    def lookup(self, rows: torch.Tensor, mask=None) -> torch.Tensor:
        """Bag sums ``[N, E]`` of ``rows [N, m]``: the partial sums summed
        over ``axis`` (with ``blocks``: :meth:`lookup_blocks`)."""
        if self.blocks:
            return self.lookup_blocks(rows, mask)
        return spmd.psum(self.partial(rows, mask), self.mesh, self.axis)

    def lookup_blocks(self, rows: torch.Tensor, mask=None) -> torch.Tensor:
        """Bag sums of ``rows [N_loc, m]``, this rank's block of bags split
        evenly over ``axis`` (a candidate set): every rank's bags
        all-gathered, their partial sums, one reduce-scatter back."""
        every = spmd.all_gather(rows, 0, self.mesh, self.axis)
        if mask is not None:
            mask = spmd.all_gather(mask, 0, self.mesh, self.axis)
        return spmd.psum_scatter(self.partial(every, mask), 0, self.mesh,
                                 self.axis)


def init_table(gen: torch.Generator | None, cfg: TableConfig,
               dtype=torch.float32, scale: float = 0.01,
               device=None) -> torch.Tensor:
    return normal(gen, (cfg.total_rows, cfg.dim), scale, dtype, device)


def field_lookup(table, ids, cfg: TableConfig) -> torch.Tensor:
    """Single-hot lookup: ids ``[B, n_fields]`` per field → ``[B, n_fields,
    dim]`` (a :class:`VocabParallel` table: one B3 launch a rank)."""
    offsets = torch.arange(cfg.n_fields, dtype=ids.dtype,
                           device=ids.device) * cfg.vocab_per_field
    rows = ids + offsets[None, :]
    if isinstance(table, VocabParallel):
        return table.lookup(rows.reshape(-1, 1)).reshape(*rows.shape,
                                                          table.dim)
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
    if isinstance(table, VocabParallel):
        offsets = torch.arange(f, dtype=ids.dtype,
                               device=ids.device) * cfg.vocab_per_field
        rows = (ids + offsets[None, :, None]).reshape(b * f, m)
        out = table.lookup(rows, mask.reshape(b * f, m)).reshape(
            b, f, table.dim)
        if combiner == "mean":  # the whole bag's count, after the sum
            counts = mask.to(out.dtype).sum(-1, keepdim=True)
            out = out / torch.clamp(counts, min=1.0)
        return out
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
