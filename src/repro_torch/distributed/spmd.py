"""Rank-local collectives over the named axes of a ``DeviceMesh``.

The torch form of the collectives a JAX ``shard_map`` body calls
(``lax.psum``, ``lax.pmax``, ``lax.all_gather(..., tiled=True)``,
``lax.psum_scatter(..., tiled=True)``, ``lax.axis_index``): the sharded
model code runs on each rank's local tensors and calls these with the
mesh and an axis name (or a tuple of names: the axes in turn, the first
one major).  ``mesh=None`` means one device: every collective is the
identity, every axis has size 1.  An axis of size 1 runs no collective.

Under autograd each collective has the backward that JAX's autodiff
takes of it: ``all_gather`` and ``psum_scatter`` are each other's
transpose, a ``psum`` (which completes partial sums that every rank then
uses alike) passes the cotangent through, and :func:`fan_out` (identity
forward) sums the cotangent of a replicated tensor that enters work each
rank does on its own block.

Every collective, forward or backward, is recorded in the active
:class:`CollectiveLog`, if any, by its local result bytes (a
reduce-scatter's scaled by its group size, as
``repro.analysis.hlo.collective_bytes`` counts XLA's): the dry run's
per-device collective traffic.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch
import torch.distributed as dist

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")

_LOGS: list = []


class CollectiveLog:
    """Bytes per collective kind while active."""

    def __init__(self):
        self.bytes: Dict[str, float] = {k: 0.0 for k in KINDS}
        self.count = 0

    def record(self, kind: str, nbytes: int) -> None:
        self.bytes[kind] += nbytes
        self.count += 1

    def summary(self) -> Dict[str, float]:
        out = dict(self.bytes)
        out["count"] = self.count
        out["total"] = sum(self.bytes[k] for k in KINDS)
        return out


@contextlib.contextmanager
def collective_log():
    log = CollectiveLog()
    _LOGS.append(log)
    try:
        yield log
    finally:
        _LOGS.remove(log)


def record(kind: str, nbytes: int) -> None:
    """Count a collective of ``nbytes`` local result bytes (a
    reduce-scatter's scaled by its group size), also one made outside
    this module."""
    for log in _LOGS:
        log.record(kind, int(nbytes))


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_INPUT_LOGS: list = []


@contextlib.contextmanager
def input_log():
    """``{id(step input): bytes of this rank's block}`` for each input a
    step cut to its block while active (the dry run's argument bytes)."""
    seen: Dict[int, int] = {}
    _INPUT_LOGS.append(seen)
    try:
        yield seen
    finally:
        _INPUT_LOGS.remove(seen)


def note_input(full, block: torch.Tensor) -> None:
    for seen in _INPUT_LOGS:
        seen[id(full)] = block.numel() * block.element_size()


def _names(axes):
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_size(mesh, axes) -> int:
    if mesh is None:
        return 1
    n = 1
    for name in _names(axes):
        n *= mesh.size(tuple(mesh.mesh_dim_names).index(name))
    return n


def axis_index(mesh, axes) -> int:
    """This rank's index along ``axes`` (row-major over a tuple)."""
    if mesh is None:
        return 0
    i = 0
    for name in _names(axes):
        i = i * axis_size(mesh, name) + mesh.get_local_rank(name)
    return i


def _live(mesh, axes):
    return [n for n in _names(axes) if axis_size(mesh, n) > 1]


def _psum(x, mesh, live, red):
    x = x.contiguous().clone()
    for name in live:
        record("all-reduce", _nbytes(x))
        dist.all_reduce(x, op=red, group=mesh.get_group(name))
    return x


def _all_gather(x, dim, mesh, live):
    for name in reversed(live):  # minor axis first: blocks stay in order
        m = axis_size(mesh, name)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((m * src.shape[0],) + tuple(src.shape[1:]))
        record("all-gather", _nbytes(out))
        dist.all_gather_into_tensor(out, src, group=mesh.get_group(name))
        x = out.movedim(0, dim)
    return x


def _psum_scatter(x, dim, mesh, live):
    for name in live:  # major axis first: the transpose of _all_gather
        m = axis_size(mesh, name)
        if x.shape[dim] % m:
            raise ValueError(f"dimension {dim} of {tuple(x.shape)} does "
                             f"not split over {m} ranks")
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // m,) + tuple(src.shape[1:]))
        record("reduce-scatter", _nbytes(out) * m)
        dist.reduce_scatter_tensor(out, src, group=mesh.get_group(name))
        x = out.movedim(0, dim)
    return x


class _Sum(torch.autograd.Function):
    """A sum that completes partial sums: every rank then uses the whole
    value alike, so each partial's gradient is the whole cotangent
    (JAX's transpose of ``psum`` inside ``shard_map``)."""

    @staticmethod
    def forward(ctx, x, mesh, live):
        return _psum(x, mesh, live, dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _FanOut(torch.autograd.Function):
    """Identity forward; the cotangent summed over the axes (Megatron's
    ``f``: a value replicated over them enters work that differs by
    rank, so each rank's gradient is a partial one)."""

    @staticmethod
    def forward(ctx, x, mesh, live):
        ctx.mesh, ctx.live = mesh, live
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _psum(g, ctx.mesh, ctx.live, dist.ReduceOp.SUM), None, None


class _AllGather(torch.autograd.Function):
    """Tiled all-gather; its transpose is the reduce-scatter."""

    @staticmethod
    def forward(ctx, x, dim, mesh, live):
        ctx.dim, ctx.mesh, ctx.live = dim, mesh, live
        return _all_gather(x, dim, mesh, live)

    @staticmethod
    def backward(ctx, g):
        return _psum_scatter(g, ctx.dim, ctx.mesh, ctx.live), None, None, \
            None


class _PsumScatter(torch.autograd.Function):
    """Tiled reduce-scatter; its transpose is the all-gather."""

    @staticmethod
    def forward(ctx, x, dim, mesh, live):
        ctx.dim, ctx.mesh, ctx.live = dim, mesh, live
        return _psum_scatter(x, dim, mesh, live)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g.contiguous(), ctx.dim, ctx.mesh, ctx.live), \
            None, None, None


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def psum(x: torch.Tensor, mesh, axes, op: str = "sum") -> torch.Tensor:
    """``lax.psum`` (``op="max"``: ``lax.pmax``) of ``x`` over ``axes``;
    returns a new tensor, ``x`` is left as it was.  Under autograd a sum
    takes the identity backward (:class:`_Sum`); a max has none."""
    live = _live(mesh, axes)
    if not live:
        return x
    if op == "sum":
        if _tracked(x):
            return _Sum.apply(x, mesh, live)
        return _psum(x, mesh, live, dist.ReduceOp.SUM)
    return _psum(x.detach(), mesh, live, dist.ReduceOp.MAX)


def fan_out(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """``x`` itself, with its gradient summed over ``axes`` in backward:
    the step where a tensor replicated over ``axes`` enters work that
    each rank does on its own block (a column-parallel product, this
    rank's experts or edges)."""
    live = _live(mesh, axes)
    if not live or not _tracked(x):
        return x
    return _FanOut.apply(x, mesh, live)


def all_gather(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """``lax.all_gather(x, axes, axis=dim, tiled=True)``: the blocks of
    every rank along ``axes`` concatenated on ``dim`` in rank order (the
    first axis major).  Its backward is :func:`psum_scatter`."""
    live = _live(mesh, axes)
    if not live:
        return x
    if _tracked(x):
        return _AllGather.apply(x, dim, mesh, live)
    return _all_gather(x, dim, mesh, live)


def psum_scatter(x: torch.Tensor, dim: int, mesh, axes) -> torch.Tensor:
    """``lax.psum_scatter(x, axes, scatter_dimension=dim, tiled=True)``:
    the sum over ``axes``, of which this rank keeps block ``index`` of
    ``dim`` (``dim`` must split evenly).  Its backward is
    :func:`all_gather`."""
    live = _live(mesh, axes)
    if not live:
        return x
    if _tracked(x):
        return _PsumScatter.apply(x, dim, mesh, live)
    return _psum_scatter(x, dim, mesh, live)


def regroup(x: torch.Tensor, dim: int, mesh, axis: str, have,
            want) -> torch.Tensor:
    """Re-cut ``dim`` over ``axis``: rank r holds entries ``have(r) =
    (lo, hi)`` of it (contiguous blocks in rank order) and gets entries
    ``want(r)``.  Where every rank's wanted entries lie in its own block
    this is a slice; else one all-gather (the blocks padded to one size),
    then a slice.  Every rank decides alike, so either all of them gather
    or none does."""
    m = axis_size(mesh, axis)
    r = axis_index(mesh, axis)
    lo, hi = want(r)
    if hi <= lo:
        return x.narrow(dim, 0, 0)
    if all(have(q)[0] <= want(q)[0] and want(q)[1] <= have(q)[1]
           for q in range(m) if want(q)[1] > want(q)[0]):
        return x.narrow(dim, lo - have(r)[0], hi - lo)
    sizes = [have(q)[1] - have(q)[0] for q in range(m)]
    size = max(sizes)
    dim = dim % x.dim()
    if x.shape[dim] < size:
        pad = [0, 0] * (x.dim() - 1 - dim) + [0, size - x.shape[dim]]
        x = torch.nn.functional.pad(x, pad)
    g = all_gather(x, dim, mesh, axis)
    full = torch.cat([g.narrow(dim, q * size, n)
                      for q, n in enumerate(sizes)], dim)
    return full.narrow(dim, lo, hi - lo)
