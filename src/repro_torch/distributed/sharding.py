"""Per-family sharding rules for the production mesh, and their DTensor
placements.

The port of ``repro.distributed.sharding``.  Axis convention (see
``launch/mesh.py``):

* ``data`` (+ ``pod`` when multi-pod) — batch / query axes (DP).
* ``model`` — tensor-parallel axis: attention heads, FFN hidden, vocab,
  experts (EP), embedding-table rows, candidate sets, KV-cache sequence.

A spec is a tuple with one entry per tensor dimension, as JAX's
``PartitionSpec`` is: ``None`` (replicated), a mesh axis name, or a tuple
of names (the dimension split over those axes, the first one major).
``P()`` is ``()``.  :func:`placements` turns a spec into the DTensor
placements over a ``DeviceMesh`` whose ``mesh_dim_names`` are the axis
names, and :func:`local_shard` cuts a tensor's local block by them
(``torch.chunk``'s rule: blocks of ``ceil(n / m)``, the last ones shorter
or empty, as GSPMD pads an uneven split).

Models never hardcode specs; they receive a ``*Sharding`` object and
call :func:`constrain`, a no-op for ``spec=None``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Tuple

import torch

Spec = Tuple


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh):
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dimension that splits tensor dimension d, ``Replicate()`` on the
    rest."""
    from torch.distributed.tensor import Replicate, Shard

    where = {}
    for dim, entry in enumerate(spec):
        for name in _axes(entry):
            if name in where:
                raise ValueError(f"axis {name!r} used twice in {spec}")
            where[name] = dim
    names = tuple(mesh.mesh_dim_names)
    unknown = set(where) - set(names)
    if unknown:
        raise ValueError(f"spec {spec} names axes {sorted(unknown)} not in "
                         f"the mesh's {names}")
    return tuple(Shard(where[n]) if n in where else Replicate()
                 for n in names)


def chunk_bounds(n: int, parts: int, index: int) -> Tuple[int, int]:
    """``[lo, hi)`` of block ``index`` when n items split into ``parts``
    blocks by ``torch.chunk``'s rule."""
    size = -(-n // parts) if parts else n
    lo = min(index * size, n)
    return lo, min(lo + size, n)


def local_bounds(shape, spec: Spec, mesh):
    """Per dimension, the ``[lo, hi)`` this rank holds of a tensor of
    ``shape`` laid out by ``spec`` (a dimension split over several axes
    is cut by the first, then each block by the next)."""
    out = []
    for dim, n in enumerate(shape):
        entry = spec[dim] if dim < len(spec) else None
        lo, hi = 0, n
        for name in _axes(entry):
            a, b = chunk_bounds(hi - lo, mesh.size(_dim(mesh, name)),
                                mesh.get_local_rank(name))
            lo, hi = lo + a, lo + b
        out.append((lo, hi))
    return out


def split_axes(spec: Spec, mesh) -> Tuple[str, ...]:
    """The axes of ``mesh`` that ``spec`` splits (those of size 1 left
    out)."""
    from repro_torch.distributed import spmd

    return tuple(n for entry in spec or () for n in _axes(entry)
                 if spmd.axis_size(mesh, n) > 1)


def _dim(mesh, name: str) -> int:
    return tuple(mesh.mesh_dim_names).index(name)


def local_shard(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the full tensor ``t`` (a view: nothing is
    copied).  Of a ``meta`` tensor (the dry run's), a new ``meta`` block,
    so that its storage is the block's size, as on a rank."""
    bounds = local_bounds(t.shape, spec, mesh)
    if t.device.type == "meta" and any(
            (lo, hi) != (0, n) for (lo, hi), n in zip(bounds, t.shape)):
        return torch.empty([hi - lo for lo, hi in bounds], dtype=t.dtype,
                           device="meta")
    for dim, (lo, hi) in enumerate(bounds):
        if (lo, hi) != (0, t.shape[dim]):
            t = t.narrow(dim, lo, hi - lo)
    return t


def to_dtensor(t: torch.Tensor, spec: Spec, mesh):
    """The full tensor ``t`` (the same on every rank) as a DTensor laid
    out by ``spec``: each rank keeps a view of its own block, and no
    collective runs; a parameter's block is detached from autograd)."""
    return from_local(local_shard(t, spec, mesh).detach(), spec, mesh,
                      t.shape)


def from_local(t: torch.Tensor, spec: Spec, mesh, shape):
    """This rank's block ``t`` of a tensor of global ``shape`` laid out by
    ``spec``, as a DTensor (no collective runs)."""
    from torch.distributed.tensor import DTensor

    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.insert(0, n)
        n *= size
    return DTensor.from_local(t, mesh, placements(spec, mesh),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(stride))


def local_input(t, spec: Spec, mesh):
    """A step input's local block: a DTensor's own, or this rank's block
    of a full tensor."""
    from repro_torch.distributed import spmd

    out = local(t) if hasattr(t, "to_local") else local_shard(t, spec, mesh)
    spmd.note_input(t, out)
    return out


def leaf_block(p: torch.Tensor, spec: Spec, mesh,
               own: bool = False) -> torch.Tensor:
    """This rank's block of the parameter ``p`` as a tensor that
    gradients land on: ``p`` itself where the block is all of it (a
    replicated parameter), else the block made a leaf: with ``own`` a
    contiguous copy of its own that requires grad when ``p`` does, else
    a detached view (sharing ``p``'s storage) that requires grad when
    ``p`` does and grad is enabled.  A ``meta`` parameter's block is a
    ``meta`` tensor of its own."""
    block = local_shard(p, spec, mesh)
    if block is p:
        return p
    if own:
        return block.detach().clone(
            memory_format=torch.contiguous_format).requires_grad_(
                p.requires_grad)
    return block.detach().requires_grad_(p.requires_grad
                                         and torch.is_grad_enabled())


class ShardedParams(Mapping):
    """A model's parameters laid out on a mesh by ``specs``: the mapping
    is ``{name: this rank's block}`` (:func:`leaf_block`: the tensors a
    sharded step differentiates and updates in place), with each one's
    spec and global shape; ``module`` is the model they were cut from.
    :meth:`dtensors` gives them as DTensors (for ``full_tensor`` and
    checkpoints).

    Without ``own`` (serving) each split parameter's block is a view of
    the module's, which stays whole.  With ``own`` (training, see
    :func:`train_layout`) each such block is a copy of its own and the
    module's parameter becomes a ``meta`` tensor of its shape, so that
    the rank keeps its blocks and the replicated parameters only (what
    the dry run counts)."""

    def __init__(self, module, specs, mesh, own: bool = False):
        self.module, self.mesh = module, mesh
        named = dict(module.named_parameters())
        self.specs = {n: tuple(specs[n]) for n in named}
        self.shapes = {n: tuple(p.shape) for n, p in named.items()}
        self.blocks = {}
        for n in list(named):
            p = named.pop(n)  # the last reference here, once replaced
            self.blocks[n] = leaf_block(p, self.specs[n], mesh, own)
            if own and self.blocks[n] is not p:
                owner, _, leaf = n.rpartition(".")
                stub = torch.empty(p.shape, dtype=p.dtype, device="meta")
                setattr(module.get_submodule(owner), leaf,
                        torch.nn.Parameter(stub, requires_grad=False))

    def __getitem__(self, name):
        return self.blocks[name]

    def __iter__(self):
        return iter(self.blocks)

    def __len__(self):
        return len(self.blocks)

    def dtensors(self):
        return {n: from_local(b.detach(), self.specs[n], self.mesh,
                              self.shapes[n])
                for n, b in self.blocks.items()}

    def full(self):
        """Every parameter's whole value (a collective on every rank)."""
        return {n: full_tensor(t) for n, t in self.dtensors().items()}


def train_layout(module, specs, mesh) -> ShardedParams:
    """``module``'s parameters laid out on ``mesh`` for training
    (``ShardedParams`` with ``own``).  The module keeps its layout: a
    second call on it returns the same blocks (the module's split
    parameters are ``meta`` from the first call on)."""
    done = module.__dict__.get("_train_layout")
    if done is None:
        done = ShardedParams(module, specs, mesh, own=True)
        module.__dict__["_train_layout"] = done
    elif done.mesh is not mesh:
        raise ValueError("the model's parameters are laid out on another "
                         "mesh")
    return done


def full_tensor(t):
    """A DTensor's whole value on every rank, gathered with the port's
    collectives (``spmd.all_gather``: c10d ``all_gather_into_tensor``,
    each block padded to the split's block size); any other tensor as it
    is.  (``DTensor.full_tensor`` goes through the functional collectives,
    which crash on a gloo group of CUDA tensors.)"""
    if not hasattr(t, "to_local"):
        return t
    from repro_torch.distributed import spmd

    mesh = t.device_mesh
    names = tuple(mesh.mesh_dim_names)
    x = t.to_local()
    axes = {}
    for i, p in enumerate(t.placements):
        if p.is_shard():
            axes.setdefault(p.dim, []).append(names[i])
    for dim, split in axes.items():
        # the block lengths above each level of the nested split
        lengths, lo, hi = [], 0, t.shape[dim]
        for name in split:
            lengths.append(hi - lo)
            a, b = chunk_bounds(hi - lo, mesh.size(_dim(mesh, name)),
                                mesh.get_local_rank(name))
            lo, hi = lo + a, lo + b
        for name, n in reversed(list(zip(split, lengths))):
            block = -(-n // mesh.size(_dim(mesh, name)))
            if x.shape[dim] < block:
                pad = [0, 0] * (x.dim() - 1 - dim) + [0, block - x.shape[dim]]
                x = torch.nn.functional.pad(x, pad)
            x = spmd.all_gather(x, dim, mesh, name).narrow(dim, 0, n)
    return x


def spec_of(t) -> Spec:
    """The spec of a DTensor's placements (a dimension split over several
    mesh axes names them in mesh order, the first major)."""
    names = tuple(t.device_mesh.mesh_dim_names)
    out = [[] for _ in range(t.dim())]
    for i, p in enumerate(t.placements):
        if p.is_shard():
            out[p.dim].append(names[i])
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in out)


def local(t):
    """The rank's local tensor of a DTensor; any other tensor as it is."""
    to_local = getattr(t, "to_local", None)
    return t if to_local is None else to_local()


def constrain(x, spec: Optional[Spec]):
    """JAX's ``with_sharding_constraint``: a DTensor is redistributed to
    ``spec``'s placements; ``spec=None`` (or a plain tensor, which has no
    layout to change) returns ``x``."""
    if spec is None or not hasattr(x, "redistribute"):
        return x
    return x.redistribute(x.device_mesh, placements(spec, x.device_mesh))


@dataclasses.dataclass(frozen=True)
class LMSharding:
    """Megatron-style TP + DP (+ optional FSDP for expert weights)."""

    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"
    fsdp_experts: bool = False
    # FSDP materialization: "gather" weights (train) or "activation"
    # (decode: gather the few tokens instead — see models/moe.py).
    moe_fsdp_mode: str = "gather"
    # decode: shard the KV-cache sequence axis over `model` (flash-decoding).
    shard_cache_seq: bool = True

    @property
    def batch(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    # --- activations ---
    def act(self):  # [B, S, D]
        return (self.batch, None, None)

    def act_heads(self):  # [B, S, H, hd] — heads TP-sharded
        return (self.batch, None, self.model_axis, None)

    def logits(self):  # [B, S, V] — vocab TP-sharded
        return (self.batch, None, self.model_axis)

    def cache(self):  # [B, KV, S, hd]
        seq = self.model_axis if self.shard_cache_seq else None
        return (self.batch, None, seq, None)

    # --- parameters ---
    def p_embed(self):  # [V, D]
        return (self.model_axis, None)

    def p_attn_in(self):  # [D, H*hd] — column parallel
        return (None, self.model_axis)

    def p_attn_out(self):  # [H*hd, D] — row parallel
        return (self.model_axis, None)

    def p_ffn_in(self):  # [D, F]
        return (None, self.model_axis)

    def p_ffn_out(self):  # [F, D]
        return (self.model_axis, None)

    def p_norm(self):
        return (None,)

    def p_router(self):  # [D, E]
        return ()

    def p_expert_in(self):  # [E, D, F] — EP over model (+ FSDP over data)
        return (self.model_axis, None, self.fsdp_axis())

    def p_expert_out(self):  # [E, F, D]
        return (self.model_axis, self.fsdp_axis(), None)

    def fsdp_axis(self) -> Optional[str]:
        return self.data_axes[-1] if self.fsdp_experts else None


@dataclasses.dataclass(frozen=True)
class GNNSharding:
    """Edges sharded over the full mesh; small feature dim replicated."""

    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"

    def edges(self):  # [E] / [E, F]
        return ((*self.data_axes, self.model_axis),)

    def nodes(self):  # [N, F] — nodes over data
        return (self.batch, None)

    @property
    def batch(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def p_weight(self):
        return (None, None)


@dataclasses.dataclass(frozen=True)
class RecSysSharding:
    """Embedding tables row-sharded over `model` (vocab-parallel); DP batch."""

    data_axes: Tuple[str, ...] = ("data",)
    model_axis: str = "model"

    @property
    def batch(self):
        return self.data_axes if len(self.data_axes) > 1 else self.data_axes[0]

    def p_table(self):  # [V_total, E]
        return (self.model_axis, None)

    def p_dense(self):
        return (None, None)

    def act(self):  # [B, ...]
        return (self.batch,)

    def candidates(self):  # [N_cand, E] — candidate set over model
        return (self.model_axis, None)
