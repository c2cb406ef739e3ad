"""GatedGCN (Bresson & Laurent, arXiv:1711.07553) over edge lists.

The port of ``repro.models.gnn``.  Message passing is gather → compute →
scatter over an edge-index list: JAX's ``jax.ops.segment_sum`` becomes
``index_add`` (on CUDA it adds with atomics, in no fixed order, so results
agree with JAX within a tolerance, not bit for bit).  Layer update
(residual, edge-featured):

    e'_ij = E1·e_ij + E2·h_i + E3·h_j                     (edge gate logits)
    η_ij  = σ(e'_ij) / (Σ_{j'∈N(i)} σ(e'_ij') + ε)        (normalized gates)
    h'_i  = h_i + ReLU(LN(A·h_i + Σ_j η_ij ⊙ (B·h_j)))
    e''_ij = e_ij + ReLU(LN(e'_ij))

LayerNorm (non-parametric) replaces the paper's BatchNorm, as in JAX.
Graphs are padded to static (n_nodes, n_edges) with masks; padded edges
point at node 0 with zero gates.

:class:`GatedGCN` keeps JAX's parameter names and layouts: ``proj_node``
``[d_in, D]``, ``proj_edge`` ``[d_edge_in, D]``, ``layers.w_node``
``[L, D, 2D]`` (A, B packed), ``layers.w_edge`` ``[L, D, 3D]`` (E1, E2,
E3 packed), ``head`` ``[D, n_classes]``; so ``models.convert`` carries
JAX weights across by copying.

:func:`gatedgcn_forward` with a mesh is the forward of a model-parallel
train step (``launch.steps.gnn_step_bundle`` with a mesh): each rank
holds a block of the nodes and a block of the edges, gathers every
node's state over the mesh for its edges, and reduce-scatters its
edges' sums back to the node blocks (the gather's and the
reduce-scatter's backwards are each other, see ``distributed.spmd``).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.nn import Parameter as P

from repro_torch.device import resolve_device
from repro_torch.distributed import spmd
from repro_torch.models import layers as L
from repro_torch.models.scan_utils import scan_layers


@dataclasses.dataclass(frozen=True)
class GatedGCNConfig:
    name: str
    n_layers: int
    d_hidden: int
    d_in: int
    d_edge_in: int
    n_classes: int
    dtype: str = "float32"
    remat: bool = False

    @property
    def torch_dtype(self):
        return getattr(torch, self.dtype)


class GatedGCN(nn.Module):
    """The model's parameters, drawn from a ``torch.Generator`` on an
    explicit device (CUDA by default; raises without it)."""

    def __init__(self, cfg: GatedGCNConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve_device(device)
        gen = None
        if dev.type != "meta":
            gen = generator or torch.Generator(device=dev).manual_seed(0)
        d, n, dt = cfg.d_hidden, cfg.n_layers, cfg.torch_dtype
        fan = (1.0 / d) ** 0.5
        self.proj_node = P(L.dense_init(gen, cfg.d_in, d, dt, device=dev))
        self.proj_edge = P(L.dense_init(gen, cfg.d_edge_in, d, dt,
                                        device=dev))
        self.layers = nn.ParameterDict({
            "w_node": P(L.normal(gen, (n, d, 2 * d), fan, dt, dev)),
            "w_edge": P(L.normal(gen, (n, d, 3 * d), fan, dt, dev)),
        })
        self.head = P(L.dense_init(gen, d, cfg.n_classes, dt, device=dev))


def segment_sum(x, seg, n):
    """``jax.ops.segment_sum(x, seg, num_segments=n)``."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add(0, seg, x)


def _gathered(xs, mesh, axes):
    """Every node's rows of each of ``xs`` (this rank's node block of
    each), all-gathered over ``axes`` in one collective; ``xs`` itself
    where no axis has more than one rank."""
    if spmd.axis_size(mesh, axes) == 1:
        return xs
    every = spmd.all_gather(torch.cat(xs, -1), 0, mesh, axes)
    return torch.split(every, [x.shape[-1] for x in xs], dim=-1)


def _summed(xs, seg, n, mesh, axes):
    """The segment sums ``[n, ...]`` of each of ``xs`` by ``seg``,
    reduce-scattered over ``axes`` to this rank's node block in one
    collective."""
    if spmd.axis_size(mesh, axes) == 1:
        return [segment_sum(x, seg, n) for x in xs]
    sums = spmd.psum_scatter(segment_sum(torch.cat(xs, -1), seg, n), 0,
                             mesh, axes)
    return torch.split(sums, [x.shape[-1] for x in xs], dim=-1)


def gatedgcn_forward(params: GatedGCN, batch, cfg: GatedGCNConfig,
                     mesh=None, axes=()):
    """batch: node_feat ``[N, d_in]``, edge_feat ``[E, d_edge_in]``, src
    and dst ``[E]`` int, node_mask ``[N]`` and edge_mask ``[E]`` bool.
    Returns per-node class logits ``[N, n_classes]``.

    With a ``mesh`` the batch is this rank's blocks: its node block
    ``[n_loc, ...]`` (every rank's of one size, in rank order over
    ``axes``, the first axis major) and its edges, whose ``src``/``dst``
    index the nodes of every block laid end to end.  Each layer then
    all-gathers the nodes' states (one collective), runs the rank's
    edges, and reduce-scatters the gates' and messages' sums (one
    collective) to the node blocks; the logits are those of the rank's
    nodes ``[n_loc, n_classes]``."""
    dt = cfg.torch_dtype
    h = batch["node_feat"].to(dt) @ params.proj_node
    e = batch["edge_feat"].to(dt) @ params.proj_edge
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"][:, None].to(h.dtype)
    n_loc, d = h.shape
    n = n_loc * spmd.axis_size(mesh, axes)

    def body(carry, lp):
        h, e = carry
        a_h, b_h = torch.split(h @ lp["w_node"], d, dim=-1)  # [N, D] each
        h_all, b_all = _gathered((h, b_h), mesh, axes)
        # edge gate logits: E1·e + E2·h_src + E3·h_dst (packed weights)
        e1, e2, e3 = torch.split(lp["w_edge"], d, dim=-1)
        eg = (e @ e1 + torch.index_select(h_all, 0, src) @ e2
              + torch.index_select(h_all, 0, dst) @ e3)
        sig = torch.sigmoid(eg) * emask
        msg = sig * torch.index_select(b_all, 0, src)
        denom, agg = _summed((sig, msg), dst, n, mesh, axes)
        agg = agg / (denom + 1e-6)
        h_new = h + torch.relu(L.nonparam_layernorm(a_h + agg))
        e_new = e + torch.relu(L.nonparam_layernorm(eg))
        return h_new, e_new

    h, e = scan_layers(body, (h, e), params.layers, cfg.remat)
    return h @ params.head


def gatedgcn_loss(params: GatedGCN, batch, cfg: GatedGCNConfig):
    """Node-classification cross-entropy over the masked nodes; returns
    ``(loss, logits)``."""
    logits = gatedgcn_forward(params, batch, cfg)
    mask = batch["node_mask"] & batch.get("train_mask", batch["node_mask"])
    return L.cross_entropy(logits, batch["labels"], mask), logits
