"""gatedgcn [arXiv:2003.00982 benchmark config; paper]

16 layers, d_hidden=70, gated aggregator.  Input feature width varies per
shape (cora 1433, reddit 602, ogbn-products 100, molecules 16), so the model
config is specialized per shape inside make_step (:func:`shape_config`).

On one H100: ``full_graph_sm``, ``minibatch_lg`` (the padded fanout
subgraph the step takes) and ``molecule`` train at full width;
``ogb_products`` (61.9M edges: 17.3 GB for each [E, 70] float32 edge
state, 16 layers of them carried) is a shape spec until sharded training
exists.
"""

from __future__ import annotations

import dataclasses

from repro_torch.launch.api import ArchDef, ShapeSpec, register
from repro_torch.models.gnn import GatedGCNConfig

SHAPES = {
    "full_graph_sm": ShapeSpec(
        "full_graph_sm", "train",
        (("n_nodes", 2708), ("n_edges", 10_556), ("d_feat", 1433),
         ("n_classes", 7))),
    "minibatch_lg": ShapeSpec(
        # reddit-scale source graph (232,965 nodes / 114.6M edges); the step
        # consumes the padded fanout-(15,10) subgraph of 1024 seed nodes.
        "minibatch_lg", "train",
        (("n_nodes", 169_984), ("n_edges", 168_960), ("d_feat", 602),
         ("n_classes", 41), ("batch_nodes", 1024), ("fanout", (15, 10)),
         ("src_nodes", 232_965), ("src_edges", 114_615_892))),
    "ogb_products": ShapeSpec(
        "ogb_products", "train",
        (("n_nodes", 2_449_029), ("n_edges", 61_859_140), ("d_feat", 100),
         ("n_classes", 47))),
    "molecule": ShapeSpec(
        "molecule", "train",
        (("n_nodes", 3840), ("n_edges", 8192), ("d_feat", 16),
         ("n_classes", 2), ("graph_task", True), ("n_graphs", 128),
         ("nodes_per_graph", 30), ("edges_per_graph", 64))),
}


def make_config(smoke: bool = False) -> GatedGCNConfig:
    if smoke:
        return GatedGCNConfig(name="gatedgcn-smoke", n_layers=3, d_hidden=16,
                              d_in=8, d_edge_in=4, n_classes=5)
    return GatedGCNConfig(name="gatedgcn", n_layers=16, d_hidden=70,
                          d_in=100, d_edge_in=8, n_classes=47)


def shape_config(cfg: GatedGCNConfig, shape: ShapeSpec) -> GatedGCNConfig:
    """``cfg`` with the shape's input width and class count."""
    return dataclasses.replace(
        cfg, d_in=shape.get("d_feat", cfg.d_in),
        n_classes=shape.get("n_classes", cfg.n_classes))


def _make_step(cfg, shape, device=None, mesh=None):
    from repro_torch.launch.steps import gnn_step_bundle

    return gnn_step_bundle(shape_config(cfg, shape), shape, device,
                           mesh)


ARCH = register(ArchDef(
    name="gatedgcn",
    family="gnn",
    shapes=SHAPES,
    make_config=make_config,
    make_step=_make_step,
    notes="Message passing via index_add over edge lists (no sparse lib); "
          "minibatch_lg takes the padded fanout subgraph.",
))
