"""Synthetic graph pipelines and a real neighbor sampler (``minibatch_lg``).

A numpy copy of ``repro.data.graph_data``: the same config and seed give
the same arrays.  Graphs are padded to static (n_nodes, n_edges) with
masks.  The neighbor sampler implements the GraphSAGE fanout protocol:
seed nodes → sample ``fanout[0]`` in-neighbors → their ``fanout[1]``
in-neighbors → induced subgraph, CSR-backed and O(E) to build.

:func:`graph_batch` (the port's own) builds the disjoint-union batch of
small graphs that the ``molecule`` shape's graph task takes.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class GraphConfig:
    n_nodes: int
    n_edges: int
    d_feat: int
    n_classes: int = 40
    d_edge_feat: int = 8
    seed: int = 0


def random_graph(cfg: GraphConfig) -> dict:
    """Degree-skewed random graph (preferential-attachment-ish)."""
    rng = np.random.default_rng(cfg.seed)
    # power-law-ish destination preference
    pref = rng.exponential(1.0, cfg.n_nodes)
    pref /= pref.sum()
    src = rng.integers(0, cfg.n_nodes, cfg.n_edges).astype(np.int32)
    dst = rng.choice(cfg.n_nodes, cfg.n_edges, p=pref).astype(np.int32)
    return {
        "src": src,
        "dst": dst,
        "node_feat": rng.standard_normal(
            (cfg.n_nodes, cfg.d_feat)).astype(np.float32),
        "edge_feat": rng.standard_normal(
            (cfg.n_edges, cfg.d_edge_feat)).astype(np.float32),
        "labels": rng.integers(0, cfg.n_classes,
                               cfg.n_nodes).astype(np.int32),
        "node_mask": np.ones(cfg.n_nodes, bool),
        "edge_mask": np.ones(cfg.n_edges, bool),
    }


def graph_batch(n_graphs: int, nodes_per_graph: int, edges_per_graph: int,
                d_feat: int, n_classes: int, d_edge_feat: int = 8,
                seed: int = 0) -> dict:
    """A disjoint union of ``n_graphs`` random graphs of
    ``nodes_per_graph`` nodes and ``edges_per_graph`` edges each (every
    edge inside its graph), with ``graph_ids [N]`` and one label per graph
    ``graph_labels [n_graphs]``: the graph task's batch."""
    rng = np.random.default_rng(seed)
    n, e = n_graphs * nodes_per_graph, n_graphs * edges_per_graph
    base = np.repeat(np.arange(n_graphs) * nodes_per_graph, edges_per_graph)
    return {
        "node_feat": rng.standard_normal((n, d_feat)).astype(np.float32),
        "edge_feat": rng.standard_normal((e, d_edge_feat)).astype(
            np.float32),
        "src": (base + rng.integers(0, nodes_per_graph, e)).astype(np.int32),
        "dst": (base + rng.integers(0, nodes_per_graph, e)).astype(np.int32),
        "labels": np.zeros(n, np.int32),
        "node_mask": np.ones(n, bool),
        "edge_mask": np.ones(e, bool),
        "graph_ids": np.repeat(np.arange(n_graphs),
                               nodes_per_graph).astype(np.int32),
        "graph_labels": rng.integers(0, n_classes, n_graphs).astype(
            np.int32),
    }


class NeighborSampler:
    """Fanout neighbor sampling over a CSR representation (in-edges)."""

    def __init__(self, graph: dict, fanout: Sequence[int],
                 batch_nodes: int, seed: int = 0):
        self.graph = graph
        self.fanout = tuple(fanout)
        self.batch_nodes = batch_nodes
        self.rng = np.random.default_rng(seed)
        n = graph["node_feat"].shape[0]
        # CSR over in-edges: for each dst, the list of (src, edge_id).
        order = np.argsort(graph["dst"], kind="stable")
        self.sorted_src = graph["src"][order]
        self.sorted_eid = order.astype(np.int32)
        counts = np.bincount(graph["dst"], minlength=n)
        self.indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self.n_nodes = n
        # static padded sizes
        max_new = batch_nodes
        self.max_nodes = batch_nodes
        self.max_edges = 0
        for f in self.fanout:
            e = max_new * f
            self.max_edges += e
            max_new = e
            self.max_nodes += e

    def sample(self) -> dict:
        g = self.graph
        seeds = self.rng.integers(0, self.n_nodes, self.batch_nodes)
        nodes = list(seeds)
        node_pos = {int(v): i for i, v in enumerate(seeds)}
        edges_src, edges_dst, edge_ids = [], [], []
        frontier = seeds
        for f in self.fanout:
            next_frontier = []
            for v in frontier:
                lo, hi = self.indptr[v], self.indptr[v + 1]
                deg = hi - lo
                if deg == 0:
                    continue
                take = min(f, int(deg))
                sel = lo + self.rng.choice(deg, size=take, replace=False)
                for s in sel:
                    u = int(self.sorted_src[s])
                    if u not in node_pos:
                        node_pos[u] = len(nodes)
                        nodes.append(u)
                        next_frontier.append(u)
                    edges_src.append(node_pos[u])
                    edges_dst.append(node_pos[int(v)])
                    edge_ids.append(int(self.sorted_eid[s]))
            frontier = np.array(next_frontier, dtype=np.int64) \
                if next_frontier else np.array([], dtype=np.int64)

        n, e = len(nodes), len(edges_src)
        nodes_arr = np.array(nodes, dtype=np.int64)
        out = {
            "node_feat": np.zeros((self.max_nodes, g["node_feat"].shape[1]),
                                  np.float32),
            "edge_feat": np.zeros((self.max_edges, g["edge_feat"].shape[1]),
                                  np.float32),
            "src": np.zeros(self.max_edges, np.int32),
            "dst": np.zeros(self.max_edges, np.int32),
            "labels": np.zeros(self.max_nodes, np.int32),
            "node_mask": np.zeros(self.max_nodes, bool),
            "edge_mask": np.zeros(self.max_edges, bool),
            "train_mask": np.zeros(self.max_nodes, bool),
        }
        out["node_feat"][:n] = g["node_feat"][nodes_arr]
        out["labels"][:n] = g["labels"][nodes_arr]
        out["node_mask"][:n] = True
        out["train_mask"][: self.batch_nodes] = True  # loss on seeds only
        if e:
            out["src"][:e] = edges_src
            out["dst"][:e] = edges_dst
            out["edge_feat"][:e] = g["edge_feat"][np.array(edge_ids)]
            out["edge_mask"][:e] = True
        return out

    def iterator(self) -> Iterator[dict]:
        while True:
            yield self.sample()
