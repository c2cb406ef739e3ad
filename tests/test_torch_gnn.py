"""The port's GNN slice and in-loop rank metrics against the JAX package,
on the CPU.

* ``data.graph_data``: ``random_graph`` and ``NeighborSampler`` batches
  byte-identical to JAX's from the same config and seeds.
* ``core.sorting.gold_rank`` bit-identical to JAX's on the same logits
  (ties, a tiebreak, leading axes); ``ranks_of`` equal on the real
  entries, with ties and masks; ``core.streaming.rank_metrics`` within
  1e-6.
* ``models.gnn``: ``gatedgcn_forward`` from carried weights (GatedGCN's
  stacked ``[L, ...]`` layers) within 1e-4 of JAX's, its gradients (with
  and without ``remat``) within rtol 2e-4 plus atol 2e-4 · max|g| of each
  leaf, and the ``train`` step for the node task (with a ``train_mask``)
  and the graph task against ``jax.jit`` of the JAX bundle's step for 3
  steps from carried weights and optimizer state: loss, grad_norm, lr and
  every rank metric within rtol = atol = 2e-4.  ``index_add`` sums in
  another order than ``segment_sum``, hence tolerances, not bits.
* ``configs.gatedgcn``: the configs and shapes equal JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sorting as JS
from repro.core import streaming as JST
from repro.data import graph_data as JGD
from repro.launch.api import ShapeSpec as JShapeSpec
from repro.launch.api import get_arch as j_get_arch
from repro.models import gnn as JG
from repro.train import optimizer as JO

from repro_torch.configs.gatedgcn import shape_config
from repro_torch.core import sorting as S
from repro_torch.core import streaming as ST
from repro_torch.data import graph_data as GD
from repro_torch.launch.api import ShapeSpec, get_arch, to_device
from repro_torch.models import gnn as G
from repro_torch.models.convert import (flatten_params, load_jax_opt_state,
                                        load_jax_params)

from test_torch_measures import single_torch_thread  # noqa: F401

TOL = 2e-4
NODE_META = (("n_nodes", 40), ("n_edges", 120), ("d_feat", 8),
             ("n_classes", 5))
GRAPH_META = (("n_nodes", 24), ("n_edges", 40), ("d_feat", 8),
              ("n_classes", 3), ("graph_task", True), ("n_graphs", 4))


def _node_batch():
    g = GD.random_graph(GD.GraphConfig(40, 120, 8, n_classes=5,
                                       d_edge_feat=4, seed=2))
    g["train_mask"] = np.arange(40) < 20
    return g


def _graph_batch():
    return GD.graph_batch(4, 6, 10, 8, 3, d_edge_feat=4, seed=2)


def _carried(meta, remat=False):
    """(port module, JAX params, port config, JAX config) for a smoke
    GatedGCN specialized to ``meta``'s widths, JAX's init carried."""
    shape = ShapeSpec("t", "train", meta)
    cfg = dataclasses.replace(shape_config(
        get_arch("gatedgcn").make_config(True), shape), remat=remat)
    jcfg = dataclasses.replace(j_get_arch("gatedgcn").make_config(True),
                               d_in=cfg.d_in, n_classes=cfg.n_classes,
                               remat=remat)
    jparams = JG.init_gatedgcn(jax.random.PRNGKey(0), jcfg)
    model = G.GatedGCN(cfg, device="cpu")
    load_jax_params(model, jax.tree.map(np.asarray, jparams))
    return model, jparams, cfg, jcfg


def _close(got, want, what, rtol=TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale,
                               err_msg=what)


# -- graph data ------------------------------------------------------------------


def _same(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_graph_data_is_byte_identical_to_jax():
    for cfg in ((120, 600, 6, 4, 8, 3), (500, 4000, 6, 40, 5, 0)):
        g = GD.random_graph(GD.GraphConfig(*cfg))
        jg = JGD.random_graph(JGD.GraphConfig(*cfg))
        _same(g, jg)
    ns = GD.NeighborSampler(g, (4, 3), 32, seed=1)
    jns = JGD.NeighborSampler(jg, (4, 3), 32, seed=1)
    assert (ns.max_nodes, ns.max_edges) == (jns.max_nodes, jns.max_edges)
    for _ in range(2):
        _same(ns.sample(), jns.sample())
    assert next(ns.iterator())["src"].tobytes() == \
        next(jns.iterator())["src"].tobytes()


def test_graph_batch_is_a_disjoint_union():
    b = _graph_batch()
    gid = b["graph_ids"]
    assert (gid[b["src"]] == gid[b["dst"]]).all()  # edges stay inside
    assert b["graph_labels"].shape == (4,) and b["src"].shape == (40,)
    assert np.bincount(gid).tolist() == [6] * 4


# -- gold ranks and their metrics ------------------------------------------------


def test_gold_rank_is_bit_identical_to_jax_with_ties():
    rng = np.random.default_rng(3)
    scores = rng.integers(0, 4, (3, 5, 17)).astype(np.float32)  # many ties
    scores[0, 0] = np.nan
    gold = rng.integers(0, 17, (3, 5)).astype(np.int32)
    tb = rng.permutation(17).astype(np.int32)
    for t in (None, tb):
        got = S.gold_rank(torch.from_numpy(scores), torch.from_numpy(gold),
                          None if t is None else torch.from_numpy(t))
        want = np.asarray(JS.gold_rank(jnp.asarray(scores),
                                       jnp.asarray(gold),
                                       None if t is None else
                                       jnp.asarray(t)))
        assert got.dtype == torch.int32 and got.shape == (3, 5)
        assert (got.numpy() == want).all()


def test_ranks_of_matches_jax_on_real_entries():
    rng = np.random.default_rng(4)
    scores = rng.integers(0, 3, (6, 12)).astype(np.float32)
    tb = np.stack([rng.permutation(12) for _ in range(6)]).astype(np.int32)
    mask = rng.random((6, 12)) < 0.7
    got = S.ranks_of(*(torch.from_numpy(x) for x in (scores, tb, mask)))
    want = np.asarray(JS.ranks_of(jnp.asarray(scores), jnp.asarray(tb),
                                  jnp.asarray(mask)))
    got = got.numpy()
    assert (got[mask] == want[mask]).all()
    for q in range(6):  # every rank once; padding after the real entries
        assert sorted(got[q]) == list(range(1, 13))
        assert got[q][~mask[q]].min(initial=13) > got[q][mask[q]].max(
            initial=0)
    # gold_rank is ranks_of without padding, index as the tiebreak
    idx = torch.arange(12, dtype=torch.int32).expand(6, 12)
    full = S.ranks_of(torch.from_numpy(scores), idx,
                      torch.ones(6, 12, dtype=torch.bool))
    gold = torch.from_numpy(rng.integers(0, 12, 6).astype(np.int32))
    assert torch.equal(S.gold_rank(torch.from_numpy(scores), gold),
                       full.gather(1, gold.long()[:, None])[:, 0])


def test_rank_metrics_match_jax():
    ranks = np.array([1, 2, 3, 7, 10, 11, 500], np.int32)
    mask = np.array([1, 1, 0, 1, 1, 0, 1], bool)
    for m in (None, mask, np.zeros_like(mask)):
        got = ST.rank_metrics(torch.from_numpy(ranks),
                              None if m is None else torch.from_numpy(m))
        want = JST.rank_metrics(jnp.asarray(ranks),
                                None if m is None else jnp.asarray(m))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


# -- GatedGCN ----------------------------------------------------------------------


def test_configs_shapes_and_params_match_jax():
    for smoke in (True, False):
        got = dataclasses.asdict(get_arch("gatedgcn").make_config(smoke))
        want = dataclasses.asdict(j_get_arch("gatedgcn").make_config(smoke))
        want.pop("unroll_layers")  # the JAX cost-probe switch
        assert got == want
    ours, theirs = get_arch("gatedgcn").shapes, j_get_arch("gatedgcn").shapes
    assert {k: (v.kind, v.meta) for k, v in ours.items()} == \
        {k: (v.kind, v.meta) for k, v in theirs.items()}
    assert get_arch("gatedgcn").family == "gnn"
    cfg = get_arch("gatedgcn").make_config(False)
    jshapes = jax.eval_shape(lambda: JG.init_gatedgcn(
        jax.random.PRNGKey(0), j_get_arch("gatedgcn").make_config(False)))
    flat = {jax.tree_util.keystr(p, simple=True, separator="."): leaf.shape
            for p, leaf in jax.tree_util.tree_leaves_with_path(jshapes)}
    model = G.GatedGCN(cfg, device="meta")
    assert {n: tuple(p.shape) for n, p in model.named_parameters()} == flat
    assert model.layers["w_node"].shape == (16, 70, 140)


@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_gradients_match_jax(remat):
    model, jparams, cfg, jcfg = _carried(NODE_META, remat)
    batch = _node_batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    logits = G.gatedgcn_forward(model, to_device(batch, "cpu"), cfg)
    want = jax.jit(JG.gatedgcn_forward, static_argnums=2)(jparams, jbatch,
                                                           jcfg)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               atol=1e-4, rtol=1e-4)
    loss, _ = G.gatedgcn_loss(model, to_device(batch, "cpu"), cfg)
    loss.backward()
    jgrads = jax.jit(jax.grad(lambda p, b: JG.gatedgcn_loss(p, b, jcfg)[0])
                     )(jparams, jbatch)
    want = flatten_params(jax.tree.map(np.asarray, jgrads))
    for n, p in model.named_parameters():
        _close(p.grad, want[n], n)


def test_padded_nodes_and_edges_leave_real_logits_unchanged():
    model, _, cfg, _ = _carried(NODE_META)
    b = to_device(_node_batch(), "cpu")
    pad = {"node_feat": (5, 0), "edge_feat": (7, 0), "src": (7,),
           "dst": (7,), "node_mask": (5,), "edge_mask": (7,),
           "labels": (5,)}
    padded = {k: torch.cat([b[k], torch.zeros((n,) + b[k].shape[1:],
                                              dtype=b[k].dtype)])
              for k, (n, *_) in pad.items()}
    with torch.no_grad():
        out = G.gatedgcn_forward(model, b, cfg)
        out_p = G.gatedgcn_forward(model, padded, cfg)
    torch.testing.assert_close(out_p[:40], out, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("task", ["node", "graph"])
def test_train_step_matches_jax_for_three_steps(task):
    meta = NODE_META if task == "node" else GRAPH_META
    batch = _node_batch() if task == "node" else _graph_batch()
    model, jparams, cfg, jcfg = _carried(meta)
    bundle = get_arch("gatedgcn").make_step(
        get_arch("gatedgcn").make_config(True), ShapeSpec("t", "train", meta),
        device="cpu")
    jstep = jax.jit(j_get_arch("gatedgcn").make_step(
        j_get_arch("gatedgcn").make_config(True),
        JShapeSpec("t", "train", meta), None).step_fn)
    j_init, _ = JO.adamw(JO.OptimizerConfig(lr=1e-3))
    jp, js = jparams, j_init(jparams)
    state = load_jax_opt_state(jax.tree.map(np.asarray, jp),
                               jax.tree.map(np.asarray, js))
    for step in range(3):
        jp, js, jm = jstep(jp, js, jax.tree.map(jnp.asarray, batch))
        model, state, m = bundle.step_fn(model, state,
                                         to_device(batch, "cpu"))
        assert m.keys() == jm.keys() == {
            "loss", "grad_norm", "lr", "recip_rank", "ndcg", "success_1",
            "success_5", "success_10"}
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=TOL,
                                       atol=TOL, err_msg=f"{k} {step}")
    want = flatten_params(jax.tree.map(np.asarray, jp))
    for n, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], atol=1e-5,
                                   err_msg=n)


def test_gnn_step_rejects_other_kinds_and_builds_every_shape():
    arch = get_arch("gatedgcn")
    cfg = arch.make_config(False)
    for name, shape in arch.shapes.items():  # specs only: nothing allocated
        params, opt, inputs = arch.make_step(cfg, shape,
                                             device="cpu").arg_specs
        assert inputs["node_feat"].shape == (shape.get("n_nodes"),
                                             shape.get("d_feat"))
        assert opt.m.keys() == params.keys()
        assert params["head"].shape == (70, shape.get("n_classes"))
        assert ("graph_ids" in inputs) == bool(shape.get("graph_task"))
    with pytest.raises(ValueError, match="kind"):
        arch.make_step(cfg, ShapeSpec("x", "serve", ()), device="cpu")
