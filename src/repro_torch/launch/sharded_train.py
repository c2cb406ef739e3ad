"""Self-check of model-parallel training over a process group: each rank
runs the sharded ``train`` steps (``launch.steps`` with a mesh) and the
same steps without a mesh from the same weights and inputs, and keeps
both.

Run one process per rank (or under ``torchrun``)::

    python -m repro_torch.launch.sharded_train --store /tmp/g --rank R \\
        --world-size 4 --mesh 2x2 --device cpu --size smoke --out DIR
    python -m repro_torch.launch.sharded_train --store /tmp/g --rank R \\
        --world-size 2 --mesh 1x2 --device cuda:0 --backend gloo \\
        --size card

Cases (``--cases``, comma-separated; each runs :data:`STEPS` steps from
the weights and a fresh ``init_opt``):

* ``recsys:<arch>`` — ``train_batch`` with the tables row-sharded over
  ``model`` (B3 and B3-bwd on each rank's rows) and the rows over the
  data axes;
* ``gnn:<shape>`` — GatedGCN with the edges over the mesh and the nodes
  over the data axes (n and e padded by the step); in smoke size every
  node-task shape (``node``) is a smoke graph of the node task and
  ``graph`` one of the graph task, each with n and e no multiples of
  the mesh;
* ``lm:<arch>[:field=int]...`` — ``train_4k`` at a few tokens, TP / EP
  with the arch's own ``fsdp`` and ``opt_memory_efficient``.  An MoE
  model is held against the unsharded model run on each data shard's
  rows in turn, the gradients added up before one update
  (:func:`lm_reference_step`): JAX's capacity is a data shard's;
* ``collectives`` — each autograd collective of ``distributed.spmd``
  over ``model``, the data axes and both, with seeded cotangents: the
  inputs, cotangents and gradients are saved for the test to hold each
  backward against its transpose;
* ``ckpt`` — xDeepFM's state after a step saved under this mesh
  (``train.checkpoint``), restored under ``(world, 1)``, gathered.

``--size smoke`` uses the smoke configs at a few rows; ``card`` the full
widths chip_smoke's phase Q2 runs (xDeepFM at ``train_batch``'s 65,536
rows, olmo-1b with 2 layers at 2 x 1,024 tokens, GatedGCN
``full_graph_sm``).  ``--weights DIR`` loads ``DIR/<tag>.npz`` (a JAX
parameter tree flattened with ``models.convert.flatten_params``) instead
of seeded weights.  With ``--out`` each rank writes ``DIR/rank<R>.npz``:
``<case>/got/...`` gathered from the sharded run (``params/<name>``,
``m/<name>``, ``v/<name>[/r|c]``, ``step<i>/<metric>``),
``<case>/want/...`` the unsharded run's, ``<case>/inputs/...`` in smoke
size.  Every rank prints one JSON line: per case its kernel launches
(B3: ``embedding_bag``, B3-bwd: ``embedding_bag_backward``, from the C
entry points' counts), seconds, the bytes the rank keeps of the
laid-out model (:func:`held_bytes`), and how far the gathered results
are from the unsharded ones, group by group (:func:`differences`).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import sys
import time
from datetime import timedelta
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.launch.sharded_serve import _Run as _ServeRun
from repro_torch.launch.sharded_serve import _sync, lm_config

GROUP_TIMEOUT = timedelta(seconds=60)
STEPS = 2
#: rows of a recsys batch per data shard, by size
RECSYS_ROWS = {"smoke": 8, "card": 65_536}
#: (tokens a sequence, sequences per data shard) by size; the layers are
#: ``sharded_serve.lm_config``'s (the config's, or 2 in card size)
LM_SIZES = {"smoke": (8, 2), "card": (1024, 2)}
#: the smoke graphs: (n_nodes, n_edges) of the node task; (graphs, nodes a
#: graph, edges a graph) of the graph task
GNN_SMOKE = {"node": (37, 101), "graph": (7, 5, 9)}
SMOKE_CASES = ("recsys:xdeepfm", "recsys:sasrec", "recsys:autoint",
               "recsys:mind", "gnn:node", "gnn:graph", "lm:olmo-1b",
               "lm:phi3-medium-14b:n_heads=3:n_kv_heads=1:d_model=48",
               "lm:qwen3-moe-235b-a22b", "lm:arctic-480b", "collectives",
               "ckpt")
CARD_CASES = ("recsys:xdeepfm", "lm:olmo-1b", "gnn:full_graph_sm")


def _launches():
    from repro_torch.kernels import embedding_bag as EB

    return {"embedding_bag": EB.LAUNCHES,
            "embedding_bag_backward": EB.BACKWARD_LAUNCHES}


def _zero_launches():
    from repro_torch.kernels import embedding_bag as EB

    EB.LAUNCHES = EB.BACKWARD_LAUNCHES = 0


def _flat(tree, prefix=""):
    """``{"a/b": tensor}`` of a nested dict / tuple of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else str(k)))
        return out
    return {prefix: tree}


def gathered(params, state, metrics_by_step,
             to=None) -> Dict[str, torch.Tensor]:
    """A train run's results as whole tensors (moved ``to`` a device when
    given): every parameter, m and v (gathered over the mesh when laid
    out on one) and each step's metrics."""
    from repro_torch.distributed import sharding as SH
    from repro_torch.train import optimizer as opt_lib

    sp = getattr(params, "params", params)
    if isinstance(sp, SH.ShardedParams):
        full = sp.full()
        st = opt_lib.state_dtensors(state, sp.specs, sp.shapes, sp.mesh)
    else:
        full = {n: p for n, p in sp.named_parameters()}
        st = state
    out = {f"params/{n}": p for n, p in full.items()}
    out.update(_flat({"m": dict(st.m), "v": dict(st.v)}))
    for i, metrics in enumerate(metrics_by_step):
        out.update({f"step{i}/{k}": v for k, v in metrics.items()})
    return {k: SH.full_tensor(v).to(to) for k, v in out.items()}


def held_bytes(model):
    """What a laid-out model keeps on its rank: the bytes of the distinct
    storages behind its blocks and its module's parameters that are not
    ``meta`` (``storage``), and the bytes of the blocks themselves
    (``blocks``); None for a model that is not laid out."""
    from repro_torch.distributed import sharding as SH

    sp = getattr(model, "params", model)
    if not isinstance(sp, SH.ShardedParams):
        return None
    storages = {}
    for t in [*sp.values(), *sp.module.parameters()]:
        if t.device.type != "meta":
            st = t.untyped_storage()
            storages[(st.data_ptr(), st.nbytes())] = st.nbytes()
    return {"storage": sum(storages.values()),
            "blocks": sum(b.numel() * b.element_size()
                          for b in sp.values())}


class _Run(_ServeRun):
    """One rank's cases (``sharded_serve``'s, with the case's largest
    differences and the directory a checkpoint goes to)."""

    def __init__(self, mesh, device, size, seed, weights, out_dir):
        super().__init__(mesh, device, size, seed, weights)
        self.out_dir = out_dir
        self.errors: Dict[str, dict] = {}
        self.held: Dict[str, dict] = {}

    def train(self, case, bundle, model, batches):
        """STEPS steps of ``bundle`` from ``model`` and a fresh state; the
        sharded run's kernel launches and seconds are the case's."""
        state = bundle.init_opt(model)
        metrics = []
        sharded = bundle.mesh is not None
        _sync(self.device)
        if sharded:
            _zero_launches()
        t0 = time.perf_counter()
        for i in range(STEPS):
            model, state, m = bundle.step_fn(model, state, batches[i])
            metrics.append(m)
        _sync(self.device)
        if sharded:
            self.seconds[case] = time.perf_counter() - t0
            self.launches[case] = _launches()
            self.held[case] = held_bytes(model)
        if self.size == "smoke":
            return gathered(model, state, metrics)
        # at full width the results wait on the host, and the card's
        # cached blocks go back to it, so that the other ranks and the
        # next run have the room
        out = gathered(model, state, metrics, "cpu")
        del model, state, metrics
        torch.cuda.empty_cache()
        return out

    def compare(self, case, got, want, inputs=None):
        """Keep both runs' results (smoke) and their differences."""
        self.errors[case] = differences(got, want)
        if self.size == "smoke":
            self.put(f"{case}/got", got)
            self.put(f"{case}/want", want)
            if inputs is not None:
                self.put(f"{case}/inputs", inputs)


def differences(got, want) -> Dict[str, dict]:
    """How far :func:`gathered`'s results ``got`` are from ``want``, by
    group (``params``, ``m``, ``v`` and ``metrics``, each to be held at
    its own scale): the largest absolute difference (``max_abs_err``)
    and value (``max_abs``); the largest of each leaf's difference over
    the leaf's own largest value (``leaf_rel_err``; a metric's over
    max(1, |value|)); the largest of each entry's difference over its
    value's size and the leaf's largest, |got - want| / (|want| +
    max|want|) (``entry_err``); the largest gap of a leaf's norm from
    the wanted one's (``norm_gap``, |‖got‖ / ‖want‖ - 1|)."""
    out: Dict[str, dict] = {}
    for k, w in want.items():
        g = got[k].detach().float()
        w = w.detach().float().to(g.device)
        if g.shape != w.shape:
            raise ValueError(f"{k}: {tuple(g.shape)} against "
                             f"{tuple(w.shape)}")
        group = "metrics" if k.startswith("step") else k.split("/")[0]
        e = out.setdefault(group, dict.fromkeys(
            ("max_abs_err", "max_abs", "leaf_rel_err", "entry_err",
             "norm_gap"), 0.0))
        if not w.numel():
            continue
        diff = (g - w).abs()
        err, big = float(diff.max()), float(w.abs().max())
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["max_abs"] = max(e["max_abs"], big)
        scale = max(1.0, big) if group == "metrics" else big
        if scale > 0:
            e["leaf_rel_err"] = max(e["leaf_rel_err"], err / scale)
            e["entry_err"] = max(e["entry_err"], float(
                (diff / (w.abs() + big)).max()))
        del diff
        norm = float(torch.linalg.vector_norm(w))
        if norm > 0:
            e["norm_gap"] = max(e["norm_gap"], abs(float(
                torch.linalg.vector_norm(g)) / norm - 1.0))
        elif err > 0:
            e["norm_gap"] = float("inf")
    return out


def _recsys_batch(name, cfg, rows, seed, step):
    from repro_torch.data import recsys_data as RD

    if name == "sasrec":
        return RD.seq_batch(RD.SeqDataConfig(cfg.n_items, cfg.seq_len, rows,
                                             seed=seed), step)
    if name == "mind":
        return RD.mind_batch(RD.SeqDataConfig(
            cfg.table.vocab_per_field, cfg.hist_len, rows, seed=seed), step)
    return RD.ctr_batch(RD.CTRDataConfig(
        cfg.table.n_fields, cfg.table.vocab_per_field, rows,
        cfg.n_multi_hot, cfg.multi_hot_len, seed), step)


def recsys_case(run: _Run, name: str) -> None:
    from repro_torch.configs.common import smoke_shape
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.launch.steps import MODELS

    arch = get_arch(name)
    cfg = arch.make_config(run.size == "smoke")
    rows = RECSYS_ROWS[run.size] * (run.n_data if run.size == "smoke"
                                    else 1)
    shape = smoke_shape(arch.shapes["train_batch"], batch=rows)
    model = run.model(name, cfg, MODELS[name])
    ref = copy.deepcopy(model)
    batches = [_recsys_batch(name, cfg, rows, run.seed + 10, s)
               for s in range(STEPS)]
    dev = [to_device(b, run.device) for b in batches]
    case = f"recsys:{name}"
    got = run.train(case, arch.make_step(cfg, shape, run.device, run.mesh),
                    model, dev)
    del model
    want = run.train(case, arch.make_step(cfg, shape, run.device), ref, dev)
    run.compare(case, got, want,
                {f"step{i}": b for i, b in enumerate(batches)})


def _gnn_data(run: _Run, arg: str):
    """(config, shape, numpy batch) of a GNN case."""
    from repro_torch.configs.common import smoke_shape
    from repro_torch.configs.gatedgcn import shape_config
    from repro_torch.data import graph_data as GD
    from repro_torch.launch.api import get_arch

    arch = get_arch("gatedgcn")
    cfg = arch.make_config(run.size == "smoke")
    if run.size == "card":
        shape = arch.shapes[arg]
        cfg = shape_config(cfg, shape)
        g = GD.random_graph(GD.GraphConfig(
            shape.get("n_nodes"), shape.get("n_edges"), cfg.d_in,
            cfg.n_classes, cfg.d_edge_in, run.seed + 20))
        return cfg, shape, g
    if arg != "graph" and not arch.shapes.get(
            arg, arch.shapes["full_graph_sm"]).get("graph_task", False):
        n, e = GNN_SMOKE["node"]
        shape = smoke_shape(arch.shapes["full_graph_sm"], n_nodes=n,
                            n_edges=e, d_feat=cfg.d_in,
                            n_classes=cfg.n_classes)
        g = GD.random_graph(GD.GraphConfig(n, e, cfg.d_in, cfg.n_classes,
                                           cfg.d_edge_in, run.seed + 20))
        g["train_mask"] = np.arange(n) % 3 != 0
        return cfg, shape, g
    ng, npg, epg = GNN_SMOKE["graph"]
    shape = smoke_shape(arch.shapes["molecule"], n_nodes=ng * npg,
                        n_edges=ng * epg, d_feat=cfg.d_in,
                        n_classes=cfg.n_classes, n_graphs=ng,
                        nodes_per_graph=npg, edges_per_graph=epg)
    g = GD.graph_batch(ng, npg, epg, cfg.d_in, cfg.n_classes, cfg.d_edge_in,
                       seed=run.seed + 21)
    return cfg, shape, g


def gnn_case(run: _Run, arg: str) -> None:
    from repro_torch.launch.api import to_device
    from repro_torch.launch.steps import gnn_step_bundle
    from repro_torch.models.gnn import GatedGCN

    cfg, shape, g = _gnn_data(run, arg)
    model = run.model(f"gatedgcn_{arg}", cfg, GatedGCN)
    ref = copy.deepcopy(model)
    batch = to_device(g, run.device)
    case = f"gnn:{arg}"
    got = run.train(case, gnn_step_bundle(cfg, shape, run.device, run.mesh),
                    model, [batch] * STEPS)
    want = run.train(case, gnn_step_bundle(cfg, shape, run.device), ref,
                     [batch] * STEPS)
    run.compare(case, got, want, g)


def lm_reference_step(cfg, shards: int, opt_memory_efficient: bool):
    """The unsharded LM ``train`` step (``steps.lm_optimizer``'s AdamW)
    with the model run on each of ``shards`` equal blocks of rows in turn
    and the gradients of the blocks' shares of the global mean added up:
    JAX's sharded step where MoE capacity is a data shard's."""
    from repro_torch.core import sorting, streaming
    from repro_torch.launch import steps as S
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as tfm
    from repro_torch.train import optimizer as opt_lib

    update = opt_lib.adamw(S.lm_optimizer(opt_memory_efficient))[1]

    def step(model, state, batch):
        model.zero_grad(set_to_none=True)
        tokens, labels = batch["tokens"], batch["labels"]
        n = tokens.shape[0] // shards
        loss, ranks = 0.0, []
        with torch.enable_grad():
            for i in range(shards):
                rows = slice(i * n, (i + 1) * n)
                logits = tfm.logits_train(model, tokens[rows], cfg)
                part = L.cross_entropy(logits, labels[rows]) * (
                    labels[rows].numel() / labels.numel())
                ranks.append(sorting.gold_rank(logits.detach(),
                                               labels[rows]))
                del logits
                part.backward()
                loss = loss + part.detach()
        model, state, info = update(S._grads(model), state, model)
        return model, state, {"loss": loss, **info, **streaming.rank_metrics(
            torch.cat(ranks).reshape(-1))}

    return step


def lm_case(run: _Run, arg: str) -> None:
    from repro_torch.configs.common import smoke_shape
    from repro_torch.launch.api import get_arch
    from repro_torch.models import transformer as tfm

    name, cfg, tag = lm_config(arg, run.size)
    arch = get_arch(name)
    seq, per_shard = LM_SIZES[run.size]
    b = per_shard * run.n_data
    shape = smoke_shape(arch.shapes["train_4k"], seq_len=seq,
                        global_batch=b)
    model = run.model(tag, cfg, tfm.Transformer)
    ref = copy.deepcopy(model)
    rng = np.random.default_rng(run.seed + 30)
    batches = []
    for _ in range(STEPS):
        tokens = rng.integers(0, cfg.vocab_size, (b, seq + 1),
                              dtype=np.int32)
        batches.append({"tokens": tokens[:, :-1].copy(),
                        "labels": tokens[:, 1:].copy()})
    dev = [{k: torch.from_numpy(v).to(run.device) for k, v in x.items()}
           for x in batches]
    case = f"lm:{arg}"
    got = run.train(case, arch.make_step(cfg, shape, run.device, run.mesh),
                    model, dev)
    del model
    plain = arch.make_step(cfg, shape, run.device)
    if cfg.moe is not None and run.n_data > 1:
        # the MoE archs (qwen3, arctic) train with bfloat16 m, factored v
        plain.step_fn = lm_reference_step(cfg, run.n_data, True)
    want = run.train(case, plain, ref, dev)
    run.compare(case, got, want,
                {f"step{i}": x for i, x in enumerate(batches)})


def collectives_case(run: _Run) -> None:
    """Each autograd collective over ``model``, ``data`` and both, with a
    seeded input and cotangent a rank: saved for the test."""
    from repro_torch.distributed import spmd

    mesh = run.mesh
    r = dist.get_rank()
    gen = torch.Generator().manual_seed(run.seed + 40 + r)
    same = torch.Generator().manual_seed(run.seed + 40)
    out = {"coords": torch.tensor([mesh.get_local_rank(a)
                                   for a in mesh.mesh_dim_names])}
    for tag, axes in (("model", "model"), ("data", "data"),
                      ("both", ("data", "model"))):
        m = spmd.axis_size(mesh, axes)
        ops = {
            "psum": (lambda x: spmd.psum(x, mesh, axes),
                     torch.randn(3, 4, generator=gen), (3, 4)),
            "fan_out": (lambda x: spmd.fan_out(x, mesh, axes),
                        torch.randn(3, 4, generator=same), (3, 4)),
            "all_gather": (lambda x: spmd.all_gather(x, 0, mesh, axes),
                           torch.randn(2, 3, generator=gen), (2 * m, 3)),
            "psum_scatter": (lambda x: spmd.psum_scatter(x, 0, mesh, axes),
                             torch.randn(2 * m, 3, generator=gen), (2, 3)),
        }
        for op, (fn, x, out_shape) in ops.items():
            x = x.to(run.device).requires_grad_()
            ct = torch.randn(out_shape, generator=gen).to(run.device)
            y = fn(x)
            y.backward(ct)
            out[f"{tag}/{op}"] = {"x": x.detach(), "y": y.detach(),
                                  "ct": ct, "grad": x.grad}
    run.put("collectives", out)


def ckpt_case(run: _Run) -> None:
    """xDeepFM after one sharded step, saved under this mesh, restored
    under ``(world, 1)``; both gathered (the test restores it under no
    mesh too)."""
    from repro_torch.configs.common import smoke_shape
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import MODELS
    from repro_torch.models import recsys as rec_lib
    from repro_torch.train import checkpoint as C
    from repro_torch.train import optimizer as opt_lib

    arch = get_arch("xdeepfm")
    cfg = arch.make_config(True)
    rows = RECSYS_ROWS["smoke"] * run.n_data
    shape = smoke_shape(arch.shapes["train_batch"], batch=rows)
    bundle = arch.make_step(cfg, shape, run.device, run.mesh)
    model = run.model("xdeepfm", cfg, MODELS["xdeepfm"])
    state = bundle.init_opt(model)
    batch = to_device(_recsys_batch("xdeepfm", cfg, rows, run.seed + 50, 0),
                      run.device)
    sp, state, _ = bundle.step_fn(model, state, batch)
    where = os.path.join(run.out_dir, "ckpt")
    tree = {"params": sp, "opt_state": opt_lib.state_dtensors(
        state, sp.specs, sp.shapes, run.mesh)}
    C.save(where, 1, tree)
    run.put("ckpt/saved", {"params": sp.full(),
                           "m": {n: SH.full_tensor(t) for n, t in
                                 tree["opt_state"].m.items()},
                           "v": {n: SH.full_tensor(t) for n, t in
                                 tree["opt_state"].v.items()},
                           "step": state.step})
    mesh2 = make_host_mesh(1, device=run.device)
    fresh = MODELS["xdeepfm"](cfg, device=run.device)
    target_p = SH.ShardedParams(fresh, rec_lib.table_specs(fresh, "xdeepfm"),
                                mesh2)
    zero = opt_lib.adamw(opt_lib.OptimizerConfig())[0](target_p)
    target = {"params": target_p, "opt_state": opt_lib.state_dtensors(
        zero, target_p.specs, target_p.shapes, mesh2)}
    got, _ = C.restore(where, 1, target)
    st = got["opt_state"]
    run.put("ckpt/restored", {"params": got["params"].full(),
                              "m": {n: SH.full_tensor(t) for n, t in
                                    st.m.items()},
                              "v": {n: SH.full_tensor(t) for n, t in
                                    st.v.items()},
                              "step": st.step,
                              "block": {"table": got["params"]["table"]}})
    run.put("ckpt/restored_mesh", np.asarray(tuple(mesh2.shape)))


def run_cases(mesh, device, size, cases, seed=0, weights=None,
              out_dir=None) -> _Run:
    run = _Run(mesh, device, size, seed, weights, out_dir)
    for case in cases:
        kind, _, arg = case.partition(":")
        if kind == "recsys":
            recsys_case(run, arg)
        elif kind == "gnn":
            gnn_case(run, arg)
        elif kind == "lm":
            lm_case(run, arg)
        elif kind == "collectives":
            collectives_case(run)
        elif kind == "ckpt":
            ckpt_case(run)
        else:
            raise ValueError(f"unknown case {case!r}")
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sharded_train",
        description="Model-parallel training against the unsharded steps "
                    "over a process group (torchrun sets RANK and "
                    "WORLD_SIZE; or pass --store, --rank, --world-size).")
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL ranks (their product is the world)")
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (the card of LOCAL_RANK) or cuda:N")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on CUDA, else gloo)")
    ap.add_argument("--store", default=None)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--size", choices=("smoke", "card"), default="smoke")
    ap.add_argument("--cases", default=None,
                    help="default: SMOKE_CASES, or CARD_CASES with --size "
                         "card")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    rank = args.rank if args.rank is not None else int(
        os.environ.get("RANK", 0))
    world = args.world_size if args.world_size is not None else int(
        os.environ.get("WORLD_SIZE", 1))
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            ap.error("CUDA device requested but torch.cuda.is_available() "
                     "is False; pass --device cpu")
        if device.index is None:
            device = torch.device(
                "cuda", int(os.environ.get("LOCAL_RANK", rank))
                % torch.cuda.device_count())
        torch.cuda.set_device(device)
        # the unsharded reference in float32 without TF32, as JAX's
        torch.backends.cuda.matmul.allow_tf32 = False
    cases = args.cases or ",".join(CARD_CASES if args.size == "card"
                                   else SMOKE_CASES)
    if "ckpt" in cases.split(",") and args.out is None:
        ap.error("the ckpt case needs --out")
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    kw = {"timeout": GROUP_TIMEOUT, "rank": rank, "world_size": world}
    if args.store is not None:
        kw["store"] = dist.FileStore(args.store, world)
    dist.init_process_group(backend, **kw)
    try:
        from repro_torch.launch.mesh import make_host_mesh

        dp, mp = (int(x) for x in args.mesh.split("x"))
        if dp * mp != world:
            ap.error(f"mesh {args.mesh} needs {dp * mp} ranks, have {world}")
        mesh = make_host_mesh(mp, device=device)
        t0 = time.perf_counter()
        run = run_cases(mesh, device, args.size,
                        [c for c in cases.split(",") if c], args.seed,
                        args.weights, args.out)
        seconds = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"rank{rank}.npz"), **run.out)
    print(json.dumps({"rank": rank, "world_size": world, "mesh": args.mesh,
                      "backend": backend, "device": str(device),
                      "launches": run.launches, "errors": run.errors,
                      "held_bytes": run.held,
                      "case_seconds": run.seconds,
                      "seconds": seconds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
