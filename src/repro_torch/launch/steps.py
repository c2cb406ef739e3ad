"""Family step builders: LM train / prefill / decode, recsys train /
serve / retrieval and GNN train.

The counterpart of ``repro.launch.steps``.  As in the JAX
package, ranking metrics are computed inside the step from the scores
already on the device (the port's ``core.measures`` for slates,
``core.sorting.gold_rank`` and ``core.streaming.rank_metrics`` in the GNN
and LM steps), so evaluation never crosses the host boundary:
only the metric scalars do.  Retrieval ranks with the port's top-k kernel
(``kernels.ops.topk``: ``lax.top_k``'s order, ties to the lower index)
where the JAX step calls ``lax.top_k``.

Each step takes the model (an ``nn.Module``) in the JAX step's ``params``
slot, with the same remaining arguments.  Serve and retrieval steps run
under ``torch.inference_mode``.  A train step is ``step_fn(model,
opt_state, batch) → (model, opt_state, metrics)`` with JAX's optimizer
(``train.optimizer.adamw``) and JAX's metric keys; it updates the model's
parameters in place, leaves their gradients in ``.grad`` until the next
step, and reads nothing back to the host.  ``bundle.init_opt(model)``
gives the optimizer's first state.  The LM ``prefill`` and ``decode``
steps run under ``torch.inference_mode``; ``decode`` writes the KV cache
it is given in place (JAX's step donates it) and takes ``pos`` as a
Python int.

With a ``mesh`` (a ``DeviceMesh`` with JAX's axis names, see
``launch.mesh``) the serving steps run model-parallel, every rank
calling the step with the same full inputs (or DTensors) and taking its
own block by JAX's ``in_shardings``: LM ``prefill`` and ``decode``
(``models.transformer``'s TP / EP path; the model may be passed as it is
or already laid out by ``transformer.shard_params``), recsys ``serve``
(``serve_p99`` and ``serve_bulk``: the batch over the data axes, the
tables row-sharded over ``model``, each rank's lookups through B3 on its
block) and ``retrieval`` (the candidates split over ``model``: each rank
scores its block and takes its top-k with B2, and a second B2 over the
gathered ``m·k`` (value, index) pairs merges them, ties to the lower
index and NaN last as one top-k over all of them).  Sharded outputs come
back as DTensors laid out as JAX's ``out_shardings``; metrics are the
same on every rank.

A ``train`` kind with a mesh is JAX's GSPMD step written rank-locally:
each rank holds its blocks of the parameters (a
``sharding.ShardedParams``, or the LM's ``ShardedTransformer``) and of
the optimizer state (``train.optimizer.opt_state_partition_specs``),
takes its block of the batch, and after the step the gathered
parameters, optimizer state and metrics are those of the same step
without a mesh.  The step takes the model as it is (laid out on the
first call, ``sharding.train_layout``: the rank keeps copies of its
blocks and the model's split parameters are dropped) or as a previous
step returned it, and returns the laid-out one; ``bundle.init_opt``
gives the state's blocks.  Each replicated
parameter's gradient is summed over the axes on which the ranks' work
differs and its spec does not split (:func:`reduce_grads`):

* recsys: the batch over the data axes, the tables row-sharded over
  ``model`` (B3 forward and B3-bwd backward on each rank's rows), the
  dense weights replicated; the loss is the global batch's mean;
* LM: the TP / EP path of serving under autograd, FSDP ``gather`` mode,
  the vocab-parallel cross-entropy (``layers.vocab_parallel_nll``) and
  gold rank (``transformer.gold_rank_block``); ``fsdp`` and
  ``opt_memory_efficient`` as in JAX.  MoE capacity comes from a data
  shard's tokens, as in JAX;
* GNN: n padded to a multiple of the data ranks and e of the mesh (JAX's
  padding, masked); the edges split over the whole mesh, the nodes over
  the data axes, and each data block's nodes further over ``model`` in
  the step, so that no work is repeated on two ranks
  (``gnn.gatedgcn_forward`` with the mesh); the weights are replicated and
  their gradients summed over every axis.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import measures as M
from repro_torch.core import sorting, streaming
from repro_torch.device import resolve_device
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import spmd
from repro_torch.kernels import ops
from repro_torch.launch.api import ShapeSpec, StepBundle, TensorSpec
from repro_torch.models import gnn as gnn_lib
from repro_torch.models import layers as L
from repro_torch.models import recsys as rec_lib
from repro_torch.models import transformer as tfm
from repro_torch.train import optimizer as opt_lib

I32 = torch.int32
F32 = torch.float32
BOOL = torch.bool

SERVE_MEASURES = ("ndcg_cut", "recip_rank", "success")
_PARSED_SERVE = M.parse_measures(SERVE_MEASURES)

MODELS = {"sasrec": rec_lib.SASRec, "xdeepfm": rec_lib.XDeepFM,
          "autoint": rec_lib.AutoInt, "mind": rec_lib.MIND}
_CTR_SCORE = {"xdeepfm": rec_lib.xdeepfm_score,
              "autoint": rec_lib.autoint_score}


def _slate_metrics(scores, rel) -> Dict[str, torch.Tensor]:
    """In-loop evaluation of a slate ``[B, D]`` against binary labels."""
    batch = M.batch_from_dense(scores.to(F32), rel.to(F32))
    per_q = M.compute_measures(batch, _PARSED_SERVE)
    agg = M.aggregate(per_q, batch.query_mask)
    return {k: agg[k] for k in ("ndcg_cut_10", "recip_rank", "success_10")}


def reduce_grads(params, mesh, axes) -> Dict[str, torch.Tensor]:
    """Every block's gradient of ``params`` (a ``ShardedParams``; zeros
    where none reached it) summed over those of ``axes`` its spec does
    not split: a replicated parameter's share from this rank's block of
    the work, made whole."""
    out = {}
    for name, p in params.items():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        split = SH.split_axes(params.specs[name], mesh)
        out[name] = spmd.psum(g, mesh, tuple(a for a in axes
                                             if a not in split))
    return out


def _zero_grads(params) -> None:
    for p in params.values():
        p.grad = None


def _rank_metrics(ranks, mask=None, mesh=None, axes=()):
    """``streaming.rank_metrics`` of this rank's gold ranks, the sums and
    counts summed over ``axes`` first."""
    return streaming.rank_metrics(
        ranks, mask, reduce=lambda t: spmd.psum(t, mesh, axes))


def _sharded_adamw(ocfg, model, specs, mesh):
    """AdamW on the blocks of ``model``'s parameters laid out by
    ``specs``: ``(init, update)`` of the blocks."""
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    return opt_lib.adamw(ocfg, mesh, specs, shapes)


def _slate_scores(kind, cfg, params, batch, cand):
    """Scores of per-user candidate slates ``[B, S_cand]``."""
    ce = rec_lib.rows_of(params.item_emb, cand)  # [B, S, D]
    if kind == "sasrec":
        h = rec_lib.sasrec_last_state(params, batch["items"], cfg)
        return torch.einsum("bd,bsd->bs", h, ce)
    caps = rec_lib.mind_interests(params, batch, cfg)  # [B, K, D]
    return torch.max(torch.einsum("bkd,bsd->bks", caps, ce), dim=1).values


def _grads(model) -> Dict[str, torch.Tensor]:
    """Every parameter's gradient by name (zeros where none reached it,
    as JAX's ``grad`` gives)."""
    return {n: p.grad if p.grad is not None else torch.zeros_like(p)
            for n, p in model.named_parameters()}


def _spec_tree(tree):
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    if isinstance(tree, dict):
        return {k: _spec_tree(v) for k, v in tree.items()}
    return type(tree)(*(_spec_tree(v) for v in tree))


def _opt_specs(init_opt, params: Dict[str, TensorSpec]):
    """The optimizer state's specs, from its init on ``meta`` tensors."""
    return _spec_tree(init_opt({n: torch.empty(s.shape, dtype=s.dtype,
                                                device="meta")
                                for n, s in params.items()}))


def param_specs(kind: str, cfg) -> Dict[str, TensorSpec]:
    """The model's parameters by name, as specs (built on ``meta``: no
    memory is allocated)."""
    return _module_specs(MODELS[kind](cfg, device="meta"))


def _module_specs(model) -> Dict[str, TensorSpec]:
    return {n: TensorSpec(tuple(p.shape), p.dtype)
            for n, p in model.named_parameters()}


def _input_specs(kind: str, cfg, b: int) -> Dict[str, TensorSpec]:
    if kind == "sasrec":
        seq = cfg.seq_len
        return {"items": TensorSpec((b, seq), I32),
                "pos": TensorSpec((b, seq), I32),
                "neg": TensorSpec((b, seq), I32),
                "mask": TensorSpec((b, seq), BOOL)}
    if kind == "mind":
        hl = cfg.hist_len
        return {"hist": TensorSpec((b, hl), I32),
                "hist_mask": TensorSpec((b, hl), BOOL),
                "pos": TensorSpec((b,), I32),
                "negs": TensorSpec((b, 20), I32)}
    out = {"ids": TensorSpec((b, cfg.table.n_fields), I32),
           "labels": TensorSpec((b,), I32)}
    if cfg.n_multi_hot:
        mh = (b, cfg.n_multi_hot, cfg.multi_hot_len)
        out["mh_ids"] = TensorSpec(mh, I32)
        out["mh_mask"] = TensorSpec(mh, BOOL)
    return out


def _recsys_sharding(mesh):
    if mesh is None:
        return None
    from repro_torch.launch.mesh import data_axes_of

    return SH.RecSysSharding(data_axes=data_axes_of(mesh))


def _batch_block(batch, mesh, shd):
    """Each input's block of this rank's data shard (JAX's ``P(batch,
    ...)`` in_specs)."""
    return {k: SH.local_input(v, (shd.batch,), mesh) for k, v in
            batch.items()}


def sharded_topk(scores, k: int, first: int, mesh, axis: str):
    """Top-k (values, global indices) of the rows of ``scores`` ``[B, N]``
    whose columns are split over ``axis`` (this rank's block starts at
    column ``first``): B2 on the block, then B2 over the ``m·k`` (value,
    index) pairs gathered in rank order, so ties go to the lower index
    and NaN last, as in one top-k of the whole row.  Needs k <= the
    block's width."""
    if k > scores.shape[1]:
        raise ValueError(f"top-{k} of a block of {scores.shape[1]} "
                         f"columns: the block must hold k")
    v, i = ops.topk(scores.contiguous(), k)
    if spmd.axis_size(mesh, axis) == 1:
        return v, i
    return merge_topk(spmd.all_gather(v, 1, mesh, axis),
                      spmd.all_gather((i + first).contiguous(), 1, mesh,
                                      axis), k)


def merge_topk(values, indices, k: int):
    """The top k of the blocks' top-k (value, global index) pairs laid
    side by side in block order ``[B, m·k]``: one B2 call over the
    values, its positions mapped to the indices."""
    mv, j = ops.topk(values.contiguous(), k)
    return mv, torch.gather(indices, 1, j.long())


def recsys_step_bundle(kind: str, cfg, shape: ShapeSpec, device=None,
                       mesh=None) -> StepBundle:
    """The ``train``, ``serve`` or ``retrieval`` step of ``kind`` at
    ``shape``, on ``device`` (default CUDA; raises without it), sharded
    over ``mesh`` when given."""
    if kind not in MODELS:
        raise ValueError(f"unknown recsys arch {kind!r}")
    dev = resolve_device(device)
    params = param_specs(kind, cfg)
    shd = _recsys_sharding(mesh)

    def view(model, blocks=False, local=None):
        """The model as a sharded step reads it: its tables
        vocab-parallel on the mesh (``local``: trainable blocks)."""
        return rec_lib.shard_tables(model, kind, mesh, shd.model_axis,
                                    blocks, local)

    if shape.kind == "train":
        b = shape.get("batch")
        ocfg = opt_lib.OptimizerConfig(lr=1e-3)
        init_opt, update = opt_lib.adamw(ocfg)
        arg_specs = (params, _opt_specs(init_opt, params),
                     _input_specs(kind, cfg, b))
        if mesh is None:
            def train_step(params, opt_state, batch):
                params.zero_grad(set_to_none=True)
                loss = rec_lib.loss_and_grad(kind, params, batch, cfg)
                params, opt_state, info = update(_grads(params), opt_state,
                                                 params)
                return params, opt_state, {"loss": loss, **info}

            return StepBundle(train_step, arg_specs, dev, init_opt=init_opt)

        meta = MODELS[kind](cfg, device="meta")
        specs = rec_lib.table_specs(meta, kind, shd.model_axis)
        s_init, s_update = _sharded_adamw(ocfg, meta, specs, mesh)

        def laid_out(model):
            if isinstance(model, SH.ShardedParams):
                return model
            return SH.train_layout(model, specs, mesh)

        def train_step(params, opt_state, batch):
            sp = laid_out(params)
            _zero_grads(sp)
            loss = rec_lib.loss_and_grad(
                kind, view(sp.module, local=sp),
                _batch_block(batch, mesh, shd), cfg, mesh=mesh,
                data_axes=shd.data_axes)
            _, opt_state, info = s_update(
                reduce_grads(sp, mesh, shd.data_axes), opt_state, sp)
            return sp, opt_state, {"loss": loss, **info}

        def init(params):
            return s_init(laid_out(params))

        return StepBundle(train_step, arg_specs, dev, init_opt=init,
                          mesh=mesh)

    if shape.kind == "serve":
        b = shape.get("batch")
        slate = shape.get("slate", 0)
        inputs = _input_specs(kind, cfg, b)
        if kind in ("sasrec", "mind") and slate:
            # online ranking: score a per-user candidate slate + in-loop eval
            @torch.inference_mode()
            def serve(params, batch, cand, rel):
                if mesh is None:
                    scores = _slate_scores(kind, cfg, params, batch, cand)
                    return scores, _slate_metrics(scores, rel)
                scores = _slate_scores(
                    kind, cfg, view(params), _batch_block(batch, mesh, shd),
                    SH.local_input(cand, (shd.batch, None), mesh))
                every = spmd.all_gather(scores, 0, mesh, shd.data_axes)
                return (SH.from_local(scores, (shd.batch, None), mesh,
                                      (cand.shape[0], slate)),
                        _slate_metrics(every, SH.full_tensor(rel)))

            return StepBundle(serve, (params, inputs,
                                      TensorSpec((b, slate), I32),
                                      TensorSpec((b, slate), I32)), dev,
                              mesh=mesh)

        def scores_of(params, batch):
            if kind == "sasrec":
                h = rec_lib.sasrec_last_state(params, batch["items"], cfg)
                cand = rec_lib.rows_of(params.item_emb, batch["pos"][:, -1])
                return torch.sum(h * cand, -1)
            if kind == "mind":
                caps = rec_lib.mind_interests(params, batch, cfg)
                cand = rec_lib.rows_of(params.item_emb, batch["pos"])
                return torch.max(torch.einsum("bkd,bd->bk", caps, cand),
                                 dim=-1).values
            return _CTR_SCORE[kind](params, batch, cfg)

        @torch.inference_mode()
        def serve(params, batch):
            if mesh is None:
                return scores_of(params, batch)
            n = next(iter(batch.values())).shape[0]
            scores = scores_of(view(params), _batch_block(batch, mesh, shd))
            return SH.from_local(scores, (shd.batch,), mesh, (n,))

        return StepBundle(serve, (params, inputs), dev, mesh=mesh)

    if shape.kind == "retrieval":
        b = shape.get("batch")
        nc = shape.get("n_candidates")
        topk = shape.get("topk", 1000)
        # batch = 1: the user's inputs stay replicated; the candidates are
        # split over `model` (JAX's in_specs)

        def block(cand_ids):
            first = SH.local_bounds(cand_ids.shape, (shd.model_axis,),
                                    mesh)[0][0]
            return SH.local_input(cand_ids, (shd.model_axis,), mesh), first

        def rank(scores, first, rel):
            v, i = sharded_topk(scores, topk, first, mesh, shd.model_axis)
            every = spmd.all_gather(scores, 1, mesh, shd.model_axis)
            return v, i, _slate_metrics(every, SH.full_tensor(rel))

        if kind in ("sasrec", "mind"):
            retrieval = (rec_lib.sasrec_retrieval_scores if kind == "sasrec"
                         else rec_lib.mind_retrieval_scores)

            @torch.inference_mode()
            def serve(params, batch, cand_ids, rel):
                if mesh is None:
                    scores = retrieval(params, {**batch,
                                                "candidates": cand_ids}, cfg)
                    v, i = ops.topk(scores.contiguous(), topk)
                    return v, i, _slate_metrics(scores, rel)
                p = view(params)
                ids, first = block(cand_ids)
                rows = p.item_emb.lookup_blocks(ids[:, None])
                scores = retrieval(p, {**batch, "candidate_rows": rows}, cfg)
                return rank(scores, first, rel)

            arg_specs = (params, _input_specs(kind, cfg, b),
                         TensorSpec((nc,), I32), TensorSpec((b, nc), I32))
        else:
            # CTR: broadcast user fields over the candidate set (field 0 is
            # the item id field)
            def score_ids(params, user_ids, cand_ids):
                ids = user_ids.expand(cand_ids.shape[0],
                                      cfg.table.n_fields).clone()
                ids[:, 0] = cand_ids
                return _CTR_SCORE[kind](params, {"ids": ids}, cfg)[None, :]

            @torch.inference_mode()
            def serve(params, batch, cand_ids, rel):
                if mesh is None:
                    scores = score_ids(params, batch["ids"], cand_ids)
                    v, i = ops.topk(scores.contiguous(), topk)
                    return v, i, _slate_metrics(scores, rel)
                ids, first = block(cand_ids)
                # each rank's candidates differ: the lookups gather the
                # ids over `model` and reduce-scatter the rows back
                scores = score_ids(view(params, blocks=True), batch["ids"],
                                   ids)
                return rank(scores, first, rel)

            arg_specs = (params,
                         {"ids": TensorSpec((1, cfg.table.n_fields), I32)},
                         TensorSpec((nc,), I32), TensorSpec((1, nc), I32))
        return StepBundle(serve, arg_specs, dev, mesh=mesh)

    raise ValueError(f"unsupported recsys shape kind {shape.kind}")


# ===========================================================================
# LM family
# ===========================================================================


def lm_optimizer(opt_memory_efficient: bool = False
                 ) -> opt_lib.OptimizerConfig:
    """JAX's LM AdamW: lr 3e-4, 50 warm-up steps, cosine to 20,000;
    bfloat16 m and factored v when ``opt_memory_efficient``."""
    ocfg = opt_lib.OptimizerConfig(lr=3e-4, warmup_steps=50,
                                   decay_steps=20_000)
    if opt_memory_efficient:
        ocfg = dataclasses.replace(ocfg, momentum_dtype="bfloat16",
                                   factored_v=True)
    return ocfg


def lm_step_bundle(cfg: tfm.TransformerConfig, shape: ShapeSpec,
                   device=None, opt_memory_efficient: bool = False,
                   mesh=None, fsdp: bool = False) -> StepBundle:
    """The LM step of ``shape.kind`` on ``device`` (default CUDA; raises
    without it), sharded over ``mesh`` when given (``fsdp``: expert
    weights also split over the last data axis; decode gathers the
    tokens instead of the weights, JAX's ``activation`` mode).

    * ``train``: ``step_fn(model, opt_state, {"tokens", "labels"})`` →
      (model, opt_state, metrics): cross-entropy, JAX's LM AdamW
      (:func:`lm_optimizer`), and the gold token's rank
      (``sorting.gold_rank`` on the detached logits) with
      ``streaming.rank_metrics``.
    * ``prefill``: ``step_fn(model, tokens, max_seq=None)`` → (last
      logits, KV cache padded with zeros to ``max_seq`` slots, default
      the prompt's length; JAX's bundle always gives the prompt's).
    * ``decode``: ``step_fn(model, cache, token, pos, gold)`` → (logits,
      cache written in place, rank metrics of ``gold``).

    With a mesh ``model`` may be a ``Transformer`` (laid out on each
    call) or ``transformer.shard_params``'s result; the logits and the
    cache are DTensors and the gold rank comes from the vocab-sharded
    logits (``transformer.gold_rank_sharded``).  A sharded ``train`` step
    lays the model out for training (``shard_params(..., train=True)``),
    returns the ``ShardedTransformer`` it updated, and ``init_opt`` the
    state's blocks.
    """
    dev = resolve_device(device)
    params = _module_specs(tfm.Transformer(cfg, device="meta"))
    b, s = shape.get("global_batch"), shape.get("seq_len")
    shd = None
    if mesh is not None:
        from repro_torch.launch.mesh import data_axes_of

        # decode gathers activations, not weight shards (JAX's choice)
        shd = SH.LMSharding(
            data_axes=data_axes_of(mesh), fsdp_experts=fsdp,
            moe_fsdp_mode="activation" if shape.kind == "decode"
            else "gather")

    def laid_out(model, train=False):
        if mesh is None or isinstance(model, tfm.ShardedTransformer):
            return model
        return tfm.shard_params(model, mesh, shd, train)

    if shape.kind == "train":
        ocfg = lm_optimizer(opt_memory_efficient)
        init_opt, update = opt_lib.adamw(ocfg)
        tokens = TensorSpec((b, s), I32)
        arg_specs = (params, _opt_specs(init_opt, params),
                     {"tokens": tokens, "labels": tokens})
        if mesh is None:
            def train_step(params, opt_state, batch):
                params.zero_grad(set_to_none=True)
                labels = batch["labels"]
                with torch.enable_grad():
                    logits = tfm.logits_train(params, batch["tokens"], cfg)
                    loss = L.cross_entropy(logits, labels)
                    ranks = sorting.gold_rank(logits.detach(), labels)
                    del logits  # autograd keeps what it needs, not these
                    loss.backward()
                params, opt_state, info = update(_grads(params), opt_state,
                                                 params)
                metrics = {"loss": loss.detach(), **info,
                           **streaming.rank_metrics(ranks.reshape(-1))}
                return params, opt_state, metrics

            return StepBundle(train_step, arg_specs, dev, init_opt=init_opt)

        meta = tfm.Transformer(cfg, device="meta")
        s_init, s_update = _sharded_adamw(
            ocfg, meta, tfm.flat_partition_specs(cfg, shd), mesh)
        v0 = tfm.vocab_block(cfg, mesh, shd)[0]

        def train_step(params, opt_state, batch):
            st = laid_out(params, train=True)
            _zero_grads(st.params)
            labels = SH.local_input(batch["labels"], (shd.batch, None), mesh)
            count = float(batch["labels"].numel())  # the global batch's
            with torch.enable_grad():
                logits = tfm.logits_train(st, batch["tokens"], cfg, mesh,
                                          shd)
                nll = L.vocab_parallel_nll(logits, labels, v0, mesh,
                                           shd.model_axis)
                part = torch.sum(nll) / count
                ranks = tfm.gold_rank_block(logits.detach(), labels, v0,
                                            mesh, shd.model_axis)
                del logits, nll
                part.backward()
            _, opt_state, info = s_update(
                reduce_grads(st.params, mesh, shd.data_axes), opt_state,
                st.params)
            metrics = {"loss": spmd.psum(part.detach(), mesh,
                                         shd.data_axes), **info,
                       **_rank_metrics(ranks.reshape(-1), None, mesh,
                                       shd.data_axes)}
            return st, opt_state, metrics

        def init(params):
            return s_init(laid_out(params, train=True).params)

        return StepBundle(train_step, arg_specs, dev, init_opt=init,
                          mesh=mesh)

    if shape.kind == "prefill":
        @torch.inference_mode()
        def prefill_step(params, tokens, max_seq=None):
            return tfm.prefill(laid_out(params), tokens, cfg,
                               max_seq=max_seq, mesh=mesh, shd=shd)

        return StepBundle(prefill_step, (params, TensorSpec((b, s), I32)),
                          dev, mesh=mesh)

    if shape.kind == "decode":
        kv = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)

        @torch.inference_mode()
        def decode(params, cache, token, pos, gold):
            logits, cache = tfm.decode_step(laid_out(params), cache, token,
                                            pos, cfg, mesh, shd)
            ranks = (sorting.gold_rank(logits, gold) if mesh is None else
                     tfm.gold_rank_sharded(logits, gold, mesh, shd))
            return logits, cache, streaming.rank_metrics(ranks)

        cache = {"k": TensorSpec(kv, cfg.torch_dtype),
                 "v": TensorSpec(kv, cfg.torch_dtype)}
        return StepBundle(decode, (params, cache, TensorSpec((b,), I32),
                                   TensorSpec((), I32),
                                   TensorSpec((b,), I32)), dev, mesh=mesh)

    raise ValueError(f"unsupported LM shape kind {shape.kind}")


# ===========================================================================
# GNN family
# ===========================================================================


def _gnn_input_specs(cfg: gnn_lib.GatedGCNConfig, shape: ShapeSpec,
                     n=None, e=None):
    n = n or shape.get("n_nodes")
    e = e or shape.get("n_edges")
    out = {"node_feat": TensorSpec((n, cfg.d_in), F32),
           "edge_feat": TensorSpec((e, cfg.d_edge_in), F32),
           "src": TensorSpec((e,), I32), "dst": TensorSpec((e,), I32),
           "labels": TensorSpec((n,), I32),
           "node_mask": TensorSpec((n,), BOOL),
           "edge_mask": TensorSpec((e,), BOOL)}
    if shape.get("graph_task", False):
        out["graph_ids"] = TensorSpec((n,), I32)
        out["graph_labels"] = TensorSpec((shape.get("n_graphs"),), I32)
    return out


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


_NODE_KEYS = ("node_feat", "labels", "node_mask", "graph_ids", "train_mask")
_EDGE_KEYS = ("edge_feat", "src", "dst", "edge_mask")


def pad_graph(batch, n: int, e: int):
    """The batch with its node arrays padded to n rows and its edge arrays
    to e (zeros, masks False: padded edges join node 0 with a zero gate,
    padded nodes count nowhere), as JAX's sharded step expects them."""
    out = dict(batch)
    for keys, size in ((_NODE_KEYS, n), (_EDGE_KEYS, e)):
        for k in keys:
            if k in out and out[k].shape[0] < size:
                x = out[k]
                pad = x.new_zeros((size - x.shape[0],) + tuple(x.shape[1:]))
                out[k] = torch.cat([x, pad])
    return out


def _node_blocks(batch, n: int, mesh, shd: SH.GNNSharding):
    """This rank's node block and edge block of a padded batch: the node
    arrays' data block (JAX's ``P(batch)``) cut again over ``model``
    (each block padded to one size), the edge arrays' block of the whole
    mesh, and ``src``/``dst`` renumbered into the blocks laid end to end
    in rank order."""
    n_data = spmd.axis_size(mesh, shd.data_axes)
    m = spmd.axis_size(mesh, shd.model_axis)
    r = spmd.axis_index(mesh, shd.model_axis)
    nb = n // n_data
    sub = -(-nb // m)
    out = {}
    for k in _NODE_KEYS:
        if k in batch:
            x = SH.local_input(batch[k], (shd.batch,), mesh)
            lo, hi = min(r * sub, nb), min((r + 1) * sub, nb)
            x = x[lo:hi]
            if hi - lo < sub:
                x = torch.cat([x, x.new_zeros((sub - (hi - lo),)
                                              + tuple(x.shape[1:]))])
            out[k] = x
    espec = shd.edges()
    for k in _EDGE_KEYS:
        x = SH.local_input(batch[k], espec, mesh)
        if k in ("src", "dst"):
            g = x.long()
            x = (g // nb) * (m * sub) + g % nb
        out[k] = x
    return out


def gnn_step_bundle(cfg: gnn_lib.GatedGCNConfig, shape: ShapeSpec,
                    device=None, mesh=None) -> StepBundle:
    """GatedGCN's ``train`` step at ``shape`` on ``device`` (default CUDA;
    raises without it): the node task (cross-entropy over the masked
    nodes; a batch may carry a ``train_mask``) or the graph task (logits
    mean-pooled per graph), each with the gold class's rank
    (``sorting.gold_rank``) and ``streaming.rank_metrics`` in the step.
    With a ``mesh``: JAX's padding of n and e (the step pads a shorter
    batch itself, :func:`pad_graph`), the batch's blocks by JAX's
    in_shardings cut as :func:`_node_blocks` says, ``gnn.gatedgcn_forward``
    on the blocks; the weights and the optimizer state stay replicated
    (the step returns the model)."""
    if shape.kind != "train":
        raise ValueError(f"unsupported GNN shape kind {shape.kind}")
    dev = resolve_device(device)
    graph_task = shape.get("graph_task", False)
    params = _module_specs(gnn_lib.GatedGCN(cfg, device="meta"))
    init_opt, update = opt_lib.adamw(opt_lib.OptimizerConfig(lr=1e-3))
    n_pad = e_pad = None
    every = ()
    if mesh is not None:
        from repro_torch.launch.mesh import data_axes_of

        shd = SH.GNNSharding(data_axes=data_axes_of(mesh))
        every = tuple(mesh.mesh_dim_names)
        n_data = spmd.axis_size(mesh, shd.data_axes)
        n_ranks = spmd.axis_size(mesh, every)
        n_pad = _pad_to(shape.get("n_nodes"), n_data)
        e_pad = _pad_to(shape.get("n_edges"), n_ranks)

    def forward(params, batch):
        """(logits of the nodes this rank holds, its node arrays)."""
        if mesh is not None:
            n = _pad_to(batch["node_feat"].shape[0], n_data)
            e = _pad_to(batch["src"].shape[0], n_ranks)
            batch = _node_blocks(pad_graph(batch, n, e), n, mesh, shd)
        return gnn_lib.gatedgcn_forward(params, batch, cfg, mesh,
                                        every), batch

    def total(x):
        """The sum of each rank's share over the mesh."""
        return spmd.psum(x, mesh, every)

    def losses(params, batch):
        """(loss of the whole batch, scores, labels, mask) for the ranks
        of this rank's rows (every graph's with the graph task)."""
        logits, nodes = forward(params, batch)
        if graph_task:
            # disjoint-union batch: mean-pool nodes per graph
            n_graphs = shape.get("n_graphs")
            node_mask = nodes["node_mask"]
            gids = nodes["graph_ids"].long()
            pooled = total(gnn_lib.segment_sum(
                logits * node_mask[:, None], gids, n_graphs))
            cnt = total(gnn_lib.segment_sum(node_mask.to(F32), gids,
                                            n_graphs))
            pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]
            labels = SH.full_tensor(batch["graph_labels"])
            loss = L.cross_entropy(pooled, labels)
            return loss, pooled, labels, torch.ones_like(labels, dtype=BOOL)
        mask = nodes["node_mask"] & nodes.get("train_mask",
                                              nodes["node_mask"])
        labels = nodes["labels"]
        m = mask.to(F32)
        # L.cross_entropy's masked mean, its sums over the whole mesh
        loss = total(torch.sum(L.token_nll(logits, labels) * m)) \
            / torch.clamp(total(torch.sum(m)), min=1.0)
        return loss, logits, labels, mask

    def train_step(params, opt_state, batch):
        params.zero_grad(set_to_none=True)
        with torch.enable_grad():
            loss, scores, labels, mask = losses(params, batch)
            loss.backward()
        ranks = sorting.gold_rank(scores.detach(), labels)
        # every rank's work differs: each weight's share is summed
        grads = {k: total(g) for k, g in _grads(params).items()}
        params, opt_state, info = update(grads, opt_state, params)
        metrics = {"loss": loss.detach(), **info,
                   **_rank_metrics(ranks.reshape(-1), mask.reshape(-1),
                                   mesh, () if graph_task else every)}
        return params, opt_state, metrics

    return StepBundle(train_step, (params, _opt_specs(init_opt, params),
                                   _gnn_input_specs(cfg, shape, n_pad,
                                                    e_pad)),
                      dev, init_opt=init_opt, mesh=mesh)
