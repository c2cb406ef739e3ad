"""RecSys serve and retrieval steps with in-loop evaluation.

The counterpart of ``repro.launch.steps`` for the recsys family, ``serve``
and ``retrieval`` kinds.  As in the JAX package, ranking metrics are
computed inside the step from the scores already on the device (the port's
``core.measures``), so evaluation never crosses the host boundary: only
the metric scalars do.  Retrieval ranks with the port's top-k kernel
(``kernels.ops.topk``: ``lax.top_k``'s order, ties to the lower index)
where the JAX step calls ``lax.top_k``.

Each step takes the model (an ``nn.Module`` from ``models.recsys``) in the
JAX step's ``params`` slot, with the same remaining arguments, and runs
under ``torch.inference_mode``.
"""

from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import measures as M
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.launch.api import ShapeSpec, StepBundle, TensorSpec
from repro_torch.models import recsys as rec_lib

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


def _slate_scores(kind, cfg, params, batch, cand):
    """Scores of per-user candidate slates ``[B, S_cand]``."""
    ce = params.item_emb[cand.long()]  # [B, S, D]
    if kind == "sasrec":
        h = rec_lib.sasrec_last_state(params, batch["items"], cfg)
        return torch.einsum("bd,bsd->bs", h, ce)
    caps = rec_lib.mind_interests(params, batch, cfg)  # [B, K, D]
    return torch.max(torch.einsum("bkd,bsd->bks", caps, ce), dim=1).values


def param_specs(kind: str, cfg) -> Dict[str, TensorSpec]:
    """The model's parameters by name, as specs (built on ``meta``: no
    memory is allocated)."""
    model = MODELS[kind](cfg, device="meta")
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


def recsys_step_bundle(kind: str, cfg, shape: ShapeSpec,
                       device=None) -> StepBundle:
    """The ``serve`` or ``retrieval`` step of ``kind`` at ``shape``, on
    ``device`` (default CUDA; raises without it)."""
    if kind not in MODELS:
        raise ValueError(f"unknown recsys arch {kind!r}")
    dev = resolve_device(device)
    params = param_specs(kind, cfg)

    if shape.kind == "train":
        raise NotImplementedError(
            "recsys training is not ported yet (ROADMAP Queue A, "
            "\"Recsys training\": optimizer, gradients through the "
            "EmbeddingBag kernel)")

    if shape.kind == "serve":
        b = shape.get("batch")
        slate = shape.get("slate", 0)
        inputs = _input_specs(kind, cfg, b)
        if kind in ("sasrec", "mind") and slate:
            # online ranking: score a per-user candidate slate + in-loop eval
            @torch.inference_mode()
            def serve(params, batch, cand, rel):
                scores = _slate_scores(kind, cfg, params, batch, cand)
                return scores, _slate_metrics(scores, rel)

            return StepBundle(serve, (params, inputs,
                                      TensorSpec((b, slate), I32),
                                      TensorSpec((b, slate), I32)), dev)

        @torch.inference_mode()
        def serve(params, batch):
            if kind == "sasrec":
                h = rec_lib.sasrec_last_state(params, batch["items"], cfg)
                cand = params.item_emb[batch["pos"][:, -1].long()]
                return torch.sum(h * cand, -1)
            if kind == "mind":
                caps = rec_lib.mind_interests(params, batch, cfg)
                cand = params.item_emb[batch["pos"].long()]
                return torch.max(torch.einsum("bkd,bd->bk", caps, cand),
                                 dim=-1).values
            return _CTR_SCORE[kind](params, batch, cfg)

        return StepBundle(serve, (params, inputs), dev)

    if shape.kind == "retrieval":
        b = shape.get("batch")
        nc = shape.get("n_candidates")
        topk = shape.get("topk", 1000)

        if kind in ("sasrec", "mind"):
            retrieval = (rec_lib.sasrec_retrieval_scores if kind == "sasrec"
                         else rec_lib.mind_retrieval_scores)

            @torch.inference_mode()
            def serve(params, batch, cand_ids, rel):
                scores = retrieval(params, {**batch, "candidates": cand_ids},
                                   cfg)
                v, i = ops.topk(scores.contiguous(), topk)
                return v, i, _slate_metrics(scores, rel)

            arg_specs = (params, _input_specs(kind, cfg, b),
                         TensorSpec((nc,), I32), TensorSpec((b, nc), I32))
        else:
            # CTR: broadcast user fields over the candidate set (field 0 is
            # the item id field)
            @torch.inference_mode()
            def serve(params, batch, cand_ids, rel):
                nfields = cfg.table.n_fields
                ids = batch["ids"].expand(nc, nfields).clone()
                ids[:, 0] = cand_ids
                scores = _CTR_SCORE[kind](params, {"ids": ids}, cfg)[None, :]
                v, i = ops.topk(scores.contiguous(), topk)
                return v, i, _slate_metrics(scores, rel)

            arg_specs = (params,
                         {"ids": TensorSpec((1, cfg.table.n_fields), I32)},
                         TensorSpec((nc,), I32), TensorSpec((1, nc), I32))
        return StepBundle(serve, arg_specs, dev)

    raise ValueError(f"unsupported recsys shape kind {shape.kind}")
