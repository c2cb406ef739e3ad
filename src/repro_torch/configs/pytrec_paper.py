"""The paper's own workload as an arch: the batched evaluator.

The counterpart of ``repro.configs.pytrec_paper``.  Shapes mirror the
paper's benchmark grid corners (Fig. 1): the largest configuration (10,000
queries × 1,000 docs) plus a deep-ranking cell (1,024 queries × 65,536
candidate docs).  The "model" is the measure core itself: the step takes
one padded batch and returns the corpus means of every measure, on one
device.  The JAX step pads the query axis to a multiple of its mesh; this
one has no mesh, so the query axis stays as the shape gives it.

``EvalConfig.engine`` picks the engine: ``"sorted"`` ranks every query
with the full sort (``core.measures.compute_measures``), ``"ranked"``
reduces over the judged documents' ranks
(``core.ranked.compute_measures_ranked``).  Neither runs a kernel of its
own: in the JAX package both are XLA.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import measures as M
from repro_torch.device import resolve_device
from repro_torch.launch.api import (ArchDef, ShapeSpec, StepBundle,
                                    TensorSpec, register)

MEASURES = ("map", "ndcg", "ndcg_cut", "P", "recall", "recip_rank",
            "Rprec", "bpref", "success", "map_cut")
_PARSED = M.parse_measures(MEASURES)
ENGINES = ("sorted", "ranked")


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    name: str
    relevance_level: float = 1.0
    # "sorted": the full-sort measure core; "ranked": the rank-reduction
    # engine (core/ranked.py), exact, without a sort of the document axis
    engine: str = "sorted"


SHAPES = {
    "eval_10k_1k": ShapeSpec("eval_10k_1k", "serve",
                             (("n_queries", 10_000), ("n_docs", 1000),
                              ("n_judged", 128))),
    "eval_1k_64k": ShapeSpec("eval_1k_64k", "serve",
                             (("n_queries", 1024), ("n_docs", 65_536),
                              ("n_judged", 128))),
}


def make_config(smoke: bool = False) -> EvalConfig:
    return EvalConfig(name="pytrec-eval-smoke" if smoke else "pytrec-eval")


def batch_specs(engine: str, q: int, d: int, j: int):
    """The step's batch at (Q, D, J) as a tree of :class:`TensorSpec`: an
    ``EvalBatch`` for ``"sorted"``, a ``RankedBatch`` for ``"ranked"``."""
    from repro_torch.core import ranked as RK

    f32, i32, b_ = torch.float32, torch.int32, torch.bool

    def spec(*shape_dtype):
        *shape, dtype = shape_dtype
        return TensorSpec(tuple(shape), dtype)

    if engine == "ranked":
        return RK.RankedBatch(
            scores=spec(q, d, f32), tiebreak=spec(q, d, i32),
            mask=spec(q, d, b_),
            judged_scores=spec(q, j, f32), judged_tiebreak=spec(q, j, i32),
            judged_rel=spec(q, j, f32), judged_retrieved=spec(q, j, b_),
            judged_mask=spec(q, j, b_), ideal_rel=spec(q, j, f32),
            n_rel=spec(q, f32), n_judged_nonrel=spec(q, f32),
            query_mask=spec(q, b_))
    if engine == "sorted":
        return M.EvalBatch(
            scores=spec(q, d, f32), tiebreak=spec(q, d, i32),
            rel=spec(q, d, f32), judged=spec(q, d, b_),
            mask=spec(q, d, b_),
            ideal_rel=spec(q, j, f32), n_rel=spec(q, f32),
            n_judged_nonrel=spec(q, f32), query_mask=spec(q, b_))
    raise ValueError(f"unknown engine {engine!r} (expected one of {ENGINES})")


def _mesh_group(mesh):
    """The process group of every rank of ``mesh`` (it must span the
    default group)."""
    import torch.distributed as dist

    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the eval step's mesh of {mesh.size()} ranks must "
                         f"span the default group's {dist.get_world_size()}")
    return dist.group.WORLD


def _make_step(cfg: EvalConfig, shape: ShapeSpec, device=None,
               mesh=None) -> StepBundle:
    """The evaluation step at ``shape`` on ``device`` (default CUDA; raises
    without it): batch in, ``{measure key: corpus mean}`` out (0-d
    tensors on the device, the same on every rank of ``mesh``)."""
    from repro_torch.core import ranked as RK

    dev = resolve_device(device)
    q = shape.get("n_queries")
    if mesh is not None:
        m = mesh.size()
        q = -(-q // m) * m  # pad the query axis to a mesh multiple
    specs = batch_specs(cfg.engine, q, shape.get("n_docs"),
                        shape.get("n_judged"))
    if mesh is not None:
        return StepBundle(_mesh_step(cfg, mesh), (specs,), dev, mesh=mesh)
    if cfg.engine == "ranked":
        @torch.inference_mode()
        def eval_step(batch: RK.RankedBatch):
            per_q = RK.compute_measures_ranked(batch, _PARSED,
                                               cfg.relevance_level)
            return M.aggregate(per_q, batch.query_mask)
    else:
        @torch.inference_mode()
        def eval_step(batch: M.EvalBatch):
            per_q = M.compute_measures(batch, _PARSED, cfg.relevance_level)
            return M.aggregate(per_q, batch.query_mask)

    return StepBundle(eval_step, (specs,), dev)


def _mesh_step(cfg: EvalConfig, mesh):
    from repro_torch.core import ranked as RK
    from repro_torch.distributed import collectives
    from repro_torch.distributed import sharding as SH
    from repro_torch.distributed import spmd

    qaxes = tuple(mesh.mesh_dim_names)  # queries over EVERY axis

    @torch.inference_mode()
    def eval_step(batch):
        local = type(batch)(*(SH.local_input(t, (qaxes,), mesh)
                              for t in batch))
        if cfg.engine != "ranked":
            return collectives.sharded_evaluate(
                local, MEASURES, _mesh_group(mesh), cfg.relevance_level)
        per_q = RK.compute_measures_ranked(local, _PARSED,
                                           cfg.relevance_level)
        keys = sorted(per_q)
        qm = local.query_mask.to(torch.float32)
        sums = torch.stack([torch.sum(per_q[k] * qm) for k in keys]
                           + [torch.sum(qm)])
        sums = spmd.psum(sums, mesh, qaxes)
        count = torch.clamp(sums[-1], min=1.0)
        return {k: sums[i] / count for i, k in enumerate(keys)}

    return eval_step


ARCH = register(ArchDef(
    name="pytrec-eval",
    family="eval",
    shapes=SHAPES,
    make_config=make_config,
    make_step=_make_step,
    notes="The paper's contribution itself: one padded batch in, the "
          "corpus mean of every measure out.",
))
