"""Shared shape tables and helpers for the config modules."""

from __future__ import annotations

from repro_torch.launch.api import ShapeSpec


def recsys_shapes(slate: int = 1024):
    return {
        "train_batch": ShapeSpec("train_batch", "train",
                                 (("batch", 65_536),)),
        "serve_p99": ShapeSpec("serve_p99", "serve",
                               (("batch", 512), ("slate", slate))),
        "serve_bulk": ShapeSpec("serve_bulk", "serve",
                                (("batch", 262_144),)),
        "retrieval_cand": ShapeSpec(
            "retrieval_cand", "retrieval",
            (("batch", 1), ("n_candidates", 1_000_000), ("topk", 1000))),
    }


def smoke_shape(spec: ShapeSpec, **overrides) -> ShapeSpec:
    meta = dict(spec.meta)
    meta.update(overrides)
    return ShapeSpec(spec.name, spec.kind, tuple(meta.items()))
