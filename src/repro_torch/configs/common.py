"""Shared shape tables and helpers for the config modules."""

from __future__ import annotations

from repro_torch.launch.api import ShapeSpec

FULL_ATTN_SKIP = ("sub-quadratic attention required; this arch is pure "
                  "full attention (see DESIGN.md §Arch-applicability)")


def lm_shapes():
    return {
        "train_4k": ShapeSpec("train_4k", "train",
                              (("seq_len", 4096), ("global_batch", 256))),
        "prefill_32k": ShapeSpec("prefill_32k", "prefill",
                                 (("seq_len", 32768), ("global_batch", 32))),
        "decode_32k": ShapeSpec("decode_32k", "decode",
                                (("seq_len", 32768), ("global_batch", 128))),
        "long_500k": ShapeSpec("long_500k", "decode",
                               (("seq_len", 524288), ("global_batch", 1)),
                               skip_reason=FULL_ATTN_SKIP),
    }


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
