"""Collective helpers over a ``torch.distributed`` process group: the
compressed data-parallel all-reduce and sharded evaluation.

The port of ``repro.distributed.collectives`` in the SPMD form a
``torchrun`` job uses: every rank calls the same function on its own
shard, and ``group=None`` means the default group.  (The JAX package runs
these inside ``shard_map``; its ``shard_map`` shim has no counterpart.)

* :func:`compressed_psum` — the mean of every rank's gradient tree, plain
  (``none``), through bfloat16 (``bf16``) or through int8 with error
  feedback (``int8``);
* :func:`sharded_evaluate` — each rank's local ``EvalBatch`` through the
  measure core, the (sum, count) statistics summed by one ``all_reduce``;
* :func:`compressed_psum_plain` — what :func:`compressed_psum` returns on
  every rank, computed in one process from each rank's inputs: the plain
  version a process group is held against.

Run as a module it is a self-check of both over a group (each rank draws
its seeded shard from :func:`demo_inputs`)::

    torchrun --nproc-per-node 4 -m repro_torch.distributed.collectives \\
        --device cpu --backend gloo
    python -m repro_torch.distributed.collectives --store /tmp/g \\
        --rank 0 --world-size 2 --device cuda:0 --backend gloo --out DIR

Two ranks may share one card only with ``gloo`` (NCCL refuses it); gloo's
``all_reduce`` takes CUDA tensors.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import measures as M
from repro_torch.core import streaming
from repro_torch.distributed import spmd
from repro_torch.train import compression as C

METHODS = ("none", "bf16", "int8")


def _flat(leaves: Sequence[torch.Tensor], dtype) -> torch.Tensor:
    return torch.cat([t.reshape(-1).to(dtype) for t in leaves])


def _split(flat: torch.Tensor, like: Sequence[torch.Tensor]):
    """``flat`` cut back into tensors shaped as ``like``."""
    parts = flat.split([t.numel() for t in like])
    return [p.reshape(t.shape) for p, t in zip(parts, like)]


def _int8_mean(sums, scales, n: int):
    return [C.true_div(t.to(torch.float32) * scales[i], float(n))
            for i, t in enumerate(sums)]


def compressed_psum(grads, method: str = "none", error_state=None,
                    group=None) -> Tuple[object, object]:
    """All-reduce a gradient tree (a tensor or a dict of tensors) over
    ``group`` with compression; returns (mean_grads, new_error_state).

    * ``none`` — a float32 sum over the ranks over the world size, in each
      leaf's dtype.
    * ``bf16`` — each leaf rounded to bfloat16, then summed in float32
      (what the JAX package sums: its ``psum`` of ``g.astype(f32)``).
    * ``int8`` — error-feedback quantization: first one ``all_reduce``
      (MAX) of every leaf's local absmax agrees on the shared scales
      (absmax / 127), then each rank quantizes with them and the int8
      payload is summed as int32.  ``error_state`` (zeros when ``None``)
      carries each rank's residual to the next step.

    All leaves go in one flat ``all_reduce``; the mean is a true division
    by the world size on the data's device.
    """
    if method not in METHODS:
        raise ValueError(f"unknown compression method {method!r}")
    leaves = C.tree_leaves(grads)
    if not leaves:
        return grads, error_state
    n = dist.get_world_size(group)
    if method in ("none", "bf16"):
        src = C.tree_leaves(C.compress_bf16(grads)) if method == "bf16" \
            else leaves
        total = _flat(src, torch.float32)
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        mean = _split(C.true_div(total, float(n)), leaves)
        if method == "none":
            mean = [m.to(g.dtype) for m, g in zip(mean, leaves)]
        return C.tree_unflatten(grads, mean), error_state
    if error_state is None:
        error_state = C.init_error_state(grads)
    errors = C.tree_leaves(error_state)
    # agree on a shared scale FIRST (tiny max), then quantize with it:
    # quantizing locally and dequantizing globally would be biased
    absmax = torch.stack([C.local_absmax(g, e)
                          for g, e in zip(leaves, errors)])
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    scales = C.true_div(absmax, 127.0)
    out = [C.quantize_int8(g, e, scales[i])
           for i, (g, e) in enumerate(zip(leaves, errors))]
    total = _flat([q for q, _, _ in out], torch.int32)  # the int8 payload
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    mean = _int8_mean(_split(total, leaves), scales, n)
    return (C.tree_unflatten(grads, mean),
            C.tree_unflatten(grads, [e for _, _, e in out]))


def compressed_psum_plain(grads_per_rank: Sequence, method: str = "none",
                          errors_per_rank: Optional[Sequence] = None):
    """:func:`compressed_psum` of ``len(grads_per_rank)`` ranks computed in
    one process: returns (the mean every rank gets, the list of each
    rank's new error state).  Sums run in rank order."""
    if method not in METHODS:
        raise ValueError(f"unknown compression method {method!r}")
    n = len(grads_per_rank)
    like = grads_per_rank[0]
    per_rank = [C.tree_leaves(g) for g in grads_per_rank]
    leaves = per_rank[0]
    if method in ("none", "bf16"):
        if method == "bf16":
            per_rank = [[t.to(torch.bfloat16) for t in r] for r in per_rank]
        total = _flat(per_rank[0], torch.float32)
        for r in per_rank[1:]:
            total = total + _flat(r, torch.float32)
        mean = _split(C.true_div(total, float(n)), leaves)
        if method == "none":
            mean = [m.to(g.dtype) for m, g in zip(mean, leaves)]
        return C.tree_unflatten(like, mean), errors_per_rank
    if errors_per_rank is None:
        errors_per_rank = [C.init_error_state(g) for g in grads_per_rank]
    errs = [C.tree_leaves(e) for e in errors_per_rank]
    absmax = None
    for g_r, e_r in zip(per_rank, errs):
        local = torch.stack([C.local_absmax(g, e) for g, e in zip(g_r, e_r)])
        absmax = local if absmax is None else torch.maximum(absmax, local)
    scales = C.true_div(absmax, 127.0)
    total, new_errs = None, []
    for g_r, e_r in zip(per_rank, errs):
        out = [C.quantize_int8(g, e, scales[i])
               for i, (g, e) in enumerate(zip(g_r, e_r))]
        flat = _flat([q for q, _, _ in out], torch.int32)
        total = flat if total is None else total + flat
        new_errs.append(C.tree_unflatten(like, [e for _, _, e in out]))
    mean = _int8_mean(_split(total, leaves), scales, n)
    return C.tree_unflatten(like, mean), new_errs


def sharded_evaluate(batch: M.EvalBatch, measures: Tuple[str, ...],
                     group=None,
                     relevance_level: float = 1.0) -> Dict[str, torch.Tensor]:
    """Corpus means of ``measures`` over every rank's local ``batch``.

    The pytrec_eval pattern across processes: each rank evaluates its own
    queries with the batched measure core (``streaming.metric_update``),
    and one ``all_reduce`` of the (sum, count) statistics
    (``streaming.metric_finalize(state, group)``) gives every rank the
    same means.  Returns a dict of 0-d tensors on the batch's device.
    """
    state = streaming.metric_init(tuple(measures),
                                  device=batch.query_mask.device)
    state = streaming.metric_update(state, batch, tuple(measures),
                                    relevance_level)
    # metric_finalize's one all_reduce of the stacked [sums..., count]
    spmd.record("all-reduce", sum(v.numel() * v.element_size()
                                  for v in state.values()))
    return streaming.metric_finalize(
        state, group if group is not None else dist.group.WORLD)


# -- the self-check -----------------------------------------------------------

DEMO_MEASURES = ("ndcg", "recip_rank", "map", "P_5")
DEMO_QUERIES, DEMO_DOCS = 32, 40
#: seconds for the group's start and for each collective
GROUP_TIMEOUT = timedelta(seconds=60)


def demo_inputs(seed: int, world_size: int) -> Dict[str, object]:
    """Seeded inputs of the self-check, as numpy: each rank's gradient
    dict and error state (``"grads"``, ``"errors"``: lists by rank) and
    one dense ``[DEMO_QUERIES, DEMO_DOCS]`` batch (``"scores"``,
    ``"rel"``) whose query axis the ranks split in equal blocks.

    Leaf ``"half"`` lands on exact half-way points of the int8 grid: its
    shared absmax is 127 on rank 0, so its scale is 1.0 and every value
    ``k + 0.5`` rounds half to even; its error state is 0.
    """
    if DEMO_QUERIES % world_size:
        raise ValueError(f"{DEMO_QUERIES} queries do not split over "
                         f"{world_size} ranks")
    rng = np.random.default_rng(seed)
    grads, errors = [], []
    for r in range(world_size):
        half = (rng.integers(-60, 60, 24) + 0.5).astype(np.float32)
        if r == 0:
            half[0] = 127.0
        g = {"w": rng.standard_normal((16, 12)).astype(np.float32),
             "b": (rng.standard_normal(12) * 1e-3).astype(np.float32),
             "emb": {"table": (rng.standard_normal((50, 8)) * 4
                               ).astype(np.float32)},
             "half": half}
        e = {k: (rng.standard_normal(v.shape) * 1e-2).astype(np.float32)
             for k, v in (("w", g["w"]), ("b", g["b"]))}
        e["b"] *= 1e-3
        e["emb"] = {"table": (rng.standard_normal((50, 8)) * 1e-2
                              ).astype(np.float32)}
        e["half"] = np.zeros_like(half)
        grads.append(g)
        errors.append(e)
    scores = rng.standard_normal((DEMO_QUERIES, DEMO_DOCS)
                                 ).astype(np.float32)
    rel = rng.integers(0, 3, (DEMO_QUERIES, DEMO_DOCS)).astype(np.float32)
    return {"grads": grads, "errors": errors, "scores": scores, "rel": rel}


def _to_torch(tree, device):
    return C.tree_map(lambda a: torch.from_numpy(np.array(a)).to(device),
                      tree)


def flatten(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """A tree of tensors as ``{"a/b": numpy array}`` (for ``np.savez``)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree.detach().to("cpu").numpy()}


def run_self_check(rank: int, world_size: int, device, seed: int = 0,
                   group=None) -> Dict[str, np.ndarray]:
    """This rank's part of the self-check on an initialised group:
    :func:`compressed_psum` by every method from the rank's seeded
    gradients and error state, and :func:`sharded_evaluate` on its block
    of the seeded batch.  Returns the results, flattened."""
    data = demo_inputs(seed, world_size)
    grads = _to_torch(data["grads"][rank], device)
    errors = _to_torch(data["errors"][rank], device)
    out = {}
    for method in METHODS:
        mean, err = compressed_psum(
            grads, method, errors if method == "int8" else None, group)
        out.update(flatten(mean, f"{method}/mean/"))
        if method == "int8":
            out.update(flatten(err, "int8/error/"))
    rows = DEMO_QUERIES // world_size
    lo = rank * rows
    batch = M.batch_from_dense(
        torch.from_numpy(data["scores"][lo:lo + rows]).to(device),
        torch.from_numpy(data["rel"][lo:lo + rows]).to(device))
    aggs = sharded_evaluate(batch, DEMO_MEASURES, group)
    out.update(flatten(aggs, "eval/"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.distributed.collectives",
        description="Self-check of compressed_psum and sharded_evaluate "
                    "over a process group (torchrun sets RANK and "
                    "WORLD_SIZE; or pass --store, --rank, --world-size).")
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda (the card of LOCAL_RANK) or cuda:N")
    ap.add_argument("--backend", default=None,
                    help="gloo or nccl (default: nccl on CUDA, else gloo)")
    ap.add_argument("--store", default=None,
                    help="a FileStore path shared by the ranks")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world-size", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="directory for rank<R>.npz with every result")
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
    backend = args.backend or ("nccl" if device.type == "cuda" else "gloo")
    if args.store is not None:
        store = dist.FileStore(args.store, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
    else:
        dist.init_process_group(backend, rank=rank, world_size=world,
                                timeout=GROUP_TIMEOUT)
    try:
        out = run_self_check(rank, world, device, args.seed)
    finally:
        dist.destroy_process_group()
    if args.out is not None:
        os.makedirs(args.out, exist_ok=True)
        np.savez(os.path.join(args.out, f"rank{rank}.npz"), **out)
    if rank == 0:
        print(json.dumps({
            "world_size": world, "backend": backend, "device": str(device),
            "aggregates": {k[5:]: float(v) for k, v in out.items()
                           if k.startswith("eval/")}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
