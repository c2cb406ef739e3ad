#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, in parallel), then drives the port's paths through the entry
points a user calls:

* A. ``python -m repro_torch`` (in-process, ``--device cuda``) on the
  conformance fixtures, plain and ``--sharded``: both must byte-match
  ``tests/fixtures/conformance.golden``; ``python -m
  repro_torch.compare`` on the three sweep fixtures, plain and
  ``--sharded``, must byte-match ``tests/fixtures/compare.golden``.
* B. The paper's largest grid corner (10,000 queries x 1,000 docs, 128
  judged per query, the paper's measure set), built from the seed and fed
  through ``buffer_from_arrays``: ``RelevanceEvaluator.evaluate_buffer``
  (full sort + measure core) against ``ShardedEvaluator.evaluate_buffer``
  (fused kernel).  Count columns bit-identical, the rest within
  atol = rtol = 2e-4.
* C. Deep candidates (1,024 queries x 65,536 docs, integer tokens through
  ``buffer_from_tokens``) with depth-bounded measures, so the evaluator
  routes through the top-k kernel; held against the full-sort route on the
  same buffer.  The same buffer then goes through
  ``ShardedEvaluator.evaluate_buffer`` (the fused kernel at
  ``[1,024, 65,536]``, its long-row regime), held against the full-sort
  results the same way.
* E. Recsys serving at full width (xDeepFM, SASRec, AutoInt, MIND from
  ``make_config(False)``, weights from a seeded ``torch.Generator`` on the
  card), through ``get_arch(name).make_step(cfg, shape)``: 20 timed
  ``serve_p99`` requests per arch (SASRec and MIND rank 1,024-item slates
  with in-loop ndcg_cut_10 / recip_rank / success_10), one xDeepFM
  ``serve_bulk`` batch (262,144 rows; one EmbeddingBag launch covers its
  three multi-hot fields, as in every xDeepFM call) and ``retrieval_cand``
  (10^6 candidates, top 1,000 through one call of the top-k kernel, which
  splits the row over two launches) for SASRec and xDeepFM.  Requests
  come from ``data/recsys_data`` with the seed; head rows of each answer are recomputed on the CPU with the
  same weights (atol = rtol = 1e-4) and the in-loop metrics recomputed on
  the CPU from the card's scores (2e-4).
* F. A Robust04-sized hyperparameter sweep: 64 runs x 249 queries x 1,000
  docs (128 judged, grades -1..3, the paper's measure set), one buffer
  from the seed re-scored 64 times (``with_scores``), through
  ``evaluate_sweep`` on both backends: ``"single"`` bit-identical to 64
  ``evaluate_buffer`` calls, ``"sharded"`` (B1, 8 calls of one launch at
  ``[2,048, 1,024]``) with count columns exact and the rest within TOL,
  the first 4 runs against the CPU port.  Then ``significance_report``
  on the ``[64, 249]`` ``map`` table (t-test and 2,000 sign flips) on the
  card against the CPU (t within 1e-4 of max(|t|, 1), p within 1e-5),
  exact enumeration on 16 queries equal to the CPU's, Monte Carlo within
  5 sigma of it.  The rank-reduction engine on phase B's batch against
  the sorted engine (count columns exact, the rest within TOL), with its
  seconds and peak memory.
* G. The paper's Q-learning demo: ``build_collection()`` at its defaults,
  20 episodes (alpha 0.1, gamma 0.95, epsilon 0.05) with the
  environment's evaluator on the card, then a fixed action sequence on
  the card against the CPU port (rewards within 2e-4); ms per step.
* N. NaN scores on the card: phase C's buffer with a seeded 1% of its
  scores NaN (all the relevant documents of 8 queries among them), plus
  phase C's first queries again as rows of 1 to 1,500 documents (some
  shorter than k = 1,000), through the evaluator's top-k route (B2)
  against the full sort: count columns bit-identical, the rest within
  TOL.  B2 against its plain version on that NaN matrix and on phase E's
  ``[1, 10^6]`` row with 1% NaN (indices exact, values bit for bit), and
  SASRec ``retrieval_cand`` with NaN item embeddings on 1% of the
  candidates against the CPU.
* H. The paper's surface and the service.  ``python -m
  repro_torch.baselines.trec_eval_cli`` byte-matches the JAX baseline's
  recorded output; the child's start-up with and without the import of
  the CLI (no torch, numpy or JAX in it); RQ1 (``bench_rq1.py``'s grid:
  in-process ``RelevanceEvaluator(...).evaluate`` on the card against
  ``workflow.serialize_invoke_parse``) and RQ2 (``bench_rq2.py``'s
  depths: ``evaluate`` against ``native_ndcg.ndcg``, values within TOL).
  ``get_arch("pytrec-eval")`` at ``eval_10k_1k`` (phase B's batch) and
  ``eval_1k_64k`` (phase C's), both engines: ranked and sorted agree
  (count aggregates exact), and the sorted step equals the mean of
  ``evaluate_buffer``'s per-query results within TOL; step ms and peak
  memory.  The service over TCP (``serve.testing.ServerThread`` on the
  card, the port's ``EvalClient``): phase F's qrel as a ``"single"`` and a
  ``"sharded"`` (B1) collection and a depth-bounded one (B2), 64
  concurrent re-scored requests, each bit-identical to a direct
  ``evaluate_buffer``, with fewer backend calls than requests; one
  ``compare`` of 8 runs equal to ``significance_report`` on their
  ``evaluate_sweep`` table; ``python -m repro_torch.serve --device
  cuda`` through ``EvalClient.spawn_stdio``, its ``map`` equal to the
  CLI's.  Every child process and client call has a timeout.
* K. The serve cluster on the card: ``serve.cluster.testing.ClusterThread``
  with 2 workers (``python -m repro_torch.serve --device cuda``),
  replication 2 and a durable journal in TMPDIR.  The card's free memory,
  read here, falls by at least 2 x WORKER_MIN_BYTES once the workers
  have registered and evaluated; phase H's three collections (each
  registration naming its backend: ``"single"``, ``"sharded"`` with B1
  in the workers, the depth-bounded one with B2) answer 32 concurrent
  re-scored requests through the router, each bit-identical to
  ``evaluate_buffer`` here on the card (p50, p99, the router's counters,
  the summed backend calls).  The primary replica of ``"sharded"`` is
  stopped, given a request and SIGKILLed: the sibling answers it (bit
  for bit) before the slot's next generation is back with its journal
  replayed (its restart seconds: backoff, torch import, CUDA context,
  replay); ``drop_qrel`` with both replicas killed is
  ``worker_unavailable``.  A new cluster on the same state dir answers
  ``conformance.run`` byte-matching ``conformance.golden``; ``python -m
  repro_torch.serve.cluster --workers 2 --device cuda`` answers one
  request and exits 0 on SIGTERM with its client connected, leaving no
  worker process.  Every boot, client call, poll and child has a
  timeout.  The kernels run in the workers, so their launch counts are
  not read here.
* T. Training on the card.  The four recsys archs at full width
  (``make_config(False)``, seeded weights) and ``train_batch`` (65,536
  rows): ``make_step(cfg, shape)``'s train step with its
  ``init_opt`` state, 3 optimizer steps each (step ms, the median of
  steps 2-3; rows/s; peak device bytes; the row chunks the dense part
  took; loss, grad_norm and lr per step, finite), one more step
  profiled; xDeepFM's steps must launch B3 and B3-bwd.  Then one step of
  1,024 rows at full width on the card, from the seed's weights and a
  fresh ``init_opt`` state (the same every run), under
  ``torch.cuda.set_sync_debug_mode("error")``, against the same step on
  the CPU (the kernels' plain versions) from the same weights and
  optimizer state: loss, grad_norm and lr within 2e-4; a ReLU input on
  the other side of 0 than the CPU's must be a tie (within 1e-5 of its
  call's largest |x|), and where there are any, the CPU step runs again
  with the card's sides of 0; every entry of every parameter's gradient
  (the table's touched rows with the rest) within 2e-4 · |g| + 2e-4 ·
  max|g| of the CPU's (see RELU_TIE_TOL).  B3-bwd at the train_batch
  shape: two launches bit for bit equal, within 1e-6 of its plain
  version on the card, bit for bit its plain version on the CPU.  GatedGCN at full width (16 layers, d 70) on
  ``full_graph_sm``, ``molecule`` (the graph task) and ``minibatch_lg``
  (a random graph at the padded subgraph's size): 3 steps each with the
  in-loop rank metrics, one more profiled, ``full_graph_sm`` against the
  CPU as above.  ``ogb_products`` is reckoned, not run.
* L. The LM family on the card, through ``get_arch(name).make_step``.
  L1: each of the five smoke configs (float32, seeded weights) on the
  card against the CPU from the same weights: ``logits_train``; one
  ``train`` step under ``set_sync_debug_mode("error")`` (loss, grad_norm,
  lr and the rank metrics within 2e-4, the gradients as phase T's);
  ``prefill`` and 4 ``decode`` steps (logits and cache within
  2e-4).  For qwen3 and arctic every MoE route is logged on both devices
  and the tokens whose expert or capacity slot differ are counted; only
  rows whose routes agree are held.  L2: olmo-1b at full width and depth
  (bfloat16, 1.18B parameters): ``train_4k`` at OLMO_TRAIN_BATCH
  sequences of 4,096 (step ms, tokens/s, peak bytes, one profiled step),
  ``prefill`` at OLMO_PREFILL_SEQ (the 32k shape's score bytes printed
  as a shape spec), ``decode_32k`` at OLMO_DECODE_BATCH from a seeded
  cache at pos 32,767 (ms a token, tokens/s, the byte bound), and
  ``prefill`` + ``decode_step`` against ``logits_train`` on the same
  tokens within LM_BF16_TOL of the largest logit (float32's gap
  printed beside it).  L3: qwen3-moe-235b at full width, QWEN3_LAYERS
  of its 94 layers: ``prefill`` at 4,096 with the share of routed
  choices capacity dropped, and 4 ``decode`` steps.  The full phi3,
  nemotron, qwen3 and arctic configs are printed as shape specs
  (parameter bytes, training state bytes, the depth one card holds).
  No LM path may launch B1, B2 or B3.
* S. The query axis split on the card: ``ShardedEvaluator`` on phase B's
  batch over the mesh ``("cuda:0",) * n`` for n = 1, 2, 3 and 4 (and over
  every visible card when there are several): per-query tables bit for
  bit one shard's, aggregates within TOL, B1 launched n times a call
  (read from the counts), ms a call and a dispatch.  One card per mesh
  exercises the split, not a second card.  A NCCL group of one rank:
  ``collectives.sharded_evaluate`` on phase B's batch against the
  streaming aggregates (TOL), ``compressed_psum`` (none, bf16, int8) on
  a seeded gradient dict of SASRec's full-width parameter shapes bit for
  bit ``compressed_psum_plain`` on the CPU (int8: payload, scale and
  error state, two steps); ``quantize_int8`` on NaN, +-inf, all-zero and
  +-3e38 inputs against the CPU (values, NaN equal to NaN, and bits).
  Two ranks of ``python -m
  repro_torch.distributed.collectives`` on cuda:0 in a gloo group, held
  against one process on the CPU, beside ``python -m repro_torch.dev
  sharded-smoke --device cuda``: started after the timed work, every
  child under a timeout.
* P. Model-parallel serving over a ``DeviceMesh`` (``make_step(cfg,
  shape, device, mesh)``).  P1: a NCCL group of one, mesh (1, 1): olmo-1b
  at full width and depth (bfloat16; ``prefill`` of 4,096 tokens and 4
  ``decode`` steps) and qwen3-moe at full width with QWEN3_LAYERS layers
  (the expert-parallel branch with every expert local), each against the
  same steps without a mesh from the same weights (within LM_BF16_TOL of
  the largest logit; qwen3 under deterministic algorithms: the prefill
  bit for bit, each decode step within LM_BF16_TOL, or P_MOE_TOL where a
  token went to another expert, two planted routing faults that the
  prefill must catch and one that decode must, finite),
  phase E's SASRec ``retrieval_cand`` (top-k values and indices
  identical) and xDeepFM ``serve_bulk`` (1e-4), B2 and B3 launched by
  the mesh steps.  P2: two gloo ranks on cuda:0, mesh (1, 2), ``python
  -m repro_torch.launch.sharded_serve --size card``: olmo-1b at full width
  with 2 layers (1,024 tokens, 4 decode steps, the cache
  sequence-sharded), SASRec's 10^6 candidates split in 2 (B2 a block and
  the B2 merge), xDeepFM's table row-sharded in 2 (B3 a shard), each rank
  against the unsharded steps, each shard's B2 and B3 launches as the C
  entry points count them.  P3: ``python -m repro_torch.launch.dryrun``
  on P_DRYRUN_CELLS on the (16, 16) and (2, 16, 16) fake meshes, every
  record read by ``roofline.analyze``.  Every child has a timeout.
* Q. Model-parallel training over a ``DeviceMesh`` (a ``train``
  ``make_step`` with a mesh).  Q1: a NCCL group of one, mesh (1, 1):
  xDeepFM at train_batch (65,536 rows, the 39M x 10 table; B3 and B3-bwd
  launched by the mesh steps), olmo-1b at full width and depth
  (bfloat16, OLMO_TRAIN_BATCH x 4,096), GatedGCN minibatch_lg and
  qwen3-moe at full width with the deepest stack whose reckoned training
  bytes fit (printed first; ``fsdp`` and the bfloat16 m / factored v);
  the two bfloat16 LMs and GatedGCN under deterministic algorithms (a
  scatter-add otherwise adds in no fixed order, and a ReLU input at 0
  may take either side); Q_STEPS steps each from the seed's weights and
  a fresh state against the same steps without a mesh: parameters, m, v
  and metrics held group by group, each at its own scale (``q_limits``:
  each leaf's norm of m and v within Q_NORM_TOL, the bfloat16 LMs'
  within LM_BF16_TOL and their entries by phase T's gradient gate at
  LM_BF16_TOL; the metrics within GRAD_TOL), whether bit for bit; for
  olmo-1b a control run with its smallest parameter's gradient doubled,
  which must break a limit; step ms, peak bytes and the busy share of
  one more profiled step.  Q2: two gloo ranks on cuda:0, mesh (1, 2),
  ``python -m repro_torch.launch.sharded_train --size card``: xDeepFM at
  65,536 rows with its table row-sharded in 2 (B3 and B3-bwd on each
  rank's half), olmo-1b at full width with 2 layers and 2 x 1,024
  tokens, GatedGCN full_graph_sm with its edges padded to the mesh, each
  rank's gathered result after 2 steps against the unsharded steps
  (``q_limits`` group by group), each shard's B3 and B3-bwd launches.
  Q3: the dry run's train cells (Q_DRYRUN_CELLS) on the (16, 16) and (2,
  16, 16) fake meshes, every record read by ``roofline.analyze``.
* D. Each kernel against its plain PyTorch version on the main paths'
  inputs, with median times, the plain version's time, one PyTorch call's
  time where one computes the same function (``torch.topk``,
  ``F.embedding_bag``; timed only, the port never calls them), the bound,
  the launch counts from B, C and E and the kernels that one wrapper call
  launched (as their C entry points count them): B1 at phase B's batch,
  at phase C's (``[1,024, 65,536]``, two launches a call: the
  rank-term table, then the rows), at one group of phase F's sharded
  sweep (``[2,048, 1,024]``) and at one shard of phase S's 4-shard mesh
  (``[4,096, 1,024]``), B2 at ``[1,024, 65,536]`` (phase C)
  and ``[1, 10^6]`` (phase E), B3's all-fields call at the ``serve_bulk``
  batch (phase E), with its general sort-and-CSR wrapper at one field's
  bags beside it, B3-bwd at phase T's train_batch bags (the op, its
  grouping and its kernel apart, the gradient's zero fill as a
  yardstick, the backward of ``F.embedding_bag`` timed beside
  it, the heaviest slab and the longest run), and phase P's shards: B2 on
  one of two candidate blocks (``[1, 500,000]``), B2's merge of the two
  blocks' top 1,000 (``[1, 2,000]``, equal to one B2 over the row) and
  B3 on one of two row shards of the xDeepFM table at the serve_bulk
  bags; and phase Q's: B3 and B3-bwd on one of two row shards of the
  table at train_batch's bags, and B3-bwd at Q2's two other launches on
  that shard, the fields (one Zipf id a bag) and the linear term (E = 1,
  39 lookups a bag), each bit for bit the CPU plain version, equal on two
  launches and within the summation-order limit of its atomic plain
  version (``F.embedding_bag`` and its backward on the half table timed
  beside them).

Every phase prints one JSON line; any failure raises and exits non-zero.
The last lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

#: paper grid corner (configs/pytrec_paper.py) and its measure set
PAPER_Q, PAPER_D, PAPER_J = 10_000, 1_000, 128
PAPER_MEASURES = ("map", "ndcg", "ndcg_cut", "P", "recall", "recip_rank",
                  "Rprec", "bpref", "success", "map_cut")
#: deep-candidate cell (configs/pytrec_paper.py) with depth-bounded measures
DEEP_Q, DEEP_D, DEEP_J = 1_024, 65_536, 128
DEPTH_MEASURES = ("P", "recall", "ndcg_cut", "map_cut", "success")

#: f32 operations per rank of the fused pass (fused_measures_plain's
#: expression count: scans, divisions, the bpref term, log2 and pow)
FUSED_FLOPS_PER_RANK = 40

TOL = 2e-4
EXACT_PREFIXES = ("num_", "P_", "recall_", "success_", "judged_")
EXACT_KEYS = ("Rprec", "recip_rank")  # ratios of counts: exact as well


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def bound(nbytes, flops=0.0):
    """The least time of a kernel on the card, ``bound_ms`` and
    ``bound_by``, from the H100 figures of
    ``repro_torch.analysis.roofline`` (float32 operations)."""
    from repro_torch.analysis import roofline

    seconds, by = roofline.bound(nbytes, flops)
    return {"bound_ms": seconds * 1e3, "bound_by": by}


def is_exact(key: str) -> bool:
    return key.startswith(EXACT_PREFIXES) or key in EXACT_KEYS


def compare_results(got, want, tol=TOL):
    """Exact keys bit-identical, the rest within atol = rtol = tol.
    Returns (number of values compared, max abs difference)."""
    check(got.keys() == want.keys(), "query sets differ")
    n, worst = 0, 0.0
    for qid, row in want.items():
        other = got[qid]
        check(row.keys() == other.keys(), f"{qid}: key sets differ")
        for k, v in row.items():
            g = other[k]
            n += 1
            worst = max(worst, abs(g - v))
            if is_exact(k):
                check(g == v, f"{qid} {k}: {g!r} != {v!r} (exact column)")
            else:
                check(abs(g - v) <= tol + tol * abs(v),
                      f"{qid} {k}: {g!r} vs {v!r} beyond {tol}")
    return n, worst


def time_ms(fn, iters=20, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events around each call)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def split_times(ev, buf, compute, topk_layout=False):
    """Seconds of one evaluation in three parts: the host scatter into a
    padded batch plus its copy to the card, the device computation of the
    ``[Q, K]`` table, and the table's copy back.  A second, profiled pass
    sums the time the card was busy (kernels and copies), and the busy
    share is that over the unprofiled pass's total."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def once():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        batch = ev.batch_from_buffer(buf, topk_layout=topk_layout)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        table = compute(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        table.cpu()
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2

    batch_s, compute_s, fetch_s = once()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        once()
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    total = batch_s + compute_s + fetch_s
    return {"batch_s": batch_s, "compute_s": compute_s, "fetch_s": fetch_s,
            "device_busy_s": busy_us / 1e6,
            "device_busy_share": busy_us / 1e6 / total}


def _kernel_modules():
    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import fused_measures as FM
    from repro_torch.kernels import topk as TK

    return {"fused_measures": FM, "topk": TK, "embedding_bag": EB}


def zero_launches():
    """Set every kernel's launch count to 0 (just before a path runs)."""
    mods = _kernel_modules()
    for mod in mods.values():
        mod.LAUNCHES = 0
    mods["embedding_bag"].BACKWARD_LAUNCHES = 0


def read_launches():
    mods = _kernel_modules()
    out = {name: mod.LAUNCHES for name, mod in mods.items()}
    out["embedding_bag_backward"] = mods["embedding_bag"].BACKWARD_LAUNCHES
    return out


def _stacked(cols):
    import torch

    return torch.stack(list(cols.values()))


# -- phases -------------------------------------------------------------------


def _golden(name):
    with open(os.path.join(FIXTURES, name), newline="") as fh:
        return fh.read()


def _cli_modes(main, args, golden, what):
    """``main`` plain and ``--sharded`` must print ``golden`` byte for
    byte."""
    modes = {}
    for extra in ([], ["--sharded"]):
        buf = io.StringIO()
        rc = main([*extra, *args], out=buf)
        check(rc == 0, f"{what} {extra} exited {rc}")
        check(buf.getvalue() == golden,
              f"{what} {extra} output differs from its golden")
        modes["sharded" if extra else "plain"] = "byte-match"
    return modes


def phase_cli(device):
    from repro_torch import cli, compare

    qrel = os.path.join(FIXTURES, "conformance.qrel")
    run = os.path.join(FIXTURES, "conformance.run")
    runs = [run] + [os.path.join(FIXTURES, n)
                    for n in ("sweep_b.run", "sweep_c.run")]
    golden = _golden("conformance.golden")
    compare_golden = _golden("compare.golden")
    return {"phase": "A",
            "cli": _cli_modes(cli.main, ["--device", device, qrel, run],
                              golden, "cli"),
            "golden_lines": golden.count("\n"),
            "compare": _cli_modes(compare.main,
                                  ["--device", device, qrel, *runs],
                                  compare_golden, "compare"),
            "compare_golden_lines": compare_golden.count("\n")}


def paper_data(rng, nq, nd, nj):
    """The paper grid corner: nq queries x nd retrieved docs; each query
    judges nj docs, most retrieved, some not.  Scores have ties."""
    corpus = 4_000_000
    n_unret = nj // 4
    offsets = rng.choice(corpus, size=nd + n_unret, replace=False)
    start = rng.integers(0, corpus, nq)
    ret = (start[:, None] + offsets[None, :nd]) % corpus  # [nq, nd] distinct
    unret = (start[:, None] + offsets[None, nd:]) % corpus
    pick = np.argsort(rng.random((nq, nd)), axis=1)[:, :nj - n_unret]
    judged_ids = np.concatenate(
        [np.take_along_axis(ret, pick, axis=1), unret], axis=1)
    rels = rng.choice(np.array([-1, 0, 1, 2, 3]), size=judged_ids.shape,
                      p=[0.02, 0.48, 0.25, 0.15, 0.10])
    qid_names = np.char.add("q", np.arange(nq).astype(str))
    qrel = {}
    for q, qid in enumerate(qid_names.tolist()):
        qrel[qid] = dict(zip(judged_ids[q].astype(str).tolist(),
                             rels[q].tolist()))
    qids = np.repeat(qid_names, nd)
    docnos = ret.reshape(-1).astype(f"U{len(str(corpus))}")
    scores = np.round(rng.random(nq * nd), 3).astype(np.float32)
    return qrel, qids, docnos, scores


def phase_paper(device, rng, nq=PAPER_Q, nd=PAPER_D, nj=PAPER_J):
    from repro_torch.core import RelevanceEvaluator, compute_measures
    from repro_torch.distributed import ShardedEvaluator

    t0 = time.perf_counter()
    qrel, qids, docnos, scores = paper_data(rng, nq, nd, nj)
    t1 = time.perf_counter()
    ev = RelevanceEvaluator(qrel, PAPER_MEASURES, device=device)
    t2 = time.perf_counter()
    buf = ev.buffer_from_arrays(qids, docnos, scores)
    sev = ShardedEvaluator(ev)
    setup = {"data_s": t1 - t0, "evaluator_s": t2 - t1,
             "buffer_from_arrays_s": time.perf_counter() - t2}

    zero_launches()
    t0 = time.perf_counter()
    core = ev.evaluate_buffer(buf)
    t1 = time.perf_counter()
    fused = sev.evaluate_buffer(buf).per_query
    t2 = time.perf_counter()
    launches = read_launches()
    check(launches["fused_measures"] >= 1,
          "main path did not launch the fused-measure kernel")
    check(len(core) == nq, f"{len(core)} queries evaluated, want {nq}")
    vals = np.array([v for row in core.values() for v in row.values()])
    check(np.isfinite(vals).all(), "non-finite measure values")
    n, worst = compare_results(fused, core)
    split = {
        "core": split_times(ev, buf, lambda b: _stacked(compute_measures(
            b, ev.measures, ev.relevance_level))),
        "fused": split_times(ev, buf, lambda b: sev._dispatch(b)[0]),
    }
    return {"phase": "B", "queries": nq, "docs": nd, "judged": nj,
            "setup": setup, "core_eval_s": t1 - t0,
            "fused_eval_s": t2 - t1, "split": split, "compared": n,
            "max_abs_diff": worst, "launches": launches,
            "mean_map": float(np.mean([r["map"] for r in core.values()]))
            }, (ev, buf)


def deep_data(rng, nq, nd, nj):
    """Deep candidates: query q judges its own nj docs (nq·nj docnos in
    all) and retrieves them plus nd - nj distinct other vocabulary docs."""
    names = np.char.add("d", np.arange(nq * nj).astype(str))
    rels = rng.choice(np.array([0, 1, 2]), size=(nq, nj), p=[0.6, 0.3, 0.1])
    qid_names = np.char.add("q", np.arange(nq).astype(str)).tolist()
    qrel = {qid: dict(zip(names[q * nj:(q + 1) * nj].tolist(),
                          rels[q].tolist()))
            for q, qid in enumerate(qid_names)}
    return qrel, qid_names, names


def deep_tokens(rng, ev, names, nq, nd, nj):
    vocab_size = len(ev.vocab)
    own_tok = np.searchsorted(ev.vocab, names).reshape(nq, nj)
    tokens = np.empty((nq, nd), dtype=np.int64)
    own = np.zeros(vocab_size, dtype=bool)
    for q in range(nq):
        own[own_tok[q]] = True
        perm = rng.permutation(vocab_size)
        tokens[q, :nj] = own_tok[q]
        tokens[q, nj:] = perm[~own[perm]][:nd - nj]
        own[own_tok[q]] = False
    scores = np.round(rng.random(nq * nd), 4).astype(np.float32)
    return tokens.reshape(-1), scores


def phase_deep(device, rng, nq=DEEP_Q, nd=DEEP_D, nj=DEEP_J):
    import torch

    from repro_torch.core import (RelevanceEvaluator, compute_measures,
                                  compute_measures_topk)
    from repro_torch.distributed import ShardedEvaluator

    t0 = time.perf_counter()
    qrel, qids, names = deep_data(rng, nq, nd, nj)
    ev = RelevanceEvaluator(qrel, DEPTH_MEASURES, device=device)
    tokens, scores = deep_tokens(rng, ev, names, nq, nd, nj)
    t1 = time.perf_counter()
    buf = ev.buffer_from_tokens(qids, np.full(nq, nd), tokens, scores)
    del tokens, scores
    check(ev._route_topk(buf), "deep batch did not route to top-k")
    setup = {"data_and_evaluator_s": t1 - t0,
             "buffer_from_tokens_s": time.perf_counter() - t1}

    zero_launches()
    t0_topk = time.perf_counter()
    routed = ev.evaluate_buffer(buf)
    t1_topk = time.perf_counter()
    launches = read_launches()
    check(launches["topk"] >= 1, "main path did not launch the top-k kernel")

    # the same buffer through the full-sort route
    batch = ev.batch_from_buffer(buf)
    per_query = compute_measures(batch, ev.measures, ev.relevance_level)
    table = torch.stack([per_query[k][:nq] for k in ev.measure_keys]
                        ).cpu().numpy().tolist()
    full = {qid: {k: table[j][i] for j, k in enumerate(ev.measure_keys)}
            for i, qid in enumerate(buf.qids)}
    del batch, per_query
    n, worst = compare_results(routed, full)

    # the same buffer through the fused route (B1 at [nq, nd])
    sev = ShardedEvaluator(ev)
    zero_launches()
    t0 = time.perf_counter()
    fused = sev.evaluate_buffer(buf).per_query
    t1 = time.perf_counter()
    fused_launches = read_launches()
    check(fused_launches["fused_measures"] >= 1,
          "fused route did not launch the fused-measure kernel")
    n_fused, worst_fused = compare_results(fused, full)
    split = {"topk": split_times(
        ev, buf, lambda b: _stacked(compute_measures_topk(
            b, ev.measures, ev.relevance_level)), topk_layout=True),
        "fused": split_times(ev, buf, lambda b: sev._dispatch(b)[0])}
    return {"phase": "C", "queries": nq, "docs": nd, "judged": nj,
            "topk_depth": ev._topk_depth, "setup": setup,
            "topk_eval_s": t1_topk - t0_topk, "fused_eval_s": t1 - t0,
            "split": split, "compared": n, "max_abs_diff": worst,
            "fused_compared": n_fused, "fused_max_abs_diff": worst_fused,
            "launches": launches, "fused_launches": fused_launches
            }, (ev, buf)


#: recsys serving (phase E): the four archs at full width
RECSYS_ARCHS = ("xdeepfm", "sasrec", "autoint", "mind")
SERVE_REQUESTS = 20  # timed serve_p99 requests per arch, after one warm-up
CHECK_ROWS = 8  # rows of an answer recomputed on the CPU
SCORE_TOL = 1e-4  # card vs CPU: float sums in another order (CIN, attention)


def _n_items(name, cfg):
    return cfg.n_items if name == "sasrec" else cfg.table.vocab_per_field


def recsys_request(name, cfg, shape, seed, step):
    """One request's numpy arguments after the model: the user batch from
    ``data/recsys_data`` at (seed, step), plus for a slate the candidates
    (the user's true next item planted at a random slot, rel 1 there) and
    for retrieval the candidate ids with a few relevant ones."""
    from repro_torch.data import recsys_data as RD

    b = shape.get("batch")
    n = _n_items(name, cfg)
    rng = np.random.default_rng([seed, step, 99])
    if name == "sasrec":
        batch = RD.seq_batch(RD.SeqDataConfig(n, cfg.seq_len, b, seed=seed),
                             step)
        truth = batch["pos"][:, -1]
    elif name == "mind":
        batch = RD.mind_batch(RD.SeqDataConfig(n, cfg.hist_len, b,
                                               seed=seed), step)
        truth = batch["pos"]
    else:
        batch = RD.ctr_batch(RD.CTRDataConfig(
            cfg.table.n_fields, n, b, cfg.n_multi_hot, cfg.multi_hot_len,
            seed), step)
        truth = None
    if shape.kind == "retrieval":
        nc = shape.get("n_candidates")
        if truth is None:
            batch = {"ids": batch["ids"][:1]}
        cand = rng.integers(0, n, nc).astype(np.int32)
        rel = (rng.random((b, nc)) < 1e-4).astype(np.int32)
        if truth is not None:
            slot = int(rng.integers(0, nc))
            cand[slot] = truth[0]
            rel[0, slot] = 1
        return (batch, cand, rel)
    slate = shape.get("slate", 0)
    if truth is None or not slate:
        return (batch,)
    cand = rng.integers(0, n, (b, slate)).astype(np.int32)
    slot = rng.integers(0, slate, b)
    cand[np.arange(b), slot] = truth
    rel = np.zeros((b, slate), np.int32)
    rel[np.arange(b), slot] = 1
    return (batch, cand, rel)


def _head(args, rows):
    """The first ``rows`` rows of a serve request's arguments."""
    batch = {k: v[:rows] for k, v in args[0].items()}
    return (batch, *(a[:rows] for a in args[1:]))


def _cpu_copy(model, name):
    """The same weights in a module on the CPU (built on ``meta``, so no
    weights are drawn on the host)."""
    from repro_torch.launch.steps import MODELS

    cpu = MODELS[name](model.cfg, device="meta").to_empty(device="cpu")
    cpu.load_state_dict(model.state_dict())
    return cpu


def _check_close(got, want, what, tol=SCORE_TOL):
    import torch

    got, want = got.detach().cpu(), want.detach().cpu()
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
          f"{tuple(want.shape)}")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    check(torch.allclose(got, want, atol=tol, rtol=tol),
          f"{what}: beyond {tol} of the CPU")
    return float((got - want).abs().max()) if got.numel() else 0.0


def _check_metrics(metrics, scores, rel, what):
    """In-loop metrics on the card against the CPU's from the same scores."""
    import torch

    from repro_torch.launch.steps import _slate_metrics

    want = _slate_metrics(scores.detach().cpu(), torch.as_tensor(rel))
    worst = 0.0
    for k, v in want.items():
        g = float(metrics[k])
        check(0.0 <= g <= 1.0, f"{what} {k} = {g} outside [0, 1]")
        check(abs(g - float(v)) <= TOL, f"{what} {k}: {g} vs CPU {float(v)}")
        worst = max(worst, abs(g - float(v)))
    return worst


def serve_requests(name, arch, cfg, model, seed, device):
    """Answer 1 + SERVE_REQUESTS ``serve_p99`` requests through the step a
    user builds; host-clock latency per request (inputs to the card, step,
    answer back), first one dropped as warm-up."""
    import torch

    from repro_torch.launch.api import to_device
    from repro_torch.launch.steps import _slate_metrics

    mods = _kernel_modules()
    shape = arch.shapes["serve_p99"]
    step = arch.make_step(cfg, shape).step_fn
    lat, worst, first = [], 0.0, None
    per_call = 1 if name == "xdeepfm" else 0  # every multi-hot field at once
    for r in range(1 + SERVE_REQUESTS):
        args = recsys_request(name, cfg, shape, seed, r)
        eb = mods["embedding_bag"].LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(model, *to_device(args, device))
        scores = out[0] if isinstance(out, tuple) else out
        host = scores.cpu()
        metrics = ({k: float(v) for k, v in out[1].items()}
                   if isinstance(out, tuple) else {})
        lat.append(time.perf_counter() - t0)
        check(mods["embedding_bag"].LAUNCHES - eb == per_call,
              f"{name}: {mods['embedding_bag'].LAUNCHES - eb} EmbeddingBag "
              f"launches in one serve call, want {per_call}")
        want_shape = (shape.get("batch"),) + (
            (shape.get("slate"),) if metrics else ())
        check(tuple(host.shape) == want_shape, f"{name}: scores shape "
              f"{tuple(host.shape)}, want {want_shape}")
        check(bool(torch.isfinite(host).all()), f"{name}: non-finite scores")
        if metrics:
            worst = max(worst, _check_metrics(metrics, host, args[2],
                                              f"{name} serve_p99"))
        if first is None:
            first = (args, host, metrics)
    ms = np.array(lat[1:]) * 1e3
    # the first request's head rows again on the CPU, same weights
    args, host, metrics = first
    cpu_model = _cpu_copy(model, name)
    head = _head(args, CHECK_ROWS)
    cpu_out = arch.make_step(cfg, shape, device="cpu").step_fn(
        cpu_model, *to_device(head, "cpu"))
    cpu_scores = cpu_out[0] if isinstance(cpu_out, tuple) else cpu_out
    err = _check_close(host[:CHECK_ROWS], cpu_scores, f"{name} serve_p99")
    del cpu_model
    summary = {"requests": SERVE_REQUESTS, "batch": shape.get("batch"),
               "p50_ms": float(np.percentile(ms, 50)),
               "p99_ms": float(np.percentile(ms, 99)),
               "max_ms": float(ms.max()), "cpu_check_max_abs_err": err,
               "metrics_max_abs_err_vs_cpu": worst}
    if metrics:
        summary["first_metrics"] = metrics
        summary["slate"] = shape.get("slate")
    return summary


def profile_call(fn, top=6):
    """Device time of one call of ``fn`` by kernel (the profiler's sums,
    after one warm-up call), with the number of device operations and the
    card's busy share of the call's host time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]
    busy = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / wall,
            "device_ops": sum(r[2] for r in rows),
            "top_kernels": [{"name": k[:80], "ms": t / 1e3, "count": c}
                            for k, t, c in rows[:top]]}


def profile_request(arch, cfg, model, name, seed, device):
    """``profile_call`` of one ``serve_p99`` request, inputs copied in."""
    from repro_torch.launch.api import to_device

    shape = arch.shapes["serve_p99"]
    step = arch.make_step(cfg, shape).step_fn
    args = recsys_request(name, cfg, shape, seed, 0)
    return profile_call(lambda: step(model, *to_device(args, device)))


def phase_recsys(device, seed):
    """Recsys serving at full width: serve_p99 requests for every arch, one
    xDeepFM serve_bulk batch, retrieval_cand for SASRec and xDeepFM."""
    import torch

    from repro_torch.kernels import topk as TK
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.launch.steps import MODELS, _CTR_SCORE
    from repro_torch.models import recsys as R

    mods = _kernel_modules()
    result = {"phase": "E", "archs": {}}
    keep = {}
    zero_launches()
    for name in RECSYS_ARCHS:
        arch = get_arch(name)
        cfg = arch.make_config(False)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        gen = torch.Generator(device=device).manual_seed(seed)
        model = MODELS[name](cfg, device=device, generator=gen)
        torch.cuda.synchronize()
        res = {"params": sum(p.numel() for p in model.parameters()),
               "init_s": time.perf_counter() - t0}
        res["serve_p99"] = serve_requests(name, arch, cfg, model, seed,
                                          device)
        res["serve_p99"]["profile"] = profile_request(arch, cfg, model, name,
                                                      seed, device)
        if name == "xdeepfm":
            # one serve_bulk batch
            shape = arch.shapes["serve_bulk"]
            args = recsys_request(name, cfg, shape, seed, 1000)
            step = arch.make_step(cfg, shape).step_fn
            dev_args = to_device(args, device)
            eb = mods["embedding_bag"].LAUNCHES
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores = step(model, *dev_args)
            torch.cuda.synchronize()
            bulk_s = time.perf_counter() - t0
            check(mods["embedding_bag"].LAUNCHES - eb == 1,
                  "serve_bulk: EmbeddingBag not launched once per call")
            cpu_model = _cpu_copy(model, name)
            cpu_scores = arch.make_step(cfg, shape, device="cpu").step_fn(
                cpu_model, *to_device(_head(args, CHECK_ROWS), "cpu"))
            check(tuple(scores.shape) == (shape.get("batch"),),
                  "serve_bulk scores shape")
            check(bool(torch.isfinite(scores).all()),
                  "serve_bulk: non-finite scores")
            res["serve_bulk"] = {
                "batch": shape.get("batch"), "step_s": bulk_s,
                "rows_per_s": shape.get("batch") / bulk_s,
                "cpu_check_max_abs_err": _check_close(
                    scores[:CHECK_ROWS], cpu_scores, "serve_bulk")}
            keep["xdeepfm"] = (model, cfg, dev_args[0])
        if name in ("sasrec", "xdeepfm"):
            shape = arch.shapes["retrieval_cand"]
            args = recsys_request(name, cfg, shape, seed, 2000)
            step = arch.make_step(cfg, shape).step_fn
            dev_args = to_device(args, device)
            times = []
            for _ in range(2):  # the first call warms up
                tk = mods["topk"].LAUNCHES
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                v, i, metrics = step(model, *dev_args)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
                check(mods["topk"].LAUNCHES - tk == 1,
                      f"{name} retrieval did not launch the top-k kernel")
            k, nc = shape.get("topk"), shape.get("n_candidates")
            check(tuple(v.shape) == (1, k) and tuple(i.shape) == (1, k),
                  "retrieval output shape")
            check(bool(torch.isfinite(v).all()), "retrieval: non-finite")
            check(bool((v[:, :-1] >= v[:, 1:]).all()),
                  "retrieval values not descending")
            check(bool(((i >= 0) & (i < nc)).all()), "retrieval index range")
            # the card's full score row, for the metric check and phase D
            batch, cand = dev_args[0], dev_args[1]
            with torch.inference_mode():
                if name == "sasrec":
                    scores = R.sasrec_retrieval_scores(
                        model, {**batch, "candidates": cand}, cfg)
                else:
                    ids = batch["ids"].expand(nc, -1).clone()
                    ids[:, 0] = cand
                    scores = _CTR_SCORE[name](model, {"ids": ids},
                                              cfg)[None, :]
            check(torch.allclose(v, torch.gather(scores, 1, i.long()),
                                 atol=1e-6, rtol=1e-6),
                  "retrieval values are not the scores at their indices")
            m_err = _check_metrics(metrics, scores, args[2],
                                   f"{name} retrieval")
            # the top rows rescored on the CPU
            cpu_model = _cpu_copy(model, name)
            top = i[0, :CHECK_ROWS].long().cpu()
            cpu_batch = to_device(args[0], "cpu")
            with torch.inference_mode():
                if name == "sasrec":
                    cpu_v = R.sasrec_retrieval_scores(
                        cpu_model, {**cpu_batch, "candidates":
                                    torch.from_numpy(args[1])[top]}, cfg)
                else:
                    ids = cpu_batch["ids"].expand(len(top), -1).clone()
                    ids[:, 0] = torch.from_numpy(args[1])[top]
                    cpu_v = _CTR_SCORE[name](cpu_model, {"ids": ids},
                                             cfg)[None, :]
            del cpu_model
            res["retrieval_cand"] = {
                "n_candidates": nc, "topk": k, "step_s": times[1],
                "first_call_s": times[0],
                "metrics": {kk: float(vv) for kk, vv in metrics.items()},
                "metrics_max_abs_err_vs_cpu": m_err,
                "cpu_check_max_abs_err": _check_close(
                    v[:, :CHECK_ROWS], cpu_v, f"{name} retrieval")}
            if name == "sasrec":
                keep["retrieval_scores"] = scores.contiguous()
                keep["sasrec"] = (model, cfg, args, dev_args)  # phase N
                res["retrieval_cand"]["profile"] = profile_call(
                    lambda: step(model, *dev_args))
            del scores
        res["peak_device_gb"] = torch.cuda.max_memory_allocated() / 1e9
        result["archs"][name] = res
        if name not in ("xdeepfm", "sasrec"):
            del model
        torch.cuda.empty_cache()
    result["launches"] = read_launches()
    check(result["launches"]["embedding_bag"] > 0,
          "phase E did not launch the EmbeddingBag kernel")
    check(result["launches"]["topk"] > 0,
          "phase E did not launch the top-k kernel")
    result["tf32"] = {"matmul": torch.backends.cuda.matmul.allow_tf32,
                      "cudnn": torch.backends.cudnn.allow_tf32}
    return result, keep


def phase_kernels(paper, deep, recsys, sweep, launches):
    """Each kernel against its plain version on the main path's inputs."""
    import torch

    # B1 at phase B's batch (a warp per row, one launch a call), phase C's
    # (a block per row after the rank-term table: two launches), one
    # group of phase F's sharded sweep (8 runs stacked, one launch) and
    # one shard of phase S's largest mesh (phase B's batch in 4 blocks)
    rows = [fused_row(*paper, launches["fused_measures"], per_call=1),
            fused_row(*deep, launches["fused_measures_deep"], per_call=2),
            fused_row(*sweep["b1"], launches["fused_measures_sweep"],
                      per_call=1),
            fused_row(*paper, launches["fused_measures_sharded"],
                      per_call=1, shards=SHARD_COUNTS[-1])]

    # B2: top-k at phase C's masked score matrix
    ev, buf = deep
    batch = ev.batch_from_buffer(buf, topk_layout=True)
    k = min(ev._topk_depth, batch.scores.shape[1])
    scores_m = torch.where(batch.mask, batch.scores, -torch.inf).contiguous()
    del batch
    rows.append(topk_row(scores_m, k, launches["topk"], split=False))
    del scores_m

    # B2 again, at the retrieval shape [1, 1,000,000], k = 1,000 (phase E)
    rows.append(topk_row(recsys["retrieval_scores"], 1000,
                         launches["topk_retrieval"], split=True))
    # B3: every multi-hot field of phase E's serve_bulk batch in one call,
    # with the general wrapper at one field's bags beside it
    row = embedding_bag_row(recsys["xdeepfm"], launches["embedding_bag"])
    row["general_wrapper_one_field"] = embedding_bag_csr_row(
        recsys["xdeepfm"])
    rows.append(row)
    return rows


def b1_inputs(ev, buf, shards=1):
    """B1's inputs (rank-sorted rel and judged, the scalars) for the first
    of ``shards`` blocks of the query axis of ``buf``'s padded batch, as
    the sharded evaluator gives each shard."""
    from repro_torch.core import measures as M
    from repro_torch.kernels import ops

    batch = ev.batch_from_buffer(buf, q_multiple=shards)
    rows = batch.query_mask.shape[0] // shards
    batch = M.EvalBatch(*(f[:rows] for f in batch))
    s = M.sort_batch(batch, ev.relevance_level)
    scal = ops.make_scalars(batch.n_rel, batch.n_judged_nonrel,
                            batch.ideal_rel)
    return s.rel.contiguous(), s.judged.contiguous(), scal


def fused_row(ev, buf, launches, per_call, shards=1):
    """B1 at the rank-sorted batch of ``buf`` (the evaluator's padded
    ``[Q, D]``; with ``shards``, its first block, :func:`b1_inputs`)
    against its plain version: count columns exact, the rest within TOL,
    padding columns zero; times, the bound and the kernels one call
    launched, as the C entry counts them (``per_call`` expected)."""
    import torch

    from repro_torch.kernels import fused_measures as FM

    rel, judged, scal = b1_inputs(ev, buf, shards)
    q, d = rel.shape
    level = ev.relevance_level
    got = FM.fused_measures(rel, judged, scal, level)
    want = FM.fused_measures_plain(rel, judged, scal, level)
    torch.cuda.synchronize()
    ncol = len(FM.COLUMNS)
    for c, name in enumerate(FM.COLUMNS):
        a, b = got[:, c], want[:, c]
        if is_exact(name):
            check(torch.equal(a, b),
                  f"fused kernel at {[q, d]}: column {name} not exact")
        else:
            check(torch.allclose(a, b, atol=TOL, rtol=TOL),
                  f"fused kernel at {[q, d]}: column {name} beyond {TOL}")
    err = float((got[:, :ncol] - want[:, :ncol]).abs().max())
    check(bool(torch.all(got[:, ncol:] == 0)), "fused padding not zero")
    del got, want
    before = FM.KERNEL_LAUNCHES
    FM.fused_measures(rel, judged, scal, level)
    counted = FM.KERNEL_LAUNCHES - before
    check(counted == per_call, f"fused kernel at {[q, d]} launched "
          f"{counted} kernels a call, want {per_call}")
    nbytes = (2 * q * d + q * FM.SCALAR_WIDTH + q * FM.OUT_WIDTH) * 4
    flops = FUSED_FLOPS_PER_RANK * q * d
    return dict(
        name="fused_measures", route="cuda",
        source="src/repro_torch/csrc/fused_measures.cu",
        replaces="src/repro/kernels/fused_measures.py:81",
        launches=launches, kernel_launches_per_call=counted,
        max_abs_err=err,
        ms=time_ms(lambda: FM.fused_measures(rel, judged, scal, level)),
        plain_ms=time_ms(lambda: FM.fused_measures_plain(rel, judged, scal,
                                                         level), iters=10),
        shape=[q, d], shards=shards, **bound(nbytes, flops),
        library_ms=None)


def topk_row(scores, k, launches, split):
    """B2 at ``scores`` against its plain version (exact), with times, the
    bound and the kernels one call launched, as the C entry counts them:
    one pass, or two (chunks, then their merge) when ``split``."""
    import torch

    from repro_torch.kernels import topk as TK

    q, d = scores.shape
    v, i = TK.topk(scores, k)
    pv, pi = TK.topk_plain(scores, k)
    torch.cuda.synchronize()
    check(torch.equal(i, pi), "top-k kernel indices differ from plain")
    check(torch.equal(v, pv), "top-k kernel values differ from plain")
    finite = torch.isfinite(pv)
    err = float((v[finite] - pv[finite]).abs().max()) if finite.any() else 0.0
    before = TK.KERNEL_LAUNCHES
    TK.topk(scores, k)
    per_call = TK.KERNEL_LAUNCHES - before
    check(per_call == (2 if split else 1),
          f"top-k at {[q, d]} launched {per_call} kernels a call")
    nbytes = q * d * 4 + q * k * 8
    return dict(
        name="topk", route="cuda", source="src/repro_torch/csrc/topk.cu",
        replaces="src/repro/kernels/topk.py:36", launches=launches,
        kernel_launches_per_call=per_call, max_abs_err=err,
        ms=time_ms(lambda: TK.topk(scores, k), iters=10),
        plain_ms=time_ms(lambda: TK.topk_plain(scores, k), iters=10),
        shape=[q, d, k],
        **bound(nbytes, q * d),
        library_ms=time_ms(lambda: torch.topk(scores, k), iters=10))


def embedding_bag_row(xdeepfm, launches):
    """B3's all-fields call at the serve_bulk batch: 262,144 rows x 3
    multi-hot fields x 8 lookups (mask as weights) into the 39M-row table,
    one launch.  Held bit for bit against the plain version run on the CPU
    and on the card (both sum each bag in lookup order, as the kernel
    does)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as EB

    model, cfg, batch = xdeepfm
    table = model.table.detach()
    ids, mask = batch["mh_ids"], batch["mh_mask"]  # [B, F, M] i32, bool
    b, f, m = ids.shape
    vocab = cfg.table.vocab_per_field
    bags, bag_mask = ids.reshape(b * f, m), mask.reshape(b * f, m)
    got = EB.embedding_bag_fixed(table, bags, bag_mask, f, vocab)
    plain = EB.embedding_bag_fixed_plain(table, bags, bag_mask, f, vocab)
    rows = (bags.long() + (torch.arange(b * f, device=ids.device) % f
                           * vocab)[:, None])  # [B·F, M] table rows
    # the plain version on the CPU, on the gathered rows (the same function
    # of the same inputs, without copying the 1.6 GB table to the host)
    gathered = table[rows.reshape(-1)].cpu()
    cpu = EB.embedding_bag_fixed_plain(
        gathered, torch.arange(b * f * m, dtype=torch.int32).reshape(b * f, m),
        bag_mask.cpu())
    torch.cuda.synchronize()
    check(bool((got.cpu() == cpu).all()),
          "EmbeddingBag kernel differs from the plain version on the CPU")
    check(bool((got == plain).all()),
          "EmbeddingBag kernel differs from the plain version on the card")
    e = table.shape[1]
    l = b * f * m
    unique_rows = int(torch.unique(rows).numel())
    # each touched row read once, int32 id + bool mask per lookup, the bags
    # written once; a multiply and an add per lookup and column
    nbytes = unique_rows * e * 4 + l * 5 + b * f * e * 4
    flops = 2 * l * e
    lib_w = bag_mask.to(torch.float32)
    before = EB.LAUNCHES
    EB.embedding_bag_fixed(table, bags, bag_mask, f, vocab)
    per_call = EB.LAUNCHES - before
    check(per_call == 1,
          f"the all-fields EmbeddingBag call launched {per_call} kernels")
    return dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:34", launches=launches,
        kernel_launches_per_call=per_call,
        max_abs_err=float((got - plain).abs().max()),
        bit_identical_to_cpu_plain=True,
        ms=time_ms(lambda: EB.embedding_bag_fixed(table, bags, bag_mask, f,
                                                  vocab)),
        plain_ms=time_ms(lambda: EB.embedding_bag_fixed_plain(
            table, bags, bag_mask, f, vocab)),
        shape=[int(table.shape[0]), e, l, b * f], unique_rows=unique_rows,
        **bound(nbytes, flops),
        library_ms=time_ms(lambda: F.embedding_bag(
            rows, table, mode="sum", per_sample_weights=lib_w)))


def embedding_bag_csr_row(xdeepfm, field=0):
    """B3's general wrapper (stable sort by bag, CSR offsets, host range
    check) at one field of the serve_bulk batch, the per-field shape:
    L = 262,144 x 8 lookups into 262,144 bags.  Off the main path since
    the all-fields call; bit for bit against the plain version on the CPU,
    within 1e-6 of the one on the card (``index_add_`` with atomics)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as EB

    model, cfg, batch = xdeepfm
    table = model.table.detach()
    ids = batch["mh_ids"][:, field] + field * cfg.table.vocab_per_field
    mask = batch["mh_mask"][:, field]
    b, m = ids.shape
    idx = ids.reshape(-1)
    seg = torch.arange(b, device=ids.device)[:, None].expand(b, m).reshape(-1)
    w = mask.reshape(-1).to(torch.float32)
    got = EB.embedding_bag(table, idx, seg, b, w)
    plain = EB.embedding_bag_plain(table, idx, seg, b, w)
    rows = table[idx.long()].cpu()
    cpu = EB.embedding_bag_plain(rows, torch.arange(b * m), seg.cpu(), b,
                                 w.cpu())
    torch.cuda.synchronize()
    check(bool((got.cpu() == cpu).all()),
          "EmbeddingBag CSR kernel differs from the plain version on the CPU")
    check(torch.allclose(got, plain, atol=1e-6, rtol=1e-6),
          "EmbeddingBag CSR kernel beyond 1e-6 of the plain version")
    e = table.shape[1]
    l = idx.numel()
    unique_rows = int(torch.unique(idx).numel())
    nbytes = unique_rows * e * 4 + l * 12 + b * e * 4
    flops = 2 * l * e
    prepared = EB.prepare(idx, seg, b, w)
    lib_ids, lib_w = ids.long(), mask.to(torch.float32)
    before = EB.LAUNCHES
    EB.embedding_bag(table, idx, seg, b, w)
    per_call = EB.LAUNCHES - before
    check(per_call == 1,
          f"the general EmbeddingBag wrapper launched {per_call} kernels")
    return dict(
        kernel_launches_per_call=per_call,
        max_abs_err=float((got - plain).abs().max()),
        ms=time_ms(lambda: EB.embedding_bag(table, idx, seg, b, w)),
        kernel_only_ms=time_ms(lambda: EB.launch(table, *prepared, b)),
        plain_ms=time_ms(lambda: EB.embedding_bag_plain(table, idx, seg, b,
                                                        w)),
        shape=[int(table.shape[0]), e, l, b], unique_rows=unique_rows,
        **bound(nbytes, flops),
        library_ms=time_ms(lambda: F.embedding_bag(
            lib_ids, table, mode="sum", per_sample_weights=lib_w)))


#: phase F: a Robust04-sized hyperparameter sweep (249 queries, the paper
#: grid's depth and judged count), tested pairwise on ``map``
SWEEP_K, SWEEP_Q = 64, 249
SWEEP_PERMUTATIONS = 2000
SWEEP_EXACT_Q = 16  # exact enumeration on the first 16 queries
SWEEP_CPU_RUNS = 4  # runs evaluated again by the port on the CPU


def _compare_tables(got, want, keys, what):
    """[K, Q, M] tables: count columns bit-identical, the rest within TOL.
    Returns the max abs difference."""
    worst = 0.0
    for m, key in enumerate(keys):
        a, b = got[..., m], want[..., m]
        if is_exact(key):
            check(np.array_equal(a, b), f"{what}: {key} not exact")
        else:
            check(np.allclose(a, b, atol=TOL, rtol=TOL),
                  f"{what}: {key} beyond {TOL}")
        worst = max(worst, float(np.abs(a - b).max()))
    return worst


def _synced(fn):
    """(result, seconds) of ``fn`` on the host clock, card synchronized."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_sweep(device, rng, seed):
    """64 runs x 249 queries x 1,000 docs through ``evaluate_sweep`` on
    both backends, held against 64 separate evaluations, the CPU port and
    each other; then ``significance_report`` on the [64, 249] ``map`` table
    on the card against the CPU."""
    import torch

    from repro_torch import stats as S
    from repro_torch.core import (RelevanceEvaluator, concat_run_buffers,
                                  evaluate_sweep)
    from repro_torch.kernels import fused_measures as FM

    t0 = time.perf_counter()
    qrel, qids, docnos, scores = paper_data(rng, SWEEP_Q, PAPER_D, PAPER_J)
    ev = RelevanceEvaluator(qrel, PAPER_MEASURES, device=device)
    base = ev.buffer_from_arrays(qids, docnos, scores)
    run_rng = np.random.default_rng([seed, SWEEP_K])
    run_scores = [np.round(run_rng.random(base.scores.shape[0]), 3)
                  for _ in range(SWEEP_K)]
    bufs = [base.with_scores(sc) for sc in run_scores]
    setup_s = time.perf_counter() - t0

    single, single_s = _synced(lambda: evaluate_sweep(ev, bufs))
    keys = single.measure_keys
    check(single.table.shape == (SWEEP_K, SWEEP_Q, len(keys)),
          f"sweep table shape {single.table.shape}")
    check(np.isfinite(single.table).all(), "non-finite sweep values")
    zero_launches()
    kernels_before = FM.KERNEL_LAUNCHES
    sharded, sharded_s = _synced(
        lambda: evaluate_sweep(ev, bufs, backend="sharded"))
    launches = read_launches()
    b1_kernels = FM.KERNEL_LAUNCHES - kernels_before
    groups = -(-SWEEP_K // (ev.chunk_queries // SWEEP_Q))
    check(launches["fused_measures"] == groups == 8,
          f"sharded sweep: {launches['fused_measures']} fused calls, "
          f"want 8")
    check(b1_kernels == groups, f"sharded sweep launched {b1_kernels} B1 "
          f"kernels, want {groups}")
    sharded_err = _compare_tables(sharded.table, single.table, keys,
                                  "sharded vs single sweep")

    # 64 separate evaluate_buffer calls: bit-identical to the sweep
    def separate():
        return [ev.evaluate_buffer(b) for b in bufs]

    per_run, separate_s = _synced(separate)
    for k, res in enumerate(per_run):
        for q, qid in enumerate(single.qids):
            row = res[qid]
            check(all(single.table[k, q, m] == row[key]
                      for m, key in enumerate(keys)),
                  f"sweep run {k} query {qid} differs from evaluate_buffer")

    # the first runs on the CPU port
    t0 = time.perf_counter()
    cpu_ev = RelevanceEvaluator(qrel, PAPER_MEASURES, device="cpu")
    cpu_base = cpu_ev.buffer_from_arrays(qids, docnos, scores)
    cpu = evaluate_sweep(cpu_ev, [cpu_base.with_scores(sc)
                                  for sc in run_scores[:SWEEP_CPU_RUNS]])
    cpu_s = time.perf_counter() - t0
    cpu_err = _compare_tables(cpu.table, single.table[:SWEEP_CPU_RUNS],
                              keys, "card vs CPU sweep")

    # significance on the [64, 249] map table, card against CPU
    x_host = np.ascontiguousarray(single.measure("map"))
    x = torch.from_numpy(x_host).to(device)
    times = {}
    (t, p), times["t_s"] = _synced(lambda: S.paired_t_matrix(x))
    perm, times["permutation_s"] = _synced(lambda: S.paired_permutation_matrix(
        x, n_permutations=SWEEP_PERMUTATIONS, seed=seed))
    exact, times["exact_s"] = _synced(
        lambda: S.paired_permutation_exact(x[:, :SWEEP_EXACT_Q]))
    rep, times["report_s"] = _synced(lambda: single.compare(
        "map", tests=("t", "permutation"),
        n_permutations=SWEEP_PERMUTATIONS, seed=seed))
    t0 = time.perf_counter()
    cpu_rep = S.significance_report(
        x_host, tests=("t", "permutation"),
        n_permutations=SWEEP_PERMUTATIONS, seed=seed, device="cpu")
    cpu_exact = S.paired_permutation_exact(x_host[:, :SWEEP_EXACT_Q],
                                           device="cpu")
    times["cpu_report_and_exact_s"] = time.perf_counter() - t0
    check(np.array_equal(rep["t"], t.cpu().numpy())
          and np.array_equal(rep["p_permutation"], perm.cpu().numpy()),
          "significance_report differs from its parts")
    g_t, c_t = rep["t"], cpu_rep["t"]
    finite = np.isfinite(c_t)
    check(np.array_equal(np.isfinite(g_t), finite)
          and np.array_equal(g_t[~finite], c_t[~finite]),
          "t: infinities differ between card and CPU")
    # relative to max(|t|, 1): float32 means of near-equal systems are
    # summed in another order on the card, which moves a t near 0 by ~1e-6
    t_rel = float(np.max(np.abs(g_t[finite] - c_t[finite])
                         / np.maximum(np.abs(c_t[finite]), 1.0)))
    check(t_rel <= 1e-4, f"t on the card beyond 1e-4 relative of the CPU "
          f"({t_rel})")
    p_err = 0.0
    for key in ("p", "p_holm", "p_bonferroni"):
        err = float(np.abs(rep[key] - cpu_rep[key]).max())
        check(err <= 1e-5, f"{key} on the card beyond 1e-5 of the CPU")
        p_err = max(p_err, err)
    check(torch.equal(exact.cpu(), cpu_exact),
          "exact enumeration differs between card and CPU")
    # Monte Carlo on the card within 5 sigma (+ smoothing) of exact
    mc16 = S.paired_permutation_matrix(
        x[:, :SWEEP_EXACT_Q], n_permutations=SWEEP_PERMUTATIONS,
        seed=seed).cpu().numpy()
    pe = cpu_exact.numpy().astype(np.float64)
    bound = (5 * np.sqrt(pe * (1 - pe) / SWEEP_PERMUTATIONS)
             + 2 / (SWEEP_PERMUTATIONS + 1))
    check((np.abs(mc16 - pe) <= bound).all(),
          "Monte Carlo p-values beyond 5 sigma of exact enumeration")
    # one sweep group (8 runs stacked, as the sweep stacks them): B1's row;
    # the qrel and the run's arrays: phase H's service
    group = concat_run_buffers(bufs[:ev.chunk_queries // SWEEP_Q])
    keep = {"b1": (ev, group), "data": (qrel, qids, docnos, scores)}
    return {"phase": "F", "runs": SWEEP_K, "queries": SWEEP_Q,
            "docs": PAPER_D, "judged": PAPER_J, "setup_s": setup_s,
            "single_s": single_s, "sharded_s": sharded_s,
            "separate_evaluate_buffer_s": separate_s,
            "cpu_sweep_runs": SWEEP_CPU_RUNS, "cpu_sweep_s": cpu_s,
            "sharded_max_abs_diff": sharded_err,
            "cpu_max_abs_diff": cpu_err, "launches": launches,
            "b1_kernel_launches": b1_kernels, "groups": groups,
            "significance": dict(
                times, permutations=SWEEP_PERMUTATIONS,
                exact_queries=SWEEP_EXACT_Q, t_max_rel_diff_vs_cpu=t_rel,
                p_max_abs_diff_vs_cpu=p_err,
                mc_max_abs_diff_vs_exact=float(np.abs(mc16 - pe).max()),
                significant_pairs_holm=int(
                    np.triu(rep["p_holm"] < 0.05, 1).sum()))}, keep


def phase_ranked(paper):
    """The rank-reduction engine on phase B's batch against the sorted
    engine on the card: count columns exact, the rest within TOL."""
    import torch

    from repro_torch.core import measures as M
    from repro_torch.core import ranked as RK

    ev, buf = paper
    nq = len(buf.qids)
    batch = ev.batch_from_buffer(buf)
    level = ev.relevance_level
    want = M.compute_measures(batch, ev.measures, level)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    rb = RK.from_eval_batch(batch)
    got, seconds = _synced(
        lambda: RK.compute_measures_ranked(rb, ev.measures, level))
    peak = torch.cuda.max_memory_allocated() - base
    _, core_s = _synced(lambda: M.compute_measures(batch, ev.measures, level))
    keys = ev.measure_keys
    worst = _compare_tables(
        torch.stack([got[k][:nq] for k in keys], -1).cpu().numpy(),
        torch.stack([want[k][:nq] for k in keys], -1).cpu().numpy(),
        keys, "ranked vs sorted engine")
    return {"phase": "F-ranked", "shape": list(batch.scores.shape),
            "judged_width": int(rb.judged_scores.shape[1]),
            "ranked_s": seconds, "sorted_s": core_s,
            "peak_extra_device_gb": peak / 1e9, "max_abs_diff": worst,
            "compared": nq * len(keys)}, None


#: phase G: the paper's query-expansion demo (synthetic_ir defaults)
RL_EPISODES = 20
RL_FIXED_ACTIONS = 5  # fixed actions per query, card against CPU
RL_FIXED_QUERIES = 10


def phase_rl(device, seed):
    """``build_collection()`` at its defaults, 20 Q-learning episodes with
    the environment evaluating on the card, held episode by episode against
    the same agent (seed and config) on the CPU port, and a fixed action
    sequence on the card against the CPU port."""
    from repro_torch.data import synthetic_ir as SIR
    from repro_torch.rl.environment import QueryExpansionEnv
    from repro_torch.rl.qlearning import QLearningAgent, QLearningConfig

    t0 = time.perf_counter()
    coll = SIR.build_collection()
    build_s = time.perf_counter() - t0
    env = QueryExpansionEnv(coll, device=device)
    step_times = []
    step = env.step

    def timed_step(action):
        t = time.perf_counter()
        out = step(action)
        step_times.append(time.perf_counter() - t)
        return out

    env.step = timed_step
    cfg = QLearningConfig(alpha=0.1, gamma=0.95, epsilon=0.05, seed=seed)
    agent = QLearningAgent(env, cfg)
    qids = list(coll.qrels)
    t0 = time.perf_counter()
    rewards = agent.train(qids, RL_EPISODES)
    train_s = time.perf_counter() - t0
    check(len(rewards) == RL_EPISODES and np.isfinite(rewards).all(),
          "Q-learning rewards not finite")
    env.step = step

    # the same agent on the CPU port: rewards within 2e-4 episode by
    # episode, and q <- (1 - a) q + a (r + g max q') keeps every Q entry
    # within 2e-4 / (1 - g) when each reward is within 2e-4
    cpu_env = QueryExpansionEnv(coll, device="cpu")
    cpu_agent = QLearningAgent(cpu_env, cfg)
    t0 = time.perf_counter()
    cpu_rewards = cpu_agent.train(qids, RL_EPISODES)
    cpu_train_s = time.perf_counter() - t0
    reward_diff = float(np.max(np.abs(np.subtract(rewards, cpu_rewards))))
    check(reward_diff <= 2e-4,
          f"Q-learning rewards: card vs CPU differ by {reward_diff}")
    check(agent.q.keys() == cpu_agent.q.keys(),
          "Q-learning: card and CPU agents visited different states")
    q_diff = max(float(np.max(np.abs(agent.q[key] - qv)))
                 for key, qv in cpu_agent.q.items())
    check(q_diff <= 2e-4 / (1 - cfg.gamma),
          f"Q-table: card vs CPU differ by {q_diff}")

    actions = [int(a) for a in agent.actions[:RL_FIXED_ACTIONS]]
    worst, n = 0.0, 0
    for qid in qids[:RL_FIXED_QUERIES]:
        env.reset(qid)
        cpu_env.reset(qid)
        for a in actions:
            _, r_gpu, d_gpu, _ = env.step(a)
            _, r_cpu, d_cpu, _ = cpu_env.step(a)
            n += 1
            worst = max(worst, abs(r_gpu - r_cpu))
            check(d_gpu == d_cpu and abs(r_gpu - r_cpu) <= 2e-4,
                  f"RL step {qid} {a}: card {r_gpu} vs CPU {r_cpu}")
            if d_gpu:
                break
    ms = np.array(step_times) * 1e3
    return {"phase": "G", "vocab": coll.cfg.vocab_size,
            "docs": coll.n_docs, "queries": len(qids), "build_s": build_s,
            "episodes": RL_EPISODES, "env_steps": len(step_times),
            "train_s": train_s, "step_ms_p50": float(np.median(ms)),
            "step_ms_mean": float(ms.mean()),
            "total_reward": float(np.sum(rewards)),
            "q_states": len(agent.q), "cpu_train_s": cpu_train_s,
            "episode_max_abs_reward_diff_vs_cpu": reward_diff,
            "q_max_abs_diff_vs_cpu": q_diff, "fixed_steps_compared": n,
            "fixed_max_abs_reward_diff_vs_cpu": worst}, None


# -- phase N: NaN order on the card ------------------------------------------

NAN_SHARE = 0.01  # seeded share of scores set to NaN
NAN_REL_ROWS = 8  # rows whose relevant documents all turn NaN
#: the short rows' document counts: below, at and above k = 1,000
SHORT_COUNTS = (1, 7, 128, 500, 999, 1000, 1500)


def _nan_scores(scores, rng, share=NAN_SHARE):
    out = np.array(scores, dtype=np.float32, copy=True)
    out[rng.random(out.shape) < share] = np.nan
    return out


def short_buffer(ev, rng, qids, nj=DEEP_J):
    """Phase C's first queries again with SHORT_COUNTS documents each: the
    query's own judged documents first (as many as fit), then other
    vocabulary documents, in a random order; NaN on a few of them, the
    relevant ones included."""
    counts = np.array(SHORT_COUNTS[:len(qids)])
    toks, scores = [], []
    for q, (qid, c) in enumerate(zip(qids, counts)):
        first = int(qid[1:]) * nj
        own = np.searchsorted(ev.vocab, np.char.add(
            "d", np.arange(first, first + nj).astype(str)))
        others = rng.choice(np.setdiff1d(np.arange(len(ev.vocab)), own),
                            max(0, c - nj), replace=False)
        t = rng.permutation(np.concatenate([own[:c], others]))
        s = np.round(rng.random(c), 4).astype(np.float32)
        s[rng.random(c) < 0.2] = np.nan
        toks.append(t)
        scores.append(s)
    return ev.buffer_from_tokens(qids, counts, np.concatenate(toks),
                                 np.concatenate(scores))


def _bits_equal(a, b):
    import torch

    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def _topk_exact(scores, k, what):
    """B2 against its plain version on ``scores``: indices exact, values
    bit for bit (NaN payloads included); returns the NaN count kept."""
    import torch

    from repro_torch.kernels import topk as TK

    v, i = TK.topk(scores, k)
    pv, pi = TK.topk_plain(scores, k)
    torch.cuda.synchronize()
    check(torch.equal(i, pi), f"{what}: top-k indices differ from plain")
    check(_bits_equal(v, pv), f"{what}: top-k values differ from plain")
    return int(torch.isnan(v).sum())


def phase_nan(device, deep, recsys, seed):
    """NaN scores through the top-k route (B2) and the full sort on phase
    C's buffer plus short rows; B2 against its plain version on NaN rows;
    SASRec retrieval with NaN candidate scores against the CPU."""
    import torch

    from repro_torch.core import compute_measures, concat_run_buffers
    from repro_torch.kernels import topk as TK
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.models import recsys as R

    ev, buf = deep
    rng = np.random.default_rng([seed, 17])
    scores = _nan_scores(buf.scores, rng)
    rel_rows = rng.choice(len(buf), NAN_REL_ROWS, replace=False)
    on_rel = np.isin(buf.qidx, rel_rows) & (buf.rel > 0)
    scores[on_rel] = np.nan
    nan_buf = buf.with_scores(scores)
    short = short_buffer(ev, rng, buf.qids[:len(SHORT_COUNTS)])
    big = concat_run_buffers([nan_buf, short])
    check(ev._route_topk(big), "NaN batch did not route to top-k")

    zero_launches()
    t0 = time.perf_counter()
    routed = ev.evaluate_buffers([nan_buf, short])
    routed_s = time.perf_counter() - t0
    launches = read_launches()
    check(launches["topk"] >= 1, "NaN batch did not launch the top-k kernel")

    # the same buffers through the full sort
    batch = ev.batch_from_buffer(big)
    per_query = compute_measures(batch, ev.measures, ev.relevance_level)
    table = torch.stack([per_query[k][:len(big)] for k in ev.measure_keys]
                        ).cpu().numpy()
    del batch, per_query
    n, worst, at = 0, 0.0, 0
    for part, res in zip((nan_buf, short), routed):
        full = {qid: {k: float(table[j, at + i])
                      for j, k in enumerate(ev.measure_keys)}
                for i, qid in enumerate(part.qids)}
        at += len(part)
        m, w = compare_results(res, full)
        n, worst = n + m, max(worst, w)

    # B2 against its plain version on the NaN matrix and at [1, 10^6]
    batch = ev.batch_from_buffer(big, topk_layout=True)
    k = min(ev._topk_depth, batch.scores.shape[1])
    scores_m = torch.where(batch.mask, batch.scores, -torch.inf).contiguous()
    del batch
    nan_kept = _topk_exact(scores_m, k, f"B2 at {list(scores_m.shape)}")
    # rows mostly NaN, so that NaNs fill the ends of their top k
    dense = scores_m[:64].clone()
    dense[torch.from_numpy(rng.random(tuple(dense.shape)) < 0.99).to(
        dense.device)] = torch.nan
    nan_kept_dense = _topk_exact(dense, k, "B2 on rows 99% NaN")
    check(nan_kept_dense > 0, "no NaN in the top k of rows 99% NaN")
    del scores_m, dense
    row = recsys["retrieval_scores"].clone()
    row[torch.from_numpy(rng.random(row.shape) < NAN_SHARE).to(row.device)] \
        = torch.nan
    nan_kept_row = _topk_exact(row, 1000, "B2 at [1, 10^6]")
    check(nan_kept_row == 0, "NaN entered the top 1,000 of 10^6")
    del row

    # SASRec retrieval with NaN candidate scores: NaN item embeddings on
    # 1% of the candidates (none in the user's history), card against CPU
    model, cfg, args, dev_args = recsys["sasrec"]
    batch, cand = dev_args[0], dev_args[1]
    hist = set(np.asarray(args[0]["items"]).reshape(-1).tolist())
    ids = np.unique(args[1][rng.random(args[1].shape) < NAN_SHARE])
    ids = torch.from_numpy(ids[~np.isin(ids, list(hist))]).long()
    saved = model.item_emb.detach()[ids.to(device)].clone()
    with torch.no_grad():
        model.item_emb[ids.to(device)] = torch.nan
    arch = get_arch("sasrec")
    shape = arch.shapes["retrieval_cand"]
    try:
        step = arch.make_step(cfg, shape).step_fn
        zero_launches()
        v, i, metrics = step(model, *dev_args)
        torch.cuda.synchronize()
        sas_launches = read_launches()
        check(sas_launches["topk"] == 1,
              "SASRec retrieval did not launch the top-k kernel once")
        with torch.inference_mode():
            full_row = R.sasrec_retrieval_scores(
                model, {**batch, "candidates": cand}, cfg).contiguous()
        n_nan = int(torch.isnan(full_row).sum())
        check(n_nan > 0, "no NaN candidate score")
        pv, pi = TK.topk_plain(full_row, v.shape[1])
        check(torch.equal(i, pi) and _bits_equal(v, pv),
              "SASRec retrieval top-k differs from the plain version")
        check(not bool(torch.isnan(v).any()), "NaN in SASRec's top 1,000")
        # the card's in-loop metrics against the CPU's full sort of the
        # card's scores, and the same step on the CPU with the same weights
        m_err = _check_metrics(metrics, full_row, args[2],
                               "SASRec retrieval with NaN")
        cpu_model = _cpu_copy(model, "sasrec")
        cv, _, _ = arch.make_step(cfg, shape, device="cpu").step_fn(
            cpu_model, *to_device(args, "cpu"))
        del cpu_model
        check(not bool(torch.isnan(cv).any()), "NaN in the CPU's top 1,000")
        err = _check_close(v, cv, "SASRec retrieval with NaN, values")
    finally:
        with torch.no_grad():
            model.item_emb[ids.to(device)] = saved
    return {"phase": "N", "queries": len(buf), "short_rows": len(short),
            "short_counts": list(SHORT_COUNTS), "nan_share": NAN_SHARE,
            "nan_scores": int(np.isnan(big.scores).sum()),
            "nan_on_relevant": int(on_rel.sum()), "topk_depth": k,
            "routed_eval_s": routed_s, "compared": n,
            "max_abs_diff_topk_vs_full_sort": worst, "launches": launches,
            "b2_nan_in_top_k": nan_kept,
            "b2_nan_in_top_k_rows_99pct_nan": nan_kept_dense,
            "retrieval_nan_candidates": n_nan,
            "sasrec_launches": sas_launches,
            "sasrec_values_max_abs_err_vs_cpu": err,
            "sasrec_metrics_max_abs_err_vs_cpu": m_err}, None


# -- phase H: the paper's surface (baselines, eval arch) and the service -----

#: ``python -m repro.baselines.trec_eval_cli -q -m map -m ndcg`` (the JAX
#: package's baseline) on the conformance fixtures, recorded once; the
#: port's baseline must print these bytes
BASELINE_GOLDEN = ("map\tq1\t0.5000\nndcg\tq1\t0.7763\n"
                   "map\tq2\t0.5000\nndcg\tq2\t0.6309\n"
                   "map\tall\t0.5000\nndcg\tall\t0.7036\n")
#: RQ1 (``benchmarks/bench_rq1.py``'s grid) and RQ2 (``bench_rq2.py``'s
#: depths), the paper's measures and repetitions
RQ1_QUERIES = (1, 10, 100, 1000)
RQ1_DOCS = (1, 10, 100, 1000)
RQ_MEASURES = ("map", "ndcg")
RQ1_REPS = 3
RQ2_DEPTHS = (1, 2, 3, 5, 10, 31, 100, 316, 1000, 3162, 10_000)
RQ2_REPS = 5
CHILD_TIMEOUT = 300  # seconds for any child process of phase H
#: the service: concurrent requests, runs compared, the depth-bounded
#: collection (queries, docs, judged) and its measures
SERVE_CONCURRENT = 64
COMPARE_RUNS = 8
SERVE_DEEP = (64, 2000, 128)
SERVE_DEEP_MEASURES = ("P_10", "ndcg_cut_10", "recall_10", "success_1")
SERVE_TIMEOUT = 300  # seconds: every client call and every wait on it
#: the service's coalescing window.  A Robust04-sized request is ~1.5 MB
#: of JSON that the client encodes and the server decodes on one thread
#: each, tens of ms apiece: with the default 2 ms every request arrives
#: alone (one backend call each, measured on the card).
SERVE_WINDOW_S = 0.25


def _src_env():
    env = dict(os.environ)
    src = os.path.join(ROOT, "src")
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    return env


def _child(args, env, **kw):
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, timeout=CHILD_TIMEOUT,
                          check=True, **kw)


def _mean_s(fn, reps, warmup):
    """Mean wall seconds of ``fn`` over ``reps`` after ``warmup`` calls
    (``benchmarks/common.py::time_call``)."""
    for _ in range(warmup):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def child_start(env):
    """Seconds for a bare interpreter, and for one that imports the
    baseline CLI and exits (medians of 3); the modules that import pulls
    in, from ``-X importtime``, must hold no torch, numpy or jax."""
    def median(args):
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            _child(args, env)
            times.append(time.perf_counter() - t0)
        return float(np.median(times))

    mod = "repro_torch.baselines.trec_eval_cli"
    trace = _child(["-X", "importtime", "-c", f"import {mod}"], env).stderr
    names = [ln.rsplit("|", 1)[-1].strip() for ln in trace.splitlines()
             if ln.startswith("import time:") and "|" in ln]
    heavy = sorted({n.split(".")[0] for n in names}
                   & {"torch", "numpy", "jax"})
    check(not heavy, f"the baseline child imports {heavy}")
    own = [ln for ln in trace.splitlines() if ln.rstrip().endswith(mod)]
    return {"bare_python_s": median(["-c", "pass"]),
            "import_cli_s": median(["-c", f"import {mod}"]),
            "cli_import_cumulative_us": int(own[0].split("|")[1]),
            "modules_imported": len(names)}


def phase_baselines(device):
    """The baseline CLI against its recorded output; RQ1 (in-process on the
    card against serialize-invoke-parse) and RQ2 (against native-Python
    NDCG), with the child's start-up."""
    import tempfile

    from repro_torch.baselines import native_ndcg, workflow
    from repro_torch.core import RelevanceEvaluator
    from repro_torch.data.synthetic_ir import synthesize_run

    env = _src_env()
    out = _child(["-m", "repro_torch.baselines.trec_eval_cli", "-q", "-m",
                  "map", "-m", "ndcg",
                  os.path.join(FIXTURES, "conformance.qrel"),
                  os.path.join(FIXTURES, "conformance.run")], env).stdout
    check(out == BASELINE_GOLDEN,
          "the baseline CLI's output differs from the JAX baseline's")
    child = child_start(env)

    rq1 = []
    with tempfile.TemporaryDirectory(prefix="rq1_") as workdir:
        for nq in RQ1_QUERIES:
            for nd in RQ1_DOCS:
                run, qrel = synthesize_run(nq, nd)
                t_in = _mean_s(lambda: RelevanceEvaluator(
                    qrel, RQ_MEASURES, device=device).evaluate(run),
                    RQ1_REPS, 1)
                t_sip = _mean_s(lambda: workflow.serialize_invoke_parse(
                    run, qrel, workdir, RQ_MEASURES,
                    timeout=CHILD_TIMEOUT), RQ1_REPS, 0)
                # child_start_share: the part of serialize-invoke-parse
                # that a child importing the CLI takes before any work
                rq1.append({"n_queries": nq, "n_docs": nd,
                            "inprocess_s": t_in, "sip_s": t_sip,
                            "speedup": t_sip / t_in,
                            "child_start_share": child["import_cli_s"]
                            / t_sip})
    rq2 = []
    for nd in RQ2_DEPTHS:
        run, qrel = synthesize_run(1, nd)
        docs, rels = run["q0"], qrel["q0"]
        ev = RelevanceEvaluator(qrel, ("ndcg",), device=device)
        ours = ev.evaluate(run)["q0"]["ndcg"]
        native = native_ndcg.ndcg(docs, rels)
        check(abs(ours - native) <= TOL + TOL * abs(native),
              f"RQ2 at {nd} docs: ndcg {ours} vs native {native}")
        t_ours = _mean_s(lambda: ev.evaluate(run), RQ2_REPS, 1)
        t_native = _mean_s(lambda: native_ndcg.ndcg(docs, rels),
                           RQ2_REPS, 1)
        rq2.append({"n_docs": nd, "ours_s": t_ours, "native_s": t_native,
                    "speedup": t_native / t_ours,
                    "abs_diff": abs(ours - native)})
    return {"phase": "H-baselines", "cli": "byte-match", "child": child,
            "rq1_measures": list(RQ_MEASURES), "rq1_reps": RQ1_REPS,
            "rq1": rq1, "rq2_reps": RQ2_REPS, "rq2": rq2}, None


def fit_to_spec(batch, specs):
    """``batch`` cut to the step's spec shapes: only padding may go (rows
    past the real queries, columns past every real document or ideal
    gain)."""
    q, d = specs.scores.shape
    j = specs.ideal_rel.shape[1]
    check(batch.scores.shape[0] >= q and batch.scores.shape[1] >= d
          and batch.ideal_rel.shape[1] >= j, "batch smaller than the spec")
    check(not bool(batch.query_mask[q:].any())
          and not bool(batch.mask[:, d:].any())
          and not bool(batch.ideal_rel[:, j:].any()),
          "cutting the batch to the spec would drop real entries")

    def cut(name, f):
        if f.dim() == 1:
            return f[:q]
        return (f[:q, :j] if name == "ideal_rel" else f[:q, :d]).contiguous()

    return type(batch)(*(cut(n, f) for n, f in zip(batch._fields, batch)))


def _timed_step(step, batch):
    """(result, median ms of 3 calls after one warm-up, peak device bytes
    above what was allocated before)."""
    import torch

    out = step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    times = []
    for _ in range(3):
        out, s = _synced(lambda: step(batch))
        times.append(s * 1e3)
    return (out, float(np.median(times)),
            torch.cuda.max_memory_allocated() - base)


def phase_arch(device, paper, deep):
    """``get_arch("pytrec-eval")`` at its two shapes, both engines, on
    phase B's and phase C's data: the engines agree with each other and
    with the mean of ``evaluate_buffer``'s per-query results."""
    import dataclasses

    from repro_torch.core import RelevanceEvaluator
    from repro_torch.core import ranked as RK
    from repro_torch.launch.api import get_arch

    arch = get_arch("pytrec-eval")
    out = {"phase": "H-arch", "shapes": {}}
    for shape_name, (ev, buf) in (("eval_10k_1k", paper),
                                  ("eval_1k_64k", deep)):
        shape = arch.shapes[shape_name]
        # phase B's evaluator computes the arch's measures (PAPER_MEASURES);
        # phase C's does not, so its qrel (the same vocabulary) gets one
        full = ev if shape_name == "eval_10k_1k" else RelevanceEvaluator(
            ev._qrel, PAPER_MEASURES, device=device)
        check(np.array_equal(full.vocab, ev.vocab),
              "the evaluator's vocabulary differs")
        per_query = full.evaluate_buffer(buf)
        bundles = {e: arch.make_step(dataclasses.replace(
            arch.make_config(False), engine=e), shape)
            for e in ("sorted", "ranked")}
        batch = fit_to_spec(full.batch_from_buffer(buf),
                            bundles["sorted"].arg_specs[0])
        res, row = {}, {}
        for engine, bundle in bundles.items():
            specs = bundle.arg_specs[0]
            arg = (RK.from_eval_batch(batch, specs.judged_scores.shape[1])
                   if engine == "ranked" else batch)
            for name, spec, f in zip(specs._fields, specs, arg):
                check((tuple(f.shape), f.dtype) == tuple(spec),
                      f"{shape_name} {engine}: {name} {tuple(f.shape)} "
                      f"{f.dtype} is not the step's {spec}")
            agg, ms, peak = _timed_step(bundle.step_fn, arg)
            res[engine] = {k: float(v) for k, v in agg.items()}
            row[engine] = {"step_ms": ms, "peak_extra_device_gb": peak / 1e9}
            del arg
        keys = list(res["sorted"])
        worst = 0.0
        for k in keys:
            a, b = res["ranked"][k], res["sorted"][k]
            worst = max(worst, abs(a - b))
            if is_exact(k):
                check(a == b, f"{shape_name}: {k} ranked {a} != sorted {b}")
            else:
                check(abs(a - b) <= TOL + TOL * abs(b),
                      f"{shape_name}: {k} ranked {a} vs sorted {b}")
        mean_err = 0.0
        for k in keys:
            m = float(np.mean([r[k] for r in per_query.values()]))
            mean_err = max(mean_err, abs(res["sorted"][k] - m))
            check(abs(res["sorted"][k] - m) <= TOL + TOL * abs(m),
                  f"{shape_name}: {k} step {res['sorted'][k]} vs "
                  f"evaluate_buffer mean {m}")
        specs = bundles["sorted"].arg_specs[0]
        row.update({"shape": list(specs.scores.shape)
                    + [specs.ideal_rel.shape[1]],
                    "ranked_vs_sorted_max_abs_diff": worst,
                    "sorted_vs_evaluate_buffer_mean_max_abs_diff": mean_err,
                    "map": res["sorted"]["map"]})
        out["shapes"][shape_name] = row
        del batch
    return out, None


def _run_dict(qids, docnos, scores):
    """Flat (qid, docno, score) arrays as a ``{qid: {docno: score}}`` run."""
    run = {}
    for q, d, sc in zip(qids.tolist(), docnos.tolist(), scores.tolist()):
        run.setdefault(q, {})[d] = sc
    return run


def _tokens(ev, qids, docnos):
    """The tokens payload of a query-major run: its queries in order, their
    document counts, and each docno's index in the evaluator's
    vocabulary (-1 where it is not judged)."""
    starts = np.flatnonzero(np.r_[True, qids[1:] != qids[:-1]])
    q_list = qids[starts].tolist()
    check(len(set(q_list)) == len(q_list), "run is not query-major")
    counts = np.diff(np.r_[starts, len(qids)]).tolist()
    tok = np.searchsorted(ev.vocab, docnos)
    hit = np.take(ev.vocab, np.minimum(tok, len(ev.vocab) - 1)) == docnos
    return q_list, counts, np.where(hit, tok, -1)


def check_direct(device, qrels, measures, runs, names, fresh, results,
                 what):
    """Each answer bit-identical to the same evaluation in process, on
    ``device``: ``evaluate_buffer`` of the collection's run re-scored with
    the request's scores, through ``ShardedEvaluator`` (B1) for the
    ``"sharded"`` collection."""
    from repro_torch.core import RelevanceEvaluator
    from repro_torch.distributed import ShardedEvaluator

    direct = {}
    for name in sorted(set(names)):
        dev_ev = RelevanceEvaluator(qrels[name], measures[name],
                                    device=device)
        direct[name] = (dev_ev, dev_ev.tokenize_run(runs[name]),
                        ShardedEvaluator(dev_ev) if name == "sharded"
                        else None)
    for j, (name, sc, res) in enumerate(zip(names, fresh, results)):
        dev_ev, buf, sev = direct[name]
        want = (sev.evaluate_buffer(buf, scores=sc).per_query if sev
                else dev_ev.evaluate_buffer(buf, scores=sc))
        check(res.per_query == want, f"{what}: request {j} ({name}) "
              "differs from a direct evaluate_buffer")


def _serve_tcp(device, sweep_data, rng, seed):
    """The TCP part of phase H: ServerThread on ``device`` and the port's
    EvalClient.  Returns the phase's numbers; raises on any mismatch."""
    from repro_torch import stats as S
    from repro_torch.client import EvalClient
    from repro_torch.core import RelevanceEvaluator, evaluate_sweep
    from repro_torch.serve.testing import ServerThread

    qrel, qids, docnos, scores = sweep_data
    run = _run_dict(qids, docnos, scores)
    dqrel, dqids, ddocnos, dscores = paper_data(rng, *SERVE_DEEP)
    measures = {"single": PAPER_MEASURES, "sharded": PAPER_MEASURES,
                "deep": SERVE_DEEP_MEASURES}
    qrels = {"single": qrel, "sharded": qrel, "deep": dqrel}
    runs = {"single": run, "sharded": run,
            "deep": _run_dict(dqids, ddocnos, dscores)}
    service_kw = {"backend": "single", "device": device,
                  "window": SERVE_WINDOW_S}
    with ServerThread(service_kw=service_kw) as srv, \
            EvalClient(srv.host, srv.port, timeout=SERVE_TIMEOUT) as client:
        t0 = time.perf_counter()
        n_docs = {}
        for name in ("single", "sharded", "deep"):
            info = client.register_qrel(
                name, qrels[name], list(measures[name]),
                backend="sharded" if name == "sharded" else None)
            check(info["backend"] == ("sharded" if name == "sharded"
                                      else "single"),
                  f"collection {name} got backend {info['backend']}")
            n_docs[name] = client.register_run(name, "base",
                                               run=runs[name])["n_docs"]
        register_s = time.perf_counter() - t0

        # SERVE_CONCURRENT re-scored requests, round robin over the three
        names = [("single", "sharded", "deep")[i % 3]
                 for i in range(SERVE_CONCURRENT)]
        fresh = [np.round(rng.random(n_docs[n]), 3) for n in names]
        before = srv.stats()
        done = [0.0] * len(names)
        start, futures = [], []
        zero_launches()
        for j, (name, sc) in enumerate(zip(names, fresh)):
            start.append(time.perf_counter())
            fut = client.submit(name, run_ref="base", scores=sc)
            fut.add_done_callback(
                lambda _, j=j: done.__setitem__(j, time.perf_counter()))
            futures.append(fut)
        results = [f.result(SERVE_TIMEOUT) for f in futures]
        launches = read_launches()
        after = srv.stats()

        # the compare: COMPARE_RUNS runs registered as token payloads
        ev = RelevanceEvaluator(qrel, PAPER_MEASURES, device=device)
        q_list, counts, tok = _tokens(ev, qids, docnos)
        cmp_scores = [np.round(rng.random(len(tok)), 3)
                      for _ in range(COMPARE_RUNS)]
        refs = [f"c{k}" for k in range(COMPARE_RUNS)]
        for ref, sc in zip(refs, cmp_scores):
            client.register_run("single", ref, tokens={
                "qids": q_list, "counts": counts, "tokens": tok.tolist(),
                "scores": sc.tolist()})
        t0 = time.perf_counter()
        report = client.compare("single", run_refs=refs, measure="map",
                                tests=["t", "permutation"],
                                n_permutations=SWEEP_PERMUTATIONS, seed=seed)
        compare_s = time.perf_counter() - t0

    check(launches["fused_measures"] >= 1,
          "the sharded collection did not launch the fused kernel")
    check(launches["topk"] >= 1,
          "the depth-bounded collection did not launch top-k")
    calls = after["backend_calls"] - before["backend_calls"]
    requests = after["requests"] - before["requests"]
    check(requests == SERVE_CONCURRENT, f"{requests} requests seen")
    check(calls < SERVE_CONCURRENT, f"{calls} backend calls for "
          f"{SERVE_CONCURRENT} requests: no coalescing")
    check_direct(device, qrels, measures, runs, names, fresh, results,
                 "service")
    sweep = evaluate_sweep(ev, [ev.buffer_from_tokens(q_list, counts, tok, sc)
                                for sc in cmp_scores], backend="single")
    want = S.significance_report(
        np.ascontiguousarray(sweep.measure("map")),
        tests=("t", "permutation"), n_permutations=SWEEP_PERMUTATIONS,
        seed=seed, device=device)
    check(report["qids"] == list(sweep.qids), "compare: query lists differ")
    for key, v in want.items():
        check(np.array_equal(np.asarray(report[key], np.float32),
                             np.asarray(v, np.float32)),
              f"compare: {key} differs from the in-process report")
    ms = (np.array(done) - np.array(start)) * 1e3
    wall = max(done) - min(start)
    return {
        "collections": {n: {"measures": list(measures[n]),
                            "docs_per_request": n_docs[n]}
                        for n in measures},
        "register_s": register_s,
        "p50_ms": float(np.percentile(ms, 50)),
        "p99_ms": float(np.percentile(ms, 99)), "max_ms": float(ms.max()),
        "requests_per_s": SERVE_CONCURRENT / wall,
        "docs_per_s": sum(len(sc) for sc in fresh) / wall,
        "backend_calls": calls,
        "flushes": after["flushes"] - before["flushes"],
        "peak_in_flight": after["peak_in_flight"], "launches": launches,
        "bit_identical_to_evaluate_buffer": SERVE_CONCURRENT,
        "compare_runs": COMPARE_RUNS, "compare_s": compare_s,
        "compare_equals_in_process": True}


def phase_service(device, sweep_data, seed):
    """The evaluation service on the card over TCP, driven by the port's
    client: three collections (Robust04-sized on ``"single"`` and on
    ``"sharded"``, a depth-bounded one), SERVE_CONCURRENT concurrent
    re-scored requests bit-identical to direct evaluations, one
    ``compare`` of COMPARE_RUNS runs equal to the in-process statistics;
    and ``python -m repro_torch.serve --device <device>`` over stdio, its
    ``map`` equal to the CLI's."""
    from repro_torch import cli
    from repro_torch.client import EvalClient
    from repro_torch.core import RelevanceEvaluator, trec

    rng = np.random.default_rng([seed, 29])
    out = {"phase": "H-service", "concurrent_requests": SERVE_CONCURRENT,
           "window_s": SERVE_WINDOW_S}
    qrel_path = os.path.join(FIXTURES, "conformance.qrel")
    run_path = os.path.join(FIXTURES, "conformance.run")
    conf_run = trec.load_run(run_path)
    # the stdio server starts first: its process start (torch, the card)
    # overlaps the TCP part
    old = os.environ.get("PYTHONPATH")
    os.environ["PYTHONPATH"] = _src_env()["PYTHONPATH"]
    try:
        t0 = time.perf_counter()
        stdio_client = EvalClient.spawn_stdio(
            [sys.executable, "-m", "repro_torch.serve", "--device", device,
             "--qrel", qrel_path, "-m", "map"], timeout=SERVE_TIMEOUT)
    finally:
        if old is None:
            os.environ.pop("PYTHONPATH", None)
        else:
            os.environ["PYTHONPATH"] = old
    with stdio_client:
        out.update(_serve_tcp(device, sweep_data, rng, seed))
        stdio = stdio_client.evaluate("default", run=conf_run).per_query
        out["stdio_s"] = time.perf_counter() - t0

    direct = RelevanceEvaluator(trec.load_qrel(qrel_path), ["map"],
                                device=device).evaluate(conf_run)
    check({q: r["map"] for q, r in stdio.items()}
          == {q: r["map"] for q, r in direct.items()},
          "stdio server's map differs from the in-process evaluator's")
    # the CLI's per-query map lines (python -m repro_torch -q -m map)
    text = io.StringIO()
    check(cli.main(["--device", device, "-q", "-m", "map", qrel_path,
                    run_path], out=text) == 0, "the CLI failed")
    cli_map = {p[1]: p[2] for p in map(str.split,
                                       text.getvalue().splitlines())
               if p[0] == "map" and p[1] != "all"}
    check({q: f"{r['map']:.4f}" for q, r in stdio.items()} == cli_map,
          "stdio server's map differs from the CLI's")
    out["stdio_map"] = {q: r["map"] for q, r in stdio.items()}
    return out, None


# -- phase K: the serve cluster on the card ----------------------------------

#: the cluster: workers, replica-set size, concurrent re-scored requests
#: (over phase H's three collections), requests tried until one sits on
#: the worker to be killed
CLUSTER_WORKERS = 2
CLUSTER_REPLICATION = 2
CLUSTER_CONCURRENT = 32
KILL_PROBES = 8
#: device memory each worker must hold once it has registered and
#: evaluated (its CUDA context and its collections): the card's free
#: memory, read in this process, must fall by CLUSTER_WORKERS times this.
#: The first run on an H100 80GB HBM3 saw 1,366,491,136 bytes for the two
#: workers (683 MB each); the bound is three quarters of that.
WORKER_MIN_BYTES = 512 * 2**20
CLUSTER_TIMEOUT = 120  # seconds: every boot, client call, poll and exit
POLL_S = 0.01  # seconds between two reads of a polled condition


def _wait_until(cond, timeout, every=POLL_S):
    """Poll ``cond`` until it returns something true (returned) or
    ``timeout`` seconds pass (None)."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        out = cond()
        if out:
            return out
        time.sleep(every)
    return None


def _poll(cond, what, timeout=CLUSTER_TIMEOUT):
    out = _wait_until(cond, timeout)
    check(out, f"{what}: not within {timeout} s")
    return out


def device_free_bytes():
    """Free memory of the whole card (every process), after this
    process's cached blocks are returned."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return torch.cuda.mem_get_info()[0]


def _pid_running(pid):
    """True while ``pid`` exists and is not a zombie."""
    try:
        with open(f"/proc/{pid}/stat") as fh:
            return fh.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (FileNotFoundError, ProcessLookupError):
        return False


class _Lines:
    """A child's text stream read into a list on a thread, so its pipe
    never fills; ``times`` holds when each line arrived."""

    def __init__(self, stream):
        self.lines, self.times = [], []
        self._thread = threading.Thread(target=self._read, args=(stream,),
                                        daemon=True)
        self._thread.start()

    def _read(self, stream):
        for line in stream:
            self.times.append(time.perf_counter())
            self.lines.append(line.rstrip("\n"))

    def wait_for(self, prefix, timeout=CLUSTER_TIMEOUT):
        """The first line starting with ``prefix`` and when it arrived."""
        i = _poll(lambda: next((i + 1 for i, ln in enumerate(
                      list(self.lines)) if ln.startswith(prefix)), None),
                  f"a {prefix!r} line on the child's stderr", timeout) - 1
        return self.lines[i], self.times[i]

    def join(self, timeout=10):
        self._thread.join(timeout)


def _workers(cluster):
    return {w["name"]: w for w in cluster.health()["workers"]}


def _back(cluster, name, generation):
    w = _workers(cluster).get(name)
    return w is not None and w["ready"] and w["generation"] > generation


def _slot_inflight(cluster, name):
    async def inflight():
        slot = cluster.router._slots.get(name)
        return 0 if slot is None else slot.inflight
    return cluster.call(inflight(), timeout=CLUSTER_TIMEOUT)


def _golden_text(per_query, qrel, measures):
    """trec_eval's summary lines for the conformance run, as the CLI
    prints them."""
    from repro_torch import cli
    from repro_torch.core import trec

    runid = trec.run_id(os.path.join(FIXTURES, "conformance.run"))
    lines = cli.summary_lines(per_query, cli.ordered_keys(measures), qrel,
                              runid)
    return "\n".join(lines) + "\n"


def _cluster_cli(device):
    """``python -m repro_torch.serve.cluster`` as a child: its banner, one
    request through it, then SIGTERM with the client still connected: rc 0
    within CLUSTER_TIMEOUT, no worker left."""
    from repro_torch.client import EvalClient
    from repro_torch.core import RelevanceEvaluator, trec

    qrel = trec.load_qrel(os.path.join(FIXTURES, "conformance.qrel"))
    run = trec.load_run(os.path.join(FIXTURES, "conformance.run"))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve.cluster", "--workers",
         str(CLUSTER_WORKERS), "--device", device, "--host", "127.0.0.1",
         "--port", "0", "--window-ms", "1"],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, env=_src_env())
    err = _Lines(proc.stderr)
    pids = []
    try:
        port = int(err.wait_for("serving on ")[0].rpartition(":")[2])
        # the router prints this line once every worker answered a ping
        boot_s = err.wait_for("cluster: ")[1] - t0
        with EvalClient("127.0.0.1", port, timeout=CLUSTER_TIMEOUT) as client:
            health = client.health()
            check(health["ready"] == CLUSTER_WORKERS,
                  f"the cluster CLI has {health['ready']} ready workers")
            pids = [w["pid"] for w in health["workers"]]
            client.register_qrel("conformance", qrel, ["map"])
            got = client.evaluate("conformance", run=run).per_query
            want = RelevanceEvaluator(qrel, ["map"],
                                      device=device).evaluate(run)
            check(got == want, "the cluster CLI's answer differs from the "
                  "in-process evaluator's")
            t1 = time.perf_counter()
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=CLUSTER_TIMEOUT)
            exit_s = time.perf_counter() - t1
        err.join()
        check(rc == 0, f"the cluster CLI exited {rc} after SIGTERM: "
              f"{err.lines[-5:]}")
        left = [p for p in pids if _pid_running(p)]
        check(not left, f"worker processes {left} outlived the cluster CLI")
        check(any(ln.startswith("drained") for ln in err.lines),
              "the cluster CLI did not report its drain")
    finally:
        if proc.poll() is None:
            # SIGTERM first: the cluster CLI stops its own workers
            proc.send_signal(signal.SIGTERM)
            try:
                proc.wait(timeout=CLUSTER_TIMEOUT)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)
        for pid in pids:
            if _pid_running(pid):
                os.kill(pid, signal.SIGKILL)
    return {"boot_s": boot_s, "sigterm_exit_s": exit_s, "rc": rc,
            "workers_left": 0, "worker_pids": pids}


def _kill_midrequest(cluster, client, scores):
    """SIGKILL the primary replica of ``"sharded"`` while a request sits
    on it (the worker is stopped first, so it holds the request); returns
    the requests sent, their answers, the seconds from the kill to the
    last answer and to the killed slot's next generation being ready."""
    owner = cluster.replicas_of("sharded")[0]
    generation = _workers(cluster)[owner]["generation"]
    futures = []
    cluster.pause_worker(owner)
    try:
        for sc in scores:
            futures.append(client.submit("sharded", run_ref="base",
                                         scores=sc))
            # p2c sends it to the stopped owner or its sibling: the next
            # one goes to whichever holds fewer
            if _wait_until(lambda: _slot_inflight(cluster, owner) > 0, 5):
                break
        check(_slot_inflight(cluster, owner) > 0,
              f"no request reached {owner} in {len(futures)} tries")
    finally:
        t_kill = time.perf_counter()
        cluster.kill_worker(owner)
    results = [f.result(CLUSTER_TIMEOUT) for f in futures]
    answered_s = time.perf_counter() - t_kill
    # every answer is in: had one waited for the killed slot's restart
    # instead of failing over, the new generation would be ready by now
    check(not _back(cluster, owner, generation), "the request waited for "
          "the restart instead of failing over to the sibling replica")
    _poll(lambda: _back(cluster, owner, generation),
          f"worker {owner} back after its SIGKILL")
    restart_s = time.perf_counter() - t_kill
    return owner, len(futures), results, answered_s, restart_s


def phase_cluster(device, sweep_data, seed):
    """The serve cluster on ``device``: a ClusterThread of CLUSTER_WORKERS
    workers (``--device <device>``), every collection on
    CLUSTER_REPLICATION of them, a durable journal in TMPDIR.  The card's
    free memory falls by the workers' contexts; phase H's three collections
    (Robust04-sized on ``"single"`` and ``"sharded"``, B1 in the workers,
    and the depth-bounded one, B2) answer CLUSTER_CONCURRENT concurrent
    re-scored requests bit-identical to ``evaluate_buffer`` here; a SIGKILL
    of a replica under a request fails over to its sibling and the slot
    comes back with its journal replayed; ``drop_qrel`` with every replica
    down is ``worker_unavailable``; a cluster rebooted on the state dir
    byte-matches the conformance golden; ``python -m
    repro_torch.serve.cluster --device <device>`` answers and exits 0 on
    SIGTERM with a client connected, leaving no worker behind."""
    import shutil
    import tempfile

    from repro_torch.client import EvalClient, WorkerUnavailableError
    from repro_torch.core import supported_measures, trec
    from repro_torch.serve.cluster.testing import ClusterThread

    rng = np.random.default_rng([seed, 31])
    qrel, qids, docnos, scores = sweep_data
    run = _run_dict(qids, docnos, scores)
    dqrel, dqids, ddocnos, dscores = paper_data(rng, *SERVE_DEEP)
    measures = {"single": PAPER_MEASURES, "sharded": PAPER_MEASURES,
                "deep": SERVE_DEEP_MEASURES}
    qrels = {"single": qrel, "sharded": qrel, "deep": dqrel}
    runs = {"single": run, "sharded": run,
            "deep": _run_dict(dqids, ddocnos, dscores)}
    backends = {"single": "single", "sharded": "sharded", "deep": "single"}
    conf_qrel = trec.load_qrel(os.path.join(FIXTURES, "conformance.qrel"))
    conf_run = trec.load_run(os.path.join(FIXTURES, "conformance.run"))
    selected = sorted(supported_measures)
    worker_args = ["--device", device, "--backend", "single",
                   "--window-ms", str(SERVE_WINDOW_S * 1e3)]
    state = tempfile.mkdtemp(prefix="cluster_state_")
    router_kw = dict(replication=CLUSTER_REPLICATION, retries=4,
                     health_interval=30.0, rng_seed=seed, state_dir=state)
    out = {"phase": "K", "workers": CLUSTER_WORKERS,
           "replication": CLUSTER_REPLICATION,
           "concurrent_requests": CLUSTER_CONCURRENT,
           "window_s": SERVE_WINDOW_S}
    try:
        free0 = device_free_bytes()
        t0 = time.perf_counter()
        with ClusterThread(CLUSTER_WORKERS, worker_args=worker_args,
                           router_kw=router_kw,
                           boot_timeout=CLUSTER_TIMEOUT) as cluster, \
                EvalClient(cluster.host, cluster.port,
                           timeout=CLUSTER_TIMEOUT) as client:
            out["boot_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            n_docs = {}
            for name in ("single", "sharded", "deep"):
                info = client.register_qrel(name, qrels[name],
                                            list(measures[name]),
                                            backend=backends[name])
                check(info["backend"] == backends[name],
                      f"collection {name} got backend {info['backend']}")
                n_docs[name] = client.register_run(
                    name, "base", run=runs[name])["n_docs"]
            client.register_qrel("conformance", conf_qrel, selected,
                                 relevance_level=1)
            client.register_qrel("drop-probe", conf_qrel, ["map"])
            out["register_s"] = time.perf_counter() - t0
            for name in ("single", "sharded", "deep"):
                client.evaluate(name, run_ref="base", scores=np.round(
                    rng.random(n_docs[name]), 3))
            free1 = device_free_bytes()
            out["device_free_drop_bytes"] = free0 - free1
            check(free0 - free1 >= CLUSTER_WORKERS * WORKER_MIN_BYTES,
                  f"the card's free memory fell by {free0 - free1} bytes, "
                  f"under {CLUSTER_WORKERS} x {WORKER_MIN_BYTES}: the "
                  "workers do not hold the card")

            # CLUSTER_CONCURRENT re-scored requests, round robin
            names = [("single", "sharded", "deep")[i % 3]
                     for i in range(CLUSTER_CONCURRENT)]
            fresh = [np.round(rng.random(n_docs[n]), 3) for n in names]
            before = cluster.stats()
            done = [0.0] * len(names)
            start, futures = [], []
            for j, (name, sc) in enumerate(zip(names, fresh)):
                start.append(time.perf_counter())
                fut = client.submit(name, run_ref="base", scores=sc)
                fut.add_done_callback(
                    lambda _, j=j: done.__setitem__(j, time.perf_counter()))
                futures.append(fut)
            results = [f.result(CLUSTER_TIMEOUT) for f in futures]
            after = cluster.stats()
            check_direct(device, qrels, measures, runs, names, fresh,
                         results, "cluster")
            requests = after["requests"] - before["requests"]
            check(requests == CLUSTER_CONCURRENT,
                  f"the workers saw {requests} requests")
            ms = (np.array(done) - np.array(start)) * 1e3
            out.update({
                "p50_ms": float(np.percentile(ms, 50)),
                "p99_ms": float(np.percentile(ms, 99)),
                "max_ms": float(ms.max()),
                "requests_per_s": CLUSTER_CONCURRENT
                / (max(done) - min(start)),
                "backend_calls": after["backend_calls"]
                - before["backend_calls"],
                "requests_per_worker": {
                    n: (w or {}).get("requests", 0)
                    - (before["workers"].get(n) or {}).get("requests", 0)
                    for n, w in after["workers"].items()},
                "bit_identical_to_evaluate_buffer": CLUSTER_CONCURRENT})

            # a replica SIGKILLed under a request
            kill_scores = [np.round(rng.random(n_docs["sharded"]), 3)
                           for _ in range(KILL_PROBES)]
            owner, sent, kill_results, answered_s, restart_s = \
                _kill_midrequest(cluster, client, kill_scores)
            check_direct(device, qrels, measures, runs, ["sharded"] * sent,
                         kill_scores, kill_results, "cluster kill")
            journaled = {"single", "sharded", "deep", "conformance",
                         "drop-probe"}
            held = set(cluster.stats()["workers"][owner]["collections"])
            check(journaled <= held, f"restarted {owner} holds {held}")
            out["kill"] = {"worker": owner, "requests": sent,
                           "answered_after_kill_s": answered_s,
                           "restart_s": restart_s}

            # drop_qrel with every replica down
            generations = {n: w["generation"]
                           for n, w in _workers(cluster).items()}
            t0 = time.perf_counter()
            for name in generations:
                cluster.kill_worker(name)
            try:
                client.drop_qrel("drop-probe")
                raise SmokeFailure("drop_qrel with every replica down "
                                   "was acknowledged")
            except WorkerUnavailableError as exc:
                code = exc.code
            for name, gen in generations.items():
                _poll(lambda: _back(cluster, name, gen),
                      f"worker {name} back after its SIGKILL")
            out["all_down"] = {"drop_qrel": code,
                               "restart_s": time.perf_counter() - t0}
            check(client.drop_qrel("drop-probe") is True,
                  "drop_qrel after the restart: the journal lost it")
            for name in ("single", "sharded", "deep"):
                check(client.drop_qrel(name) is True, f"drop {name}")
            out["router"] = dict(cluster.router.counters)
            check(out["router"]["failovers"] >= 1, "no failover counted")
            t0 = time.perf_counter()
        out["close_s"] = time.perf_counter() - t0

        # a new cluster on the same state dir: the journal holds only
        # the conformance collection now
        t0 = time.perf_counter()
        with ClusterThread(CLUSTER_WORKERS, worker_args=worker_args,
                           router_kw=router_kw,
                           boot_timeout=CLUSTER_TIMEOUT) as reborn, \
                EvalClient(reborn.host, reborn.port,
                           timeout=CLUSTER_TIMEOUT) as client:
            reboot_s = time.perf_counter() - t0
            journal = reborn.stats()["router"]["journal"]
            check(journal["recovered_collections"] == 1,
                  f"journal recovered {journal['recovered_collections']} "
                  "collections, want 1")
            res = client.evaluate("conformance", run=conf_run)
        check(_golden_text(res.per_query, conf_qrel, selected)
              == _golden("conformance.golden"),
              "the rebooted cluster's conformance output differs from "
              "the golden")
        out["state_dir_restart"] = {"boot_s": reboot_s,
                                    "golden": "byte-match"}
        # after every timed section, so its boot overlaps none of them
        out["cli"] = _cluster_cli(device)
    finally:
        shutil.rmtree(state, ignore_errors=True)
    return out, None


# -- entry point --------------------------------------------------------------


# -- phase T: training on the card --------------------------------------------

#: recsys training at full width and train_batch; GatedGCN at full width
TRAIN_STEPS = 3  # optimizer steps per model; steps 2..3 are timed
TRAIN_CHECK_ROWS = 1024  # rows of the one-step check against the CPU
GRAD_TOL = 2e-4  # loss, grad_norm, metrics (sums in another order)
#: A ReLU input within float32 rounding of 0 can take the other side of 0
#: on the card than on the CPU, which changes the gradient entries it
#: gates by their whole size.  Measured on an H100 80GB HBM3 (700 W): one
#: such tie of 5,120,000 SASRec inputs put ``blocks.w1`` 6.5e-4 of its norm
#: from the CPU step's, four of 14,855,680 GatedGCN inputs ``proj_node``
#: 3.46e-3.  Each input on the other side must lie within RELU_TIE_TOL of
#: 0 (relative to its call's largest |x|; 1.04e-7 at most there); the CPU
#: step then runs again with the card's sides, and every gradient entry
#: must be within GRAD_TOL·|g| + GRAD_TOL·max|g| of it (the largest leaf
#: 1.4e-6 of its norm there).
RELU_TIE_TOL = 1e-5
B3_BWD_TOL = 1e-6  # B3-bwd against its plain version on the card (atomics)
GNN_SHAPES = ("full_graph_sm", "molecule", "minibatch_lg")
GNN_CPU_SHAPE = "full_graph_sm"


def _cpu_clone(model):
    """The same weights in a module of the same class on the CPU (built on
    ``meta``, so no weights are drawn on the host)."""
    cpu = type(model)(model.cfg, device="meta").to_empty(device="cpu")
    cpu.load_state_dict(model.state_dict())
    return cpu


def gnn_batch(shape, cfg, seed):
    """A batch of ``shape``, numpy, from the seed: a random graph at the
    step's (n_nodes, n_edges) for the node task (``minibatch_lg``: made
    directly at the padded subgraph's size, the loss on its first
    ``batch_nodes`` nodes, as the sampler marks its seeds), a disjoint
    union of small graphs for the graph task."""
    from repro_torch.data import graph_data as GD

    n_classes, d_feat = shape.get("n_classes"), shape.get("d_feat")
    if shape.get("graph_task", False):
        return GD.graph_batch(shape.get("n_graphs"),
                              shape.get("nodes_per_graph"),
                              shape.get("edges_per_graph"), d_feat,
                              n_classes, cfg.d_edge_in, seed=seed)
    n = shape.get("n_nodes")
    g = GD.random_graph(GD.GraphConfig(n, shape.get("n_edges"), d_feat,
                                       n_classes, cfg.d_edge_in, seed))
    if shape.get("batch_nodes"):
        g["train_mask"] = np.arange(n) < shape.get("batch_nodes")
    return g


def _train_steps(bundle, model, state, batches, device):
    """TRAIN_STEPS steps; per step the host ms of the step (its batch
    already on the card; synchronised after) and the metrics, each
    finite."""
    import torch

    from repro_torch.launch.api import to_device

    rows = []
    for s in range(TRAIN_STEPS):
        batch = to_device(batches(s), device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, metrics = bundle.step_fn(model, state, batch)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        vals = {k: float(v) for k, v in metrics.items()}
        check(all(np.isfinite(v) for v in vals.values()),
              f"non-finite train metrics {vals}")
        rows.append({"ms": ms, **vals})
        del batch
    return model, state, rows


def profile_step(bundle, model, state, batch):
    """``profile_call`` of one more train step on ``batch`` (the model and
    state carried on); returns (profile, model, state)."""
    held = [model, state]

    def one():
        held[0], held[1], _ = bundle.step_fn(held[0], held[1], batch)

    prof = profile_call(one, top=10)
    return prof, held[0], held[1]


def _grads_close(card, cpu, what, hold=True):
    """Every entry of ``card`` (gradients on the card) within GRAD_TOL·|g|
    + GRAD_TOL·max|g| of ``cpu``'s (``hold=False``: shown, not held); per
    leaf, the norm share and the entries beyond."""
    import torch

    check(card.keys() == cpu.keys(), f"{what}: gradient leaves differ")
    out = {}
    for name, want in cpu.items():
        got = card[name]
        want = want.to(got.device)
        check(bool(torch.isfinite(got).all() and torch.isfinite(want).all()),
              f"{what} {name}: non-finite gradient")
        diff = got - want
        rel = float(torch.linalg.vector_norm(diff)
                    / torch.clamp(torch.linalg.vector_norm(want), min=1e-30))
        allow = GRAD_TOL * want.abs() + GRAD_TOL * float(want.abs().max())
        beyond = int((diff.abs() > allow).sum())
        check(not hold or beyond == 0, f"{what} {name}: {beyond} gradient "
              f"entries beyond {GRAD_TOL}·|g| + {GRAD_TOL}·max|g| of the "
              f"CPU's ({rel:.3g} of its norm)")
        out[name] = {"norm_share": rel, "entries_beyond": beyond,
                     "entries": got.numel()}
        del want, diff, allow
    return out


def _metrics_close(card, cpu, what):
    worst = 0.0
    for k, v in cpu.items():
        g, w = float(card[k]), float(v)
        check(abs(g - w) <= GRAD_TOL + GRAD_TOL * abs(w),
              f"{what} {k}: card {g} vs CPU {w}")
        worst = max(worst, abs(g - w))
    return worst


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_to(v, device) for v in tree))
    return tree.to(device)


def _relu_sides(given=None):
    """A ``TorchFunctionMode`` that keeps every ReLU's input, call by call
    (``inputs``, on their device).  With ``given`` (another run's
    ``inputs``), each ReLU takes their sides of 0 in place of its own:
    ``where(given > 0, x, 0)``, whose gradient is that side, as a ReLU's
    is."""
    import torch
    import torch.nn.functional as F
    from torch.overrides import TorchFunctionMode

    relus = (torch.relu, F.relu, torch.Tensor.relu)

    class ReluSides(TorchFunctionMode):
        def __init__(self):
            super().__init__()
            self.inputs = []

        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func not in relus:
                return func(*args, **kwargs)
            x = args[0]
            self.inputs.append(x.detach().clone())
            if given is None:
                return func(*args, **kwargs)
            side = given[len(self.inputs) - 1].to(x.device) > 0
            check(side.shape == x.shape, "ReLU calls differ in shape")
            return torch.where(side, x, torch.zeros((), dtype=x.dtype))

    return ReluSides()


def _relu_ties(card, cpu, what):
    """The ReLU inputs on the other side of 0 on the card than on the CPU,
    over every call of two runs' ``inputs``; each must lie within
    RELU_TIE_TOL of 0 on the CPU, relative to its call's largest |x|."""
    import torch

    check(len(card) == len(cpu), f"{what}: {len(card)} ReLU calls on the "
          f"card, {len(cpu)} on the CPU")
    flips, worst = 0, 0.0
    for got, want in zip(card, cpu):
        differ = (got.cpu() > 0) != (want > 0)
        flips += int(differ.sum())
        if bool(differ.any()):
            scale = torch.clamp(want.abs().max(), min=1e-30)
            worst = max(worst, float(want[differ].abs().max() / scale))
    check(worst <= RELU_TIE_TOL, f"{what}: a ReLU input {worst:.3g} of its "
          f"call's largest from 0 takes the other side on the card")
    return {"relu_inputs": sum(w.numel() for w in cpu), "relu_flips": flips,
            "relu_flip_largest_share": worst}


def _step_against_cpu(bundle, cpu_bundle, model, state, batch, device,
                      what):
    """One step of ``bundle`` on the card under
    ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the step
    raises) against the same step on the CPU (the kernels' plain
    versions) from the same weights and optimizer state: the metrics
    (loss, grad_norm, lr, rank metrics) and every parameter's gradient.
    Touched table rows are compared with the rest (untouched rows must be
    zero on both).  ReLU inputs that take the other side of 0 on the card
    must be ties (RELU_TIE_TOL); where there are any, the gradients are
    held against a second CPU step that takes the card's sides, and the
    plain CPU step's are shown."""
    import torch

    from repro_torch.launch.api import to_device

    cpu_model = _cpu_clone(model)
    cpu_state = _tree_to(state, "cpu")
    spare = _cpu_clone(model), _tree_to(state, "cpu")
    dev_batch = to_device(batch, device)
    cpu_batch = to_device(batch, "cpu")
    card_relu = _relu_sides()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with card_relu:
            model, state, metrics = bundle.step_fn(model, state, dev_batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    with _relu_sides() as cpu_relu:
        cpu_model, _, cpu_metrics = cpu_bundle.step_fn(
            cpu_model, cpu_state, cpu_batch)
    out = _relu_ties(card_relu.inputs, cpu_relu.inputs, what)
    card_grads = {n: p.grad for n, p in model.named_parameters()}
    cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    out["metrics_max_abs_err_vs_cpu"] = _metrics_close(metrics, cpu_metrics,
                                                       what)
    if out["relu_flips"]:
        out["grads_plain_cpu"] = _grads_close(card_grads, cpu_grads, what,
                                              hold=False)
        del cpu_model, cpu_grads, cpu_state
        with _relu_sides(card_relu.inputs):
            cpu_model, _, _ = cpu_bundle.step_fn(*spare, cpu_batch)
        cpu_grads = {n: p.grad for n, p in cpu_model.named_parameters()}
    del spare, card_relu, cpu_relu
    out.update({
        "grads": _grads_close(card_grads, cpu_grads, what),
        "loss": float(metrics["loss"]),
        "grad_norm": float(metrics["grad_norm"]),
        "sync_debug_mode": "error"})
    del cpu_model, cpu_grads
    return model, state, out


def _recsys_train(name, seed, device):
    """One arch at full width: TRAIN_STEPS steps at train_batch, then one
    step of TRAIN_CHECK_ROWS rows against the CPU."""
    import torch

    from repro_torch.configs.common import smoke_shape
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.launch.steps import MODELS
    from repro_torch.models import recsys as R

    arch = get_arch(name)
    cfg = arch.make_config(False)
    shape = arch.shapes["train_batch"]
    b = shape.get("batch")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = MODELS[name](cfg, device=device, generator=gen)
    bundle = arch.make_step(cfg, shape)
    state = bundle.init_opt(model)
    zero_launches()
    model, state, steps = _train_steps(
        bundle, model, state,
        lambda s: recsys_request(name, cfg, shape, seed, 3000 + s)[0],
        device)
    launches = read_launches()
    ms = float(np.median([s["ms"] for s in steps[1:]]))
    peak = torch.cuda.max_memory_allocated()
    prof, model, state = profile_step(bundle, model, state, to_device(
        recsys_request(name, cfg, shape, seed, 3000)[0], device))
    rows = R.train_chunk_rows(name, cfg)
    res = {"batch": b, "params": sum(p.numel() for p in model.parameters()),
           "step_ms": ms, "rows_per_s": b / ms * 1e3,
           "peak_device_bytes": peak, "chunk_rows": rows,
           "chunks": -(-b // rows), "steps": steps, "launches": launches,
           "profile": prof}
    if name == "xdeepfm":
        check(launches["embedding_bag"] > 0
              and launches["embedding_bag_backward"] > 0,
              f"xdeepfm training launched B3 {launches['embedding_bag']} and "
              f"B3-bwd {launches['embedding_bag_backward']} times")
    keep = None
    if name == "xdeepfm":
        keep = (model.table.shape[0], cfg,
                recsys_request(name, cfg, shape, seed, 3000)[0])
    del model, state
    # the check starts from the seed's weights, not from the steps' (whose
    # atomics differ run to run), so every run checks the same ReLU sides
    small = smoke_shape(shape, batch=TRAIN_CHECK_ROWS)
    batch = recsys_request(name, cfg, small, seed, 4000)[0]
    check_bundle = arch.make_step(cfg, small)
    gen = torch.Generator(device=device).manual_seed(seed)
    model = MODELS[name](cfg, device=device, generator=gen)
    _, _, res["against_cpu"] = _step_against_cpu(
        check_bundle, arch.make_step(cfg, small, device="cpu"), model,
        check_bundle.init_opt(model), batch, device, name)
    res["against_cpu"]["rows"] = TRAIN_CHECK_ROWS
    del model
    return res, keep


def b3_backward_check(xdeepfm, seed, device):
    """B3-bwd at the train_batch shape (65,536 rows x 3 multi-hot fields x
    8 lookups into the 39M-row table): two launches bit for bit equal,
    within B3_BWD_TOL of the plain version on the card (``index_add_``
    with atomics) and bit for bit equal to the plain version on the CPU
    (which adds in lookup order, as the kernel does)."""
    import torch

    from repro_torch.kernels import embedding_bag as EB

    v, cfg, batch = xdeepfm
    b, f, m = batch["mh_ids"].shape
    e = cfg.table.dim
    ids = torch.from_numpy(batch["mh_ids"].reshape(b * f, m)).to(device)
    mask = torch.from_numpy(batch["mh_mask"].reshape(b * f, m)).to(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    grad = torch.randn((b * f, e), generator=gen, device=device)
    args = (grad, ids, mask, v, f, cfg.table.vocab_per_field)
    first = EB.embedding_bag_fixed_backward(*args)
    second = EB.embedding_bag_fixed_backward(*args)
    plain = EB.embedding_bag_fixed_backward_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(first, second), "B3-bwd differs between two launches")
    err = float((first - plain).abs().max())
    check(err <= B3_BWD_TOL, f"B3-bwd {err} from its plain version")
    del second, plain
    cpu = EB.embedding_bag_fixed_backward_plain(
        grad.cpu(), ids.cpu(), mask.cpu(), v, f, cfg.table.vocab_per_field)
    check(torch.equal(first.cpu(), cpu),
          "B3-bwd differs from the plain version on the CPU")
    del first, cpu
    return {"shape": [v, e, b * f * m, b * f], "max_abs_err": err,
            "deterministic": True, "bit_identical_to_cpu_plain": True}, args


def _gnn_train(shape_name, seed, device):
    import torch

    from repro_torch.configs.gatedgcn import shape_config
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.models.gnn import GatedGCN

    arch = get_arch("gatedgcn")
    shape = arch.shapes[shape_name]
    cfg = arch.make_config(False)
    scfg = shape_config(cfg, shape)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = GatedGCN(scfg, device=device, generator=gen)
    bundle = arch.make_step(cfg, shape)
    state = bundle.init_opt(model)
    batch = gnn_batch(shape, scfg, seed)
    model, state, steps = _train_steps(bundle, model, state,
                                       lambda s: batch, device)
    for s in steps:
        for k in ("recip_rank", "ndcg", "success_1", "success_5",
                  "success_10"):
            check(0.0 <= s[k] <= 1.0, f"gatedgcn {shape_name} {k} = {s[k]}")
    res = {"n_nodes": shape.get("n_nodes"), "n_edges": shape.get("n_edges"),
           "step_ms": float(np.median([s["ms"] for s in steps[1:]])),
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "steps": steps}
    res["profile"], model, state = profile_step(
        bundle, model, state, to_device(batch, device))
    del model, state
    if shape_name == GNN_CPU_SHAPE:  # from the seed's weights, as recsys
        gen = torch.Generator(device=device).manual_seed(seed)
        model = GatedGCN(scfg, device=device, generator=gen)
        _, _, res["against_cpu"] = _step_against_cpu(
            bundle, arch.make_step(cfg, shape, device="cpu"), model,
            bundle.init_opt(model), batch, device, f"gatedgcn {shape_name}")
        del model
    return res


def phase_train(device, seed):
    """Training on the card: the four recsys archs at full width and
    train_batch, B3-bwd against its plain version, GatedGCN at full width
    on three shapes; ogb_products reckoned, not run."""
    import torch

    from repro_torch.launch.api import get_arch

    result = {"phase": "T", "recsys": {}, "gnn": {}}
    keep = {}
    for name in RECSYS_ARCHS:
        t0 = time.perf_counter()
        res, xd = _recsys_train(name, seed, device)
        res["seconds"] = time.perf_counter() - t0
        result["recsys"][name] = res
        if xd is not None:
            keep["xdeepfm_launches"] = res["launches"]
            result["b3_backward"], keep["b3_backward"] = b3_backward_check(
                xd, seed, device)
            keep["xdeepfm"] = xd
        torch.cuda.empty_cache()
    for shape_name in GNN_SHAPES:
        t0 = time.perf_counter()
        result["gnn"][shape_name] = _gnn_train(shape_name, seed, device)
        result["gnn"][shape_name]["seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    ogb = get_arch("gatedgcn").shapes["ogb_products"]
    d = get_arch("gatedgcn").make_config(False).d_hidden
    layers = get_arch("gatedgcn").make_config(False).n_layers
    edge_state = ogb.get("n_edges") * d * 4
    result["gnn"]["ogb_products"] = {
        "run": False, "edge_state_bytes": edge_state,
        "carried_edge_states_bytes": edge_state * layers,
        "why": "one [E, 70] float32 edge state is 17.3 GB; 16 layers of "
               "them are kept for backward: a shape spec until sharded "
               "training exists"}
    return result, keep


B3_BWD_REPLACES = ("none: port-only (the JAX package trains without its "
                   "Pallas kernel, src/repro/models/embedding.py:50-73)")


def b3_bwd_shape(args):
    """Of B3-bwd's inputs: the kernel's slab rows, the heaviest slab's
    lookups, the lookups of the longest run (one row), of
    the longest run of mask-1 lookups, and the slabs any lookup reaches."""
    import torch

    from repro_torch.kernels import embedding_bag as EB

    grad, ids, mask, v, f, field_rows = args
    keys = EB._rows32(ids, f, field_rows).reshape(-1).long()
    r = EB.slab_rows(grad.shape[1])
    slabs = torch.bincount(keys // r)
    runs = torch.bincount(keys)
    held = torch.bincount(keys[mask.reshape(-1)]) if mask is not None \
        else runs
    return {"slab_rows": r, "slabs": -(-v // r),
            "slabs_reached": int((slabs > 0).sum()),
            "heaviest_slab_lookups": int(slabs.max()),
            "longest_run": int(runs.max()),
            "longest_run_mask_1": int(held.max()) if held.numel() else 0}


def b3_bwd_order_check(args, got, plain):
    """B3-bwd against its atomic plain version on the card where a row
    sums many terms: two orders of n terms each lie within (n - 1)·2^-24
    of the sum of their magnitudes from the exact sum, so they differ by
    at most 2·(n - 1)·2^-24·sum|x|, entry by entry.  Returns the largest
    difference over that limit (<= 1 passes)."""
    import torch

    from repro_torch.kernels import embedding_bag as EB

    grad, ids, mask, v, f, field_rows = args
    rows = EB._fixed_rows(ids, f, field_rows).reshape(-1)
    n = torch.bincount(rows, minlength=v).to(torch.float32)
    mag = EB.embedding_bag_fixed_backward_plain(grad.abs(), ids, mask, v, f,
                                                field_rows)
    limit = 2.0 * (n - 1).clamp(min=0)[:, None] * 2.0**-24 * mag
    over = (got - plain).abs() / limit.clamp(min=1e-38)
    check(bool(((got - plain).abs() <= limit).all()),
          f"B3-bwd beyond the summation-order limit from its plain version "
          f"(worst {float(over.max())} of the limit)")
    return float(over[limit > 0].max()) if bool((limit > 0).any()) else 0.0


def b3_bwd_row(args, launches, err, **extra):
    """B3-bwd's kernel row at ``args`` (grad, ids, mask, num_rows, fields,
    field_rows), whose checks ran before: the op (grouping and one launch),
    the grouping alone, the kernel alone on prepared inputs, each by CUDA
    events, the dense gradient's zero fill as the bound's yardstick, the
    plain version (``index_add_``, atomics) and the backward of
    ``F.embedding_bag(..., mode="sum", per_sample_weights=mask)``; the
    bound counts the dense
    ``[V, E]`` gradient written once, the ids, mask and output gradient
    read once; the heaviest slab and the longest run."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as EB

    grad, ids, mask, v, f, field_rows = args
    n, m = ids.shape
    e = grad.shape[1]
    before = EB.BACKWARD_LAUNCHES
    EB.embedding_bag_fixed_backward(*args)
    per_call = EB.BACKWARD_LAUNCHES - before
    check(per_call == 1, f"B3-bwd launched {per_call} kernels a call")
    prepared = EB.prepare_backward(ids, v, e, f, field_rows)
    rows64 = EB._fixed_rows(ids, f, field_rows).reshape(-1)
    table = torch.zeros((v, e), device=grad.device, requires_grad=True)
    lib_out = F.embedding_bag(rows64.reshape(n, m), table, mode="sum",
                              per_sample_weights=mask.to(torch.float32))
    row = dict(
        name="embedding_bag_backward", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces=B3_BWD_REPLACES, launches=launches,
        kernel_launches_per_call=per_call, max_abs_err=err,
        ms=time_ms(lambda: EB.embedding_bag_fixed_backward(*args),
                   iters=10),
        grouping_ms=time_ms(lambda: EB.prepare_backward(ids, v, e, f,
                                                        field_rows),
                            iters=10),
        kernel_ms=time_ms(lambda: EB.launch_backward(grad, mask, m, v,
                                                     *prepared), iters=10),
        zero_fill_ms=time_ms(lambda: torch.zeros((v, e),
                                                 device=grad.device),
                             iters=10),
        plain_ms=time_ms(
            lambda: EB.embedding_bag_fixed_backward_plain(*args), iters=10),
        shape=[v, e, n * m, n],
        **b3_bwd_shape(args), **extra,
        **bound(v * e * 4 + n * m * 5 + n * e * 4, 2 * n * m * e),
        library_ms=time_ms(lambda: torch.autograd.grad(
            lib_out, table, grad, retain_graph=True), iters=10))
    row["kernel_share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
    del lib_out, table
    return row


# -- phase L: the LM family on the card ---------------------------------------

LM_ARCHS = ("olmo-1b", "phi3-medium-14b", "nemotron-4-15b",
            "qwen3-moe-235b-a22b", "arctic-480b")
LM_CHECK_BATCH, LM_CHECK_SEQ = 2, 16  # L1: smoke configs, card vs CPU
LM_DECODE_STEPS = 4
LM_ROUTE_DRAWS = 8  # L1: batches drawn until card and CPU routes agree
#: L2, olmo-1b at full width and depth.  JAX's train_4k batch (256) is a
#: pod's.  Params, grads and AdamW's float32 m and v take ~19 GB; the
#: naive attention keeps a [B, 16, S, S] float32 softmax per layer in
#: backward and the loss a [B, S, 50,304] float32 one.  8 sequences of
#: 4,096 ran out of memory after the earlier phases (49 GiB allocated,
#: 24 GiB held by the allocator in pieces too small); 4 leave room
OLMO_TRAIN_BATCH = 4
OLMO_PREFILL_SEQ = 16_384  # batch 1: [16, S, S] float32 scores, 17.2 GB
OLMO_DECODE_BATCH = 8  # a seeded 32,768-token cache, 4.29 GB a sequence
OLMO_DECODE_STEPS = 10  # timed decode steps at pos 32,767
CONSIST_PROMPT, CONSIST_STEPS = 256, 8  # prefill + decode vs logits_train
#: bfloat16 gap between prefill + decode_step and logits_train on the same
#: tokens (another order of every sum): max |diff| over max |logit|.
#: Measured on an H100 at these shapes: 1.44e-2 (float32 from the same
#: weights: 3.0e-6); the limit is about twice that, 8 bfloat16 roundings
#: (2^-8 each) of the largest logit
LM_BF16_TOL = 3e-2
#: the same gap in float32 from the same weights: a decode fault (a RoPE
#: position, a cache slot, the mask) that bfloat16's limit could hide
#: shows here.  Measured on an H100: 3.0e-6; the limit is 30 times that
LM_F32_TOL = 1e-4
#: L3, qwen3-moe-235b at full width with its depth cut
QWEN3_LAYERS = 8
QWEN3_PREFILL_SEQ = 4096
QWEN3_DECODE_STEPS = 4


class _RouteLog:
    """Every ``models.moe.route_experts`` call's (gate values, token
    indices), kept on their device, while the ``with`` block runs (the
    unsharded ``route`` and the mesh's expert-parallel branch both call
    it).  ``alter(gate, idx)``, when given, replaces what each call
    returns: a planted routing fault."""

    def __init__(self, alter=None):
        self.alter = alter

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self._moe, self._route = [], moe, moe.route_experts

        def route_experts(*args, **kwargs):
            out = self._route(*args, **kwargs)
            if self.alter is not None:
                out = self.alter(*out)
            self.calls.append(tuple(t.detach() for t in out))
            return out

        moe.route_experts = route_experts
        return self

    def take(self):
        """The (expert, token) pairs that each call since the last take
        held, on the host."""
        import torch

        calls, self.calls = self.calls, []
        out = []
        for g, i in calls:
            e, c = torch.nonzero(g > 0, as_tuple=True)
            out.append(tuple(zip(e.tolist(), i[e, c].tolist())))
        return tuple(out)

    def __exit__(self, *exc):
        self._moe.route_experts = self._route


def _slot_table(gate, idx, n_tokens):
    """``[T, E]``: the capacity slot (1-based) each token holds in each
    expert, 0 where it holds none (a zero gate fills a slot, holds none)."""
    import torch

    gate, idx = gate.cpu(), idx.cpu()
    e, c = idx.shape
    table = torch.zeros((n_tokens, e), dtype=torch.int64)
    slots = torch.arange(1, c + 1).expand(e, c)
    experts = torch.arange(e)[:, None].expand(e, c)
    held = gate > 0
    table[idx[held], experts[held]] = slots[held]
    return table


def _route_flips(card, cpu, n_tokens):
    """Tokens whose expert choice or capacity slot differs between two
    runs' route logs, in any layer (a bool ``[T]``)."""
    import torch

    check(len(card) == len(cpu), "route logs differ in length")
    flipped = torch.zeros(n_tokens, dtype=torch.bool)
    for (g1, i1), (g2, i2) in zip(card, cpu):
        flipped |= (_slot_table(g1, i1, n_tokens)
                    != _slot_table(g2, i2, n_tokens)).any(dim=1)
    return flipped


def _close_rows(got, want, rows, what, tol=TOL):
    """``got`` within atol = rtol = tol of ``want`` on the batch rows
    ``rows`` keeps; returns the largest difference there."""
    import torch

    got, want = got.float().cpu()[rows], want.float().cpu()[rows]
    if got.numel() == 0:
        return 0.0
    err = float((got - want).abs().max())
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite values")
    check(bool(((got - want).abs() <= tol + tol * want.abs()).all()),
          f"{what}: {err} from the CPU's (limit {tol})")
    return err


def _lm_against_cpu(name, seed, device):
    """L1: one smoke arch on the card against the CPU from the same
    weights: a train step (under sync debug mode "error"), prefill, and
    LM_DECODE_STEPS decode steps; MoE routes compared token by token."""
    import torch

    from repro_torch.configs.common import smoke_shape
    from repro_torch.data import lm_data as LD
    from repro_torch.launch.api import get_arch
    from repro_torch.models import transformer as TF

    arch = get_arch(name)
    cfg = arch.make_config(True)
    b, s, n = LM_CHECK_BATCH, LM_CHECK_SEQ, LM_DECODE_STEPS
    gen = torch.Generator(device=device).manual_seed(seed)
    model = TF.Transformer(cfg, device=device, generator=gen)
    cpu_model = _cpu_clone(model)
    res = {"batch": b, "seq": s, "moe": cfg.moe is not None,
           "train_tokens_rerouted": [], "logits_max_abs_err": 0.0}
    # the forward on both devices first: routes and per-row agreement.
    # The train step is held against the CPU's on a batch whose every
    # route agrees: the batch is drawn again (at most LM_ROUTE_DRAWS
    # times) while a route differs
    for draw in range(LM_ROUTE_DRAWS):
        batch = LD.MarkovLM(LD.LMDataConfig(cfg.vocab_size, s, b,
                                            seed=seed + draw)).batch(0)
        tokens = torch.from_numpy(batch["tokens"])
        with torch.no_grad(), _RouteLog() as card_log:
            card_logits = TF.logits_train(model, tokens.to(device), cfg)
        with torch.no_grad(), _RouteLog() as cpu_log:
            cpu_logits = TF.logits_train(cpu_model, tokens, cfg)
        flips = _route_flips(card_log.calls, cpu_log.calls, b * s)
        rows = ~flips.reshape(b, s).any(dim=1)
        res["train_tokens_rerouted"].append(int(flips.sum()))
        res["logits_max_abs_err"] = max(res["logits_max_abs_err"], _close_rows(
            card_logits, cpu_logits, rows, f"{name} logits_train"))
        if not bool(flips.any()):
            break
    check(not bool(flips.any()), f"{name}: card and CPU routes differ on "
          f"each of {LM_ROUTE_DRAWS} batches")
    res["train_batch_draws"] = draw + 1
    del card_logits, cpu_logits, cpu_model
    shape = smoke_shape(arch.shapes["train_4k"], seq_len=s, global_batch=b)
    bundle = arch.make_step(cfg, shape, device=device)
    state = bundle.init_opt(model)
    model, state, res["train_against_cpu"] = _step_against_cpu(
        bundle, arch.make_step(cfg, shape, device="cpu"), model, state,
        batch, device, name)
    del state

    # serving: prefill s - n tokens into a cache of s, decode n more
    cpu_model = _cpu_clone(model)
    pre = smoke_shape(arch.shapes["prefill_32k"], seq_len=s - n,
                      global_batch=b)
    dec = smoke_shape(arch.shapes["decode_32k"], seq_len=s, global_batch=b)
    labels = torch.from_numpy(batch["labels"])
    runs = []
    for dev, m in ((device, model), ("cpu", cpu_model)):
        toks, gold = tokens.to(dev), labels.to(dev)
        with _RouteLog() as log:
            last, full = arch.make_step(cfg, pre, device=dev).step_fn(
                m, toks[:, :s - n], max_seq=s)
            step = arch.make_step(cfg, dec, device=dev).step_fn
            logits, metrics = [last], []
            for pos in range(s - n, s):
                out, full, mets = step(m, full, toks[:, pos], pos,
                                       gold[:, pos])
                logits.append(out)
                metrics.append(mets)
        runs.append((log.calls, logits, metrics, full))
    card, cpu = runs
    # route calls: one a layer in the prefill, then one a layer a step
    n_pre = per_step = cfg.n_layers if cfg.moe else 0
    flips = _route_flips(card[0][:n_pre], cpu[0][:n_pre], b * (s - n))
    rows = ~flips.reshape(b, s - n).any(dim=1)
    for i in range(n):
        calls = slice(n_pre + i * per_step, n_pre + (i + 1) * per_step)
        rows &= ~_route_flips(card[0][calls], cpu[0][calls], b)
    res["serve_tokens_rerouted"] = int(flips.sum())
    res["serve_rows_held"] = int(rows.sum())
    errs = [_close_rows(g, w, rows, f"{name} logits {i}")
            for i, (g, w) in enumerate(zip(card[1], cpu[1]))]
    for k in ("k", "v"):
        errs.append(_close_rows(card[3][k].transpose(0, 1),
                                cpu[3][k].transpose(0, 1), rows,
                                f"{name} cache {k}"))
    if bool(rows.all()):  # means over the batch: held when no row differs
        for i, (g, w) in enumerate(zip(card[2], cpu[2])):
            errs.append(_metrics_close(g, w, f"{name} decode {i}"))
    res["serve_max_abs_err"] = max(errs)
    return res


def _spec_bytes(tree):
    """Bytes of a tree of ``launch.api.TensorSpec``s."""
    import torch

    from repro_torch.launch.api import TensorSpec

    if isinstance(tree, TensorSpec):
        return int(np.prod(tree.shape, dtype=np.int64)) * torch.empty(
            (), dtype=tree.dtype).element_size()
    if isinstance(tree, dict):
        return sum(_spec_bytes(v) for v in tree.values())
    return sum(_spec_bytes(v) for v in tree)


def _lm_bytes(name, cfg, device):
    """From the ``train_4k`` bundle's argument specs (nothing
    allocated): the parameters and their bytes, one layer's bytes and
    the rest's, and the same for training state (parameters, gradients
    and the optimizer's m and v); the deepest stack of layers whose
    weights (or training state, activations aside) one card holds."""
    import torch

    from repro_torch.launch.api import get_arch

    arch = get_arch(name)
    params, opt, _ = arch.make_step(cfg, arch.shapes["train_4k"],
                                    device=device).arg_specs
    total = torch.cuda.get_device_properties(0).total_memory
    out = {"params": sum(int(np.prod(p.shape)) for p in params.values())}
    for what, per_name in (
            ("weights", lambda n: _spec_bytes(params[n])),
            ("train_state", lambda n: 2 * _spec_bytes(params[n])
             + _spec_bytes(opt.m[n]) + _spec_bytes(opt.v[n]))):
        layer = sum(per_name(n) for n in params
                    if n.startswith("layers.")) // cfg.n_layers
        rest = sum(per_name(n) for n in params
                   if not n.startswith("layers."))
        out[f"{what}_bytes"] = layer * cfg.n_layers + rest
        out[f"{what}_bytes_per_layer"] = layer
        out[f"{what}_bytes_outside_layers"] = rest
        out[f"largest_depth_{what}_fit"] = max(0, (total - rest) // layer)
    return out


def _olmo_train(model, cfg, arch, seed, device):
    import torch

    from repro_torch.configs.common import smoke_shape
    from repro_torch.data import lm_data as LD
    from repro_torch.launch.api import to_device

    b, s = OLMO_TRAIN_BATCH, arch.shapes["train_4k"].get("seq_len")
    shape = smoke_shape(arch.shapes["train_4k"], global_batch=b)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bundle = arch.make_step(cfg, shape, device=device)
    state = bundle.init_opt(model)
    data = LD.MarkovLM(LD.LMDataConfig(cfg.vocab_size, s, b, seed=seed))
    zero_launches()
    model, state, steps = _train_steps(bundle, model, state, data.batch,
                                       device)
    launches = read_launches()
    ms = float(np.median([x["ms"] for x in steps[1:]]))
    jb = arch.shapes["train_4k"].get("global_batch")
    res = {"batch": b, "seq": s, "cut": f"global_batch {jb} -> {b}",
           "step_ms": ms, "tokens_per_s": b * s / ms * 1e3,
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "steps": steps, "launches": launches}
    check(not any(launches.values()),
          f"olmo-1b training launched kernels {launches}")
    res["profile"], model, state = profile_step(
        bundle, model, state, to_device(data.batch(TRAIN_STEPS), device))
    del state
    return model, res


def _olmo_serve(model, cfg, arch, seed, device):
    """prefill at OLMO_PREFILL_SEQ, decode_32k at OLMO_DECODE_BATCH from
    a seeded cache at its last position, and prefill + decode_step against
    logits_train on the same tokens."""
    import torch

    from repro_torch.configs.common import smoke_shape
    from repro_torch.models import transformer as TF

    rng = np.random.default_rng(seed)
    res = {}
    s = OLMO_PREFILL_SEQ
    full = arch.shapes["prefill_32k"]
    step = arch.make_step(cfg, smoke_shape(arch.shapes["prefill_32k"],
                                           seq_len=s, global_batch=1),
                          device=device)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s))
                              .astype(np.int32)).to(device)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    step.step_fn(model, tokens)  # warm-up
    (last, cache), sec = _synced(lambda: step.step_fn(model, tokens))
    ms = sec * 1e3
    check(bool(torch.isfinite(last).all()), "olmo prefill: non-finite logits")
    check(tuple(cache["k"].shape) == (cfg.n_layers, 1, cfg.n_kv_heads, s,
                                      cfg.head_dim), "olmo prefill cache")
    res["prefill"] = {
        "seq": s, "batch": 1, "ms": ms, "tokens_per_s": s / ms * 1e3,
        "cut": f"seq_len {full.get('seq_len')} -> {s}, global_batch "
               f"{full.get('global_batch')} -> 1",
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "scores_bytes_per_layer": cfg.n_heads * s * s * 4,
        "prefill_32k_shape_spec": {
            "seq": full.get("seq_len"), "batch": full.get("global_batch"),
            "scores_bytes_per_layer_per_sequence":
                cfg.n_heads * full.get("seq_len") ** 2 * 4}}
    del last, cache

    b, s = OLMO_DECODE_BATCH, arch.shapes["decode_32k"].get("seq_len")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    cache = TF.init_cache(cfg, b, s, device=device)
    for k in cache:
        cache[k].normal_(0.0, 1.0, generator=gen)
    step = arch.make_step(cfg, smoke_shape(arch.shapes["decode_32k"],
                                           global_batch=b),
                          device=device).step_fn
    token = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)
                             .astype(np.int32)).to(device)
    gold = torch.from_numpy(rng.integers(0, cfg.vocab_size, b)
                            .astype(np.int32)).to(device)
    step(model, cache, token, s - 1, gold)  # warm-up
    times = []
    for _ in range(OLMO_DECODE_STEPS):
        (logits, cache, metrics), sec = _synced(
            lambda: step(model, cache, token, s - 1, gold))
        times.append(sec * 1e3)
    vals = {k: float(v) for k, v in metrics.items()}
    check(bool(torch.isfinite(logits).all())
          and all(np.isfinite(v) for v in vals.values()),
          "olmo decode: non-finite output")
    prof = profile_call(lambda: step(model, cache, token, s - 1, gold))
    cache_bytes = sum(v.numel() * v.element_size() for v in cache.values())
    weight_bytes = sum(p.numel() * p.element_size()
                       for p in model.parameters())
    ms = float(np.median(times))
    res["decode_32k"] = {
        "batch": b, "seq": s, "pos": s - 1,
        "cut": f"global_batch {arch.shapes['decode_32k'].get('global_batch')}"
               f" -> {b}",
        "ms_per_token": ms, "tokens_per_s": b / ms * 1e3,
        "step_ms": times, "cache_bytes": cache_bytes,
        "bound_ms": bound(cache_bytes + weight_bytes)["bound_ms"],
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "metrics": vals, "profile": prof,
        "jax_batch_cache_bytes": cache_bytes // b
        * arch.shapes["decode_32k"].get("global_batch")}
    del cache, logits
    res["launches"] = read_launches()
    check(not any(res["launches"].values()),
          f"olmo-1b serving launched kernels {res['launches']}")
    res["consistency"] = _prefill_decode_consistency(model, cfg, rng, device)
    return res


def _prefill_decode_consistency(model, cfg, rng, device):
    """prefill(P tokens) then n decode_steps against logits_train at the
    same positions, in the model's bfloat16 and (for scale) in float32
    from the same weights: max |diff| over max |logit|."""
    import dataclasses

    import torch

    from repro_torch.models import transformer as TF

    p, n = CONSIST_PROMPT, CONSIST_STEPS
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, p + n))
                              .astype(np.int32)).to(device)

    def gap(m, c):
        with torch.inference_mode():
            want = TF.logits_train(m, tokens, c).float()
            last, cache = TF.prefill(m, tokens[:, :p], c, max_seq=p + n)
            got = [last]
            for pos in range(p, p + n - 1):
                logits, cache = TF.decode_step(m, cache, tokens[:, pos], pos,
                                               c)
                got.append(logits)
        got = torch.stack(got, dim=1).float()
        want = want[:, p - 1:p + n - 1]
        check(bool(torch.isfinite(got).all()), "consistency: non-finite")
        return float((got - want).abs().max() / want.abs().max())

    out = {"prompt": p, "decode_steps": n - 1, "bf16_rel_gap":
           gap(model, cfg), "bf16_limit": LM_BF16_TOL,
           "f32_limit": LM_F32_TOL}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    m32 = TF.Transformer(cfg32, device="meta").to_empty(device=device)
    m32.load_state_dict(model.state_dict())
    out["f32_rel_gap"] = gap(m32, cfg32)
    del m32
    check(out["f32_rel_gap"] <= LM_F32_TOL,
          f"olmo prefill + decode vs logits_train in float32: "
          f"{out['f32_rel_gap']} of the largest logit (limit {LM_F32_TOL})")
    check(out["bf16_rel_gap"] <= LM_BF16_TOL,
          f"olmo prefill + decode vs logits_train: {out['bf16_rel_gap']} "
          f"of the largest logit (limit {LM_BF16_TOL})")
    return out


def _qwen3_cut(seed, device):
    """L3: qwen3-moe-235b at full width, QWEN3_LAYERS of its 94 layers:
    prefill at QWEN3_PREFILL_SEQ and QWEN3_DECODE_STEPS decode steps;
    the share of routed (token, expert) choices that capacity dropped."""
    import dataclasses

    import torch

    from repro_torch.configs.common import smoke_shape
    from repro_torch.launch.api import get_arch
    from repro_torch.models import moe
    from repro_torch.models import transformer as TF

    arch = get_arch("qwen3-moe-235b-a22b")
    full = arch.make_config(False)
    cfg = dataclasses.replace(full, n_layers=QWEN3_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = TF.Transformer(cfg, device=device, generator=gen)
    res = {"layers": QWEN3_LAYERS, "of_layers": full.n_layers,
           "cut": f"n_layers {full.n_layers} -> {QWEN3_LAYERS}",
           **_lm_bytes(arch.name, cfg, device)}
    s, n = QWEN3_PREFILL_SEQ, QWEN3_DECODE_STEPS
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                           (1, s + n + 1))
                              .astype(np.int32)).to(device)
    prefill = arch.make_step(cfg, smoke_shape(arch.shapes["prefill_32k"],
                                              seq_len=s, global_batch=1),
                             device=device)
    zero_launches()
    prefill.step_fn(model, tokens[:, :s])  # warm-up
    with _RouteLog() as log:
        (last, cache), sec = _synced(
            lambda: prefill.step_fn(model, tokens[:, :s], max_seq=s + n))
    ms = sec * 1e3
    kept = [int((g > 0).sum()) for g, _ in log.calls]
    routed = s * cfg.moe.top_k
    res["prefill"] = {"seq": s, "ms": ms, "tokens_per_s": s / ms * 1e3,
                      "capacity": moe.capacity(s, cfg.moe),
                      "dropped_share_per_layer":
                          [1 - k / routed for k in kept]}
    step = arch.make_step(cfg, smoke_shape(arch.shapes["decode_32k"],
                                           seq_len=s + n, global_batch=1),
                          device=device)
    times = []
    for pos in range(s, s + n):
        (logits, cache, metrics), sec = _synced(
            lambda: step.step_fn(model, cache, tokens[:, pos], pos,
                                 tokens[:, pos + 1]))
        times.append(sec * 1e3)
        check(bool(torch.isfinite(logits).all()), "qwen3 decode non-finite")
    check(bool(torch.isfinite(last).all()), "qwen3 prefill non-finite")
    res["decode"] = {"batch": 1, "step_ms": times,
                     "capacity": moe.capacity(1, cfg.moe),
                     "metrics": {k: float(v) for k, v in metrics.items()}}
    res["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    res["launches"] = read_launches()
    check(not any(res["launches"].values()),
          f"qwen3 launched kernels {res['launches']}")
    del model, cache, last, logits
    return res


def phase_lm(device, seed):
    """The LM family on the card: L1 every smoke arch against the CPU,
    L2 olmo-1b at full width and depth (train, prefill, decode_32k, the
    prefill + decode consistency), L3 qwen3-moe at full width with its
    depth cut; the full configs that one card cannot hold as shape
    specs."""
    import torch

    from repro_torch.launch.api import get_arch

    result = {"phase": "L", "L1": {}}
    for name in LM_ARCHS:
        t0 = time.perf_counter()
        result["L1"][name] = _lm_against_cpu(name, seed, device)
        result["L1"][name]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    arch = get_arch("olmo-1b")
    cfg = arch.make_config(False)
    from repro_torch.models import transformer as TF

    gen = torch.Generator(device=device).manual_seed(seed)
    model = TF.Transformer(cfg, device=device, generator=gen)
    l2 = {**_lm_bytes("olmo-1b", cfg, device), "layers": cfg.n_layers,
          "d_model": cfg.d_model, "dtype": cfg.dtype}
    model, l2["train_4k"] = _olmo_train(model, cfg, arch, seed, device)
    model.zero_grad(set_to_none=True)
    l2.update(_olmo_serve(model, cfg, arch, seed, device))
    l2["seconds"] = time.perf_counter() - t0
    result["L2"] = l2
    del model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    result["L3"] = _qwen3_cut(seed, device)
    result["L3"]["seconds"] = time.perf_counter() - t0
    torch.cuda.empty_cache()

    specs = {"device_total_bytes":
             torch.cuda.get_device_properties(0).total_memory,
             "note": "largest depth: activations aside"}
    for name in LM_ARCHS[1:]:
        full = get_arch(name).make_config(False)
        specs[name] = {"layers": full.n_layers,
                       **_lm_bytes(name, full, device)}
    result["shape_specs"] = specs
    return result, None


#: phase S: the query axis split over the mesh ("cuda:0",) * n, the
#: collectives in a NCCL group of one and a gloo group of two ranks
SHARD_COUNTS = (1, 2, 3, 4)
SHARD_REPS = 3  # timed evaluate_buffer calls per mesh, after the first
GROUP_RANKS = 2
GROUP_TIMEOUT = 120  # seconds: the ranks and the developer command's smoke
PSUM_INT8_STEPS = 2  # int8 steps; the second carries the first's error


def _spawn(args, env):
    return subprocess.Popen([sys.executable, *args], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(procs, what, timeout=None):
    """Wait for every process (``timeout``, default GROUP_TIMEOUT, in
    all); kill them all and fail past it, or if one exits non-zero.
    Returns their stdout."""
    timeout = timeout or GROUP_TIMEOUT
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 0.1)))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        raise SmokeFailure(f"{what} did not finish in {timeout} s")
    failed = [f"process {i} exited {p.returncode}: {err[-1500:]}"
              for i, (p, (_, err)) in enumerate(zip(procs, outs))
              if p.returncode != 0]
    check(not failed, f"{what}: " + "\n".join(failed))
    return [o for o, _ in outs]


def _shard_meshes(device):
    import torch

    first = "cuda:0" if device == "cuda" else device
    meshes = {str(n): [first] * n for n in SHARD_COUNTS}
    if device == "cuda" and torch.cuda.device_count() > 1:
        meshes["every_card"] = [f"cuda:{i}"
                                for i in range(torch.cuda.device_count())]
    return meshes


def _sharded_meshes(ev, buf, device):
    """``ShardedEvaluator.evaluate_buffer`` on every mesh: launches per
    call, per-query tables against one shard's (bit for bit), aggregates
    against one shard's (TOL), host ms per call and device ms of the
    dispatch alone, and B1's ms on one shard's block."""
    import torch

    from repro_torch.distributed import ShardedEvaluator
    from repro_torch.kernels import fused_measures as FM

    out, base = {}, None
    for name, mesh in _shard_meshes(device).items():
        sev = ShardedEvaluator(ev, mesh=mesh)
        zero_launches()
        res = sev.evaluate_buffer(buf)
        launches = read_launches()
        check(launches["fused_measures"] == len(mesh),
              f"mesh {name}: B1 launched {launches['fused_measures']} "
              f"times in one call, want {len(mesh)}")
        check(launches["topk"] == 0 and launches["embedding_bag"] == 0,
              f"mesh {name}: the sharded path launched {launches}")
        if base is None:
            base = res
        check(res.per_query == base.per_query,
              f"mesh {name}: per-query rows differ from one shard's")
        worst = max(abs(res.aggregates[k] - v)
                    for k, v in base.aggregates.items())
        check(all(abs(res.aggregates[k] - v) <= TOL + TOL * abs(v)
                  for k, v in base.aggregates.items()),
              f"mesh {name}: aggregates beyond {TOL} of one shard's")
        times = []
        for _ in range(SHARD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sev.evaluate_buffer(buf)
            times.append(time.perf_counter() - t0)
        batch = sev._batch(buf)
        block = b1_inputs(ev, buf, len(mesh))
        out[name] = {"mesh": mesh, "launches": launches["fused_measures"],
                     "shard_shape": list(block[0].shape),
                     "evaluate_buffer_ms": float(np.median(times)) * 1e3,
                     "dispatch_ms": time_ms(lambda: sev._dispatch(batch),
                                            iters=5, warmup=1),
                     "b1_shard_ms": time_ms(
                         lambda: FM.fused_measures(*block,
                                                   ev.relevance_level)),
                     "aggregates_max_abs_diff": worst}
        del batch, block
    return out


def _nccl_world1(batch, sasrec, seed, device):
    """A NCCL group of one rank on the card (gloo off it): ``sharded_evaluate`` on phase
    B's batch against the streaming aggregates, ``compressed_psum`` by
    every method on a gradient dict of SASRec's full-width parameter
    shapes against ``compressed_psum_plain`` on the CPU (int8: payload,
    scale and error state bit for bit, over PSUM_INT8_STEPS steps)."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.core import streaming
    from repro_torch.distributed import collectives as TC
    from repro_torch.train import compression as C

    kw = {}
    if device == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60), **kw)
    try:
        out = {"backend": dist.get_backend()}
        got = TC.sharded_evaluate(batch, PAPER_MEASURES)
        state = streaming.metric_update(
            streaming.metric_init(PAPER_MEASURES, device=batch.rel.device),
            batch, PAPER_MEASURES)
        want = streaming.metric_finalize(state)
        diff = max(abs(float(got[k]) - float(v)) for k, v in want.items())
        check(all(abs(float(got[k]) - float(v)) <= TOL + TOL * abs(float(v))
                  for k, v in want.items()),
              f"sharded_evaluate beyond {TOL} of the streaming aggregates")
        out["sharded_evaluate_max_abs_diff"] = diff

        model = sasrec[0]
        gen = torch.Generator(device=device).manual_seed(seed)
        grads = {n: torch.randn(p.shape, generator=gen, device=device)
                 for n, p in model.named_parameters()}
        cpu_grads = {n: g.cpu() for n, g in grads.items()}
        out["grad_params"] = sum(g.numel() for g in grads.values())
        for method in ("none", "bf16"):
            mean, _ = TC.compressed_psum(grads, method)
            want, _ = TC.compressed_psum_plain([cpu_grads], method)
            check(all(torch.equal(mean[n].cpu(), want[n]) for n in want),
                  f"compressed_psum {method}: card differs from the CPU")
            out[f"{method}_ms"] = time_ms(
                lambda m=method: TC.compressed_psum(grads, m), iters=5,
                warmup=1)
        err, cpu_err = C.init_error_state(grads), None
        for step in range(PSUM_INT8_STEPS):
            q, s, _ = C.compress_grads_int8(grads, err)
            cq, cs, _ = C.compress_grads_int8(
                cpu_grads, cpu_err or C.init_error_state(cpu_grads))
            check(all(torch.equal(q[n].cpu(), cq[n])
                      and torch.equal(s[n].cpu(), cs[n]) for n in q),
                  f"int8 payload step {step}: card differs from the CPU")
            mean, err = TC.compressed_psum(grads, "int8", err)
            want, errs = TC.compressed_psum_plain(
                [cpu_grads], "int8", None if cpu_err is None else [cpu_err])
            cpu_err = errs[0]
            check(all(torch.equal(mean[n].cpu(), want[n])
                      and torch.equal(err[n].cpu(), cpu_err[n])
                      for n in want),
                  f"int8 step {step}: mean or error state differs from "
                  "the CPU's")
        out["int8_ms"] = time_ms(
            lambda: TC.compressed_psum(grads, "int8", err), iters=5,
            warmup=1)
        out["int8_bit_for_bit_steps"] = PSUM_INT8_STEPS
        out["int8_edge_cases"] = int8_edge_cases(device)
        return out
    finally:
        dist.destroy_process_group()


#: quantize_int8 inputs whose rounding or scale could differ between the
#: card and the CPU: NaN, +-inf, all zeros, values near the float32 limit
INT8_EDGE_CASES = {
    "nan": [float("nan"), 1.0, -2.0, 0.5],
    "inf": [float("inf"), 1.0, -3.0],
    "minus_inf": [-float("inf"), 2.0, 0.25],
    "nan_and_inf": [float("nan"), float("inf"), -1.0],
    "zeros": [0.0] * 5,
    "near_max": [3e38, -3e38, 1.0, -1e38],
}


def int8_edge_cases(device):
    """``train.compression.quantize_int8`` on INT8_EDGE_CASES (with and
    without an error state) on the card against the CPU: q, scale and
    error as values (NaN equal to NaN) and as bits, with the bits where
    they differ."""
    import torch

    from repro_torch.train import compression as C

    out = {}
    for name, values in INT8_EDGE_CASES.items():
        x = torch.tensor(values, dtype=torch.float32)
        err = torch.linspace(-0.1, 0.1, len(values))
        for label, e in (("no_error", None), ("error", err)):
            cpu = C.quantize_int8(x, e)
            card = [t.cpu() for t in C.quantize_int8(
                x.to(device), None if e is None else e.to(device))]
            same = [torch.equal(a, b) or (a.is_floating_point() and bool(
                ((a == b) | (torch.isnan(a) & torch.isnan(b))).all()))
                for a, b in zip(card, cpu)]
            bits = [a.numpy().tobytes() == b.numpy().tobytes()
                    for a, b in zip(card, cpu)]
            key = f"{name}/{label}"
            out[key] = {"identical": all(same), "same_bits": all(bits)}
            if not all(bits):
                out[key].update({
                    "card_bits": [a.view(torch.int32).tolist() if
                                  a.is_floating_point() else a.tolist()
                                  for a in card],
                    "cpu_bits": [a.view(torch.int32).tolist() if
                                 a.is_floating_point() else a.tolist()
                                 for a in cpu]})
    out["all_identical"] = all(v["identical"] for v in out.values())
    out["all_same_bits"] = all(v["same_bits"] for v in out.values()
                               if isinstance(v, dict))
    check(out["all_identical"], "quantize_int8 on NaN / inf / zeros / "
          "near-max inputs: the card's values differ from the CPU's")
    return out


def _gloo_ranks(outdir, seed, device):
    """Two ranks' results (``collectives`` self-check on ``cuda:0``)
    against one process on the CPU: compressed_psum_plain over both
    ranks' inputs (int8 bit for bit, none and bf16 within 1e-6) and the
    streaming aggregates of the whole batch (TOL)."""
    import torch

    from repro_torch.core import measures as M
    from repro_torch.core import streaming
    from repro_torch.distributed import collectives as TC
    from repro_torch.train import compression as C

    ranks = [dict(np.load(os.path.join(outdir, f"rank{r}.npz")))
             for r in range(GROUP_RANKS)]
    data = TC.demo_inputs(seed, GROUP_RANKS)
    tree = lambda t: C.tree_map(lambda a: torch.from_numpy(np.array(a)), t)
    grads = [tree(g) for g in data["grads"]]
    errors = [tree(e) for e in data["errors"]]
    worst = 0.0
    for method in TC.METHODS:
        mean, errs = TC.compressed_psum_plain(
            grads, method, errors if method == "int8" else None)
        want = TC.flatten(mean, "")
        for r, out in enumerate(ranks):
            for k, v in want.items():
                got = out[f"{method}/mean/{k}"]
                if method == "int8":
                    check(got.tobytes() == v.tobytes(),
                          f"gloo rank {r} int8 {k}: not the CPU's bits")
                else:
                    d = float(np.abs(got - v).max())
                    worst = max(worst, d)
                    check(d <= 1e-6, f"gloo rank {r} {method} {k}: {d}")
            if method == "int8":
                for k, v in TC.flatten(errs[r], "").items():
                    check(out[f"int8/error/{k}"].tobytes() == v.tobytes(),
                          f"gloo rank {r} error {k}: not the CPU's bits")
    batch = M.batch_from_dense(torch.from_numpy(data["scores"]),
                               torch.from_numpy(data["rel"]))
    want = streaming.metric_finalize(streaming.metric_update(
        streaming.metric_init(TC.DEMO_MEASURES, device="cpu"), batch,
        TC.DEMO_MEASURES))
    diff = 0.0
    for r, out in enumerate(ranks):
        for k, v in want.items():
            d = abs(float(out[f"eval/{k}"]) - float(v))
            diff = max(diff, d)
            check(d <= TOL + TOL * abs(float(v)),
                  f"gloo rank {r} sharded_evaluate {k}: {d}")
    return {"ranks": GROUP_RANKS, "device": device, "backend": "gloo",
            "psum_max_abs_diff": worst, "eval_max_abs_diff": diff,
            "int8": "bit for bit"}


def phase_sharded(device, paper, recsys, seed):
    """The sharded evaluator on the mesh ("cuda:0",) * n (and every card
    when there are several), the collectives in a NCCL group of one, then
    a gloo group of two ranks on cuda:0 beside ``python -m repro_torch.dev
    sharded-smoke`` (the children start after the timed work, so nothing
    else runs on the card while it is timed)."""
    import shutil
    import tempfile

    ev, buf = paper
    result = {"phase": "S", "meshes": _sharded_meshes(ev, buf, device)}
    batch = ev.batch_from_buffer(buf)
    result["nccl_world1"] = _nccl_world1(batch, recsys["sasrec"], seed,
                                         device)
    del batch
    rank_device = "cuda:0" if device == "cuda" else device
    tmp = tempfile.mkdtemp(prefix="phase_s_")
    env = _src_env()
    t0 = time.perf_counter()
    procs = [_spawn(["-m", "repro_torch.distributed.collectives",
                     "--device", rank_device, "--backend", "gloo",
                     "--seed", str(seed), "--store",
                     os.path.join(tmp, "store"), "--rank", str(r),
                     "--world-size", str(GROUP_RANKS),
                     "--out", os.path.join(tmp, "out")], env)
             for r in range(GROUP_RANKS)]
    procs.append(_spawn(["-m", "repro_torch.dev", "sharded-smoke",
                         "--device", device], env))
    try:
        outs = _finish(procs, "phase S's children")
        result["children_s"] = time.perf_counter() - t0
        result["gloo_2_ranks"] = _gloo_ranks(os.path.join(tmp, "out"), seed,
                                             rank_device)
        check("bit-identical" in outs[-1],
              f"dev sharded-smoke printed {outs[-1]!r}")
        result["dev_sharded_smoke"] = outs[-1].strip().splitlines()[-1]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    return result, result["meshes"]


#: phase P: model-parallel serving over a DeviceMesh
P_PREFILL = 4096  # P1's prompt (olmo-1b and qwen3-moe), batch 1
P_DECODE_STEPS = 4
P_RANKS = 2  # P2: gloo ranks sharing cuda:0, mesh (1, 2)
P2_SIZE = "card"  # sharded_serve's sizes: full widths
P_TIMEOUT = 300  # seconds: P2's ranks, and P3's dry run
P_DRYRUN_CELLS = ("olmo-1b:prefill_32k", "olmo-1b:decode_32k",
                  "qwen3-moe-235b-a22b:decode_32k", "arctic-480b:decode_32k",
                  "sasrec:retrieval_cand")
#: P1's MoE gap (max |diff| over the largest logit) at a decode step
#: whose routes differ from the unsharded step's: five times phase L's
#: bfloat16 limit.  The comparison runs with deterministic algorithms
#: (without, the combine's bfloat16 index_add adds in no fixed order and
#: the unsharded step alone differed from itself by up to 0.056 on an
#: H100).  There the prefill is bit for bit, decode steps with equal
#: routes reached 0.0071 and those with a rerouted token 0.052; of the
#: planted faults (P_MOE_FAULTS) the expert offset moved each decode step
#: 0.49-0.57, one expert dropped 0.045-0.073 (the prefill, 0.042,
#: catches it)
P_MOE_TOL = 5 * LM_BF16_TOL


def _fault_offset(gate, idx):
    """Expert e's tokens to expert e + 1's weights: an expert offset
    wrong by one."""
    return gate.roll(1, 0), idx.roll(1, 0)


def _fault_drop(gate, idx):
    """Expert 0's output dropped."""
    gate = gate.clone()
    gate[0] = 0.0
    return gate, idx


P_MOE_FAULTS = {"offset": _fault_offset, "drop": _fault_drop}


@contextlib.contextmanager
def _deterministic(on=True):
    """``torch.use_deterministic_algorithms`` (warnings only, where an op
    has no deterministic form) while the block runs, when ``on``."""
    import torch

    if not on:
        yield
        return
    was = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was, warn_only=warn)
#: P2's retrieval against the unsharded step: each candidate block's
#: scores come from a product of another width, so a value may move by a
#: rounding; indices may then swap only between values this close
P_RETRIEVAL_TOL = 1e-5


def _mesh_of_one(device):
    """A NCCL group of one rank (gloo off the card) and its (1, 1) mesh."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_host_mesh

    kw = {}
    if device == "cuda":
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        kw["device_id"] = torch.device("cuda", 0)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            store=dist.HashStore(), rank=0, world_size=1,
                            timeout=timedelta(seconds=60), **kw)
    return make_host_mesh(1, device="cuda:0" if device == "cuda"
                          else device)


def _full(t):
    from repro_torch.distributed.sharding import full_tensor

    return full_tensor(t)


def _rel_gap(got, want):
    """max |got - want| over max |want| (phase L's bfloat16 measure)."""
    import torch

    got, want = _full(got).float(), _full(want).float()
    check(bool(torch.isfinite(got).all()), "non-finite logits")
    return float((got - want).abs().max() / want.abs().max())


def _p1_lm(name, layers, mesh, seed, device):
    """``prefill`` of P_PREFILL tokens and P_DECODE_STEPS ``decode`` steps
    through ``make_step(..., mesh)`` against the same steps without a
    mesh, from the same seeded weights: logits within LM_BF16_TOL of the
    largest (phase L's gate), ms of each."""
    import dataclasses

    import torch

    from repro_torch.configs.common import smoke_shape
    from repro_torch.launch.api import get_arch
    from repro_torch.models import transformer as TF

    arch = get_arch(name)
    full = arch.make_config(False)
    cfg = dataclasses.replace(full, n_layers=layers or full.n_layers)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=device).manual_seed(seed)
    model = TF.Transformer(cfg, device=device, generator=gen)
    s, n = P_PREFILL, P_DECODE_STEPS
    rng = np.random.default_rng(seed + 7)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, s + n + 1))
                              .astype(np.int32)).to(device)
    pre = smoke_shape(arch.shapes["prefill_32k"], seq_len=s, global_batch=1)
    dec = smoke_shape(arch.shapes["decode_32k"], seq_len=s + n,
                      global_batch=1)
    runs = {}
    modes = [("mesh", mesh, None), ("plain", None, None)]
    if cfg.moe is not None:
        # the unsharded step again (bit for bit, deterministic), and the
        # unsharded step with a planted routing fault each
        modes += [("plain_again", None, None)] + [
            (f"fault_{k}", None, f) for k, f in P_MOE_FAULTS.items()]
    with _deterministic(cfg.moe is not None):
        for label, m, alter in modes:
            bp = arch.make_step(cfg, pre, device, m)
            bd = arch.make_step(cfg, dec, device, m)
            bp.step_fn(model, tokens[:, :s])  # warm-up
            with _RouteLog(alter) as log:
                (last, cache), sec = _synced(
                    lambda: bp.step_fn(model, tokens[:, :s], max_seq=s + n))
                out = {"logits": [_full(last).float()],
                       "prefill_ms": sec * 1e3, "decode_ms": [],
                       "metrics": [], "routes": [log.take()]}
                for pos in range(s, s + n):
                    (logits, cache, metrics), sec = _synced(
                        lambda: bd.step_fn(model, cache, tokens[:, pos], pos,
                                           tokens[:, pos + 1]))
                    out["logits"].append(_full(logits).float())
                    out["decode_ms"].append(sec * 1e3)
                    out["metrics"].append({k: float(v)
                                           for k, v in metrics.items()})
                    out["routes"].append(log.take())
            runs[label] = out
            del cache

    def gaps_to_plain(label):
        return [_rel_gap(g, w) for g, w in zip(runs[label]["logits"],
                                               runs["plain"]["logits"])]

    gaps = gaps_to_plain("mesh")
    same = [a == b for a, b in zip(runs["mesh"]["routes"],
                                   runs["plain"]["routes"])]
    limit, spread, faults = LM_BF16_TOL, None, None
    if cfg.moe is None:
        check(max(gaps) <= limit,
              f"P1 {name}: the (1, 1) mesh's logits {max(gaps)} of the "
              f"largest from the unsharded step's (limit {limit})")
    else:
        # deterministic index_add: the unsharded step is its own double,
        # and the mesh's prefill (every collective of size 1, every
        # product of the unsharded shape) is the unsharded one bit for
        # bit, where each planted fault shows.  Decode sums the softmax
        # flash-decoding style: phase L's gate where the routes agree,
        # P_MOE_TOL where a rounding moved a token to another expert,
        # which the planted expert offset must exceed
        spread = gaps_to_plain("plain_again")
        faults = {k: gaps_to_plain(f"fault_{k}") for k in P_MOE_FAULTS}
        check(max(spread) == 0.0,
              f"P1 {name}: the deterministic unsharded step differs from "
              f"itself by {max(spread)} of the largest logit")
        check(gaps[0] == 0.0 and same[0],
              f"P1 {name}: the (1, 1) mesh's prefill is {gaps[0]} of the "
              f"largest logit from the unsharded one (routes equal: "
              f"{same[0]}); it must be bit for bit")
        for t, (gap, ok) in enumerate(zip(gaps[1:], same[1:])):
            lim = LM_BF16_TOL if ok else P_MOE_TOL
            check(gap <= lim, f"P1 {name}: decode step {t} is {gap} of the "
                  f"largest logit from the unsharded one (routes equal: "
                  f"{ok}; limit {lim})")
        for k, g in faults.items():
            check(g[0] > 0.0, f"P1 {name}: the prefill check misses the "
                  f"planted fault {k}")
        check(min(faults["offset"][1:]) > P_MOE_TOL,
              f"P1 {name}: a planted expert offset moves a decode step "
              f"only {min(faults['offset'][1:])} of the largest logit "
              f"(limit {P_MOE_TOL})")
        limit = {"prefill": 0.0, "decode_routes_equal": LM_BF16_TOL,
                 "decode_routes_differ": P_MOE_TOL}
    res = {"layers": cfg.n_layers, "of_layers": full.n_layers,
           "prompt": s, "decode_steps": n, "rel_gaps": gaps,
           "plain_run_to_run_gaps": spread, "limit": limit,
           "planted_fault_gaps": faults,
           "routes_equal": same,
           "metrics_equal": runs["mesh"]["metrics"]
           == runs["plain"]["metrics"]}
    for label, out in runs.items():
        res[label] = {"prefill_ms": out["prefill_ms"],
                      "decode_ms": out["decode_ms"]}
    del model
    torch.cuda.empty_cache()
    return res


def _p1_recsys(recsys, mesh, seed, device):
    """SASRec ``retrieval_cand`` and xDeepFM ``serve_bulk`` (phase E's
    models and inputs) on the (1, 1) mesh against the unsharded steps:
    top-k values and indices identical, scores within SCORE_TOL."""
    import torch

    from repro_torch.launch.api import get_arch

    out = {}
    launches = {}

    def on_mesh(step, *args):
        """The mesh step's call, its launches counted (not the
        unsharded step's, which it is held against)."""
        zero_launches()
        out = _synced(lambda: step(*args))
        for k, v in read_launches().items():
            launches[k] = launches.get(k, 0) + v
        return out

    model, cfg, _, dev_args = recsys["sasrec"]
    arch = get_arch("sasrec")
    shape = arch.shapes["retrieval_cand"]
    want = arch.make_step(cfg, shape, device).step_fn(model, *dev_args)
    got, sec = on_mesh(arch.make_step(cfg, shape, device, mesh).step_fn,
                       model, *dev_args)
    check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
          "P1 SASRec retrieval: top-k differs from the unsharded step's")
    check(all(float(got[2][k]) == float(want[2][k]) for k in want[2]),
          "P1 SASRec retrieval: metrics differ")
    out["sasrec_retrieval"] = {"identical": True, "ms": sec * 1e3}
    model, cfg, batch = recsys["xdeepfm"]
    arch = get_arch("xdeepfm")
    shape = arch.shapes["serve_bulk"]
    want = arch.make_step(cfg, shape, device).step_fn(model, batch)
    got, sec = on_mesh(arch.make_step(cfg, shape, device, mesh).step_fn,
                       model, batch)
    out["xdeepfm_serve_bulk"] = {
        "ms": sec * 1e3,
        "max_abs_err": _check_close(_full(got), want, "P1 xDeepFM serve")}
    out["launches"] = launches
    return out


def _topk_agree(got_v, got_i, want_v, want_i, tol, what):
    """Values within ``tol``; an index may differ only where its value is
    within ``tol`` of the next or previous one (a near tie reordered)."""
    check(np.allclose(got_v, want_v, atol=tol, rtol=tol, equal_nan=True),
          f"{what}: values beyond {tol}")
    moved = np.nonzero(got_i != want_i)[1] if got_i.ndim == 2 else \
        np.nonzero(got_i != want_i)[0]
    v = want_v.reshape(-1)
    near = [(j > 0 and abs(v[j] - v[j - 1]) <= tol)
            or (j + 1 < len(v) and abs(v[j + 1] - v[j]) <= tol)
            for j in moved]
    check(all(near), f"{what}: indices differ away from near ties")
    return {"max_abs_err": float(np.nan_to_num(np.abs(got_v - want_v)).max()),
            "indices_moved": int(len(moved))}


def _p2(seed, device, tmp):
    """Two gloo ranks on cuda:0, mesh (1, 2): ``python -m
    repro_torch.launch.sharded_serve --size card`` (olmo-1b at full width
    with 2 layers, SASRec's 10^6 candidates split in 2, xDeepFM's
    serve_bulk with the table row-sharded), each rank against the
    unsharded steps in its own process; each shard's B2 and B3 launches
    as the C entry points count them."""
    env = _src_env()
    rank_device = "cuda:0" if device == "cuda" else device
    cases = "lm:olmo-1b,retrieval:sasrec,serve:xdeepfm"
    t0 = time.perf_counter()
    procs = [_spawn(["-m", "repro_torch.launch.sharded_serve", "--size",
                     P2_SIZE, "--mesh", f"1x{P_RANKS}", "--device",
                     rank_device, "--backend", "gloo", "--cases", cases,
                     "--seed", str(seed), "--store",
                     os.path.join(tmp, "store"), "--rank", str(r),
                     "--world-size", str(P_RANKS), "--out",
                     os.path.join(tmp, "out")], env)
             for r in range(P_RANKS)]
    outs = _finish(procs, "P2's ranks", P_TIMEOUT)
    res = {"ranks": P_RANKS, "mesh": [1, P_RANKS], "backend": "gloo",
           "device": rank_device, "cases": cases.split(","),
           "children_s": time.perf_counter() - t0, "shards": []}
    for r, text in enumerate(outs):
        line = json.loads(text.strip().splitlines()[-1])
        res["shards"].append({"rank": r, "launches": line["launches"],
                              "case_seconds": line["case_seconds"]})
        for case in ("retrieval:sasrec", "serve:xdeepfm"):
            got = line["launches"][case]
            check(got["embedding_bag"] >= 1,
                  f"P2 rank {r} {case}: B3 not launched on its shard")
        # B2 on the rank's candidate block, then the merge
        got = line["launches"]["retrieval:sasrec"]
        check(got["topk_block"] >= 1 and got["topk_merge"] >= 1,
              f"P2 rank {r}: B2 not launched on its block and the merge: "
              f"{got}")
        data = dict(np.load(os.path.join(tmp, "out", f"rank{r}.npz")))
        key = "lm:olmo-1b"
        gaps = []
        for k in data:
            if k.startswith(f"{key}/got/") and "metrics" not in k:
                w = data[k.replace("/got/", "/want/")]
                gaps.append(float(np.abs(data[k] - w).max()
                                  / np.abs(w).max()))
        check(max(gaps) <= LM_BF16_TOL,
              f"P2 rank {r} olmo-1b: logits {max(gaps)} of the largest from "
              f"the unsharded step's (limit {LM_BF16_TOL})")
        cache = {c: data[f"{key}/{c}_max_abs_diff"]
                 / data[f"{key}/{c}_max_abs"] for c in ("cache_k", "cache_v")}
        check(max(cache.values()) <= LM_BF16_TOL,
              f"P2 rank {r} olmo-1b: cache {cache}")
        ret = _topk_agree(data["retrieval:sasrec/got/0"],
                          data["retrieval:sasrec/got/1"],
                          data["retrieval:sasrec/want/0"],
                          data["retrieval:sasrec/want/1"], P_RETRIEVAL_TOL,
                          f"P2 rank {r} SASRec retrieval")
        got, want = data["serve:xdeepfm/got"], data["serve:xdeepfm/want"]
        check(np.allclose(got, want, atol=SCORE_TOL, rtol=SCORE_TOL),
              f"P2 rank {r} xDeepFM serve_bulk beyond {SCORE_TOL}")
        res["shards"][-1].update({
            "olmo_rel_gaps_max": max(gaps), "olmo_cache_rel_gaps": cache,
            "sasrec_retrieval": ret,
            "xdeepfm_max_abs_err": float(np.abs(got - want).max())})
    return res


def _dryrun_cells(out, what, cells):
    """The dry run's records under ``out``: each ``ok``, with a
    collective, read by ``roofline.analyze``; two a cell (both meshes)."""
    from repro_torch.analysis import roofline

    res = {}
    for name in sorted(os.listdir(out)):
        with open(os.path.join(out, name)) as fh:
            rec = json.load(fh)
        check(rec["status"] == "ok", f"{what} {name}: {rec.get('error')}")
        a = roofline.analyze(rec)
        check(a is not None, f"{what} {name}: roofline.analyze read nothing")
        check(rec["collectives"]["total"] > 0,
              f"{what} {name}: no collective")
        res[name[:-5]] = {
            "n_chips": rec["n_chips"], "flops_per_device":
            rec["cost"]["flops"], "bytes_per_device":
            rec["cost"]["bytes accessed"], "collective_bytes_per_device":
            rec["collectives"]["total"], "peak_bytes_per_device":
            rec["memory"]["peak_bytes"], "opt_state_bytes_per_device":
            rec["memory"].get("opt_state_bytes", 0),
            "kernel_calls": rec["kernel_calls"], "dominant": a["dominant"],
            "compute_s": a["compute_s"], "memory_s": a["memory_s"],
            "collective_s": a["collective_s"], "step_s": rec["total_s"]}
    check(len(res) == 2 * len(cells), f"{what} wrote {len(res)} records")
    return res


def _p3(tmp):
    """The dry run in a child: P_DRYRUN_CELLS on the (16, 16) and
    (2, 16, 16) fake meshes; ``roofline.analyze`` reads every record."""
    out = os.path.join(tmp, "dryrun")
    args = ["-m", "repro_torch.launch.dryrun", "--out", out]
    for cell in P_DRYRUN_CELLS:
        args += ["--cell", cell]
    t0 = time.perf_counter()
    _finish([_spawn(args, _src_env())], "P3's dry run", P_TIMEOUT)
    return {"child_s": time.perf_counter() - t0,
            "cells": _dryrun_cells(out, "P3", P_DRYRUN_CELLS)}


def shard_rows(recsys, p2):
    """Kernel rows of phase P's shards on the card: B2 on one of two
    candidate blocks of phase E's ``[1, 10^6]`` SASRec scores, B2's merge
    of the two blocks' top 1,000, and B3 on one of two row shards of the
    xDeepFM table at the serve_bulk batch (the vocab-parallel lookup's
    partial sums), each against its plain version; launches as P2's rank
    0 counted them (B2's split into its block call's and its merge's)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.kernels import topk as TK
    from repro_torch.launch.steps import merge_topk

    launches = p2["shards"][0]["launches"]
    scores = recsys["retrieval_scores"]
    half = scores.shape[1] // P_RANKS
    blocks = [scores[:, r * half:(r + 1) * half].contiguous()
              for r in range(P_RANKS)]
    k = 1000
    rows = [topk_row(blocks[0], k,
                     launches["retrieval:sasrec"]["topk_block"], split=True)]
    rows[-1].update(shards=P_RANKS, on="a candidate block")
    tops = [TK.topk(b, k) for b in blocks]
    vals = torch.cat([v for v, _ in tops], 1).contiguous()
    idx = torch.cat([i + r * half for r, (_, i) in enumerate(tops)], 1)
    mv, mi = merge_topk(vals, idx, k)
    wv, wi = TK.topk(scores, k)
    check(torch.equal(mi, wi) and torch.equal(mv, wv),
          "B2's merge of the blocks differs from one B2 over the row")
    rows.append(topk_row(vals, k, launches["retrieval:sasrec"]["topk_merge"],
                         split=False))
    rows[-1].update(shards=P_RANKS, on="the merge of the blocks' top-k")

    model, cfg, batch = recsys["xdeepfm"]
    table = model.table.detach()
    v = table.shape[0]
    local = table[:-(-v // P_RANKS)]  # rank 0's rows
    ids, mask = batch["mh_ids"], batch["mh_mask"]
    b, f, m = ids.shape
    rows_g = (ids + (torch.arange(f, device=ids.device, dtype=ids.dtype)
                     * cfg.table.vocab_per_field)[None, :, None]).reshape(
                         b * f, m)
    hit = (rows_g < local.shape[0]) & mask.reshape(b * f, m)
    lids = torch.where(hit, rows_g, torch.zeros_like(rows_g)).contiguous()
    hit = hit.contiguous()
    got = EB.embedding_bag_fixed(local, lids, hit)
    plain = EB.embedding_bag_fixed_plain(local, lids, hit)
    torch.cuda.synchronize()
    check(bool((got == plain).all()),
          "B3 on a row shard differs from its plain version")
    e, l = local.shape[1], b * f * m
    held = int(hit.sum())
    unique = int(torch.unique(lids[hit]).numel())
    nbytes = unique * e * 4 + l * 5 + b * f * e * 4
    rows.append(dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:34",
        launches=launches["serve:xdeepfm"]["embedding_bag"],
        max_abs_err=float((got - plain).abs().max()),
        ms=time_ms(lambda: EB.embedding_bag_fixed(local, lids, hit)),
        plain_ms=time_ms(lambda: EB.embedding_bag_fixed_plain(local, lids,
                                                              hit)),
        shape=[int(local.shape[0]), e, l, b * f], held_lookups=held,
        unique_rows=unique, shards=P_RANKS, on="a row shard of the table",
        **bound(nbytes, 2 * l * e),
        library_ms=time_ms(lambda: F.embedding_bag(
            lids.long(), local, mode="sum",
            per_sample_weights=hit.to(torch.float32)))))
    return rows


def phase_parallel(device, recsys, seed):
    """P1 (a NCCL group of one, mesh (1, 1): olmo-1b at full width and
    depth, qwen3-moe at full width with QWEN3_LAYERS layers through the EP
    branch, SASRec retrieval, xDeepFM serve_bulk, each against the step
    without a mesh), P2 (two gloo ranks on cuda:0), P3 (the dry run)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    result = {"phase": "P"}
    t0 = time.perf_counter()
    mesh = _mesh_of_one(device)
    try:
        p1 = {"olmo-1b": _p1_lm("olmo-1b", None, mesh, seed, device),
              "qwen3-moe-235b-a22b": _p1_lm("qwen3-moe-235b-a22b",
                                            QWEN3_LAYERS, mesh, seed,
                                            device)}
        p1.update(_p1_recsys(recsys, mesh, seed, device))
    finally:
        dist.destroy_process_group()
    check(p1["launches"]["topk"] > 0 and p1["launches"]["embedding_bag"] > 0,
          f"P1's mesh steps did not launch B2 and B3: {p1['launches']}")
    p1["seconds"] = time.perf_counter() - t0
    result["P1"] = p1
    tmp = tempfile.mkdtemp(prefix="phase_p_")
    try:
        t0 = time.perf_counter()
        result["P2"] = _p2(seed, device, tmp)
        result["P2"]["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["P3"] = _p3(tmp)
        result["P3"]["seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return result, result["P2"]


# -- phase Q: model-parallel training -------------------------------------

Q_STEPS = 3  # train steps a model, mesh and unsharded each
Q_RANKS = 2  # Q2: gloo ranks sharing cuda:0, mesh (1, 2)
Q2_SIZE = "card"  # sharded_train's sizes: full widths
Q2_CASES = "recsys:xdeepfm,lm:olmo-1b,gnn:full_graph_sm"
Q_TIMEOUT = 300  # seconds: Q2's ranks, and Q3's dry run
#: Q1's qwen3-moe batch (sequences, tokens a sequence) and the share of
#: the card its reckoned training bytes may fill
QWEN3_TRAIN = (1, 2048)
QWEN3_TRAIN_SHARE = 0.7
#: float32 copies of a parameter the update holds at once (the clipped
#: gradient, m, g², v̂, the step, the parameter twice)
UPDATE_F32_COPIES = 7
Q_DRYRUN_CELLS = ("olmo-1b:train_4k", "qwen3-moe-235b-a22b:train_4k",
                  "xdeepfm:train_batch", "gatedgcn:ogb_products")


#: |‖got‖ / ‖want‖ - 1| of each leaf of m and v (the CPU tests' limit)
Q_NORM_TOL = 1e-3


def q_limits(bf16):
    """Phase Q's limits, group by group, each at its own scale (keys of
    ``sharded_train.differences``): each metric within GRAD_TOL of
    max(1, |value|); m and v, which carry the gradient (m is 0.1 g after
    one step, v 0.001 g²), leaf by leaf, v within twice m's limits (its
    relative error is twice g's): in the float32 families each leaf's
    norm within Q_NORM_TOL (their ReLUs take an entry far off where the
    reordered sums move an input at 0 across it, so no entry is held);
    in a bfloat16 LM (smooth: SwiGLU) each entry within LM_BF16_TOL ·
    (|m| + the leaf's max|m|) (phase T's gradient gate) and each norm
    within LM_BF16_TOL; the parameters within GRAD_TOL absolute (a
    bfloat16 LM's leaves within LM_BF16_TOL of their own largest).  The
    parameters cannot show a gradient's scale (AdamW's step is blind to
    it) nor, in an LM's warm-up, a bfloat16 gradient's size (the step is
    below an ulp); m, v and grad_norm do."""
    if bf16:
        state = {"entry_err": LM_BF16_TOL, "norm_gap": LM_BF16_TOL}
    else:
        state = {"norm_gap": Q_NORM_TOL}
    return {"metrics": {"leaf_rel_err": GRAD_TOL},
            "params": ({"leaf_rel_err": LM_BF16_TOL} if bf16 else
                       {"max_abs_err": GRAD_TOL}),
            "m": state, "v": {k: 2 * x for k, x in state.items()}}


def q_failures(errors, bf16):
    """The [group, statistic, reading, limit] of ``errors``
    (``sharded_train.differences``) beyond :func:`q_limits`."""
    return [[g, k, errors[g][k], lim]
            for g, stats in q_limits(bf16).items()
            for k, lim in stats.items() if not errors[g][k] <= lim]


def _q_run(bundle, model, batches, mesh_run, profile=True, to=None):
    """Q_STEPS steps from a fresh ``init_opt``: (every parameter, m, v
    and each step's metrics, copied as ``sharded_train.gathered`` gives
    them, ``to`` a device or on the card; per-step metrics; step ms;
    peak bytes; launches of the mesh run; profile of one more step of
    the mesh run)."""
    import torch

    from repro_torch.launch.sharded_train import gathered

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    state = bundle.init_opt(model)
    held, metrics, ms = [], [], []
    if mesh_run:
        zero_launches()
    for i in range(Q_STEPS):
        batch = batches(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, state, m = bundle.step_fn(model, state, batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        vals = {k: float(v) for k, v in m.items()}
        check(all(np.isfinite(v) for v in vals.values()),
              f"non-finite train metrics {vals}")
        held.append(m)
        metrics.append(vals)
    launches = read_launches() if mesh_run else None
    peak = torch.cuda.max_memory_allocated()
    out = {k: t.detach().to(to, copy=True)
           for k, t in gathered(model, state, held).items()}
    prof = None
    if mesh_run and profile:  # one more step, after the results were taken
        prof, model, state = profile_step(bundle, model, state, batches(0))
    del model, state, held
    torch.cuda.empty_cache()
    return out, metrics, ms, peak, launches, prof


def _q_case(what, arch, cfg, shape, make, batches, mesh, device,
            bf16=False, deterministic=False, control=False):
    """The step on the (1, 1) mesh against the same step without one,
    each from the seed's weights (``make()``) and a fresh state, held
    group by group to :func:`q_limits`; whether bit for bit; step ms,
    peak bytes, busy share.  With ``control`` one more mesh run whose
    smallest parameter's gradient is doubled must break a limit."""
    from repro_torch.launch.sharded_train import differences

    import torch

    with _deterministic(deterministic):
        # the mesh run's results wait on the host while the plain one runs
        got, gm, gms, gpeak, launches, prof = _q_run(
            arch.make_step(cfg, shape, device, mesh), make(), batches, True,
            to="cpu")
        want, wm, wms, wpeak, _, _ = _q_run(
            arch.make_step(cfg, shape, device), make(), batches, False)
    got = {k: t.to(device) for k, t in got.items()}

    check(got.keys() == want.keys(), f"Q1 {what}: results differ in keys")
    errors = differences(got, want)
    same = all(bool(torch.equal(got[k], want[k])) for k in want)
    del got
    fails = q_failures(errors, bf16)
    check(not fails, f"Q1 {what}: beyond the limits [group, statistic, "
          f"reading, limit]: {fails}; every reading: {errors}")
    out = {"steps": Q_STEPS, "mesh_metrics": gm, "plain_metrics": wm,
           "differences": errors, "limits": q_limits(bf16),
           "bit_for_bit": same, "mesh_step_ms": gms, "plain_step_ms": wms,
           "step_ms": float(np.median(gms[1:])),
           "mesh_peak_device_bytes": gpeak,
           "plain_peak_device_bytes": wpeak, "launches": launches,
           "device_busy_share": prof["device_busy_share"],
           "profile": prof}
    if control:
        model = make()
        leaf, p = min(model.named_parameters(), key=lambda kv: kv[1].numel())
        p.register_hook(lambda g: 2 * g)
        with _deterministic(deterministic):
            bad = _q_run(arch.make_step(cfg, shape, device, mesh), model,
                         batches, True, profile=False)[0]
        errors = differences(bad, want)
        caught = q_failures(errors, bf16)
        check(bool(caught), f"Q1 {what}: the control (the gradient of "
              f"{leaf} doubled) is within every limit")
        out["control"] = {"fault": f"gradient of {leaf} doubled",
                          "differences": errors, "caught_by": caught}
        del bad
    del want
    return out


def _qwen3_train_layers(cfg, device):
    """(layers, reckoning): the deepest qwen3-moe stack whose training
    bytes (``_lm_bytes``'s state: weights, gradients, bfloat16 m,
    factored v; plus UPDATE_F32_COPIES float32 copies of one layer's
    largest parameter, which the update holds at once) fill at most
    QWEN3_TRAIN_SHARE of the card."""
    import torch

    from repro_torch.models import transformer as TF

    r = _lm_bytes("qwen3-moe-235b-a22b", cfg, device)
    meta = TF.Transformer(cfg, device="meta")
    largest = max(p.numel() // cfg.n_layers * 4 for n, p in
                  meta.named_parameters() if n.startswith("layers."))
    head = max(p.numel() * 4 for n, p in meta.named_parameters()
               if not n.startswith("layers."))
    per_layer = r["train_state_bytes_per_layer"] + UPDATE_F32_COPIES * largest
    total = torch.cuda.get_device_properties(0).total_memory
    room = QWEN3_TRAIN_SHARE * total - r["train_state_bytes_outside_layers"] \
        - UPDATE_F32_COPIES * head
    layers = max(1, min(cfg.n_layers, int(room // per_layer)))
    return layers, {"train_state_bytes_per_layer":
                    r["train_state_bytes_per_layer"],
                    "train_state_bytes_outside_layers":
                    r["train_state_bytes_outside_layers"],
                    "update_f32_bytes_per_layer":
                    UPDATE_F32_COPIES * largest,
                    "update_f32_bytes_outside_layers":
                    UPDATE_F32_COPIES * head,
                    "card_bytes": total, "share": QWEN3_TRAIN_SHARE,
                    "layers": layers}


def _q1(mesh, seed, device):
    """Q1: xDeepFM at train_batch, olmo-1b at full depth, GatedGCN
    minibatch_lg and qwen3-moe at the reckoned depth, each Q_STEPS steps
    on the (1, 1) mesh against the same steps without a mesh."""
    import dataclasses

    import torch

    from repro_torch.configs.common import smoke_shape
    from repro_torch.configs.gatedgcn import shape_config
    from repro_torch.data import lm_data as LD
    from repro_torch.launch.api import get_arch, to_device
    from repro_torch.launch.steps import MODELS
    from repro_torch.models import transformer as TF
    from repro_torch.models.gnn import GatedGCN

    out = {}

    def seeded(cls, cfg):
        return lambda: cls(cfg, device=device, generator=torch.Generator(
            device=device).manual_seed(seed))

    arch = get_arch("xdeepfm")
    cfg = arch.make_config(False)
    shape = arch.shapes["train_batch"]
    reqs = [to_device(recsys_request("xdeepfm", cfg, shape, seed,
                                     5000 + i)[0], device)
            for i in range(Q_STEPS)]
    out["xdeepfm"] = _q_case("xdeepfm", arch, cfg, shape,
                             seeded(MODELS["xdeepfm"], cfg),
                             lambda i: reqs[i], mesh, device)
    out["xdeepfm"]["batch"] = shape.get("batch")
    got = out["xdeepfm"]["launches"]
    check(got["embedding_bag"] > 0 and got["embedding_bag_backward"] > 0,
          f"Q1 xDeepFM's mesh steps launched B3 {got['embedding_bag']} and "
          f"B3-bwd {got['embedding_bag_backward']} times")
    del reqs

    arch = get_arch("olmo-1b")
    cfg = arch.make_config(False)
    b, s = OLMO_TRAIN_BATCH, arch.shapes["train_4k"].get("seq_len")
    shape = smoke_shape(arch.shapes["train_4k"], global_batch=b)
    data = LD.MarkovLM(LD.LMDataConfig(cfg.vocab_size, s, b, seed=seed))
    batches = [to_device(data.batch(i), device) for i in range(Q_STEPS)]
    out["olmo-1b"] = _q_case("olmo-1b", arch, cfg, shape,
                             seeded(TF.Transformer, cfg),
                             lambda i: batches[i], mesh, device,
                             bf16=True, deterministic=True, control=True)
    out["olmo-1b"].update(batch=b, seq=s, layers=cfg.n_layers)
    del batches

    arch = get_arch("gatedgcn")
    shape = arch.shapes["minibatch_lg"]
    cfg = shape_config(arch.make_config(False), shape)
    batch = to_device(gnn_batch(shape, cfg, seed), device)
    out["gatedgcn_minibatch_lg"] = _q_case(
        "gatedgcn minibatch_lg", arch, arch.make_config(False), shape,
        seeded(GatedGCN, cfg), lambda i: batch, mesh, device,
        deterministic=True)
    del batch

    arch = get_arch("qwen3-moe-235b-a22b")
    full = arch.make_config(False)
    layers, reckoning = _qwen3_train_layers(full, device)
    emit({"phase": "Q1 reckoning", "qwen3-moe-235b-a22b": reckoning})
    cfg = dataclasses.replace(full, n_layers=layers)
    b, s = QWEN3_TRAIN
    shape = smoke_shape(arch.shapes["train_4k"], global_batch=b, seq_len=s)
    data = LD.MarkovLM(LD.LMDataConfig(cfg.vocab_size, s, b, seed=seed))
    batches = [to_device(data.batch(i), device) for i in range(Q_STEPS)]
    out["qwen3-moe-235b-a22b"] = _q_case(
        "qwen3-moe", arch, cfg, shape, seeded(TF.Transformer, cfg),
        lambda i: batches[i], mesh, device, bf16=True, deterministic=True)
    out["qwen3-moe-235b-a22b"].update(
        batch=b, seq=s, layers=layers, of_layers=full.n_layers,
        cut=f"n_layers {full.n_layers} -> {layers}, global_batch "
            f"{arch.shapes['train_4k'].get('global_batch')} -> {b}, "
            f"seq_len {arch.shapes['train_4k'].get('seq_len')} -> {s}",
        reckoning=reckoning)
    return out


def _q2(seed, device, tmp):
    """Q2: two gloo ranks on cuda:0, mesh (1, 2): ``python -m
    repro_torch.launch.sharded_train --size card`` (xDeepFM at 65,536
    rows with the table row-sharded in 2, olmo-1b at full width with 2
    layers and 2 x 1,024 tokens, GatedGCN full_graph_sm with its edges
    padded to the mesh), each rank's gathered result after 2 steps
    against the unsharded steps in its own process; each shard's B3 and
    B3-bwd launches as the C entry points count them."""
    env = _src_env()
    rank_device = "cuda:0" if device == "cuda" else device
    t0 = time.perf_counter()
    procs = [_spawn(["-m", "repro_torch.launch.sharded_train", "--size",
                     Q2_SIZE, "--mesh", f"1x{Q_RANKS}", "--device",
                     rank_device, "--backend", "gloo", "--cases", Q2_CASES,
                     "--seed", str(seed),
                     "--store", os.path.join(tmp, "store"), "--rank",
                     str(r), "--world-size", str(Q_RANKS)], env)
             for r in range(Q_RANKS)]
    outs = _finish(procs, "Q2's ranks", Q_TIMEOUT)
    res = {"ranks": Q_RANKS, "mesh": [1, Q_RANKS], "backend": "gloo",
           "device": rank_device, "children_s": time.perf_counter() - t0,
           "shards": []}
    cases = Q2_CASES.split(",")
    lines = [json.loads(text.strip().splitlines()[-1]) for text in outs]
    for r, line in enumerate(lines):
        check(set(line["errors"]) == set(cases),
              f"Q2 rank {r} ran {sorted(line['errors'])}")
    fails = {f"rank {r} {case}": [q_failures(e, case.startswith("lm:")), e]
             for r, line in enumerate(lines)
             for case, e in line["errors"].items()
             if q_failures(e, case.startswith("lm:"))}
    check(not fails, f"Q2 beyond the limits ([group, statistic, reading, "
          f"limit], then every reading): {fails}")
    for r, line in enumerate(lines):
        got = line["launches"]["recsys:xdeepfm"]
        check(got["embedding_bag"] >= 1 and got["embedding_bag_backward"] >= 1,
              f"Q2 rank {r} xDeepFM: B3 and B3-bwd not launched on its "
              f"shard: {got}")
        res["shards"].append({"rank": r, "launches": line["launches"],
                              "errors": line["errors"],
                              "limits": {c: q_limits(c.startswith("lm:"))
                                         for c in cases},
                              "case_seconds": line["case_seconds"]})
    return res


def _q3_start(tmp):
    """Q3: the dry run of Q_DRYRUN_CELLS on the (16, 16) and (2, 16, 16)
    fake meshes, one child a mesh, started now (they need no card, so
    they run beside Q2); :func:`_q3` reads them."""
    out = os.path.join(tmp, "dryrun_train")
    procs = []
    for mesh in ("single", "multi"):
        args = ["-m", "repro_torch.launch.dryrun", "--out", out, "--mesh",
                mesh]
        for cell in Q_DRYRUN_CELLS:
            args += ["--cell", cell]
        procs.append(_spawn(args, _src_env()))
    return procs, out, time.perf_counter()


def _q3(started):
    """Q3's records (:func:`_dryrun_cells`); xDeepFM's count B3 and
    B3-bwd."""
    procs, out, t0 = started
    _finish(procs, "Q3's dry run", Q_TIMEOUT)
    res = {"child_s": time.perf_counter() - t0,
           "cells": _dryrun_cells(out, "Q3", Q_DRYRUN_CELLS)}
    for name, cell in res["cells"].items():
        if name.startswith("xdeepfm"):
            check(cell["kernel_calls"].get("embedding_bag_fixed", 0) > 0
                  and cell["kernel_calls"].get(
                      "embedding_bag_fixed_backward", 0) > 0,
                  f"Q3 {name}: B3 and B3-bwd not counted: "
                  f"{cell['kernel_calls']}")
    return res


def phase_train_parallel(device, seed):
    """Q1 (a NCCL group of one, mesh (1, 1)), Q2 (two gloo ranks on
    cuda:0), Q3 (the dry run's train cells, two children beside Q2; Q3's
    seconds are Q2's and Q3's together)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    result = {"phase": "Q"}
    t0 = time.perf_counter()
    mesh = _mesh_of_one(device)
    try:
        result["Q1"] = _q1(mesh, seed, device)
    finally:
        dist.destroy_process_group()
    result["Q1"]["seconds"] = time.perf_counter() - t0
    # Q1's cached blocks go back to the card: Q2's two ranks need room
    result["device_free_bytes_before_Q2"] = device_free_bytes()
    tmp = tempfile.mkdtemp(prefix="phase_q_")
    q3 = None
    try:
        t0 = time.perf_counter()
        q3 = _q3_start(tmp)
        result["Q2"] = _q2(seed, device, tmp)
        result["Q2"]["seconds"] = time.perf_counter() - t0
        result["Q3"] = _q3(q3)
        result["Q3"]["seconds"] = time.perf_counter() - t0
    finally:
        for p in q3[0] if q3 else ():
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    return result, result["Q2"]


def train_shard_rows(args, xd, q2):
    """Kernel rows of phase Q's shards on the card, at phase T's
    train_batch bags (xDeepFM's 65,536 rows x 3 multi-hot fields x 8
    lookups): B3 and B3-bwd on one of two row shards of the table (rank
    0's rows, as Q2's rank 0 holds them; a lookup of the other half is
    masked), each against its plain version; then B3-bwd at Q2's other two
    launches of a step on that shard, from the batch's single-hot ids
    (``xd``: phase T's table rows, config and batch): the fields and the
    linear term.  Launches as Q2's rank 0 counted them in its xDeepFM
    steps."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import embedding_bag as EB
    from repro_torch.models import embedding as E

    grad, ids, mask, v, f, field_rows = args
    n, m = ids.shape
    e = grad.shape[1]
    half = -(-v // Q_RANKS)
    gen = torch.Generator(device=grad.device).manual_seed(1)
    table = torch.randn((half, e), generator=gen, device=grad.device)
    # rank 0's ids and mask, as the vocab-parallel lookup makes them
    shard = E.VocabParallel.__new__(E.VocabParallel)
    shard.local, shard.row0 = table, 0
    lids, hit, _ = shard.local_ids(EB._fixed_rows(ids, f, field_rows), mask)
    launches = q2["shards"][0]["launches"]["recsys:xdeepfm"]
    got = EB.embedding_bag_fixed(table, lids, hit)
    plain = EB.embedding_bag_fixed_plain(table, lids, hit)
    torch.cuda.synchronize()
    check(bool((got == plain).all()),
          "B3 on a train row shard differs from its plain version")
    held = int(hit.sum())
    unique = int(torch.unique(lids[hit]).numel())
    out = [dict(
        name="embedding_bag", route="cuda",
        source="src/repro_torch/csrc/embedding_bag.cu",
        replaces="src/repro/kernels/embedding_bag.py:34",
        launches=launches["embedding_bag"],
        max_abs_err=float((got - plain).abs().max()),
        ms=time_ms(lambda: EB.embedding_bag_fixed(table, lids, hit)),
        plain_ms=time_ms(lambda: EB.embedding_bag_fixed_plain(table, lids,
                                                              hit)),
        shape=[half, e, n * m, n], held_lookups=held, unique_rows=unique,
        shards=Q_RANKS, on="a row shard of the table, train_batch's bags",
        **bound(unique * e * 4 + n * m * 5 + n * e * 4, 2 * n * m * e),
        library_ms=time_ms(lambda: F.embedding_bag(
            lids.long(), table, mode="sum",
            per_sample_weights=hit.to(torch.float32))))]
    del got, plain, table
    out.append(b3_bwd_launch_row(
        (grad, lids, hit, half, 1, 0), launches["embedding_bag_backward"],
        tol=B3_BWD_TOL, held_lookups=held, shards=Q_RANKS,
        on="a row shard of the table, train_batch's bags"))
    # Q2's two other launches a step on the same shard: the fields (one
    # Zipf id a bag) and the linear term (a [V, 1] table, 39 lookups a bag)
    single = torch.from_numpy(xd[2]["ids"]).to(grad.device).long()
    vpf = xd[1].table.vocab_per_field
    rows = single + torch.arange(single.shape[1],
                                 device=grad.device)[None] * vpf
    for what, bag_rows, width in (
            ("the fields: one Zipf id a bag", rows.reshape(-1, 1), e),
            ("the linear term: a [V, 1] table, 39 lookups a bag", rows, 1)):
        shard.local = torch.empty((half, width), device=grad.device)
        lids, hit, _ = shard.local_ids(bag_rows, None)
        g = torch.randn((lids.shape[0], width), generator=gen,
                        device=grad.device)
        out.append(b3_bwd_launch_row(
            (g, lids, hit, half, 1, 0), launches["embedding_bag_backward"],
            held_lookups=int(hit.sum()), shards=Q_RANKS,
            on=f"a row shard of the table, {what}"))
        del g, lids, hit
    return out


def b3_bwd_launch_row(args, launches, tol=None, **extra):
    """B3-bwd at one of Q2's launches: checked (bit for bit the CPU plain
    version, two launches equal, within the summation-order limit of its
    atomic plain version on the card and, given ``tol``, within ``tol`` of
    it), then timed as :func:`b3_bwd_row`."""
    import torch

    from repro_torch.kernels import embedding_bag as EB

    first = EB.embedding_bag_fixed_backward(*args)
    second = EB.embedding_bag_fixed_backward(*args)
    plain = EB.embedding_bag_fixed_backward_plain(*args)
    torch.cuda.synchronize()
    check(torch.equal(first, second), "B3-bwd differs between two launches")
    err = float((first - plain).abs().max())
    check(tol is None or err <= tol,
          f"B3-bwd {err} from its plain version ({extra})")
    order = b3_bwd_order_check(args, first, plain)
    del second, plain
    cpu = EB.embedding_bag_fixed_backward_plain(
        *(None if x is None else x.cpu() for x in args[:3]), *args[3:])
    check(torch.equal(first.cpu(), cpu),
          f"B3-bwd differs from the plain version on the CPU ({extra})")
    del first, cpu
    return b3_bwd_row(args, launches, err, order_limit_share=order,
                      bit_identical_to_cpu_plain=True, deterministic=True,
                      **extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    from repro_torch.kernels import _build

    # the JAX reference is float32: no TF32 in float32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "allow_tf32": {"matmul": torch.backends.cuda.matmul.allow_tf32,
                         "cudnn": torch.backends.cudnn.allow_tf32},
          "float32_matmul_precision": torch.get_float32_matmul_precision()})

    t0 = time.perf_counter()
    _build.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    def timed(fn, *a):
        t = time.perf_counter()
        out, ctx = fn(*a)
        out["seconds"] = time.perf_counter() - t
        emit(out)
        return out, ctx

    emit(phase_cli("cuda"))
    rng = np.random.default_rng(args.seed)
    out_b, paper = timed(phase_paper, "cuda", rng)
    out_c, deep = timed(phase_deep, "cuda", rng)
    out_e, recsys = timed(phase_recsys, "cuda", args.seed)
    out_f, sweep = timed(phase_sweep, "cuda", rng, args.seed)
    timed(phase_ranked, paper)
    timed(phase_rl, "cuda", args.seed)
    timed(phase_nan, "cuda", deep, recsys, args.seed)
    timed(phase_baselines, "cuda")
    timed(phase_arch, "cuda", paper, deep)
    timed(phase_service, "cuda", sweep["data"], args.seed)
    timed(phase_cluster, "cuda", sweep["data"], args.seed)
    out_t, train = timed(phase_train, "cuda", args.seed)
    timed(phase_lm, "cuda", args.seed)
    _, meshes = timed(phase_sharded, "cuda", paper, recsys, args.seed)
    _, p2 = timed(phase_parallel, "cuda", recsys, args.seed)
    _, q2 = timed(phase_train_parallel, "cuda", args.seed)
    launches = {"fused_measures": out_b["launches"]["fused_measures"],
                "fused_measures_sweep": out_f["launches"]["fused_measures"],
                "fused_measures_deep":
                    out_c["fused_launches"]["fused_measures"],
                "topk": out_c["launches"]["topk"],
                "topk_retrieval": out_e["launches"]["topk"],
                "embedding_bag": out_e["launches"]["embedding_bag"],
                "fused_measures_sharded": meshes[str(SHARD_COUNTS[-1])][
                    "launches"]}
    t0 = time.perf_counter()
    rows = phase_kernels(paper, deep, recsys, sweep, launches)
    rows.append(b3_bwd_row(  # phase T's train_batch (its checks ran there)
        train["b3_backward"],
        train["xdeepfm_launches"]["embedding_bag_backward"],
        out_t["b3_backward"]["max_abs_err"]))
    rows.extend(shard_rows(recsys, p2))
    rows.extend(train_shard_rows(train["b3_backward"], train["xdeepfm"],
                                 q2))
    emit({"phase": "D", "seconds": time.perf_counter() - t0})
    emit({"kernels": rows})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
