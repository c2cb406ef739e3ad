#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds both CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per
source, in parallel), then drives the port's main path through the entry
points a user calls:

* A. ``python -m repro_torch`` (in-process, ``--device cuda``) on the
  conformance fixtures, plain and ``--sharded``: both must byte-match
  ``tests/fixtures/conformance.golden``.
* B. The paper's largest grid corner (10,000 queries x 1,000 docs, 128
  judged per query, the paper's measure set), built from the seed and fed
  through ``buffer_from_arrays``: ``RelevanceEvaluator.evaluate_buffer``
  (full sort + measure core) against ``ShardedEvaluator.evaluate_buffer``
  (fused kernel).  Count columns bit-identical, the rest within
  atol = rtol = 2e-4.
* C. Deep candidates (1,024 queries x 65,536 docs, integer tokens through
  ``buffer_from_tokens``) with depth-bounded measures, so the evaluator
  routes through the top-k kernel; held against the full-sort route on the
  same buffer.
* D. Each kernel against its plain PyTorch version on the main path's
  inputs, with median times, the plain version's time, ``torch.topk``'s
  time for the top-k kernel (timed only; the port never calls it), the
  byte bound and the launch counts from B and C.

Every phase prints one JSON line; any failure raises and exits non-zero.
The last lines are the card's ``nvidia-smi`` name and power limit and
``{"ok": true, "device": {...}}``.  Without CUDA, or without the
repository's ``src/`` beside it, the script exits 1 and prints no result.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(ROOT, "tests", "fixtures")

#: published H100 SXM figures (NVIDIA data sheet) used for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12

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


def _stacked(cols):
    import torch

    return torch.stack(list(cols.values()))


# -- phases -------------------------------------------------------------------


def phase_cli(device):
    from repro_torch import cli

    qrel = os.path.join(FIXTURES, "conformance.qrel")
    run = os.path.join(FIXTURES, "conformance.run")
    with open(os.path.join(FIXTURES, "conformance.golden"),
              newline="") as fh:
        golden = fh.read()
    modes = {}
    for extra in ([], ["--sharded"]):
        buf = io.StringIO()
        rc = cli.main([*extra, "--device", device, qrel, run], out=buf)
        check(rc == 0, f"cli {extra} exited {rc}")
        check(buf.getvalue() == golden,
              f"cli {extra} output differs from conformance.golden")
        modes["sharded" if extra else "plain"] = "byte-match"
    return {"phase": "A", "cli": modes, "golden_lines": golden.count("\n")}


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
    from repro_torch.kernels import fused_measures as FM
    from repro_torch.kernels import topk as TK

    t0 = time.perf_counter()
    qrel, qids, docnos, scores = paper_data(rng, nq, nd, nj)
    t1 = time.perf_counter()
    ev = RelevanceEvaluator(qrel, PAPER_MEASURES, device=device)
    t2 = time.perf_counter()
    buf = ev.buffer_from_arrays(qids, docnos, scores)
    sev = ShardedEvaluator(ev)
    setup = {"data_s": t1 - t0, "evaluator_s": t2 - t1,
             "buffer_from_arrays_s": time.perf_counter() - t2}

    FM.LAUNCHES = TK.LAUNCHES = 0
    t0 = time.perf_counter()
    core = ev.evaluate_buffer(buf)
    t1 = time.perf_counter()
    fused = sev.evaluate_buffer(buf).per_query
    t2 = time.perf_counter()
    launches = {"fused_measures": FM.LAUNCHES, "topk": TK.LAUNCHES}
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
    from repro_torch.kernels import fused_measures as FM
    from repro_torch.kernels import topk as TK

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

    FM.LAUNCHES = TK.LAUNCHES = 0
    t0 = time.perf_counter()
    routed = ev.evaluate_buffer(buf)
    t1 = time.perf_counter()
    launches = {"fused_measures": FM.LAUNCHES, "topk": TK.LAUNCHES}
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
    split = {"topk": split_times(
        ev, buf, lambda b: _stacked(compute_measures_topk(
            b, ev.measures, ev.relevance_level)), topk_layout=True)}
    return {"phase": "C", "queries": nq, "docs": nd, "judged": nj,
            "topk_depth": ev._topk_depth, "setup": setup,
            "topk_eval_s": t1 - t0, "split": split, "compared": n,
            "max_abs_diff": worst, "launches": launches}, (ev, buf)


def phase_kernels(paper, deep, launches):
    """Each kernel against its plain version on the main path's inputs."""
    import torch

    from repro_torch.core import measures as M
    from repro_torch.kernels import fused_measures as FM
    from repro_torch.kernels import ops
    from repro_torch.kernels import topk as TK

    rows = []
    # B1: the fused-measure pass at phase B's padded batch
    ev, buf = paper
    batch = ev.batch_from_buffer(buf)
    s = M.sort_batch(batch, ev.relevance_level)
    scal = ops.make_scalars(batch.n_rel, batch.n_judged_nonrel,
                            batch.ideal_rel)
    rel, judged = s.rel.contiguous(), s.judged.contiguous()
    q, d = rel.shape
    got = FM.fused_measures(rel, judged, scal, ev.relevance_level)
    want = FM.fused_measures_plain(rel, judged, scal, ev.relevance_level)
    torch.cuda.synchronize()
    ncol = len(FM.COLUMNS)
    for c, name in enumerate(FM.COLUMNS):
        a, b = got[:, c], want[:, c]
        if is_exact(name):
            check(torch.equal(a, b), f"fused kernel column {name} not exact")
        else:
            check(torch.allclose(a, b, atol=TOL, rtol=TOL),
                  f"fused kernel column {name} beyond {TOL}")
    err = float((got[:, :ncol] - want[:, :ncol]).abs().max())
    check(bool(torch.all(got[:, ncol:] == 0)), "fused padding not zero")
    nbytes = (2 * q * d + q * FM.SCALAR_WIDTH + q * FM.OUT_WIDTH) * 4
    flops = FUSED_FLOPS_PER_RANK * q * d
    ms = time_ms(lambda: FM.fused_measures(rel, judged, scal))
    plain_ms = time_ms(lambda: FM.fused_measures_plain(rel, judged, scal))
    rows.append(dict(
        name="fused_measures", route="cuda",
        source="src/repro_torch/csrc/fused_measures.cu",
        replaces="src/repro/kernels/fused_measures.py:81",
        launches=launches["fused_measures"], max_abs_err=err, ms=ms,
        plain_ms=plain_ms, shape=[q, d],
        bound_ms=max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)
        * 1e3,
        bound_by="bytes" if nbytes / HBM_BYTES_PER_S
        >= flops / FP32_FLOPS_PER_S else "operations",
        library_ms=None))
    del batch, s, scal, rel, judged, got, want

    # B2: top-k at phase C's masked score matrix
    ev, buf = deep
    batch = ev.batch_from_buffer(buf, topk_layout=True)
    k = min(ev._topk_depth, batch.scores.shape[1])
    scores_m = torch.where(batch.mask, batch.scores, -torch.inf)
    del batch
    q, d = scores_m.shape
    v, i = TK.topk(scores_m, k)
    pv, pi = TK.topk_plain(scores_m, k)
    torch.cuda.synchronize()
    check(torch.equal(i, pi), "top-k kernel indices differ from plain")
    check(torch.equal(v, pv), "top-k kernel values differ from plain")
    finite = torch.isfinite(pv)
    err = float((v[finite] - pv[finite]).abs().max()) if finite.any() else 0.0
    nbytes = q * d * 4 + q * k * 8
    ms = time_ms(lambda: TK.topk(scores_m, k), iters=10)
    plain_ms = time_ms(lambda: TK.topk_plain(scores_m, k), iters=10)
    library_ms = time_ms(lambda: torch.topk(scores_m, k), iters=10)
    rows.append(dict(
        name="topk", route="cuda", source="src/repro_torch/csrc/topk.cu",
        replaces="src/repro/kernels/topk.py:36", launches=launches["topk"],
        max_abs_err=err, ms=ms, plain_ms=plain_ms, shape=[q, d, k],
        bound_ms=max(nbytes / HBM_BYTES_PER_S, q * d / FP32_FLOPS_PER_S)
        * 1e3,
        bound_by="bytes", library_ms=library_ms))
    return rows


# -- entry point --------------------------------------------------------------


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

    card = card_line()
    emit({"phase": "card", "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build()
    ptxas = {n: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for n, log in _build.build_log.items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": ptxas})

    emit(phase_cli("cuda"))
    rng = np.random.default_rng(args.seed)
    out_b, paper = phase_paper("cuda", rng)
    emit(out_b)
    out_c, deep = phase_deep("cuda", rng)
    emit(out_c)
    launches = {"fused_measures": out_b["launches"]["fused_measures"],
                "topk": out_c["launches"]["topk"]}
    emit({"kernels": phase_kernels(paper, deep, launches)})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
