"""The port's evaluator surfaces against the JAX package's, on the CPU.

One seeded qrel/run pair with the densifier's stress features (score ties,
out-of-vocabulary and non-ASCII docnos, an empty-qrel query, uneven depths)
goes through ``repro.core.RelevanceEvaluator`` and its port: evaluate,
the session API (tokenized buffers, coalesced buffers), the reference
densifier, and the fused-kernel ``ShardedEvaluator``.  Count columns
bit-identical, the rest within atol = rtol = 2e-4; host-side buffers and
batches identical field by field.
"""

import random

import numpy as np
import pytest
import torch

from repro.core import RelevanceEvaluator as JaxEvaluator
from repro.core import aggregate_results as jax_aggregate
from repro.core import streaming as JSTREAM
from repro.distributed.sharded_evaluator import \
    ShardedEvaluator as JaxSharded

from repro_torch.core import (RelevanceEvaluator, RunBuffer,
                              aggregate_results, streaming)
from repro_torch.distributed import ShardedEvaluator, ShardedResult

from test_densify import _random_case
from test_torch_measures import single_torch_thread  # noqa: F401
from test_torch_measures import assert_results_match

MEASURES = ("map", "ndcg", "ndcg_cut", "P", "recall", "recip_rank", "Rprec",
            "bpref", "success", "map_cut", "num_ret", "num_rel",
            "num_rel_ret", "judged", "rbp", "iprec_at_recall", "gm_map",
            "err")


@pytest.fixture(scope="module")
def case():
    rng = random.Random(2024)
    run, qrel = _random_case(rng)
    more_run, more_qrel = _random_case(rng, with_empty_qrel=False)
    run.update({f"m{q}": docs for q, docs in more_run.items()})
    qrel.update({f"m{q}": docs for q, docs in more_qrel.items()})
    return run, qrel


@pytest.fixture(scope="module")
def evaluators(case):
    _, qrel = case
    return (RelevanceEvaluator(qrel, MEASURES, device="cpu"),
            JaxEvaluator(qrel, MEASURES))


@pytest.fixture(scope="module")
def jax_result(case, evaluators):
    return evaluators[1].evaluate(case[0])


def test_evaluate_matches_jax(case, evaluators, jax_result):
    got = evaluators[0].evaluate(case[0])
    assert_results_match(got, jax_result)
    assert all(type(v) is float for r in got.values() for v in r.values())


def test_session_api_matches_evaluate(case, evaluators, jax_result):
    ev = evaluators[0]
    run = case[0]
    buf = ev.tokenize_run(run)
    assert isinstance(buf, RunBuffer)
    assert_results_match(ev.evaluate_buffer(buf), jax_result)
    assert ev.evaluate_many([run, run]) == [ev.evaluate(run)] * 2
    # fresh scores through the buffer equal evaluating the rescored run
    scores = np.random.default_rng(3).random(len(buf.scores))
    rescored, it = {}, iter(scores.astype(np.float32).tolist())
    for qid in buf.qids:
        rescored[qid] = {d: next(it) for d in run[qid]}
    assert ev.evaluate_buffer(buf, scores=scores) == ev.evaluate(rescored)


def test_buffers_match_jax_field_by_field(case, evaluators):
    ev, jev = evaluators
    run = case[0]
    pairs = [(ev.tokenize_run(run), jev.tokenize_run(run))]
    qids = np.array([q for q in run for _ in run[q]])
    docnos = np.array([d for q in run for d in run[q]])
    scores = np.array([s for q in run for s in run[q].values()],
                      np.float32)
    pairs.append((ev.buffer_from_arrays(qids, docnos, scores),
                  jev.buffer_from_arrays(qids, docnos, scores)))
    kept = [q for q in run if q in ev._qid_index]
    counts = [len(run[q]) for q in kept]
    tokens = np.array([ev._tok.get(d, -1) for q in kept for d in run[q]])
    pairs.append((ev.buffer_from_tokens(kept, counts, tokens),
                  jev.buffer_from_tokens(kept, counts, tokens)))
    for tb, jb in pairs:
        assert tb.qids == jb.qids
        for name in RunBuffer.__slots__[1:]:
            a, b = getattr(tb, name), getattr(jb, name)
            if b is None:
                assert a is None, name
            else:
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("topk_layout", [False, True])
def test_batch_from_buffer_matches_jax(case, evaluators, topk_layout):
    ev, jev = evaluators
    tb = ev.batch_from_buffer(ev.tokenize_run(case[0]),
                              topk_layout=topk_layout)
    jb = jev.batch_from_buffer(jev.tokenize_run(case[0]),
                               topk_layout=topk_layout)
    for name in jb._fields:
        a, b = getattr(tb, name), np.asarray(getattr(jb, name))
        assert a.device.type == "cpu"
        assert a.numpy().dtype == b.dtype, name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


def test_reference_densifier_matches_jax(case, jax_result):
    run, qrel = case
    ev = RelevanceEvaluator(qrel, MEASURES, densify="reference",
                            device="cpu")
    jev = JaxEvaluator(qrel, MEASURES, densify="reference")
    qids = [q for q in run if q in qrel]
    tb, tq = ev._densify(run, qids)
    jb, jq = jev._densify(run, qids)
    np.testing.assert_array_equal(tq, jq)
    for name in jb._fields:
        np.testing.assert_array_equal(getattr(tb, name).numpy(),
                                      np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert_results_match(ev.evaluate(run), jax_result)


def test_evaluate_buffers_matches_jax(case, evaluators):
    ev, jev = evaluators
    run = case[0]
    half = dict(list(run.items())[:3])
    got = ev.evaluate_buffers([ev.tokenize_run(run), ev.tokenize_run(half),
                               ev.tokenize_run({})])
    want = jev.evaluate_buffers([jev.tokenize_run(run),
                                 jev.tokenize_run(half),
                                 jev.tokenize_run({})])
    assert len(got) == 3 and got[2] == {} == want[2]
    for g, w in zip(got[:2], want[:2]):
        assert_results_match(g, w)


def test_aggregate_results_matches_jax(jax_result):
    got = aggregate_results(jax_result)
    want = jax_aggregate(jax_result)
    assert got == want


def test_sharded_evaluator_matches_jax(case, evaluators):
    ev, jev = evaluators
    run = case[0]
    got = ShardedEvaluator(ev).evaluate(run)
    want = JaxSharded(jev).evaluate(run)
    assert_results_match(got.per_query, want.per_query)
    assert got.aggregates.keys() == want.aggregates.keys()
    for k, v in want.aggregates.items():
        assert got.aggregates[k] == pytest.approx(v, abs=2e-4, rel=2e-4), k
    # and the fused path agrees with the port's own measure core
    assert_results_match(got.per_query, ev.evaluate(run))


def test_sharded_buffers_and_table(case, evaluators):
    ev = evaluators[0]
    sev = ShardedEvaluator(ev)
    run = case[0]
    buf = ev.tokenize_run(run)
    one = sev.evaluate_buffer(buf)
    many = sev.evaluate_buffers([buf, ev.tokenize_run({}), buf])
    assert many[1] == ShardedResult({}, {})
    assert many[0].per_query == one.per_query == many[2].per_query
    for k, v in one.aggregates.items():
        assert many[0].aggregates[k] == pytest.approx(v, abs=2e-4), k
    table = sev.evaluate_table([buf, buf])
    assert table.shape == (2 * len(buf), len(sev.keys))
    assert table.dtype == np.float32
    first = [one.per_query[q][k] for q in buf.qids for k in sev.keys]
    np.testing.assert_array_equal(table[:len(buf)].reshape(-1), first)


def test_streaming_accumulators_match_jax():
    rng = np.random.default_rng(9)
    cols = {k: rng.random(7).astype(np.float32) for k in ("map", "P_5")}
    qm = np.array([1, 1, 0, 1, 1, 1, 0], bool)
    init = {k: np.float32(0.0) for k in ("map", "P_5", "__count")}
    want = JSTREAM.metric_finalize(JSTREAM.metric_update_cols(
        init, cols, qm))
    state = {k: torch.tensor(0.0) for k in init}
    got = streaming.metric_finalize(streaming.metric_update_cols(
        state, {k: torch.from_numpy(v) for k, v in cols.items()},
        torch.from_numpy(qm)))
    for k in want:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-6)


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        RelevanceEvaluator({"q": {"d": 1}}, ["map"])
    with pytest.raises(RuntimeError, match="CUDA"):
        RelevanceEvaluator({"q": {"d": 1}}, ["map"], device="cuda")


#: depth-bounded measures: a wide enough run takes the top-k route
DEPTH_MEASURES = ("P_5", "P_10", "success_1", "recall_10", "ndcg_cut_10",
                  "map_cut_10", "judged_10")


def _jax_full_sort(qrel, measures):
    """The JAX evaluator held to its full-sort route: its top-k route has
    no order for NaN (``repro/kernels/bitonic.py``), so it is no reference
    for NaN scores."""
    ev = JaxEvaluator(qrel, measures)
    ev._route_topk = lambda buf: False
    return ev


@pytest.fixture(scope="module")
def nan_case():
    """Eight queries of 3-1,500 documents: ties, +-inf, NaN of both signs;
    one query all NaN, two shorter than the depth-10 cutoffs' k."""
    rng = np.random.default_rng(7)
    qrel, run = {}, {}
    for q, n in enumerate((1500, 700, 1200, 3, 600, 900, 8, 1100)):
        docs = [f"q{q}d{i}" for i in range(n)]
        s = np.round(rng.random(n), 2).astype(np.float32)
        s[rng.random(n) < 0.05] = np.nan
        s[rng.random(n) < 0.02] = -np.nan
        s[rng.random(n) < 0.02] = np.inf
        s[rng.random(n) < 0.02] = -np.inf
        if q == 3:
            s[:] = np.nan
        judged = rng.choice(docs, min(n, 40), replace=False)
        qrel[f"q{q}"] = {d: int(rng.integers(0, 3)) for d in judged}
        run[f"q{q}"] = dict(zip(docs, s.tolist()))
    return qrel, run


def test_topk_route_ranks_nan_as_the_jax_full_sort(nan_case):
    """NaN and +-inf scores, all-NaN and short rows: the port's top-k route
    equals the JAX full-sort route (counts exact, the rest at 2e-4), and
    the port's own full-sort route value for value."""
    from repro_torch.core import measures as M

    qrel, run = nan_case
    ev = RelevanceEvaluator(qrel, DEPTH_MEASURES, device="cpu")
    buf = ev.tokenize_run(run)
    assert ev._route_topk(buf)
    got = ev.evaluate(run)
    assert_results_match(got, _jax_full_sort(qrel, DEPTH_MEASURES)
                         .evaluate(run))
    full = M.compute_measures(ev.batch_from_buffer(buf), ev.measures,
                              ev.relevance_level)
    for i, qid in enumerate(buf.qids):
        for k in ev.measure_keys:
            assert got[qid][k] == float(full[k][i]), (qid, k)


def test_nan_on_relevant_documents_ranks_last_on_both_routes():
    """One query of 1,500 documents, 10 relevant scored below every other,
    3 of them NaN: P_10 is 0.0 on both routes, as on the JAX full sort
    (the top-k route once ranked the NaNs first: 0.3)."""
    from repro_torch.core import measures as M

    rng = np.random.default_rng(3)
    docs = [f"d{i:04d}" for i in range(1500)]
    scores = 1.0 + rng.random(1500)
    scores[:10] = rng.random(10) * 0.5
    scores[:3] = np.nan
    qrel = {"q1": {d: 1 for d in docs[:10]}}
    run = {"q1": dict(zip(docs, scores.tolist()))}
    ev = RelevanceEvaluator(qrel, {"P_10"}, device="cpu")
    buf = ev.tokenize_run(run)
    assert ev._route_topk(buf)
    assert ev.evaluate(run)["q1"]["P_10"] == 0.0
    full = M.compute_measures(ev.batch_from_buffer(buf), ev.measures,
                              ev.relevance_level)
    assert float(full["P_10"][0]) == 0.0
    assert _jax_full_sort(qrel, {"P_10"}).evaluate(run)["q1"]["P_10"] == 0.0
