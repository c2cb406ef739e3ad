"""The port's sharded evaluator over CPU meshes, against the JAX package's.

``ShardedEvaluator(ev, mesh=["cpu"] * n)`` splits the query axis into n
blocks, each through the fused kernel's plain version: per-query rows must
be bit-identical for n = 1, 2, 3 and 4, on the conformance fixtures and
on ``synthesize_run(12, 30)``.  Against the JAX ``ShardedEvaluator``
in-process (one device, as the test process runs; its mesh invariance
is JAX's own test, ``tests/test_sharded.py``): count columns exact, the
rest within atol = rtol = 2e-4, also at relevance level 2 and with
``judged_docs_only``.  Also: uneven padding, an empty run,
``evaluate_buffers``, ``evaluate_table``, ``from_files(mesh=...)``,
``evaluate_sharded``, ``default_mesh`` and mesh entries that name an
absent card.
"""

import os

import numpy as np
import pytest
import torch

from repro.core import RelevanceEvaluator as JaxEvaluator
from repro.core import supported_measures as jax_supported
from repro.core import trec as jax_trec
from repro.data.synthetic_ir import synthesize_run as jax_synthesize_run
from repro.distributed.sharded_evaluator import \
    ShardedEvaluator as JaxSharded

from repro_torch.core import (RelevanceEvaluator, aggregate_results,
                              supported_measures, trec)
from repro_torch.data.synthetic_ir import synthesize_run
from repro_torch.distributed import (ShardedEvaluator, ShardedResult,
                                     default_mesh, sharded_evaluator)
from repro_torch.kernels import bucketing

from test_torch_measures import single_torch_thread  # noqa: F401
from test_torch_measures import assert_results_match

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
QREL = os.path.join(FIXTURES, "conformance.qrel")
RUN = os.path.join(FIXTURES, "conformance.run")
SHARDS = (1, 2, 3, 4)


def _conformance():
    return trec.load_run(RUN), trec.load_qrel(QREL)


def _synthetic():
    return synthesize_run(12, 30)


#: the synthetic data set again, with an evaluator option
OPTIONS = {"level_2": {"relevance_level": 2},
           "judged_docs_only": {"judged_docs_only": True}}


@pytest.fixture(scope="module",
                params=["conformance", "synthetic", *OPTIONS])
def case(request):
    """(run, port evaluator, JAX sharded result) for one data set, the
    synthetic one also at relevance level 2 and with
    ``judged_docs_only``."""
    options = OPTIONS.get(request.param, {})
    if request.param == "conformance":
        run, qrel = _conformance()
        jrun = jax_trec.load_run(RUN)
        jqrel = jax_trec.load_qrel(QREL)
    else:
        run, qrel = _synthetic()
        jrun, jqrel = jax_synthesize_run(12, 30)
        assert jrun == run and jqrel == qrel
    ev = RelevanceEvaluator(qrel, supported_measures, device="cpu",
                            **options)
    want = JaxSharded(JaxEvaluator(jqrel, jax_supported,
                                   **options)).evaluate(jrun)
    return run, ev, want


@pytest.fixture(scope="module")
def results(case):
    run, ev, _ = case
    return {n: ShardedEvaluator(ev, mesh=["cpu"] * n).evaluate(run)
            for n in SHARDS}


@pytest.mark.parametrize("n", SHARDS[1:])
def test_rows_bit_identical_across_mesh_sizes(results, n):
    one, got = results[1].per_query, results[n].per_query
    assert list(got) == list(one)
    for qid, row in one.items():
        assert list(got[qid]) == list(row)
        for k, v in row.items():
            assert got[qid][k] == v, (n, qid, k)
    for k, v in results[1].aggregates.items():
        assert results[n].aggregates[k] == pytest.approx(v, abs=1e-6), k


@pytest.mark.parametrize("n", SHARDS)
def test_matches_jax_sharded_evaluator(case, results, n):
    _, _, want = case
    got = results[n]
    assert_results_match(got.per_query, want.per_query)
    assert got.aggregates.keys() == want.aggregates.keys()
    for k, v in want.aggregates.items():
        assert got.aggregates[k] == pytest.approx(v, abs=2e-4, rel=2e-4), k


def test_matches_the_ports_own_evaluate(case, results):
    run, ev, _ = case
    want = ev.evaluate(run)
    assert_results_match(results[4].per_query, want)
    for k, v in aggregate_results(want).items():
        assert results[4].aggregates[k] == pytest.approx(v, abs=1e-6), k


def test_uneven_padding_gives_equal_blocks_masked():
    """5 queries over 3 shards: the query axis pads to 9, three blocks of
    3, and the padded rows carry ``query_mask`` False."""
    assert bucketing.bucket_queries(5, multiple=3) == 9
    run, qrel = _synthetic()
    qids = list(run)[:5]
    ev = RelevanceEvaluator({q: qrel[q] for q in qids}, ("map", "P_5"),
                            device="cpu")
    sev = ShardedEvaluator(ev, mesh=["cpu"] * 3)
    buf = ev.tokenize_run({q: run[q] for q in qids})
    batch = sev._batch(buf)
    assert batch.query_mask.tolist() == [True] * 5 + [False] * 4
    blocks = []
    real = sev._local

    def spy(block):
        blocks.append(block)
        return real(block)

    sev._local = spy
    res = sev.evaluate_buffer(buf)
    assert [b.query_mask.tolist() for b in blocks] == [
        [True] * 3, [True, True, False], [False] * 3]
    want = ev.evaluate_buffer(buf)
    assert res.per_query == want
    for k in ("map", "P_5"):
        assert res.aggregates[k] == pytest.approx(
            np.mean([want[q][k] for q in want], dtype=np.float32), abs=1e-6)


def test_dispatch_rejects_a_query_axis_that_does_not_split():
    run, qrel = _conformance()
    ev = RelevanceEvaluator(qrel, ("map",), device="cpu")
    batch = ev.batch_from_buffer(ev.tokenize_run(run))  # 2 rows
    with pytest.raises(ValueError, match="equal shards"):
        ShardedEvaluator(ev, mesh=["cpu"] * 3)._dispatch(batch)


def test_empty_run():
    ev = RelevanceEvaluator({"q1": {"d1": 1}}, ("map",), device="cpu")
    sev = ShardedEvaluator(ev, mesh=["cpu"] * 2)
    assert sev.evaluate({}) == ShardedResult({}, {})
    assert sev.evaluate_buffers([]) == []
    assert sev.evaluate_table([]).shape == (0, 1)


@pytest.mark.parametrize("n", (1, 3))
def test_buffers_and_table_over_a_mesh(n):
    run, qrel = _synthetic()
    ev = RelevanceEvaluator(qrel, supported_measures, device="cpu")
    sev = ShardedEvaluator(ev, mesh=["cpu"] * n)
    buf = ev.tokenize_run(run)
    half = ev.tokenize_run({q: run[q] for q in list(run)[:5]})
    one = sev.evaluate_buffer(buf)
    many = sev.evaluate_buffers([buf, ev.tokenize_run({}), half])
    assert many[1] == ShardedResult({}, {})
    assert many[0].per_query == one.per_query
    assert many[2].per_query == {q: one.per_query[q] for q in half.qids}
    for k, v in one.aggregates.items():
        assert many[0].aggregates[k] == pytest.approx(v, abs=1e-6), k
    table = sev.evaluate_table([buf, half])
    assert table.shape == (len(buf) + len(half), len(sev.keys))
    assert table.dtype == np.float32
    want = [one.per_query[q][k] for q in buf.qids + half.qids
            for k in sev.keys]
    np.testing.assert_array_equal(table.reshape(-1), want)


def test_from_files_with_a_mesh():
    sev, buf = ShardedEvaluator.from_files(QREL, RUN,
                                           measures=("map", "ndcg"),
                                           mesh=["cpu"] * 4, device="cpu")
    assert sev.n_shards == 4 and sev.mesh == (torch.device("cpu"),) * 4
    jsev, jbuf = JaxSharded.from_files(QREL, RUN, measures=("map", "ndcg"))
    want = jsev.evaluate_buffer(jbuf)
    got = sev.evaluate_buffer(buf)
    assert_results_match(got.per_query, want.per_query)
    assert got.per_query == sev.evaluator.evaluate_buffer(buf)


def test_evaluate_sharded_matches_the_jax_example():
    """``tests/test_sharded.py``'s example: map 0.5."""
    qrel = {"q1": {"d1": 1, "d2": 0}}
    run = {"q1": {"d1": 0.2, "d2": 0.9}}
    ev = RelevanceEvaluator(qrel, ("map",), device="cpu")
    res = ev.evaluate_sharded(run)
    assert res.per_query["q1"]["map"] == 0.5
    assert res.aggregates["map"] == 0.5
    want = JaxEvaluator(qrel, ("map",)).evaluate_sharded(run)
    assert res.per_query == want.per_query
    buf = ev.tokenize_run(run)
    assert ev.evaluate_sharded(buf, mesh=["cpu"] * 2).per_query == \
        res.per_query


def test_cpu_evaluator_defaults_to_its_own_device():
    ev = RelevanceEvaluator({"q1": {"d1": 1}}, ("map",), device="cpu")
    assert ShardedEvaluator(ev).mesh == (torch.device("cpu"),)


def test_default_mesh_spans_every_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    default_mesh.cache_clear()
    try:
        mesh = default_mesh()
        assert mesh == tuple(torch.device("cuda", i) for i in range(3))
        assert default_mesh() is mesh  # memoized
    finally:
        default_mesh.cache_clear()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        default_mesh()
    default_mesh.cache_clear()


def test_mesh_entries_name_present_cards_only(monkeypatch):
    ev = RelevanceEvaluator({"q1": {"d1": 1}}, ("map",), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ShardedEvaluator(ev, mesh=["cuda:0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    with pytest.raises(ValueError, match="absent card"):
        ShardedEvaluator(ev, mesh=["cuda:0", "cuda:2"])
    # "cuda" is the current card: compare indices, not device objects
    assert sharded_evaluator.mesh_device("cuda") == torch.device("cuda", 1)
    with pytest.raises(TypeError):
        ShardedEvaluator(ev, mesh="cpu")
    with pytest.raises(ValueError, match="empty"):
        ShardedEvaluator(ev, mesh=[])


def test_the_batch_is_densified_once_on_the_evaluators_device(monkeypatch):
    """One densify on the evaluator's device; the blocks of shards on that
    device are views of it (no copy), and the table comes back on the
    mesh's first device."""
    run, qrel = _conformance()
    ev = RelevanceEvaluator(qrel, ("map", "P_5"), device="cpu")
    sev = ShardedEvaluator(ev, mesh=["cpu"] * 2)
    batch = sev._batch(ev.tokenize_run(run))
    assert batch.rel.device == ev.device
    seen = []
    local = sev._local

    def spy(block):
        seen.append(block.rel.untyped_storage().data_ptr())
        return local(block)

    monkeypatch.setattr(sev, "_local", spy)
    table, aggs = sev._dispatch(batch)
    assert seen == [batch.rel.untyped_storage().data_ptr()] * 2
    assert table.device == sev.mesh[0] and set(aggs) == {"map", "P_5"}


def test_select_backend_is_unchanged_on_one_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert sharded_evaluator.select_backend("auto") == "single"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert sharded_evaluator.select_backend("auto") == "sharded"
    assert sharded_evaluator.select_backend("auto", device="cpu") == "single"
    with pytest.raises(ValueError):
        sharded_evaluator.select_backend("mesh")
