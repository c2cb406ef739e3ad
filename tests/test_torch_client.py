"""The port's client library against the port's service, on the CPU.

``EvalClient`` over a ``ServerThread`` (TCP, on an ephemeral port) and
over ``spawn_stdio`` (``python -m repro_torch.serve --device cpu``), and
``AsyncEvalClient`` pipelining on one connection: answers bit-identical
to the evaluator called directly, pipelined requests coalesced into fewer
backend calls, server errors mapped to the client's error types, and the
same ``compare`` bundle the JAX client gets from the JAX service.  Every
wait is bounded: the sync client's ``timeout``, ``Future.result(timeout)``,
``asyncio.wait_for``.
"""

import asyncio
import os
import sys

import numpy as np
import pytest

from repro.client import EvalClient as JaxClient
from repro.serve.testing import ServerThread as JaxServerThread

from repro_torch.client import AsyncEvalClient, EvalClient, ServerError
from repro_torch.core import RelevanceEvaluator
from repro_torch.data.synthetic_ir import synthesize_run
from repro_torch.serve.testing import ServerThread

from test_torch_measures import single_torch_thread  # noqa: F401

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
QREL = os.path.join(FIXTURES, "conformance.qrel")
RUN = os.path.join(FIXTURES, "conformance.run")
SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
MEASURES = ("map", "recip_rank", "P")
WAIT = 60
CPU = {"device": "cpu", "backend": "single", "window": 0.05}


@pytest.fixture(scope="module")
def collection():
    return synthesize_run(n_queries=16, n_docs=12, seed=11)


def test_eval_client_over_tcp(collection):
    run, qrel = collection
    ev = RelevanceEvaluator(qrel, MEASURES, device="cpu")
    buf = ev.tokenize_run(run)
    rng = np.random.default_rng(1)
    score_sets = [rng.random(buf.qidx.shape[0]).astype(np.float32)
                  for _ in range(6)]
    with ServerThread(service_kw=CPU) as srv:
        with EvalClient(srv.host, srv.port, timeout=WAIT) as client:
            assert client.ping() == "pong"
            info = client.register_qrel("c", qrel, MEASURES)
            assert info["backend"] == "single"
            assert client.evaluate("c", run=run).per_query == \
                ev.evaluate(run)
            client.register_run("c", "bm25", run=run)
            before = srv.stats()["backend_calls"]
            futures = [client.submit("c", run_ref="bm25", scores=s)
                       for s in score_sets]
            results = [f.result(WAIT) for f in futures]
            many = client.evaluate_many("c", run_ref="bm25",
                                        scores_list=score_sets)
            calls = srv.stats()["backend_calls"] - before
            with pytest.raises(ServerError) as err:
                client.evaluate("nope", run=run)
            assert err.value.code == "not_found"
            assert client.drop_qrel("c") is True
    assert calls < 2 * len(score_sets)  # pipelined requests coalesced
    for s, a, b in zip(score_sets, results, many):
        want = ev.evaluate_buffer(buf, scores=s)
        assert a.per_query == want and b.per_query == want


def test_async_client_pipelines_on_one_connection(collection):
    run, qrel = collection
    ev = RelevanceEvaluator(qrel, MEASURES, device="cpu")
    runs = [{q: {d: s * (i + 1) % 7 for d, s in docs.items()}
             for q, docs in run.items()} for i in range(4)]
    with ServerThread(service_kw=CPU) as srv:
        srv.register_qrel("c", qrel, MEASURES)

        async def main():
            async with await AsyncEvalClient.connect(srv.host,
                                                     srv.port) as client:
                return await client.evaluate_many("c", runs=runs)

        results = asyncio.run(asyncio.wait_for(main(), WAIT))
        stats = srv.stats()
    assert stats["requests"] == 4 and stats["backend_calls"] < 4
    for r, res in zip(runs, results):
        assert res.per_query == ev.evaluate(r)


def test_compare_over_the_wire_matches_the_jax_client(collection):
    """The t-test bundle over TCP from the port's service equals the JAX
    service's within 2e-4 (same names, queries and significance mask)."""
    run, qrel = collection
    rng = np.random.default_rng(2)
    runs = {f"s{i}": {q: {d: float(s + rng.normal())
                          for d, s in docs.items()}
                      for q, docs in run.items()} for i in range(3)}
    out = []
    for server, client_cls, kw in (
            (ServerThread, EvalClient, {"service_kw": CPU}),
            (JaxServerThread, JaxClient,
             {"service_kw": {"backend": "single", "window": 0.05}})):
        with server(**kw) as srv:
            with client_cls(srv.host, srv.port, timeout=WAIT) as client:
                client.register_qrel("c", qrel, MEASURES)
                out.append(client.compare("c", runs=runs, measure="map"))
    got, want = out
    assert got.keys() == want.keys()
    for k in ("run_names", "measure", "qids", "n_queries", "significant"):
        assert got[k] == want[k], k
    for k in ("means", "diff", "t", "p", "p_holm", "p_bonferroni"):
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float),
                                   atol=2e-4, rtol=2e-4, err_msg=k)


def test_eval_client_spawn_stdio(collection, monkeypatch):
    """``python -m repro_torch.serve --device cpu`` as a private stdio
    subprocess: the ``--qrel`` collection answers as the CLI does."""
    run, qrel = collection
    path = os.environ.get("PYTHONPATH")
    monkeypatch.setenv("PYTHONPATH",
                       SRC + (os.pathsep + path if path else ""))
    with EvalClient.spawn_stdio(
            [sys.executable, "-m", "repro_torch.serve", "--device", "cpu",
             "--qrel", QREL, "-m", "map", "--window-ms", "1"],
            timeout=WAIT) as client:
        assert client.ping() == "pong"
        res = client.evaluate("default", run={
            "q1": {"APPLE": 3.0, "CHERRY": 2.0, "MANGO": 2.0,
                   "BANANA": 1.0}})
        assert res.per_query["q1"]["map"] == pytest.approx(0.5, abs=1e-6)
        client.register_qrel("syn", qrel, MEASURES)
        got = client.evaluate("syn", run=run)
        assert client.health()["status"] == "ok"
    assert got.per_query == RelevanceEvaluator(qrel, MEASURES,
                                               device="cpu").evaluate(run)


def test_server_thread_on_a_host_without_cuda_raises_and_leaves_no_thread(
        monkeypatch):
    import threading

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="CUDA"):
        ServerThread()
    assert threading.active_count() == before
    with pytest.raises(ValueError, match="both required"):
        EvalClient(None, None)
