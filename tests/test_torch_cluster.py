"""The port's serve cluster (``repro_torch.serve.cluster``) against the JAX
package's, on the CPU.

The pure pieces go through both packages on the same inputs: the hash
ring gives the same owner and replica set for every key, the circuit
breaker the same states under the same clock, and the registration
journal the same bytes on disk, each package loading the other's file.

The live pieces run the port's router over ``python -m repro_torch.serve
--device cpu`` workers: every answer is bit-identical to the port's
in-process evaluator (count columns bit-identical to the JAX evaluator's
as well, the rest within atol = rtol = 2e-4), the conformance golden
byte-matches through ``EvalClient``, and the fault paths (a worker killed
mid-request, ``drop_qrel`` on a down worker, replica failover, hedging,
deadlines, drain, a restart from ``--state-dir``) and the chaos schedules
(kill, hang, delay, truncate, a seeded random mix) keep their contract.
No JAX cluster is booted.

Every wait is bounded: ``EvalClient(timeout=...)``, ``ClusterThread.call``
and its ``close``, ``asyncio.wait_for`` around each coroutine, and polls
with deadlines.  Two module-scoped clusters serve most tests: ``cluster``
(one replica a collection) and ``replicated`` (two, a durable journal,
every worker behind a chaos proxy).
"""

import asyncio
import json
import os
import time

import numpy as np
import pytest

from repro.core import RelevanceEvaluator as JaxEvaluator
from repro.serve.cluster import CircuitBreaker as JaxBreaker
from repro.serve.cluster import HashRing as JaxRing
from repro.serve.cluster import RegistrationJournal as JaxJournal

from repro_torch import cli
from repro_torch.client import (DeadlineExceededError, EvalClient,
                                ServerError, WorkerUnavailableError)
from repro_torch.core import RelevanceEvaluator, aggregate_results, trec
from repro_torch.core import supported_measures
from repro_torch.data.synthetic_ir import synthesize_run
from repro_torch.serve import EvaluationService
from repro_torch.serve.cluster import (ChaosEvent, ChaosSchedule,
                                       CircuitBreaker, HashRing,
                                       ProxyManager, RegistrationJournal,
                                       Router)
from repro_torch.serve.cluster.chaos import inject
from repro_torch.serve.cluster.journal import JOURNAL_FILE
from repro_torch.serve.cluster.testing import ClusterThread
from repro_torch.serve.frontend import close_server, serve_protocol

from test_torch_measures import assert_results_match

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
QREL = os.path.join(FIXTURES, "conformance.qrel")
RUN = os.path.join(FIXTURES, "conformance.run")
GOLDEN = os.path.join(FIXTURES, "conformance.golden")

MEASURES = ("map", "ndcg", "recip_rank", "P")
CPU = ["--device", "cpu", "--backend", "single", "--window-ms", "1"]
WAIT = 60  # seconds: the bound on every client call, poll and coroutine

#: errors a client may legitimately see WHILE a chaos schedule runs
TOLERATED = (WorkerUnavailableError, DeadlineExceededError)


def _evaluator(qrel, measures=MEASURES):
    return RelevanceEvaluator(qrel, measures, device="cpu")


# -- the hash ring: the same owners as the JAX ring ---------------------------


@pytest.mark.parametrize("n_workers", [2, 3, 4, 5])
def test_ring_owners_equal_the_jax_ring(n_workers):
    nodes = [f"w{i}" for i in range(n_workers)]
    mine, theirs = HashRing(nodes), JaxRing(reversed(nodes))
    keys = [f"collection-{i}" for i in range(2000)]
    for key in keys:
        assert mine.owner(key) == theirs.owner(key), key
        for r in range(1, n_workers + 2):
            assert mine.owners(key, r) == theirs.owners(key, r), (key, r)
    # growing and shrinking remaps the same keys in both packages
    before = {k: mine.owner(k) for k in keys}
    mine.add("wx")
    theirs.add("wx")
    moved = [k for k in keys if mine.owner(k) != before[k]]
    assert moved == [k for k in keys if theirs.owner(k) != before[k]]
    assert moved and all(mine.owner(k) == "wx" for k in moved)
    assert ([mine.owners(k, 2) for k in keys]
            == [theirs.owners(k, 2) for k in keys])
    mine.remove("w0")
    theirs.remove("w0")
    assert [mine.owner(k) for k in keys] == [theirs.owner(k) for k in keys]
    copy = mine.copy()
    copy.remove("wx")
    assert "wx" in mine and mine.nodes == theirs.nodes


# -- the circuit breaker: the same states under the same clock ----------------


def _breaker_trace(cls):
    now = [0.0]
    b = cls(failures=3, cooldown=2.0, clock=lambda: now[0])
    steps = [("allow",), ("fail",), ("fail",), ("ok",), ("fail",),
             ("fail",), ("fail",), ("would",), ("allow",), ("t", 1.0),
             ("would",), ("t", 2.5), ("would",), ("would",), ("allow",),
             ("allow",), ("fail",), ("t", 5.0), ("allow",), ("ok",),
             ("fail",), ("fail",), ("fail",), ("t", 7.5), ("allow",),
             ("fail",), ("fail",)]
    trace = []
    for step in steps:
        if step[0] == "t":
            now[0] = step[1]
            out = None
        elif step[0] == "allow":
            out = b.allow()
        elif step[0] == "would":
            out = b.would_allow()
        elif step[0] == "ok":
            out = b.record_success()
        else:
            out = b.record_failure()
        trace.append((step, out, b.state, b.stats()))
    return trace


def test_breaker_matches_the_jax_breaker():
    trace = _breaker_trace(CircuitBreaker)
    assert trace == _breaker_trace(JaxBreaker)
    assert {state for _, _, state, _ in trace} == {"closed", "open",
                                                   "half_open"}
    assert trace[-1][3]["trips"] == 4


# -- the journal: byte-identical files, loaded across packages ----------------


def _journal_ops(journal):
    qrel = {"q1": {"d1": 1, "d2": 0}, "q2": {"d3": 2}}
    journal.record_qrel("web", {"qrel_id": "web", "qrel": qrel,
                                "measures": ["map"]})
    journal.record_run("web", "bm25", {"qrel_id": "web", "run_id": "bm25",
                                       "run": {"q1": {"d1": 1.5}}})
    journal.record_qrel("news", {"qrel_id": "news", "qrel": {"q9": {"x": 1}}})
    journal.record_run("web", "bm25", {"qrel_id": "web", "run_id": "bm25",
                                       "run": {"q1": {"d2": 0.5}}})
    journal.record_run("gone", "r", {"qrel_id": "gone", "run_id": "r"})
    assert journal.record_drop("news") is True
    assert journal.record_drop("news") is False
    for i in range(5):  # superseded registrations: compaction folds them
        journal.record_qrel("col", {"qrel_id": "col", "n": i})


@pytest.mark.parametrize("compact_min_dead", [4, 1000])
def test_journal_files_are_the_jax_journal_s(tmp_path, compact_min_dead):
    mine_dir, theirs_dir = str(tmp_path / "torch"), str(tmp_path / "jax")
    mine = RegistrationJournal(mine_dir, compact_min_dead=compact_min_dead,
                               fsync=False)
    theirs = JaxJournal(theirs_dir, compact_min_dead=compact_min_dead,
                        fsync=False)
    _journal_ops(mine)
    _journal_ops(theirs)
    assert mine.entries == theirs.entries
    assert mine.counters == theirs.counters
    mine_path = os.path.join(mine_dir, JOURNAL_FILE)
    theirs_path = os.path.join(theirs_dir, JOURNAL_FILE)
    with open(mine_path, "rb") as a, open(theirs_path, "rb") as b:
        data = a.read()
        assert data == b.read()
    assert (mine.counters["compactions"] > 0) == (compact_min_dead == 4)
    # each package loads the other's file, torn tail and corrupt line too
    for path in (mine_path, theirs_path):
        with open(path, "ab") as fh:
            fh.write(b"this is not json\n")
            fh.write(b'{"kind": "qrel", "qrel_id": "torn"')
    loaded = [RegistrationJournal(theirs_dir, compact_min_dead=1000),
              JaxJournal(mine_dir, compact_min_dead=1000)]
    for j in loaded:
        assert j.entries == mine.entries
        assert sorted(j) == ["col", "web"]
    assert loaded[0].stats()["skipped_records"] == 1  # torn: never framed
    assert ({k: v for k, v in loaded[0].stats().items() if k != "path"}
            == {k: v for k, v in loaded[1].stats().items() if k != "path"})


def test_journal_skips_a_record_missing_its_fields(tmp_path):
    """A ``run`` or ``qrel`` record without its run id or payload is a
    corrupt line: the port skips it and replays the rest.  (The JAX
    journal raises KeyError on it and loads nothing.)"""
    d = str(tmp_path)
    RegistrationJournal(d).record_qrel("web", {"qrel_id": "web"})
    with open(os.path.join(d, JOURNAL_FILE), "ab") as fh:
        fh.write(b'{"kind": "run", "qrel_id": "web", "payload": {}}\n')
        fh.write(b'{"kind": "qrel", "qrel_id": "news"}\n')
        fh.write(b'{"kind": "run", "qrel_id": "web", "run_id": "r", '
                 b'"payload": {"run_id": "r"}}\n')
    j = RegistrationJournal(d)
    assert sorted(j) == ["web"] and list(j.get("web")["runs"]) == ["r"]
    assert j.stats()["skipped_records"] == 2
    with pytest.raises(KeyError):
        JaxJournal(d)


def test_journal_memory_only_mode(tmp_path):
    j = RegistrationJournal(None)
    j.record_qrel("a", {"qrel_id": "a"})
    assert "a" in j and j.stats()["durable"] is False
    assert j.record_drop("a") is True and len(j) == 0
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("module_name", [
    "repro_torch.serve.cluster.ring", "repro_torch.serve.cluster.breaker",
    "repro_torch.serve.cluster.journal", "repro_torch.serve.cluster.chaos",
])
def test_cluster_docstring_examples(module_name):
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module_name))
    assert results.attempted > 0 and results.failed == 0, results


# -- live clusters ------------------------------------------------------------


@pytest.fixture(scope="module")
def cluster():
    # one replica a collection; health probes out of the way, so restarts
    # come from the supervisor's proc.wait alone
    with ClusterThread(2, worker_args=CPU,
                       router_kw=dict(retries=4, health_interval=30.0)) as c:
        yield c


@pytest.fixture(scope="module")
def replicated(tmp_path_factory):
    # R=2 over 2 workers: every collection on BOTH, reads balanced with
    # power-of-two-choices, a durable journal, and every worker reached
    # through a chaos proxy.  Health probes out of the way: the hedging
    # test SIGSTOPs a worker and must not race the prober's kill.
    state = str(tmp_path_factory.mktemp("cluster-state"))
    proxies = ProxyManager()
    cluster = ClusterThread(
        2, worker_args=[*CPU, "--max-collections", "64"],
        router_kw=dict(replication=2, retries=4, health_interval=30.0,
                       rng_seed=0, state_dir=state,
                       wrap_endpoint=proxies.wrap))
    try:
        yield cluster, proxies
    finally:
        try:
            cluster.call(proxies.aclose(), timeout=WAIT)
        finally:
            cluster.close()


def _distinct_owner_ids(cluster, n=2):
    """qrel_ids owned by n different workers (deterministic: SHA-1 ring)."""
    picked, owners = [], set()
    for i in range(200):
        qid = f"col{i}"
        owner = cluster.owner_of(qid)
        if owner not in owners:
            owners.add(owner)
            picked.append(qid)
            if len(picked) == n:
                return picked
    raise AssertionError(f"ring maps 200 candidate ids onto < {n} workers")


def _wait_all_ready(cluster, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cluster.health()["status"] == "ok":
            return
        time.sleep(0.05)
    raise AssertionError(f"cluster not ready: {cluster.health()}")


def _wait_forwarded(cluster, worker, timeout=WAIT):
    """Block until the router has a request in flight on ``worker``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        async def inflight():
            return cluster.router._slots[worker].inflight
        if cluster.call(inflight(), timeout=timeout) > 0:
            return
        time.sleep(0.002)
    raise AssertionError(f"no request reached {worker} within {timeout} s")


def _golden_lines(per_query, qrel, keys):
    lines = cli.summary_lines(per_query, keys, qrel, trec.run_id(RUN))
    return "\n".join(lines) + "\n"


def _golden():
    with open(GOLDEN, newline="") as fh:
        return fh.read()


# -- bit-identity vs the in-process evaluators --------------------------------


def test_cluster_ping_health_and_worker_spread(cluster):
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        assert client.ping() == "pong"
        health = client.health()
    assert health["status"] == "ok" and health["ready"] == 2
    assert {w["name"] for w in health["workers"]} == {"w0", "w1"}
    ids = _distinct_owner_ids(cluster, n=2)  # both workers take traffic
    assert cluster.owner_of(ids[0]) != cluster.owner_of(ids[1])
    assert ([cluster.owner_of(f"col{i}") for i in range(200)]
            == [JaxRing(["w0", "w1"]).owner(f"col{i}") for i in range(200)])


def test_cluster_evaluate_bit_identical_across_workers(cluster):
    """One collection per worker; both answer the port's in-process
    evaluator bit for bit, and the JAX evaluator within its tolerance."""
    ids = _distinct_owner_ids(cluster, n=2)
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        for seed, qrel_id in enumerate(ids):
            run, qrel = synthesize_run(n_queries=12, n_docs=10, seed=seed)
            info = client.register_qrel(qrel_id, qrel, MEASURES)
            assert info["n_queries"] == len(qrel)
            res = client.evaluate(qrel_id, run=run)
            want = _evaluator(qrel).evaluate(run)
            assert res.per_query == want  # bit-identical floats
            assert res.aggregates == aggregate_results(want)
            assert_results_match(res.per_query,
                                 JaxEvaluator(qrel, MEASURES).evaluate(run))
        stats = client.stats()
    # each collection is resident on exactly ONE worker
    residence = {name: set(w["collections"]) if w else set()
                 for name, w in stats["workers"].items()}
    for qrel_id in ids:
        holders = [n for n, cols in residence.items() if qrel_id in cols]
        assert holders == [cluster.owner_of(qrel_id)], (qrel_id, residence)


def test_cluster_rescoring_run_ref_bit_identical(cluster):
    run, qrel = synthesize_run(n_queries=10, n_docs=8, seed=41)
    ev = _evaluator(qrel, ("map", "recip_rank"))
    buf = ev.tokenize_run(run)
    rng = np.random.default_rng(8)
    score_sets = [rng.normal(size=buf.qidx.shape[0]).astype(np.float32)
                  for _ in range(4)]
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        client.register_qrel("rescore", qrel, ("map", "recip_rank"))
        client.register_run("rescore", "bm25", run=run)
        results = client.evaluate_many("rescore", run_ref="bm25",
                                       scores_list=score_sets)
    for scores, res in zip(score_sets, results):
        assert res.per_query == ev.evaluate_buffer(buf, scores=scores)


def test_cluster_compare_matches_single_process(cluster):
    run_a, qrel = synthesize_run(n_queries=9, n_docs=7, seed=3)
    run_b, _ = synthesize_run(n_queries=9, n_docs=7, seed=4)
    runs = {"a": run_a, "b": run_b}
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        client.register_qrel("cmp", qrel, ("map",))
        got = client.compare("cmp", runs=runs, measure="map",
                             tests=["t", "permutation"],
                             n_permutations=200, seed=7)

    async def direct():
        svc = EvaluationService(backend="single", device="cpu")
        svc.register_qrel("cmp", qrel, ("map",))
        return await svc.compare("cmp", runs=runs, measure="map",
                                 tests=("t", "permutation"),
                                 n_permutations=200, seed=7)

    want = asyncio.run(asyncio.wait_for(direct(), WAIT))
    # json round-trip on both sides: NaN-safe bit-exact comparison
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)


def test_cluster_conformance_golden_byte_match(cluster):
    """The CLI golden, reproduced through a 2-worker cluster."""
    selected = sorted(supported_measures)
    qrel = trec.load_qrel(QREL)
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        client.register_qrel("conformance", qrel, selected,
                             relevance_level=1)
        res = client.evaluate("conformance", run=trec.load_run(RUN))
    assert _golden_lines(res.per_query, qrel,
                         cli.ordered_keys(selected)) == _golden()


def test_cluster_large_payload_roundtrip(cluster):
    """>64 KiB register_qrel + evaluate through the router, bit-identical
    (the forwarded frame also carries the spliced router id — headroom)."""
    qrel, run = {}, {}
    rng = np.random.default_rng(17)
    for q in range(80):
        qid = f"query-{q:05d}"
        docs = [f"document-{q:05d}-{d:05d}-padpadpad" for d in range(24)]
        qrel[qid] = {doc: int(rng.integers(0, 3)) for doc in docs}
        run[qid] = {doc: float(rng.normal()) for doc in docs}
    payload = json.dumps({"op": "evaluate", "qrel_id": "big",
                          "run": run}).encode()
    assert len(payload) > 64 * 1024
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        client.register_qrel("big", qrel, MEASURES)
        res = client.evaluate("big", run=run)
    assert res.per_query == _evaluator(qrel).evaluate(run)


# -- membership changes -------------------------------------------------------


def test_cluster_add_then_remove_worker_rebalances(cluster):
    local = HashRing(["w0", "w1"])
    grown = local.copy()
    grown.add("wx")
    moving = next(f"move{i}" for i in range(500)
                  if grown.owner(f"move{i}") == "wx")
    staying = next(f"move{i}" for i in range(500)
                   if grown.owner(f"move{i}") != "wx")

    run, qrel = synthesize_run(n_queries=8, n_docs=6, seed=9)
    want = _evaluator(qrel).evaluate(run)
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        for qrel_id in (moving, staying):
            client.register_qrel(qrel_id, qrel, MEASURES)
        before = cluster.owner_of(moving)

        assert cluster.add_worker("wx") == "wx"
        assert cluster.owner_of(moving) == "wx" != before
        assert cluster.owner_of(staying) != "wx"
        # no gap in service: the moved collection answers bit-identically
        assert client.evaluate(moving, run=run).per_query == want
        assert cluster.stats()["router"]["rebalanced_collections"] >= 1

        cluster.remove_worker("wx")
        assert cluster.owner_of(moving) == before
        assert "wx" not in cluster.worker_names
        for qrel_id in (moving, staying):  # moved back, still identical
            assert client.evaluate(qrel_id, run=run).per_query == want
            client.drop_qrel(qrel_id)


# -- fault injection (one replica a collection) -------------------------------


def test_worker_kill_midrequest_retries_transparently(cluster):
    """SIGKILL the owner while the router has an evaluate in flight on it
    (the worker is stopped first, so the request is surely there): the
    caller sees nothing but a slower, still bit-identical response."""
    _wait_all_ready(cluster)
    qrel_id = "kill-midrequest"
    owner = cluster.owner_of(qrel_id)
    run, qrel = synthesize_run(n_queries=10, n_docs=8, seed=21)
    want = _evaluator(qrel).evaluate(run)
    counters = cluster.router.counters
    restarts_before = counters["restarts"]
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        client.register_qrel(qrel_id, qrel, MEASURES)
        cluster.pause_worker(owner)
        try:
            future = client.submit(qrel_id, run=run)
            _wait_forwarded(cluster, owner)
        finally:
            cluster.kill_worker(owner)  # SIGKILL ends a stopped process
        res = future.result(WAIT)  # transparent retry after restart+replay
    assert res.per_query == want
    assert counters["restarts"] > restarts_before
    assert counters["worker_retries"] >= 1
    assert counters["replayed_collections"] >= 1


def test_drop_qrel_on_down_worker_is_worker_unavailable(cluster):
    """Non-idempotent drop_qrel is never retried: a down owner surfaces a
    machine-readable error, and the journal keeps the collection so the
    restarted worker still has it."""
    _wait_all_ready(cluster)
    qrel_id = "drop-on-down"
    owner = cluster.owner_of(qrel_id)
    run, qrel = synthesize_run(n_queries=6, n_docs=5, seed=33)
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        client.register_qrel(qrel_id, qrel, MEASURES)
        cluster.kill_worker(owner)
        with pytest.raises(WorkerUnavailableError) as exc_info:
            client.drop_qrel(qrel_id)
        assert exc_info.value.code == "worker_unavailable"
        assert cluster.router.counters["worker_unavailable"] >= 1
        _wait_all_ready(cluster)
        res = client.evaluate(qrel_id, run=run)
        assert res.per_query == _evaluator(qrel).evaluate(run)
        assert client.drop_qrel(qrel_id) is True


def test_deadline_exceeded_is_a_typed_error(cluster):
    """A deadline the stopped owner cannot meet surfaces as
    DeadlineExceededError with the machine-readable code, and a generous
    deadline changes nothing about the bytes."""
    _wait_all_ready(cluster)
    run, qrel = synthesize_run(n_queries=6, n_docs=5, seed=55)
    want = _evaluator(qrel).evaluate(run)
    counters = cluster.router.counters
    before = counters["deadline_exceeded"]
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as c:
        c.register_qrel("deadline", qrel, MEASURES)
        owner = cluster.owner_of("deadline")
        cluster.pause_worker(owner)
        try:
            with pytest.raises(DeadlineExceededError) as exc_info:
                c.evaluate("deadline", run=run, timeout=0.2)
        finally:
            cluster.resume_worker(owner)
        assert exc_info.value.code == "deadline_exceeded"
        assert counters["deadline_exceeded"] > before
        assert c.evaluate("deadline", run=run, timeout=WAIT).per_query \
            == want
        assert c.drop_qrel("deadline") is True
        with pytest.raises(ValueError):  # local validation, never sent
            c.evaluate("deadline", run=run, timeout=-1)


def test_router_drain_answers_inflight_and_refuses_new():
    """Drain contract: the listener closes first, in-flight requests are
    answered through the cascade, new connections are refused.  The
    client stays connected through the drain, so the listener's
    ``wait_closed`` is awaited only after it hangs up, and bounded."""

    async def main():
        router = Router(1, worker_args=["--device", "cpu", "--backend",
                                        "single", "--window-ms", "300"],
                        health_interval=30.0)
        try:
            await router.start()
            server = await serve_protocol(router.handle, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)

            async def rpc(obj):
                writer.write(json.dumps(obj).encode() + b"\n")
                await writer.drain()
                return json.loads(await reader.readline())

            reg = await rpc({"op": "register_qrel", "id": 1, "qrel_id": "c",
                             "qrel": {"q1": {"d1": 1, "d2": 0}},
                             "measures": ["map"]})
            assert reg["ok"], reg
            # the evaluate sits in the worker's 300 ms coalescing window;
            # wait until the router has it in flight, then start the drain
            writer.write(json.dumps({"op": "evaluate", "id": 2,
                                     "qrel_id": "c",
                                     "run": {"q1": {"d1": 1.0}}}).encode()
                         + b"\n")
            await writer.drain()
            while router._inflight == 0:
                await asyncio.sleep(0.001)
            server.close()  # listener gone; our connection stays open
            drain = asyncio.get_running_loop().create_task(router.drain())
            answered = json.loads(await reader.readline())
            await drain
            writer.close()
            await writer.wait_closed()
            closed = await close_server(server)
            refused = None
            try:
                _, w2 = await asyncio.open_connection("127.0.0.1", port)
                w2.close()
            except OSError as exc:
                refused = exc
            return answered, refused, closed
        finally:
            await router.drain()

    answered, refused, closed = asyncio.run(asyncio.wait_for(main(), WAIT))
    assert answered["ok"] and answered["id"] == 2
    assert answered["result"]["per_query"]["q1"]["map"] == 1.0
    assert isinstance(refused, OSError)  # listener gone
    assert closed  # every connection had closed


# -- replication (R=2): fan-out, failover, durable drops, hedging -------------


def test_replicated_register_fans_out_to_all_replicas(replicated):
    cluster, _ = replicated
    _wait_all_ready(cluster)
    run, qrel = synthesize_run(n_queries=10, n_docs=8, seed=51)
    want = _evaluator(qrel).evaluate(run)
    assert sorted(cluster.replicas_of("fanout")) == ["w0", "w1"]
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as c:
        c.register_qrel("fanout", qrel, MEASURES)
        assert c.evaluate("fanout", run=run).per_query == want
        stats = c.stats()
    for name, w in stats["workers"].items():
        assert "fanout" in w["collections"], (name, stats["workers"])
    assert stats["router"]["replication"] == 2
    assert stats["router"]["journal"]["durable"] is True


def test_replicated_kill_one_replica_is_invisible(replicated):
    cluster, _ = replicated
    _wait_all_ready(cluster)
    run, qrel = synthesize_run(n_queries=12, n_docs=9, seed=52)
    want = _evaluator(qrel).evaluate(run)
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as c:
        c.register_qrel("failover", qrel, MEASURES)
        cluster.kill_worker(cluster.replicas_of("failover")[0])
        for _ in range(6):  # p2c aims some of these at the corpse
            assert c.evaluate("failover", run=run).per_query == want
    _wait_all_ready(cluster)


def test_replicated_drop_succeeds_with_one_replica_down(replicated):
    """R=2 drop with a dead replica: acks, prunes the journal, and the
    restarted sibling does NOT resurrect it."""
    cluster, _ = replicated
    _wait_all_ready(cluster)
    run, qrel = synthesize_run(n_queries=6, n_docs=5, seed=53)
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as c:
        c.register_qrel("durable-drop", qrel, MEASURES)
        cluster.kill_worker(cluster.replicas_of("durable-drop")[0])
        assert c.drop_qrel("durable-drop") is True
        assert "durable-drop" not in cluster.router._journal
        _wait_all_ready(cluster)
        with pytest.raises(ServerError) as exc_info:
            c.evaluate("durable-drop", run=run)
        assert exc_info.value.code == "not_found"


def test_replicated_drop_with_every_replica_down_is_worker_unavailable(
        replicated):
    """Both replicas SIGKILLed: ``drop_qrel`` answers
    ``worker_unavailable`` (never ``internal``, even when a replica dies
    while the router talks to its sibling), the journal keeps the
    collection, and once both are back the drop goes through."""
    cluster, _ = replicated
    _wait_all_ready(cluster)
    run, qrel = synthesize_run(n_queries=6, n_docs=5, seed=56)
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as c:
        c.register_qrel("all-down", qrel, MEASURES)
        for name in cluster.worker_names:
            cluster.kill_worker(name)
        with pytest.raises(WorkerUnavailableError) as exc_info:
            c.drop_qrel("all-down")
        assert exc_info.value.code == "worker_unavailable"
        assert "all-down" in cluster.router._journal
        _wait_all_ready(cluster)
        assert c.evaluate("all-down", run=run).per_query \
            == _evaluator(qrel).evaluate(run)
        assert c.drop_qrel("all-down") is True


def test_replicated_hedged_request_wins_past_hung_replica(replicated):
    """SIGSTOP one replica: deadline-carrying evaluates that land on it
    are hedged to the sibling at half the budget and still answer
    bit-identically."""
    cluster, _ = replicated
    _wait_all_ready(cluster)
    run, qrel = synthesize_run(n_queries=8, n_docs=6, seed=54)
    want = _evaluator(qrel).evaluate(run)
    counters = cluster.router.counters
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as c:
        c.register_qrel("hedged", qrel, MEASURES)
        victim = cluster.replicas_of("hedged")[0]
        hedges_before = counters["hedges"]
        cluster.pause_worker(victim)
        try:
            for _ in range(16):  # stop as soon as one request hedged
                res = c.evaluate("hedged", run=run, timeout=1.0)
                assert res.per_query == want
                if counters["hedges"] > hedges_before:
                    break
        finally:
            cluster.resume_worker(victim)
    assert counters["hedges"] > hedges_before
    assert counters["hedge_wins"] > 0
    _wait_all_ready(cluster)


# -- chaos: every fault kind, then a seeded mix -------------------------------


def _register(client, prefix, n, seed0):
    """Register n collections; return {qrel_id: (run, want)}."""
    registered = {}
    for i in range(n):
        run, qrel = synthesize_run(n_queries=6, n_docs=5, seed=seed0 + i)
        qrel_id = f"{prefix}-{i}"
        client.register_qrel(qrel_id, qrel, MEASURES)
        registered[qrel_id] = (run, _evaluator(qrel).evaluate(run))
    return registered


def _drive(client, registered, fut, *, deadline=None, register_seed=None):
    """Round-robin evaluates (and optional mid-chaos registrations) until
    the schedule future resolves.  Delivered results must be
    bit-identical; failures must be typed.  Returns {code: count}."""
    errors = {}
    i = 0
    stop = time.monotonic() + WAIT
    while not fut.done():
        assert time.monotonic() < stop, "the schedule never finished"
        for qrel_id, (run, want) in list(registered.items()):
            try:
                res = client.evaluate(qrel_id, run=run, timeout=deadline)
            except TOLERATED as exc:
                errors[exc.code] = errors.get(exc.code, 0) + 1
            else:
                assert res.per_query == want, qrel_id
        if register_seed is not None and i < 8:  # bounded: LRU headroom
            run, qrel = synthesize_run(n_queries=5, n_docs=4,
                                       seed=register_seed + i)
            qrel_id = f"mid-{register_seed}-{i}"
            try:
                client.register_qrel(qrel_id, qrel, MEASURES)
            except TOLERATED:
                pass  # NOT acked: the router owes us nothing for it
            else:  # acked: it must survive whatever the schedule does
                registered[qrel_id] = (run, _evaluator(qrel).evaluate(run))
            i += 1
        time.sleep(0.02)
    fut.result(timeout=WAIT)  # surface injector exceptions
    return errors


def _assert_converged(cluster, client, registered):
    """Post-schedule: zero lost acks, every answer bit-identical."""
    _wait_all_ready(cluster)
    for qrel_id, (run, want) in registered.items():
        res = client.evaluate(qrel_id, run=run)
        assert res.per_query == want, f"{qrel_id} diverged after chaos"
        assert qrel_id in cluster.router._journal  # ack is still durable


def test_chaos_kills_lose_nothing(replicated):
    cluster, proxies = replicated
    _wait_all_ready(cluster)
    schedule = ChaosSchedule([
        ChaosEvent(t=0.10, kind="kill", worker="w0"),
        ChaosEvent(t=1.20, kind="kill", worker="w1"),
    ])
    restarts = cluster.router.counters["restarts"]
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        registered = _register(client, "kill", 3, seed0=200)
        injector, fut = inject(cluster, schedule, proxies)
        _drive(client, registered, fut, register_seed=250)
        assert len(injector.applied) == 2 and not injector.skipped
        _assert_converged(cluster, client, registered)
    assert cluster.router.counters["restarts"] >= restarts + 2


def test_chaos_hangs_lose_nothing(replicated):
    """SIGSTOP-hangs: the worker is alive but silent, then resumes (the
    probe is out of the way here) — invisible to acknowledged state."""
    cluster, proxies = replicated
    _wait_all_ready(cluster)
    schedule = ChaosSchedule([
        ChaosEvent(t=0.10, kind="hang", worker="w0", duration=0.35),
        ChaosEvent(t=0.90, kind="hang", worker="w1", duration=0.35),
    ])
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        registered = _register(client, "hang", 3, seed0=300)
        injector, fut = inject(cluster, schedule, proxies)
        _drive(client, registered, fut)
        assert len(injector.applied) == 2
        _assert_converged(cluster, client, registered)


def test_chaos_truncation_never_relays_garbage(replicated):
    """Torn frames on the worker wire: the router's client treats a
    response cut mid-frame as a connection loss and fails over."""
    cluster, proxies = replicated
    _wait_all_ready(cluster)
    schedule = ChaosSchedule([
        ChaosEvent(t=0.05, kind="truncate", worker="w0"),
        ChaosEvent(t=0.35, kind="truncate", worker="w1"),
        ChaosEvent(t=0.65, kind="truncate", worker="w0"),
    ])

    def truncated():
        return sum(p.counters["truncated"] for p in proxies.proxies.values())

    before = truncated()
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        registered = _register(client, "trunc", 3, seed0=400)
        injector, fut = inject(cluster, schedule, proxies)
        _drive(client, registered, fut)
        assert len(injector.applied) == 3
        # a pending truncate_next fires on the next chunk through the
        # proxy; keep traffic flowing until at least one actually struck
        deadline = time.monotonic() + 15
        while truncated() == before and time.monotonic() < deadline:
            for qrel_id, (run, want) in registered.items():
                try:
                    assert client.evaluate(
                        qrel_id, run=run).per_query == want
                except TOLERATED:
                    pass
        assert truncated() > before
        _assert_converged(cluster, client, registered)


def test_chaos_delay_with_deadlines_hedges_or_times_out(replicated):
    """A slow replica (per-chunk delay beyond the hedge point): requests
    carrying deadlines hedge to the fast sibling or answer
    deadline_exceeded — never a late-garbled result."""
    cluster, proxies = replicated
    _wait_all_ready(cluster)
    schedule = ChaosSchedule([
        ChaosEvent(t=0.05, kind="delay", worker="w0", duration=0.7),
        ChaosEvent(t=0.40, kind="delay", worker="w1", duration=0.7),
    ])
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        registered = _register(client, "slow", 2, seed0=500)
        injector, fut = inject(cluster, schedule, proxies)
        _drive(client, registered, fut, deadline=1.0)
        assert len(injector.applied) == 2
        _assert_converged(cluster, client, registered)
    for proxy in proxies.proxies.values():
        assert proxy.delay == 0.0  # trailing effects undone by run()


def test_chaos_random_schedule_converges(replicated):
    """A SEEDED random mix of every fault kind, with registrations arriving
    mid-schedule, ends with zero lost acks and bit-identical answers."""
    cluster, proxies = replicated
    _wait_all_ready(cluster)
    seed = 3
    schedule = ChaosSchedule.random(seed, cluster.worker_names,
                                    n_events=6, horizon=2.0)
    assert (schedule.events
            == ChaosSchedule.random(seed, cluster.worker_names,
                                    n_events=6, horizon=2.0).events)
    with EvalClient(cluster.host, cluster.port, timeout=WAIT) as client:
        registered = _register(client, f"rand{seed}", 3, seed0=600 + seed)
        injector, fut = inject(cluster, schedule, proxies)
        _drive(client, registered, fut, register_seed=700 + seed)
        assert len(injector.applied) + len(injector.skipped) == 6
        _assert_converged(cluster, client, registered)


# -- whole-cluster restart from --state-dir -----------------------------------


def test_cluster_restart_from_state_dir_byte_matches_golden(tmp_path):
    """Shut the WHOLE cluster down; boot a fresh one against the same
    --state-dir; the conformance golden reproduces byte-for-byte without
    re-registering anything."""
    state = str(tmp_path / "state")
    selected = sorted(supported_measures)
    qrel = trec.load_qrel(QREL)
    kw = dict(worker_args=CPU,
              router_kw=dict(health_interval=30.0, state_dir=state))
    with ClusterThread(1, **kw) as first:
        with EvalClient(first.host, first.port, timeout=WAIT) as c:
            c.register_qrel("conformance", qrel, selected,
                            relevance_level=1)
    # the journal the JAX router would read back, byte for byte
    assert sorted(JaxJournal(state)) == ["conformance"]

    with ClusterThread(1, **kw) as reborn:  # same state dir, cold start
        stats = reborn.stats()
        assert stats["router"]["journal"]["recovered_collections"] == 1
        with EvalClient(reborn.host, reborn.port, timeout=WAIT) as c:
            res = c.evaluate("conformance", run=trec.load_run(RUN))
    assert _golden_lines(res.per_query, qrel,
                         cli.ordered_keys(selected)) == _golden()
