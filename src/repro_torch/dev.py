"""Developer workflow helpers: ``python -m repro_torch.dev verify``.

The port of ``repro.dev``.  Subcommands (``--device`` picks the
evaluators' device for the smokes: ``cuda``, the default, raises without
a card, as every entry point of the port does; pass ``--device cpu`` on a
host without one):

* ``verify`` — the one-command pre-merge check: ``pytest -q
  tests/test_torch_*.py`` on the CPU (no card visible to it), then each
  smoke below in order;
* ``sharded-smoke`` — a 2-shard :class:`ShardedEvaluator` (two cards when
  two are visible, else the evaluator's device twice) on the conformance
  fixtures: per-query results bit-identical to
  :meth:`RelevanceEvaluator.evaluate` and to one shard, aggregates
  within 1e-6 of the per-query means;
* ``serve-smoke`` — a TCP evaluation service with concurrent clients,
  coalesced into fewer backend calls, bit-identical to direct evaluation;
* ``client-smoke`` — ``EvalClient`` over TCP and over a stdio subprocess
  server, pipelined requests and >64 KiB payloads, bit-identical;
* ``cluster-smoke`` — a 2-worker cluster: a >64 KiB round trip through
  the router, then the owning worker SIGKILLed mid-request: restart,
  journal replay and a transparent retry, bit-identical;
* ``sweep-smoke`` — a K-run ``evaluate_sweep`` bit-identical to K
  ``evaluate`` calls, plus the statistics invariants and the df=1
  closed-form p-value.

The JAX package's step 7 (``python -m benchmarks.run --only sweep``) is
left out: the port has no benchmark segment yet.  Every child process
runs under a timeout; the exit status is non-zero if any step fails.
"""

from __future__ import annotations

import argparse
import glob
import os
import subprocess
import sys
import textwrap

ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
SRC = os.path.join(ROOT, "src")

#: seconds for the CPU test suite, and for each smoke
PYTEST_TIMEOUT = 1800
SMOKE_TIMEOUT = 600

_DEVICE = """
    import torch
    DEVICE = {device!r}
"""

_SHARDED_SMOKE = """
    import numpy as np
    from repro_torch.core import (RelevanceEvaluator, aggregate_results,
                                  supported_measures, trec)
    from repro_torch.distributed import ShardedEvaluator

    qrel = trec.load_qrel({qrel!r})
    run = trec.load_run({run!r})
    ev = RelevanceEvaluator(qrel, supported_measures, device=DEVICE)
    if ev.device.type == "cuda" and torch.cuda.device_count() >= 2:
        mesh = ["cuda:0", "cuda:1"]
    else:
        mesh = [ev.device] * 2
    want = ev.evaluate(run)
    one = ShardedEvaluator(ev, mesh=mesh[:1]).evaluate(run)
    sev = ShardedEvaluator(ev, mesh=mesh)
    assert sev.n_shards == 2, sev.n_shards
    res = sev.evaluate(run)
    assert set(res.per_query) == set(want)
    for qid in want:
        for key, val in want[qid].items():
            got = res.per_query[qid][key]
            assert got == val, (qid, key, got, val)  # bit-identical
            assert got == one.per_query[qid][key], (qid, key)
    for key, val in aggregate_results(want).items():
        assert abs(res.aggregates[key] - val) <= 1e-6, key
    print(f"sharded 2-shard smoke: OK (mesh {{[str(d) for d in sev.mesh]}}, "
          f"{{len(want)}} queries x {{len(ev.measure_keys)}} measures, "
          "bit-identical)")
"""

_SERVE_SMOKE = """
    import asyncio, json
    from repro_torch.core import RelevanceEvaluator, trec
    from repro_torch.serve import EvaluationService, serve_tcp
    from repro_torch.serve.frontend import close_server

    qrel = trec.load_qrel({qrel!r})
    run = trec.load_run({run!r})
    measures = ("map", "ndcg", "recip_rank")
    n = 6
    runs = [{{q: {{d: s + 0.25 * i for d, s in docs.items()}}
             for q, docs in run.items()}} for i in range(n)]
    ev = RelevanceEvaluator(qrel, measures, device=DEVICE)
    want = [ev.evaluate(r) for r in runs]

    async def client(port, i):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        req = {{"op": "evaluate", "id": i, "qrel_id": "smoke",
                "run": runs[i]}}
        writer.write((json.dumps(req) + "\\n").encode())
        await writer.drain()
        reply = json.loads(await asyncio.wait_for(reader.readline(), 120))
        writer.close()
        await asyncio.wait_for(writer.wait_closed(), 10)
        assert reply["ok"], reply
        return reply["result"]["per_query"]

    async def main():
        svc = EvaluationService(window=0.05, device=DEVICE)
        svc.register_qrel("smoke", qrel, measures)
        server = await serve_tcp(svc, "127.0.0.1", 0)
        port = server.sockets[0].getsockname()[1]
        got = await asyncio.gather(*(client(port, i) for i in range(n)))
        await close_server(server)
        stats = svc.stats()
        assert stats["backend_calls"] < n, stats  # coalesced
        for g, w in zip(got, want):
            for qid in w:
                for key, val in w[qid].items():
                    assert g[qid][key] == val, (qid, key)  # bit-identical
        print(f"serve smoke: OK ({{n}} concurrent requests -> "
              f"{{stats['backend_calls']}} backend call(s), bit-identical)")

    asyncio.run(main())
"""

_BIG = """
    # a payload comfortably past the seed's 64 KiB limit
    big_qrel = {{"Q%04d-%s" % (i, "x" * 80):
                {{"D%04d-%s" % (d, "y" * 80): int((i + d) % 3)
                 for d in range(24)}} for i in range(36)}}
    big_run = {{q: {{d: float((i * 31 + j * 7) % 97) / 97.0
                   for j, d in enumerate(docs)}}
               for i, (q, docs) in enumerate(big_qrel.items())}}
"""

_CLIENT_SMOKE = """
    import json, sys
    from repro_torch.client import EvalClient
    from repro_torch.core import RelevanceEvaluator
    from repro_torch.serve.testing import ServerThread

    payload = json.dumps({{"op": "register_qrel", "qrel_id": "big",
                          "qrel": big_qrel}})
    assert len(payload) > (1 << 16), len(payload)
    want = RelevanceEvaluator(big_qrel, ("map", "ndcg"),
                              device=DEVICE).evaluate(big_run)

    # TCP: persistent connection, pipelining, >64 KiB payload
    with ServerThread(service_kw=dict(window=0.02, device=DEVICE)) as srv:
        with EvalClient(srv.host, srv.port, timeout=120) as client:
            assert client.ping() == "pong"
            client.register_qrel("big", big_qrel, ("map", "ndcg"))
            res = client.evaluate("big", run=big_run)
            assert res.per_query == want  # bit-identical through TCP
            many = client.evaluate_many("big", runs=[big_run] * 4)
            assert all(m.per_query == want for m in many)
        stats = srv.stats()
        assert stats["backend_calls"] < stats["requests"], stats

    # stdio: a private subprocess server, same >64 KiB payload
    with EvalClient.spawn_stdio(
            [sys.executable, "-m", "repro_torch.serve", "--device", DEVICE,
             "--qrel", {qrel!r}, "-m", "map", "--window-ms", "1"],
            timeout=120) as client:
        assert client.ping() == "pong"
        r = client.evaluate("default",
                            run={{"q1": {{"APPLE": 2.0, "BANANA": 1.0}}}})
        assert r.per_query["q1"]["map"] > 0
        client.register_qrel("big", big_qrel, ("map", "ndcg"))
        res = client.evaluate("big", run=big_run)
        assert res.per_query == want  # and through stdio pipes

    print("client smoke: OK (TCP pipelined + stdio, >64 KiB payloads, "
          f"{{stats['requests']}} reqs -> {{stats['backend_calls']}} backend "
          "calls, bit-identical)")
"""

_CLUSTER_SMOKE = """
    import asyncio, json
    from repro_torch.client import EvalClient
    from repro_torch.core import RelevanceEvaluator
    from repro_torch.serve.cluster.testing import ClusterThread

    payload = json.dumps({{"op": "evaluate", "qrel_id": "big",
                          "run": big_run}})
    assert len(payload) > (1 << 16), len(payload)
    want = RelevanceEvaluator(big_qrel, ("map", "ndcg"),
                              device=DEVICE).evaluate(big_run)

    # a wide coalescing window so the kill lands mid-request
    with ClusterThread(2, worker_args=["--device", DEVICE,
                                       "--backend", "single",
                                       "--window-ms", "250"],
                       router_kw=dict(retries=4,
                                      health_interval=30.0)) as cluster:
        with EvalClient(cluster.host, cluster.port, timeout=180) as client:
            assert client.ping() == "pong"
            health = client.health()
            assert health["status"] == "ok" and health["ready"] == 2, health
            client.register_qrel("big", big_qrel, ("map", "ndcg"))
            res = client.evaluate("big", run=big_run)
            assert res.per_query == want  # >64 KiB round trip, bit-identical

            owner = cluster.owner_of("big")
            future = client.submit("big", run=big_run)

            async def wait_inflight():
                slot = cluster.router._slots[owner]
                while True:
                    h = await slot.proc.client.health()
                    if h["in_flight"]:
                        return
                    await asyncio.sleep(0.002)

            cluster.call(wait_inflight(), timeout=60)
            cluster.kill_worker(owner)  # SIGKILL mid-request
            assert future.result(180).per_query == want  # transparent retry
        counters = dict(cluster.router.counters)
    assert counters["restarts"] >= 1 and counters["worker_retries"] >= 1, \\
        counters
    print("cluster smoke: OK (2 workers, >64 KiB through the router, "
          "worker killed mid-request -> restart + journal replay + "
          "transparent retry, bit-identical)")
"""

_SWEEP_SMOKE = """
    import numpy as np
    from repro_torch import stats
    from repro_torch.core import RelevanceEvaluator, evaluate_sweep, trec

    qrel = trec.load_qrel({qrel!r})
    base = trec.load_run({run!r})
    measures = ("map", "ndcg", "P_5")
    k = 6
    runs = [{{q: {{d: s + 0.25 * i * (1 if sum(map(ord, d)) % 2 else -1)
                 for d, s in docs.items()}}
             for q, docs in base.items()}} for i in range(k)]
    ev = RelevanceEvaluator(qrel, measures, device=DEVICE)
    result = evaluate_sweep(ev, [ev.tokenize_run(r) for r in runs])
    # bit-identity: the sweep table IS the K independent evaluations
    for ki, r in enumerate(runs):
        want = ev.evaluate(r)
        for qi, qid in enumerate(result.qids):
            for mi, key in enumerate(result.measure_keys):
                assert result.table[ki, qi, mi] == want[qid][key], \\
                    (ki, qid, key)

    x = result.measure("map")
    t, p = stats.paired_t_matrix(x, device=DEVICE)
    holm = stats.holm_matrix(p)
    bonf = stats.bonferroni_matrix(p)
    t, p, holm, bonf = (np.asarray(a.cpu()) for a in (t, p, holm, bonf))
    assert np.array_equal(p, p.T) and np.array_equal(np.diag(p),
                                                     np.ones(k))
    assert np.array_equal(t, -t.T)
    assert (holm <= bonf + 1e-7).all() and (holm <= 1.0).all()
    # closed form at df=1: d=[0.1, 0.3] -> t=2, p = 1 - (2/pi)atan(2)
    _, p2 = stats.paired_t_matrix(
        np.array([[0.4, 0.6], [0.3, 0.3]], np.float32), device=DEVICE)
    assert abs(float(p2[0, 1]) - 0.29516723) < 1e-6, float(p2[0, 1])
    print(f"sweep smoke: OK ({{k}} runs x {{len(result.qids)}} queries x "
          f"{{len(result.measure_keys)}} measures, bit-identical; "
          "stats invariants + df=1 closed form hold)")
"""


def _env(extra=None):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    if extra:
        env.update(extra)
    return env


def _fixture(name: str) -> str:
    return os.path.join(ROOT, "tests", "fixtures", name)


def _run(argv, timeout: float, env=None) -> int:
    """A child process under ``timeout`` seconds (killed past it: 124)."""
    try:
        return subprocess.run(argv, cwd=ROOT, env=env or _env(),
                              timeout=timeout).returncode
    except subprocess.TimeoutExpired:
        print(f"timed out after {timeout} s: {argv[:3]}", file=sys.stderr)
        return 124


def _smoke(title: str, body: str, device: str, big: bool = False) -> int:
    print(f"== {title} ==", flush=True)
    code = textwrap.dedent(_DEVICE) + (textwrap.dedent(_BIG) if big
                                       else "") + textwrap.dedent(body)
    code = code.format(device=device, qrel=_fixture("conformance.qrel"),
                       run=_fixture("conformance.run"))
    return _run([sys.executable, "-c", code], SMOKE_TIMEOUT)


def sharded_smoke(device: str = "cuda") -> int:
    """Two shards bit-identical to ``evaluate`` and to one shard."""
    return _smoke("sharded smoke (2 shards)", _SHARDED_SMOKE, device)


def serve_smoke(device: str = "cuda") -> int:
    """Boot a TCP service, assert coalescing + bit-identity."""
    return _smoke("serve smoke (TCP, concurrent clients)", _SERVE_SMOKE,
                  device)


def client_smoke(device: str = "cuda") -> int:
    """EvalClient over TCP + stdio with >64 KiB payloads."""
    return _smoke("client smoke (EvalClient: TCP + stdio, large frames)",
                  _CLIENT_SMOKE, device, big=True)


def cluster_smoke(device: str = "cuda") -> int:
    """2-worker cluster: big frames + kill-retry fault path."""
    return _smoke("cluster smoke (2 workers, router, worker-kill retry)",
                  _CLUSTER_SMOKE, device, big=True)


def sweep_smoke(device: str = "cuda") -> int:
    """K-run sweep bit-identity + statistics invariants."""
    return _smoke("sweep smoke (evaluate_sweep + repro_torch.stats)",
                  _SWEEP_SMOKE, device)


SMOKES = {"sharded-smoke": sharded_smoke, "serve-smoke": serve_smoke,
          "client-smoke": client_smoke, "cluster-smoke": cluster_smoke,
          "sweep-smoke": sweep_smoke}


def verify(device: str = "cuda") -> int:
    print("== pytest tests/test_torch_*.py (CPU) ==", flush=True)
    tests = sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_*.py")))
    rc = _run([sys.executable, "-m", "pytest", "-q", *tests],
              PYTEST_TIMEOUT, _env({"CUDA_VISIBLE_DEVICES": ""}))
    if rc != 0:
        return rc
    for smoke in SMOKES.values():
        rc = smoke(device)
        if rc != 0:
            return rc
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.dev",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("command", choices=["verify", *SMOKES])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.command == "verify":
        return verify(args.device)
    return SMOKES[args.command](args.device)


if __name__ == "__main__":
    sys.exit(main())
