"""The port's evaluation service and its JSON-lines front-end against the
JAX package's, on the CPU.

The same request lines go through ``repro.serve.frontend.handle_line`` and
``repro_torch.serve.frontend.handle_line``: a response that carries only
count-valued measures (or no measure at all) must be the same bytes, any
other must parse to the same structure with every number within
atol = rtol = 2e-4.  Error codes (unknown op, missing field, a line that
is not JSON, an oversized frame over TCP) and their messages match.  The
port's service coalesces concurrent requests, evaluates on the device it
was given, and never moves to the CPU on its own.  Every wait here is
bounded: ``asyncio.wait_for`` around each coroutine, socket reads inside
it.
"""

import asyncio
import json
import math
import os
import selectors
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from repro.serve import EvaluationService as JaxService
from repro.serve import handle_line as jax_handle_line
from repro.serve import serve_tcp as jax_serve_tcp
from repro.serve.wire import ERROR_CODES as JAX_ERROR_CODES

from repro_torch import stats as S
from repro_torch.core import RelevanceEvaluator, evaluate_sweep
from repro_torch.core.trec import load_qrel
from repro_torch.data.synthetic_ir import synthesize_run
from repro_torch.distributed import select_backend
from repro_torch.serve import (ERROR_CODES, EvaluationService, handle_line,
                               serve_tcp)

from test_torch_measures import single_torch_thread  # noqa: F401

WAIT = 60  # seconds: the bound on every coroutine a test runs
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
QREL = os.path.join(os.path.dirname(__file__), "fixtures", "conformance.qrel")
EXACT_MEASURES = ["P", "recall", "success", "num_ret", "num_rel",
                  "num_rel_ret", "judged"]
FLOAT_MEASURES = ["map", "ndcg", "recip_rank", "Rprec", "bpref", "ndcg_cut"]


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, WAIT))


def _perturbed(run, n, seed):
    rng = np.random.default_rng(seed)
    return [{q: {d: float(s + rng.normal()) for d, s in docs.items()}
             for q, docs in run.items()} for _ in range(n)]


@pytest.fixture(scope="module")
def collection():
    run, qrel = synthesize_run(n_queries=12, n_docs=20, seed=7)
    # graded judgments, some unjudged and negative, so the measures differ
    rng = np.random.default_rng(7)
    qrel = {q: {d: int(rng.integers(-1, 3)) for d in list(docs)[:14]}
            for q, docs in qrel.items()}
    return run, qrel


def _script(collection):
    """Request lines in order, each with the kind of comparison its
    response gets ("bytes" or "close")."""
    run, qrel = collection
    runs = _perturbed(run, 3, seed=1)
    scores = np.random.default_rng(2).random(12 * 20).round(3).tolist()
    tokens = {"qids": list(run), "counts": [20] * 12,
              "tokens": list(range(240)), "scores": scores}
    lines = [
        ({"op": "register_qrel", "id": 1, "qrel_id": "counts", "qrel": qrel,
          "measures": EXACT_MEASURES}, "bytes"),
        ({"op": "register_qrel", "id": 2, "qrel_id": "floats", "qrel": qrel,
          "measures": FLOAT_MEASURES, "relevance_level": 2}, "bytes"),
        ({"op": "register_qrel", "id": 3, "qrel_id": "dialect",
          "qrel": qrel, "measures": ["AP", "nDCG@10", "P@5"]}, "bytes"),
        ({"op": "register_run", "id": 4, "qrel_id": "counts",
          "run_id": "base", "run": run}, "bytes"),
        ({"op": "register_run", "id": 5, "qrel_id": "floats",
          "run_id": "base", "run": run}, "bytes"),
        ({"op": "evaluate", "id": 6, "qrel_id": "counts", "run": runs[0]},
         "bytes"),
        ({"op": "evaluate", "id": 7, "qrel_id": "counts",
          "run_ref": "base", "scores": scores}, "bytes"),
        ({"op": "evaluate", "id": 8, "qrel_id": "floats", "run": runs[1]},
         "close"),
        ({"op": "evaluate", "id": 9, "qrel_id": "floats",
          "run_ref": "base", "scores": scores}, "close"),
        ({"op": "evaluate", "id": 10, "qrel_id": "dialect",
          "run": runs[2]}, "close"),
        ({"op": "evaluate", "id": 11, "qrel_id": "counts",
          "tokens": tokens}, "bytes"),
        ({"op": "compare", "id": 12, "qrel_id": "floats", "runs": runs,
          "measure": "map"}, "close"),
        ({"op": "compare", "id": 13, "qrel_id": "counts",
          "runs": {"a": runs[0], "b": runs[1]}, "measure": "P_10"},
         "close"),
        ({"op": "ping", "id": 14}, "bytes"),
        ({"op": "health", "id": 15}, "bytes"),
        ({"op": "auth", "id": 16, "token": "x"}, "bytes"),
        ({"op": "stats", "id": 17}, "bytes"),
        ({"op": "drop_qrel", "id": 18, "qrel_id": "dialect"}, "bytes"),
        ({"op": "drop_qrel", "id": 19, "qrel_id": "dialect"}, "bytes"),
        # failures: every one a response with its code
        ({"op": "frobnicate", "id": 20}, "bytes"),
        ({"op": "register_qrel", "id": 21, "qrel": qrel}, "bytes"),
        ({"op": "evaluate", "id": 22}, "bytes"),
        ({"op": "evaluate", "id": 23, "qrel_id": "nope", "run": {}},
         "bytes"),
        ({"op": "evaluate", "id": 24, "qrel_id": "counts", "run": {},
          "run_ref": "base"}, "bytes"),
        ({"op": "evaluate", "id": 25, "qrel_id": "counts",
          "run_ref": "missing", "scores": scores}, "bytes"),
        ({"op": "register_qrel", "id": 26, "qrel_id": "x", "qrel": qrel,
          "relevance_level": "2"}, "bytes"),
        ({"op": "register_qrel", "id": 27, "qrel_id": "x", "qrel": qrel,
          "measures": ["nosuch"]}, "bytes"),
        ({"op": "compare", "id": 28, "qrel_id": "floats", "runs": [run]},
         "bytes"),
        ({"op": "evaluate", "id": 29, "qrel_id": "counts", "run": run,
          "deadline_ms": -1}, "bytes"),
    ]
    return ([json.dumps(req) for req, _ in lines] + ["{not json",
                                                      '["array"]'],
            [kind for _, kind in lines] + ["bytes", "bytes"])


def _assert_close(got, want, path="$"):
    """Same structure; numbers within atol = rtol = 2e-4."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and not isinstance(want, bool):
        assert isinstance(got, (int, float)), path
        if math.isnan(want):
            assert math.isnan(got), path
        else:
            assert abs(got - want) <= 2e-4 + 2e-4 * abs(want), \
                (path, got, want)
    else:
        assert got == want, path


def _through(service, handle, lines):
    async def main():
        return [await handle(service(), line) for line in lines]
    return main


def test_wire_responses_match_the_jax_service(collection):
    """Every op and every failure, line by line through both front-ends."""
    lines, kinds = _script(collection)

    async def both():
        mine = EvaluationService(backend="single", device="cpu")
        theirs = JaxService(backend="single")
        out = []
        for line in lines:
            out.append((await handle_line(mine, line),
                        await jax_handle_line(theirs, line)))
        return out

    pairs = _run(both())
    assert len(pairs) == len(lines)
    for line, kind, (got, want) in zip(lines, kinds, pairs):
        if kind == "bytes":
            assert got == want, line[:120]
        else:
            _assert_close(json.loads(got), json.loads(want))
        assert json.loads(got)["ok"] == json.loads(want)["ok"], line[:120]
    codes = [json.loads(g).get("code") for g, _ in pairs]
    assert {"unknown_op", "missing_field", "not_found", "invalid",
            "bad_request"} <= set(codes)


def test_error_codes_are_the_jax_package_s():
    assert ERROR_CODES == JAX_ERROR_CODES


def test_oversized_frame_over_tcp_matches_jax():
    """A line past the frame limit answers ``frame_too_large`` and the
    connection keeps serving, with the JAX front-end's exact bytes."""
    qrel = {"q1": {"d1": 1, "d2": 0}}
    lines = [b'{"op": "ping", "id": 1, "pad": "' + b"x" * 4096 + b'"}\n',
             json.dumps({"op": "evaluate", "id": 7, "qrel_id": "web",
                         "run": {"q1": {"d1": 1.0}}}).encode() + b"\n"]

    async def over_tcp(service, serve):
        service.register_qrel("web", qrel, ("map",))
        server = await serve(service, "127.0.0.1", 0, limit=1024)
        port = server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        try:
            for line in lines:
                writer.write(line)
            await writer.drain()
            return [await reader.readline() for _ in lines]
        finally:
            writer.close()
            await writer.wait_closed()
            server.close()
            await server.wait_closed()

    got = _run(over_tcp(EvaluationService(backend="single", device="cpu"),
                        serve_tcp))
    want = _run(over_tcp(JaxService(backend="single"), jax_serve_tcp))
    assert got == want
    first, second = map(json.loads, got)
    assert first["code"] == "frame_too_large" and second["ok"]


def test_two_concurrent_requests_make_one_backend_call(collection):
    run, qrel = collection
    runs = _perturbed(run, 2, seed=3)
    direct = RelevanceEvaluator(qrel, FLOAT_MEASURES, device="cpu")

    async def main():
        svc = EvaluationService(window=0.05, backend="single", device="cpu")
        svc.register_qrel("c", qrel, FLOAT_MEASURES)
        res = await asyncio.gather(*(svc.evaluate("c", run=r)
                                     for r in runs))
        return res, svc.stats()

    results, stats = _run(main())
    assert stats["requests"] == 2 and stats["backend_calls"] == 1
    for res, r in zip(results, runs):
        assert res.per_query == direct.evaluate(r)  # bit for bit


def test_sharded_collection_matches_single(collection):
    """``"sharded"`` goes through the fused-measure path (its plain version
    on the CPU): count columns exact, the rest within 2e-4."""
    from test_torch_measures import assert_results_match

    run, qrel = collection
    runs = _perturbed(run, 3, seed=4)

    async def main():
        svc = EvaluationService(window=0.05, device="cpu")
        info = svc.register_qrel("s", qrel, FLOAT_MEASURES + EXACT_MEASURES,
                                 backend="sharded")
        svc.register_qrel("1", qrel, FLOAT_MEASURES + EXACT_MEASURES,
                          backend="single")
        got = await asyncio.gather(*(svc.evaluate("s", run=r)
                                     for r in runs))
        want = await asyncio.gather(*(svc.evaluate("1", run=r)
                                      for r in runs))
        return info, got, want, svc.stats()

    info, got, want, stats = _run(main())
    assert info["backend"] == "sharded"
    assert stats["backend_calls"] == 2
    for g, w in zip(got, want):
        assert_results_match(g.per_query, w.per_query)


def test_compare_equals_significance_on_the_sweep_table(collection):
    """``compare`` over registered runs equals ``significance_report`` on
    the same runs' ``evaluate_sweep`` table (t-test and sign flips)."""
    run, qrel = collection
    runs = _perturbed(run, 4, seed=5)

    async def main():
        svc = EvaluationService(window=0.02, device="cpu")
        svc.register_qrel("c", qrel, FLOAT_MEASURES)
        for i, r in enumerate(runs):
            svc.register_run("c", f"r{i}", run=r)
        return await svc.compare("c", run_refs=[f"r{i}" for i in range(4)],
                                 measure="map", tests=("t", "permutation"),
                                 n_permutations=500, seed=9)

    got = _run(main())
    ev = RelevanceEvaluator(qrel, FLOAT_MEASURES, device="cpu")
    sweep = evaluate_sweep(ev, [ev.tokenize_run(r) for r in runs])
    # contiguous, as the service builds its [K, Q] matrix: a strided view
    # is reduced in another order on the CPU
    want = S.significance_report(np.ascontiguousarray(sweep.measure("map")),
                                 tests=("t", "permutation"),
                                 n_permutations=500, seed=9, device="cpu")
    assert got["qids"] == list(sweep.qids)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(v, np.float32), err_msg=k)


def test_auto_backend_follows_the_service_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    svc = EvaluationService(device="cpu")
    info = svc.register_qrel("c", {"q1": {"d1": 1}}, ("map",))
    assert info["backend"] == "single" == select_backend("auto", "cpu")
    assert svc.device == torch.device("cpu")


def test_service_defaults_to_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EvaluationService()
    with pytest.raises(RuntimeError, match="CUDA"):
        EvaluationService(device="cuda")


@pytest.mark.parametrize("module_name", [
    "repro_torch.serve", "repro_torch.serve.service",
    "repro_torch.serve.cache", "repro_torch.serve.batcher",
    "repro_torch.serve.wire", "repro_torch.serve.testing",
    "repro_torch.client", "repro_torch.client.aio",
    "repro_torch.client.sync",
])
def test_port_docstring_examples(module_name):
    """The modules' docstring examples, every one on ``device="cpu"``."""
    import doctest
    import importlib

    results = doctest.testmod(importlib.import_module(module_name))
    assert results.attempted > 0 and results.failed == 0, results


def _stderr_banner_port(proc, timeout):
    """The port of ``serving on HOST:PORT`` on the child's stderr."""
    deadline = time.monotonic() + timeout
    sel = selectors.DefaultSelector()
    sel.register(proc.stderr, selectors.EVENT_READ)
    buf = b""
    try:
        while time.monotonic() < deadline:
            if not sel.select(timeout=max(0.0, deadline - time.monotonic())):
                continue
            chunk = os.read(proc.stderr.fileno(), 4096)
            assert chunk, f"server exited before its banner: {buf!r}"
            buf += chunk
            for line in buf.decode("utf-8", "replace").splitlines():
                if line.startswith("serving on "):
                    return int(line.rpartition(":")[2])
    finally:
        sel.close()
    raise AssertionError(f"no banner within {timeout} s: {buf!r}")


def _read_until(stream, rid):
    """Response lines off ``stream`` (its socket has a timeout) until the
    one answering ``rid``."""
    while True:
        line = stream.readline()
        assert line, f"connection closed before the answer to id {rid}"
        msg = json.loads(line)
        if msg["id"] == rid:
            return msg


def test_sigterm_exits_with_an_idle_client_connected():
    """Since Python 3.12.1 ``Server.wait_closed()`` waits for every open
    connection.  With one client connected and idle, SIGTERM must still end
    ``python -m repro_torch.serve`` with rc 0 within 10 s, and a request
    sent before the signal is still answered."""
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.serve", "--tcp", "127.0.0.1:0",
         "--device", "cpu", "--qrel", QREL, "-m", "map",
         "--window-ms", "500"],
        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, env=env)
    socks = []
    try:
        port = _stderr_banner_port(proc, timeout=60)
        for _ in range(2):
            socks.append(socket.create_connection(("127.0.0.1", port),
                                                  timeout=WAIT))
        idle, busy = socks
        stream = busy.makefile("rwb")
        run = {"q1": {"APPLE": 2.0, "banana": 1.0}}
        stream.write(json.dumps({"op": "evaluate", "id": 1,
                                 "qrel_id": "default",
                                 "run": run}).encode() + b"\n")
        stream.flush()
        # the evaluate sits in the 500 ms window: wait until it is in flight
        for rid in range(2, 200):
            stream.write(json.dumps({"op": "health", "id": rid}).encode()
                         + b"\n")
            stream.flush()
            if _read_until(stream, rid)["result"]["in_flight"] >= 1:
                break
        else:
            raise AssertionError("the evaluate never showed as in flight")
        proc.send_signal(signal.SIGTERM)
        t0 = time.monotonic()
        answer = _read_until(stream, 1)
        rc = proc.wait(timeout=10)
        exit_s = time.monotonic() - t0
    finally:
        for sock in socks:
            sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()
    assert rc == 0 and exit_s < 10
    want = RelevanceEvaluator(load_qrel(QREL), ["map"],
                              device="cpu").evaluate(run)
    assert answer["ok"] and answer["result"]["per_query"] == want
